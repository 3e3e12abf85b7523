"""Maximum-likelihood destriper (port of
``comapreduce_tpu/mapmaking/destriper.py``).

Solves ``F^T W Z F a = F^T W Z d`` by preconditioned CG. Two paths:

- :func:`destripe_planned`, the fast path: every binning in the coarse
  (pixel, offset)-pair space of a
  :class:`~comapreduce_tpu_torch.mapmaking.pointing_plan.PointingPlan`,
  each CG matvec one rank-order and one offset-order windowed scatter
  (kernel K3 on the card) plus small gathers. A leading axis on the TOD
  is a multi-RHS solve (the four bands against their shared pointing).
  The joint az-linear ground template adds a small ``(n_groups, 2)``
  unknown block; its offset-order coefficient reads are kernel K4. The
  two-level preconditioner (``coarse=``) adds an exact Galerkin
  coarse-grid correction over blocks of offsets.
- :func:`destripe`, the scatter path: per-sample ``index_add_`` binning,
  the oracle, and the route for ground groups that are not
  offset-aligned. Plain PyTorch on both devices, as the reference has no
  kernel there either.

Not ported yet (``NotImplementedError``): the multigrid (``mg=``) and
banded (``banded=``) preconditioners, sharded plans (``axis_name=``,
``device_arrays=``) and compensated CG dots.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from comapreduce_tpu_torch.mapmaking.binning import (accumulate_weights,
                                                     bin_map, naive_map,
                                                     sample_map)
from comapreduce_tpu_torch.mapmaking.cuda_binning import windowed_gather
from comapreduce_tpu_torch.mapmaking.pixel_space import resolve_npix
from comapreduce_tpu_torch.mapmaking.pointing_plan import (PointingPlan,
                                                           binned_window_sum)
from comapreduce_tpu_torch.resilience.tripwires import scrub_tod

__all__ = ["DestriperResult", "destripe", "destripe_planned",
           "ground_ids_per_offset", "coarse_pattern",
           "build_coarse_preconditioner", "DIVERGENCE_K",
           "DIVERGENCE_GROWTH"]

logger = logging.getLogger("comapreduce_tpu_torch")

# CG divergence tripwire (``destriper.py:93``): diverged after
# DIVERGENCE_K consecutive checks with |r|^2 > DIVERGENCE_GROWTH x the
# best iterate's (converged systems exempt)
DIVERGENCE_K = 6
DIVERGENCE_GROWTH = 100.0


class DestriperResult(NamedTuple):
    """Everything a solve produces (``destriper.py:97``)."""

    offsets: torch.Tensor
    ground: torch.Tensor
    destriped_map: torch.Tensor
    naive_map: torch.Tensor
    weight_map: torch.Tensor
    hit_map: torch.Tensor
    n_iter: torch.Tensor
    residual: torch.Tensor
    diverged: torch.Tensor | int = 0
    sky_pixels: object = None
    trace: object = None


def _jacobi_inverse(diag_a: torch.Tensor, diag_fwf: torch.Tensor,
                    floor: float = 1e-6) -> torch.Tensor:
    """1/diag(A), falling back to the plain F^T W F diagonal on offsets
    Z absorbs and to 1 on zero-weight offsets (``destriper.py:316``)."""
    cut = floor * torch.clamp(diag_fwf, min=1e-30)
    one = torch.ones((), dtype=diag_a.dtype, device=diag_a.device)
    safe = torch.where(diag_a > cut, diag_a,
                       torch.where(diag_fwf > 0, diag_fwf, one))
    return 1.0 / safe


def _tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over a tuple of unknown blocks (or to one
    tensor); a ``None`` block (the scatter path without ground) stays
    ``None``, as an empty pytree node does in the reference."""
    if isinstance(trees[0], tuple):
        return tuple(None if leaves[0] is None else fn(*leaves)
                     for leaves in zip(*trees))
    return fn(*trees)


def _cg_loop(matvec, b, dot, n_iter: int, threshold: float, precond=None,
             x0=None, divergence_k: int = DIVERGENCE_K, trace_n: int = 0):
    """(P)CG with the breakdown guard, divergence monitor, best-iterate
    return for diverged systems, ``x0`` warm start and ``trace_n``
    histories (``destriper.py:334``).

    The unknowns ``b`` are one tensor f32[..., n] or a tuple of blocks
    (the joint [offsets; ground] solve); ``dot`` returns one inner
    product per system (shape ``S``), and every per-system scalar
    broadcasts onto each block as ``S + (1,) * trailing``. Returns
    ``(x, rr, k, b_norm, diverged, trace)``; the loop stops when every
    system has converged, broken down or diverged, or after ``n_iter``
    iterations (one host read of the live flag per iteration)."""
    b_norm = dot(b, b)
    minv = precond if precond is not None else (lambda v: v)
    tol = threshold ** 2 * torch.clamp(b_norm, min=1e-30)

    def bcast(s, leaf):
        return s.reshape(s.shape + (1,) * (leaf.ndim - s.ndim))

    def axpy(a, x, y):
        return _tree_map(lambda xi, yi: xi + bcast(a, xi) * yi, x, y)

    def sel_where(mask, new, old):
        return _tree_map(lambda n_, o_: torch.where(bcast(mask, n_), n_, o_),
                         new, old)

    if x0 is None:
        x = _tree_map(torch.zeros_like, b)
        r = b
    else:
        x = _tree_map(lambda x0i, bi: torch.broadcast_to(
            x0i.to(bi.dtype), bi.shape).clone(), x0, b)
        r = _tree_map(torch.sub, b, matvec(x))
    rr = dot(r, r)
    z = minv(r)
    p = z
    rz = dot(r, z)
    dev = b_norm.device
    done = torch.zeros(b_norm.shape, dtype=torch.bool, device=dev)
    div = torch.zeros_like(done)
    inc = torch.zeros(b_norm.shape, dtype=torch.int32, device=dev)
    xb, rrb = x, rr
    hist = None
    if trace_n:
        hist = tuple(torch.zeros((int(trace_n),) + tuple(b_norm.shape),
                                 dtype=torch.float32, device=dev)
                     for _ in range(3))
    zero = torch.zeros((), dtype=b_norm.dtype, device=dev)
    k = 0
    while k < n_iter and bool((~done & (rr > tol)).any()):
        q = matvec(p)
        pq = dot(p, q)
        ok = torch.isfinite(pq) & (pq > 0) & ~done
        alpha = torch.where(ok, rz / torch.where(ok, pq, zero + 1.0), zero)
        x_new = axpy(alpha, x, p)
        r_new = axpy(-alpha, r, q)
        z_new = minv(r_new)
        rz_new = dot(r_new, z_new)
        rr_new = dot(r_new, r_new)
        ok = ok & torch.isfinite(rz_new) & torch.isfinite(rr_new)
        not_conv = rr_new > tol
        elevated = ok & not_conv & (rr_new > DIVERGENCE_GROWTH * rrb)
        inc = torch.where(elevated, inc + 1,
                          torch.where(ok, torch.zeros_like(inc), inc))
        div_new = div | (inc >= divergence_k)
        better = ok & (rr_new < rrb)
        xb = sel_where(better, x_new, xb)
        rrb = torch.where(better, rr_new, rrb)
        beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-30), zero)
        p_new = axpy(beta, z_new, p)
        adv = ok & ~div_new
        if trace_n:
            idx = min(k, int(trace_n) - 1)
            hist[0][idx] = torch.where(adv, rr_new, rr)
            hist[1][idx] = alpha
            hist[2][idx] = beta
        x = sel_where(adv, x_new, x)
        r = sel_where(adv, r_new, r)
        p = sel_where(adv, p_new, p)
        rz = torch.where(adv, rz_new, rz)
        rr = torch.where(adv, rr_new, rr)
        done = done | ~ok | div_new
        div = div_new
        k += 1
    use_best = div & (rrb < rr)
    x = sel_where(use_best, xb, x)
    rr = torch.where(use_best, rrb, rr)
    return x, rr, k, b_norm, div.to(torch.int32), hist


def _check_precond(precond: str, coarse=None, mg=None) -> str:
    """The preconditioner-name rule (``destriper.py:481``): ``jacobi`` |
    ``none``; the two-level preconditioner is Jacobi plus ``coarse=``,
    multigrid is Jacobi plus ``mg=``, and not both."""
    if precond not in ("jacobi", "none"):
        raise ValueError(f"precond must be 'jacobi' or 'none', got "
                         f"{precond!r} (the two-level preconditioner is "
                         "selected by passing coarse=..., the multigrid "
                         "one by passing mg=...)")
    if coarse is not None and precond != "jacobi":
        raise ValueError("the two-level preconditioner is additive over "
                         "Jacobi; coarse=... requires precond='jacobi'")
    if mg is not None and precond != "jacobi":
        raise ValueError("the multigrid V-cycle smooths with Jacobi; "
                         "mg=... requires precond='jacobi'")
    if mg is not None and coarse is not None:
        raise ValueError("pass coarse=... (two-level) OR mg=... "
                         "(multigrid), not both")
    return precond


def _check_cg_dot(cg_dot: str) -> None:
    if cg_dot == "compensated":
        raise NotImplementedError(
            "cg_dot='compensated' is not ported yet; only 'f32' is")
    if cg_dot != "f32":
        raise ValueError(
            f"cg_dot must be 'f32' or 'compensated', got {cg_dot!r}")


# ---------------------------------------------------------------------------
# scatter path
# ---------------------------------------------------------------------------

def _expand(offsets, ground, ground_ids, az, offset_length):
    """The template operator ``F a (+ G g)`` -> TOD domain."""
    d = torch.repeat_interleave(offsets, offset_length, dim=-1)
    if ground is not None:
        d = d + ground[ground_ids, 0] + ground[ground_ids, 1] * az
    return d


def _reduce(wr, ground_ids, az, n_offsets, offset_length, n_groups):
    """The adjoint: TOD -> (per-offset sums, per-group ``[sum, sum az]``)."""
    a = wr.reshape(n_offsets, offset_length).sum(dim=1)
    if ground_ids is None:
        return a, None
    def seg(v):
        return torch.zeros(n_groups, dtype=wr.dtype,
                           device=wr.device).index_add_(0, ground_ids, v)
    return a, torch.stack([seg(wr), seg(wr * az)], dim=-1)


def _dot(x, y):
    """CG inner product over the (offsets, ground) unknowns."""
    s = (x[0] * y[0]).sum()
    if x[1] is not None:
        s = s + (x[1] * y[1]).sum()
    return s


def destripe(tod: torch.Tensor, pixels: torch.Tensor, weights: torch.Tensor,
             npix, offset_length: int = 50, n_iter: int = 100,
             threshold: float = 1e-6,
             ground_ids: torch.Tensor | None = None,
             az: torch.Tensor | None = None, n_groups: int = 0,
             precond: str = "jacobi", cg_dot: str = "f32"
             ) -> DestriperResult:
    """Destripe a flat TOD vector by per-sample scatter (``destriper.py:507``).

    ``tod``/``weights`` f32[N] with N a multiple of ``offset_length``;
    ``pixels`` i64/i32[N], invalid samples negative or ``>= npix``;
    ``npix`` an int or a :class:`PixelSpace`. ``ground_ids``/``az``
    (per-sample group id and normalised azimuth) enable the joint ground
    template. Jacobi (the per-sample diagonal approximation) acts on the
    offsets; the ground block is never scaled. All tensors on the
    device the solve runs on."""
    _check_precond(precond)
    _check_cg_dot(cg_dot)
    n = tod.shape[0]
    if n % offset_length:
        raise ValueError(f"N={n} is not a multiple of offset_length="
                         f"{offset_length}")
    n_offsets = n // offset_length
    npix = resolve_npix(npix)
    with_ground = ground_ids is not None
    if with_ground:
        ground_ids = ground_ids.to(torch.int64)
    tod, weights = scrub_tod(tod, weights)
    sum_w = accumulate_weights(pixels, weights, npix)

    def z_map(d):
        m = bin_map(d, pixels, weights, npix, sum_w=sum_w)
        return weights * (d - sample_map(m, pixels))

    def matvec(x):
        offs, grd = x
        d = _expand(offs, grd, ground_ids, az, offset_length)
        return _reduce(z_map(d), ground_ids, az, n_offsets, offset_length,
                       n_groups)

    b = _reduce(z_map(tod), ground_ids, az, n_offsets, offset_length,
                n_groups)

    if precond == "none":
        precond_fn = None
    else:
        # per-sample approximation of the Jacobi correction (<= the true
        # one): still SPD, slightly weaker (destriper.py:581)
        zero = torch.zeros((), dtype=sum_w.dtype, device=sum_w.device)
        inv_sw = torch.where(sum_w > 0,
                             1.0 / torch.clamp(sum_w, min=1e-30), zero)
        d_fwf = weights.reshape(n_offsets, offset_length).sum(dim=1)
        corr = (weights * weights * sample_map(inv_sw, pixels)).reshape(
            n_offsets, offset_length).sum(dim=1)
        inv_diag = _jacobi_inverse(d_fwf - corr, d_fwf)

        def precond_fn(v):
            # identity on the ground block: its unprojected diagonal
            # starves the template directions (destriper.py:598)
            return (v[0] * inv_diag, v[1])

    x, rz, k, b_norm, diverged, _ = _cg_loop(matvec, b, _dot, n_iter,
                                             threshold, precond=precond_fn)
    offsets, ground = x
    template = _expand(offsets, ground, ground_ids, az, offset_length)
    m_naive, w_map, h_map = naive_map(tod, pixels, weights, npix,
                                      sum_w=sum_w)
    m_destriped = bin_map(tod - template, pixels, weights, npix,
                          sum_w=sum_w)
    if ground is None:
        ground = torch.zeros((0, 2), dtype=tod.dtype, device=tod.device)
    residual = torch.sqrt(rz / torch.clamp(b_norm, min=1e-30))
    return DestriperResult(offsets, ground, m_destriped, m_naive, w_map,
                           h_map, torch.tensor(k, dtype=torch.int32),
                           residual, diverged)


# ---------------------------------------------------------------------------
# host-side set-up of the planned path
# ---------------------------------------------------------------------------

def ground_ids_per_offset(ground_ids: np.ndarray,
                          offset_length: int) -> np.ndarray:
    """Per-offset ground-group ids from per-sample ids
    (``destriper.py:633``); raises when a group changes inside an
    offset."""
    ids = np.asarray(ground_ids)
    n = (ids.shape[0] // offset_length) * offset_length
    blocks = ids[:n].reshape(-1, offset_length)
    if not (blocks == blocks[:, :1]).all():
        raise ValueError("ground_ids change inside an offset; the "
                         "planned ground solve needs offset-aligned "
                         "groups (use the scatter path)")
    return blocks[:, 0].astype(np.int32)


def coarse_pattern(pixels, npix, offset_length: int, block: int = 32,
                   max_coarse: int = 4096) -> dict:
    """Weights-independent half of the coarse build (``destriper.py:651``):
    the clipped pixel stream, the offset -> block map (``block`` doubles
    until at most ``max_coarse`` blocks) and the sorted (pixel, block)
    pattern, shared by every band of one pointing."""
    npix = resolve_npix(npix)
    pixels = np.asarray(pixels)
    L = int(offset_length)
    n = (pixels.size // L) * L
    pixels = pixels[:n]
    bad = (pixels < 0) | (pixels >= npix)
    pix = np.clip(pixels, 0, npix - 1).astype(np.int64)
    n_off = n // L
    K = max(int(block), 1)
    while -(-n_off // K) > max_coarse:
        K *= 2
    off_id = np.arange(n) // L
    grp = (np.arange(n_off) // K).astype(np.int32)
    n_c = int(grp[-1]) + 1 if n_off else 1
    key = pix * n_c + grp[off_id]
    uk, inv = np.unique(key, return_inverse=True)
    return {"n": n, "bad": bad, "pix": pix, "off_id": off_id,
            "grp": grp, "n_c": n_c, "inv": inv,
            "rows": uk // n_c, "cols": uk % n_c, "npix": int(npix),
            "offset_length": L, "block": int(block)}


def build_coarse_preconditioner(pixels, weights, npix, offset_length: int,
                                block: int = 32, ridge: float = 3e-3,
                                max_coarse: int = 4096,
                                pattern: dict | None = None):
    """Two-level preconditioner set-up on the host in f64
    (``destriper.py:683``): the exact Galerkin coarse matrix over blocks
    of offsets,

        A_c = diag(sum w per block) - Mat^T diag(1/sumw_pix) Mat,

    its global-constant null mode pinned by a rank-one shift
    ``mean(diag) * 11^T / n_c`` plus a ``ridge * mean(diag)`` f32 guard,
    inverted by Cholesky, symmetrised and cast to f32. Returns
    ``(grp, ac_inv)``: i32[n_off] offset -> block, f32[n_c, n_c]."""
    import scipy.linalg as sl
    import scipy.sparse as sp

    npix = resolve_npix(npix)
    if pattern is None:
        pattern = coarse_pattern(pixels, npix, offset_length, block=block,
                                 max_coarse=max_coarse)
    elif (pattern["npix"] != int(npix)
          or pattern["offset_length"] != int(offset_length)
          or pattern["block"] != int(block)):
        raise ValueError(
            "pattern geometry mismatch: built for (npix, offset_length,"
            f" block) = ({pattern['npix']}, {pattern['offset_length']},"
            f" {pattern['block']}), called with ({npix},"
            f" {offset_length}, {block})")
    n, pix, off_id = pattern["n"], pattern["pix"], pattern["off_id"]
    if np.asarray(weights).shape[0] < n:
        raise ValueError(f"weights size {np.asarray(weights).shape[0]} "
                         f"< pattern sample count {n}")
    grp, n_c = pattern["grp"], pattern["n_c"]
    n_off = grp.size
    weights = np.asarray(weights, np.float64)[:n].copy()
    weights[pattern["bad"]] = 0.0
    sw_pix = np.bincount(pix, weights=weights, minlength=npix)
    inv_sw = np.where(sw_pix > 0, 1.0 / np.maximum(sw_pix, 1e-30), 0.0)
    sw_off = np.bincount(off_id, weights=weights, minlength=n_off)
    mw = np.bincount(pattern["inv"], weights=weights)
    mat = sp.coo_matrix((mw, (pattern["rows"], pattern["cols"])),
                        shape=(npix, n_c)).tocsr()
    d_c = np.bincount(grp, weights=sw_off, minlength=n_c)
    a_c = np.diag(d_c) - (mat.T @ sp.diags(inv_sw) @ mat).toarray()
    m = max(float(np.mean(np.diag(a_c))), 1e-30)
    a_c += m / n_c
    a_c += np.eye(n_c) * ridge * m
    try:
        inv = sl.cho_solve(sl.cho_factor(a_c), np.eye(n_c))
    except np.linalg.LinAlgError:
        # a ridged Galerkin A_c is SPD by construction: a failure here is
        # an assembly bug, surfaced loudly while the LU inverse keeps the
        # solve alive (destriper.py:779)
        logger.warning("coarse A_c failed Cholesky (not SPD?) — LU "
                       "fallback; check the preconditioner assembly")
        inv = np.linalg.inv(a_c)
    inv = (inv + inv.T) / 2.0
    return grp, inv.astype(np.float32)


# ---------------------------------------------------------------------------
# planned path
# ---------------------------------------------------------------------------

def destripe_planned(tod: torch.Tensor, weights: torch.Tensor,
                     plan: PointingPlan, n_iter: int = 100,
                     threshold: float = 1e-6,
                     axis_name=None, dense_maps: bool = True,
                     device_arrays: dict | None = None,
                     ground_off=None, az=None, n_groups: int = 0,
                     coarse=None, mg=None, banded=None,
                     x0: torch.Tensor | None = None,
                     precond: str = "jacobi", cg_dot: str = "f32",
                     trace_iters: int = 0) -> DestriperResult:
    """Destripe with a precomputed plan (``destriper.py:989``).

    ``tod``/``weights``: f32[..., N] in natural sample order on the
    device the solve runs on; a leading axis is a multi-RHS solve
    (``offsets``, the destriped/naive/weight maps and ``residual`` gain
    it, ``hit_map`` and ``n_iter`` stay shared). ``dense_maps=False``
    returns compact maps over ``plan.uniq_pixels``. ``x0``: warm-start
    offsets. ``trace_iters``: depth of the per-iteration
    ``(rr, alpha, beta)`` histories, returned with ``|b|^2`` in
    ``trace``.

    ``ground_off`` (i32[n_off] per-offset group id, from
    :func:`ground_ids_per_offset`), ``az`` (f32[N] normalised azimuth)
    and ``n_groups`` enable the joint az-linear ground template
    (single-RHS, cold start). ``coarse``: ``(grp, ac_inv)`` from
    :func:`build_coarse_preconditioner` upgrades Jacobi to the additive
    two-level preconditioner; ``ac_inv`` may carry a leading band axis.
    Both compose; the coarse correction acts on the offsets block."""
    _check_precond(precond, coarse, mg)
    with_ground = ground_off is not None
    if with_ground and tod.ndim != 1:
        raise ValueError("the planned ground solve is single-RHS; "
                         "use destripe() or per-band solves otherwise")
    if banded is not None and with_ground:
        raise ValueError("banded noise weighting composes with the "
                         "offsets-only solves; the joint ground solve "
                         "keeps the white-weight operator (run "
                         "noise_weight = white there)")
    if x0 is not None and with_ground:
        raise ValueError("x0 warm start is offsets-only; the joint "
                         "ground solve restarts cold")
    unported = {"axis_name": axis_name, "device_arrays": device_arrays,
                "mg": mg, "banded": banded}
    for name, val in unported.items():
        if val is not None:
            raise NotImplementedError(
                f"destripe_planned({name}=...) is not ported yet")
    _check_cg_dot(cg_dot)
    dv = plan.device(tod.device)
    tod, weights = scrub_tod(tod, weights)
    dt = tod.dtype
    dev = tod.device
    n_off, n_rank = plan.n_offsets, plan.n_rank
    P_pad = int(dv["pair_rank"].shape[0])
    N_pad = int(dv["sample_perm"].shape[0])
    N = tod.shape[-1]
    zero = torch.zeros((), dtype=dt, device=dev)

    perm = dv["sample_perm"].to(torch.int64)
    pad_mask = (torch.arange(N_pad, device=dev) < N).to(dt)
    w_s = torch.index_select(weights, -1, perm) * pad_mask
    wd_s = w_s * torch.index_select(tod, -1, perm)

    def pair_sum(v):
        return binned_window_sum(v, dv["sample_pair"], dv["sample_base"],
                                 plan.sample_window, plan.sample_chunk,
                                 P_pad)

    def rank_sum(pv):
        return binned_window_sum(pv, dv["pair_rank"], dv["rank_base"],
                                 plan.rank_window, plan.pair_chunk, n_rank)

    perm_off = dv["pair_perm_off"].to(torch.int64)
    po_off = dv["pair_offset"][perm_off]
    pr_off = dv["pair_rank"][perm_off].to(torch.int64)
    pr_off_ok = pr_off < n_rank
    pr_off_clip = torch.clamp(pr_off, 0, max(n_rank - 1, 0))
    pair_off_clip = torch.clamp(dv["pair_offset"].to(torch.int64), 0,
                                n_off - 1)

    def off_sum(pv_off):
        return binned_window_sum(pv_off, po_off, dv["off_base"],
                                 plan.off_window, plan.pair_chunk, n_off)

    pair_w = pair_sum(w_s)
    pair_wd = pair_sum(wd_s)
    pair_cnt = pair_sum(pad_mask)
    pair_w_off = torch.index_select(pair_w, -1, perm_off)
    pair_wd_off = torch.index_select(pair_wd, -1, perm_off)
    sum_w = rank_sum(pair_w)
    diag = off_sum(pair_w_off)

    def to_map(pv):
        s = rank_sum(pv)
        return torch.where(sum_w > 0, s / torch.clamp(sum_w, min=1e-30),
                           zero)

    def gather_a(a):
        # padding pairs' sentinel offset clamps to a[-1]; their pair_w is 0
        return torch.index_select(a, -1, pair_off_clip)

    def gather_m(m):
        # invalid-pixel pairs read 0 from the map; OFFSET-order output
        if n_rank == 0:
            return torch.zeros(m.shape[:-1] + pr_off.shape, dtype=dt,
                               device=dev)
        return torch.where(pr_off_ok, torch.index_select(m, -1, pr_off_clip),
                           zero)

    def matvec(a):
        pav = pair_w * gather_a(a)
        m = to_map(pav)
        return diag * a - off_sum(pair_w_off * gather_m(m))

    m_d = to_map(pair_wd)
    gm_md = gather_m(m_d)
    b = off_sum(pair_wd_off - pair_w_off * gm_md)

    if precond == "none":
        apply_precond = None
    else:
        inv_sw = torch.where(sum_w > 0,
                             1.0 / torch.clamp(sum_w, min=1e-30), zero)
        corr = off_sum(pair_w_off * pair_w_off * gather_m(inv_sw))
        inv_diag = _jacobi_inverse(diag - corr, diag)
        if coarse is None:
            def apply_precond(v):
                return v * inv_diag
        else:
            c_grp = torch.as_tensor(coarse[0], device=dev).to(torch.int64)
            ac_inv = torch.as_tensor(coarse[1], dtype=dt, device=dev)
            n_c = ac_inv.shape[-1]

            def apply_precond(v):
                # additive two-level: Jacobi + the coarse-grid correction
                # (sum to blocks, small dense solve as a product, gather
                # back)
                rc = torch.zeros(v.shape[:-1] + (n_c,), dtype=dt,
                                 device=dev).index_add_(-1, c_grp, v)
                cc = torch.einsum("...ij,...j->...i", ac_inv, rc)
                return v * inv_diag + torch.index_select(cc, -1, c_grp)

    if with_ground:
        # joint [offsets; ground] solve in the same pair space: the
        # per-pair template coefficients c0 = a + g0, c1 = g1 are read
        # through the per-offset domain (destriper.py:1416)
        az_s = torch.index_select(torch.as_tensor(az, dtype=dt, device=dev),
                                  -1, perm)
        paz = pair_sum(w_s * az_s)
        pazaz = pair_sum(w_s * az_s * az_s)
        pazd = pair_sum(wd_s * az_s)
        paz_off = torch.index_select(paz, -1, perm_off)
        pazaz_off = torch.index_select(pazaz, -1, perm_off)
        pazd_off = torch.index_select(pazd, -1, perm_off)
        grp_off = torch.as_tensor(ground_off, device=dev).to(torch.int64)

        def c_gather(c):
            # K4: sentinel pairs read 0.0; pair_w_off, paz_off and
            # pazaz_off are 0 there, so the products match a clamped read
            return windowed_gather(c, po_off, dv["off_base"],
                                   plan.off_window, plan.pair_chunk)

        def group_sum(v_off):
            return torch.zeros(n_groups, dtype=dt, device=dev).index_add_(
                0, grp_off, v_off)

        def matvec_g(x):
            a_, g = x
            # c0 = a + g0[grp], c1 = g1[grp] written as the two rows of
            # one source, so each gather below is one launch for both
            c = torch.empty((2, n_off), dtype=dt, device=dev)
            torch.add(a_, g[:, 0][grp_off], out=c[0])
            torch.index_select(g[:, 1], 0, grp_off, out=c[1])
            ga = gather_a(c)
            q_rank = pair_w * ga[0] + paz * ga[1]
            gm = gather_m(to_map(q_rank))
            g0, g1 = c_gather(c)
            off_f = off_sum(pair_w_off * g0 + paz_off * g1
                            - pair_w_off * gm)
            off_az = off_sum(paz_off * g0 + pazaz_off * g1 - paz_off * gm)
            return (off_f, torch.stack([group_sum(off_f),
                                        group_sum(off_az)], -1))

        b_az = off_sum(pazd_off - paz_off * gm_md)
        b_g = (b, torch.stack([group_sum(b), group_sum(b_az)], -1))
        precond_g = None
        if apply_precond is not None:
            def precond_g(v):
                # identity on the ground block, as in the scatter path
                return (apply_precond(v[0]), v[1])

        x, rz, k, b_norm, diverged, cg_trace = _cg_loop(
            matvec_g, b_g, _dot, n_iter, threshold, precond=precond_g,
            trace_n=trace_iters)
        a, ground = x
        c0 = a + ground[:, 0][grp_off]
        c1 = ground[:, 1][grp_off]
        pair_res = pair_wd - (pair_w * gather_a(c0) + paz * gather_a(c1))
    else:
        def dot_b(u, v):
            return (u * v).sum(dim=-1)

        a, rz, k, b_norm, diverged, cg_trace = _cg_loop(
            matvec, b, dot_b, n_iter, threshold, precond=apply_precond,
            x0=x0, trace_n=trace_iters)
        ground = torch.zeros((0, 2), dtype=dt, device=dev)
        pair_res = pair_wd - pair_w * gather_a(a)

    uniq = dv["uniq_pixels"].to(torch.int64)

    def expand(cmp):
        if not dense_maps:
            return cmp
        full = torch.zeros(cmp.shape[:-1] + (plan.npix,), dtype=dt,
                           device=dev)
        full[..., uniq] = cmp
        return full

    m_destriped = expand(to_map(pair_res))
    m_naive = expand(m_d)
    w_map = expand(sum_w)
    h_map = expand(rank_sum(pair_cnt))
    residual = torch.sqrt(rz / torch.clamp(b_norm, min=1e-30))
    trace = None if cg_trace is None else (cg_trace + (b_norm,))
    return DestriperResult(a, ground, m_destriped, m_naive, w_map, h_map,
                           torch.tensor(k, dtype=torch.int32), residual,
                           diverged, trace=trace)
