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
  unknown block; its offset-order coefficient reads are kernel K4.
  Preconditioners: Jacobi, the two-level one (``coarse=``, an exact
  Galerkin coarse-grid correction over blocks of offsets) and the
  multigrid V-cycle over a ladder of offset blocks (``mg=``, host build
  :func:`build_multigrid_hierarchy`). ``banded=`` adds the measured-noise
  offset prior of :mod:`~comapreduce_tpu_torch.mapmaking.noise_weight`
  to the operator, and ``cg_dot="compensated"`` runs the CG dots in
  float-float (:mod:`~comapreduce_tpu_torch.ops.precision`). The V-cycle,
  the banded shifts and the float-float dots are plain PyTorch, as they
  are plain ``jnp`` outside any Pallas kernel in the reference.
- :func:`destripe`, the scatter path: per-sample ``index_add_`` binning,
  the oracle, and the route for ground groups that are not
  offset-aligned. Plain PyTorch on both devices, as the reference has no
  kernel there either.

Around the solve: :func:`watched_solve` runs one under the watchdog's
``mapmaking.cg_solve`` wall budget, and :func:`save_solver_checkpoint` /
:func:`load_solver_checkpoint` write and read the durable CG snapshots
of the checkpointed band solve (the reference's ``.npz`` schema and
``.s256`` sidecars, so either package resumes the other's).

Not ported yet (``NotImplementedError``): sharded plans (``axis_name=``,
``device_arrays=``).
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from comapreduce_tpu_torch.mapmaking.binning import (accumulate_weights,
                                                     bin_map, naive_map,
                                                     pixel_stream,
                                                     sample_map)
from comapreduce_tpu_torch.mapmaking.cuda_binning import windowed_gather
from comapreduce_tpu_torch.mapmaking.pixel_space import resolve_npix
from comapreduce_tpu_torch.mapmaking.pointing_plan import (PointingPlan,
                                                           binned_window_sum)
from comapreduce_tpu_torch.ops.precision import precise_dot
from comapreduce_tpu_torch.ops.segment import plan_segments, segment_sums
from comapreduce_tpu_torch.resilience.integrity import (
    CorruptArtifactError, committed_replace, drop_sidecar, verify_file)
from comapreduce_tpu_torch.resilience.tripwires import scrub_tod

__all__ = ["DestriperResult", "destripe", "destripe_planned",
           "ground_ids_per_offset", "coarse_pattern",
           "build_coarse_preconditioner", "multigrid_levels",
           "multigrid_patterns", "build_multigrid_hierarchy",
           "stack_multigrid", "MultigridUnavailable", "DIVERGENCE_K",
           "DIVERGENCE_GROWTH", "watched_solve", "save_solver_checkpoint",
           "load_solver_checkpoint"]

logger = logging.getLogger("comapreduce_tpu_torch")

# CG divergence tripwire (``destriper.py:93``): diverged after
# DIVERGENCE_K consecutive checks with |r|^2 > DIVERGENCE_GROWTH x the
# best iterate's (converged systems exempt)
DIVERGENCE_K = 6
DIVERGENCE_GROWTH = 100.0


class MultigridUnavailable(ValueError):
    """The geometry admits no multigrid ladder: every offset-block level
    would have fewer than 2 unknowns (``destriper.py:56``). A type of its
    own, so the band solve's Jacobi fallback catches this refusal and no
    other error."""


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


def watched_solve(solve, watchdog=None, name: str = "mapmaking.cg_solve",
                  unit: str = ""):
    """Run one (device-driving) CG solve under a wall budget.

    Device compute cannot be cancelled in place, so this is the
    UNCANCELLABLE arm of the watchdog (``Watchdog.watch``): the soft
    deadline fires the structured ``stalled`` warning + ledger event
    mid-solve; a blown hard deadline sets ``state.hard_expired`` and
    the caller routes the late result through the SAME operator signal
    path as a tripped divergence monitor — a loud warning naming the
    band, never a silent late map. Completed solve durations feed the
    watchdog's adaptive percentile, so a campaign's per-CG budget
    tightens around measured behaviour (hard = p95 x scale, floored by
    config).

    Returns ``(result, state)``; ``state`` is None when unwatched. The
    watch closes when ``solve`` returns, so on the card ``solve`` must
    synchronise its device before it returns (``cli.run_destriper.
    _watched_cg`` does): a solve that returns at launch time would
    record the launch wall and never blow a hard deadline.
    """
    if watchdog is None:
        return solve(), None
    with watchdog.watch(name, unit=unit) as state:
        result = solve()
    return result, state


def save_solver_checkpoint(path: str, offsets, n_done: int,
                           residuals, precond_id: str,
                           durable: bool = True) -> None:
    """Durably snapshot a partial CG solve: ``(x, iter, residual
    history, preconditioner id)`` — written every ``[Destriper]
    checkpoint_every`` iterations by the chunked solve in
    ``cli.run_destriper`` so a solve killed at iteration 140/142
    resumes from 140, not 0.

    Same discipline as every other checkpoint in the repo
    (``data/durable.py``): full write + fsync to a temp file, then an
    atomic replace — a SIGKILL mid-save leaves either the previous
    complete snapshot or a stray temp file, never a torn snapshot
    under the live name.
    """
    if isinstance(offsets, torch.Tensor):
        # a solve on the card hands its offsets over as f32 numpy
        offsets = offsets.detach().to("cpu", torch.float32).numpy()
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".solver.", suffix=".tmp",
                               dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, schema=np.int64(1),
                     offsets=np.asarray(offsets),
                     n_done=np.int64(n_done),
                     residuals=np.asarray(residuals, dtype=np.float64),
                     precond_id=np.bytes_(
                         str(precond_id).encode("utf-8")))
        committed_replace(tmp, path, kind="solver", durable=durable)
        tmp = ""
    finally:
        if tmp:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def load_solver_checkpoint(path: str,
                           precond_id: str | None = None) -> dict | None:
    """Read a solver snapshot; None when absent, torn, foreign-schema
    or written under a DIFFERENT preconditioner/geometry id (warm-
    starting CG from another operator's iterate is a correctness trap,
    not a resume) — every None falls back to a fresh solve, never an
    error: a corrupt snapshot must cost iterations, not the campaign.

    Returns ``{"offsets": f32[n], "n_done": int, "residuals":
    [float...], "precond_id": str}``.
    """
    if not path or not os.path.exists(path):
        return None
    try:
        # verify-on-read: a bit-rotted snapshot must be detected here
        # and cost a cold solve — warm-starting CG from damaged floats
        # would converge to a silently wrong map
        verify_file(path, kind="solver")
    except CorruptArtifactError as exc:
        logger.warning("solver checkpoint %s failed its sha256 "
                       "manifest (%s); unlinking — the solve restarts "
                       "fresh", path, exc)
        try:
            os.unlink(path)
        except OSError:
            pass
        drop_sidecar(path)
        return None
    try:
        with np.load(path) as z:
            if int(z["schema"]) != 1:
                logger.warning("solver checkpoint %s: unknown schema "
                               "%s; starting fresh", path,
                               int(z["schema"]))
                return None
            snap = {
                "offsets": np.asarray(z["offsets"]),
                "n_done": int(z["n_done"]),
                "residuals": [float(v) for v in z["residuals"]],
                "precond_id": bytes(z["precond_id"].item()
                                    if z["precond_id"].shape == ()
                                    else z["precond_id"]
                                    ).decode("utf-8", "replace"),
            }
    except Exception as exc:
        logger.warning("solver checkpoint %s unreadable (%s: %s); "
                       "starting the solve fresh", path,
                       type(exc).__name__, exc)
        return None
    if precond_id is not None and snap["precond_id"] != str(precond_id):
        logger.warning(
            "solver checkpoint %s was written under %r but this solve "
            "is %r (preconditioner/geometry changed); starting fresh",
            path, snap["precond_id"], str(precond_id))
        return None
    return snap


def _jacobi_inverse(diag_a: torch.Tensor, diag_fwf: torch.Tensor,
                    floor: float = 1e-6) -> torch.Tensor:
    """1/diag(A), falling back to the plain F^T W F diagonal on offsets
    Z absorbs and to 1 on zero-weight offsets (``destriper.py:316``)."""
    cut = floor * torch.clamp(diag_fwf, min=1e-30)
    one = torch.ones((), dtype=diag_a.dtype, device=diag_a.device)
    safe = torch.where(diag_a > cut, diag_a,
                       torch.where(diag_fwf > 0, diag_fwf, one))
    return 1.0 / safe


def _flush_subnormals(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its subnormal entries set to 0."""
    return torch.where(t.abs() < torch.finfo(t.dtype).tiny,
                       torch.zeros_like(t), t)


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
    if cg_dot not in ("f32", "compensated"):
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


def _reduce(wr, g_plan, az, n_offsets, offset_length):
    """The adjoint: TOD -> (per-offset sums, per-group ``[sum, sum az]``,
    the groups' sums in the fixed order of ``g_plan``)."""
    a = wr.reshape(n_offsets, offset_length).sum(dim=1)
    if g_plan is None:
        return a, None
    return a, torch.stack([segment_sums(wr, g_plan),
                           segment_sums(wr * az, g_plan)], dim=-1)


def _dot(x, y):
    """CG inner product over the (offsets, ground) unknowns."""
    s = (x[0] * y[0]).sum()
    if x[1] is not None:
        s = s + (x[1] * y[1]).sum()
    return s


def _dot_compensated(x, y):
    """:func:`_dot` with each block contracted by the float-float
    :func:`~comapreduce_tpu_torch.ops.precision.precise_dot`
    (``destriper.py:291``)."""
    s = precise_dot(x[0], y[0])
    if x[1] is not None:
        s = s + precise_dot(x[1], y[1])
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
    g_plan = None
    if with_ground:
        ground_ids = ground_ids.to(torch.int64)
        g_plan = plan_segments(ground_ids, n_groups, one_launch=True)
    tod, weights = scrub_tod(tod, weights)
    # the stream's sums planned once, outside the CG loop
    pixels = pixel_stream(pixels, npix)
    sum_w = accumulate_weights(pixels, weights, npix)

    def z_map(d):
        m = bin_map(d, pixels, weights, npix, sum_w=sum_w)
        return weights * (d - sample_map(m, pixels))

    def matvec(x):
        offs, grd = x
        d = _expand(offs, grd, ground_ids, az, offset_length)
        return _reduce(z_map(d), g_plan, az, n_offsets, offset_length)

    b = _reduce(z_map(tod), g_plan, az, n_offsets, offset_length)

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

    dot = _dot_compensated if cg_dot == "compensated" else _dot
    x, rz, k, b_norm, diverged, _ = _cg_loop(matvec, b, dot, n_iter,
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


def multigrid_levels(n_offsets: int, block: int = 8, levels: int = 2,
                     max_coarse: int = 4096) -> list[int]:
    """The offset-block ladder ``b_1 < ... < b_L`` of the multigrid
    hierarchy, finest to coarsest (``destriper.py:792``): ``block``
    times 8 per level, the coarsest doubled until its system fits
    ``max_coarse`` unknowns; levels that stop coarsening or leave fewer
    than 2 unknowns are dropped (a 1-block system is pure null mode),
    down to a halving two-grid block, or ``[]`` when no level with 2
    unknowns exists (``n_offsets < 3``)."""
    blocks = []
    b = max(int(block), 2)
    for _ in range(max(int(levels), 1)):
        blocks.append(b)
        b *= 8
    n_off = max(int(n_offsets), 1)
    while -(-n_off // blocks[-1]) > max_coarse:
        blocks[-1] *= 2
    # every surviving block divides every larger one, so dropping a level
    # keeps the adjacent-level nesting
    out = []
    prev_n = n_off
    for bk in blocks:
        n_b = -(-n_off // bk)
        if 2 <= n_b < prev_n:
            out.append(bk)
            prev_n = n_b
    if out:
        return out
    half = -(-n_off // 2)
    return [half] if half >= 2 and -(-n_off // half) >= 2 else []


def multigrid_patterns(pixels, npix, offset_length: int, block: int = 8,
                       levels: int = 2, max_coarse: int = 4096) -> dict:
    """Weights-independent half of the multigrid build
    (``destriper.py:838``): one :func:`coarse_pattern` per ladder level,
    shared by every band of one pointing. Raises
    :class:`MultigridUnavailable` when the geometry admits no level."""
    npix = resolve_npix(npix)
    pixels = np.asarray(pixels)
    n_off = (pixels.size // int(offset_length))
    blocks = multigrid_levels(n_off, block=block, levels=levels,
                              max_coarse=max_coarse)
    if not blocks:
        raise MultigridUnavailable(
            f"n_offsets={n_off} is too small for any multigrid level "
            "(every block leaves < 2 unknowns — the coarse system "
            "would be pure null mode); run jacobi/twolevel instead")
    # intermediate patterns keep their exact block (no internal doubling)
    pats = [coarse_pattern(pixels, npix, offset_length, block=bk,
                           max_coarse=max(n_off, 1))
            for bk in blocks[:-1]]
    pats.append(coarse_pattern(pixels, npix, offset_length,
                               block=blocks[-1],
                               max_coarse=max_coarse))
    return {"blocks": blocks, "patterns": pats}


def build_multigrid_hierarchy(pixels, weights, npix, offset_length: int,
                              block: int = 8, levels: int = 2,
                              max_coarse: int = 4096, ridge: float = 3e-3,
                              patterns: dict | None = None) -> tuple:
    """Galerkin offset-block hierarchy of the multigrid V-cycle, built on
    the host in f64 (``destriper.py:868``; the same numpy and scipy calls
    in the same order, so the output is the reference's bit for bit).

    Each intermediate level ``k`` (block ``b_k``) carries the exact
    Galerkin operator

        A_k = diag(sum w per block) - Mat_k^T diag(1/sumw_pix) Mat_k

    as COO triplets with its Jacobi inverse diagonal; the coarsest level
    is :func:`build_coarse_preconditioner`'s dense ridged inverse. Every
    level keeps zero row sums and non-positive off-diagonals, so
    ``lambda(D_k^{-1} A_k) <= 2`` and any damping ``omega < 1`` gives a
    convergent smoother and an SPD V-cycle.

    Returns a tuple of per-level dicts of numpy arrays: intermediate
    levels ``{grp, rows, cols, vals, invd}`` (``grp`` maps the previous
    level's index to this level's block), the coarsest ``{grp, ac_inv}``.
    Bands with their own weights share ``patterns`` and stack with
    :func:`stack_multigrid`."""
    import scipy.sparse as sp

    npix = resolve_npix(npix)
    if patterns is None:
        patterns = multigrid_patterns(pixels, npix, offset_length,
                                      block=block, levels=levels,
                                      max_coarse=max_coarse)
    blocks, pats = patterns["blocks"], patterns["patterns"]
    p0 = pats[0]
    n, pix, off_id = p0["n"], p0["pix"], p0["off_id"]
    n_off = p0["grp"].size
    w = np.asarray(weights, np.float64)[:n].copy()
    w[p0["bad"]] = 0.0

    sw_pix = np.bincount(pix, weights=w, minlength=npix)
    inv_sw = np.where(sw_pix > 0, 1.0 / np.maximum(sw_pix, 1e-30), 0.0)
    sw_off = np.bincount(off_id, weights=w, minlength=n_off)

    out = []
    for k, pat in enumerate(pats[:-1]):
        n_c = pat["n_c"]
        mw = np.bincount(pat["inv"], weights=w)
        mat = sp.coo_matrix((mw, (pat["rows"], pat["cols"])),
                            shape=(npix, n_c)).tocsr()
        d_c = np.bincount(pat["grp"], weights=sw_off, minlength=n_c)
        a_k = (sp.diags(d_c) - mat.T @ sp.diags(inv_sw) @ mat).tocsr()
        diag = a_k.diagonal()
        # level Jacobi inverse, _jacobi_inverse's degenerate-offset rule
        cut = 1e-6 * np.maximum(d_c, 1e-30)
        safe = np.where(diag > cut, diag, np.where(d_c > 0, d_c, 1.0))
        coo = a_k.tocoo()
        grp = (pat["grp"] if k == 0 else
               np.arange(-(-n_off // blocks[k - 1]), dtype=np.int64)
               // (blocks[k] // blocks[k - 1]))
        out.append({"grp": np.asarray(grp, np.int32),
                    "rows": coo.row.astype(np.int32),
                    "cols": coo.col.astype(np.int32),
                    "vals": coo.data.astype(np.float32),
                    "invd": (1.0 / safe).astype(np.float32)})
    # coarsest: the dense ridged inverse, restricted from the last
    # intermediate level (or from the offsets on a one-level ladder)
    _, ac_inv = build_coarse_preconditioner(
        pixels, weights, npix, offset_length, block=blocks[-1],
        ridge=ridge, max_coarse=max_coarse, pattern=pats[-1])
    if len(blocks) == 1:
        grp_c = pats[-1]["grp"]
    else:
        n_prev = -(-n_off // blocks[-2])
        grp_c = np.arange(n_prev, dtype=np.int64) \
            // (blocks[-1] // blocks[-2])
    out.append({"grp": np.asarray(grp_c, np.int32), "ac_inv": ac_inv})
    return tuple(out)


def stack_multigrid(hierarchies: list) -> tuple:
    """Per-band hierarchies (shared patterns) as one multi-RHS hierarchy
    (``destriper.py:969``): ``vals``, ``invd`` and ``ac_inv`` gain a
    leading band axis; the index stencils are taken from the first."""
    first = hierarchies[0]
    out = []
    for lv_i, lv in enumerate(first):
        stacked = {}
        for key, val in lv.items():
            if key in ("vals", "invd", "ac_inv"):
                stacked[key] = np.stack(
                    [np.asarray(h[lv_i][key]) for h in hierarchies])
            else:
                stacked[key] = val
        out.append(stacked)
    return tuple(out)


# ---------------------------------------------------------------------------
# planned path
# ---------------------------------------------------------------------------

def _vcycle_precond(mg, matvec, inv_diag, mg_smooth: int, omega: float,
                    dt, dev):
    """The symmetric V(nu, nu)-cycle of :func:`destripe_planned`'s ``mg=``
    (``destriper.py:1342-1395``) as a preconditioner ``v -> M^-1 v``.

    At each level: pre-smooth from zero (the first damped-Jacobi step is
    ``x = omega D^-1 r`` exactly, no matvec), restrict the residual to the
    next level's blocks (exact Galerkin), recurse (the coarsest level is
    one product with its dense inverse), prolong by ``index_select`` and
    post-smooth ``nu`` times. Level operators below the fine one are
    their COO triplets, applied as one gather, multiply and segment sum
    over the rows. Every sum adds in a fixed order
    (:func:`~comapreduce_tpu_torch.ops.segment.segment_sums`, planned here
    once). Leading band axes of the hierarchy broadcast."""
    nu = max(int(mg_smooth), 1)
    levels = []
    for lv in mg:
        t = {"grp": torch.as_tensor(np.asarray(lv["grp"]), device=dev).to(
            torch.int64)}
        n_next = np.asarray(lv["ac_inv"] if "ac_inv" in lv
                            else lv["invd"]).shape[-1]
        t["grp_plan"] = plan_segments(lv["grp"], n_next, one_launch=True)
        if "ac_inv" in lv:
            t["ac_inv"] = torch.as_tensor(lv["ac_inv"], dtype=dt, device=dev)
        else:
            t["rows_plan"] = plan_segments(
                lv["rows"], np.asarray(lv["invd"]).shape[-1],
                one_launch=True)
            t["cols"] = torch.as_tensor(np.asarray(lv["cols"]),
                                        device=dev).to(torch.int64)
            t["vals"] = torch.as_tensor(lv["vals"], dtype=dt, device=dev)
            t["invd"] = torch.as_tensor(lv["invd"], dtype=dt, device=dev)
        levels.append(t)

    def coo_apply(lv, x):
        # A_k x over the level's triplets; bands broadcast through
        contrib = lv["vals"] * torch.index_select(x, -1, lv["cols"])
        return segment_sums(contrib, lv["rows_plan"])

    def vcycle(idx, r, apply_a, invd):
        x = omega * invd * r
        for _ in range(nu - 1):
            x = x + omega * invd * (r - apply_a(x))
        lv = levels[idx]
        res = r - apply_a(x)
        if "ac_inv" in lv:            # coarsest: the dense ridged inverse
            rc = segment_sums(res, lv["grp_plan"])
            ec = torch.einsum("...ij,...j->...i", lv["ac_inv"], rc)
        else:
            rc = segment_sums(res, lv["grp_plan"])
            ec = vcycle(idx + 1, rc, lambda v, lv=lv: coo_apply(lv, v),
                        lv["invd"])
        x = x + torch.index_select(ec, -1, lv["grp"])
        for _ in range(nu):           # symmetric post-smooth
            x = x + omega * invd * (r - apply_a(x))
        return x

    return lambda v: vcycle(0, v, matvec, inv_diag)


def destripe_planned(tod: torch.Tensor, weights: torch.Tensor,
                     plan: PointingPlan, n_iter: int = 100,
                     threshold: float = 1e-6,
                     axis_name=None, dense_maps: bool = True,
                     device_arrays: dict | None = None,
                     ground_off=None, az=None, n_groups: int = 0,
                     coarse=None, mg=None, mg_smooth: int = 1,
                     mg_omega: float = 2.0 / 3.0, banded=None,
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
    Both compose; the coarse correction acts on the offsets block.

    ``mg``: a hierarchy from :func:`build_multigrid_hierarchy` (or
    :func:`stack_multigrid` for a multi-RHS solve; numpy arrays or
    tensors) replaces the two-level correction with a symmetric
    V(nu, nu)-cycle, ``nu = mg_smooth`` damped-Jacobi steps (damping
    ``mg_omega`` in (0, 1)) around an exact-Galerkin restriction at every
    level, the coarsest solved by its dense inverse. The fine level's
    operator is this solve's own matvec, so one application costs
    ``2 nu`` fine matvecs. Requires ``precond='jacobi'``, excludes
    ``coarse``; on the ground solve it acts on the offsets block.

    ``banded``: ``(c0, cs)`` from :func:`~comapreduce_tpu_torch.
    mapmaking.noise_weight.build_banded_weight` adds the symmetric banded
    offset prior ``B`` to the operator (``A + B``; ``c0`` the diagonal,
    ``cs[..., j-1, i] = B[i, i+j]``), inside the matvec and the Jacobi
    diagonal; the right-hand side is unchanged. Leading band axes
    broadcast. Offsets-only solves only.

    ``cg_dot="compensated"`` takes the CG recurrence dots through the
    float-float :func:`~comapreduce_tpu_torch.ops.precision.precise_dot`
    (per band on a multi-RHS solve)."""
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
    unported = {"axis_name": axis_name, "device_arrays": device_arrays}
    for name, val in unported.items():
        if val is not None:
            raise NotImplementedError(
                f"destripe_planned({name}=...) is not ported yet")
    _check_cg_dot(cg_dot)
    if mg is not None and not 0.0 < float(mg_omega) < 1.0:
        raise ValueError(f"mg_omega must be in (0, 1) — the "
                         f"Gershgorin-safe damping range — got "
                         f"{float(mg_omega)}")
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

    if banded is not None:
        # the prior as the reference's XLA arithmetic reads it: f32
        # subnormals flushed to zero. A degenerate fit can make a
        # diagonal of ~1e-45; kept, its Jacobi inverse on a zero-weight
        # offset is inf and the preconditioned residual NaN (0 * inf)
        b_c0 = _flush_subnormals(torch.as_tensor(banded[0], dtype=dt,
                                                 device=dev))
        b_cs = _flush_subnormals(torch.as_tensor(banded[1], dtype=dt,
                                                 device=dev))

        def banded_apply(a):
            # the symmetric prior from its diagonal and upper bands, as
            # shifted adds with zero fill (destriper.py:1299): the builder
            # zeroes every coupling across a group boundary
            out = b_c0 * a
            for j in range(1, int(b_cs.shape[-2]) + 1):
                cj = b_cs[..., j - 1, :]
                # upper band: row i adds cj[i] * a[i+j] ...
                out = out + cj * F.pad(a[..., j:], (0, j))
                # ... and its transpose: row i+j adds cj[i] * a[i]
                out = out + F.pad((cj * a)[..., :-j], (j, 0))
            return out

    def matvec(a):
        pav = pair_w * gather_a(a)
        m = to_map(pav)
        out = diag * a - off_sum(pair_w_off * gather_m(m))
        if banded is not None:
            out = out + banded_apply(a)
        return out

    m_d = to_map(pair_wd)
    gm_md = gather_m(m_d)
    b = off_sum(pair_wd_off - pair_w_off * gm_md)

    if precond == "none":
        apply_precond = None
    else:
        inv_sw = torch.where(sum_w > 0,
                             1.0 / torch.clamp(sum_w, min=1e-30), zero)
        corr = off_sum(pair_w_off * pair_w_off * gather_m(inv_sw))
        if banded is not None:
            # diag(A + B): the prior's diagonal rides the true diagonal
            # and the degenerate-offset fallback alike
            inv_diag = _jacobi_inverse(diag - corr + b_c0, diag + b_c0)
        else:
            inv_diag = _jacobi_inverse(diag - corr, diag)
        if mg is not None:
            apply_precond = _vcycle_precond(mg, matvec, inv_diag,
                                            int(mg_smooth), float(mg_omega),
                                            dt, dev)
        elif coarse is None:
            def apply_precond(v):
                return v * inv_diag
        else:
            c_grp = torch.as_tensor(coarse[0], device=dev).to(torch.int64)
            ac_inv = torch.as_tensor(coarse[1], dtype=dt, device=dev)
            n_c = ac_inv.shape[-1]
            # the restriction's sums in a fixed order, planned once
            c_plan = plan_segments(coarse[0], n_c, one_launch=True)

            def apply_precond(v):
                # additive two-level: Jacobi + the coarse-grid correction
                # (sum to blocks, small dense solve as a product, gather
                # back)
                rc = segment_sums(v, c_plan)
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
        g_plan = plan_segments(ground_off, n_groups, one_launch=True)

        def c_gather(c):
            # K4: sentinel pairs read 0.0; pair_w_off, paz_off and
            # pazaz_off are 0 there, so the products match a clamped read
            return windowed_gather(c, po_off, dv["off_base"],
                                   plan.off_window, plan.pair_chunk)

        def group_sum(v_off):
            return segment_sums(v_off, g_plan)

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
            matvec_g, b_g,
            _dot_compensated if cg_dot == "compensated" else _dot, n_iter,
            threshold, precond=precond_g, trace_n=trace_iters)
        a, ground = x
        c0 = a + ground[:, 0][grp_off]
        c1 = ground[:, 1][grp_off]
        pair_res = pair_wd - (pair_w * gather_a(c0) + paz * gather_a(c1))
    else:
        if cg_dot == "compensated":
            def dot_b(u, v):
                return precise_dot(u, v, axis=-1)
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
