"""Polarized (I, Q, U) destriping (port of
``comapreduce_tpu/mapmaking/polarization.py``).

Each sample carries the Stokes basis ``s_t = [1, cos 2psi_t, sin
2psi_t]`` and the map solve becomes a per-pixel 3 x 3 system:

    d_t = I[p_t] + Q[p_t] cos(2 psi_t) + U[p_t] sin(2 psi_t) + (F a)_t + n_t

- :func:`destripe_pol` is the scatter oracle (plain CG): the entries of
  ``A_p = sum_t w s s^T`` and ``b_p = sum_t w d s`` are pixel sums, on
  the card in the fixed order of ``ops.segment``'s one-launch plans
  (``mapmaking.binning.pixel_stream``), on the CPU ``index_add_`` in
  sample order;
- :func:`destripe_pol_planned` is the production solve on a
  :class:`~comapreduce_tpu_torch.mapmaking.pointing_plan.PointingPlan`,
  floored-Jacobi CG, its sums all kernel K3 (``binned_window_sum``, as
  the reference's are ``binned_window_sum_pallas`` through
  ``pointing_plan.binned_window_sum``): the ten stacked pair rows at
  R = 10 once, the seven rank rows (the six unique ``A_p`` entries and
  the hits) at R = 7 once, then at R = 3 the rank sum of each CG
  iteration and of the naive and destriped maps, and the offset sums at
  R = 1. A solve of ``k`` iterations launches K3 ``7 + 2 k`` times.

The per-pixel 3 x 3 work (determinant, inverse, solve) is
``torch.linalg``, as the reference's is ``jnp.linalg`` outside any
Pallas kernel. Pixels with too little angle diversity are masked
(:func:`_ata_scale_solvable`, one rule for both paths). The planned
solve holds its masked inverses in float64 and applies them in float64
(:func:`_masked_inverse`, :func:`_apply_inverse`), on the card as on the
CPU: a kept pixel's normalised determinant may be as small as 1e-6, and
an f32 inverse of such a block, stored or applied, errs by a large part
of the map it solves for, which left the CG operator inconsistent and
the solve landing 2-3x above the reference on its hard problem
(``tests/torch_pol_spread.py``). Every input and output of those steps
stays float32, and every sum stays K3's. Both entry points
take numpy arrays or tensors and compute on ``device`` (``None``: the
card; raises without one). ``axis_name`` is the reference's sharded
scatter solve (``polarization.py:102-116``): inside an SPMD run
(:mod:`~comapreduce_tpu_torch.parallel.spmd`) with the time axis split,
``A_p``, the hits, ``b_p``, the CG dots and the zero-mean pinning are
summed over the mesh (:func:`destripe_pol_sharded` drives it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from comapreduce_tpu_torch._device import resolve_device
from comapreduce_tpu_torch.mapmaking.binning import _segment, pixel_stream
from comapreduce_tpu_torch.mapmaking.destriper import (_cg_loop,
                                                       _jacobi_inverse)
from comapreduce_tpu_torch.mapmaking.pointing_plan import binned_window_sum
from comapreduce_tpu_torch.parallel.spmd import psum

__all__ = ["PolMapState", "pol_map_solve", "destripe_pol", "destripe_pol_jit",
           "destripe_pol_planned", "destripe_pol_sharded",
           "PolDestriperResult"]


# the planned solve's Jacobi floor: offsets whose diag(A) falls below
# this fraction of their plain sum-w diagonal take sum w instead
# (polarization.py:41; destripe_pol_planned's docstring)
_POL_JACOBI_FLOOR = 0.05


class PolMapState(NamedTuple):
    """Per-pixel normal-equation pieces of the IQU solve."""

    ata: torch.Tensor       # f32[npix, 3, 3]
    hits: torch.Tensor      # f32[npix]
    rcond_ok: torch.Tensor  # bool[npix]: pixel solvable


class PolDestriperResult(NamedTuple):
    offsets: torch.Tensor        # f32[n_offsets]
    iqu_destriped: torch.Tensor  # f32[npix, 3]
    iqu_naive: torch.Tensor      # f32[npix, 3]
    hit_map: torch.Tensor        # f32[npix]
    solvable: torch.Tensor       # bool[npix]
    n_iter: torch.Tensor
    residual: torch.Tensor


def _stokes_basis(c2, s2):
    """s_t = [1, cos 2psi, sin 2psi] stacked (N, 3)."""
    return torch.stack([torch.ones_like(c2), c2, s2], dim=-1)


def _ata_scale(ata):
    """Per-pixel Tikhonov scale, trace / 3."""
    return torch.clamp(torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1) / 3.0,
                       min=1e-30)


def _ata_scale_solvable(ata, hits):
    """(scale, rcond_ok) of per-pixel normal matrices
    (``polarization.py:73``): the determinant of ``A_p`` normalised by
    its trace scale, solvable where ``hits >= 3`` and ``det > 1e-6``."""
    scale = _ata_scale(ata)
    det_n = torch.linalg.det(ata / scale[:, None, None])
    return scale, (hits >= 3) & (det_n > 1e-6)


def _tikhonov(ata, scale):
    """The per-pixel floor, scaled to each pixel's weight."""
    eye = torch.eye(3, dtype=ata.dtype, device=ata.device)
    return ata + (1e-6 * scale)[:, None, None] * eye


def _masked_inverse(ata, scale, rcond_ok):
    """The planned solve's prefactor: each ``A_p`` (f32[R, 3, 3], with
    its f32 trace scale) Tikhonov-regularised, inverted and held in
    float64, an unsolvable pixel's inverse all zero. f64[R, 3, 3]. A kept
    block may have a normalised determinant near 1e-6: its f32 inverse
    (the reference's) errs by up to ``eps_f32 x cond``, a large part of
    the map it solves for."""
    inv = torch.linalg.inv(_tikhonov(ata.double(), scale.double()))
    return torch.where(rcond_ok[:, None, None], inv, torch.zeros(
        (), dtype=inv.dtype, device=inv.device))


def _apply_inverse(inv_a, b_rank):
    """``m = A_p^-1 b_p`` for every pixel: (3, R) -> (3, R) in ``b_rank``'s
    dtype, the products and sums in ``inv_a``'s."""
    return torch.einsum("rkj,jr->kr", inv_a,
                        b_rank.to(inv_a.dtype)).to(b_rank.dtype)


def _pair_quadratic(inv_a_off, pws_off):
    """Each pair's ``s^T A_p^-1 s``, ``pws_off`` f32[3, P] against its
    pixel's inverse ``inv_a_off`` [P, 3, 3], in the inverse's dtype and
    rounded once to ``pws_off``'s: f32[P]."""
    pws = pws_off.to(inv_a_off.dtype)
    return torch.einsum("pij,ip,jp->p", inv_a_off, pws,
                        pws).to(pws_off.dtype)


def _pol_accumulate(pixels, weights, c2, s2, npix, axis_name=None):
    """``A_p`` (the outer products' pixel sums), hits and the solvable
    mask. ``pixels``: a tensor or a :class:`~..binning.PixelStream`."""
    stream = pixel_stream(pixels, npix)
    s = _stokes_basis(c2, s2)                              # (N, 3)
    w_outer = (s[:, :, None] * s[:, None, :]) * weights[:, None, None]
    ata = _segment(w_outer.permute(1, 2, 0), stream,
                   axis_name).permute(2, 0, 1)
    hits = _segment((weights > 0).to(weights.dtype), stream, axis_name)
    _, rcond_ok = _ata_scale_solvable(ata, hits)
    return PolMapState(ata.contiguous(), hits, rcond_ok)


def pol_map_solve(d, pixels, weights, c2, s2, npix, state: PolMapState,
                  axis_name=None):
    """Weighted IQU map: ``A_p m_p = b_p`` solved per pixel, unsolvable
    pixels 0. f32[npix, 3]."""
    stream = pixel_stream(pixels, npix)
    s = _stokes_basis(c2, s2)
    b = _segment(((weights * d)[:, None] * s).T, stream,
                 axis_name).T                              # (npix, 3)
    a_reg = _tikhonov(state.ata, _ata_scale(state.ata))
    m = torch.linalg.solve(a_reg, b[..., None])[..., 0]
    return torch.where(state.rcond_ok[:, None], m, torch.zeros_like(m))


def _on(x, dev, dtype=torch.float32):
    return torch.as_tensor(x, device=dev).to(dtype)


def destripe_pol(tod, pixels, weights, psi, npix: int,
                 offset_length: int = 50, n_iter: int = 100,
                 threshold: float = 1e-6, axis_name: str | None = None,
                 device=None) -> PolDestriperResult:
    """Destripe a polarized TOD with plain CG (``polarization.py:116``).
    ``psi``: f32[N] polarization angle [rad]; ``N`` a multiple of
    ``offset_length``. The offsets are pinned to zero mean. ``axis_name``:
    inside an SPMD run, this shard's part of the time axis (whole
    offsets); the pixel systems, the dots and the mean are summed over
    the mesh."""
    dev = resolve_device(device)
    tod, weights, psi = (_on(x, dev) for x in (tod, weights, psi))
    pixels = _on(pixels, dev, torch.int64)
    n = tod.shape[0]
    n_offsets = n // offset_length
    c2 = torch.cos(2.0 * psi)
    s2 = torch.sin(2.0 * psi)
    stream = pixel_stream(pixels, npix)
    state = _pol_accumulate(stream, weights, c2, s2, npix, axis_name)
    s_basis = _stokes_basis(c2, s2)
    safe = torch.clamp(pixels, 0, npix - 1)
    valid = (pixels >= 0) & (pixels < npix) & state.rcond_ok[safe]
    zero = torch.zeros((), dtype=tod.dtype, device=dev)

    def sample_iqu(m):
        return torch.where(valid, (m[safe] * s_basis).sum(-1), zero)

    def Z(d):
        m = pol_map_solve(d, stream, weights, c2, s2, npix, state,
                          axis_name)
        return weights * (d - sample_iqu(m))

    def FT(wr):
        return wr.reshape(n_offsets, offset_length).sum(dim=1)

    def matvec(a):
        return FT(Z(torch.repeat_interleave(a, offset_length)[:n]))

    b = FT(Z(tod))
    a, rz, k, b_norm, _, _ = _cg_loop(
        matvec, b, lambda x, y: psum((x * y).sum(), axis_name), n_iter,
        threshold)
    # a constant offset vector is near-degenerate with the I map: pin
    # the offsets to zero mean
    if axis_name is None:
        a = a - a.sum() / n_offsets
    else:
        tot = psum(a.sum(), axis_name)
        cnt = psum(torch.tensor(float(n_offsets), dtype=a.dtype,
                                device=dev), axis_name)
        a = a - tot / cnt
    template = torch.repeat_interleave(a, offset_length)[:n]
    iqu_naive = pol_map_solve(tod, stream, weights, c2, s2, npix, state,
                              axis_name)
    iqu_destriped = pol_map_solve(tod - template, stream, weights, c2, s2,
                                  npix, state, axis_name)
    residual = torch.sqrt(rz / torch.clamp(b_norm, min=1e-30))
    return PolDestriperResult(a, iqu_destriped, iqu_naive, state.hits,
                              state.rcond_ok,
                              torch.tensor(k, dtype=torch.int32), residual)


#: the reference's jitted entry point; eager PyTorch compiles nothing, so
#: it is :func:`destripe_pol` itself
destripe_pol_jit = destripe_pol


def destripe_pol_planned(tod, weights, psi, plan, n_iter: int = 100,
                         threshold: float = 1e-6,
                         device=None) -> PolDestriperResult:
    """Scatter-free polarized destriping on a plan
    (``polarization.py:193``), single right-hand side (a 2-D ``tod``
    raises).

    Within a (pixel, offset) pair the Stokes basis varies per sample, so
    the pair aggregates are 3-vectors ``pws_k = sum_t w s_k`` and
    ``pwds_k = sum_t w d s_k`` and the six unique entries of ``w s
    s^T``, summed as rows of one K3 launch. The per-pixel systems are
    inverted once (the masked inverse of the Tikhonov-regularised
    ``A_p``), so an iteration is two K3 launches and small batched
    products. The CG is preconditioned by the floored Jacobi of the
    reference: ``diag(A)`` is ``sum w`` per offset less each pair's
    ``s^T A_p^-1 s``, and an offset whose diagonal falls below
    ``_POL_JACOBI_FLOOR`` of its ``sum w`` takes ``sum w`` instead
    (``polarization.py:214``). The inverses are float64
    (:func:`_masked_inverse`), and so are their products with the pair
    and rank vectors (the map solves, each pair's ``s^T A_p^-1 s``),
    each rounded once to float32 before K3 sums it."""
    dev = resolve_device(device)
    tod, weights, psi = (_on(x, dev) for x in (tod, weights, psi))
    if tod.ndim != 1:
        raise ValueError("destripe_pol_planned is single-RHS: tod must "
                         f"be 1-D, got shape {tuple(tod.shape)}")
    dv = plan.device(dev)
    f32 = tod.dtype
    n_off, n_rank = plan.n_offsets, plan.n_rank
    P_pad = int(dv["pair_rank"].shape[0])
    N_pad = int(dv["sample_perm"].shape[0])
    N = tod.shape[-1]
    zero = torch.zeros((), dtype=f32, device=dev)

    perm = dv["sample_perm"].to(torch.int64)
    pad_mask = (torch.arange(N_pad, device=dev) < N).to(f32)
    w_s = weights[perm] * pad_mask
    d_s = tod[perm]
    c2_s = torch.cos(2.0 * psi)[perm]
    s2_s = torch.sin(2.0 * psi)[perm]

    def pair_sum(v):
        return binned_window_sum(v, dv["sample_pair"], dv["sample_base"],
                                 plan.sample_window, plan.sample_chunk,
                                 P_pad, ids_sorted=True)

    def rank_sum(pv):
        return binned_window_sum(pv, dv["pair_rank"], dv["rank_base"],
                                 plan.rank_window, plan.pair_chunk, n_rank,
                                 ids_sorted=True)

    perm_off = dv["pair_perm_off"].to(torch.int64)
    po_off = dv["pair_offset"][perm_off]
    pr_off = dv["pair_rank"][perm_off].to(torch.int64)
    pr_ok = pr_off < n_rank
    pr_clip = torch.clamp(pr_off, 0, max(n_rank - 1, 0))
    pair_off_clip = torch.clamp(dv["pair_offset"].to(torch.int64), 0,
                                n_off - 1)

    def off_sum(pv_off):
        return binned_window_sum(pv_off, po_off, dv["off_base"],
                                 plan.off_window, plan.pair_chunk, n_off,
                                 ids_sorted=True)

    # the pair aggregates in one launch: rows 0-2 w s_k (pws), 3-5
    # w d s_k (pwds), 6-8 w [cc, cs, ss], 9 the hit counts
    wc, ws, wd = w_s * c2_s, w_s * s2_s, w_s * d_s
    stacked = pair_sum(torch.stack(
        [w_s, wc, ws, wd, wd * c2_s, wd * s2_s, wc * c2_s, wc * s2_s,
         ws * s2_s, (w_s > 0).to(f32)]))                  # (10, P_pad)
    pws = stacked[0:3]
    pwds = stacked[3:6]
    ranked = rank_sum(torch.cat([stacked[0:3], stacked[6:10]]))  # (7, R)
    e0, e1, e2, e3, e4, e5 = ranked[:6]
    hits = ranked[6]
    ata = torch.stack([torch.stack([e0, e1, e2], -1),
                       torch.stack([e1, e3, e4], -1),
                       torch.stack([e2, e4, e5], -1)], -2)   # (R, 3, 3)
    scale, rcond_ok = _ata_scale_solvable(ata, hits)
    # the masked prefactor (f64): an unsolvable pixel reads an all-zero
    # inverse
    inv_a = _masked_inverse(ata, scale, rcond_ok)

    pws_off = pws[:, perm_off]
    pwds_off = pwds[:, perm_off]
    diag = off_sum(pws_off[0])                            # sum w per offset
    # exact diag(A): sum w less each pair's s^T A_p^-1 s, floored
    if n_rank:
        inv_a_off = torch.where(pr_ok[:, None, None], inv_a[pr_clip],
                                torch.zeros((), dtype=inv_a.dtype,
                                            device=dev))
    else:
        inv_a_off = torch.zeros((P_pad, 3, 3), dtype=inv_a.dtype,
                                device=dev)
    quad = _pair_quadratic(inv_a_off, pws_off)
    del inv_a_off
    inv_diag = _jacobi_inverse(diag - off_sum(quad), diag,
                               floor=_POL_JACOBI_FLOOR)

    def solve_map(b_rank):
        """m = masked A^-1 b, (3, n_rank) -> (3, n_rank)."""
        return _apply_inverse(inv_a, b_rank)

    def gather_a(a):
        return a[pair_off_clip]

    def gather_m(m):
        if n_rank == 0:
            return torch.zeros((3, P_pad), dtype=f32, device=dev)
        return torch.where(pr_ok, m[:, pr_clip], zero)

    def matvec(a):
        m = solve_map(rank_sum(pws * gather_a(a)))
        return diag * a - off_sum((pws_off * gather_m(m)).sum(0))

    m_d = solve_map(rank_sum(pwds))                       # naive IQU
    b = off_sum(pwds_off[0] - (pws_off * gather_m(m_d)).sum(0))

    a, rz, k, b_norm, _, _ = _cg_loop(
        matvec, b, lambda u, v: (u * v).sum(-1), n_iter, threshold,
        precond=lambda v: v * inv_diag)
    # zero-mean pinning, as on the scatter path
    a = a - a.mean()
    iqu_destriped_c = solve_map(rank_sum(pwds - pws * gather_a(a)))

    uniq = dv["uniq_pixels"].to(torch.int64)

    def expand(cmp):
        full = torch.zeros(cmp.shape[:-1] + (plan.npix,), dtype=f32,
                           device=dev)
        full[..., uniq] = cmp
        return full

    residual = torch.sqrt(rz / torch.clamp(b_norm, min=1e-30))
    return PolDestriperResult(
        a, expand(iqu_destriped_c).T, expand(m_d).T, expand(hits),
        expand(rcond_ok.to(f32)) > 0, torch.tensor(k, dtype=torch.int32),
        residual)


def destripe_pol_sharded(mesh, tod, pixels, weights, psi, npix: int,
                         offset_length: int = 50, n_iter: int = 100,
                         threshold: float = 1e-6) -> PolDestriperResult:
    """:func:`destripe_pol` with the time axis split over every device of
    ``mesh`` (:class:`~comapreduce_tpu_torch.parallel.mesh.Mesh`), as the
    reference runs it under ``shard_map`` with ``axis_name``. ``N`` must
    be a multiple of ``mesh.size x offset_length``. The offsets come back
    in global order and the maps as every shard has them, on the mesh's
    first device."""
    from comapreduce_tpu_torch.parallel import spmd
    from comapreduce_tpu_torch.parallel.axes import split_slices

    axes = tuple(mesh.axis_names)
    devices = mesh.flat_devices()
    n_shards = len(devices)
    n = int(len(tod))
    if n % (n_shards * offset_length):
        raise ValueError(f"N={n} is not a multiple of n_shards x L = "
                         f"{n_shards * offset_length}; pad first")

    def body(ctx, i):
        sl = split_slices(n, n_shards, i)
        return destripe_pol(tod[sl], pixels[sl], weights[sl], psi[sl], npix,
                            offset_length=offset_length, n_iter=n_iter,
                            threshold=threshold, axis_name=axes,
                            device=devices[i])

    outs = spmd.run(mesh, body, [(i,) for i in range(n_shards)])
    dev0 = devices[0]
    return outs[0]._replace(offsets=torch.cat([o.offsets.to(dev0)
                                               for o in outs]))
