"""Atmosphere removal: per-channel regression against airmass (port of
``comapreduce_tpu/ops/atmosphere.py``).

The per-scan fit ``tod(c, t) ~ offset(c) + atmos(c) A(t)`` is C
independent 2x2 normal-equation solves per scan: five moments summed
per scan segment and solved in closed form, with centred second moments
(two passes) because the raw normal equations cancel in f32 at count
scales. The reference's ``segment_sum`` becomes one ``index_add_`` over
``(rows, n_scans + 1)`` (the last column collects samples outside every
scan)."""

from __future__ import annotations

import torch

__all__ = ["fit_airmass_block", "fit_atmosphere_segments",
           "subtract_atmosphere"]


def fit_airmass_block(tod: torch.Tensor, airmass: torch.Tensor,
                      mask: torch.Tensor):
    """Masked per-channel fit ``tod ~ offset + slope * airmass`` over one
    block (``atmosphere.py:21``).

    ``tod``/``mask``: f32[..., C, L]; ``airmass``: f32[L] (or broadcast
    against ``tod``'s leading axes). Returns ``(offset, slope)`` each
    f32[..., C]; centered moments, slope 0 on degenerate blocks."""
    cnt = mask.sum(dim=-1)
    s1 = torch.clamp(cnt, min=1.0)
    a_mean = (mask * airmass).sum(dim=-1) / s1
    d_mean = (mask * tod).sum(dim=-1) / s1
    da = airmass - a_mean.unsqueeze(-1)
    dd = tod - d_mean.unsqueeze(-1)
    saa = (mask * da * da).sum(dim=-1)
    sad = (mask * da * dd).sum(dim=-1)
    ok = (cnt >= 2.0) & (saa > 1e-12)
    slope = torch.where(ok, sad / torch.clamp(saa, min=1e-12),
                        torch.zeros((), dtype=tod.dtype, device=tod.device))
    offset = d_mean - slope * a_mean
    return offset, slope


def _segment_sums(x: torch.Tensor, seg: torch.Tensor, n_scans: int):
    """f32[..., T] -> f32[..., n_scans]: sums over each scan's samples
    (``seg`` i64[T], ``n_scans`` for samples outside every scan)."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.zeros((flat.shape[0], n_scans + 1), dtype=x.dtype,
                      device=x.device)
    out.index_add_(1, seg, flat)
    return out[:, :n_scans].reshape(x.shape[:-1] + (n_scans,))


def _per_sample(v: torch.Tensor, seg_c: torch.Tensor) -> torch.Tensor:
    """f32[..., n_scans] -> f32[..., T]: each sample's scan value."""
    return torch.index_select(v, -1, seg_c)


def fit_atmosphere_segments(tod: torch.Tensor, airmass: torch.Tensor,
                            scan_ids, mask: torch.Tensor, n_scans: int):
    """Per-scan, per-channel linear fit of TOD against airmass
    (``atmosphere.py:45``).

    ``tod``/``mask``: f32[..., C, T]; ``airmass``: f32[T]; ``scan_ids``:
    i32[T] (-1 outside scans). Returns ``(offset, atmos)`` each
    f32[..., C, n_scans]; a scan with under 2 valid samples or no
    airmass variance gets ``atmos = 0`` and the weighted mean as
    offset."""
    dev = tod.device
    ids = torch.as_tensor(scan_ids, device=dev).to(torch.int64)
    seg = torch.where(ids < 0, torch.full_like(ids, n_scans), ids)
    m = mask
    a = airmass
    cnt = _segment_sums(m, seg, n_scans)
    s1 = torch.clamp(cnt, min=1.0)
    a_mean = _segment_sums(m * a, seg, n_scans) / s1
    d_mean = _segment_sums(m * tod, seg, n_scans) / s1
    # second pass on per-scan centred values
    seg_c = torch.clamp(ids, 0, n_scans - 1)
    da = a - _per_sample(a_mean, seg_c)
    dd = tod - _per_sample(d_mean, seg_c)
    saa = _segment_sums(m * da * da, seg, n_scans)
    sad = _segment_sums(m * da * dd, seg, n_scans)
    ok = (cnt >= 2.0) & (saa > 1e-12)
    atmos = torch.where(ok, sad / torch.clamp(saa, min=1e-12),
                        torch.zeros((), dtype=tod.dtype, device=dev))
    offset = d_mean - atmos * a_mean
    return offset, atmos


def subtract_atmosphere(tod: torch.Tensor, airmass: torch.Tensor,
                        scan_ids, offset: torch.Tensor,
                        atmos: torch.Tensor) -> torch.Tensor:
    """Subtract the fitted per-scan model from the TOD
    (``atmosphere.py:100``); samples outside every scan stay as they
    are."""
    n_scans = offset.shape[-1]
    ids = torch.as_tensor(scan_ids, device=tod.device).to(torch.int64)
    seg = torch.clamp(ids, 0, n_scans - 1)
    model = _per_sample(offset, seg) + _per_sample(atmos, seg) * airmass
    return torch.where(ids >= 0, tod - model, tod)
