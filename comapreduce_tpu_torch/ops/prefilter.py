"""Hopper kernel K5: the reduction's atmosphere fit and radiometer
normalisation, fused, with its plain PyTorch version and launch counter.

The field branch of ``ops.reduce._prefilter_chain`` after the NaN fill
(K1): the masked, centred two-pass airmass fit of each row, the
stride-4 pair differences' masked std, ``norm`` and the cleaned block.
:func:`prefilter` (``csrc/prefilter.cu``) replaces no Pallas kernel: it
stands for XLA's fusion of the reference's ``_prefilter_chain``
(``comapreduce_tpu/ops/reduce.py:550``), which eager PyTorch ran as ~35
generic kernels over the block. Bound: bytes — read the filled block and
the mask, write the cleaned block, once each. Design: one block a row,
the row (f32 counts and mask weights, 32 bytes per four samples) kept in
shared memory while it fits :data:`PREFILTER_SMEM_BUDGET`, every pass of
the fit and of the std over it, each sum in a fixed order (so a row's
result depends on that row alone); longer rows take the second body,
chosen by shape, the same passes over device memory.

Dispatch follows the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed build or launch raises), a CPU tensor
takes the plain version. ``prefilter.launches`` counts one a call,
``prefilter.bodies`` the calls each body took.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from comapreduce_tpu_torch import _build
from comapreduce_tpu_torch.ops.atmosphere import fit_airmass_block
from comapreduce_tpu_torch.ops.stats import masked_std

__all__ = ["PREFILTER_SMEM_BUDGET", "normalise_plain", "prefilter",
           "prefilter_occupancy", "prefilter_plain", "prefilter_row_on_chip"]

# shared memory a K5 block may give its row (of the 227 KB an H100 block
# can use); longer rows take the second body, read from device memory
PREFILTER_SMEM_BUDGET = 200 * 1024

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def normalise_plain(d, m, a, base, slope, bandwidth_tau: float):
    """Subtract the model ``base + slope * a`` and divide by the
    radiometer noise (``reduce.py:571``). ``d``/``m``: f32[..., B, C, L];
    ``a``: f32[..., L]; ``base``/``slope``: f32[..., B, C]. Returns
    ``(clean, norm)``, ``norm`` f32[..., B, C]: the stride-4 pair
    differences' masked std over sqrt(2), times sqrt(bandwidth tau)."""
    L = d.shape[-1]
    a_b = a.unsqueeze(-2).unsqueeze(-2)                    # (..., 1, 1, L)
    model = base.unsqueeze(-1) + slope.unsqueeze(-1) * a_b
    n4 = L // 4 * 4
    am_d = (a[..., 0:n4:4] - a[..., 2:n4:4]).unsqueeze(-2).unsqueeze(-2)
    diff = ((d[..., 0:n4:4] - d[..., 2:n4:4])
            - slope.unsqueeze(-1) * am_d)
    pm = m[..., 0:n4:4] * m[..., 2:n4:4]
    rms = masked_std(diff, pm, axis=-1) / torch.sqrt(_f32(2.0, d))
    norm = (rms * torch.sqrt(_f32(bandwidth_tau, d))).unsqueeze(-1)
    safe = torch.clamp(norm, min=1e-30)
    clean = torch.where(norm > 0, (d - model) / safe,
                        torch.zeros((), dtype=d.dtype, device=d.device))
    return clean, norm[..., 0]


def prefilter_plain(d, m, a, bandwidth_tau: float):
    """Plain version of K5: :func:`fit_airmass_block`, then
    :func:`normalise_plain`. Returns ``(clean, stats)``: ``clean``
    f32[..., B, C, L] and ``stats`` f32[3, ..., B, C] (offset, slope,
    norm)."""
    base, slope = fit_airmass_block(d, a.unsqueeze(-2).unsqueeze(-2), m)
    clean, norm = normalise_plain(d, m, a, base, slope, bandwidth_tau)
    return clean, torch.stack([base, slope, norm])


def prefilter(d, m, a, bandwidth_tau: float):
    """The field pre-filter after the fill: the kernel on a CUDA tensor,
    the plain version on a CPU tensor; returns what
    :func:`prefilter_plain` returns. ``d``/``m``: f32[..., B, C, L] of
    one shape, contiguous on the card; ``a``: f32[..., L], its leading
    axes broadcast against ``d``'s. ``bandwidth_tau`` is rounded to f32
    and its square root taken in f32 on the host, as the plain version
    rounds it."""
    if d.device.type == "cpu":
        return prefilter_plain(d, m, a, bandwidth_tau)
    if any(x.dtype != torch.float32 for x in (d, m, a)):
        raise TypeError("prefilter kernel takes float32 d, m and a")
    if (d.ndim < 3 or m.shape != d.shape or a.ndim > d.ndim - 2
            or a.shape[-1] != d.shape[-1]
            or any(x.device != d.device for x in (m, a))):
        raise ValueError(f"prefilter: d {tuple(d.shape)} on {d.device}, m "
                         f"{tuple(m.shape)} on {m.device}, a "
                         f"{tuple(a.shape)} on {a.device}")
    if not (d.is_contiguous() and m.is_contiguous()):
        raise ValueError("prefilter kernel takes contiguous d and m")
    L = d.shape[-1]
    lead = d.shape[:-3]
    per_a = d.shape[-3] * d.shape[-2]
    # one airmass row per leading index (a small copy when it broadcasts)
    a = torch.broadcast_to(a, lead + (L,)).contiguous()
    rows = d.numel() // L if L else 0
    clean = torch.empty_like(d)
    stats = torch.empty((3,) + d.shape[:-1], dtype=torch.float32,
                        device=d.device)
    if rows == 0:
        return clean, stats.zero_()
    on_chip = prefilter_row_on_chip(L)
    vec = (L % 4 == 0 and all(p.data_ptr() % 16 == 0
                              for p in (d, m, a, clean)))
    sqrt2 = np.sqrt(np.float32(2.0))
    sqrt_bt = np.sqrt(np.float32(bandwidth_tau))
    fn = _build.c_function("prefilter", "cr_prefilter",
                           [_VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _F, _F,
                            _I, _I, _VP])
    _build.count_launch(prefilter, "on_chip" if on_chip else "streamed")
    _build.check(fn(d.data_ptr(), m.data_ptr(), a.data_ptr(),
                    clean.data_ptr(), stats.data_ptr(), rows, L, per_a,
                    float(sqrt2), float(sqrt_bt), int(on_chip), int(vec),
                    torch.cuda.current_stream().cuda_stream),
                 "prefilter")
    return clean, stats


prefilter.launches = 0
prefilter.bodies = {"on_chip": 0, "streamed": 0}


def prefilter_row_on_chip(L: int) -> bool:
    """Whether K5 keeps rows of ``L`` samples on chip: the counts and the
    mask, 32 bytes per four samples, within
    :data:`PREFILTER_SMEM_BUDGET`. Longer rows take the second body."""
    return 32 * ((L + 3) // 4) <= PREFILTER_SMEM_BUDGET


def prefilter_occupancy(L: int) -> int:
    """Resident K5 blocks (rows) per SM for rows of ``L`` samples on the
    current card, as the CUDA occupancy API gives them."""
    fn = _build.c_function("prefilter", "cr_prefilter_occupancy", [_LL, _I])
    n = fn(L, int(prefilter_row_on_chip(L)))
    if n < 0:
        _build.check(-n, "prefilter occupancy")
    return n
