"""Hopper kernels K1 (masked fill) and K2 (rolling median), with their
plain PyTorch versions and launch counters.

Port of ``comapreduce_tpu/ops/pallas_median.py``. Dispatch follows the
tensor's device and nothing else: a CUDA tensor launches the kernel (a
failed build or launch raises), a CPU tensor takes the plain version.
There is no shape gate — the TPU's VMEM limits (row length, padded
window) are not limits of these kernels.

K1 ``masked_fill`` (``csrc/masked_fill.cu``) replaces
``masked_fill_pallas`` (``pallas_median.py:306``, body ``_fill_kernel``
``:240``). Bound: bytes — read tod + mask, write out. Design: one block
per row, and the row crosses device memory once: the load pass keeps
tod, the mask bits and the stride-4 keys in shared memory (21 bytes per
4 samples, three rows resident per SM at the main path's L = 13 568),
the median is a radix select (four 8-bit digits, one warp-aggregated
shared histogram each, both order statistics at once) and the write
pass selects from shared memory. Rows past the shared-memory budget take
the second body, chosen by shape: keys in a device scratch buffer, and
the row read again to write.

K2 ``rolling_median_windows`` (``csrc/rolling_median.cu``) replaces
``rolling_median_windows_pallas`` (``pallas_median.py:174``, body
``_kernel`` ``:99``). Bound: at the main-path shape (8 rows x 2130
samples, window 500) the bytes are ~120 KB and an exact median needs at
most one linear selection (window compares) per output, so a launch is
bounded by its latency. Design: a block of :data:`RM_OUT` outputs sorts
its overlapping row segment once, as (key, position) pairs in shared
memory (bitonic), and each thread walks the sorted segment counting the
entries inside its own window up to its two middle order statistics;
one binary search over the sorted NaN tail tells whether its window
holds a NaN. Segments too long to sort in shared memory take the second
body, chosen by shape (:func:`rolling_median_sorts`): each thread of a
128-output block bisects its own window's value range, for every window
whose segment of keys fits a block's shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from comapreduce_tpu_torch import _build
from comapreduce_tpu_torch.ops.stats import (_median_mid, f32_key, key_f32,
                                            masked_median)

__all__ = ["fill_row_on_chip", "masked_fill", "masked_fill_occupancy",
           "masked_fill_plain", "rolling_median_occupancy",
           "rolling_median_sorts", "rolling_median_windows",
           "rolling_median_windows_plain"]

# shared memory a K1 block may give its row (of the 227 KB an H100 block
# can use); longer rows take the second body, keys in device scratch
FILL_SMEM_BUDGET = 200 * 1024

# K2: the sorted body's outputs (threads) per block, as RM_OUT in
# ``csrc/rolling_median.cu`` (chosen there), and the shared memory its
# (key, position) pairs may use (8 bytes each, padded to a power of two);
# longer segments take the bisection body
RM_OUT = 256
RM_SORT_SMEM = 128 * 1024

# outputs per step of K2's plain version (bounds its rows x chunk x window
# working matrix)
_PLAIN_CHUNK = 256

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K1: masked fill
# ---------------------------------------------------------------------------

def masked_fill_plain(tod: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``ops/reduce._fill_bad_xla`` (``reduce.py:487``)
    — ``where(mask > 0, tod, fill)`` with ``fill`` the stride-4 masked
    median, or the full-row masked mean when the stride-4 float mask sum
    is 0."""
    med = masked_median(tod[..., ::4], mask[..., ::4], axis=-1)
    sub_cnt = mask[..., ::4].sum(dim=-1)
    cnt = mask.sum(dim=-1)
    mean = (tod * mask).sum(dim=-1) / torch.clamp(cnt, min=1.0)
    fill = torch.where(sub_cnt > 0, med, mean).unsqueeze(-1)
    return torch.where(mask > 0, tod, fill)


def masked_fill(tod: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``_fill_bad``: the kernel on a CUDA tensor, the plain version on a
    CPU tensor. ``tod``/``mask``: f32[..., L] of one shape."""
    if tod.device.type == "cpu":
        return masked_fill_plain(tod, mask)
    if tod.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("masked_fill kernel takes float32 tod and mask")
    if tod.shape != mask.shape or mask.device != tod.device:
        raise ValueError(f"masked_fill: tod {tuple(tod.shape)} on "
                         f"{tod.device} vs mask {tuple(mask.shape)} on "
                         f"{mask.device}")
    L = tod.shape[-1]
    t = tod.contiguous().reshape(-1, L)
    m = mask.contiguous().reshape(-1, L)
    rows = t.shape[0]
    out = torch.empty_like(t)
    if rows == 0 or L == 0:
        return out.reshape(tod.shape)
    on_chip = fill_row_on_chip(L)
    scratch = None if on_chip else torch.empty(
        (rows, (L + 3) // 4), dtype=torch.int32, device=t.device)
    vec = (L % 4 == 0 and all(p.data_ptr() % 16 == 0 for p in (t, m, out)))
    fn = _build.c_function("masked_fill", "cr_masked_fill",
                           [_VP, _VP, _VP, _VP, _LL, _LL, _I, _I, _VP])
    masked_fill.launches += 1
    _build.check(fn(t.data_ptr(), m.data_ptr(), out.data_ptr(),
                    0 if scratch is None else scratch.data_ptr(),
                    rows, L, int(on_chip), int(vec), _stream()),
                 "masked_fill")
    return out.reshape(tod.shape)


masked_fill.launches = 0


def fill_row_on_chip(L: int) -> bool:
    """Whether K1 keeps rows of ``L`` samples on chip: the row, its mask
    bits and its keys (21 bytes per 4 samples) within
    :data:`FILL_SMEM_BUDGET`. Longer rows take the second body."""
    return 21 * ((L + 3) // 4) <= FILL_SMEM_BUDGET


def masked_fill_occupancy(L: int) -> int:
    """Resident K1 blocks (rows) per SM for rows of ``L`` samples on the
    current card, as the CUDA occupancy API gives them."""
    fn = _build.c_function("masked_fill", "cr_masked_fill_occupancy",
                           [_LL, _I])
    n = fn(L, int(fill_row_on_chip(L)))
    if n < 0:
        _build.check(-n, "masked_fill occupancy")
    return n


# ---------------------------------------------------------------------------
# K2: rolling median over pre-padded rows
# ---------------------------------------------------------------------------

def rolling_median_windows_plain(padded: torch.Tensor,
                                 window: int) -> torch.Tensor:
    """Plain version of K2: ``out[..., i] = median(padded[..., i:i+window])``
    exactly, any NaN in a window giving NaN, middles combined by
    ``_median_mid``. Streams ``_PLAIN_CHUNK`` outputs at a time so the
    window matrix stays ``rows x _PLAIN_CHUNK x window``."""
    P = padded.shape[-1]
    T = P - window + 1
    if T <= 0:
        raise ValueError(f"padded length {P} shorter than window {window}")
    x = padded.reshape(-1, P)
    k_lo, k_hi = (window - 1) // 2, window // 2
    outs = []
    for c0 in range(0, T, _PLAIN_CHUNK):
        c1 = min(c0 + _PLAIN_CHUNK, T)
        mat = x[:, c0:c1 + window - 1].unfold(-1, window, 1)
        # key order (-0 < +0), the kernel's order, not float comparison
        srt = torch.sort(f32_key(mat), dim=-1).values
        med = _median_mid(key_f32(srt[..., k_lo]), key_f32(srt[..., k_hi]))
        outs.append(torch.where(torch.isnan(mat).any(dim=-1),
                                torch.full((), float("nan"),
                                           dtype=med.dtype,
                                           device=med.device), med))
    out = torch.cat(outs, dim=-1) if outs else x[:, :0]
    return out.reshape(padded.shape[:-1] + (T,))


def rolling_median_windows(padded: torch.Tensor,
                           window: int) -> torch.Tensor:
    """Exact rolling median over caller-padded rows: the kernel on a CUDA
    tensor, the plain version on a CPU tensor. ``padded``: f32[..., P]
    gives ``P - window + 1`` outputs per row."""
    if padded.device.type == "cpu":
        return rolling_median_windows_plain(padded, window)
    if padded.dtype != torch.float32:
        raise TypeError("rolling_median_windows kernel takes float32")
    P = padded.shape[-1]
    T = P - window + 1
    if T <= 0:
        raise ValueError(f"padded length {P} shorter than window {window}")
    x = padded.contiguous().reshape(-1, P)
    rows = x.shape[0]
    out = torch.empty((rows, T), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out.reshape(padded.shape[:-1] + (T,))
    fn = _build.c_function("rolling_median", "cr_rolling_median",
                           [_VP, _VP, _LL, _LL, _I, _I, _VP])
    rolling_median_windows.launches += 1
    _build.check(fn(x.data_ptr(), out.data_ptr(), rows, P, int(window),
                    int(rolling_median_sorts(window)), _stream()),
                 "rolling_median_windows")
    return out.reshape(padded.shape[:-1] + (T,))


rolling_median_windows.launches = 0


def rolling_median_sorts(window: int) -> bool:
    """Whether K2 takes its sorted body for ``window``: a block's
    ``RM_OUT + window - 1`` (key, position) pairs, 8 bytes each and
    padded to a power of two, fit :data:`RM_SORT_SMEM`. Longer windows
    take the bisection body."""
    n = RM_OUT + window - 1
    return 8 * (1 << max(n - 1, 0).bit_length()) <= RM_SORT_SMEM


def rolling_median_occupancy(window: int) -> int:
    """Resident K2 blocks per SM for ``window`` on the current card, as the
    CUDA occupancy API gives them."""
    fn = _build.c_function("rolling_median", "cr_rolling_median_occupancy",
                           [_I, _I])
    n = fn(int(window), int(rolling_median_sorts(window)))
    if n < 0:
        _build.check(-n, "rolling_median occupancy")
    return n
