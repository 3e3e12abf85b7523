"""Hopper kernels K3 (binned window sum) and K4 (windowed gather), their
plain PyTorch versions and their launch counters.

Port of ``comapreduce_tpu/mapmaking/pallas_binning.py``:
``binned_window_sum`` (``csrc/binned_window_sum.cu``; re-exported by
``pointing_plan``, where the reference defines it) replaces
``binned_window_sum_pallas`` (``pallas_binning.py:204``, body
``_scatter_kernel`` ``:173``). Bound: bytes — values R x M f32 and ids
M i32 read once, out R x out_size f32 written once, its partial buffer
(R x n_chunks x window f32) written and read once. Design: two passes
that add in an order fixed by the inputs, so a sum is the same bits on
every run (the TPU kernel's ordered grid gave it one order; CUDA blocks
run concurrently, so float atomics would not). Pass 1, one block a
chunk: a thread sums its runs of equal in-window ids in registers, a
warp joins runs across its lanes with a segmented scan keyed on the id,
and the warps add their runs one after the other into the chunk's window
in shared memory, which the block writes to its partial row (a window
wider than the shared slice is done slice by slice). Pass 2, one thread
a bin: the partial entries of the chunks whose windows cover the bin,
added in chunk order. Correct for ids in any order; sorted ids make the
runs long. Against the ordered plain version the kernel agrees to f32
summation-order tolerance.

Dispatch follows the tensor's device: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version. The TPU's VMEM
gate (``pallas_binning_ok``) has no counterpart here.

``windowed_gather`` (``csrc/windowed_gather.cu``) replaces
``windowed_gather_pallas`` (``pallas_binning.py:285``, body
``_gather_kernel`` ``:263``), the offset-order coefficient gather of the
ground-template solve. Bound: bytes — ids M i32 read once, out R x M f32
written once, the distinct source words read once. Design: a thread
takes four consecutive elements (one 16-byte ids load, its chunk's
window start found with 32-bit math), tests their windows and writes
every row of the source from that one read of ids, one 16-byte store
per row — the ground solve gathers its two coefficient rows ``c0``,
``c1`` in one launch. A chunk that is not a multiple of 4, or ids not
16-byte aligned, takes the scalar body (one element per thread), chosen
by shape. The kernel copies (no arithmetic), so it is bitwise equal to
the plain version. Out-of-window and ``>= S`` ids read 0.0, where
``take(src, clip(ids))`` would read a clamped element: every caller
multiplies those lanes by a zero pair aggregate.
"""

from __future__ import annotations

import ctypes

import torch

from comapreduce_tpu_torch import _build

__all__ = ["binned_window_sum", "binned_window_sum_plain",
           "binned_window_sum_occupancy", "windowed_gather",
           "windowed_gather_occupancy", "windowed_gather_plain"]

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def _check_layout(ids, base, chunk, M):
    """ids i[M] in chunks of ``chunk``, one window start per chunk."""
    if ids.shape != (M,):
        raise ValueError(f"ids shape {tuple(ids.shape)} != ({M},)")
    if chunk <= 0 or M % chunk:
        raise ValueError(f"M={M} is not a multiple of chunk={chunk}")
    if base.shape != (M // chunk,):
        raise ValueError(f"base shape {tuple(base.shape)} != "
                         f"({M // chunk},)")


def _window_dest(ids, base, window, chunk, size):
    """i64 ids of the lanes inside their chunk's window
    ``[clip(base[c], 0, size), + window)`` and below ``size``; ``size``
    (the drop or zero slot) elsewhere."""
    b = torch.repeat_interleave(torch.clamp(base.to(torch.int64), 0, size),
                                chunk)
    idl = ids.to(torch.int64)
    keep = (idl >= b) & (idl < b + window) & (idl < size)
    return torch.where(keep, idl, torch.full_like(idl, size))


def binned_window_sum_plain(values: torch.Tensor, ids: torch.Tensor,
                            base: torch.Tensor, window: int, chunk: int,
                            out_size: int) -> torch.Tensor:
    """Plain version of K3, with the semantics of
    ``_binned_window_sum_fori`` (``pointing_plan.py:523``): per chunk
    ``c`` with ``b_c = clip(base[c], 0, out_size)``, an id adds its value
    only if ``b_c <= id < b_c + window`` and ``id < out_size``."""
    _check_layout(ids, base, chunk, values.shape[-1])
    out = torch.zeros(values.shape[:-1] + (out_size + 1,),
                      dtype=values.dtype, device=values.device)
    out.index_add_(-1, _window_dest(ids, base, window, chunk, out_size),
                   values)
    return out[..., :out_size]


def binned_window_sum(values: torch.Tensor, ids: torch.Tensor,
                      base: torch.Tensor, window: int, chunk: int,
                      out_size: int) -> torch.Tensor:
    """Sum ``values`` f32[..., M] into ``out[..., id]`` for plan-sorted,
    chunk-windowed ids (``pointing_plan.py:423``): ids of chunk ``c``
    outside ``[clip(base[c], 0, out_size), + window)`` or ``>= out_size``
    drop; leading axes (the multi-RHS bands) share the ids. The kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if values.device.type == "cpu":
        return binned_window_sum_plain(values, ids, base, window, chunk,
                                       out_size)
    if values.dtype != torch.float32:
        raise TypeError("binned_window_sum kernel takes float32 values")
    M = values.shape[-1]
    _check_layout(ids, base, chunk, M)
    lead = values.shape[:-1]
    v = values.contiguous().reshape(-1, M)
    R = v.shape[0]
    if M == 0 or R == 0 or out_size == 0 or window <= 0:
        return torch.zeros(lead + (out_size,), dtype=torch.float32,
                           device=values.device)
    # pass 2 writes every bin
    out = torch.empty((R, out_size), dtype=torch.float32,
                      device=values.device)
    i32 = ids.to(torch.int32).contiguous()
    b32 = base.to(torch.int32).contiguous()
    # the chunks' window sums (pass 1) and the flag of unsorted bases
    partial = torch.empty(R * (M // chunk) * int(window),
                          dtype=torch.float32, device=values.device)
    flag = torch.empty(1, dtype=torch.int32, device=values.device)
    # 16-byte loads of ids and of each band's values
    vec = (M % 4 == 0 and chunk % 4 == 0 and v.data_ptr() % 16 == 0
           and i32.data_ptr() % 16 == 0)
    fn = _build.c_function("binned_window_sum", "cr_binned_window_sum",
                           [_VP, _VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _I,
                            _I, _I, _VP])
    binned_window_sum.launches += 1
    _build.check(fn(v.data_ptr(), i32.data_ptr(), b32.data_ptr(),
                    out.data_ptr(), partial.data_ptr(), flag.data_ptr(), M,
                    R, int(window), int(chunk), int(out_size), int(vec),
                    torch.cuda.current_stream().cuda_stream),
                 "binned_window_sum")
    return out.reshape(lead + (out_size,))


binned_window_sum.launches = 0


def binned_window_sum_occupancy(R: int = 1,
                                window: int = 4096) -> tuple[int, int]:
    """``(blocks per SM, elements per pass)`` of K3's first pass at ``R``
    bands and ``window`` bins on the current card: its resident blocks per
    SM, as the CUDA occupancy API gives them for that shared window, and
    the elements of a chunk one block takes per pass over it."""
    fn = _build.c_function("binned_window_sum",
                           "cr_binned_window_sum_occupancy", [_I, _I, _VP])
    per_pass = ctypes.c_int(0)
    n = fn(int(R), int(window), ctypes.byref(per_pass))
    if n < 0:
        _build.check(-n, "binned_window_sum occupancy")
    return n, per_pass.value


def windowed_gather_plain(src: torch.Tensor, ids: torch.Tensor,
                          base: torch.Tensor, window: int,
                          chunk: int) -> torch.Tensor:
    """Plain version of K4: ``index_select`` on ``src`` padded with one
    zero column, which every out-of-window or ``>= S`` id reads."""
    _check_layout(ids, base, chunk, ids.shape[-1])
    S = src.shape[-1]
    pad = torch.zeros(src.shape[:-1] + (1,), dtype=src.dtype,
                      device=src.device)
    return torch.index_select(torch.cat([src, pad], dim=-1), -1,
                              _window_dest(ids, base, window, chunk, S))


def windowed_gather(src: torch.Tensor, ids: torch.Tensor,
                    base: torch.Tensor, window: int,
                    chunk: int) -> torch.Tensor:
    """``out[..., e] = src[..., ids[e]]`` for plan-sorted, chunk-windowed
    ids (``pallas_binning.py:285``): ids of chunk ``c`` outside
    ``[clip(base[c], 0, S), + window)`` or ``>= S`` read 0.0; leading axes
    share the ids. The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if src.device.type == "cpu":
        return windowed_gather_plain(src, ids, base, window, chunk)
    if src.dtype != torch.float32:
        raise TypeError("windowed_gather kernel takes a float32 source")
    M = ids.shape[-1]
    _check_layout(ids, base, chunk, M)
    if M > 2 ** 31 - 1:
        raise ValueError(f"windowed_gather kernel takes fewer than 2**31 "
                         f"elements, got {M}")
    S = src.shape[-1]
    lead = src.shape[:-1]
    s2 = src.contiguous().reshape(-1, S)
    R = s2.shape[0]
    out = torch.empty((R, M), dtype=torch.float32, device=src.device)
    if M == 0 or R == 0:
        return out.reshape(lead + (M,))
    i32 = ids.to(torch.int32).contiguous()
    b32 = base.to(torch.int32).contiguous()
    # four elements per thread: 16-byte loads of ids, 16-byte stores
    vec = chunk % 4 == 0 and i32.data_ptr() % 16 == 0
    fn = _build.c_function("windowed_gather", "cr_windowed_gather",
                           [_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I,
                            _VP])
    windowed_gather.launches += 1
    _build.check(fn(s2.data_ptr(), i32.data_ptr(), b32.data_ptr(),
                    out.data_ptr(), M, R, S, int(window), int(chunk),
                    int(vec), torch.cuda.current_stream().cuda_stream),
                 "windowed_gather")
    return out.reshape(lead + (M,))


windowed_gather.launches = 0


def windowed_gather_occupancy(vec: bool = True) -> int:
    """Resident K4 blocks (256 threads) per SM of the four-element body
    (``vec``) or the scalar one on the current card, as the CUDA occupancy
    API gives them."""
    fn = _build.c_function("windowed_gather", "cr_windowed_gather_occupancy",
                           [_I])
    n = fn(int(vec))
    if n < 0:
        _build.check(-n, "windowed_gather occupancy")
    return n
