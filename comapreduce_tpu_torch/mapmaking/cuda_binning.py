"""Hopper kernels K3 (binned window sum) and K4 (windowed gather), their
plain PyTorch versions and their launch counters.

Port of ``comapreduce_tpu/mapmaking/pallas_binning.py``:
``binned_window_sum`` (``csrc/binned_window_sum.cu``; re-exported by
``pointing_plan``, where the reference defines it) replaces
``binned_window_sum_pallas`` (``pallas_binning.py:204``, body
``_scatter_kernel`` ``:173``). Both of its bodies add in an order fixed
by the inputs, R and their compile-time constants, so a sum is the same
bits on every run (the TPU kernel's ordered grid gave it one order; CUDA
blocks run concurrently, so float atomics would not).

- One-pass body, ``ids_sorted=True`` (the six call sites of the planned
  solvers, whose plan ids ascend over the whole array): a segmented sum
  over tiles of ``ONE_PASS_TILE`` elements. Bound: bytes — values
  R x M f32, ids M i32 and base read once, out R x out_size f32 written
  once. Design: one launch, no memset, no scratch. A tile owns the bins
  from just above the previous tile's last id up to its own last id
  (from bin 0 in the first tile, to ``out_size`` in the last) and writes
  each exactly once, a run's sum or 0; a thread sums its runs in
  registers, a warp joins them with a segmented scan keyed on the id,
  the warps in warp order; a run that continues past the tile is read
  ahead by its owner. A descent in the ids fails the launch with a
  device-side assert.
- Two-pass body (the default): ids in any order inside a chunk, the TPU
  kernel's contract. Bound: the same bytes plus its partial buffer
  (R x n_chunks x window f32) written and read once. Pass 1, one block a
  chunk, sums the chunk's window in shared memory into its partial row
  (a window wider than the shared slice slice by slice); pass 2, one
  thread a bin, adds the partial entries of the chunks whose windows
  cover the bin in chunk order.

Against the ordered plain version either body agrees to f32
summation-order tolerance. ``binned_window_sum.launches`` counts one a
call; ``binned_window_sum.bodies`` counts the calls each body took.

Dispatch follows the tensor's device: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version (whatever
``ids_sorted`` says). The TPU's VMEM gate (``pallas_binning_ok``) has no
counterpart here.

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

__all__ = ["ONE_PASS_TILE", "binned_window_sum", "binned_window_sum_plain",
           "binned_window_sum_occupancy", "windowed_gather",
           "windowed_gather_occupancy", "windowed_gather_plain"]

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
#: elements a block of the one-pass body owns (``BW_TILE`` of
#: ``csrc/binned_window_sum.cu``): with the kernel's thread layout it
#: fixes that body's order of adds
ONE_PASS_TILE = 2048


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
                      out_size: int, *, ids_sorted: bool = False
                      ) -> torch.Tensor:
    """Sum ``values`` f32[..., M] into ``out[..., id]`` for chunk-windowed
    ids (``pointing_plan.py:423``): ids of chunk ``c`` outside
    ``[clip(base[c], 0, out_size), + window)`` or ``>= out_size`` drop;
    leading axes (the multi-RHS bands) share the ids. ``ids_sorted``: the
    caller vouches that the ids never descend over the whole array (a
    plan's layouts), and a CUDA tensor takes the one-pass body, which
    fails the launch on a descent; otherwise the two-pass body, right for
    ids in any order inside a chunk. The kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
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
    # either body writes every bin
    out = torch.empty((R, out_size), dtype=torch.float32,
                      device=values.device)
    i32 = ids.to(torch.int32).contiguous()
    b32 = base.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    if ids_sorted:
        if M >= 2 ** 31 - 2 * ONE_PASS_TILE:
            raise ValueError(f"binned_window_sum's one-pass body takes "
                             f"fewer than 2**31 - {2 * ONE_PASS_TILE} "
                             f"elements, got {M}")
        # 16-byte loads of ids and of each band's values
        vec = (M % 4 == 0 and v.data_ptr() % 16 == 0
               and i32.data_ptr() % 16 == 0)
        fn = _build.c_function("binned_window_sum",
                               "cr_binned_window_sum_sorted",
                               [_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I,
                                _VP])
        _build.count_launch(binned_window_sum, "one_pass")
        _build.check(fn(v.data_ptr(), i32.data_ptr(), b32.data_ptr(),
                        out.data_ptr(), M, R, int(window), int(chunk),
                        int(out_size), int(vec), stream),
                     "binned_window_sum")
        return out.reshape(lead + (out_size,))
    # the chunks' window sums (pass 1) and the flag of unsorted bases
    partial = torch.empty(R * (M // chunk) * int(window),
                          dtype=torch.float32, device=values.device)
    flag = torch.empty(1, dtype=torch.int32, device=values.device)
    vec = (M % 4 == 0 and chunk % 4 == 0 and v.data_ptr() % 16 == 0
           and i32.data_ptr() % 16 == 0)
    fn = _build.c_function("binned_window_sum", "cr_binned_window_sum",
                           [_VP, _VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _I,
                            _I, _I, _VP])
    _build.count_launch(binned_window_sum, "two_pass")
    _build.check(fn(v.data_ptr(), i32.data_ptr(), b32.data_ptr(),
                    out.data_ptr(), partial.data_ptr(), flag.data_ptr(), M,
                    R, int(window), int(chunk), int(out_size), int(vec),
                    stream),
                 "binned_window_sum")
    return out.reshape(lead + (out_size,))


binned_window_sum.launches = 0
#: calls per body (``"one_pass"``, ``"two_pass"``)
binned_window_sum.bodies = {"one_pass": 0, "two_pass": 0}


def binned_window_sum_occupancy(R: int = 1, window: int = 4096, *,
                                ids_sorted: bool = False
                                ) -> tuple[int, int]:
    """``(blocks per SM, elements)`` of a K3 body on the current card, as
    the CUDA occupancy API gives its resident blocks: with ``ids_sorted``
    the one-pass body at ``R`` bands (its staged bands) and the elements a
    block owns (``ONE_PASS_TILE``); else the two-pass body's first pass at ``R``
    bands and ``window`` bins (its shared window) and the elements of a
    chunk one block takes per pass over it."""
    elements = ctypes.c_int(0)
    if ids_sorted:
        fn = _build.c_function("binned_window_sum",
                               "cr_binned_window_sum_sorted_occupancy",
                               [_I, _VP])
        n = fn(int(R), ctypes.byref(elements))
    else:
        fn = _build.c_function("binned_window_sum",
                               "cr_binned_window_sum_occupancy",
                               [_I, _I, _VP])
        n = fn(int(R), int(window), ctypes.byref(elements))
    if n < 0:
        _build.check(-n, "binned_window_sum occupancy")
    return n, elements.value


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
    _build.count_launch(windowed_gather)
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
