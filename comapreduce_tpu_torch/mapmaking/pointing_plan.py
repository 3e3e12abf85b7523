"""Static pointing plan: scatter-free destriper binning
(port of ``comapreduce_tpu/mapmaking/pointing_plan.py``).

The plan is plain numpy, built once per pointing on the host, byte for
byte the reference's: compact ranks of the hit pixels, (rank, offset)
pairs, and chunk-windowed id layouts so that every per-iteration sum is
a windowed scatter (``binned_window_sum`` -> kernel K3).
:meth:`PointingPlan.device` uploads the index arrays to a torch device.

``pair_batch`` (merging pair chunks into one binning step) was an MXU
trade on the TPU; here it is fixed at 1, what the reference's auto rule
gives off the TPU, until the H100 measures a reason for another value.
On the auto path a ``[tuning]`` ``plan`` winner is consulted as the
reference consults it (``pointing_plan.py:290``); a winner other than 1
(one the reference measured on its MXU) is skipped with a log line.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from comapreduce_tpu_torch.mapmaking.cuda_binning import \
    binned_window_sum
from comapreduce_tpu_torch.mapmaking.pixel_space import (PixelSpace,
                                                         resolve_npix)

# ``binned_window_sum`` (kernel K3 on a CUDA tensor, its plain version on
# a CPU tensor) lives beside its kernel; it is re-exported here, where the
# reference defines it
__all__ = ["PointingPlan", "build_pointing_plan", "binned_window_sum"]

logger = logging.getLogger("comapreduce_tpu_torch")

#: the plan's index arrays, uploaded by :meth:`PointingPlan.device`
DEVICE_FIELDS = ("sample_perm", "sample_pair", "sample_base", "pair_rank",
                 "pair_offset", "rank_base", "pair_perm_off", "off_base",
                 "uniq_pixels")


def _resolve_pixel_space(pixels, npix, pixel_space):
    """Remap GLOBAL sky pixels through a compacted :class:`PixelSpace`
    once per plan build, or resolve a ``PixelSpace`` passed as ``npix``;
    a mismatched pair raises (``pointing_plan.py:44``)."""
    if pixel_space is not None:
        n = resolve_npix(npix)
        if n not in (pixel_space.npix_sky, pixel_space.n_solve):
            raise ValueError(
                f"npix {n} matches neither pixel_space.npix_sky "
                f"{pixel_space.npix_sky} nor its n_solve "
                f"{pixel_space.n_solve} — wrong-resolution dictionary?")
        return pixel_space.remap(pixels), pixel_space.n_solve
    return pixels, resolve_npix(npix)


def _round_up(x: int, q: int) -> int:
    return -(-int(x) // q) * q


@dataclass
class PointingPlan:
    """Static index structure for one pointing (``pointing_plan.py:67``).

    Sample arrays are in sorted (rank, offset) order (device data enters
    through ``sample_perm``); pair arrays come in rank order and, through
    ``pair_perm_off``, offset order."""

    npix: int
    offset_length: int
    n_offsets: int
    n_rank: int
    uniq_pixels: np.ndarray
    sample_perm: np.ndarray
    sample_pair: np.ndarray
    sample_chunk: int
    sample_window: int
    sample_base: np.ndarray
    n_pairs: int
    pair_rank: np.ndarray
    pair_offset: np.ndarray
    pair_chunk: int
    rank_window: int
    rank_base: np.ndarray
    pair_perm_off: np.ndarray
    off_window: int
    off_base: np.ndarray
    pair_batch: int = 1
    _device: dict = field(default_factory=dict, repr=False)

    def device(self, torch_device) -> dict:
        """Upload (and cache per device) the index arrays as i32 tensors."""
        dev = torch.device(torch_device)
        key = str(dev)
        if key not in self._device:
            self._device[key] = {
                k: torch.as_tensor(np.asarray(getattr(self, k), np.int32),
                                   device=dev)
                for k in DEVICE_FIELDS}
        return self._device[key]


def _window_layout(ids_sorted: np.ndarray, chunk: int, align: int = 128):
    """Per-chunk base ids and the window width covering every chunk's
    span (``ids_sorted`` ascending, length a chunk multiple)."""
    n_chunks = len(ids_sorted) // chunk
    blocks = ids_sorted.reshape(n_chunks, chunk)
    base = blocks[:, 0].astype(np.int64)
    span = blocks[:, -1] - base + 1
    window = _round_up(max(int(span.max()), 1), align)
    return base.astype(np.int32), int(window)


def _consult_plan_winner(n_samples: int, offset_length: int) -> None:
    """The ``[tuning]`` ``plan`` winner for this ``(N, L)`` bucket: the
    port builds ``pair_batch`` 1 only, so another winner is logged and
    skipped (a cache file never makes a plan build raise)."""
    from comapreduce_tpu_torch.tuning.cache import TUNING

    if not TUNING.enabled:
        return
    from comapreduce_tpu_torch.tuning.space import plan_bucket

    win = TUNING.winner("plan", plan_bucket(n_samples, offset_length))
    if win and win.get("pair_batch") and int(win["pair_batch"]) != 1:
        logger.warning("[tuning] plan winner pair_batch=%s for bucket "
                       "N=%d L=%d skipped: the port builds pair_batch 1 "
                       "only", win["pair_batch"], n_samples, offset_length)


def build_pointing_plan(pixels: np.ndarray, npix, offset_length: int,
                        sample_chunk: int = 8192,
                        pair_chunk: int = 4096,
                        pair_batch: int | None = None,
                        pixel_space: PixelSpace | None = None
                        ) -> PointingPlan:
    """Build the static plan for one flat pointing vector
    (``pointing_plan.py:187``); the arrays equal the reference's byte for
    byte. ``pixels``: integer pixel per sample (invalid = negative or
    >= npix), length a multiple of ``offset_length``. ``pair_batch``:
    ``None``/0 (auto) or 1 — one pair chunk per binning step; merged
    chunks are not ported. (The reference's ``min_pair_pad`` /
    ``min_windows`` serve its sharded plans, which are not ported yet.)"""
    if pair_batch not in (None, 0, 1):
        raise NotImplementedError(
            f"pair_batch={pair_batch}: merged pair chunks are not ported; "
            "pass None (auto) or 1")
    pixels, npix = _resolve_pixel_space(pixels, npix, pixel_space)
    pixels = np.asarray(pixels).astype(np.int64).ravel()
    N = pixels.size
    if N % offset_length:
        raise ValueError(f"N={N} not a multiple of L={offset_length}")
    if not pair_batch:
        _consult_plan_winner(N, offset_length)
    n_offsets = N // offset_length
    offs = np.arange(N, dtype=np.int64) // offset_length
    valid = (pixels >= 0) & (pixels < npix)

    uniq = np.unique(pixels[valid])
    n_rank = int(uniq.size)
    rank = np.full(N, n_rank, dtype=np.int64)
    rank[valid] = np.searchsorted(uniq, pixels[valid])

    # sort samples by (rank, offset); invalid (rank = n_rank) sort last
    key = rank * n_offsets + offs
    perm = np.argsort(key, kind="stable")
    skey = key[perm]

    new_pair = np.empty(N, dtype=bool)
    new_pair[0] = True
    np.not_equal(skey[1:], skey[:-1], out=new_pair[1:])
    pair_id = np.cumsum(new_pair) - 1
    n_pairs_all = int(pair_id[-1]) + 1

    firsts = np.flatnonzero(new_pair)
    pair_rank = rank[perm][firsts]
    pair_offset = offs[perm][firsts]

    N_pad = _round_up(max(N, 1), sample_chunk)
    sample_perm = np.concatenate(
        [perm, np.zeros(N_pad - N, np.int64)]).astype(np.int32)
    sample_pair = np.concatenate(
        [pair_id, np.full(N_pad - N, n_pairs_all, np.int64)])
    sample_base, sample_window = _window_layout(sample_pair, sample_chunk)
    sample_pair = sample_pair.astype(np.int32)

    P_pad = _round_up(max(n_pairs_all, 1), pair_chunk)
    pad = P_pad - n_pairs_all
    pr = np.concatenate([pair_rank, np.full(pad, n_rank, np.int64)])
    po = np.concatenate([pair_offset, np.full(pad, n_offsets, np.int64)])
    rank_base, rank_window = _window_layout(pr, pair_chunk)
    okey = po * (n_rank + 1) + pr
    perm_off = np.argsort(okey, kind="stable")
    off_base, off_window = _window_layout(po[perm_off], pair_chunk)

    return PointingPlan(
        npix=int(npix), offset_length=int(offset_length),
        n_offsets=int(n_offsets), n_rank=n_rank, uniq_pixels=uniq,
        sample_perm=sample_perm, sample_pair=sample_pair,
        sample_chunk=int(sample_chunk),
        sample_window=sample_window,
        sample_base=sample_base,
        n_pairs=n_pairs_all, pair_rank=pr.astype(np.int32),
        pair_offset=po.astype(np.int32), pair_chunk=int(pair_chunk),
        rank_window=rank_window,
        rank_base=rank_base,
        pair_perm_off=perm_off.astype(np.int32),
        off_window=off_window, off_base=off_base)
