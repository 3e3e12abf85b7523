"""Static pointing plan: scatter-free destriper binning
(port of ``comapreduce_tpu/mapmaking/pointing_plan.py``).

The plan is plain numpy, built once per pointing on the host, byte for
byte the reference's: compact ranks of the hit pixels, (rank, offset)
pairs, and chunk-windowed id layouts so that every per-iteration sum is
a windowed scatter (``binned_window_sum`` -> kernel K3).
:meth:`PointingPlan.device` uploads the index arrays to a torch device.

``pair_batch`` merges that many consecutive pair chunks into one
binning step (K3 and K4 then see chunks of ``pair_chunk x pair_batch``
pairs and the wider windows they span), byte for byte the reference's
layout. Its auto value (``None``, or ``COMAP_PAIR_BATCH`` unset / 0 /
``auto``) is, as in the reference, a ``[tuning]`` ``plan`` winner for
the plan's ``(N, L)`` bucket where one was measured under this
process's identity (``("gpu", card name)`` on the card: a winner of
another device keys elsewhere), else 1, what the reference's rule gives
off the TPU (merging was an MXU trade there). On the card K3's one-pass
body sums in an order that the merged chunks do not change.

:func:`build_sharded_plans` builds one plan per contiguous time shard,
all with the same static shapes, each in its own compact rank space,
with ``rank_to_global`` mapping it into the shared global hit-pixel
space the shards' map sums meet in.
"""

from __future__ import annotations

import dataclasses
import os
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
__all__ = ["PointingPlan", "build_pointing_plan", "build_sharded_plans",
           "binned_window_sum"]

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
    # sharded plans (build_sharded_plans): the shard's local rank ->
    # global compact rank (n_rank_global on padding), the global count
    # and the global hit pixels
    rank_to_global: np.ndarray | None = None
    n_rank_global: int = 0
    uniq_global: np.ndarray | None = None
    _device: dict = field(default_factory=dict, repr=False)

    def device(self, torch_device) -> dict:
        """Upload (and cache per device) the index arrays as i32 tensors
        (``rank_to_global`` too on a sharded plan)."""
        dev = torch.device(torch_device)
        key = str(dev)
        if key not in self._device:
            fields = DEVICE_FIELDS + (("rank_to_global",)
                                      if self.rank_to_global is not None
                                      else ())
            self._device[key] = {
                k: torch.as_tensor(np.asarray(getattr(self, k), np.int32),
                                   device=dev)
                for k in fields}
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


def _resolve_pair_batch(pair_batch) -> int:
    """The knob normalised (``pointing_plan.py:147``): an int >= 1 pins
    it; ``None`` reads ``COMAP_PAIR_BATCH`` (unset, 0 or ``auto``: 0, the
    auto value)."""
    if pair_batch is None:
        env = os.environ.get("COMAP_PAIR_BATCH", "").strip().lower()
        if env in ("", "auto", "0"):
            return 0
        return max(int(env), 1)
    return max(int(pair_batch), 0)


def _consult_plan_winner(n_samples: int, offset_length: int):
    """The ``[tuning]`` ``plan`` winner's ``pair_batch`` for this
    ``(N, L)`` bucket, or None (``pointing_plan.py:287-300``): disabled
    (no table) one attribute check; the lookup keys on this process's
    identity, so only a winner measured on this device matches."""
    from comapreduce_tpu_torch.tuning.cache import TUNING

    if not TUNING.enabled:
        return None
    from comapreduce_tpu_torch.tuning.space import plan_bucket

    win = TUNING.winner("plan", plan_bucket(n_samples, offset_length))
    if win and win.get("pair_batch"):
        return max(int(win["pair_batch"]), 1)
    return None


def build_pointing_plan(pixels: np.ndarray, npix, offset_length: int,
                        sample_chunk: int = 8192,
                        pair_chunk: int = 4096,
                        min_pair_pad: int = 0,
                        min_windows: tuple = (0, 0, 0),
                        pair_batch: int | None = None,
                        pixel_space: PixelSpace | None = None
                        ) -> PointingPlan:
    """Build the static plan for one flat pointing vector
    (``pointing_plan.py:187``); the arrays equal the reference's byte for
    byte. ``pixels``: integer pixel per sample (invalid = negative or
    >= npix), length a multiple of ``offset_length``. ``pair_batch``:
    pair chunks merged per binning step (``None``/0: auto, a measured
    ``[tuning]`` winner else 1; see the module docstring); the plan's
    ``pair_chunk`` is the merged chunk. ``min_pair_pad`` /
    ``min_windows`` (sample, rank, offset) pad the pair space and widen
    the windows to at least these sizes, so that every shard of
    :func:`build_sharded_plans` has the same static shapes."""
    pixels, npix = _resolve_pixel_space(pixels, npix, pixel_space)
    pixels = np.asarray(pixels).astype(np.int64).ravel()
    N = pixels.size
    if N % offset_length:
        raise ValueError(f"N={N} not a multiple of L={offset_length}")
    pb = _resolve_pair_batch(pair_batch)
    if pb == 0:
        pb = _consult_plan_winner(N, offset_length) or 1
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

    pair_chunk = int(pair_chunk) * pb
    P_pad = _round_up(max(n_pairs_all, 1, int(min_pair_pad)), pair_chunk)
    pad = P_pad - n_pairs_all
    pr = np.concatenate([pair_rank, np.full(pad, n_rank, np.int64)])
    po = np.concatenate([pair_offset, np.full(pad, n_offsets, np.int64)])
    rank_base, rank_window = _window_layout(pr, pair_chunk)
    okey = po * (n_rank + 1) + pr
    perm_off = np.argsort(okey, kind="stable")
    off_base, off_window = _window_layout(po[perm_off], pair_chunk)
    sample_window = max(sample_window, int(min_windows[0]))
    rank_window = max(rank_window, int(min_windows[1]))
    off_window = max(off_window, int(min_windows[2]))

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
        off_window=off_window, off_base=off_base, pair_batch=pb)


def build_sharded_plans(pixels: np.ndarray, npix, offset_length: int,
                        n_shards: int, sample_chunk: int = 8192,
                        pair_chunk: int = 4096,
                        pair_batch: int | None = None,
                        pixel_space: PixelSpace | None = None
                        ) -> list[PointingPlan]:
    """Per-shard plans over ``n_shards`` contiguous time shards
    (``pointing_plan.py:338``), byte for byte the reference's: identical
    static shapes (the pair padding and the three windows equalised to
    the fleet's maxima, one merged chunk size for all), each shard
    compacted into its own dense local rank space (narrow windows), and
    ``rank_to_global`` into the global hit-pixel space ``uniq_global``
    the shards' sums meet in. ``N`` must be a multiple of ``n_shards x
    offset_length`` (pad first)."""
    pixels, npix = _resolve_pixel_space(pixels, npix, pixel_space)
    pixels = np.asarray(pixels).astype(np.int64).ravel()
    N = pixels.size
    quantum = n_shards * offset_length
    if N % quantum:
        raise ValueError(f"N={N} not a multiple of "
                         f"n_shards*L={quantum}; pad first")
    shard_n = N // n_shards
    valid = (pixels >= 0) & (pixels < npix)
    uniq_global = np.unique(pixels[valid])
    n_rank_global = int(uniq_global.size)
    shards = [pixels[i * shard_n:(i + 1) * shard_n]
              for i in range(n_shards)]

    def build_all(min_pair_pad=0, wins=(0, 0, 0), pb=pair_batch):
        return [build_pointing_plan(s, npix, offset_length,
                                    sample_chunk=sample_chunk,
                                    pair_chunk=pair_chunk,
                                    min_pair_pad=min_pair_pad,
                                    min_windows=wins, pair_batch=pb)
                for s in shards]

    plans = build_all()
    # one static layout for every shard: the smallest merged chunk any
    # shard took, then the padding and windows at the fleet maxima
    pb = min(p.pair_batch for p in plans)
    if any(p.pair_batch != pb for p in plans):
        plans = build_all(pb=pb)
    p_max = max(p.pair_rank.shape[0] for p in plans)
    wins = (max(p.sample_window for p in plans),
            max(p.rank_window for p in plans),
            max(p.off_window for p in plans))
    if (any(p.pair_rank.shape[0] != p_max for p in plans)
            or any((p.sample_window, p.rank_window, p.off_window) != wins
                   for p in plans)):
        plans = build_all(min_pair_pad=p_max, wins=wins, pb=pb)
    # local rank spaces padded to one size; a shard's sentinel rank (its
    # own n_rank) and the padding map to the global sentinel
    n_rank_max = max(p.n_rank for p in plans)
    out = []
    for p in plans:
        l2g = np.full(n_rank_max, n_rank_global, np.int64)
        l2g[:p.n_rank] = np.searchsorted(uniq_global, p.uniq_pixels)
        uniq_pad = np.concatenate(
            [p.uniq_pixels,
             np.full(n_rank_max - p.n_rank, npix, np.int64)])
        out.append(dataclasses.replace(
            p, n_rank=n_rank_max, uniq_pixels=uniq_pad,
            rank_to_global=l2g, n_rank_global=n_rank_global,
            uniq_global=uniq_global, _device={}))
    return out
