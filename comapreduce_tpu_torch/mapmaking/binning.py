"""TOD <-> map binning: the pointing matrix as ``index_add_`` /
``index_select`` (port of ``comapreduce_tpu/mapmaking/binning.py``).

- ``P^T w d`` (TOD -> map accumulate) = ``index_add_`` into ``npix + 1``
  bins, the last one the drop slot of invalid samples;
- ``P m`` (map -> TOD sample) = ``index_select`` with invalid pixels
  reading 0.

Invalid samples carry a pixel id that is negative or ``>= npix``; each
public entry maps them to the drop slot once (:func:`pixel_stream`) and
shares the stream across its sums; a caller that bins one stream many
times (the scatter destriper's CG loop) passes the
:class:`PixelStream` itself in place of ``pixels``. On the card a
stream's sums add in a fixed order, planned once per stream
(:func:`~comapreduce_tpu_torch.ops.segment.segment_sums`), so a map is
the same bits on every run; on the CPU they are ``index_add_`` in sample
order, the order of the reference's segment sums there. ``npix`` may be
a :class:`~comapreduce_tpu_torch.mapmaking.pixel_space.PixelSpace`,
whose compacted maps have ``n_compact`` entries. The reference does
these with XLA segment sums, outside any Pallas kernel, so they stay
plain PyTorch on both devices. Sharded maps (``axis_name``) are not
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from comapreduce_tpu_torch.mapmaking.pixel_space import resolve_npix
from comapreduce_tpu_torch.ops.segment import (SegmentPlan, plan_segments,
                                               segment_sums)

__all__ = ["bin_map", "bin_offset_map", "sample_map", "accumulate_weights",
           "naive_map", "PixelStream", "pixel_stream"]


def _sanitize(pixels: torch.Tensor, npix: int) -> torch.Tensor:
    """Every invalid id (negative or ``>= npix``) -> the drop slot
    ``npix``, as i64 indices."""
    p = pixels.to(torch.int64)
    return torch.where((p < 0) | (p >= npix), torch.full_like(p, npix), p)


class PixelStream(NamedTuple):
    """A pixel stream sanitized once: ``pixels`` as given, ``sane`` (i64,
    every invalid id at the drop slot ``npix``) and, on the card, the
    fixed-order plan of its sums."""

    pixels: torch.Tensor
    sane: torch.Tensor
    npix: int
    plan: SegmentPlan | None


def pixel_stream(pixels, npix) -> PixelStream:
    """``pixels`` as a :class:`PixelStream` over ``npix`` bins (a stream is
    returned as it is); a card stream plans its sums here (one copy of the
    ids to the host)."""
    if isinstance(pixels, PixelStream):
        return pixels
    n = resolve_npix(npix)
    sane = _sanitize(pixels, n)
    plan = (None if sane.device.type == "cpu" else
            plan_segments(sane, n, one_launch=True))
    return PixelStream(pixels, sane, n, plan)


def _segment(values: torch.Tensor, stream: PixelStream) -> torch.Tensor:
    """Sum ``values`` f32[..., N] into the stream's ``npix`` bins (the
    drop slot is sliced off)."""
    if stream.plan is not None:
        return segment_sums(values, stream.plan)
    npix = stream.npix
    out = torch.zeros(values.shape[:-1] + (npix + 1,), dtype=values.dtype,
                      device=values.device)
    out.index_add_(-1, stream.sane, values)
    return out[..., :npix]


def accumulate_weights(pixels, weights: torch.Tensor,
                       npix) -> torch.Tensor:
    """``sum_w[p] = sum_{t: pix_t=p} w_t`` — the map-domain weights."""
    return _segment(weights, pixel_stream(pixels, npix))


def _bin_map_stream(tod, stream: PixelStream, weights, sum_w):
    wsum = _segment(tod * weights, stream)
    if sum_w is None:
        sum_w = _segment(weights, stream)
    zero = torch.zeros((), dtype=wsum.dtype, device=wsum.device)
    return torch.where(sum_w > 0, wsum / torch.clamp(sum_w, min=1e-30), zero)


def bin_map(tod: torch.Tensor, pixels, weights: torch.Tensor,
            npix, sum_w: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted naive map ``(P^T W d) / (P^T W 1)``; unhit pixels are 0.
    ``pixels``: a tensor or a :class:`PixelStream`."""
    return _bin_map_stream(tod, pixel_stream(pixels, npix), weights, sum_w)


def bin_offset_map(offsets: torch.Tensor, pixels: torch.Tensor,
                   weights: torch.Tensor, npix, offset_length: int,
                   sum_w: torch.Tensor | None = None) -> torch.Tensor:
    """Map of the offset vector stretched over ``offset_length`` samples
    each (sample ``t`` belongs to offset ``t // L``)."""
    stream = pixel_stream(pixels, npix)
    n = stream.pixels.shape[0]
    tod = torch.repeat_interleave(offsets, offset_length, dim=-1)[..., :n]
    return bin_map(tod, stream, weights, npix, sum_w=sum_w)


def sample_map(m: torch.Tensor, pixels) -> torch.Tensor:
    """``(P m)_t = m[pix_t]`` with invalid pixels reading 0."""
    if isinstance(pixels, PixelStream):
        pixels = pixels.pixels
    npix = m.shape[-1]
    p = pixels.to(torch.int64)
    valid = (p >= 0) & (p < npix)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    return torch.where(valid, torch.index_select(m, -1,
                                                 torch.clamp(p, 0, npix - 1)),
                       zero)


def naive_map(tod: torch.Tensor, pixels: torch.Tensor,
              weights: torch.Tensor, npix,
              sum_w: torch.Tensor | None = None):
    """``(signal, weight, hit)`` maps, the pixel stream sanitized once."""
    stream = pixel_stream(pixels, npix)
    if sum_w is None:
        sum_w = _segment(weights, stream)
    m = _bin_map_stream(tod, stream, weights, sum_w)
    hits = _segment(torch.ones_like(weights), stream)
    return m, sum_w, hits
