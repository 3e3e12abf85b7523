"""Segment sums that add in a fixed order: the same bits from run to run
on the card, for ids in any order.

``index_add_`` on a CUDA tensor adds with float atomics, so a bin's sum
depends on the order its samples land in, which varies from run to run.
Here the ids are planned once on the host (:func:`plan_segments`): their
runs of equal ids in time order, or, when the ids are scattered, a
stable ordering that makes each id one run. On the card,
:func:`segment_sums` sums each run with one reduction over its
contiguous slice (``sum`` adds in an order fixed by the shape) and adds
a segment's runs in time order (:func:`run_sums`). On a CPU tensor it
adds sample by sample in time order (``index_add_`` there is a
sequential loop), the order of the reference's ``segment_sum`` on the
CPU, so the fits stay bit for bit where they are degenerate.

A plan made with ``one_launch=True`` (the destriper's sums, whose
segments run to thousands: coarse blocks, ground groups, the rows of a
multigrid level, map pixels) keeps instead the stable ordering of the
samples by id and each segment's length, laid out on the card at its
first sum there; :func:`segment_sums` then adds each segment's samples
in that order, a few launches whatever the number of segments:
segments of like lengths gathered into zero-padded rows and each row
summed, any others in pieces of ``PIECE`` samples and then their pieces
(two ``segment_reduce`` calls).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["SegmentPlan", "plan_segments", "segment_sums", "run_sums"]

# the most runs summed slice by slice; scattered ids past it are
# reordered (one gather) so that each segment is one run
MAX_RUNS = 256


@dataclass(frozen=True)
class SegmentPlan:
    """The fixed summation order of ``n_segments`` segments over the
    samples of ``ids`` (i64[n], ids outside ``[0, n_segments)`` in no
    segment): ``runs`` holds (segment, start, end) of each contiguous
    run of the (possibly reordered) sample axis; ``order`` is the sample
    permutation applied first (None: time order). A ``one_launch`` plan
    keeps no runs: its stable id order and the length of each id class
    in that order (below 0, each segment, ``n_segments`` and above) are
    made at its first sum on the card and kept there."""

    ids: np.ndarray
    n_segments: int
    runs: tuple
    order: np.ndarray | None = None
    one_launch: bool = False
    _on_device: dict = field(default_factory=dict, compare=False,
                             repr=False)

    @property
    def n(self) -> int:
        return int(self.ids.size)


def plan_segments(ids, n_segments: int,
                  one_launch: bool = False) -> SegmentPlan:
    """Plan the sums of ``n_segments`` segments over ``ids`` (on the host
    or the card: a card tensor is copied back once). ``one_launch``: the
    sorted plan :func:`segment_sums` adds in a few launches on the card,
    for any number of segments."""
    ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids,
                     dtype=np.int64).reshape(-1)
    if one_launch:
        return SegmentPlan(ids, int(n_segments), (), one_launch=True)
    order = None
    srt = ids
    cuts = np.flatnonzero(np.diff(srt)) + 1
    if cuts.size + 1 > MAX_RUNS:
        order = np.argsort(ids, kind="stable")
        srt = ids[order]
        cuts = np.flatnonzero(np.diff(srt)) + 1
    starts = np.concatenate([[0], cuts]).astype(np.int64)
    ends = np.concatenate([cuts, [srt.size]]).astype(np.int64)
    runs = tuple((int(srt[s]), int(s), int(e)) for s, e in zip(starts, ends)
                 if srt.size and 0 <= srt[s] < n_segments)
    return SegmentPlan(ids, int(n_segments), runs, order)


# a one-launch plan whose segments are of like lengths (n_segments x the
# longest at most PAD_WASTE x the samples) gathers each segment into a
# row of its own, zero-padded, and sums the rows; any other sums each
# segment in pieces of at most PIECE samples, then each segment's pieces
# in order, so a long segment (a ground group of thousands of offsets)
# is never one thread's serial loop
PAD_WASTE = 2
PIECE = 64


def _sorted_layout(plan: SegmentPlan, device) -> tuple:
    """The layout of a one-launch plan's sums on ``device``, built there
    once (a stable sort, a count and a few index sums; two host reads of
    a size): ``("pad", gather, longest)`` with ``gather``
    i64[n_segments x longest] into the samples and one zero slot past
    them, or ``("pieces", order, piece lengths, pieces a class)`` over the
    samples sorted by id (``order`` None when they already are)."""
    layout = plan._on_device.get(device)
    if layout is not None:
        return layout
    n = plan.n_segments
    ids = torch.as_tensor(plan.ids, device=device)
    N = ids.numel()
    cls = torch.clamp(ids + 1, 0, n + 1)
    order = torch.sort(cls, stable=True).indices
    lengths = torch.bincount(cls, minlength=n + 2)
    seg_len = lengths[1:n + 1]
    longest = int(seg_len.max()) if n else 0
    if n * longest <= PAD_WASTE * N + 4096:
        j = torch.arange(longest, device=device)
        pos = torch.cumsum(lengths, 0)[:n, None] + j[None, :]
        inside = j[None, :] < seg_len[:, None]
        gather = torch.where(inside, order[pos.clamp(max=max(N - 1, 0))]
                             if N else pos, N)
        layout = ("pad", gather.reshape(-1), longest)
    else:
        n_pieces = torch.clamp((lengths + PIECE - 1) // PIECE, min=1)
        pieces = torch.full((int(n_pieces.sum()),), PIECE, device=device)
        pieces[torch.cumsum(n_pieces, 0) - 1] = \
            lengths - (n_pieces - 1) * PIECE
        in_order = bool((ids[1:] >= ids[:-1]).all()) if N > 1 else True
        layout = ("pieces", None if in_order else order, pieces, n_pieces)
    plan._on_device[device] = layout
    return layout


def _sorted_sums(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """A one-launch plan's sums, each segment's samples in id-sorted order
    (:func:`_sorted_layout`): a reduction over each padded row, or two
    ``segment_reduce`` calls, pieces then segments."""
    layout = _sorted_layout(plan, x.device)
    n = plan.n_segments
    lead = x.shape[:-1]
    flat = x.reshape(math.prod(lead), x.shape[-1])
    if layout[0] == "pad":
        _, gather, longest = layout
        rows = torch.cat([flat, flat.new_zeros((flat.shape[0], 1))], dim=1)
        out = torch.index_select(rows, 1, gather).reshape(
            flat.shape[0], n, longest).sum(dim=-1)
        return out.reshape(lead + (n,))
    _, order, pieces, n_pieces = layout
    if order is not None:
        flat = torch.index_select(flat, 1, order)
    part = torch.segment_reduce(flat, "sum", lengths=pieces.expand(
        flat.shape[0], -1), axis=1, unsafe=True, initial=0.0)
    out = torch.segment_reduce(part, "sum", lengths=n_pieces.expand(
        flat.shape[0], -1), axis=1, unsafe=True, initial=0.0)
    return out[:, 1:n + 1].reshape(lead + (n,))


def run_sums(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """f[..., n] -> f[..., n_segments]: each run summed by one reduction
    over its slice, a segment's runs added in time order (an empty
    segment holds 0). The card's order; any device."""
    if plan.one_launch:
        return _sorted_sums(x, plan)
    if plan.order is not None:
        x = torch.index_select(x, -1, torch.as_tensor(plan.order,
                                                      device=x.device))
    parts: list[list[torch.Tensor]] = [[] for _ in range(plan.n_segments)]
    for seg, s, e in plan.runs:
        parts[seg].append(x[..., s:e].sum(dim=-1))
    zero = x.new_zeros(x.shape[:-1])
    cols = []
    for p in parts:
        acc = p[0] if p else zero
        for q in p[1:]:
            acc = acc + q
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def segment_sums(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """f[..., n] -> f[..., n_segments]: each segment's samples summed in
    a fixed order, :func:`run_sums`' on the card and sample by sample on
    the CPU (``index_add_`` in time order, bit for bit the sums it
    replaces)."""
    if x.shape[-1] != plan.n:
        raise ValueError(f"segment_sums: {x.shape[-1]} samples, plan for "
                         f"{plan.n}")
    if x.device.type != "cpu":
        return run_sums(x, plan)
    n = plan.n_segments
    ids = torch.from_numpy(plan.ids)
    seg = torch.where((ids < 0) | (ids >= n), torch.full_like(ids, n), ids)
    flat = x.reshape(math.prod(x.shape[:-1]), x.shape[-1])
    out = torch.zeros((flat.shape[0], n + 1), dtype=x.dtype)
    out.index_add_(1, seg, flat)
    return out[:, :n].reshape(x.shape[:-1] + (n,))
