"""K3's one-pass body (``binned_window_sum(..., ids_sorted=True)``): a
numpy model of its schedule against the reference, and the planned
solvers' promise that their ids ascend (CPU).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here ``one_pass_schedule`` replays what its blocks do, tile by tile:
tile ``t`` of ``tile`` elements owns the bins
``(ids[t*tile - 1], ids[(t+1)*tile - 1]]`` clipped to ``[0, out_size)``
(from bin 0 in the first tile, to ``out_size`` in the last); it writes
a run's sum where an id occurs and 0 in the gaps; a run that continues
past the tile is read ahead and finished by its owner, and later tiles
skip it; a run's terms add in tile order. The model runs at small tiles
(64, 256) and at the kernel's own (``ONE_PASS_TILE``) on the plans'
three K3 sites: every bin written exactly once and by its owner,
integer-valued sums bitwise equal to ``binned_window_sum_plain``, real
values within ``SUM_RTOL`` (rtol 2e-6 with atol 2e-6 of the output's
scale, ``tests/test_torch_pointing_plan.py``'s) of the reference's XLA
loop and its Pallas kernel (``interpret=True``).
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import window_sum_stress_case
from comapreduce_tpu.mapmaking.pallas_binning import (
    MAX_PALLAS_BIN_WINDOW, binned_window_sum_pallas)
from comapreduce_tpu.mapmaking.pointing_plan import _binned_window_sum_fori
from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL, OFFSET_LENGTH,
                                            field_geometry)
from comapreduce_tpu_torch.flagship import SMALL, observation_geometry
from comapreduce_tpu_torch.mapmaking import destriper, polarization
from comapreduce_tpu_torch.mapmaking.cuda_binning import (
    ONE_PASS_TILE, binned_window_sum_plain)
from comapreduce_tpu_torch.mapmaking.pointing_plan import (
    build_pointing_plan, build_sharded_plans)
from comapreduce_tpu_torch.parallel import feed_time_mesh
from comapreduce_tpu_torch.parallel.sharded import \
    make_destripe_sharded_planned

SUM_RTOL = 2e-6
TILES = (64, 256, ONE_PASS_TILE)
CASES = ("bench_small", "field_small", "random", "merged", "sharded")


def one_pass_schedule(vals, ids, base, window, chunk, out_size, tile):
    """The one-pass body's schedule in numpy: ``(out, writes, writer)``
    with ``out`` f32[R, out_size], the writes each bin took and the tile
    that wrote it (-1: none). Raises ``ValueError`` on a descent, as the
    kernel asserts."""
    ids = np.asarray(ids, np.int64)
    vals = np.asarray(vals, np.float32).reshape(-1, ids.size)
    M = ids.size
    if np.any(np.diff(ids) < 0):
        raise ValueError("ids descend")
    R = vals.shape[0]
    out = np.full((R, out_size), np.nan, np.float32)
    writes = np.zeros(out_size, np.int64)
    writer = np.full(out_size, -1, np.int64)

    def write(bins, tiles, sums):
        writes[bins] += 1
        writer[bins] = tiles
        out[:, bins] = sums

    e = np.arange(M)
    b = np.clip(np.asarray(base, np.int64)[e // chunk], 0, out_size)
    kept = np.where((ids >= b) & (ids - b < window), vals, np.float32(0))
    # segments: runs of one id cut at tile boundaries; a tile's first
    # segment continues the previous tile's last run when the id is the
    # same (that tile skips it: its owner read it ahead)
    cut = np.ones(M, bool)
    cut[1:] = ids[1:] != ids[:-1]
    cut[::tile] = True
    seg = np.flatnonzero(cut)
    seg_sums = np.add.reduceat(kept, seg, axis=1)
    cont = (seg % tile == 0) & (seg > 0)
    cont[cont] = ids[seg[cont]] == ids[seg[cont] - 1]
    # a run: its first segment (owned by that segment's tile) and the
    # continuations its owner reads ahead, added in tile order
    first = np.flatnonzero(~cont)
    sums = np.add.reduceat(seg_sums, first, axis=1)
    start = seg[first]
    key = ids[start]
    owner = start // tile
    own = (key >= 0) & (key < out_size)
    write(key[own], owner[own], sums[:, own])
    # zeros between an id and the one before it, by the tile of the id
    prev = np.where(start > 0, ids[np.maximum(start - 1, 0)], -1)
    lo = np.clip(prev + 1, 0, out_size)
    hi = np.clip(key, 0, out_size)
    n = np.maximum(hi - lo, 0)
    bins = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
            + np.repeat(lo, n))
    write(bins, np.repeat(owner, n), 0.0)
    # the last tile: every bin past the last id
    s = int(np.clip(ids[-1] + 1, 0, out_size))
    write(np.arange(s, out_size), (M - 1) // tile, 0.0)
    return out, writes, writer


def owning_tile(ids, tile, out_size):
    """The tile that owns each bin: the first whose last id reaches it
    (the last tile owns every bin past the last id)."""
    ids = np.asarray(ids, np.int64)
    last = ids[np.minimum(np.arange(tile, ids.size + tile, tile),
                          ids.size) - 1]
    t = np.searchsorted(last, np.arange(out_size), side="left")
    return np.minimum(t, last.size - 1)


def _plans(case):
    pix = np.random.default_rng(8).integers(-20, 420, 6000)
    if case == "bench_small":
        return [build_pointing_plan(observation_geometry(SMALL)[3],
                                    SMALL.nx * SMALL.ny,
                                    SMALL.offset_length)]
    if case == "field_small":
        return [build_pointing_plan(field_geometry(FIELD_SMALL)[0],
                                    FIELD_SMALL.nx * FIELD_SMALL.ny,
                                    OFFSET_LENGTH)]
    if case == "random":
        return [build_pointing_plan(pix, 400, 30, sample_chunk=512,
                                    pair_chunk=256)]
    if case == "merged":
        return [build_pointing_plan(pix, 400, 30, sample_chunk=512,
                                    pair_chunk=256, pair_batch=2)]
    return build_sharded_plans(pix, 400, 30, 2, sample_chunk=512,
                               pair_chunk=128)


def plan_sites(plan):
    """The planned solvers' three K3 layouts of ``plan``:
    ``(ids, base, window, chunk, out_size)`` each."""
    po = plan.pair_offset[plan.pair_perm_off.astype(np.int64)]
    return {
        "pair_sum": (plan.sample_pair, plan.sample_base,
                     plan.sample_window, plan.sample_chunk,
                     int(plan.pair_rank.shape[0])),
        "rank_sum": (plan.pair_rank, plan.rank_base, plan.rank_window,
                     plan.pair_chunk, plan.n_rank),
        "off_sum": (po, plan.off_base, plan.off_window, plan.pair_chunk,
                    plan.n_offsets),
    }


@functools.lru_cache(maxsize=None)
def _layouts(case):
    """Each site of each plan of ``case``, with its values (R = 2), the
    plain version's integer sums and the reference's two real sums."""
    rng = np.random.default_rng(17)
    out = []
    for i, plan in enumerate(_plans(case)):
        for site, (ids, base, window, chunk, n) in plan_sites(plan).items():
            ids = np.asarray(ids, np.int64)
            base = np.asarray(base, np.int64)
            ints = rng.integers(-2, 3, (2, ids.size)).astype(np.float32)
            vals = rng.normal(size=(2, ids.size)).astype(np.float32)
            it = torch.as_tensor(ids, dtype=torch.int32)
            bt = torch.as_tensor(base, dtype=torch.int32)
            want_int = binned_window_sum_plain(torch.as_tensor(ints), it, bt,
                                               window, chunk, n).numpy()
            ref = [np.asarray(f(jnp.asarray(vals), jnp.asarray(ids, jnp.int32),
                                jnp.asarray(base, jnp.int32), window, chunk,
                                n, **kw))
                   for f, kw in ((_binned_window_sum_fori, {}),
                                 (binned_window_sum_pallas,
                                  {"interpret": True}))]
            out.append((f"{case}[{i}].{site}", ids, base, window, chunk, n,
                        ints, want_int, vals, ref))
    return out


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL,
                               atol=SUM_RTOL * scale)


def _check_schedule(ids, base, window, chunk, n, tile, ints, want_int):
    got, writes, writer = one_pass_schedule(ints, ids, base, window, chunk,
                                            n, tile)
    assert (writes == 1).all(), "a bin written other than once"
    np.testing.assert_array_equal(writer, owning_tile(ids, tile, n))
    np.testing.assert_array_equal(got.view(np.int32),
                                  want_int.astype(np.float32).view(np.int32))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", CASES)
def test_one_pass_schedule_on_plan_sites(case, tile):
    for (name, ids, base, window, chunk, n, ints, want_int, vals,
         ref) in _layouts(case):
        _check_schedule(ids, base, window, chunk, n, tile, ints, want_int)
        got = one_pass_schedule(vals, ids, base, window, chunk, n, tile)[0]
        for want in ref:
            _close(got, want)


@pytest.mark.parametrize("tile", TILES)
def test_one_pass_schedule_on_sorted_stress_case(tile):
    """``window_sum_stress_case(sorted_ids=True)``: a window past the
    Pallas kernel's limit (so the reference's XLA loop holds the real
    values), runs of 5000 and 3000 equal ids across chunk and tile
    boundaries, windows clipped at 0 and at ``out_size``, a raised window
    start that drops ids, and a sentinel chunk."""
    ids, base, window, chunk, n = window_sum_stress_case(sorted_ids=True)
    assert window > MAX_PALLAS_BIN_WINDOW
    assert (np.diff(ids) >= 0).all()
    rng = np.random.default_rng(5)
    ints = rng.integers(-2, 3, (2, ids.size)).astype(np.float32)
    want_int = binned_window_sum_plain(
        torch.as_tensor(ints), torch.as_tensor(ids, dtype=torch.int32),
        torch.as_tensor(base, dtype=torch.int32), window, chunk, n).numpy()
    _check_schedule(ids, base, window, chunk, n, tile, ints, want_int)
    vals = rng.normal(size=(2, ids.size)).astype(np.float32)
    got = one_pass_schedule(vals, ids, base, window, chunk, n, tile)[0]
    _close(got, np.asarray(_binned_window_sum_fori(
        jnp.asarray(vals), jnp.asarray(ids, jnp.int32),
        jnp.asarray(base, jnp.int32), window, chunk, n)))


def test_one_pass_schedule_refuses_descending_ids():
    ids, base, window, chunk, n = window_sum_stress_case()
    with pytest.raises(ValueError, match="descend"):
        one_pass_schedule(np.ones(ids.size), ids, base, window, chunk, n,
                          ONE_PASS_TILE)


def test_one_pass_tile_is_the_kernels():
    """``ONE_PASS_TILE`` is the .cu's ``BW_TILE`` (threads x elements a
    thread), the constant that fixes the one-pass body's order."""
    src = (Path(destriper.__file__).resolve().parents[1] / "csrc" /
           "binned_window_sum.cu").read_text()
    threads = int(re.search(r"BW_TILE_THREADS = (\d+);", src).group(1))
    ept = int(re.search(r"BW_TILE_EPT = (\d+);", src).group(1))
    assert "constexpr int BW_TILE = BW_TILE_THREADS * BW_TILE_EPT;" in src
    assert threads * ept == ONE_PASS_TILE


def _recording(monkeypatch, module, calls):
    real = module.binned_window_sum

    def record(values, ids, base, window, chunk, out_size, **kw):
        calls.append((kw, bool((np.diff(ids.numpy().astype(np.int64))
                                >= 0).all())))
        return real(values, ids, base, window, chunk, out_size, **kw)

    monkeypatch.setattr(module, "binned_window_sum", record)


@pytest.mark.parametrize("case", CASES)
def test_planned_solvers_declare_their_ids_sorted(monkeypatch, case):
    """Every K3 call of the planned solvers (``destripe_planned`` with and
    without the ground template, ``destripe_pol_planned``; on sharded
    plans the sharded planned solve over a two-shard CPU mesh) passes
    ``ids_sorted=True``, and its ids ascend over the whole array (the
    one-pass body's contract)."""
    calls = []
    _recording(monkeypatch, destriper, calls)
    _recording(monkeypatch, polarization, calls)
    rng = np.random.default_rng(3)
    plans = _plans(case)
    if case == "sharded":
        n = sum(p.n_offsets * p.offset_length for p in plans)
        tod = rng.normal(size=n).astype(np.float32)
        make_destripe_sharded_planned(feed_time_mesh(["cpu"] * len(plans)),
                                      plans, n_iter=3)(tod, np.ones(n,
                                                                    np.float32))
    else:
        plan = plans[0]
        n = plan.n_offsets * plan.offset_length
        tod = torch.as_tensor(rng.normal(size=n).astype(np.float32))
        w = torch.ones(n)
        destriper.destripe_planned(tod, w, plan, n_iter=3)
        az = torch.as_tensor(rng.normal(size=n).astype(np.float32))
        destriper.destripe_planned(
            tod, w, plan, n_iter=3, az=az, n_groups=3,
            ground_off=torch.as_tensor(np.arange(plan.n_offsets) % 3))
        psi = torch.as_tensor(rng.uniform(0, np.pi, n).astype(np.float32))
        polarization.destripe_pol_planned(tod, w, psi, plan, n_iter=3,
                                          device="cpu")
    assert len(calls) > 10
    assert all(kw == {"ids_sorted": True} for kw, _ in calls)
    assert all(up for _, up in calls)
