"""The port's CUDA kernels on the card: K1 (masked fill) in its second
body (rows too long to keep on chip, which the main path's shapes never
take: keys in device scratch) and on rows at the edges of its
selection, K2 (rolling median) at the main path's shape, at the edges of
its selection, on odd and even windows and in its second body, K3
(binned window sum) on a layout that stresses both bodies (the two-pass
body with ids shuffled in a chunk, the one-pass body with them sorted
back, and on runs that cross many of its tiles; a descent under
``ids_sorted=True`` fails the launch), and K4
(windowed gather) on every lane kind (in-window, out-of-window, sentinel
ids >= S, clipped window starts) with two and three source rows and in
its scalar body, each against its plain version. The edge rows, the
stress layout and the lane-kind case are ``chip_smoke.py``'s. Beside the
kernels: ``precise_dot`` on the card against a float64 dot, and the
band solve under the multigrid V-cycle with and without the banded
noise prior, card against CPU at FIELD_SMALL.

This file imports neither ``jax`` nor the JAX package, so it runs on a
machine with a card and no JAX: ``python -m pytest tests/test_torch_cuda.py``.
Everywhere else every test skips with a reason.

Tolerances: K1 is bitwise on rows that take the stride-4 median; a row
that takes the masked-mean fallback sums ~75 000 samples in another
order than ``torch.sum``, so it is held to rtol 1e-5 (f32 summation
order at that length). K2 returns order statistics and their
``_median_mid``: bitwise. K3 adds in its own fixed order, not the plain
version's: bitwise on integer-valued sums (exact in f32 in any order)
and, on real values, each bin within gamma(n-1) * sum|x| of its exact
f64 sum, a bound that holds for every summation order
(``chip_smoke.check_window_sum``); launches on the same inputs give the
same bits, either body, and so do the planned solver's fixed-order
segment sums. K4 copies one source word per lane:
bitwise. ``precise_dot``: within u |exact| plus (depth + 2)^2 u^2
sum|x y| of the float64 dot (``chip_smoke.phase_small_mg_banded``).
Converged band solves, card against CPU: 5e-4 absolute on the
null-space-invariant or mean-removed products (``chip_smoke.FIELD_ATOL``;
the card sums in another order than the CPU).
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chip_smoke import (FIELD_ATOL, K2_LONGEST_WINDOW, fill_edge_rows,
                        gather_lane_case, median_edge_rows, precise_dot_case,
                        window_sum_stress_case)
from comapreduce_tpu_torch.cli.run_destriper import solve_band
from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL, MG_KW, OFFSET_LENGTH,
                                            field_geometry, invariants,
                                            make_field_band,
                                            make_field_band_1f)
from comapreduce_tpu_torch.mapmaking.cuda_binning import (
    ONE_PASS_TILE, binned_window_sum, binned_window_sum_plain,
    windowed_gather, windowed_gather_plain)
from comapreduce_tpu_torch.ops.cuda_median import (
    RM_OUT, fill_row_on_chip, masked_fill, masked_fill_plain,
    rolling_median_sorts, rolling_median_windows,
    rolling_median_windows_plain)
from comapreduce_tpu_torch.ops.precision import precise_dot

F32_U = 2.0 ** -24


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(a: np.ndarray) -> np.ndarray:
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


# L % 4 == 0 takes the float4 loads, the odd length the scalar ones
@pytest.mark.cuda
@pytest.mark.parametrize("L", [300_000, 300_001])
def test_cuda_masked_fill_streams_keys_past_smem_budget(cuda_device, L):
    assert not fill_row_on_chip(L)
    rng = np.random.default_rng(L)
    rows = 6
    tod = (10.0 + rng.normal(size=(rows, L))).astype(np.float32)
    mask = (rng.random((rows, L)) > 0.05).astype(np.float32)
    tod[1, 7] = np.nan             # masked out: takes the fill
    mask[1, 7] = 0.0
    tod[2, 9] = np.nan             # masked in: passes through
    mask[2, 9] = 1.0
    mask[3] = 0.0                  # the mean fallback: valid off the
    mask[3, 1::4] = 1.0            # stride-4 grid only
    mask[4] = 0.0                  # nothing valid: fill 0
    t = torch.as_tensor(tod, device=cuda_device)
    m = torch.as_tensor(mask, device=cuda_device)
    before = masked_fill.launches
    got = masked_fill(t, m).cpu().numpy()
    assert masked_fill.launches == before + 1
    want = masked_fill_plain(t.cpu(), m.cpu()).numpy()
    med = [0, 1, 2, 4, 5]
    np.testing.assert_array_equal(_bits(got[med]), _bits(want[med]))
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)


# the main path's L (float4 loads) and an odd L (scalar loads)
@pytest.mark.cuda
@pytest.mark.parametrize("L", [13568, 13567])
def test_cuda_masked_fill_edge_rows(cuda_device, L):
    tod, mask = fill_edge_rows(L)
    t = torch.as_tensor(tod, device=cuda_device)
    m = torch.as_tensor(mask, device=cuda_device)
    got = masked_fill(t, m).cpu().numpy()
    want = masked_fill_plain(t.cpu(), m.cpu()).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _window_sum_within_bound(got, vals, it, bt, args):
    """Each bin of ``got`` within gamma(n-1) * sum|x| of its exact sum."""
    plain64 = [binned_window_sum_plain(torch.as_tensor(x), it.cpu(),
                                       bt.cpu(), *args)
               for x in (vals.astype(np.float32).astype(np.float64),
                         np.abs(vals.astype(np.float32)).astype(np.float64),
                         np.ones((1, vals.shape[-1])))]
    exact, abs_sum, n = plain64[0], plain64[1], plain64[2][0]
    ku = (n - 1).clamp(min=0) * F32_U
    return bool(((got.cpu().double() - exact).abs()
                 <= ku / (1 - ku) * abs_sum).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_ids", [False, True],
                         ids=["two_pass", "one_pass"])
def test_cuda_window_sum_stress_case(cuda_device, sorted_ids):
    """The two-pass body on the stress layout (ids shuffled in chunk 40),
    the one-pass body on it with those ids sorted back; the launch counts
    one call and one call of its body."""
    ids, base, window, chunk, out_size = window_sum_stress_case(
        sorted_ids=sorted_ids)
    assert window > 32768
    rng = np.random.default_rng(9)
    it = torch.as_tensor(ids, dtype=torch.int32, device=cuda_device)
    bt = torch.as_tensor(base, dtype=torch.int32, device=cuda_device)
    args = (window, chunk, out_size)
    # integer values sum exactly in f32 in any order (every partial sum
    # stays below 2**24: the longest run is 5000 terms), so the routing
    # must match bitwise
    ints = torch.as_tensor(rng.integers(-2, 3, (4, ids.size)).astype(
        np.float32), device=cuda_device)
    body = "one_pass" if sorted_ids else "two_pass"
    before = binned_window_sum.launches, binned_window_sum.bodies[body]
    got = binned_window_sum(ints, it, bt, *args, ids_sorted=sorted_ids)
    assert (binned_window_sum.launches,
            binned_window_sum.bodies[body]) == (before[0] + 1,
                                                before[1] + 1)
    np.testing.assert_array_equal(
        got.cpu(), binned_window_sum_plain(ints.cpu(), it.cpu(), bt.cpu(),
                                           *args))
    vals = rng.normal(size=(4, ids.size))
    got = binned_window_sum(torch.as_tensor(vals.astype(np.float32),
                                            device=cuda_device),
                            it, bt, *args, ids_sorted=sorted_ids)
    assert _window_sum_within_bound(got, vals, it, bt, args)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 6])
def test_cuda_window_sum_one_pass_runs_across_tiles(cuda_device, R):
    """The one-pass body where runs cross many of its tiles: a run from
    the first element, one of 3 tiles plus 17 in the middle (its owner
    reads ahead), one ending on a tile's last element, one to the last
    element, gaps of one and of thousands of bins, a raised window start
    that drops terms inside a run, and a chunk (1000) that is not a
    multiple of 4 (the scalar loads). Integer values bitwise; real ones
    within the bound, the same bits over three launches."""
    T = ONE_PASS_TILE
    chunk = 1000
    M = 20 * chunk
    rng = np.random.default_rng(31)
    ids = np.sort(rng.integers(0, 40_000, M))
    ids[:T + 5] = ids[0]
    a = 4 * T - 9
    ids[a:a + 3 * T + 17] = ids[a]
    ids[7 * T - 40:7 * T] = ids[7 * T - 40]
    ids[-2 * T:] = ids[-2 * T]
    ids = np.maximum.accumulate(ids)
    ids[9000:] += 5000                      # a wide gap
    blocks = ids.reshape(-1, chunk)
    base = blocks[:, 0].copy()
    base[5] += 1                            # drops the chunk's first id
    window = int((blocks[:, -1] - base + 1).max())
    out_size = int(ids[-1]) + 3000
    it = torch.as_tensor(ids, dtype=torch.int32, device=cuda_device)
    bt = torch.as_tensor(base, dtype=torch.int32, device=cuda_device)
    args = (window, chunk, out_size)
    ints = torch.as_tensor(rng.integers(-2, 3, (R, M)).astype(np.float32),
                           device=cuda_device)
    np.testing.assert_array_equal(
        binned_window_sum(ints, it, bt, *args, ids_sorted=True).cpu(),
        binned_window_sum_plain(ints.cpu(), it.cpu(), bt.cpu(), *args))
    vals = rng.normal(size=(R, M))
    v = torch.as_tensor(vals.astype(np.float32), device=cuda_device)
    got = [binned_window_sum(v, it, bt, *args, ids_sorted=True).cpu()
           for _ in range(3)]
    assert _window_sum_within_bound(got[0], vals, it, bt, args)
    for g in got[1:]:
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      got[0].numpy().view(np.int32))


@pytest.mark.cuda
def test_cuda_window_sum_one_pass_fails_loudly_on_descending_ids(
        cuda_device):
    """``ids_sorted=True`` on ids that descend: the launch fails (a
    device-side assert, which ends the process's CUDA context, so it runs
    in a child process), never a silent wrong sum."""
    code = textwrap.dedent("""
        import torch
        from comapreduce_tpu_torch.mapmaking.cuda_binning import \\
            binned_window_sum
        ids = torch.arange(8192, dtype=torch.int32, device="cuda")
        ids[5000] = 3
        base = torch.zeros(2, dtype=torch.int32, device="cuda")
        binned_window_sum(torch.ones(8192, device="cuda"), ids, base, 8192,
                          4096, 8192, ids_sorted=True)
        torch.cuda.synchronize()
        print("no failure")
    """)
    child = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300)
    assert child.returncode != 0 and "no failure" not in child.stdout
    assert "device-side assert" in child.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("shuffled", [False, True],
                         ids=["sorted", "shuffled"])
def test_cuda_window_sum_same_bits_launch_to_launch(cuda_device, shuffled):
    """K3 launched three times on the stress layout (ids sorted over the
    whole array, the one-pass body; or shuffled inside each chunk, the
    two-pass body): the same bytes; the planned solver's segment sums
    (``ops.segment``, one-launch plans) twice: the same bytes."""
    from comapreduce_tpu_torch.ops.segment import (plan_segments,
                                                   segment_sums)

    ids, base, window, chunk, out_size = window_sum_stress_case(
        sorted_ids=True)
    rng = np.random.default_rng(12)
    if shuffled:
        perm = np.concatenate([c * chunk + rng.permutation(chunk)
                               for c in range(ids.size // chunk)])
        ids = ids[perm]
    it = torch.as_tensor(ids, dtype=torch.int32, device=cuda_device)
    bt = torch.as_tensor(base, dtype=torch.int32, device=cuda_device)
    vals = torch.as_tensor(rng.normal(size=(4, ids.size)).astype(
        np.float32), device=cuda_device)
    a, b, c = (binned_window_sum(vals, it, bt, window, chunk, out_size,
                                 ids_sorted=not shuffled).cpu()
               for _ in range(3))
    for x in (b, c):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      x.numpy().view(np.int32))
    grp = np.sort(rng.integers(0, 5000, ids.size)) if not shuffled \
        else rng.integers(0, 5000, ids.size)
    plan = plan_segments(grp, 5000, one_launch=True)
    c = segment_sums(vals, plan).cpu()
    d = segment_sums(vals, plan).cpu()
    np.testing.assert_array_equal(c.numpy().view(np.int32),
                                  d.numpy().view(np.int32))


# R = 2 is the ground solve's fused (c0, c1) gather
@pytest.mark.cuda
@pytest.mark.parametrize("R", [2, 3])
def test_cuda_windowed_gather_every_lane_kind(cuda_device, R):
    src, ids, base, window, chunk = gather_lane_case(R)
    s = torch.as_tensor(src, device=cuda_device)
    it = torch.as_tensor(ids, dtype=torch.int32, device=cuda_device)
    bt = torch.as_tensor(base, dtype=torch.int32, device=cuda_device)
    before = windowed_gather.launches
    got = windowed_gather(s, it, bt, window, chunk)
    torch.cuda.synchronize()
    assert windowed_gather.launches == before + 1
    want = windowed_gather_plain(s.cpu(), it.cpu(), bt.cpu(), window, chunk)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    assert not got[:, -chunk:].any()
    assert not got[:, [3, chunk, chunk + 5]].any()


# the scalar body: a chunk that is not a multiple of 4, and ids that
# start one word into their buffer (not 16-byte aligned)
@pytest.mark.cuda
@pytest.mark.parametrize("chunk,shift", [(255, 0), (256, 1)])
def test_cuda_windowed_gather_scalar_body(cuda_device, chunk, shift):
    src, ids, base, window, chunk = gather_lane_case(2, chunk)
    s = torch.as_tensor(src, device=cuda_device)
    buf = torch.zeros(ids.size + shift, dtype=torch.int32, device=cuda_device)
    buf[shift:] = torch.as_tensor(ids, dtype=torch.int32)
    it = buf[shift:]
    bt = torch.as_tensor(base, dtype=torch.int32, device=cuda_device)
    before = windowed_gather.launches
    got = windowed_gather(s, it, bt, window, chunk)
    torch.cuda.synchronize()
    assert windowed_gather.launches == before + 1
    want = windowed_gather_plain(s.cpu(), it.cpu(), bt.cpu(), window, chunk)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.numpy().view(np.int32))


def _median_bitwise(x, w):
    before = rolling_median_windows.launches
    got = rolling_median_windows(x, w).cpu().numpy()
    assert rolling_median_windows.launches == before + 1
    want = rolling_median_windows_plain(x.cpu(), w).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    return got


# the main path's shape: 2 scans x 4 bands of the block-median series,
# window 500 (T = 1631 outputs, not a multiple of RM_OUT)
@pytest.mark.cuda
def test_cuda_rolling_median_main_shape(cuda_device):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(8, 2130)).astype(np.float32),
                        device=cuda_device)
    assert rolling_median_sorts(500)
    _median_bitwise(x, 500)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tied", "block_median", "signed_zero_nan"])
def test_cuda_rolling_median_edge_rows(cuda_device, name):
    x = median_edge_rows(2130, 500)[name]
    got = _median_bitwise(torch.as_tensor(x, device=cuda_device), 500)
    if name == "signed_zero_nan":
        assert np.isnan(got[:3]).any() and not np.isnan(got[3]).any()
        assert (np.signbit(got) & (got == 0)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 37, 500])
def test_cuda_rolling_median_windows(cuda_device, w):
    rng = np.random.default_rng(w)
    P = 3 * RM_OUT + 17 + w - 1          # T = 3 RM_OUT + 17
    x = rng.normal(size=(3, P)).astype(np.float32)
    x[1, P // 2] = np.nan
    _median_bitwise(torch.as_tensor(x, device=cuda_device), w)


# windows whose sorted segment does not fit shared memory: the bisection
# body, up to the longest window whose 128-output segment of keys fits
# the 227 KB a block may use
@pytest.mark.cuda
@pytest.mark.parametrize("w", [20_000, K2_LONGEST_WINDOW])
def test_cuda_rolling_median_second_body(cuda_device, w):
    assert not rolling_median_sorts(w)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, w + 299)).astype(np.float32)
    x[1, 100] = np.nan
    _median_bitwise(torch.as_tensor(x, device=cuda_device), w)


# the field solve's offset count (206 264) and an odd length
@pytest.mark.cuda
@pytest.mark.parametrize("n", [206_264, 4097])
def test_cuda_precise_dot_matches_float64(cuda_device, n):
    x, y, exact = precise_dot_case(n, seed=3)
    got = float(precise_dot(torch.as_tensor(x, device=cuda_device),
                            torch.as_tensor(y, device=cuda_device)))
    abs_sum = float(np.dot(np.abs(x).astype(np.float64),
                           np.abs(y).astype(np.float64)))
    depth = int(np.ceil(np.log2(n)))
    assert abs(got - exact) <= (F32_U * abs(exact)
                                + (depth + 2) ** 2 * F32_U ** 2 * abs_sum)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ground_mg", "banded_mg"])
def test_cuda_multigrid_band_solve_matches_cpu(cuda_device, case):
    geo = field_geometry(FIELD_SMALL)
    kw = dict(offset_length=OFFSET_LENGTH, n_iter=100, threshold=1e-6,
              mg=MG_KW)
    if case == "ground_mg":
        data, _ = make_field_band(FIELD_SMALL, geo, 0)
        kw["use_ground"] = True
    else:
        data, _, quality = make_field_band_1f(FIELD_SMALL, geo, 0)
        kw.update(noise_weight={"bandwidth": 4}, quality=quality, band=0)
    res = {dev: solve_band(data, device=dev, **kw)
           for dev in (cuda_device, "cpu")}
    for r in res.values():
        assert float(r.residual) < 1e-6 and int(r.diverged) == 0
    card, cpu = res[cuda_device], res["cpu"]
    if case == "ground_mg":
        a = invariants(card, data, OFFSET_LENGTH)
        b = invariants(cpu, data, OFFSET_LENGTH)
    else:
        a, b = ({"offsets": r.offsets.cpu().numpy()
                 - float(r.offsets.mean())} for r in (card, cpu))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=FIELD_ATOL,
                                   err_msg=k)
    assert torch.equal(card.hit_map.cpu(), cpu.hit_map)


@pytest.mark.cuda
@pytest.mark.parametrize("cast", ["f32", "bf16"])
def test_prefetch_to_device_side_stream_bitwise(cuda_device, cast):
    """``ingest.prefetch_to_device`` on the card: blocks copied from
    pinned memory on a side stream arrive bitwise equal to ``.to``, in
    order, while the consumer's stream computes on each one (a bf16
    ``cast`` narrows on the host: the ``torch.bfloat16`` bits of
    ``BF16Array``)."""
    from comapreduce_tpu_torch.ingest import prefetch_to_device
    from comapreduce_tpu_torch.ops.precision import BF16Array

    rng = np.random.default_rng(4)
    blocks = [{"tod": rng.normal(size=(8, 4096)).astype(np.float32)}
              for _ in range(5)]
    narrow = (lambda b: {"tod": BF16Array.from_float(b["tod"])}) \
        if cast == "bf16" else None
    sums = []
    for i, blk in enumerate(prefetch_to_device(blocks, size=2,
                                               device=cuda_device,
                                               cast=narrow)):
        got = blk["tod"]
        assert got.is_cuda
        want = (BF16Array.from_float(blocks[i]["tod"]).to_tensor()
                if cast == "bf16" else torch.from_numpy(blocks[i]["tod"]))
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16 if cast == "bf16"
                                    else torch.int32).cpu(),
                           want.view(torch.int16 if cast == "bf16"
                                     else torch.int32))
        sums.append(got.float().sum())
    torch.cuda.synchronize()
    assert len(sums) == 5
