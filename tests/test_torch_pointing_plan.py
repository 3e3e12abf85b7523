"""The port's pointing plan and kernel K3 (``binned_window_sum``) against
the reference, on the same numpy inputs (CPU).

Tolerances: the plan is integer bookkeeping built by the same numpy
algorithm, so every array is held BYTE-equal to the reference's. The
window sums add the same values in another order than the reference's
ordered chunk loop (and, on the card, in the kernel's fixed two-pass
order): rtol 2e-6 with atol 2e-6 of the output's scale — the bound
``tests/test_pallas_binning.py`` holds the Pallas kernel to.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from comapreduce_tpu.mapmaking.pallas_binning import \
    binned_window_sum_pallas
from comapreduce_tpu.mapmaking.pixel_space import PixelSpace as RefSpace
from comapreduce_tpu.mapmaking.pointing_plan import (
    _binned_window_sum_fori, build_pointing_plan as ref_build_plan)
from comapreduce_tpu_torch.convert import (PLAN_ARRAY_FIELDS,
                                           PLAN_STATIC_FIELDS, plan_arrays,
                                           plan_from_reference)
from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL, OFFSET_LENGTH,
                                            field_geometry)
from comapreduce_tpu_torch.flagship import SMALL, observation_geometry
from comapreduce_tpu_torch.mapmaking.cuda_binning import \
    binned_window_sum_plain
from comapreduce_tpu_torch.mapmaking.pixel_space import PixelSpace
from comapreduce_tpu_torch.mapmaking.pointing_plan import (
    binned_window_sum, build_pointing_plan, build_sharded_plans)

SUM_RTOL = 2e-6


def _raster(n, npix, n_bad=37, seed=0):
    rng = np.random.default_rng(seed)
    nx = int(np.sqrt(npix))
    t = np.arange(n)
    x = np.abs(((t / 97.0) % 2.0) - 1.0) * (nx - 1)
    y = np.abs(((t * 3 / n) % 2.0) - 1.0) * (nx - 1)
    pix = (np.round(y) * nx + np.round(x)).astype(np.int64)
    bad = rng.choice(n, size=n_bad, replace=False)
    pix[bad[: n_bad // 2]] = -1
    pix[bad[n_bad // 2:]] = npix + rng.integers(0, 5, n_bad - n_bad // 2)
    return pix


def _assert_plans_equal(port, ref):
    for k in PLAN_ARRAY_FIELDS:
        a, b = np.asarray(getattr(port, k)), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    for k in PLAN_STATIC_FIELDS:
        assert int(getattr(port, k)) == int(getattr(ref, k)), k


@pytest.mark.parametrize("n,npix,L,chunks,pair_batch", [
    (4000, 144, 50, (512, 256), None),
    (6000, 400, 30, (1024, 512), 1),
    (12000, 1024, 25, (8192, 4096), None),
    (1000, 64, 50, (128, 128), None),
])
def test_plan_arrays_byte_equal(n, npix, L, chunks, pair_batch):
    pix = _raster(n, npix)
    kw = dict(sample_chunk=chunks[0], pair_chunk=chunks[1],
              pair_batch=pair_batch)
    _assert_plans_equal(build_pointing_plan(pix, npix, L, **kw),
                        ref_build_plan(pix, npix, L, **kw))


def test_plan_rejects_merged_pair_chunks():
    """Merged pair chunks (``pair_batch`` > 1) were refused until the
    sharded slice ported them; the merged layout (chunks of
    ``pair_chunk x pair_batch`` pairs) now equals the reference's byte
    for byte, and ``COMAP_PAIR_BATCH`` pins the auto value as there."""
    pix = _raster(4000, 144)
    for pb in (2, 4):
        kw = dict(sample_chunk=512, pair_chunk=256, pair_batch=pb)
        plan = build_pointing_plan(pix, 144, 50, **kw)
        assert plan.pair_batch == pb and plan.pair_chunk == 256 * pb
        _assert_plans_equal(plan, ref_build_plan(pix, 144, 50, **kw))


def test_plan_with_compacted_pixel_space():
    pix = _raster(4000, 144)
    npix = 4 * 144
    ref_space = RefSpace.from_pixels(pix, npix)
    space = PixelSpace.from_pixels(pix, npix)
    assert space == PixelSpace.from_dictionary(ref_space.pixels, npix)
    np.testing.assert_array_equal(space.remap(pix), ref_space.remap(pix))
    _assert_plans_equal(
        build_pointing_plan(pix, npix, 50, sample_chunk=512,
                            pair_chunk=256, pixel_space=space),
        ref_build_plan(pix, npix, 50, sample_chunk=512, pair_chunk=256,
                       pixel_space=ref_space))


def test_plan_from_reference_round_trip():
    pix = _raster(4000, 144)
    ref = ref_build_plan(pix, 144, 50, sample_chunk=512, pair_chunk=256)
    arrays, static = plan_arrays(ref)
    port = plan_from_reference(arrays, **static)
    _assert_plans_equal(port, ref)
    dv = port.device("cpu")
    assert dv["sample_perm"].dtype == torch.int32
    assert dv is port.device(torch.device("cpu"))   # cached per device
    with pytest.raises(ValueError, match="missing"):
        plan_from_reference({}, npix=1)


def _small_plans(which):
    """The plans the BENCH_SMALL flagship, the FIELD_SMALL field run or a
    random pointing (sample chunks of 512, pair chunks of 256; also with
    merged pair chunks, ``pair_batch=2``, and as two shards'
    ``build_sharded_plans``) give."""
    if which == "bench_small":
        return [build_pointing_plan(observation_geometry(SMALL)[3],
                                    SMALL.nx * SMALL.ny, SMALL.offset_length)]
    if which == "field_small":
        return [build_pointing_plan(field_geometry(FIELD_SMALL)[0],
                                    FIELD_SMALL.nx * FIELD_SMALL.ny,
                                    OFFSET_LENGTH)]
    pix = np.random.default_rng(8).integers(-20, 420, 6000)
    if which == "sharded":
        return build_sharded_plans(pix, 400, 30, 2, sample_chunk=512,
                                   pair_chunk=128)
    return [build_pointing_plan(pix, 400, 30, sample_chunk=512,
                                pair_chunk=256,
                                pair_batch=2 if which == "merged" else 1)]


@pytest.mark.parametrize("which", ["bench_small", "field_small", "random",
                                   "merged", "sharded"])
def test_k3_sites_ids_ascending_within_windows(which):
    """At each of K3's three call sites (those of ``destripe_planned`` and
    of ``destripe_pol_planned``, which sum over the same three layouts)
    the plan's ids ascend over the whole array and every chunk lies
    inside its window, so K3's runs of equal ids are as long as the data
    allows and its one-pass body (``ids_sorted=True``, which the six call
    sites pass) holds; the two-pass body is right for ids in any order
    inside a chunk. On merged pair chunks and on every shard's plan too."""
    for plan in _small_plans(which):
        perm_off = plan.pair_perm_off.astype(np.int64)
        sites = {
            "pair_sum": (plan.sample_pair, plan.sample_base,
                         plan.sample_window, plan.sample_chunk),
            "rank_sum": (plan.pair_rank, plan.rank_base, plan.rank_window,
                         plan.pair_chunk),
            "off_sum": (plan.pair_offset[perm_off], plan.off_base,
                        plan.off_window, plan.pair_chunk),
        }
        for site, (ids, base, window, chunk) in sites.items():
            ids = np.asarray(ids, np.int64)
            assert ids.size % chunk == 0 and ids.size // chunk == base.size
            assert (np.diff(ids) >= 0).all(), site
            blocks = ids.reshape(-1, chunk)
            assert (blocks[:, -1] - blocks[:, 0] + 1 <= window).all(), site
            assert (blocks[:, 0] == base).all(), site


def _windowed(M, out_size, chunk, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, out_size, M))
    blocks = ids.reshape(M // chunk, chunk)
    base = blocks[:, 0]
    window = int(-(-int((blocks[:, -1] - base + 1).max()) // 16) * 16)
    return ids, base, window


def _sums(vals, ids, base, window, chunk, out_size):
    args = (window, chunk, out_size)
    got = binned_window_sum(torch.as_tensor(vals),
                            torch.as_tensor(ids, dtype=torch.int32),
                            torch.as_tensor(base, dtype=torch.int32), *args)
    fori = _binned_window_sum_fori(jnp.asarray(vals),
                                   jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(base, jnp.int32), *args)
    pallas = binned_window_sum_pallas(jnp.asarray(vals),
                                      jnp.asarray(ids, jnp.int32),
                                      jnp.asarray(base, jnp.int32), *args,
                                      interpret=True)
    return got.numpy(), np.asarray(fori), np.asarray(pallas)


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL,
                               atol=SUM_RTOL * scale)


@pytest.mark.parametrize("lead,chunk", [((), 128), ((3,), 128),
                                        ((2, 2), 256), ((4,), 512)])
def test_window_sum_matches_fori_and_pallas(lead, chunk):
    rng = np.random.default_rng(1)
    M, out_size = 1024, 300
    ids, base, window = _windowed(M, out_size, chunk)
    vals = rng.normal(size=lead + (M,)).astype(np.float32)
    got, fori, pallas = _sums(vals, ids, base, window, chunk, out_size)
    assert got.shape == lead + (out_size,)
    _close(got, fori)
    _close(got, pallas)


@pytest.mark.parametrize("lead,chunk", [((), 128), ((4,), 256)])
def test_window_sum_with_ids_shuffled_in_chunks_matches_reference(lead,
                                                                  chunk):
    """K3's contract holds for ids in any order inside a chunk (sorted
    ids may only make it faster): the plan's ids and values permuted
    within each chunk, the port against the reference's XLA loop and its
    Pallas kernel (``interpret=True``) on the same permuted inputs."""
    rng = np.random.default_rng(4)
    M, out_size = 2048, 500
    ids, base, window = _windowed(M, out_size, chunk, seed=3)
    vals = rng.normal(size=lead + (M,)).astype(np.float32)
    perm = np.concatenate([c * chunk + rng.permutation(chunk)
                           for c in range(M // chunk)])
    got, fori, pallas = _sums(vals[..., perm], ids[perm], base, window,
                              chunk, out_size)
    sorted_got = _sums(vals, ids, base, window, chunk, out_size)[0]
    _close(got, fori)
    _close(got, pallas)
    _close(got, sorted_got)


def test_window_sum_sentinel_and_out_of_window_drop():
    """Whole sentinel chunks at, past and far past out_size add nothing;
    ids outside a chunk's window drop on both sides
    (``tests/test_pallas_binning.py``'s drop contract)."""
    chunk, out_size, window = 128, 100, 64
    ids = np.concatenate([
        np.sort(np.random.default_rng(0).integers(10, 10 + window - 4,
                                                  chunk)),
        np.full(chunk, out_size), np.full(chunk, out_size + 10),
        np.full(chunk, out_size + 1000)]).astype(np.int64)
    ids[0] = 5
    ids[chunk - 1] = 10 + window
    base = np.array([10, out_size, out_size + 10, out_size + 1000])
    vals = np.ones(ids.size, np.float32)
    in_win = (ids[:chunk] >= 10) & (ids[:chunk] < 10 + window)
    want = np.bincount(ids[:chunk][in_win], minlength=out_size)
    got, fori, pallas = _sums(vals, ids, base, window, chunk, out_size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fori)
    np.testing.assert_array_equal(got, pallas)


def test_window_sum_clips_negative_base():
    """A window starting below 0 clips to 0 (landing stays absolute):
    ids past the clipped window's end drop."""
    chunk, out_size, window = 128, 50, 16
    ids = np.sort(np.random.default_rng(3).integers(0, 30, chunk))
    base = np.array([-8])
    vals = np.random.default_rng(4).normal(size=chunk).astype(np.float32)
    got, fori, _ = _sums(vals, ids, base, window, chunk, out_size)
    _close(got, fori)
    assert not got[window:].any()


def test_window_sum_multi_rhs_rows_match_single():
    rng = np.random.default_rng(2)
    M, out_size, chunk, nb = 512, 200, 128, 3
    ids, base, window = _windowed(M, out_size, chunk, seed=2)
    vals = rng.normal(size=(nb, M)).astype(np.float32)
    it = torch.as_tensor(ids, dtype=torch.int32)
    bt = torch.as_tensor(base, dtype=torch.int32)
    multi = binned_window_sum(torch.as_tensor(vals), it, bt, window, chunk,
                              out_size)
    for b in range(nb):
        one = binned_window_sum(torch.as_tensor(vals[b]), it, bt, window,
                                chunk, out_size)
        np.testing.assert_array_equal(multi[b].numpy(), one.numpy())


def test_window_sum_zero_length():
    e = binned_window_sum(torch.zeros((2, 0)),
                          torch.zeros((0,), dtype=torch.int32),
                          torch.zeros((0,), dtype=torch.int32), 64, 128, 50)
    assert e.shape == (2, 50) and not e.any()


def test_window_sum_validates_layout():
    with pytest.raises(ValueError, match="multiple"):
        binned_window_sum_plain(torch.zeros(100),
                                torch.zeros(100, dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32), 16, 64,
                                10)
    with pytest.raises(ValueError, match="base"):
        binned_window_sum_plain(torch.zeros(128),
                                torch.zeros(128, dtype=torch.int32),
                                torch.zeros(3, dtype=torch.int32), 16, 64,
                                10)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_window_sum_matches_plain(cuda_device):
    ids, base, window = _windowed(8192, 3000, 1024, seed=5)
    vals = torch.randn((4, 8192), device=cuda_device)
    it = torch.as_tensor(ids, dtype=torch.int32, device=cuda_device)
    bt = torch.as_tensor(base, dtype=torch.int32, device=cuda_device)
    before = binned_window_sum.launches
    got = binned_window_sum(vals, it, bt, window, 1024, 3000)
    assert binned_window_sum.launches == before + 1
    want = binned_window_sum_plain(vals.cpu(), it.cpu(), bt.cpu(), window,
                                   1024, 3000)
    _close(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("streams", ["files", "tensors", "none"])
def test_build_seen_pixel_space_matches_reference(streams):
    """The campaign dictionary: the same sorted union as the reference's
    ``build_seen_pixel_space``, whatever the streams' order (sentinels
    and out-of-range ids drop out)."""
    from comapreduce_tpu.mapmaking.pixel_space import \
        build_seen_pixel_space as ref_build
    from comapreduce_tpu_torch.mapmaking import build_seen_pixel_space

    rng = np.random.default_rng(9)
    npix = 500
    parts = [] if streams == "none" else \
        [rng.integers(-3, npix + 3, size=n) for n in (40, 300, 1, 77)]
    want = ref_build(iter(parts), npix)
    feed = [torch.as_tensor(p) for p in parts] if streams == "tensors" \
        else parts
    got = build_seen_pixel_space(iter(feed), npix)
    assert got.npix_sky == want.npix_sky and got.n_compact == want.n_compact
    np.testing.assert_array_equal(got.pixels, want.pixels)
    assert got == build_seen_pixel_space(reversed(feed), npix)
