"""``mapmaking/binning.py`` of the port against the reference's on the same
numpy inputs: a raster pointing with invalid samples (negative ids and
ids past ``npix``), zero and positive weights, dense and compacted pixel
spaces; and K4's plain version on a two-row source (the ground solve's
fused ``(c0, c1)`` gather) against ``windowed_gather_pallas``.

Tolerances: sums of integer-valued inputs (hits, integer weights) are
exact in f32 in any order, so they are held bitwise, and so are gathers;
sums of real values are held to 1e-6 of the output's scale (the
reference's XLA segment sum and ``index_add_`` add in different orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import gather_lane_case
from comapreduce_tpu.mapmaking import binning as ref
from comapreduce_tpu.mapmaking.pallas_binning import windowed_gather_pallas
from comapreduce_tpu.mapmaking.pixel_space import PixelSpace as RefSpace
from comapreduce_tpu_torch.mapmaking import binning as port
from comapreduce_tpu_torch.mapmaking.cuda_binning import windowed_gather
from comapreduce_tpu_torch.mapmaking.pixel_space import PixelSpace

SCALE_RTOL = 1e-6


def _inputs(seed=0, n=3000, npix=100, int_weights=False):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, npix, n)
    pix[rng.choice(n, 40, replace=False)] = -1
    pix[rng.choice(n, 40, replace=False)] = npix + 3
    tod = rng.normal(size=n).astype(np.float32)
    if int_weights:
        w = rng.integers(0, 4, n).astype(np.float32)
    else:
        w = rng.uniform(0.5, 2.0, n).astype(np.float32)
        w[rng.choice(n, 30, replace=False)] = 0.0
    return pix, tod, w, npix


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=SCALE_RTOL * scale)


def test_accumulate_weights():
    pix, _, w, npix = _inputs(int_weights=True)
    np.testing.assert_array_equal(
        port.accumulate_weights(torch.as_tensor(pix), torch.as_tensor(w),
                                npix).numpy(),
        np.asarray(ref.accumulate_weights(jnp.asarray(pix, jnp.int32),
                                          jnp.asarray(w), npix)))
    pix, _, w, npix = _inputs(seed=1)
    _close(port.accumulate_weights(torch.as_tensor(pix), torch.as_tensor(w),
                                   npix),
           ref.accumulate_weights(jnp.asarray(pix, jnp.int32),
                                  jnp.asarray(w), npix))


@pytest.mark.parametrize("with_sum_w", [False, True])
def test_bin_map(with_sum_w):
    pix, tod, w, npix = _inputs(seed=2)
    sw_r = sw_p = None
    if with_sum_w:
        sw_r = ref.accumulate_weights(jnp.asarray(pix, jnp.int32),
                                      jnp.asarray(w), npix)
        sw_p = torch.as_tensor(np.array(sw_r))
    got = port.bin_map(torch.as_tensor(tod), torch.as_tensor(pix),
                       torch.as_tensor(w), npix, sum_w=sw_p)
    want = ref.bin_map(jnp.asarray(tod), jnp.asarray(pix, jnp.int32),
                       jnp.asarray(w), npix, sum_w=sw_r)
    _close(got, want)
    assert (got.numpy() == 0).sum() == (np.asarray(want) == 0).sum()


def test_bin_offset_map():
    pix, _, w, npix = _inputs(seed=3)
    offsets = np.random.default_rng(3).normal(size=pix.size // 50).astype(
        np.float32)
    _close(port.bin_offset_map(torch.as_tensor(offsets), torch.as_tensor(pix),
                               torch.as_tensor(w), npix, 50),
           ref.bin_offset_map(jnp.asarray(offsets), jnp.asarray(pix, jnp.int32),
                              jnp.asarray(w), npix, 50))


def test_sample_map_is_bitwise():
    pix, tod, _, npix = _inputs(seed=4)
    m = np.random.default_rng(4).normal(size=npix).astype(np.float32)
    np.testing.assert_array_equal(
        port.sample_map(torch.as_tensor(m), torch.as_tensor(pix)).numpy(),
        np.asarray(ref.sample_map(jnp.asarray(m),
                                  jnp.asarray(pix, jnp.int32))))


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_naive_map(compact):
    pix, tod, w, npix = _inputs(seed=5, npix=400)
    # a mostly-unhit sky; the invalid ids stay invalid
    pix = np.where((pix >= 0) & (pix < npix), pix % 150, pix)
    n_r = n_p = npix
    if compact:
        n_r = RefSpace.from_pixels(pix, npix)
        n_p = PixelSpace.from_pixels(pix, npix)
        remapped = n_p.remap(pix)
        np.testing.assert_array_equal(remapped, np.asarray(n_r.remap(pix)))
        pix = remapped
    got = port.naive_map(torch.as_tensor(tod), torch.as_tensor(pix),
                         torch.as_tensor(w), n_p)
    want = ref.naive_map(jnp.asarray(tod), jnp.asarray(pix, jnp.int32),
                         jnp.asarray(w), n_r)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].shape[-1] == (n_p.n_solve if compact else npix)


# K4 with the ground solve's two coefficient rows as one (2, S) source,
# on every lane kind (chip_smoke.py's case), chunks of 256 and 128
@pytest.mark.parametrize("chunk", [256, 128])
def test_windowed_gather_two_rows_matches_pallas(chunk):
    src, ids, base, window, chunk = gather_lane_case(2, chunk)
    got = windowed_gather(torch.as_tensor(src), torch.as_tensor(ids),
                          torch.as_tensor(base), window, chunk).numpy()
    want = np.asarray(windowed_gather_pallas(
        jnp.asarray(src), jnp.asarray(ids, jnp.int32),
        jnp.asarray(base, jnp.int32), window, chunk, interpret=True))
    assert got.shape == want.shape == (2, ids.size)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for r in range(2):
        np.testing.assert_array_equal(
            got[r], windowed_gather(torch.as_tensor(src[r]),
                                    torch.as_tensor(ids),
                                    torch.as_tensor(base), window,
                                    chunk).numpy())
