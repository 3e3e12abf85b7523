"""The port's spike flagging (``ops/spikes.py``) against the reference's on
the same numpy inputs (CPU): ``dilate_mask`` bitwise, and ``spike_mask``
at the shipped ``Spikes`` setting (window 101, pad 10), the reference's
defaults (window 501, pad 100) and without dilation, over a random walk
plus white noise with planted spikes and a partial validity mask.

The rolling median runs through K2's plain version on the CPU (K2 on the
card). Masks must be equal except at samples whose high-passed value
lies within ``MARGIN`` (relative) of ``threshold * rms`` — there two f32
paths may round to either side — widened by the dilation's ±pad. On
these inputs no sample is that close and the masks are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from comapreduce_tpu.ops import spikes as ref
from comapreduce_tpu.ops.median_filter import rolling_median as ref_median
from comapreduce_tpu.ops.stats import auto_rms as ref_auto_rms
from comapreduce_tpu_torch.ops import spikes as port

MARGIN = 1e-5


def _case(seed, F=2, B=2, T=3000):
    rng = np.random.default_rng(seed)
    tod = (np.cumsum(rng.normal(size=(F, B, T)), -1) * 0.01
           + rng.normal(size=(F, B, T))).astype(np.float32)
    hit = rng.integers(0, T, 40)
    tod[0, 0, hit] += (rng.normal(size=40) * 20).astype(np.float32)
    tod[1, 1, 1500:1503] += 50.0                  # a three-sample run
    valid = (rng.random((F, B, T)) > 0.02).astype(np.float32)
    valid[..., :100] = 0.0
    return tod, valid


@pytest.mark.parametrize("pad", [0, 1, 5])
def test_dilate_mask_is_bitwise(pad):
    rng = np.random.default_rng(pad)
    m = rng.random((3, 2, 200)) < 0.03
    want = np.asarray(ref.dilate_mask(jnp.asarray(m), pad))
    got = port.dilate_mask(torch.as_tensor(m), pad).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window,pad,seed", [(101, 10, 0), (501, 100, 1),
                                             (51, 0, 2)])
def test_spike_mask_matches_reference(window, pad, seed):
    tod, valid = _case(seed)
    want = np.asarray(ref.spike_mask(jnp.asarray(tod), window=window,
                                     pad=pad, valid=jnp.asarray(valid)))
    got = port.spike_mask(torch.as_tensor(tod), window=window, pad=pad,
                          valid=torch.as_tensor(valid)).numpy()
    assert got.dtype == want.dtype == np.bool_ and got.shape == want.shape
    assert want.sum() > 0                          # the planted spikes
    # samples within MARGIN of the threshold, and the pad around them
    hp = np.asarray(jnp.asarray(tod) - ref_median(jnp.asarray(tod), window))
    thr = 10.0 * np.asarray(ref_auto_rms(jnp.asarray(hp),
                                         jnp.asarray(valid)))[..., None]
    near = np.abs(np.abs(hp) - thr) <= MARGIN * thr
    allowed = np.asarray(ref.dilate_mask(jnp.asarray(near), pad))
    assert not (got != want)[~allowed].any()
