"""The port's per-scan atmosphere fit and subtraction
(``ops/atmosphere.fit_atmosphere_segments`` / ``subtract_atmosphere``)
against the reference's on the same numpy inputs (CPU): raw-count
scales, a 5% random mask, samples outside every scan, a scan at
constant airmass and one with a single valid sample (both degenerate:
slope 0, offset the masked mean), leading (feed, band) axes.

Tolerance: the reference's rtol 2e-5 of each output's scale
(``tests/test_reduce.py:209``, the steps that only sum and divide); the
two packages agree bitwise on this container.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from comapreduce_tpu.ops import atmosphere as ref
from comapreduce_tpu_torch.ops import atmosphere as port

RTOL = 2e-5


def _case(seed, F=2, B=2, C=16, T=900):
    rng = np.random.default_rng(seed)
    am = (1.2 + 0.1 * np.sin(np.arange(T) / 90.0)).astype(np.float32)
    am[600:700] = 1.25                       # scan 2: constant airmass
    ids = np.full(T, -1, np.int32)
    ids[50:300], ids[320:580], ids[600:700], ids[720:722] = 0, 1, 2, 3
    tod = (4.5e7 * (1 + 0.01 * rng.normal(size=(F, B, C, T)))
           + 3e6 * am).astype(np.float32)
    mask = (rng.random((F, B, C, T)) > 0.05).astype(np.float32)
    mask[..., 721] = 0.0                     # scan 3: one valid sample
    return tod, am, ids, mask


def _scaled(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_atmosphere_segments_matches_reference(seed):
    tod, am, ids, mask = _case(seed)
    ro, ra = ref.fit_atmosphere_segments(jnp.asarray(tod), jnp.asarray(am),
                                         jnp.asarray(ids), jnp.asarray(mask),
                                         n_scans=4)
    po, pa = port.fit_atmosphere_segments(
        torch.as_tensor(tod), torch.as_tensor(am), torch.as_tensor(ids),
        torch.as_tensor(mask), n_scans=4)
    assert po.shape == pa.shape == (2, 2, 16, 4)
    _scaled(po, ro, "offset")
    _scaled(pa, ra, "slope")
    # the degenerate scans: no slope, offset = masked mean
    assert (pa[..., 2:] == 0).all()
    m3 = mask[..., 720:722]
    np.testing.assert_allclose(
        po[..., 3].numpy(),
        (tod[..., 720:722] * m3).sum(-1) / np.maximum(m3.sum(-1), 1),
        rtol=1e-6)
    assert (pa[..., :2] != 0).all()


def test_subtract_atmosphere_matches_reference():
    tod, am, ids, mask = _case(2)
    ro, ra = ref.fit_atmosphere_segments(jnp.asarray(tod), jnp.asarray(am),
                                         jnp.asarray(ids), jnp.asarray(mask),
                                         n_scans=4)
    want = ref.subtract_atmosphere(jnp.asarray(tod), jnp.asarray(am),
                                   jnp.asarray(ids), ro, ra)
    got = port.subtract_atmosphere(
        torch.as_tensor(tod), torch.as_tensor(am), torch.as_tensor(ids),
        torch.as_tensor(np.array(ro)), torch.as_tensor(np.array(ra)))
    _scaled(got, want, "subtracted")
    # samples outside every scan are untouched
    out = ids < 0
    np.testing.assert_array_equal(got.numpy()[..., out], tod[..., out])
