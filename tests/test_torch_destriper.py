"""``destripe_planned`` of the port against the reference's
``kernels="xla"`` path on the same problem (a copy of
``tests/test_pallas_binning.py::_problem``): the identical plan (carried
over with ``convert.plan_from_reference``) and the same numpy TOD and
weights.

Tolerances: ``threshold=0.0`` pins the iteration count, so both solves
run the same number of CG steps; offsets and maps are then held to the
reference's own planned-solver bound, atol 5e-4
(``tests/test_pallas_binning.py::_compare``), which covers f32
summation order accumulated over the iterations. Hit maps are counts:
exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from comapreduce_tpu.mapmaking.destriper import \
    _jacobi_inverse as ref_jacobi_inverse
from comapreduce_tpu.mapmaking.destriper import \
    destripe_planned as ref_destripe
from comapreduce_tpu.mapmaking.pointing_plan import \
    build_pointing_plan as ref_build_plan
from comapreduce_tpu_torch.convert import plan_arrays, plan_from_reference
from comapreduce_tpu_torch.mapmaking.destriper import (_jacobi_inverse,
                                                       destripe_planned)

ATOL = 5e-4


def _raster_pixels(n, npix, n_bad=37, seed=0, n_passes=3):
    rng = np.random.default_rng(seed)
    nx = int(np.sqrt(npix))
    t = np.arange(n)
    x = np.abs(((t / 97.0) % 2.0) - 1.0) * (nx - 1)
    y = np.abs(((t * n_passes / n) % 2.0) - 1.0) * (nx - 1)
    pix = (np.round(y) * nx + np.round(x)).astype(np.int64)
    bad = rng.choice(n, size=n_bad, replace=False)
    pix[bad[: n_bad // 2]] = -1
    pix[bad[n_bad // 2:]] = npix + rng.integers(0, 5, n_bad - n_bad // 2)
    return pix


def _problem(seed=2, n=4000, npix=144, L=50, n_bad=37):
    rng = np.random.default_rng(seed)
    pix = _raster_pixels(n, npix, n_bad=n_bad)
    offs = np.repeat(rng.normal(0, 1, n // L), L)
    sky = rng.normal(0, 1, npix + 8)
    tod = (sky[np.clip(pix, 0, npix - 1)] + offs
           + 0.1 * rng.normal(size=n)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.choice(n, 29, replace=False)] = 0.0
    return pix, tod, w, npix, L


def _port_plan(ref):
    arrays, static = plan_arrays(ref)
    return plan_from_reference(arrays, **static)


def _compare(port, ref, maps=("destriped_map", "naive_map")):
    np.testing.assert_allclose(port.offsets.numpy(),
                               np.asarray(ref.offsets), rtol=0, atol=ATOL)
    for name in maps:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    w = np.asarray(ref.weight_map)
    np.testing.assert_allclose(port.weight_map.numpy(), w, rtol=2e-6,
                               atol=2e-6 * float(np.abs(w).max()))
    np.testing.assert_array_equal(port.hit_map.numpy(),
                                  np.asarray(ref.hit_map))
    assert int(port.n_iter) == int(ref.n_iter)
    np.testing.assert_array_equal(np.asarray(port.diverged),
                                  np.asarray(ref.diverged))


def _bands(tod, w):
    return (np.stack([tod, np.roll(tod, 7), 0.5 * tod]),
            np.stack([w, w, np.roll(w, 3)]))


# single-RHS Jacobi runs again in the compact-map and tripwire tests
# below, multi-RHS Jacobi in the warm-start test
@pytest.mark.parametrize("precond,multi", [("none", False), ("none", True),
                                           ("jacobi", True)],
                         ids=["none-single", "none-multi", "jacobi-multi"])
def test_destripe_planned_matches_reference(precond, multi):
    pix, tod, w, npix, L = _problem()
    ref_plan = ref_build_plan(pix, npix, L, sample_chunk=512, pair_chunk=256)
    plan = _port_plan(ref_plan)
    if multi:
        tod, w = _bands(tod, w)
    ref = ref_destripe(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                       n_iter=12, threshold=0.0, precond=precond,
                       kernels="xla")
    got = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                           n_iter=12, threshold=0.0, precond=precond)
    _compare(got, ref)
    assert got.destriped_map.shape == ((3,) if multi else ()) + (npix,)


def test_destripe_planned_converges_like_reference():
    """At a real threshold both multi-RHS solves stop at the same
    iteration."""
    pix, tod, w, npix, L = _problem(seed=4)
    ref_plan = ref_build_plan(pix, npix, L, sample_chunk=512, pair_chunk=256)
    tod, w = _bands(tod, w)
    ref = ref_destripe(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                       n_iter=200, threshold=1e-5, kernels="xla")
    got = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w),
                           _port_plan(ref_plan), n_iter=200,
                           threshold=1e-5)
    assert abs(int(got.n_iter) - int(ref.n_iter)) <= 1
    assert torch.all(got.residual <= 1e-5)
    np.testing.assert_allclose(got.offsets.numpy(), np.asarray(ref.offsets),
                               rtol=0, atol=ATOL)


def test_destripe_planned_warm_start_and_trace():
    pix, tod, w, npix, L = _problem()
    ref_plan = ref_build_plan(pix, npix, L, sample_chunk=512, pair_chunk=256)
    tod, w = _bands(tod, w)
    x0 = np.random.default_rng(9).normal(
        0, 0.5, (3, ref_plan.n_offsets)).astype(np.float32)
    ref = ref_destripe(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                       n_iter=8, threshold=0.0, x0=jnp.asarray(x0),
                       trace_iters=10, kernels="xla")
    got = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w),
                           _port_plan(ref_plan), n_iter=8, threshold=0.0,
                           x0=torch.as_tensor(x0), trace_iters=10)
    _compare(got, ref)
    assert len(got.trace) == 4
    rr_ref, al_ref, be_ref, bn_ref = (np.asarray(t) for t in ref.trace)
    rr, al, be, bn = (t.numpy() for t in got.trace)
    assert rr.shape == rr_ref.shape == (10, 3)
    np.testing.assert_allclose(bn, bn_ref, rtol=1e-5)
    np.testing.assert_allclose(rr / bn, rr_ref / bn_ref, rtol=1e-3,
                               atol=1e-9)
    np.testing.assert_allclose(al, al_ref, rtol=1e-3)
    np.testing.assert_allclose(be, be_ref, rtol=1e-3, atol=1e-6)


def test_destripe_planned_compact_maps():
    pix, tod, w, npix, L = _problem()
    ref_plan = ref_build_plan(pix, npix, L, sample_chunk=512, pair_chunk=256)
    ref = ref_destripe(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                       n_iter=10, threshold=0.0, dense_maps=False,
                       kernels="xla")
    got = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w),
                           _port_plan(ref_plan), n_iter=10, threshold=0.0,
                           dense_maps=False)
    assert got.destriped_map.shape == (ref_plan.n_rank,)
    _compare(got, ref)


def test_destripe_planned_scrubs_non_finite():
    """The tripwire: NaN TOD / inf weight samples enter as (0, 0)."""
    pix, tod, w, npix, L = _problem()
    ref_plan = ref_build_plan(pix, npix, L, sample_chunk=512, pair_chunk=256)
    tod = tod.copy()
    w = w.copy()
    tod[100] = np.nan
    w[200] = np.inf
    ref = ref_destripe(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                       n_iter=10, threshold=0.0, kernels="xla")
    got = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w),
                           _port_plan(ref_plan), n_iter=10, threshold=0.0)
    assert torch.isfinite(got.destriped_map).all()
    _compare(got, ref)


def test_jacobi_inverse_matches_reference():
    rng = np.random.default_rng(0)
    diag = rng.uniform(0, 2, 50).astype(np.float32)
    diag[:5] = 0.0
    da = (diag * rng.uniform(-1e-7, 1, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        _jacobi_inverse(torch.as_tensor(da), torch.as_tensor(diag)).numpy(),
        np.asarray(ref_jacobi_inverse(jnp.asarray(da), jnp.asarray(diag))))


# ground_off=, coarse=, mg=, banded= and cg_dot="compensated" are ported
# now (tests/test_torch_{ground,coarse,multigrid,noise_weight,precision}.py
# hold them to the reference); the sharded options still raise, whatever
# else is asked
@pytest.mark.parametrize("kw", [
    {"axis_name": "x", "mg": ()}, {"axis_name": "x", "banded": (0, 0)},
    {"axis_name": "x"}, {"device_arrays": {}},
    {"axis_name": "x", "cg_dot": "compensated"}])
def test_unported_options_raise(kw):
    pix, tod, w, npix, L = _problem(n=1000)
    plan = _port_plan(ref_build_plan(pix, npix, L))
    with pytest.raises(NotImplementedError):
        destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                         n_iter=2, **kw)


def test_bad_precond_raises():
    pix, tod, w, npix, L = _problem(n=1000)
    plan = _port_plan(ref_build_plan(pix, npix, L))
    with pytest.raises(ValueError, match="precond"):
        destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                         n_iter=2, precond="twolevel")
