"""The float-float arithmetic of the port (``comapreduce_tpu_torch/ops/
precision.py``) against the reference's (``comapreduce_tpu/ops/
precision.py``), and ``cg_dot="compensated"`` in the port's solvers
against the reference's.

Tolerances: the error-free transformations are the same f32 operations in
the same order in both packages, so ``two_sum``/``two_prod`` and the
float-float sums are held bitwise (CPU f32 arithmetic is IEEE in both;
where XLA might contract an op, one ulp of the result is allowed). The
compensated solves at pinned iterations are held to the planned solver's
5e-4 absolute (``tests/test_torch_destriper.py``), 1e-5 for the ground
solve's two iterations (``tests/test_torch_coarse.py``), and converged
solves to the iteration count within 5 and the float64 normal equations
to 5e-5, as ``tests/test_torch_coarse.py`` holds the two-level solve.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import comapreduce_tpu.ops.precision as ref
from comapreduce_tpu.mapmaking.destriper import destripe as ref_destripe
from comapreduce_tpu.mapmaking.destriper import \
    destripe_planned as ref_planned
from comapreduce_tpu.mapmaking.pointing_plan import \
    build_pointing_plan as ref_build_plan
from comapreduce_tpu_torch.convert import plan_arrays, plan_from_reference
from comapreduce_tpu_torch.flagship import ces_pixels
from comapreduce_tpu_torch.mapmaking.destriper import (destripe,
                                                       destripe_planned,
                                                       ground_ids_per_offset)
from comapreduce_tpu_torch.ops.precision import (precise_dot, precise_norm,
                                                 precise_sum, two_prod,
                                                 two_sum)
from tests.test_torch_coarse import _normal_residual

PLANNED_ATOL = 5e-4
F32_ULP = 2.0 ** -23


def _ulps(a, b):
    a = np.float32(a)
    b = np.float32(b)
    return abs(float(a) - float(b)) / max(np.spacing(np.float32(max(
        abs(a), abs(b)))), np.finfo(np.float32).tiny)


def _vectors(n, seed, scale_spread=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    if scale_spread:
        x *= (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("fn_name", ["two_sum", "two_prod"])
def test_error_free_transforms_bitwise(fn_name):
    x, y = _vectors(4096, 1)
    x[:4] = [1e30, -1e-30, 3.0, 0.0]
    y[:4] = [-1e30, 1e-30, 1e-8, -0.0]
    got = {"two_sum": two_sum, "two_prod": two_prod}[fn_name](
        torch.as_tensor(x), torch.as_tensor(y))
    want = getattr(ref, fn_name)(jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4097])
def test_precise_dot_and_sum_match_reference(n):
    x, y = _vectors(n, n)
    for got, want in (
            (precise_dot(torch.as_tensor(x), torch.as_tensor(y)),
             ref.precise_dot(jnp.asarray(x), jnp.asarray(y))),
            (precise_sum(torch.as_tensor(x)), ref.precise_sum(jnp.asarray(x))),
            (precise_norm(torch.as_tensor(y)),
             ref.precise_norm(jnp.asarray(y)))):
        assert _ulps(float(got), float(want)) <= 1.0, (float(got),
                                                       float(want))


def test_precise_dot_last_axis_matches_reference():
    """The multi-RHS form: one dot per leading index."""
    x, y = _vectors(3 * 777, 5)
    x, y = x.reshape(3, 777), y.reshape(3, 777)
    got = precise_dot(torch.as_tensor(x), torch.as_tensor(y), axis=-1)
    want = np.asarray(ref.precise_dot(jnp.asarray(x), jnp.asarray(y),
                                      axis=-1))
    assert got.shape == (3,)
    for g, w in zip(got.numpy(), want):
        assert _ulps(g, w) <= 1.0
    with pytest.raises(ValueError, match="axis"):
        precise_dot(torch.as_tensor(x), torch.as_tensor(y), axis=0)
    with pytest.raises(ValueError, match="axis"):
        precise_sum(torch.as_tensor(x), axis=0)


def test_precise_dot_beats_f32_on_cancellation():
    """Large terms that cancel to a small exact sum: the f32 sum loses it,
    the float-float sum keeps it to a few ulps of the float64 value."""
    rng = np.random.default_rng(3)
    big = (rng.standard_normal(20_000) * 1e4).astype(np.float32)
    small = rng.standard_normal(20_000).astype(np.float32)
    x = np.concatenate([big, -big, small])
    y = np.ones_like(x)
    perm = rng.permutation(x.size)
    x, y = x[perm], y[perm]
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    f32_err = abs(float(torch.dot(torch.as_tensor(x), torch.as_tensor(y)))
                  - exact)
    cmp_err = abs(float(precise_dot(torch.as_tensor(x), torch.as_tensor(y)))
                  - exact)
    cmp_sum_err = abs(float(precise_sum(torch.as_tensor(x))) - exact)
    assert cmp_err <= 2 * F32_ULP * abs(exact)
    assert cmp_sum_err <= 2 * F32_ULP * abs(exact)
    assert cmp_err < f32_err


def _problem(seed=0, F=2, T=6_000, nx=32, L=50):
    rng = np.random.default_rng(seed)
    pix = np.concatenate([ces_pixels(T, nx, nx, f, F) for f in range(F)])
    n = (pix.size // L) * L
    pix = pix[:n]
    off = np.cumsum(rng.normal(0, 0.3, n // L)).astype(np.float32)
    sky = rng.normal(0, 1.0, nx * nx).astype(np.float32)
    tod = (sky[pix] + np.repeat(off, L)
           + rng.normal(0, 1.0, n)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return pix, tod, w, nx * nx, L


def _plans(pix, npix, L):
    r = ref_build_plan(pix, npix, L)
    arrays, static = plan_arrays(r)
    return r, plan_from_reference(arrays, **static)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_compensated_planned_matches_reference_pinned(multi):
    pix, tod, w, npix, L = _problem()
    ref_plan, plan = _plans(pix, npix, L)
    if multi:
        tod = np.stack([tod, tod[::-1].copy()])
        w = np.stack([w, w[::-1].copy()])
    r = ref_planned(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                    n_iter=10, threshold=0.0, cg_dot="compensated",
                    kernels="xla")
    g = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                         n_iter=10, threshold=0.0, cg_dot="compensated")
    for name in ("offsets", "destriped_map"):
        np.testing.assert_allclose(getattr(g, name).numpy(),
                                   np.asarray(getattr(r, name)), rtol=0,
                                   atol=PLANNED_ATOL, err_msg=name)
    np.testing.assert_allclose(g.residual.numpy(), np.asarray(r.residual),
                               rtol=1e-3)


def test_compensated_ground_and_scatter_match_reference():
    """The ground solve's two-block dot (two iterations) and the scatter
    path's ``_dot_compensated`` (ten iterations)."""
    pix, tod, w, npix, L = _problem(seed=4)
    n = tod.size
    gids = (np.arange(n) >= n // 2).astype(np.int32)
    az = np.tile(np.linspace(-1, 1, 200), n // 200).astype(np.float32)
    ref_plan, plan = _plans(pix, npix, L)
    g_off = ground_ids_per_offset(gids, L)
    got = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                           n_iter=2, threshold=0.0, ground_off=g_off,
                           az=torch.as_tensor(az), n_groups=2,
                           cg_dot="compensated")
    want = ref_planned(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                       n_iter=2, threshold=0.0, ground_off=g_off,
                       az=jnp.asarray(az), n_groups=2, cg_dot="compensated",
                       kernels="xla")
    for name in ("offsets", "ground", "destriped_map"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    got = destripe(torch.as_tensor(tod), torch.as_tensor(pix),
                   torch.as_tensor(w), npix, offset_length=L, n_iter=10,
                   threshold=0.0, ground_ids=torch.as_tensor(gids),
                   az=torch.as_tensor(az), n_groups=2, cg_dot="compensated")
    want = ref_destripe(jnp.asarray(tod), jnp.asarray(pix), jnp.asarray(w),
                        npix, offset_length=L, n_iter=10, threshold=0.0,
                        ground_ids=jnp.asarray(gids), az=jnp.asarray(az),
                        n_groups=2, cg_dot="compensated")
    for name in ("offsets", "destriped_map"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=PLANNED_ATOL, err_msg=name)


def test_compensated_converged_matches_reference():
    pix, tod, w, npix, L = _problem(seed=2)
    ref_plan, plan = _plans(pix, npix, L)
    g = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                         n_iter=400, threshold=1e-6, cg_dot="compensated")
    r = ref_planned(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                    n_iter=400, threshold=1e-6, cg_dot="compensated",
                    kernels="xla")
    assert float(g.residual) < 1e-6 and float(r.residual) < 1e-6
    assert abs(int(g.n_iter) - int(r.n_iter)) <= 5
    assert _normal_residual(pix, tod, w, npix, L, g.offsets.numpy()) < 5e-5


def test_bad_cg_dot_raises():
    pix, tod, w, npix, L = _problem(T=1000)
    _, plan = _plans(pix, npix, L)
    with pytest.raises(ValueError, match="cg_dot"):
        destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                         n_iter=2, cg_dot="f64")
