"""The multigrid V-cycle of the port (host build in ``comapreduce_tpu_torch/
mapmaking/destriper.py`` and ``destripe_planned(mg=...)``) against the
reference's (``comapreduce_tpu/mapmaking/destriper.py:792-988`` and
``:1342-1395``).

Problems: the CES raster with 1/f offsets and spread weights of
``tests/test_torch_coarse.py``, roughened with sentinel pixels and zero
weights where the build is compared.

Tolerances: the host build is the same float64 numpy/scipy algebra in
the same order, so the ladder, the patterns, every level's arrays and the
stacked hierarchy are held bitwise. One V-cycle application
(``n_iter=1``, the reference's hierarchy fed to the port so that a build
difference cannot hide in it) is held to 1e-5 of the offsets' scale (f32
summation order: the fine matvec's pair sums and the level sums add in
another order, measured 1.0e-6 of scale). Converged solves: the
reference's iteration count within 5 and the float64 normal equations to
5e-5 — the contract ``tests/test_torch_coarse.py`` holds the two-level
solve to (two converged runs may differ along the solver's weakest
modes, so offsets are not compared point by point).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import comapreduce_tpu.mapmaking.destriper as ref
from comapreduce_tpu.mapmaking.pointing_plan import \
    build_pointing_plan as ref_build_plan
from comapreduce_tpu_torch.convert import (multigrid_from_reference,
                                           plan_arrays, plan_from_reference)
from comapreduce_tpu_torch.flagship import ces_pixels
from comapreduce_tpu_torch.mapmaking.destriper import (
    MultigridUnavailable, _vcycle_precond, build_coarse_preconditioner,
    build_multigrid_hierarchy, destripe_planned, ground_ids_per_offset,
    multigrid_levels, multigrid_patterns, stack_multigrid)
from tests.test_torch_coarse import _normal_residual

VCYCLE_RTOL = 1e-5


def _problem(seed=0, F=2, T=6_000, nx=32, L=50):
    """Raster pointing + 1/f offsets + white noise + a sky, weights spread
    over a decade."""
    rng = np.random.default_rng(seed)
    pix = np.concatenate([ces_pixels(T, nx, nx, f, F) for f in range(F)])
    n = (pix.size // L) * L
    pix = pix[:n]
    off = np.cumsum(rng.normal(0, 0.3, n // L)).astype(np.float32)
    sky = rng.normal(0, 1.0, nx * nx).astype(np.float32)
    tod = (sky[pix] + np.repeat(off, L)
           + rng.normal(0, 1.0, n)).astype(np.float32)
    w = (10.0 ** rng.uniform(-0.5, 0.5, n)).astype(np.float32)
    return pix, tod, w, nx * nx, L


def _rough(pix, w, npix, seed=9):
    rng = np.random.default_rng(seed)
    pix = pix.copy()
    pix[rng.random(pix.size) < 0.01] = npix
    pix[rng.random(pix.size) < 0.01] = -1
    w = w.copy()
    w[rng.random(w.size) < 0.05] = 0.0
    return pix, w


def _plans(pix, npix, L):
    r = ref_build_plan(pix, npix, L)
    arrays, static = plan_arrays(r)
    return r, plan_from_reference(arrays, **static)


def _assert_hierarchy_equal(got, want):
    assert len(got) == len(want)
    for lv_g, lv_w in zip(got, want):
        assert lv_g.keys() == lv_w.keys()
        for k in lv_g:
            a, b = np.asarray(lv_g[k]), np.asarray(lv_w[k])
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("args", [
    (1_000_000, 8, 3, 4096), (240, 8, 2, 4096), (240, 4, 3, 4096),
    (5, 8, 2, 4096), (2, 8, 2, 4096), (10_000_000, 8, 2, 4096),
    (206_264, 8, 2, 4096), (1, 2, 1, 4096), (100, 1, 4, 3)])
def test_multigrid_levels_ladder(args):
    n_off, block, levels, max_coarse = args
    got = multigrid_levels(n_off, block=block, levels=levels,
                           max_coarse=max_coarse)
    assert got == ref.multigrid_levels(n_off, block=block, levels=levels,
                                       max_coarse=max_coarse)
    if args == (206_264, 8, 2, 4096):
        # the full field run's ladder: blocks 8 and 64, 25 783 unknowns on
        # level 1 and a 3 223-unknown coarsest level
        assert got == [8, 64]
        assert [-(-n_off // b) for b in got] == [25_783, 3_223]


@pytest.mark.parametrize("block,levels", [(8, 2), (4, 3), (2, 1)],
                         ids=["b8l2", "b4l3", "b2l1"])
def test_hierarchy_bitwise_to_reference(block, levels):
    pix, _, w, npix, L = _problem(seed=6)
    pix, w = _rough(pix, w, npix)
    pats = multigrid_patterns(pix, npix, L, block=block, levels=levels)
    ref_pats = ref.multigrid_patterns(pix, npix, L, block=block,
                                      levels=levels)
    assert pats["blocks"] == ref_pats["blocks"]
    for p, q in zip(pats["patterns"], ref_pats["patterns"]):
        assert p.keys() == q.keys()
        for k in p:
            np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(q[k]),
                                          err_msg=k)
    got = build_multigrid_hierarchy(pix, w, npix, L, block=block,
                                    levels=levels)
    _assert_hierarchy_equal(got, ref.build_multigrid_hierarchy(
        pix, w, npix, L, block=block, levels=levels))
    # with the shared patterns, as the band solve builds it
    _assert_hierarchy_equal(build_multigrid_hierarchy(
        pix, w, npix, L, patterns=pats), got)


def test_one_level_ladder_and_stack_bitwise():
    """A geometry whose ladder collapses to the halving two-grid block,
    and the multi-RHS stack of two bands' hierarchies."""
    pix, _, w, npix, L = _problem(seed=3, F=1, T=5 * 50, nx=8)
    assert multigrid_levels(pix.size // L) == [3]
    _assert_hierarchy_equal(
        build_multigrid_hierarchy(pix, w, npix, L),
        ref.build_multigrid_hierarchy(pix, w, npix, L))
    pix, _, w, npix, L = _problem(seed=5)
    w2 = (w * np.random.default_rng(1).uniform(0.5, 2, w.size)).astype(
        np.float32)
    pats = multigrid_patterns(pix, npix, L)
    got = stack_multigrid([build_multigrid_hierarchy(
        pix, ww, npix, L, patterns=pats) for ww in (w, w2)])
    want = ref.stack_multigrid([ref.build_multigrid_hierarchy(
        pix, ww, npix, L) for ww in (w, w2)])
    _assert_hierarchy_equal(got, want)
    _assert_hierarchy_equal(multigrid_from_reference(want), got)
    assert got[0]["vals"].shape[0] == 2 and got[-1]["ac_inv"].ndim == 3


def test_multigrid_unavailable():
    """No level with 2 unknowns: a refusal of its own type, a
    ``ValueError`` as in the reference."""
    pix, _, w, npix, L = _problem(F=1, T=2 * 50, nx=8)
    assert multigrid_levels(pix.size // L) == []
    for fn in (lambda: multigrid_patterns(pix, npix, L),
               lambda: build_multigrid_hierarchy(pix, w, npix, L)):
        with pytest.raises(MultigridUnavailable, match="too small"):
            fn()
    assert issubclass(MultigridUnavailable, ValueError)
    with pytest.raises(ValueError, match="too small"):
        ref.build_multigrid_hierarchy(pix, w, npix, L)


@pytest.mark.parametrize("case", ["single", "multi", "ground", "smooth2"])
def test_one_vcycle_application_matches_reference(case):
    """``n_iter=1``: the first iterate is alpha times the V-cycle applied
    to the right-hand side, with the reference's hierarchy (``smooth2``:
    two smoothing steps a level)."""
    pix, tod, w, npix, L = _problem(seed=2)
    ref_plan, plan = _plans(pix, npix, L)
    kw, ref_kw = {}, {}
    if case == "smooth2":
        kw["mg_smooth"] = ref_kw["mg_smooth"] = 2
    if case == "multi":
        w2 = (w * np.random.default_rng(3).uniform(0.5, 2.0, w.size)
              ).astype(np.float32)
        pats = ref.multigrid_patterns(pix, npix, L)
        mg = ref.stack_multigrid([ref.build_multigrid_hierarchy(
            pix, ww, npix, L, patterns=pats) for ww in (w, w2)])
        tod, w = np.stack([tod, tod[::-1].copy()]), np.stack([w, w2])
    else:
        mg = ref.build_multigrid_hierarchy(pix, w, npix, L)
    if case == "ground":
        n = tod.size
        gids = (np.arange(n) * 3 // n).astype(np.int32)
        az = np.tile(np.linspace(-1, 1, 200), n // 200).astype(np.float32)
        g_off = ground_ids_per_offset(gids, L)
        kw = dict(ground_off=g_off, az=torch.as_tensor(az), n_groups=3)
        ref_kw = dict(ground_off=g_off, az=jnp.asarray(az), n_groups=3)
    got = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                           n_iter=1, threshold=0.0,
                           mg=multigrid_from_reference(mg), **kw)
    want = ref.destripe_planned(jnp.asarray(tod), jnp.asarray(w),
                                plan=ref_plan, n_iter=1, threshold=0.0,
                                mg=mg, kernels="xla", **ref_kw)
    b = np.asarray(want.offsets)
    scale = float(np.abs(b).max())
    assert scale > 0
    np.testing.assert_allclose(got.offsets.numpy(), b, rtol=0,
                               atol=VCYCLE_RTOL * scale)
    if case == "ground":
        g = np.asarray(want.ground)
        np.testing.assert_allclose(got.ground.numpy(), g, rtol=0,
                                   atol=VCYCLE_RTOL * float(np.abs(g).max()))


def test_vcycle_operator_is_symmetric_positive_definite():
    """CG's admissibility condition, for the port's own V-cycle: applied
    in float64 to an independent float64 statement of the fine operator,
    ``<u, M v> == <v, M u>`` and ``<u, M u> > 0`` on random vectors, at
    one and two smoothing steps."""
    pix, _, w, npix, L = _problem(seed=4, F=1, T=4_000, nx=24)
    n_off = pix.size // L
    mg = build_multigrid_hierarchy(pix, w, npix, L, block=4, levels=2)
    off_id = np.arange(pix.size) // L
    wd = w.astype(np.float64)
    sw = np.bincount(pix, weights=wd, minlength=npix)
    inv_sw = np.where(sw > 0, 1.0 / np.maximum(sw, 1e-30), 0.0)

    def a_mat(v):
        d = v.numpy()[off_id]
        m = np.bincount(pix, weights=wd * d, minlength=npix) * inv_sw
        return torch.as_tensor(np.bincount(off_id, weights=wd * (d - m[pix]),
                                           minlength=n_off))

    d_fwf = np.bincount(off_id, weights=wd, minlength=n_off)
    corr = np.bincount(off_id, weights=wd * wd * inv_sw[pix],
                       minlength=n_off)
    inv_diag = torch.as_tensor(1.0 / np.maximum(d_fwf - corr, 1e-12))
    rng = np.random.default_rng(1)
    us = torch.as_tensor(rng.standard_normal((3, n_off)))
    vs = torch.as_tensor(rng.standard_normal((3, n_off)))
    for nu in (1, 2):
        m_inv = _vcycle_precond(mg, a_mat, inv_diag, nu, 2.0 / 3.0,
                                torch.float64, torch.device("cpu"))
        for u, v in zip(us, vs):
            mu, mv = m_inv(u), m_inv(v)
            lhs, rhs = float(u @ mv), float(v @ mu)
            assert abs(lhs - rhs) < 1e-9 * max(abs(lhs), abs(rhs), 1.0)
            assert float(u @ mu) > 0 and float(v @ mv) > 0


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_converged_multigrid_matches_reference(multi):
    """Converged V-cycle solves: 1e-6 within 5 iterations of the
    reference, fewer iterations than the port's Jacobi solve, and the
    float64 normal equations solved to 5e-5, per band."""
    pix, tod, w, npix, L = _problem()
    ref_plan, plan = _plans(pix, npix, L)
    pats = multigrid_patterns(pix, npix, L)
    if multi:
        w2 = (w * np.random.default_rng(7).uniform(0.5, 2.0, w.size)
              ).astype(np.float32)
        mg = stack_multigrid([build_multigrid_hierarchy(
            pix, ww, npix, L, patterns=pats) for ww in (w, w2)])
        tod, w = np.stack([tod, tod[::-1].copy()]), np.stack([w, w2])
    else:
        mg = build_multigrid_hierarchy(pix, w, npix, L, patterns=pats)
    t, ww = torch.as_tensor(tod), torch.as_tensor(w)
    got = destripe_planned(t, ww, plan, n_iter=500, threshold=1e-6, mg=mg)
    jac = destripe_planned(t, ww, plan, n_iter=500, threshold=1e-6)
    want = ref.destripe_planned(jnp.asarray(tod), jnp.asarray(w),
                                plan=ref_plan, n_iter=500, threshold=1e-6,
                                mg=mg, kernels="xla")
    assert (got.residual.numpy() < 1e-6).all()
    assert not got.diverged.numpy().any()
    assert abs(int(got.n_iter) - int(want.n_iter)) <= 5
    assert int(got.n_iter) < int(jac.n_iter)
    offs = got.offsets.numpy().reshape(-1, pix.size // L)
    tods, ws = tod.reshape(-1, pix.size), w.reshape(-1, pix.size)
    for i in range(offs.shape[0]):
        assert _normal_residual(pix, tods[i], ws[i], npix, L, offs[i]) < 5e-5


@pytest.mark.parametrize("case", ["precond-none", "with-coarse",
                                  "omega-high", "omega-zero"])
def test_invalid_combinations_raise(case):
    """The reference's ``ValueError`` contracts (``_check_precond`` and
    the ``mg_omega`` range)."""
    pix, tod, w, npix, L = _problem()
    _, plan = _plans(pix, npix, L)
    mg = build_multigrid_hierarchy(pix, w, npix, L)
    kw = {"mg": mg}
    match = "mg_omega"
    if case == "precond-none":
        kw["precond"], match = "none", "jacobi"
    elif case == "with-coarse":
        kw["coarse"], match = build_coarse_preconditioner(
            pix, w, npix, L, block=8), "not both"
    else:
        kw["mg_omega"] = 1.5 if case == "omega-high" else 0.0
    with pytest.raises(ValueError, match=match):
        destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                         n_iter=2, **kw)
