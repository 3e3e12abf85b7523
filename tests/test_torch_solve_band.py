"""``cli.run_destriper.solve_band`` of the port against the reference's on
the synthetic field run (``comapreduce_tpu_torch/fieldrun.py`` at
``FIELD_SMALL``: 2 observations x 2 feeds, cross-linked, 4 ground
groups), the same numpy data fed to both.

Routes: offset-aligned groups -> the planned ground solve with the
two-level or the multigrid preconditioner; unaligned groups -> the
scatter path under Jacobi; a solve the divergence tripwire stops under
either -> the Jacobi re-solve (keeping the banded prior of an
offsets-only solve); the matched-1/f variant
(``fieldrun.make_field_band_1f``) -> the offsets-only solve with the
banded noise prior; a geometry too small for any multigrid level ->
Jacobi.

Tolerances (null-space-invariant products, see ``fieldrun.invariants``):

- converged planned solves: 5e-4 absolute on the slopes, the
  mean-removed baselines and the mean-removed hit-pixel map — measured
  at most 1.2e-4 between the packages at threshold 1e-6 (the system's
  weak modes amplify the 1e-6 residual);
- converged offsets-only solves: 5e-4 absolute on the mean-removed
  offsets and hit-pixel map, the same bound (measured below 1e-6 on
  the matched-1/f band);
- the scatter route: slopes 2e-3 and maps 5e-3, the reference's own
  planned-vs-scatter contract (``tests/test_pointing_plan.py:239``);
- the forced divergence of the offsets-only solve: 1e-4 on the
  mean-removed offsets and map after the re-solve's few pinned
  iterations (measured below 1e-5). A ground solve is not compared
  after so few iterations: its early iterates lie far along the near-null
  slope <-> sky-gradient mode, where rounding alone moves the slopes by
  0.7 (measured) at equal residuals, so the ground re-solve is held at
  convergence instead.
"""

import logging

import numpy as np
import pytest
import torch

import comapreduce_tpu.cli.run_destriper as ref_rd
import comapreduce_tpu.mapmaking.destriper as ref_destriper
import comapreduce_tpu_torch.cli.run_destriper as port_rd
import comapreduce_tpu_torch.mapmaking.destriper as port_destriper
from comapreduce_tpu.mapmaking.leveldata import DestriperData as RefData
from comapreduce_tpu_torch.fieldrun import (FIELD_SMALL, MG_KW,
                                            OFFSET_LENGTH, SLOPE_ATOL,
                                            SOLVE_KW, field_geometry,
                                            invariants, make_field_band,
                                            make_field_band_1f, slope_errors)
from comapreduce_tpu_torch.convert import destriper_data_from_reference

CONVERGED_ATOL = 5e-4
FORCED_ATOL = 1e-4


def _ref_data(d):
    return RefData(tod=d.tod, pixels=d.pixels, weights=d.weights,
                   ground_ids=d.ground_ids, az=d.az, n_groups=d.n_groups,
                   npix=d.npix, groups=d.groups)


def _ref_invariants(res, data):
    class _T:
        pass
    t = _T()
    for k in ("ground", "offsets", "hit_map", "destriped_map"):
        setattr(t, k, torch.as_tensor(np.array(getattr(res, k))))
    return invariants(t, data, OFFSET_LENGTH)


def _solve_both(data, **kw):
    ref = ref_rd.solve_band(_ref_data(data), kernels="xla", trace_iters=0,
                            **kw)
    got = port_rd.solve_band(destriper_data_from_reference(_ref_data(data)),
                             device="cpu", **kw)
    return got, ref


@pytest.fixture(scope="module")
def geometry():
    return field_geometry(FIELD_SMALL)


def test_field_geometry(geometry):
    pix, gid, az = geometry
    sh = FIELD_SMALL
    assert pix.size == sh.n_groups * sh.stream_samples == 16_000
    assert ((pix >= 0) & (pix < sh.nx * sh.ny)).all()
    assert np.abs(az).max() <= 1.0
    # groups are offset-aligned, one per (observation, feed) stream
    assert np.array_equal(np.unique(gid), np.arange(sh.n_groups))
    # the odd observation crosses the even one: x and y swapped
    n = sh.stream_samples
    p0, p1 = pix[:n], pix[sh.n_feeds * n:(sh.n_feeds + 1) * n]
    np.testing.assert_array_equal(p1, (p0 % sh.nx) * sh.nx + p0 // sh.nx)


@pytest.mark.parametrize("band", [0, 1])
def test_aligned_groups_match_reference(geometry, band):
    data, truth = make_field_band(FIELD_SMALL, geometry, band)
    got, ref = _solve_both(data, **SOLVE_KW)
    assert float(got.residual) < 1e-6 and int(got.diverged) == 0
    assert float(ref.residual) < 1e-6
    a, b = invariants(got, data, 50), _ref_invariants(ref, data)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=CONVERGED_ATOL,
                                   err_msg=k)
    # the slope check chip_smoke.py makes at full width, at this size
    assert np.abs(slope_errors(got, truth, FIELD_SMALL)).max() \
        < SLOPE_ATOL


def test_unaligned_groups_take_the_scatter_route(geometry, caplog):
    """Groups that change inside an offset go to ``destripe`` (Jacobi; the
    coarse request is dropped with a warning) in both packages."""
    data, _ = make_field_band(FIELD_SMALL, geometry, 0)
    data.ground_ids = np.roll(data.ground_ids, 25)
    with caplog.at_level(logging.WARNING):
        got, ref = _solve_both(data, use_ground=True, coarse_block=8,
                               n_iter=100, threshold=1e-6)
    assert any("not offset-aligned" in r.getMessage()
               and r.name == "comapreduce_tpu_torch" for r in caplog.records)
    np.testing.assert_allclose(got.ground.numpy()[:, 1],
                               np.asarray(ref.ground)[:, 1], rtol=0,
                               atol=2e-3)
    hit = got.hit_map.numpy() > 0
    m_g = got.destriped_map.numpy()[hit]
    m_r = np.asarray(ref.destriped_map)[hit]
    np.testing.assert_allclose(m_g - m_g.mean(), m_r - m_r.mean(), rtol=0,
                               atol=5e-3)
    np.testing.assert_array_equal(got.hit_map.numpy(),
                                  np.asarray(ref.hit_map))


def test_divergence_resolves_ground_cold(geometry, caplog):
    """A divergence the two-level preconditioner meets on its own: band 1
    of seed 7 trips the tripwire in both packages, and both re-solve the
    ground solve under Jacobi from a cold start to convergence."""
    data, _ = make_field_band(FIELD_SMALL, geometry, 1, seed=7)
    with caplog.at_level(logging.WARNING):
        got, ref = _solve_both(data, use_ground=True, coarse_block=8,
                               n_iter=100, threshold=1e-6)
    for name in ("comapreduce_tpu", "comapreduce_tpu_torch"):
        assert any("re-solving ground solve" in r.getMessage()
                   and r.name == name for r in caplog.records), name
    assert int(got.diverged) == int(np.asarray(ref.diverged)) == 0
    assert float(got.residual) < 1e-6 and float(ref.residual) < 1e-6
    a, b = invariants(got, data, 50), _ref_invariants(ref, data)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=CONVERGED_ATOL,
                                   err_msg=k)


def test_forced_divergence_resolves_offsets_warm(geometry, monkeypatch,
                                                 caplog):
    """With the tripwire's growth factor at 0, any live iteration counts
    as elevated, so both packages' two-level offsets-only solves trip
    after ``DIVERGENCE_K`` iterations and re-solve under Jacobi from the
    best iterate; the re-solve trips too and returns its best iterate."""
    monkeypatch.setattr(ref_destriper, "DIVERGENCE_GROWTH", 0.0)
    monkeypatch.setattr(port_destriper, "DIVERGENCE_GROWTH", 0.0)
    monkeypatch.setattr(ref_rd, "_PLAN_MEMO", {})   # retrace under the patch
    data, _ = make_field_band(FIELD_SMALL, geometry, 0)
    with caplog.at_level(logging.WARNING):
        got, ref = _solve_both(data, coarse_block=8, n_iter=100,
                               threshold=1e-6)
    for name in ("comapreduce_tpu", "comapreduce_tpu_torch"):
        assert any("best iterate" in r.getMessage() and r.name == name
                   for r in caplog.records), name
    k = port_destriper.DIVERGENCE_K
    assert int(got.n_iter) == int(ref.n_iter) == k
    assert int(got.diverged) == int(np.asarray(ref.diverged)) == 1
    for r_g, r_r, name in ((got.offsets, ref.offsets, "offsets"),
                           (got.destriped_map, ref.destriped_map, "map")):
        a, b = r_g.numpy(), np.asarray(r_r)
        np.testing.assert_allclose(a - a.mean(), b - b.mean(), rtol=0,
                                   atol=FORCED_ATOL, err_msg=name)


def test_offsets_only_warm_start_matches_reference(geometry):
    data, _ = make_field_band(FIELD_SMALL, geometry, 1)
    x0 = np.random.default_rng(1).normal(
        0, 0.1, data.tod.size // 50).astype(np.float32)
    got, ref = _solve_both(data, coarse_block=8, n_iter=8, threshold=0.0,
                           x0=x0)
    np.testing.assert_allclose(got.offsets.numpy(), np.asarray(ref.offsets),
                               rtol=0, atol=FORCED_ATOL)
    np.testing.assert_allclose(got.destriped_map.numpy(),
                               np.asarray(ref.destriped_map), rtol=0,
                               atol=FORCED_ATOL)
    assert got.ground.shape == (0, 2)


def test_plan_is_memoised_across_bands(geometry, caplog):
    """The plan and the coarse pattern are built once per pointing; the
    weights' half of the coarse build once per band."""
    port_rd._PLAN_MEMO.clear()
    with caplog.at_level(logging.INFO, logger="comapreduce_tpu_torch"):
        for band in range(FIELD_SMALL.n_bands):
            data, _ = make_field_band(FIELD_SMALL, geometry, band)
            port_rd.solve_band(data, use_ground=True, coarse_block=8,
                               n_iter=3, device="cpu")
    stages = [getattr(r, "stage", None) for r in caplog.records]
    assert stages.count("plan_build") == 1
    assert stages.count("coarse_pattern") == 1
    assert stages.count("coarse_build") == FIELD_SMALL.n_bands
    plan = port_rd.pointing_plan(geometry[0], data.npix, OFFSET_LENGTH)
    assert plan is port_rd._PLAN_MEMO["plan"][1]


# mg, noise_weight and cg_dot="compensated" are ported (the tests below);
# the sharded solve and the watchdog still raise, whatever else is asked
@pytest.mark.parametrize("kw", [{"sharded": True}, {"watchdog": object()},
                                {"sharded": True, "mg": MG_KW},
                                {"sharded": True,
                                 "noise_weight": {"bandwidth": 4}},
                                {"watchdog": object(),
                                 "cg_dot": "compensated"}])
def test_unported_options_raise(geometry, kw):
    data, _ = make_field_band(FIELD_SMALL, geometry, 0)
    with pytest.raises(NotImplementedError):
        port_rd.solve_band(data, n_iter=2, device="cpu", **kw)


def _mean_removed(res):
    hit = np.asarray(res.hit_map) > 0
    a = np.asarray(res.offsets)
    m = np.asarray(res.destriped_map)[hit]
    return {"offsets": a - a.mean(), "map": m - m.mean()}


def _assert_invariants_match(got, ref, data):
    a, b = invariants(got, data, 50), _ref_invariants(ref, data)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=CONVERGED_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("cg_dot", ["f32", "compensated"])
def test_multigrid_ground_matches_reference(geometry, cg_dot):
    """The ground solve under the multigrid V-cycle (and with compensated
    CG dots) converges with the reference's to the same invariants."""
    data, truth = make_field_band(FIELD_SMALL, geometry, 0)
    got, ref = _solve_both(data, offset_length=OFFSET_LENGTH,
                           use_ground=True, n_iter=100, threshold=1e-6,
                           mg=MG_KW, cg_dot=cg_dot)
    assert float(got.residual) < 1e-6 and int(got.diverged) == 0
    assert float(ref.residual) < 1e-6
    _assert_invariants_match(got, ref, data)
    assert np.abs(slope_errors(got, truth, FIELD_SMALL)).max() < SLOPE_ATOL


@pytest.mark.parametrize("mg", [None, MG_KW], ids=["banded", "banded-mg"])
def test_banded_offsets_only_matches_reference(geometry, caplog, mg):
    """The matched-1/f band through ``noise_weight = banded``: both
    packages name the two planted fallbacks in one warning and converge
    to the same offsets and map."""
    data, _, quality = make_field_band_1f(FIELD_SMALL, geometry, 0)
    with caplog.at_level(logging.WARNING):
        got, ref = _solve_both(data, offset_length=OFFSET_LENGTH,
                               n_iter=100, threshold=1e-6, mg=mg,
                               noise_weight={"bandwidth": 4},
                               quality=quality, band=0)
    want = ("2 group(s) kept white weighting (obs0.h5/feed1:absent, "
            "obs1.h5/feed0:flagged)")
    for name in ("comapreduce_tpu", "comapreduce_tpu_torch"):
        assert any(want in r.getMessage() and r.name == name
                   for r in caplog.records), name
    assert float(got.residual) < 1e-6 and float(ref.residual) < 1e-6
    a, b = _mean_removed(got), _mean_removed(ref)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=CONVERGED_ATOL,
                                   err_msg=k)


def test_ground_solve_keeps_white_weighting(geometry, caplog):
    """``noise_weight`` on a ground solve: a warning, and the white ground
    solve runs (the port's result equals its own white solve)."""
    data, _ = make_field_band(FIELD_SMALL, geometry, 0)
    quality = [{"file": g["file"], "feed": g["feed"], "band": 0,
                "white_sigma": 0.05, "fknee_hz": 1.0, "alpha": -1.5}
               for g in data.groups]
    with caplog.at_level(logging.WARNING):
        got, ref = _solve_both(data, noise_weight={"bandwidth": 4},
                               quality=quality, **SOLVE_KW)
    for name in ("comapreduce_tpu", "comapreduce_tpu_torch"):
        assert any("keeps white weighting" in r.getMessage()
                   and r.name == name for r in caplog.records), name
    white = port_rd.solve_band(data, device="cpu", **SOLVE_KW)
    np.testing.assert_array_equal(got.offsets.numpy(), white.offsets.numpy())
    _assert_invariants_match(got, ref, data)


def test_tiny_geometry_falls_back_to_jacobi(caplog):
    """Mirror of ``tests/test_multigrid.py::test_solve_band_tiny_geometry_
    falls_back_to_jacobi``: two offsets admit no multigrid level, so both
    packages warn and run Jacobi."""
    rng = np.random.default_rng(0)
    L, npix = 50, 16
    from comapreduce_tpu_torch.mapmaking.leveldata import DestriperData
    data = DestriperData(tod=rng.standard_normal(2 * L).astype(np.float32),
                         pixels=(np.arange(2 * L) % npix).astype(np.int32),
                         weights=np.ones(2 * L, np.float32),
                         ground_ids=np.zeros(2 * L, np.int32),
                         az=np.zeros(2 * L, np.float32), n_groups=1,
                         npix=npix)
    with caplog.at_level(logging.WARNING):
        got, ref = _solve_both(data, offset_length=L, n_iter=100,
                               threshold=1e-6, mg=MG_KW)
    for name in ("comapreduce_tpu", "comapreduce_tpu_torch"):
        assert any("multigrid unavailable" in r.getMessage()
                   and r.name == name for r in caplog.records), name
    assert float(got.residual) < 1e-6
    np.testing.assert_allclose(got.destriped_map.numpy(),
                               np.asarray(ref.destriped_map), rtol=0,
                               atol=FORCED_ATOL)


def test_unaligned_groups_drop_multigrid(geometry, caplog):
    """Groups that change inside an offset take the scatter route under
    Jacobi; the multigrid request is dropped with a warning."""
    data, _ = make_field_band(FIELD_SMALL, geometry, 0)
    data.ground_ids = np.roll(data.ground_ids, 25)
    with caplog.at_level(logging.WARNING):
        got, ref = _solve_both(data, use_ground=True, mg=MG_KW, n_iter=100,
                               threshold=1e-6)
    assert any("multigrid active" in r.getMessage()
               and r.name == "comapreduce_tpu_torch" for r in caplog.records)
    np.testing.assert_allclose(got.ground.numpy()[:, 1],
                               np.asarray(ref.ground)[:, 1], rtol=0,
                               atol=2e-3)


def test_forced_divergence_under_multigrid_keeps_banded(geometry,
                                                        monkeypatch, caplog):
    """With the tripwire's growth factor at 0 both packages' multigrid
    solves trip after ``DIVERGENCE_K`` iterations and re-solve under
    Jacobi from the best iterate, the banded prior kept in the system."""
    monkeypatch.setattr(ref_destriper, "DIVERGENCE_GROWTH", 0.0)
    monkeypatch.setattr(port_destriper, "DIVERGENCE_GROWTH", 0.0)
    monkeypatch.setattr(ref_rd, "_PLAN_MEMO", {})   # retrace under the patch
    data, _, quality = make_field_band_1f(FIELD_SMALL, geometry, 1)
    with caplog.at_level(logging.WARNING):
        got, ref = _solve_both(data, n_iter=100, threshold=1e-6, mg=MG_KW,
                               noise_weight={"bandwidth": 4},
                               quality=quality, band=1)
    for name in ("comapreduce_tpu", "comapreduce_tpu_torch"):
        assert any("multigrid preconditioner" in r.getMessage()
                   and "best iterate" in r.getMessage() and r.name == name
                   for r in caplog.records), name
    k = port_destriper.DIVERGENCE_K
    assert int(got.n_iter) == int(ref.n_iter) == k
    assert int(got.diverged) == int(np.asarray(ref.diverged)) == 1
    a, b = _mean_removed(got), _mean_removed(ref)
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=0,
                                   atol=FORCED_ATOL, err_msg=name)


def test_multigrid_patterns_memoised_across_bands(geometry, caplog):
    """The multigrid patterns are built once per pointing, the hierarchy
    once per band."""
    port_rd._PLAN_MEMO.clear()
    with caplog.at_level(logging.INFO, logger="comapreduce_tpu_torch"):
        for band in range(FIELD_SMALL.n_bands):
            data, _ = make_field_band(FIELD_SMALL, geometry, band)
            port_rd.solve_band(data, use_ground=True, mg=MG_KW, n_iter=3,
                               device="cpu")
    stages = [getattr(r, "stage", None) for r in caplog.records]
    assert stages.count("plan_build") == 1
    assert stages.count("mg_patterns") == 1
    assert stages.count("mg_build") == FIELD_SMALL.n_bands


@pytest.mark.parametrize("kw,match", [
    ({"coarse_block": 8, "mg": MG_KW}, "not both"),
    ({"precond": "none", "mg": MG_KW}, "jacobi"),
    ({"cg_dot": "f16"}, "cg_dot")])
def test_solver_option_errors(geometry, kw, match):
    data, _ = make_field_band(FIELD_SMALL, geometry, 0)
    with pytest.raises(ValueError, match=match):
        port_rd.solve_band(data, n_iter=2, device="cpu", **kw)


def test_destriper_data_copies_groups(geometry):
    data, _ = make_field_band(FIELD_SMALL, geometry, 0)
    got = destriper_data_from_reference(_ref_data(data))
    assert got.groups == data.groups and got.groups is not data.groups
    assert got.groups[1] == {"file": "obs0.h5", "feed": 1,
                             "sample_rate": 50.0,
                             "n_samples": FIELD_SMALL.stream_samples}
