"""The port's polarized destriper (``comapreduce_tpu_torch/mapmaking/
polarization.py``) against the reference's (``comapreduce_tpu/
mapmaking/polarization.py``) on the CPU, on the reference test's
simulated ring scans (``tests/test_polarization.py``):

- the per-pixel IQU solve on a noiseless scan, both packages recovering
  the injected maps;
- the scatter oracle and the planned solve against the reference's own
  of each: offsets and destriped maps within 2e-3 and naive maps within
  1e-3 (the reference test's planned-against-scatter tolerances; the
  packages agree to 3e-6 on these problems), hit maps exactly, the
  solvable masks exactly;
- the solvable-mask rule ``(hits >= 3) & (det_n > 1e-6)`` on pixels of
  graded angle diversity: the masks agree exactly but for pixels whose
  reference ``det_n`` lies within 25% of 1e-6 — the two packages' f32
  LU determinants of the same matrices differ by up to 1.6e-7 there
  (``tests/torch_pol_spread.py``), 16% of the threshold; the test counts
  them;
- rank-deficient pixels masked to zero maps in both paths;
- the hard problem (``tests/test_polarization.py:140``) on its TOD and
  six 1e-6 perturbations: the floored Jacobi survives 300 iterations on
  CES pointing and lands below the reference test's 5e-3; plain CG
  breaks down with f32 3 x 3 inverses and survives with the port's
  f64 ones; the per-pixel map solve against a float64 oracle;
- a 2-D ``tod`` raises, the entry points need a card unless given
  ``device="cpu"``, and a solve of ``k`` iterations calls K3
  ``7 + 2 k`` times (counted on the CPU route).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comapreduce_tpu.data.synthetic import one_over_f_noise
from comapreduce_tpu.mapmaking import polarization as ref_pol
from comapreduce_tpu.mapmaking.pointing_plan import \
    build_pointing_plan as ref_plan
from comapreduce_tpu_torch.mapmaking import polarization as pol
from comapreduce_tpu_torch.mapmaking.pointing_plan import build_pointing_plan

OFF_ATOL = MAP_ATOL = 2e-3
NAIVE_ATOL = 1e-3
DET_MARGIN = 0.25


def _simulate(npix=64, revisits=40, sigma=0.1, fknee=0.5, seed=0):
    """The reference test's tiny ring scanned many times with rotating
    psi (``tests/test_polarization.py:16``), as numpy."""
    rng = np.random.default_rng(seed)
    n = (npix * revisits // 50) * 50
    pixels = np.arange(n) % npix
    psi = np.linspace(0, np.pi, n) + 0.3 * np.sin(np.arange(n) / 77.0)
    I = 1.0 + rng.normal(size=npix) * 0.3
    Q = 0.3 * rng.normal(size=npix)
    U = 0.3 * rng.normal(size=npix)
    d = (I[pixels] + Q[pixels] * np.cos(2 * psi)
         + U[pixels] * np.sin(2 * psi))
    noise = one_over_f_noise(rng, n, sigma, fknee, 1.5, fs=50.0)
    weights = np.full(n, 1.0 / sigma**2, np.float32)
    return ((d + noise).astype(np.float32), pixels.astype(np.int32),
            weights, psi.astype(np.float32), npix, I, Q, U)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_results_match(got, want):
    np.testing.assert_array_equal(_np(got.hit_map), _np(want.hit_map))
    np.testing.assert_array_equal(_np(got.solvable), _np(want.solvable))
    np.testing.assert_allclose(_np(got.offsets), _np(want.offsets),
                               rtol=0, atol=OFF_ATOL)
    np.testing.assert_allclose(_np(got.iqu_destriped),
                               _np(want.iqu_destriped), rtol=0,
                               atol=MAP_ATOL)
    np.testing.assert_allclose(_np(got.iqu_naive), _np(want.iqu_naive),
                               rtol=0, atol=NAIVE_ATOL)


def test_pol_map_solve_noiseless_like_the_reference():
    d, pixels, weights, psi, npix, I, Q, U = _simulate(sigma=1e-9, seed=1)
    c2, s2 = np.cos(2 * psi), np.sin(2 * psi)
    t = [torch.as_tensor(a) for a in (pixels, weights, c2, s2, d)]
    state = pol._pol_accumulate(t[0], t[1], t[2], t[3], npix)
    assert bool(state.rcond_ok.all())
    m = pol.pol_map_solve(t[4], t[0], t[1], t[2], t[3], npix, state).numpy()
    for k, truth in enumerate((I, Q, U)):
        np.testing.assert_allclose(m[:, k], truth, atol=1e-4)
    ref_state = ref_pol._pol_accumulate(jnp.asarray(pixels),
                                        jnp.asarray(weights),
                                        jnp.asarray(c2), jnp.asarray(s2),
                                        npix, None)
    want = np.asarray(ref_pol.pol_map_solve(
        jnp.asarray(d), jnp.asarray(pixels), jnp.asarray(weights),
        jnp.asarray(c2), jnp.asarray(s2), npix, ref_state))
    np.testing.assert_allclose(m, want, rtol=0, atol=NAIVE_ATOL)
    np.testing.assert_array_equal(state.ata.numpy(),
                                  np.asarray(ref_state.ata))


@pytest.mark.parametrize("path", ["scatter", "planned"])
def test_destripe_pol_matches_the_reference(path):
    """Each path against the reference's own, and the reference test's
    recovery bounds on the port's result."""
    d, pixels, weights, psi, npix, I, Q, U = _simulate(
        sigma=0.05, fknee=1.0, seed=2 if path == "scatter" else 5)
    if path == "scatter":
        got = pol.destripe_pol(d, pixels, weights, psi, npix,
                               offset_length=50, n_iter=80, device="cpu")
        want = ref_pol.destripe_pol_jit(
            jnp.asarray(d), jnp.asarray(pixels), jnp.asarray(weights),
            jnp.asarray(psi), npix, offset_length=50, n_iter=80)
    else:
        got = pol.destripe_pol_planned(
            d, weights, psi, build_pointing_plan(pixels, npix, 50),
            n_iter=80, device="cpu")
        want = ref_pol.destripe_pol_planned(
            jnp.asarray(d), jnp.asarray(weights), jnp.asarray(psi),
            ref_plan(pixels, npix, 50), n_iter=80)
    _assert_results_match(got, want)
    m = got.iqu_destriped.numpy()
    assert got.solvable.all()
    for k, truth in enumerate((I, Q, U)):
        assert np.median(np.abs(m[:, k] - truth)) < 0.05
    err_d = np.median(np.abs(m[:, 0] - I))
    err_n = np.median(np.abs(got.iqu_naive.numpy()[:, 0] - I))
    assert err_d <= err_n * 1.05
    assert int(got.n_iter) > 0 and float(got.residual) < 1e-2


def _graded_diversity(seed=3, npix=400, per=24):
    """Pixels of 24 samples each whose angles spread over a range
    growing log-uniformly from 3e-4 to 0.3 rad, so the normalised
    determinant crosses 1e-6; shuffled into time order."""
    rng = np.random.default_rng(seed)
    pix = np.repeat(np.arange(npix), per)
    spread = np.repeat(np.logspace(-3.5, -0.5, npix), per)
    psi = (rng.uniform(0, np.pi, npix)[pix]
           + spread * rng.uniform(-1, 1, pix.size)).astype(np.float32)
    w = (rng.uniform(0.5, 2.0, pix.size) * 1e4).astype(np.float32)
    perm = rng.permutation(pix.size)
    return pix[perm].astype(np.int32), psi[perm], w[perm], npix


def test_solvable_mask_rule_like_the_reference():
    """The masks agree exactly outside the stated margin of 1e-6; the
    pixels inside it are counted (7 of 400 here) and left out."""
    pix, psi, w, npix = _graded_diversity()
    c2, s2 = np.cos(2 * psi), np.sin(2 * psi)
    want = ref_pol._pol_accumulate(jnp.asarray(pix), jnp.asarray(w),
                                   jnp.asarray(c2), jnp.asarray(s2), npix,
                                   None)
    got = pol._pol_accumulate(*(torch.as_tensor(a)
                                for a in (pix, w, c2, s2)), npix)
    ata = np.asarray(want.ata)
    scale = np.maximum(np.trace(ata, axis1=-2, axis2=-1) / 3.0, 1e-30)
    det_n = np.asarray(jnp.linalg.det(jnp.asarray(ata / scale[:, None,
                                                               None])))
    near = np.abs(det_n - 1e-6) <= DET_MARGIN * 1e-6
    n_near = int(near.sum())
    assert 0 < n_near <= 10, n_near
    ok_want, ok_got = np.asarray(want.rcond_ok), got.rcond_ok.numpy()
    np.testing.assert_array_equal(ok_got[~near], ok_want[~near])
    # both sides of the threshold are populated
    assert 20 < int(ok_want.sum()) < npix - 20
    np.testing.assert_array_equal(got.hits.numpy(), np.asarray(want.hits))


@pytest.mark.parametrize("path", ["scatter", "planned"])
def test_rank_deficient_pixels_masked(path):
    """A single angle everywhere: nothing solvable, maps exactly 0."""
    n, npix = 500, 10
    pixels = (np.arange(n) % npix).astype(np.int32)
    psi = np.zeros(n, np.float32)
    d = np.random.default_rng(3).normal(size=n).astype(np.float32)
    w = np.ones(n, np.float32)
    if path == "scatter":
        res = pol.destripe_pol(d, pixels, w, psi, npix, offset_length=50,
                               n_iter=10, device="cpu")
    else:
        res = pol.destripe_pol_planned(
            d, w, psi, build_pointing_plan(pixels, npix, 50), n_iter=40,
            device="cpu")
    assert not bool(res.solvable.any())
    assert torch.all(res.iqu_destriped == 0.0)


#: the hard problem's TOD (``None``) and the seeds of its six 1e-6
#: perturbations (``tests/torch_pol_spread.py``)
HARD_SEEDS = [None, 100, 101, 102, 103, 104, 105]


def hard_problem(seed=None):
    """The reference test's hard problem (``tests/test_polarization.py:
    140``): CES pointing of two feeds over 64 x 64 pixels, 1/f offsets,
    unit weights; ``seed`` adds normal noise of 1e-6 to its TOD.
    ``(tod, weights, psi, pixels, npix, offset_length)``, numpy."""
    from bench import ces_pixels

    F, T, nx, L = 2, 10_000, 64, 50
    rng = np.random.default_rng(0)
    pix = np.concatenate([ces_pixels(T, nx, nx, f, F) for f in range(F)])
    n = (pix.size // L) * L
    pix = pix[:n]
    toff = np.cumsum(rng.normal(0, 0.3, n // L)).astype(np.float32)
    I = rng.normal(0, 1.0, nx * nx)
    psi = (np.linspace(0, 40 * np.pi, n)
           + rng.normal(0, 0.2, n)).astype(np.float32)
    tod = (I[pix] + np.repeat(toff, L)
           + rng.normal(0, 1.0, n)).astype(np.float32)
    if seed is not None:
        tod = tod + np.random.default_rng(seed).normal(
            0, 1e-6, tod.size).astype(np.float32)
    return tod, np.ones(n, np.float32), psi, pix, nx * nx, L


def f32_prefactor(ata, scale, rcond_ok):
    """:func:`pol._masked_inverse` in float32, the reference's 3 x 3
    arithmetic (``polarization.py:281-285``) and the port's until it held
    the inverses in float64."""
    inv = torch.linalg.inv(pol._tikhonov(ata, scale))
    return torch.where(rcond_ok[:, None, None], inv,
                       torch.zeros((), dtype=inv.dtype))


@pytest.mark.parametrize("seed", HARD_SEEDS,
                         ids=["tod"] + [f"seed{s}" for s in HARD_SEEDS[1:]])
def test_planned_floored_jacobi_survives_the_hard_problem(seed,
                                                          monkeypatch):
    """The reference's regression for the floored Jacobi
    (``tests/test_polarization.py:140``), on the port, over its TOD and
    six 1e-6 perturbations of it: 300 iterations with no early breakdown,
    landing below the reference test's 5e-3.

    With the 3 x 3 inverses in f32 the port landed at 2.0e-3 to 5.8e-3
    over these seven TODs (5.008e-3 on the TOD itself) and the reference
    at 0.9e-3 to 2.7e-3: an f32 inverse of a near-singular block (a
    normalised determinant near the 1e-6 cut) errs by up to 0.9% of the
    map it solves for, so the CG operator is not the symmetric one the
    iteration assumes. Held and applied in f64 it lands at 1.8e-4 to
    2.1e-4 on all seven (``tests/torch_pol_spread.py``, on the CPU).

    On the TOD itself the plain half: with the identity in place of the
    Jacobi, f32 inverses break down before the budget (iteration 198 in
    the port, ~142 in the reference's docstring: the reason for the
    floor), while the f64 ones run all 300 iterations and land lower
    still (8.7e-5)."""
    tod, w, psi, pix, npix, L = hard_problem(seed)
    plan = build_pointing_plan(pix, npix, L)
    r = pol.destripe_pol_planned(tod, w, psi, plan, n_iter=300,
                                 threshold=1e-6, device="cpu")
    assert int(r.n_iter) == 300 or float(r.residual) < 1e-6
    assert float(r.residual) < 5e-3
    assert torch.isfinite(r.iqu_destriped).all()
    if seed is not None:
        return
    monkeypatch.setattr(pol, "_jacobi_inverse",
                        lambda a, d, floor: torch.ones_like(a))
    plain = pol.destripe_pol_planned(tod, w, psi, plan, n_iter=300,
                                     threshold=1e-6, device="cpu")
    assert int(plain.n_iter) == 300 and float(plain.residual) < 5e-3
    monkeypatch.setattr(pol, "_masked_inverse", f32_prefactor)
    plain = pol.destripe_pol_planned(tod, w, psi, plan, n_iter=300,
                                     threshold=1e-6, device="cpu")
    assert int(plain.n_iter) < 300 and float(plain.residual) > 1e-6


def test_planned_map_solve_against_an_f64_oracle():
    """The mechanism behind the hard problem's landing: the planned
    solve's per-pixel map solve (:func:`pol._masked_inverse`,
    :func:`pol._apply_inverse`) on the hard problem's normal matrices
    and data sums against numpy's float64 solve of the same f32 inputs.
    Measured: within 5.8e-8 of each pixel's largest |m| (one f32
    rounding), held to 1e-6; the f32 prefactor errs by up to 9.0e-3 there
    (15 of 2 875 solvable pixels above 1e-3)."""
    tod, w, psi, pix, npix, _ = hard_problem()
    c2, s2 = np.cos(2 * psi), np.sin(2 * psi)
    state = pol._pol_accumulate(*(torch.as_tensor(a)
                                  for a in (pix, w, c2, s2)), npix)
    s = np.stack([np.ones_like(c2), c2, s2], -1).astype(np.float64)
    b = np.zeros((npix, 3))
    np.add.at(b, pix, (w * tod).astype(np.float64)[:, None] * s)
    b32 = torch.as_tensor(b.T.astype(np.float32))           # (3, npix)
    ok = state.rcond_ok.numpy()
    scale = pol._ata_scale(state.ata)
    a64 = (state.ata.double().numpy()
           + (1e-6 * scale.double().numpy())[:, None, None] * np.eye(3))
    want = np.linalg.solve(a64[ok], b32.double().numpy().T[ok][..., None])
    want = want[..., 0]

    def rel_err(prefactor):
        m = pol._apply_inverse(prefactor(state.ata, scale, state.rcond_ok),
                               b32).numpy().T[ok]
        assert m.dtype == np.float32
        return np.abs(m - want).max(1) / np.abs(want).max(1)

    assert 2_800 < int(ok.sum()) < npix
    assert rel_err(pol._masked_inverse).max() < 1e-6
    assert rel_err(f32_prefactor).max() > 1e-3


def test_entry_contract_and_k3_call_count(monkeypatch):
    d, pixels, weights, psi, npix, *_ = _simulate(seed=4)
    plan = build_pointing_plan(pixels, npix, 50)
    with pytest.raises(ValueError, match="single-RHS"):
        pol.destripe_pol_planned(np.stack([d, d]), weights, psi, plan,
                                 device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pol.destripe_pol_planned(d, weights, psi, plan)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pol.destripe_pol(d, pixels, weights, psi, npix)
    # the sharded solve (axis_name) sums over an SPMD run's mesh; outside
    # one it raises (tests/test_torch_sharded_planned.py runs it)
    with pytest.raises(RuntimeError, match="outside an SPMD run"):
        pol.destripe_pol(d, pixels, weights, psi, npix, axis_name="x",
                         device="cpu")
    calls = []
    real = pol.binned_window_sum

    def counting(values, *args, **kw):
        calls.append(tuple(values.shape[:-1]))
        assert kw == {"ids_sorted": True}
        return real(values, *args, **kw)

    monkeypatch.setattr(pol, "binned_window_sum", counting)
    res = pol.destripe_pol_planned(d, weights, psi, plan, n_iter=30,
                                   device="cpu")
    k = int(res.n_iter)
    assert len(calls) == 7 + 2 * k
    rows = sorted(set(calls))
    assert rows == [(), (3,), (7,), (10,)]
    assert calls.count((10,)) == 1 and calls.count((7,)) == 1
    assert calls.count((3,)) == k + 2 and calls.count(()) == k + 3
