"""The banded noise prior of the port (``comapreduce_tpu_torch/mapmaking/
noise_weight.py`` and ``destripe_planned(banded=...)``) against the
reference's (``comapreduce_tpu/mapmaking/noise_weight.py``).

The builder is numpy in both packages, the same calls in the same order:
held bitwise, fallback report and ``stack_banded`` included. Solves with
the prior: pinned iterations to the planned solver's 5e-4 absolute
(``tests/test_torch_destriper.py``); converged solves to the reference's
iteration count within 5 and the float64 normal equations of ``A + B`` to
5e-5, as ``tests/test_torch_coarse.py`` holds the two-level solve. The
reference's zero-prior parity test fails on this container, so the
port's zero prior is held to the port's own white solve instead, and the
reference's headline (banded beats white on matched 1/f) is ported as a
test of the port alone.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from comapreduce_tpu.mapmaking.destriper import \
    destripe_planned as ref_planned
from comapreduce_tpu.mapmaking.noise_weight import \
    build_banded_weight as ref_build
from comapreduce_tpu.mapmaking.noise_weight import \
    quality_index as ref_quality_index
from comapreduce_tpu.mapmaking.noise_weight import stack_banded as ref_stack
from comapreduce_tpu.mapmaking.pointing_plan import \
    build_pointing_plan as ref_build_plan
from comapreduce_tpu_torch.convert import (banded_from_reference,
                                           plan_arrays, plan_from_reference)
from comapreduce_tpu_torch.mapmaking.destriper import destripe_planned
from comapreduce_tpu_torch.mapmaking.noise_weight import (
    build_banded_weight, quality_index, stack_banded)

L = 10
FS = 50.0
PLANNED_ATOL = 5e-4


def _group(file="a.h5", feed=0, n_samples=400, fs=FS):
    return {"file": file, "feed": feed, "sample_rate": fs,
            "n_samples": n_samples}


def _fit(file="a.h5", feed=0, band=0, sigma=0.05, fknee=1.0,
         alpha=-1.5, **over):
    rec = {"file": file, "feed": feed, "band": band,
           "white_sigma": sigma, "fknee_hz": fknee, "alpha": alpha}
    rec.update(over)
    return rec


# (groups, quality, n_offsets, kwargs) of the builder's cases: a good fit
# with padding offsets, every fallback reason, two groups (the boundary
# zeroing), shards, another grid, scale and bandwidth, a fit with other
# band and a string-valued parameter
BUILD_CASES = {
    "good_fit": ([_group(n_samples=800)], [_fit()], 120, {}),
    "every_fallback": (
        [_group("absent.h5", 0), _group("flagged.h5", 1),
         _group("badfit.h5", 2), _group("lowknee.h5", 3),
         _group("ok.h5", 4)],
        [_fit("flagged.h5", 1, flagged=True), _fit("badfit.h5", 2, alpha=1.0),
         _fit("lowknee.h5", 3, fknee=1e-6), _fit("ok.h5", 4, fknee=0.5)],
        200, {}),
    "all_white": ([_group("absent.h5", 0)], [], 40, {}),
    "two_groups": ([_group("a.h5", 0), _group("b.h5", 1)],
                   [_fit("a.h5", 0), _fit("b.h5", 1, sigma=0.1, alpha=-2.0)],
                   80, {"bandwidth": 3}),
    "shards": ([_group(n_samples=800)], [_fit()], 80,
               {"bandwidth": 3, "n_shards": 4}),
    "grid_scale": ([_group(n_samples=800, fs=20.0)],
                   [_fit(fknee=0.3, alpha=-1.1), _fit(band=1, sigma=9.0)],
                   80, {"n_grid": 256, "prior_scale": 0.5, "bandwidth": 6}),
    "string_params": ([_group(n_samples=800)],
                      [_fit(sigma="0.07", fknee="2.0", alpha="-1.3")], 80,
                      {}),
}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_builder_bitwise_to_reference(case):
    groups, quality, n_off, kw = BUILD_CASES[case]
    got, rep = build_banded_weight(groups, quality, n_off, L, **kw)
    want, ref_rep = ref_build(groups, quality, n_off, L, **kw)
    assert rep == ref_rep
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    if case == "every_fallback":
        assert {f["reason"] for f in rep["fallbacks"]} == {
            "absent", "flagged", "bad_fit", "fknee_low"}


def test_shard_misaligned_offsets_raise():
    with pytest.raises(ValueError, match="not divisible"):
        build_banded_weight([_group(n_samples=800)], [_fit()], 81, L,
                            n_shards=4)


def test_quality_index_and_stack_match_reference():
    recs = [_fit("/deep/path/a.h5", 0, band=0),
            _fit("a.h5", 0, band=1, sigma=9.0),
            {"file": None, "feed": "x", "band": 0}]
    assert quality_index(recs, 0) == ref_quality_index(recs, 0)
    assert set(quality_index(recs, 0)) == {("a.h5", 0)}
    a, _ = build_banded_weight([_group(n_samples=800)], [_fit()], 80, L)
    b, _ = build_banded_weight([_group(n_samples=800)],
                               [_fit(alpha=-2.0)], 80, L)
    for lst in ([a, None], [a, b, None], [None, None]):
        got, want = stack_banded(lst), ref_stack(lst)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    c, _ = build_banded_weight([_group(n_samples=800)], [_fit()], 100, L)
    with pytest.raises(ValueError, match="geometry"):
        stack_banded([a, c])


def _matched_1f_problem(T=8_000, nx=16, seed=0):
    """The reference's fixture (``tests/test_noise_weight.py:131``): a sky
    raster plus correlated noise drawn from the PSD the quality record
    states, inverse-variance weights."""
    rng = np.random.default_rng(seed)
    npix = nx * nx
    pix = ((np.arange(T) * 7) % npix).astype(np.int64)
    sky = rng.normal(0, 1.0, npix).astype(np.float32)
    sigma, fknee, alpha = 0.05, 1.0, -1.5
    freqs = np.fft.rfftfreq(T, d=1.0 / FS)
    psd = np.zeros_like(freqs)
    psd[1:] = sigma ** 2 * (freqs[1:] / fknee) ** alpha
    amp = np.sqrt(psd * T * FS / 2.0) / np.sqrt(FS)
    ph = rng.normal(size=freqs.size) + 1j * rng.normal(size=freqs.size)
    corr = np.fft.irfft(amp * ph, n=T).astype(np.float32)
    tod = (sky[pix] + corr
           + sigma * rng.normal(size=T).astype(np.float32)
           ).astype(np.float32)
    w = np.full(T, 1.0 / sigma ** 2, np.float32)
    groups = [_group("synthetic.h5", 0, n_samples=T)]
    quality = [_fit("synthetic.h5", 0, sigma=sigma, fknee=fknee,
                    alpha=alpha)]
    return pix, tod, w, sky, npix, groups, quality


def _plans(pix, npix):
    r = ref_build_plan(pix, npix, L)
    arrays, static = plan_arrays(r)
    return r, plan_from_reference(arrays, **static)


def _map_err(r, sky):
    hit = r.hit_map.numpy() > 0
    d = r.destriped_map.numpy()[hit] - sky[hit]
    return float(np.sqrt(np.mean((d - d.mean()) ** 2)))


def test_zero_prior_is_white_parity():
    """A zero ``(c0, cs)`` adds exact zeros in the port's matvec: the
    port's white solve, iteration for iteration."""
    pix, tod, w, _, npix, _, _ = _matched_1f_problem(T=2_000)
    _, plan = _plans(pix, npix)
    n_off = tod.size // L
    t, ww = torch.as_tensor(tod), torch.as_tensor(w)
    r_white = destripe_planned(t, ww, plan, n_iter=300, threshold=1e-8)
    r_zero = destripe_planned(t, ww, plan, n_iter=300, threshold=1e-8,
                              banded=(torch.zeros(n_off),
                                      torch.zeros(4, n_off)))
    assert int(r_zero.n_iter) == int(r_white.n_iter)
    np.testing.assert_allclose(r_zero.offsets.numpy(),
                               r_white.offsets.numpy(), rtol=0, atol=1e-6)


def test_banded_beats_white_on_matched_1f():
    """The reference's headline, in the port: with noise drawn from the
    fitted PSD and inverse-variance weights, the banded prior converges in
    fewer CG iterations and lands closer to the injected sky."""
    pix, tod, w, sky, npix, groups, quality = _matched_1f_problem()
    banded, report = build_banded_weight(groups, quality, tod.size // L, L)
    assert report["banded"] == 1
    _, plan = _plans(pix, npix)
    t, ww = torch.as_tensor(tod), torch.as_tensor(w)
    r_white = destripe_planned(t, ww, plan, n_iter=500, threshold=1e-8)
    r_band = destripe_planned(t, ww, plan, n_iter=500, threshold=1e-8,
                              banded=banded)
    assert float(r_band.residual) < 1e-8
    assert int(r_band.n_iter) < int(r_white.n_iter)
    assert _map_err(r_band, sky) < _map_err(r_white, sky)


def _normal_residual_banded(pix, tod, w, npix, banded, offsets):
    """|b - (A + B) a| / |b| in float64: the scatter statement of the
    destriper's normal equations plus the banded prior applied as a dense
    symmetric band."""
    n = tod.size
    off_id = np.arange(n) // L
    wd = w.astype(np.float64)
    sw = np.bincount(pix, weights=wd, minlength=npix)
    inv_sw = np.where(sw > 0, 1.0 / np.maximum(sw, 1e-30), 0.0)

    def proj(x):
        m = np.bincount(pix, weights=x * wd, minlength=npix) * inv_sw
        return np.bincount(off_id, weights=(x - m[pix]) * wd,
                           minlength=n // L)

    c0, cs = (np.asarray(b, np.float64) for b in banded)
    a = np.asarray(offsets, np.float64)
    ba = c0 * a
    for j in range(1, cs.shape[0] + 1):
        ba[:-j] += cs[j - 1, :-j] * a[j:]
        ba[j:] += cs[j - 1, :-j] * a[:-j]
    b = proj(tod.astype(np.float64))
    return np.linalg.norm(b - proj(a[off_id]) - ba) / np.linalg.norm(b)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_banded_solve_matches_reference(multi):
    """Ten pinned iterations, then the converged solve, against the
    reference's, with the reference's prior fed to the port."""
    pix, tod, w, sky, npix, groups, quality = _matched_1f_problem(T=4_000)
    ref_plan, plan = _plans(pix, npix)
    n_off = tod.size // L
    b0, _ = ref_build(groups, quality, n_off, L)
    if multi:
        b1, _ = ref_build(groups, [_fit("synthetic.h5", 0, sigma=0.08,
                                        alpha=-2.0)], n_off, L)
        banded = ref_stack([b0, b1])
        tod = np.stack([tod, tod[::-1].copy()])
        w = np.stack([w, w])
    else:
        banded = b0
    port_banded = banded_from_reference(banded)
    for n_iter, thr in ((10, 0.0), (500, 1e-7)):
        g = destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                             n_iter=n_iter, threshold=thr,
                             banded=port_banded)
        r = ref_planned(jnp.asarray(tod), jnp.asarray(w), plan=ref_plan,
                        n_iter=n_iter, threshold=thr,
                        banded=tuple(jnp.asarray(b) for b in banded),
                        kernels="xla")
        if n_iter == 10:
            np.testing.assert_allclose(g.offsets.numpy(),
                                       np.asarray(r.offsets), rtol=0,
                                       atol=PLANNED_ATOL)
    assert (g.residual.numpy() < 1e-7).all()
    assert abs(int(g.n_iter) - int(r.n_iter)) <= 5
    offs = g.offsets.numpy().reshape(-1, n_off)
    tods = tod.reshape(-1, tod.shape[-1])
    pb = [np.asarray(b).reshape((-1,) + np.asarray(b).shape[-1 - k:])
          for k, b in enumerate(port_banded)]
    for i in range(offs.shape[0]):
        assert _normal_residual_banded(pix, tods[i], w.reshape(
            -1, tod.shape[-1])[i], npix, (pb[0][i], pb[1][i]),
            offs[i]) < 5e-5


def test_banded_rejected_on_ground_solve():
    pix, tod, w, _, npix, _, _ = _matched_1f_problem(T=1_000)
    _, plan = _plans(pix, npix)
    n_off = tod.size // L
    with pytest.raises(ValueError, match="banded"):
        destripe_planned(torch.as_tensor(tod), torch.as_tensor(w), plan,
                         n_iter=2, banded=(np.zeros(n_off, np.float32),
                                           np.zeros((4, n_off), np.float32)),
                         ground_off=np.zeros(n_off, np.int32),
                         az=torch.zeros(tod.size), n_groups=1)
