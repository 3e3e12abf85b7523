"""The port's noise power spectra and model fits (``ops/power.py``) against
the reference's on the same numpy inputs (CPU): ``psd``, ``log_bin_psd``
with and without a sample mask, ``psd_peak_mask``, the two models,
``minimize_lm`` on a small smooth problem, ``fit_noise_model`` and the
whole-observation ``fit_observation_noise`` (knee and red-noise models,
with and without peak masking) over rows of 1/f plus white noise with a
planted resonance. Beside them, the written-out gradient and Hessian of
the fits' log-chi^2 against ``torch.func`` in float64.

Tolerances:
- ``psd``, ``log_bin_psd``, ``psd_peak_mask``: frequencies and masks
  equal, powers within 1e-6 of scale (FFTs in another order; measured
  1.8e-7). The log-bin edges are formed as ``jnp.logspace`` forms them,
  so every sample lands in the reference's bin.
- ``minimize_lm`` on a convex quadratic-plus-quartic: 1e-5 (measured
  ~1e-7).
- Noise fits (60 damped-Newton steps in f32 each, gradient and Hessian
  written out here, autodiff in the reference): parameters within
  ``FIT_RTOL`` = 5e-3 relative (measured 2.7e-6 knee, 4.5e-4 red noise)
  and the fitted model over the fit's frequency span within
  ``MODEL_RTOL`` = 1e-3 (measured below 1e-4). A row dominated by a
  resonance line fits a pure power law whose white level runs to
  ~1e-10: its parameters are degenerate along the model, so that row
  is held through the model only.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import grad, hessian, vmap

from chip_smoke import noise_model
from comapreduce_tpu.data.synthetic import one_over_f_noise
from comapreduce_tpu.ops import power as ref
from comapreduce_tpu_torch.ops import power as port

FIT_RTOL = 5e-3
MODEL_RTOL = 1e-3


@pytest.fixture(scope="module")
def blocks():
    """(3 feeds, 2 bands, 2 scans, 1024) rows of 1/f + white noise with
    knees 0.3-1.3 Hz and indices 1.2-2.2."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        rows.append(one_over_f_noise(rng, 1024, 1e-3 * (1 + i),
                                     0.3 + 0.2 * i, 1.2 + 0.2 * i,
                                     size=(2,)))
    return np.stack(rows).reshape(3, 2, 2, 1024).astype(np.float32)


@pytest.fixture(scope="module")
def resonant(blocks):
    """``blocks`` with a strong 7.3 Hz line in one row."""
    x = blocks.copy()
    t = np.arange(1024) / 50.0
    x[1, 0, 1] += (0.05 * np.sin(2 * np.pi * 7.3 * t)).astype(np.float32)
    return x


def test_psd_and_log_bins_match_reference(blocks):
    rf, rp = ref.psd(jnp.asarray(blocks))
    pf, pp = port.psd(torch.as_tensor(blocks))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))
    scale = float(np.abs(np.asarray(rp)).max())
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=0,
                               atol=1e-6 * scale)
    rng = np.random.default_rng(1)
    smask = (rng.random(rp.shape) > 0.1).astype(np.float32)
    for nbins, sm in ((12, None), (30, smask)):
        want = ref.log_bin_psd(rf, rp, nbins=nbins,
                               sample_mask=None if sm is None
                               else jnp.asarray(sm))
        got = port.log_bin_psd(pf, pp, nbins=nbins,
                               sample_mask=None if sm is None
                               else torch.as_tensor(sm))
        nu, pb, cnt = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(got[0].numpy(), nu)
        np.testing.assert_array_equal(got[2].numpy(), cnt)
        np.testing.assert_allclose(got[1].numpy(), pb, rtol=0,
                                   atol=1e-6 * float(np.abs(pb).max()))


def test_psd_peak_mask_matches_reference(resonant):
    blocks = resonant
    rf, rp = ref.psd(jnp.asarray(blocks))
    d = blocks[..., 1:] - blocks[..., :-1]
    r2 = (d.var(axis=-1) / 2.0).astype(np.float32)
    want = np.asarray(ref.psd_peak_mask(rf, rp, jnp.asarray(r2)))
    got = port.psd_peak_mask(torch.as_tensor(np.array(rf)),
                             torch.as_tensor(np.array(rp)),
                             torch.as_tensor(r2)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any()                      # the resonance is cut


def test_minimize_lm_matches_reference():
    c = np.array([0.3, -1.2, 2.0], np.float32)

    def r_loss(q):
        return jnp.sum((q - c) ** 2 * (1 + jnp.arange(3.0))) + \
            0.1 * jnp.sum((q - c) ** 4)

    ct = torch.as_tensor(c)

    def p_loss(q):
        return torch.sum((q - ct) ** 2 * (1 + torch.arange(3.0))) + \
            0.1 * torch.sum((q - ct) ** 4)

    q0 = np.array([2.0, 1.0, -1.0], np.float32)
    want = np.asarray(ref.minimize_lm(r_loss, jnp.asarray(q0)))
    got = port.minimize_lm(p_loss, torch.as_tensor(q0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, c, atol=1e-3)


@pytest.mark.parametrize("model", ["knee", "red_noise"])
def test_written_out_derivatives_match_autodiff(model):
    fn = port.knee_model if model == "knee" else port.red_noise_model
    g = torch.Generator().manual_seed(0)
    R, K = 5, 12
    nu = torch.logspace(-2, 1.3, K, dtype=torch.float64).expand(R, K)
    logp = torch.randn(R, K, generator=g, dtype=torch.float64)
    wgt = 3 * torch.rand(R, K, generator=g, dtype=torch.float64)
    q = torch.tensor([[np.log(1e-3), np.log(0.3), -1.5]] * R,
                     dtype=torch.float64) + 0.1 * torch.randn(
        R, 3, generator=g, dtype=torch.float64)
    loss = port._log_chi2(fn)
    g_auto = vmap(grad(loss))(q, nu, logp, wgt)
    h_auto = vmap(hessian(loss))(q, nu, logp, wgt)
    g_out, h_out = port._lm_grad_hess(fn)(q, nu, logp, wgt)
    torch.testing.assert_close(g_out, g_auto, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(h_out, h_auto, rtol=1e-10, atol=1e-12)


def _model_span(params, knee: bool, fs=50.0, n=1024):
    """The fitted model over the fit's frequency span."""
    return noise_model(params, np.logspace(np.log10(fs / n),
                                           np.log10(fs / 2), 20), knee)


@pytest.mark.parametrize("model", ["knee", "red_noise"])
@pytest.mark.parametrize("data,mask_peaks", [("blocks", True),
                                             ("blocks", False),
                                             ("resonant", True)])
def test_fit_observation_noise_matches_reference(request, data, model,
                                                 mask_peaks):
    x = request.getfixturevalue(data)
    want = np.asarray(ref.fit_observation_noise(
        jnp.asarray(x), nbins=12, model_name=model, mask_peaks=mask_peaks))
    got = port.fit_observation_noise(
        torch.as_tensor(x), nbins=12, model_name=model,
        mask_peaks=mask_peaks).numpy()
    assert got.shape == want.shape == (3, 2, 2, 3)
    assert np.isfinite(got).all()
    knee = model == "knee"
    mw, mg = _model_span(want, knee), _model_span(got, knee)
    np.testing.assert_allclose(mg, mw, rtol=MODEL_RTOL, atol=0)
    # the resonant row fits a pure power law (white level -> 1e-10): its
    # parameters are degenerate along the model and are held through the
    # model only
    keep = np.ones(want.shape[:-1], bool)
    if data == "resonant":
        keep[1, 0, 1] = False
    np.testing.assert_allclose(got[keep], want[keep], rtol=FIT_RTOL, atol=0)


def test_fit_noise_model_matches_reference(blocks):
    rf, rp = ref.psd(jnp.asarray(blocks[0, 0]))
    nu, pb, cnt = ref.log_bin_psd(rf, rp, nbins=12)
    p0 = np.array([[1e-5, 0.5, -1.5], [4e-6, 0.2, -1.0]], np.float32)
    want = np.asarray(jax.vmap(lambda pr, q: ref.fit_noise_model(
        nu, pr, cnt, q))(pb, jnp.asarray(p0)))
    got = port.fit_noise_model(torch.as_tensor(np.array(nu)),
                               torch.as_tensor(np.array(pb)),
                               torch.as_tensor(np.array(cnt)),
                               torch.as_tensor(p0)).numpy()
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=0)
