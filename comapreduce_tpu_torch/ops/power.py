"""Noise power spectra and their model fits (port of
``comapreduce_tpu/ops/power.py``).

The PSD is ``|rfft|^2 / n``; log-binning sums each row into log-spaced
bins with one ``index_add_``; the 3-parameter noise models are fitted in
log space by :func:`minimize_lm`, a damped-Newton loop of 60 steps over
all (feed, band, scan) rows at once. For the two noise models the
gradient and Hessian of the log-chi^2 are written out (a few batched
tensor ops a step); :func:`minimize_lm` takes them from
``torch.func.grad``/``hessian`` under ``vmap`` for any other loss.
Everything follows the device of its input tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import grad, hessian, vmap

__all__ = ["psd", "log_bin_psd", "psd_peak_mask", "fit_noise_model",
           "fit_observation_noise", "knee_model", "red_noise_model",
           "minimize_lm"]


def psd(tod: torch.Tensor, sample_rate: float = 50.0):
    """One-sided power spectrum ``|rfft|^2 / n`` and its frequencies
    (``power.py:24``): ``(freqs[n//2+1], ps[..., n//2+1])``."""
    n = tod.shape[-1]
    ps = torch.fft.rfft(tod, dim=-1).abs() ** 2 / n
    freqs = torch.fft.rfftfreq(n, d=1.0 / sample_rate, device=tod.device,
                               dtype=tod.dtype)
    return freqs, ps


def _bin_sums(x: torch.Tensor, ids: torch.Tensor, nbins: int):
    """f32[..., n] -> f32[..., nbins] sums over each bin's samples."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.zeros((flat.shape[0], nbins), dtype=x.dtype,
                      device=x.device)
    out.index_add_(1, ids, flat)
    return out.reshape(x.shape[:-1] + (nbins,))


def log_bin_psd(freqs: torch.Tensor, ps: torch.Tensor, nbins: int = 15,
                sample_mask: torch.Tensor | None = None):
    """Average the PSD in log-spaced frequency bins (``power.py:36``).

    Empty bins hold 0 with count 0; the DC sample is excluded. With
    ``sample_mask`` (1 = keep, ``ps``'s shape) the counts gain the batch
    axes. Bin-centre frequencies come from the unmasked grid. Returns
    ``(nu_bin[nbins], p_bin[..., nbins], counts)``."""
    fmin = freqs[1]
    fmax = freqs[-1]
    # edges as jnp.logspace forms them in f32: 10 ** (start (1 - s) +
    # stop s) with s = i / nbins, the last edge at stop exactly
    lo, hi = torch.log10(fmin), torch.log10(fmax)
    s = torch.arange(nbins, dtype=freqs.dtype, device=freqs.device) / nbins
    lin = torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])
    edges = torch.pow(torch.tensor(10.0, dtype=freqs.dtype,
                                   device=freqs.device), lin)
    ids = torch.clamp(torch.searchsorted(edges, freqs, right=True) - 1,
                      0, nbins - 1)
    valid = (freqs >= fmin).to(ps.dtype)
    fsum = _bin_sums(freqs * valid, ids, nbins)
    valid_cnt = _bin_sums(valid, ids, nbins)
    if sample_mask is None:
        cnt = valid_cnt
        p_bin = _bin_sums(ps * valid, ids, nbins) / torch.clamp(cnt,
                                                                min=1.0)
    else:
        m = sample_mask.to(ps.dtype) * valid
        cnt = _bin_sums(m, ids, nbins)
        p_bin = _bin_sums(ps * m, ids, nbins) / torch.clamp(cnt, min=1.0)
    nu_bin = fsum / torch.clamp(valid_cnt, min=1.0)
    return nu_bin, p_bin, cnt


def psd_peak_mask(freqs: torch.Tensor, ps: torch.Tensor,
                  auto_rms2: torch.Tensor, threshold: float = 100.0,
                  min_freq: float = 0.5, halfwidth: int = 4):
    """Mask (1 = keep) of PSD samples free of resonance spikes
    (``power.py:87``): samples above ``threshold * auto_rms2`` at
    ``freqs > min_freq``, dilated by ``halfwidth`` bins."""
    cand = ((ps > threshold * auto_rms2.unsqueeze(-1))
            & (freqs > min_freq)).to(ps.dtype)
    if halfwidth > 0:
        flat = cand.reshape(-1, 1, cand.shape[-1])
        cand = F.max_pool1d(flat, kernel_size=2 * halfwidth + 1, stride=1,
                            padding=halfwidth).reshape(cand.shape)
    return 1.0 - torch.clamp(cand, 0.0, 1.0)


def knee_model(params, nu):
    """``sigma_w^2 (1 + |nu/fknee|^alpha)``."""
    sig2, fknee, alpha = params
    return sig2 * (1.0 + torch.abs(nu / fknee) ** alpha)


def red_noise_model(params, nu):
    """``sigma_w^2 + sigma_r^2 |nu|^alpha``."""
    sig2, red2, alpha = params
    return sig2 + red2 * torch.abs(nu) ** alpha


def minimize_lm(loss, q0: torch.Tensor, n_iter: int = 60,
                lam0: float = 1e-2, args: tuple = (),
                grad_hess=None) -> torch.Tensor:
    """Damped-Newton (Levenberg-Marquardt style) minimiser of small
    parameter vectors (``power.py:155``).

    ``loss(q, *args)`` is one row's scalar loss. ``q0``: f32[n] for one
    problem, or f32[R, n] for R problems with ``args`` batched along
    their first axis. Each of the ``n_iter`` steps solves
    ``(H + lam I) delta = g`` (a non-finite Hessian becomes ``I``) and
    keeps the step only if the loss falls: then ``lam *= 0.3``, else
    ``lam *= 10``, clipped to [1e-9, 1e9]. Gradient and Hessian come
    from ``torch.func`` unless ``grad_hess(q, *args) -> (g, H)`` gives
    them for the whole batch."""
    single = q0.ndim == 1
    q = q0.unsqueeze(0) if single else q0
    args = tuple(a.unsqueeze(0) for a in args) if single else tuple(args)
    f_fn = vmap(loss)
    if grad_hess is None:
        g_fn, h_fn = vmap(grad(loss)), vmap(hessian(loss))

        def grad_hess(q, *a):
            return g_fn(q, *a), h_fn(q, *a)
    n = q.shape[-1]
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    lam = torch.full(q.shape[:1], lam0, dtype=q.dtype, device=q.device)
    f = f_fn(q, *args)
    for _ in range(n_iter):
        g, H = grad_hess(q, *args)
        finite = torch.isfinite(H).all(dim=(-2, -1), keepdim=True)
        H = torch.where(finite, H, eye)
        delta, info = torch.linalg.solve_ex(
            H + lam[:, None, None] * eye, g.unsqueeze(-1))
        # a singular system gives no step (the reference's solve returns
        # non-finite values there, which the loss test then rejects)
        delta = torch.where((info == 0)[:, None], delta[..., 0],
                            torch.full_like(g, float("nan")))
        q_new = q - delta
        f_new = f_fn(q_new, *args)
        better = torch.isfinite(f_new) & (f_new < f)
        q = torch.where(better[:, None], q_new, q)
        f = torch.where(better, f_new, f)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 10.0),
                          1e-9, 1e9)
    return q[0] if single else q


def _log_chi2(model):
    """The per-row log-chi^2 of ``model`` in log-parameter space."""
    def loss(q, nu, logp, wgt):
        params = (torch.exp(q[0]), torch.exp(q[1]), q[2])
        m = model(params, torch.clamp(nu, min=1e-6))
        r = (logp - torch.log(torch.clamp(m, min=1e-30))) * wgt
        return torch.sum(r * r)
    return loss


def _log_model_derivs(model, q, nu):
    """``(m, D, E)`` of a 3-parameter model in log-parameter space over
    rows ``q`` f32[R, 3] and bins ``nu`` f32[R, K]: the model, the first
    derivatives of ``log m`` (f32[R, 3, K]) and its second derivatives
    (f32[R, 3, 3, K])."""
    nu = torch.clamp(nu, min=1e-6)
    q0, q1, a = (q[:, i:i + 1] for i in range(3))
    zero = torch.zeros_like(nu)
    if model is knee_model:
        ell = torch.log(torch.abs(nu)) - q1
        u = torch.abs(nu / torch.exp(q1)) ** a
        m = torch.exp(q0) * (1.0 + u)
        h = u / (1.0 + u)
        k = u / (1.0 + u) ** 2
        D = torch.stack([torch.ones_like(nu), -a * h, ell * h], dim=1)
        e12 = -h - a * ell * k
        E = torch.stack([torch.stack([zero, zero, zero], 1),
                         torch.stack([zero, a * a * k, e12], 1),
                         torch.stack([zero, e12, ell * ell * k], 1)], 1)
        return m, D, E
    lam = torch.log(torch.abs(nu))
    s = torch.exp(q0)
    rv = torch.exp(q1) * torch.abs(nu) ** a
    m = s + rv
    dm = torch.stack([s.expand_as(nu), rv, rv * lam], dim=1)
    d2 = torch.stack([torch.stack([s.expand_as(nu), zero, zero], 1),
                      torch.stack([zero, rv, rv * lam], 1),
                      torch.stack([zero, rv * lam, rv * lam * lam], 1)], 1)
    D = dm / m[:, None]
    E = d2 / m[:, None, None] - D[:, :, None] * D[:, None, :]
    return m, D, E


def _lm_grad_hess(model):
    """Batched gradient and Hessian of :func:`_log_chi2` written out:
    ``g = -2 sum r w D``, ``H = 2 sum w^2 D D^T - 2 sum r w E`` (the
    clamp of ``m`` at 1e-30 passes no derivative below it, as the
    reference's ``maximum`` does)."""
    def grad_hess(q, nu, logp, wgt):
        m, D, E = _log_model_derivs(model, q, nu)
        live = (m > 1e-30).to(q.dtype)
        D = D * live[:, None]
        E = E * live[:, None, None]
        r = (logp - torch.log(torch.clamp(m, min=1e-30))) * wgt
        rw = r * wgt
        g = -2.0 * torch.einsum("rk,rik->ri", rw, D)
        H = (2.0 * torch.einsum("rk,rik,rjk->rij", wgt * wgt, D, D)
             - 2.0 * torch.einsum("rk,rijk->rij", rw, E))
        return g, H
    return grad_hess


def _fit_rows(nu_bin, p_bin, counts, p0, model):
    """LM fits of R rows: ``p_bin``/``counts`` f32[R, nbins] (``counts``
    may broadcast), ``p0`` f32[R, 3]. Returns ``(params f32[R, 3],
    final loss f32[R])`` (``power.py:118``)."""
    counts = torch.broadcast_to(counts, p_bin.shape)
    nu = torch.broadcast_to(nu_bin, p_bin.shape)
    good = (counts > 0) & (p_bin > 0) & (nu > 0)
    zero = torch.zeros((), dtype=p_bin.dtype, device=p_bin.device)
    logp = torch.where(good, torch.log(torch.clamp(p_bin, min=1e-30)), zero)
    # a bin of k exponentially-distributed PSD samples has var(log) ~ 1/k
    wgt = torch.sqrt(torch.clamp(counts, min=0.0)) * good
    q0 = torch.stack([torch.log(torch.clamp(p0[:, 0], min=1e-20)),
                      torch.log(torch.clamp(p0[:, 1], min=1e-20)),
                      p0[:, 2]], dim=-1)
    loss = _log_chi2(model)
    q = minimize_lm(loss, q0, n_iter=60, args=(nu, logp, wgt),
                    grad_hess=_lm_grad_hess(model))
    params = torch.stack([torch.exp(q[:, 0]), torch.exp(q[:, 1]), q[:, 2]],
                         dim=-1)
    return params, vmap(loss)(q, nu, logp, wgt)


def fit_noise_model(nu_bin: torch.Tensor, p_bin: torch.Tensor,
                    counts: torch.Tensor, p0: torch.Tensor,
                    model=knee_model) -> torch.Tensor:
    """Fit a 3-parameter noise model to binned PSDs by log-chi^2
    (``power.py:141``): log(sig2) and log(fknee or red2) are optimised,
    the index free. ``p_bin`` f32[..., nbins], ``p0`` f32[..., 3]
    (``counts`` broadcasts). Returns f32[..., 3] in natural units."""
    lead = p_bin.shape[:-1]
    nb = p_bin.shape[-1]
    pb = p_bin.reshape(-1, nb)
    cnt = torch.broadcast_to(counts, p_bin.shape).reshape(-1, nb)
    fit, _ = _fit_rows(nu_bin, pb, cnt, p0.reshape(-1, 3), model)
    return fit.reshape(lead + (3,))


def fit_observation_noise(blocks: torch.Tensor, sample_rate: float = 50.0,
                          nbins: int = 30, model_name: str = "red_noise",
                          mask_peaks: bool = True) -> torch.Tensor:
    """Whole-observation noise fits (``power.py:192``): PSD -> peak mask
    -> log bins -> initial guess -> LM, for ``blocks`` f32[..., Lmin]
    per-(feed, band, scan) rows. The red-noise model is fitted from two
    starts, its own and the knee model's optimum converted into red-noise
    parameters, keeping the better. Returns f32[..., 3]."""
    model = red_noise_model if model_name == "red_noise" else knee_model
    freqs, ps = psd(blocks, sample_rate)
    if mask_peaks:
        d = blocks[..., 1:] - blocks[..., :-1]
        auto_rms2 = torch.var(d, dim=-1, unbiased=False) / 2.0
        smask = psd_peak_mask(freqs, ps, auto_rms2)
        nu, pb, cnt = log_bin_psd(freqs, ps, nbins=nbins,
                                  sample_mask=smask)
        cnt = cnt.reshape(-1, nbins)
    else:
        nu, pb, cnt = log_bin_psd(freqs, ps, nbins=nbins)
    pb_flat = pb.reshape(-1, nbins)
    good_hi = (nu > 0.5 * nu.max()).to(pb.dtype)
    n_hi = torch.clamp(good_hi.sum(), min=1.0)
    sig2 = torch.clamp((pb_flat * good_hi).sum(-1) / n_hi, min=1e-20)
    p_low = torch.maximum(pb_flat[:, 1], sig2 * 1.01)
    nu_low = torch.clamp(nu[1], min=1e-3)
    alpha0 = -1.5
    a0 = torch.full_like(sig2, alpha0)
    if model_name == "red_noise":
        p1 = torch.maximum((p_low - sig2) * nu_low ** (-alpha0),
                           sig2 * 1e-3)
    else:
        excess = torch.clamp(p_low / sig2 - 1.0, min=1e-3)
        p1 = torch.clamp(nu_low * excess ** (-1.0 / alpha0),
                         nu_low, 0.5 * sample_rate)
    p0 = torch.stack([sig2, p1, a0], dim=-1)
    if model_name == "red_noise":
        # the red-noise surface is bistable: a second start from the knee
        # model's optimum, red2 = sig2 * fknee^(-alpha)
        excess_k = torch.clamp(p_low / sig2 - 1.0, min=1e-3)
        p1_k = torch.clamp(nu_low * excess_k ** (-1.0 / alpha0),
                           nu_low, 0.5 * sample_rate)
        p0_k = torch.stack([sig2, p1_k, a0], dim=-1)
        pk, _ = _fit_rows(nu, pb_flat, cnt, p0_k, knee_model)
        red2_k = pk[:, 0] * torch.clamp(pk[:, 1], min=1e-6) ** (-pk[:, 2])
        start_k = torch.stack([pk[:, 0], torch.clamp(red2_k, min=1e-20),
                               pk[:, 2]], dim=-1)
        pa, la = _fit_rows(nu, pb_flat, cnt, p0, red_noise_model)
        pb2, lb = _fit_rows(nu, pb_flat, cnt, start_k, red_noise_model)
        take_b = (torch.isfinite(lb) & (lb < la))[:, None]
        fit = torch.where(take_b, pb2, pa)
    else:
        fit, _ = _fit_rows(nu, pb_flat, cnt, p0, model)
    return fit.reshape(blocks.shape[:-1] + (3,))
