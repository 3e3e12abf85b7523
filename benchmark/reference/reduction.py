"""Plain Level-1 -> Level-2 reduction of one feed (COMAPreduce's
``MeasureSystemTemperature`` and ``Level1AveragingGainCorrection``, as
the program's reduction defines them), one scan at a time.

Vane: per band the channel-mean TOD of the vane event; hot samples are
flat (|gradient| < 2e-3 of the range) and 15 white rms above the
midrange, cold ones flat, below that and after the last hot sample;
``gain = (<hot> - <cold>) / (T_load - 2.73 K)``, ``tsys = <cold> /
gain`` per channel (0 where a half is missing or the gain is not
positive).

Each scan, padded to ``L`` samples (the tail repeats the last sample
and is masked out): flagged samples take the channel's median over
every fourth sample (the mean of the row where none is valid); a
per-channel fit ``offset + slope * airmass``; the radiometer rms of
every-fourth-sample differences sets the scale ``rms sqrt(dnu tau)``;
the scaled residual is high-passed by a median filter of the band's
channel mean (``window`` samples, symmetric boundary, taken as the
running median over ``window // stride`` block medians of ``stride =
ceil(window / 512)`` samples where ``stride > 1``) fitted per channel
as ``a + b med``; the gain fluctuation ``dg(t)`` is the projection of
the filtered TOD on the Tsys templates ``[1 / tsys, freq / tsys]``'
orthogonal complement; the band average weights channels by ``1 /
tsys^2`` and scales them by ``rms sqrt(dnu tau) / gain``, then takes
``coef * dg`` off; the sample weights are the inverse of half the
variance of adjacent-sample differences.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import precision

T_CMB = 2.73


def channel_masks(C: int) -> dict:
    """The chain's channel masks (edges and the band centre cut),
    scaled from 1024 channels."""
    def s(n):
        return max(int(round(n * C / 1024.0)), 1)

    def mask(edge, below, above):
        m = torch.ones(C, dtype=torch.float64)
        m[:edge] = 0.0
        m[C - edge:] = 0.0
        c = C // 2
        if below or above:
            m[max(c - below, 0):min(c + above, C)] = 0.0
        return m
    return {"weights": mask(s(10), s(2), s(3)),
            "band_avg": mask(s(50), 0, s(1)),
            "medfilt": mask(s(10), s(5), s(6)),
            "templates": mask(s(20), s(5), s(5))}


def _median_rows(x):
    """Median of each row: the mean of the two middle values."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def _masked_median(x, m):
    """Median of the rows' valid entries (``m > 0``); 0 on an empty
    row."""
    big = torch.finfo(x.dtype).max
    s = torch.sort(torch.where(m > 0, x, big), dim=-1).values
    cnt = (m > 0).sum(-1)
    c1 = torch.clamp(cnt, min=1)
    lo = torch.gather(s, -1, ((c1 - 1) // 2).unsqueeze(-1))[..., 0]
    hi = torch.gather(s, -1, (c1 // 2).unsqueeze(-1))[..., 0]
    return torch.where(cnt > 0, 0.5 * (lo + hi), torch.zeros_like(lo))


def _masked_mean(x, m):
    return (x * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def _masked_std(x, m):
    mu = _masked_mean(x, m)
    d = x - mu.unsqueeze(-1)
    return torch.sqrt(torch.clamp(_masked_mean(d * d, m), min=0.0))


def vane(vane_tod, load_k: float, prec: str = "f64"):
    """``(tsys, gain)`` [B, C] from one vane event [B, C, V]."""
    dt, q = precision(prec)
    v = q(vane_tod.to(dt))
    avg = v.mean(dim=1)                                    # (B, V)
    n = avg.shape[-1] // 2 * 2
    diff = avg[..., 1:n:2] - avg[..., 0:n:2]
    rms = diff.std(dim=-1, unbiased=False) / math.sqrt(2.0)
    rng = torch.clamp(avg.amax(-1) - avg.amin(-1), min=1e-30)
    x = avg / rng[:, None]
    rms_n = (rms / rng)[:, None]
    mid = ((x.amax(-1) + x.amin(-1)) / 2)[:, None]
    grad = torch.cat([x[:, 1:2] - x[:, 0:1], (x[:, 2:] - x[:, :-2]) / 2,
                      x[:, -1:] - x[:, -2:-1]], dim=-1)
    flat = grad.abs() < 2e-3
    hot = ((x - mid) > 15.0 * rms_n) & flat
    cold = ((x - mid) < 15.0 * rms_n) & flat
    t = torch.arange(x.shape[-1], device=x.device)
    last_hot = torch.where(hot, t, -1).amax(-1, keepdim=True)
    cold = cold & (t > last_hot)
    both = (hot.any(-1) & cold.any(-1))[:, None]
    hot, cold = (hot & both).to(dt), (cold & both).to(dt)
    p_hot = _masked_mean(v, hot[:, None, :].expand_as(v))
    p_cold = _masked_mean(v, cold[:, None, :].expand_as(v))
    gain = (p_hot - p_cold) / (load_k - T_CMB)
    ok = ((hot.sum(-1) > 0) & (cold.sum(-1) > 0))[:, None] & (gain > 0)
    gain = torch.where(ok, gain, 0.0)
    tsys = torch.where(ok, p_cold / torch.where(ok, gain, 1.0), 0.0)
    return q(tsys), q(gain)


def _running_median(x, window: int, pad: str):
    """Centred running median over the last axis, ``pad`` 'edge' or
    'symmetric' boundaries, one window at a time in blocks."""
    T = x.shape[-1]
    left = (window - 1) // 2
    pos = torch.arange(-left, T + window - 1 - left, device=x.device)
    if pad == "edge":
        src = torch.clamp(pos, 0, T - 1)
    else:
        mm = torch.remainder(pos, 2 * T)
        src = torch.where(mm < T, mm, 2 * T - 1 - mm)
    padded = x[..., src]
    outs = []
    for c0 in range(0, T, 512):
        c1 = min(c0 + 512, T)
        outs.append(_median_rows(
            padded[..., c0:c1 + window - 1].unfold(-1, window, 1)))
    return torch.cat(outs, dim=-1)


def median_filter(x, window: int):
    """The chain's median filter of [B, L] with symmetric boundaries:
    exact up to a 512-sample window, two-level above it."""
    stride = -(-window // 512)
    if stride == 1:
        return _running_median(x, window, "symmetric")
    T = x.shape[-1]
    left = (window - 1) // 2
    pos = torch.arange(-left, T + window - 1 - left, device=x.device)
    mm = torch.remainder(pos, 2 * T)
    padded = x[..., torch.where(mm < T, mm, 2 * T - 1 - mm)]
    P0 = padded.shape[-1]
    nb = -(-P0 // stride)
    padded = torch.cat([padded, padded[..., -1:].expand(
        padded.shape[:-1] + (nb * stride - P0,))], dim=-1)
    bm = _median_rows(padded.reshape(padded.shape[:-1] + (nb, stride)))
    rm = _running_median(bm, max(window // stride, 1), "edge")
    j = torch.clamp((torch.arange(T, device=x.device) + left) // stride,
                    0, nb - 1)
    return rm[..., j]


def reduce_feed(tod, scan_mask, airmass, freq, tsys, gain, edges,
                L: int, cfg: dict, prec: str = "f64"):
    """One feed's ``(tod, weights)`` [B, T] from raw counts [B, C, T],
    the time mask [T], airmass [T], freq [B, C], the vane's tsys and
    gain [B, C] and the host scan ``edges`` [S, 2]."""
    dt, q = precision(prec)
    dev = tod.device
    B, C, T = tod.shape
    masks = {k: v.to(dev, dt) for k, v in channel_masks(C).items()}
    bw_tau = (2e9 / C) * (1.0 / 50.0)
    freq = freq.to(dt)
    tsys, gain = tsys.to(dt), gain.to(dt)
    # the gain templates: the projector off [1/tsys, freq/tsys]
    ok = (tsys > 0) & (masks["templates"] > 0) & torch.isfinite(tsys)
    inv_t = torch.where(ok, 1.0 / torch.where(ok, tsys, 1.0), 0.0)
    T2 = torch.stack([inv_t.reshape(-1), (freq * inv_t).reshape(-1)], -1)
    p = ok.to(dt).reshape(-1)
    G = T2.T @ T2
    det = G[0, 0] * G[1, 1] - G[0, 1] * G[1, 0]
    if abs(float(det)) <= 1e-30:
        G_inv = torch.eye(2, dtype=dt, device=dev)
    else:
        G_inv = torch.stack([torch.stack([G[1, 1], -G[0, 1]]),
                             torch.stack([-G[1, 0], G[0, 0]])]) / det
    zp = (p - T2 @ (G_inv @ (T2.T @ p))).reshape(B, C)
    zpp = (p.reshape(B, C) * zp).sum()
    w_tsys = torch.where(tsys > 0, 1.0 / torch.clamp(tsys, min=1e-10) ** 2,
                         0.0)
    w_ch = w_tsys * masks["weights"] * masks["band_avg"]
    den = torch.clamp(w_ch.sum(-1), min=1e-30)[:, None]
    safe_gain = torch.where(gain > 0, gain, 1.0)
    cm = masks["medfilt"]
    nch = torch.clamp(cm.sum(), min=1.0)
    out_t = torch.zeros((B, T), dtype=dt, device=dev)
    out_w = torch.zeros((B, T), dtype=dt, device=dev)
    ar = torch.arange(L, device=dev)
    for s, e in edges.tolist():
        n = e - s
        idx = torch.clamp(s + ar, max=e - 1)
        tv = (ar < n).to(dt)
        d = q(tod[:, :, idx].to(dt))
        m = (scan_mask[torch.clamp(s + ar, max=T - 1)].to(dt) * tv)
        m = m.expand(B, C, L)
        a = airmass[idx].to(dt)
        # flagged samples: the stride-4 masked median, else the mean
        med4 = _masked_median(d[..., ::4], m[..., ::4])
        fill = torch.where(m[..., ::4].sum(-1) > 0, med4, _masked_mean(d, m))
        d = torch.where(m > 0, d, fill[..., None])
        # airmass fit
        cnt = m.sum(-1)
        s1 = torch.clamp(cnt, min=1.0)
        a_mean = (m * a).sum(-1) / s1
        d_mean = (m * d).sum(-1) / s1
        da = a - a_mean[..., None]
        saa = (m * da * da).sum(-1)
        sad = (m * da * (d - d_mean[..., None])).sum(-1)
        fit = (cnt >= 2.0) & (saa > 1e-12)
        slope = torch.where(fit, sad / torch.clamp(saa, min=1e-12), 0.0)
        base = d_mean - slope * a_mean
        # radiometer scale
        n4 = L // 4 * 4
        diff = (d[..., 0:n4:4] - d[..., 2:n4:4]) \
            - slope[..., None] * (a[0:n4:4] - a[2:n4:4])
        rms = _masked_std(diff, m[..., 0:n4:4] * m[..., 2:n4:4]) \
            / math.sqrt(2.0)
        norm = rms * math.sqrt(bw_tau)
        clean = torch.where(norm[..., None] > 0,
                            (d - base[..., None] - slope[..., None] * a)
                            / torch.clamp(norm, min=1e-30)[..., None], 0.0)
        clean = q(clean)
        del d
        # median-filter high-pass
        mean_tod = (clean * cm[:, None]).sum(-2) / nch     # (B, L)
        med = median_filter(mean_tod, cfg["window"])
        n_t = torch.clamp(tv.sum(), min=1.0)
        m_mean = (med * tv).sum(-1) / n_t
        dm = (med - m_mean[:, None]) * tv
        smm = (dm * dm).sum(-1)
        smd = torch.einsum("bt,bct->bc", dm, clean)
        dmean = (clean * tv).sum(-1) / n_t
        bb = torch.where(smm[:, None] > 1e-20,
                         smd / torch.where(smm > 1e-20, smm, 1.0)[:, None],
                         0.0)
        aa = dmean - bb * m_mean[:, None]
        filt = q((clean - aa[..., None] - bb[..., None] * med[:, None, :])
                 * cm[:, None])
        del clean
        # gain fluctuation and band average
        dg = torch.einsum("bc,bct->t", zp, filt * m) \
            / torch.clamp(zpp, min=1e-20) * tv
        wk = w_ch * (norm / safe_gain)
        t_orig = torch.einsum("bct,bc->bt", filt, wk) / den
        coef = (wk * p.reshape(B, C)).sum(-1)[:, None] / den
        t_clean = t_orig - coef * dg[None, :]
        n2 = L // 2 * 2
        dd = t_clean[:, 1:n2:2] - t_clean[:, 0:n2:2]
        pm = tv[1:n2:2] * tv[0:n2:2]
        var = (dd * dd * pm).sum(-1) / torch.clamp(pm.sum(), min=1.0)
        rms2 = var / 2.0
        w_t = torch.where(rms2 > 0, 1.0 / torch.clamp(rms2, min=1e-30), 0.0)
        out_t[:, s:e] = q(t_clean[:, :n])
        out_w[:, s:e] = q(w_t[:, None].expand(B, n))
    return out_t, out_w
