"""Plain destriper: offsets of ``offset_length`` samples solved by
Jacobi-preconditioned conjugate gradients (COMAPreduce
``MapMaking/Destriper.py``: ``cgm`` at :85-152, ``run_destriper`` at
:456-503), bands as independent right-hand sides of one pointing.

The system is ``A a = b`` with ``A a = F^T W (F a - P m(F a))``,
``m(v) = (P^T W P)^{-1} P^T W v``, ``b = F^T W (d - P m(d))``: F spreads
each offset over its samples, P reads a sample's pixel, W weights. The
Jacobi diagonal is ``diag(A) = sum_s w_s - sum_(o,p) w_op^2 / W_p``
(``w_op`` the weight an offset puts on a pixel), falling back to
``sum_s w_s`` where that is under 1e-6 of it and to 1 on an unweighted
offset. The loop stops when every band's ``|r|^2 <= threshold^2
|b|^2`` or after ``n_iter`` iterations; a band whose ``p.Ap`` is not
positive stops moving. Every sum is a pixel or offset binning of the
samples (``index_add_``), worked out here from the pixel stream.
"""

from __future__ import annotations

import torch

from benchmark.reference import precision


def destripe(tod, weights, pixels, npix: int, offset_length: int,
             n_iter: int, threshold: float, prec: str = "f64") -> dict:
    """``tod``/``weights``: [R, N] (R bands of one pointing), ``pixels``
    i64[N] (outside ``[0, npix)``: no pixel), N a multiple of
    ``offset_length``. Returns ``offsets`` [R, N/L], ``map``,
    ``naive``, ``weight`` [R, npix], ``hits`` [npix] and ``n_iter``."""
    dt, q = precision(prec)
    dev = tod.device
    R, N = tod.shape
    L = int(offset_length)
    n_off = N // L
    d = q(tod.to(dt))
    w = q(weights.to(dt))
    valid = (pixels >= 0) & (pixels < npix)
    pv = torch.where(valid, pixels, torch.full_like(pixels, npix))

    def to_pix(v):
        out = torch.zeros((R, npix + 1), dtype=dt, device=dev)
        out.index_add_(1, pv, v)
        return out[:, :npix]

    def off_sum(v):
        return v.reshape(R, n_off, L).sum(-1)

    def spread(a):
        return a.unsqueeze(-1).expand(R, n_off, L).reshape(R, N)

    def read(m):
        mm = torch.cat([m, torch.zeros((R, 1), dtype=dt, device=dev)], 1)
        return mm[:, pv]

    sum_w = q(to_pix(w))
    inv_sw = torch.where(sum_w > 0, 1.0 / torch.where(sum_w > 0, sum_w,
                                                       1.0), 0.0)

    def to_map(v):
        return to_pix(w * v) * inv_sw

    m_d = q(to_map(d))
    b = q(off_sum(w * (d - read(m_d))))

    def matvec(a):
        fa = spread(a)
        return off_sum(w * (fa - read(q(to_map(fa)))))

    # Jacobi: the weight each offset puts on each pixel, binned by the
    # (offset, pixel) pairs the stream visits
    key = (torch.arange(N, device=dev) // L) * (npix + 1) + pv
    uk, inv = torch.unique(key, return_inverse=True)
    pair_w = torch.zeros((R, uk.numel()), dtype=dt, device=dev)
    pair_w.index_add_(1, inv, w)
    pair_pix = uk % (npix + 1)
    pair_off = uk // (npix + 1)
    isw = torch.cat([inv_sw, torch.zeros((R, 1), dtype=dt, device=dev)],
                    1)[:, pair_pix]
    corr = torch.zeros((R, n_off), dtype=dt, device=dev)
    corr.index_add_(1, pair_off, pair_w * pair_w * isw)
    fwf = off_sum(w)
    diag = fwf - corr
    safe = torch.where(diag > 1e-6 * torch.clamp(fwf, min=1e-30), diag,
                       torch.where(fwf > 0, fwf, torch.ones_like(fwf)))
    inv_diag = q(1.0 / safe)

    def dot(u, v):
        return (u * v).sum(-1)

    b_norm = dot(b, b)
    tol = threshold ** 2 * torch.clamp(b_norm, min=1e-30)
    x = torch.zeros_like(b)
    r = b
    rr = dot(r, r)
    z = q(inv_diag * r)
    p = z
    rz = dot(r, z)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    k = 0
    while k < n_iter and bool((~done & (rr > tol)).any()):
        qv = matvec(p)
        pq = dot(p, qv)
        ok = torch.isfinite(pq) & (pq > 0) & ~done
        alpha = torch.where(ok, rz / torch.where(ok, pq, 1.0), 0.0)
        x_new = q(x + alpha[:, None] * p)
        r_new = q(r - alpha[:, None] * qv)
        z_new = q(inv_diag * r_new)
        rz_new = dot(r_new, z_new)
        rr_new = dot(r_new, r_new)
        ok = ok & torch.isfinite(rz_new) & torch.isfinite(rr_new)
        beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        p_new = q(z_new + beta[:, None] * p)
        o = ok[:, None]
        x = torch.where(o, x_new, x)
        r = torch.where(o, r_new, r)
        p = torch.where(o, p_new, p)
        rz = torch.where(ok, rz_new, rz)
        rr = torch.where(ok, rr_new, rr)
        done = done | ~ok
        k += 1
    hits = torch.bincount(pv, minlength=npix + 1)[:npix]
    return {"offsets": x, "map": q(to_map(d - spread(x))), "naive": m_d,
            "weight": sum_w, "hits": hits, "n_iter": k}
