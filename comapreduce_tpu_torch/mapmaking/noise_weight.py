"""Measured-noise banded offset weighting (port of
``comapreduce_tpu/mapmaking/noise_weight.py``; numpy only, copied so the
port imports nothing of the reference).

The destriper's normal operator ``F^T W Z F`` treats the offset
amplitudes as free parameters, the maximum-likelihood solution under
white noise only. The MADAM / MAPPRAISER destriping prior adds the
measured correlated noise:

    A' = F^T W Z F + C_a^{-1}

with ``C_a`` the offset-amplitude covariance implied by each
(file, feed, band)'s 1/f noise model. ``C_a`` is Toeplitz within one
(file, feed) group, so its inverse is close to a banded symmetric
matrix: this module assembles that band per group from measured
``white_sigma / fknee_hz / alpha`` fits and hands
:func:`~comapreduce_tpu_torch.mapmaking.destriper.destripe_planned`'s
``banded=`` the ``(c0, cs)`` storage its CG matvec applies in
O(q n_off).

Layout: ``c0`` f32[n_off] is the prior's diagonal, exactly 0.0 on
white-fallback groups and padding offsets; ``cs`` f32[q, n_off] holds
the upper bands, ``cs[j-1, i] = B[i, i+j]``, zeroed wherever ``i`` and
``i+j`` straddle a (file, feed) group boundary or a shard boundary.
Each group's band is strictly diagonally dominant
(``sum_j 2 |b_j| <= 0.95 b_0``), so the prior is SPD and
``lambda(D^{-1}(A+B)) <= 2`` still holds for the multigrid smoother.
Every fallback is reported: the (file, feed) that kept white weighting
and why (``absent | flagged | bad_fit | fknee_low``).

The functions and their numpy calls are the reference's, in the same
order, so the outputs are bitwise equal.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["build_banded_weight", "stack_banded", "quality_index"]

# fraction of the diagonal the off-diagonal row sum may reach — strict
# diagonal dominance margin (see module docstring)
_DOMINANCE = 0.95


def quality_index(records: list, band: int) -> dict:
    """``{(file_basename, feed): record}`` for one band from
    quality-ledger records (the reference's ``telemetry.quality.
    read_quality`` output, already latest-wins per (file, feed, band))."""
    out = {}
    for rec in records:
        try:
            if int(rec.get("band", -1)) != int(band):
                continue
            key = (os.path.basename(str(rec.get("file", ""))),
                   int(rec.get("feed", -1)))
        except (TypeError, ValueError):
            continue
        out[key] = rec
    return out


def _band_coefficients(white_sigma: float, fknee_hz: float, alpha: float,
                       f_off: float, n_grid: int, bandwidth: int,
                       prior_scale: float) -> np.ndarray | None:
    """Toeplitz band ``[b_0, b_1, ..., b_q]`` of the inverse offset
    covariance for one stationary 1/f model, or ``None`` when the model
    carries no usable correlated power at the offset rate.

    The offset sequence is treated as a discrete series at rate
    ``f_off = fs / L`` whose correlated PSD is the measured red part
    ``sigma^2 (f / fknee)^alpha`` (per-sample convention — the white
    part already lives in ``F^T W F``). The inverse spectrum
    ``1 / P_a`` is sampled on an ``n_grid``-point rfft grid and
    inverse-transformed; lags past ``bandwidth`` are dropped and the
    rest rescaled for strict diagonal dominance (SPD by Gershgorin —
    exactness matters less than definiteness for a prior).
    """
    f_min = f_off / n_grid
    if not (white_sigma > 0 and fknee_hz > 0 and np.isfinite(alpha)
            and alpha < 0):
        return None
    if fknee_hz <= f_min:
        # the knee sits below the lowest represented offset-rate
        # frequency: correlated power < white everywhere in band — the
        # prior would be numerically void; keep white weighting
        return None
    freqs = np.fft.rfftfreq(n_grid, d=1.0 / f_off)
    f = np.maximum(freqs, f_min)          # clamp the DC bin
    p_a = (white_sigma ** 2) * (f / fknee_hz) ** alpha
    inv_p = 1.0 / np.maximum(p_a, 1e-300)
    row = np.fft.irfft(inv_p, n=n_grid)
    b = row[: bandwidth + 1].astype(np.float64) * float(prior_scale)
    if not (b[0] > 0 and np.isfinite(b).all()):
        return None
    off_sum = 2.0 * np.abs(b[1:]).sum()
    limit = _DOMINANCE * b[0]
    if off_sum > limit:
        b[1:] *= limit / off_sum
    return b


def build_banded_weight(groups: list, quality: list, n_offsets: int,
                        offset_length: int, band: int = 0,
                        bandwidth: int = 4, n_grid: int = 512,
                        n_shards: int = 1,
                        prior_scale: float = 1.0):
    """Assemble the ``(c0, cs)`` banded prior for one band's solve.

    Parameters
    ----------
    groups : ``DestriperData.groups`` — per ground-id group metadata
        ``{"file", "feed", "sample_rate", "n_samples"}`` in
        concatenation order (each group owns whole offsets; the data
        layer truncates scans to offset multiples).
    quality : quality-ledger records (the reference's
        ``telemetry.quality.read_quality`` output; any bands, filtered
        here).
    n_offsets : TOTAL offset count of the solve vector — the PADDED
        global count on sharded runs (``pad_for_shards`` quantum), so
        padding offsets land beyond every group and stay zero.
    offset_length, band : solve geometry / which band's fits to join.
    bandwidth : half-bandwidth ``q`` of the stored prior (lags 1..q).
    n_grid : rfft grid size for the inverse-spectrum transform.
    n_shards : zero couplings across ``n_offsets / n_shards``
        boundaries so a sharded apply needs no halo exchange.
    prior_scale : overall multiplier on the prior (A/B runs).

    Returns ``(banded, report)``: ``banded`` is ``(c0, cs)`` float32
    arrays of shape ``(n_offsets,)`` / ``(bandwidth, n_offsets)``, or
    ``None`` when EVERY group fell back to white (callers then omit the
    kwarg entirely — the white-weight solve, exact parity).
    ``report`` is ``{"banded": n, "white": n, "fallbacks": [{"file",
    "feed", "reason"}, ...]}`` with one entry per white group —
    ``reason`` one of ``absent | flagged | bad_fit | fknee_low``.
    """
    L = int(offset_length)
    n_off = int(n_offsets)
    q = max(int(bandwidth), 1)
    qidx = quality_index(quality, band)
    c0 = np.zeros(n_off, np.float64)
    cs = np.zeros((q, n_off), np.float64)
    report = {"banded": 0, "white": 0, "fallbacks": []}

    def fallback(g, reason):
        report["white"] += 1
        report["fallbacks"].append({"file": g.get("file", "?"),
                                    "feed": int(g.get("feed", -1)),
                                    "reason": reason})

    o0 = 0
    for g in groups:
        ng = int(g.get("n_samples", 0)) // L
        if ng <= 0:
            continue
        o1 = min(o0 + ng, n_off)
        rec = qidx.get((os.path.basename(str(g.get("file", ""))),
                        int(g.get("feed", -1))))
        if rec is None:
            fallback(g, "absent")
        elif rec.get("flagged"):
            fallback(g, "flagged")
        else:
            try:
                sig = float(rec.get("white_sigma") or 0.0)
                fk = float(rec.get("fknee_hz") or 0.0)
                al = float(rec.get("alpha")
                           if rec.get("alpha") is not None else np.nan)
            except (TypeError, ValueError):
                sig, fk, al = 0.0, 0.0, np.nan
            fs = float(g.get("sample_rate", 50.0))
            f_off = fs / L if fs > 0 else 1.0 / L
            b = _band_coefficients(sig, fk, al, f_off, int(n_grid), q,
                                   prior_scale)
            if b is None:
                reason = ("fknee_low"
                          if (sig > 0 and fk > 0 and np.isfinite(al)
                              and al < 0) else "bad_fit")
                fallback(g, reason)
            else:
                report["banded"] += 1
                c0[o0:o1] = b[0]
                for j in range(1, q + 1):
                    if j < len(b) and o1 - j > o0:
                        # cs[j-1, i] couples i and i+j: the last j
                        # offsets of the group couple into the next
                        # group and stay zero
                        cs[j - 1, o0:o1 - j] = b[j]
        o0 += ng
    if report["banded"] == 0:
        return None, report
    # shard-boundary zeroing: offsets i and i+j in different shards
    # must not couple (each shard owns a contiguous n_off/n_shards run)
    ns = max(int(n_shards), 1)
    if ns > 1:
        if n_off % ns:
            raise ValueError(f"n_offsets={n_off} not divisible by "
                             f"n_shards={ns} — pass the padded global "
                             "offset count (pad_for_shards quantum)")
        per = n_off // ns
        idx = np.arange(n_off)
        for j in range(1, q + 1):
            cross = (idx // per) != ((idx + j) // per)
            cs[j - 1, cross] = 0.0
    return (c0.astype(np.float32), cs.astype(np.float32)), report


def stack_banded(banded_list: list):
    """Stack per-band ``(c0, cs)`` priors (some possibly ``None``) into
    ONE multi-RHS operand with a leading band axis — ``None`` entries
    become zero blocks (white weighting for that band). Returns ``None``
    when every band is ``None`` (callers then omit the kwarg — the
    multi-RHS analogue of the single-band exact-parity rule)."""
    if all(b is None for b in banded_list):
        return None
    shapes = [np.asarray(b[0]).shape[-1] for b in banded_list
              if b is not None]
    qs = [np.asarray(b[1]).shape[-2] for b in banded_list
          if b is not None]
    n_off, q = shapes[0], qs[0]
    if any(s != n_off for s in shapes) or any(x != q for x in qs):
        raise ValueError("per-band banded priors disagree on geometry")
    c0s, css = [], []
    for b in banded_list:
        if b is None:
            c0s.append(np.zeros(n_off, np.float32))
            css.append(np.zeros((q, n_off), np.float32))
        else:
            c0s.append(np.asarray(b[0], np.float32))
            css.append(np.asarray(b[1], np.float32))
    return np.stack(c0s), np.stack(css)
