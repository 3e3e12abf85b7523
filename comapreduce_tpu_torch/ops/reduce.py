"""The Level-1 -> Level-2 reduction of one feed (port of
``comapreduce_tpu/ops/reduce.py``).

Scans are gathered into padded ``(k, B, C, L)`` blocks, ``k`` scans at a
time (``ReduceConfig.scan_batch``; all scans at once when ``None``),
pushed through the chain — NaN fill (kernel K1), atmosphere fit and
radiometer normalisation (kernel K5 on a field observation),
median-filter high-pass (kernel K2), gain solve, band average — as
batched tensor ops, and scattered back onto
the time axis. The reference's per-scan ``vmap`` / ``lax.map`` become
the leading scan-batch axis and a Python loop over batches (a partial
last batch included); the reference's ``vmap`` over a feed batch
(``parallel/sharded.reduce_feeds_sharded``) becomes :func:`reduce_feeds`,
a loop over the batch's feeds on one device.

The HBM planner (``reduce.py:168-485``) is copied as pure arithmetic:
for the same inputs and the same declared capacity it returns what the
reference returns. Only :func:`device_hbm_bytes` reads the device
(``torch.cuda.mem_get_info`` on a CUDA device). Its estimate models the
reference's XLA program (``REDUCE_CHAIN_BLOCKS`` scan blocks per feed of
the batch); the port holds one feed's chain at a time, so its own peak
is measured against that estimate on the card, not fed back into it.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from comapreduce_tpu_torch import _build
from comapreduce_tpu_torch.ops import gain as gain_ops
from comapreduce_tpu_torch.ops.average import edge_channel_mask
from comapreduce_tpu_torch.ops.cuda_median import masked_fill
from comapreduce_tpu_torch.ops.median_filter import medfilt_highpass
from comapreduce_tpu_torch.ops.prefilter import normalise_plain, prefilter
from comapreduce_tpu_torch.ops.stats import masked_median
from comapreduce_tpu_torch.telemetry.core import TELEMETRY

__all__ = ["KERNEL_LIBRARIES", "scan_starts_lengths", "extract_scan_blocks",
           "extract_one_scan", "scatter_scan_blocks", "reduce_feed_scans",
           "reduce_feeds", "ReduceConfig", "estimate_reduce_hbm", "plan_reduce_memory",
           "device_hbm_bytes", "set_device_hbm_override",
           "plan_stage_feed_batch", "stage_feed_batches", "ShapeBuckets",
           "pad_time_axis", "pad_scan_geometry"]

logger = logging.getLogger("comapreduce_tpu_torch")

#: the kernel libraries the reduction launches on the card: K1 (the NaN
#: fill), K2 (the median filter's rolling medians) and K5 (the atmosphere
#: fit and radiometer normalisation), built at once before its first scan
#: batch (one ``nvcc`` each, in parallel, where each first launch would
#: build its own in turn)
KERNEL_LIBRARIES = ("masked_fill", "rolling_median", "prefilter")


def scan_starts_lengths(edges: np.ndarray, pad_to: int = 128):
    """Static scan geometry from host edges: ``(starts, lengths, L_max)``
    with ``L_max`` rounded up to ``pad_to``."""
    edges = np.asarray(edges, dtype=np.int64)
    starts = edges[:, 0]
    lengths = edges[:, 1] - edges[:, 0]
    L = int(lengths.max()) if len(lengths) else pad_to
    L = -(-L // pad_to) * pad_to
    return starts, lengths, L


def _scan_index(starts, L, lengths, T, device):
    starts = torch.as_tensor(starts, dtype=torch.int64, device=device)
    idx = starts[:, None] + torch.arange(L, device=device)[None, :]
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int64, device=device)
        last = starts + torch.clamp(lengths, min=1) - 1
        idx = torch.minimum(idx, last[:, None])
    return torch.clamp(idx, 0, T - 1)


def extract_scan_blocks(x: torch.Tensor, starts, L: int, lengths=None):
    """Gather scans into a padded block: f32[..., T] -> f32[S, ..., L]
    (contiguous). With ``lengths``, each scan's padded tail repeats its
    own last sample; otherwise out-of-range indices clamp to T-1."""
    T = x.shape[-1]
    idx = _scan_index(starts, L, lengths, T, x.device)     # (S, L)
    S = idx.shape[0]
    out = torch.index_select(x, -1, idx.reshape(-1))
    out = out.reshape(x.shape[:-1] + (S, L))
    return torch.movedim(out, -2, 0).contiguous()


def extract_one_scan(x: torch.Tensor, start, L: int, length=None):
    """One scan's padded block: f32[..., T] -> f32[..., L]."""
    lengths = None if length is None else [int(length)]
    return extract_scan_blocks(x, [int(start)], L, lengths)[0]


def scatter_scan_blocks(blocks: torch.Tensor, starts, lengths, T: int,
                        out: torch.Tensor | None = None):
    """Inverse of :func:`extract_scan_blocks`: f32[S, ..., L] ->
    f32[..., T]. Padded samples drop; samples outside every scan stay 0.
    ``out`` (f32[..., T + 1], the last slot a junk bin) accumulates
    successive scan batches in place."""
    S, L = blocks.shape[0], blocks.shape[-1]
    dev = blocks.device
    starts = torch.as_tensor(starts, dtype=torch.int64, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    ar = torch.arange(L, device=dev)[None, :]
    idx = torch.where(ar < lengths[:, None], starts[:, None] + ar,
                      torch.full((), T, dtype=torch.int64, device=dev))
    moved = torch.movedim(blocks, 0, -2)                    # (..., S, L)
    flat = moved.reshape(moved.shape[:-2] + (S * L,))
    if out is None:
        out = torch.zeros(moved.shape[:-2] + (T + 1,), dtype=blocks.dtype,
                          device=dev)
    out.index_copy_(-1, idx.reshape(-1), flat)
    return out[..., :T]


class ReduceConfig:
    """Static knobs of the reduction (``reduce.py:111``); value-hashable.

    The four channel masks are f32[C] CPU tensors; the chain moves them
    to the data's device where it uses them."""

    def _key(self):
        return (self.n_channels, self.medfilt_window, self.medfilt_stride,
                self.is_calibrator, self.bandwidth, self.tau,
                self.scan_batch)

    def __eq__(self, other):
        return type(other) is ReduceConfig and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __init__(self, n_channels: int, medfilt_window: int = 6000,
                 is_calibrator: bool = False,
                 bandwidth: float | None = None, tau: float = 1.0 / 50.0,
                 medfilt_stride: int | None = None,
                 scan_batch: int | None = None):
        c = n_channels

        def s(n):
            return max(int(round(n * c / 1024.0)), 1)
        self.n_channels = c
        self.medfilt_window = medfilt_window
        self.medfilt_stride = medfilt_stride
        self.scan_batch = scan_batch
        self.is_calibrator = is_calibrator
        self.bandwidth = bandwidth if bandwidth is not None else 2e9 / c
        self.tau = tau
        self.mask_weights = edge_channel_mask(c, s(10), s(2), s(3))
        self.mask_band_avg = edge_channel_mask(c, s(50), 0, s(1))
        self.mask_medfilt = edge_channel_mask(c, s(10), s(5), s(6))
        self.mask_templates = edge_channel_mask(c, s(20), s(5), s(5))


# ``fill_bad_data``: masked samples take the per-channel stride-4 masked
# median (masked-mean fallback) — kernel K1 on the card
_fill_bad = masked_fill


def _prefilter_chain(d_s, m_s, a_s, cfg: ReduceConfig):
    """NaN fill -> atmosphere (field) or median (calibrator) removal ->
    radiometer normalisation (``reduce.py:550``). ``d_s``/``m_s``:
    f32[..., B, C, L] (``m_s`` already time-masked); ``a_s``: f32[..., L].
    Returns ``(clean, norm, atmos_fit)``. Spans: ``reduce.fill`` (K1),
    ``reduce.atmosphere`` (field: the fit, the pair std, ``norm`` and
    ``clean``, kernel K5 on the card; calibrator: the masked median),
    ``reduce.normalise`` (field: the outputs split and the fit stacked;
    calibrator: the rms, ``norm``, ``clean``)."""
    span = TELEMETRY.span
    bandwidth_tau = cfg.bandwidth * cfg.tau
    with span("reduce.fill"):
        d_s = d_s.to(torch.float32)
        d_s = _fill_bad(d_s, m_s)
    with span("reduce.atmosphere"):
        if cfg.is_calibrator:
            med = masked_median(d_s, m_s, axis=-1)         # (..., B, C)
            slope = torch.zeros_like(med)
        else:
            clean, stats = prefilter(d_s, m_s, a_s, bandwidth_tau)
    with span("reduce.normalise"):
        if cfg.is_calibrator:
            clean, norm = normalise_plain(d_s, m_s, a_s, med, slope,
                                          bandwidth_tau)
            atmos_fit = torch.stack([med, slope], dim=-2)  # (..., B, 2, C)
        else:
            base, slope, norm = stats.unbind(0)
            atmos_fit = torch.stack([base, slope], dim=-2)
    return clean, norm.unsqueeze(-1), atmos_fit


def _postfilter_chain(filtered, m_s, tv, norm, tsys, sys_gain, freq_scaled,
                      cfg: ReduceConfig):
    """Gain solve + counts -> kelvin band averages (``reduce.py:608``).
    ``filtered``/``m_s``: f32[..., B, C, L]; ``tv``: f32[..., L];
    ``norm``: f32[..., B, C, 1]. Returns ``(tod_clean, tod_orig, weights,
    dg)`` with the first three f32[..., B, L] and ``dg`` f32[..., L].
    Spans: ``reduce.gain`` (templates, gain solve), ``reduce.average``
    (band average, weights)."""
    span = TELEMETRY.span
    with span("reduce.gain"):
        filtered = filtered.to(torch.float32)
        dev = filtered.device
        B, C, L = filtered.shape[-3:]
        T2, p = gain_ops.build_templates(
            tsys, freq_scaled,
            cfg.mask_templates.to(dev)[None, :]
            * torch.ones((B, 1), device=dev))
        if cfg.is_calibrator:
            dg = torch.zeros(filtered.shape[:-3] + (L,),
                             dtype=filtered.dtype, device=dev)
        else:
            dg = gain_ops.solve_gain(filtered * m_s, T2, p, time_mask=tv)
    with span("reduce.average"):
        zero = torch.zeros((), dtype=filtered.dtype, device=dev)
        w_tsys = torch.where(tsys > 0,
                             1.0 / torch.clamp(tsys, min=1e-10) ** 2, zero)
        w = (w_tsys * cfg.mask_weights.to(dev)[None, :]
             * cfg.mask_band_avg.to(dev)[None, :])
        safe_gain = torch.where(sys_gain > 0, sys_gain, zero + 1.0)
        kelvin = norm[..., 0] / safe_gain                   # (..., B, C)
        wk = w * kelvin
        den = torch.clamp(w.sum(dim=-1), min=1e-30).unsqueeze(-1)  # (B, 1)
        tod_orig = torch.einsum("...ct,...c->...t", filtered, wk) / den
        coef = (wk * p.reshape(B, C)).sum(dim=-1).unsqueeze(-1) / den
        tod_clean = tod_orig - coef * dg.unsqueeze(-2)      # (..., B, L)

        n2 = L // 2 * 2
        diff = tod_clean[..., 1:n2:2] - tod_clean[..., 0:n2:2]
        pm = (tv[..., 1:n2:2] * tv[..., 0:n2:2]).unsqueeze(-2)
        var = (diff * diff * pm).sum(dim=-1) / torch.clamp(pm.sum(dim=-1),
                                                            min=1.0)
        rms2 = var / 2.0
        w_t = torch.where(rms2 > 0, 1.0 / torch.clamp(rms2, min=1e-30),
                          zero)
        tvb = tv.unsqueeze(-2)
        weights = w_t.unsqueeze(-1) * tvb
        return tod_clean * tvb, tod_orig * tvb, weights, dg


def reduce_feed_scans(tod, mask, airmass, starts, lengths, tsys, sys_gain,
                      freq_scaled, cfg: ReduceConfig, n_scans: int, L: int,
                      fold_len=None):
    """Full reduction of one feed's observation (``reduce.py:667``).

    ``tod``: f32[B, C, T] raw counts on the device the chain runs on.
    ``mask``: validity broadcastable to [B, C, T] (e.g. a time mask
    f32[T]), or ``None``: validity is then ``isfinite(tod)`` and ``tod``
    is NaN-filled. ``airmass``: f32[T]. ``starts``/``lengths``: host
    scan geometry of ``n_scans`` scans. ``tsys``/``sys_gain``/
    ``freq_scaled``: f32[B, C]. ``fold_len``: optional symmetric
    reflection length of the median filter.

    Returns a dict with ``tod``, ``tod_original``, ``weights``
    (f32[B, T]), ``dg`` (f32[S, L]) and ``atmos_fits`` (f32[S, B, 2, C]).

    Spans: a ``reduce.batch`` (scans) a scan batch, around ``reduce.
    extract``, the chains' ``reduce.fill`` to ``reduce.normalise``,
    ``reduce.medfilt`` (K2), ``reduce.gain``, ``reduce.average`` and
    ``reduce.scatter``.
    """
    B, C, T = tod.shape
    dev = tod.device
    if dev.type == "cuda":
        _build.build(KERNEL_LIBRARIES)
    tod = tod.to(torch.float32)
    if mask is None:
        mask = torch.isfinite(tod).to(tod.dtype)
        tod = torch.nan_to_num(tod)
    mask = mask.to(torch.float32)
    starts = np.asarray(starts, dtype=np.int64)[:n_scans]
    lengths = np.asarray(lengths, dtype=np.int64)[:n_scans]
    t_valid = (torch.arange(L, device=dev)[None, :]
               < torch.as_tensor(lengths, device=dev)[:, None]
               ).to(torch.float32)
    k = n_scans if cfg.scan_batch is None or cfg.scan_batch >= n_scans \
        else max(int(cfg.scan_batch), 1)
    mfilt = cfg.mask_medfilt.to(dev)[None, :] * torch.ones((B, 1),
                                                            device=dev)
    outs = [torch.zeros((B, T + 1), dtype=torch.float32, device=dev)
            for _ in range(3)]
    dgs, atms = [], []
    m_lead = (1,) * (3 - mask.ndim)       # mask axes -> (B, C) alignment
    span = TELEMETRY.span
    for s0 in range(0, n_scans, k):
        sl = slice(s0, min(s0 + k, n_scans))
        with span("reduce.batch", scans=sl.stop - sl.start):
            with span("reduce.extract"):
                d = extract_scan_blocks(tod, starts[sl], L, lengths[sl])
                m = extract_scan_blocks(mask, starts[sl], L)
                m = m.reshape(m.shape[:1] + m_lead + m.shape[1:])
                a = extract_scan_blocks(airmass.to(torch.float32),
                                        starts[sl], L, lengths[sl])  # (k, L)
                tv = t_valid[sl]
                m_s = torch.broadcast_to(m, d.shape) * tv[:, None, None, :]
            clean, norm, atmos_fit = _prefilter_chain(d, m_s, a, cfg)
            del d
            with span("reduce.medfilt"):
                filtered, _ = medfilt_highpass(clean, mfilt,
                                               cfg.medfilt_window,
                                               time_mask=tv,
                                               stride=cfg.medfilt_stride,
                                               fold_len=fold_len)
            del clean
            tod_c, tod_o, wts, dg = _postfilter_chain(
                filtered, m_s, tv, norm, tsys, sys_gain, freq_scaled, cfg)
            with span("reduce.scatter"):
                for o, blk in zip(outs, (tod_c, tod_o, wts)):
                    scatter_scan_blocks(blk, starts[sl], lengths[sl], T,
                                        out=o)
            dgs.append(dg)
            atms.append(atmos_fit)
    return {
        "tod": outs[0][:, :T],
        "tod_original": outs[1][:, :T],
        "weights": outs[2][:, :T],
        "dg": torch.cat(dgs) if dgs else torch.zeros((0, L), device=dev),
        "atmos_fits": torch.cat(atms) if atms else torch.zeros(
            (0, B, 2, C), device=dev),
    }


def reduce_feeds(tod, airmass, starts, lengths, tsys, sys_gain, freq_scaled,
                 cfg: ReduceConfig, L: int | None = None, fold_len=None):
    """:func:`reduce_feed_scans` over a feed batch with ``mask=None``
    (the single-device form of ``sharded.reduce_feeds_sharded``, :99).

    ``tod``: f32[f, B, C, T] NaN-carrying raw counts (validity derived
    on the device); ``airmass`` f32[f, T]; ``tsys``/``sys_gain``
    f32[f, B, C]; ``starts``/``lengths`` the shared host scan geometry;
    ``freq_scaled`` f32[B, C]. ``L`` defaults to the geometry's padded
    block length; ``fold_len`` is the median filter's reflection length
    (the campaign padding hook). Feeds run one after another, so the
    device holds one feed's chain at a time. Returns the dict of
    :func:`reduce_feed_scans` with a leading feed axis."""
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if L is None:
        _, _, L = scan_starts_lengths(np.stack([starts, starts + lengths],
                                               axis=1))
    outs = [reduce_feed_scans(tod[i], None, airmass[i], starts, lengths,
                              tsys[i], sys_gain[i], freq_scaled, cfg=cfg,
                              n_scans=len(starts), L=int(L),
                              fold_len=fold_len)
            for i in range(tod.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# Simultaneous (B, C, L)-sized working blocks of the reference's per-scan
# chain at peak: the envelope behind the HBM planner (``reduce.py:159``)
REDUCE_CHAIN_BLOCKS = 6


def estimate_reduce_hbm(feed_batch: int, B: int, C: int, T: int,
                        n_scans: int, L: int, scan_batch: int | None = None,
                        dense_mask: bool = False) -> int:
    """Estimated peak bytes of one feed-batched reduction program
    (``reduce.py:168``): per feed the raw f32[B, C, T] counts (twice with
    a dense mask) plus ``REDUCE_CHAIN_BLOCKS`` f32[B, C, L] blocks per
    scan materialised at once."""
    unit_T = B * C * T * 4
    blk = B * C * L * 4
    k = n_scans if (scan_batch is None or scan_batch >= n_scans) \
        else max(int(scan_batch), 1)
    inputs = unit_T * (2 if dense_mask else 1)
    return int(feed_batch) * (inputs + REDUCE_CHAIN_BLOCKS * k * blk)


# [tuning] device_hbm_mb: the declared-capacity override (0 = unset)
_HBM_OVERRIDE_BYTES = 0
_HBM_DEFAULT_WARNED = False


def set_device_hbm_override(n_bytes: int) -> None:
    """Install (or clear, with 0) the declared-capacity override that
    :func:`device_hbm_bytes` consults; clearing re-arms the warning."""
    global _HBM_OVERRIDE_BYTES, _HBM_DEFAULT_WARNED
    _HBM_OVERRIDE_BYTES = max(int(n_bytes), 0)
    if not _HBM_OVERRIDE_BYTES:
        _HBM_DEFAULT_WARNED = False


def device_hbm_bytes(default: int = 16 << 30, device=None) -> int:
    """Device memory the planners budget against (``reduce.py:211``).

    ``COMAP_HBM_BYTES`` wins, then the declared override, then the
    card's total memory (``torch.cuda.mem_get_info``) for a CUDA
    ``device`` (``None``: the current card when one is present). A CPU
    device reports none: ``default`` (16 GiB), warned once per process
    because every planner then plans against a guess."""
    global _HBM_DEFAULT_WARNED
    env = os.environ.get("COMAP_HBM_BYTES", "")
    if env:
        return int(env)
    if _HBM_OVERRIDE_BYTES:
        return _HBM_OVERRIDE_BYTES
    dev = (torch.device("cuda") if device is None
           and torch.cuda.is_available() else torch.device(device or "cpu"))
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    if not _HBM_DEFAULT_WARNED:
        _HBM_DEFAULT_WARNED = True
        logger.warning(
            "device_hbm_bytes: %s reports no device memory; assuming the "
            "%.0f GiB default for every planner. Set COMAP_HBM_BYTES to "
            "plan against a real part.", dev, default / 2**30)
    return default


def plan_reduce_memory(feed_batch: int, B: int, C: int, T: int,
                       n_scans: int, L: int, scan_batch: int | None,
                       hbm_bytes: int | None = None,
                       dense_mask: bool = False,
                       headroom: float = 0.9,
                       suggest_scale: int = 1) -> int | None:
    """The reduction's scan streaming checked (and auto-picked) against
    the memory budget (``reduce.py:255``): returns the ``scan_batch`` to
    use (an explicit value is an upper bound; ``None`` = all scans when
    that fits), preferring divisors of ``n_scans``; raises
    ``ValueError`` naming a ``feed_batch`` that fits when no streaming
    rescues the requested one."""
    budget = int((hbm_bytes or device_hbm_bytes()) * headroom)

    def fits(k):
        return estimate_reduce_hbm(feed_batch, B, C, T, n_scans, L,
                                   scan_batch=k,
                                   dense_mask=dense_mask) <= budget

    if fits(scan_batch):
        return scan_batch
    top = n_scans if scan_batch is None else min(int(scan_batch), n_scans)
    for k in (k for k in range(top - 1, 0, -1) if n_scans % k == 0):
        if fits(k):
            return k
    per_feed = estimate_reduce_hbm(1, B, C, T, n_scans, L, scan_batch=1,
                                   dense_mask=dense_mask)
    fb_ok = max(budget // max(per_feed, 1), 0)
    raise ValueError(
        f"reduction batch does not fit device memory: feed_batch="
        f"{feed_batch} feeds/device at shape (B={B}, C={C}, T={T}, "
        f"S={n_scans}, L={L}) needs "
        f"~{estimate_reduce_hbm(feed_batch, B, C, T, n_scans, L, 1, dense_mask) / 2**30:.1f} GiB "
        f"even streaming one scan at a time; budget is "
        f"{budget / 2**30:.1f} GiB. Set feed_batch="
        f"{max(fb_ok, 1) * max(suggest_scale, 1)}"
        + ("" if fb_ok else " and a smaller medfilt/scan geometry")
        + " (stage option feed_batch=).")


# per-feed working blocks of the feed-batched stage programs
# (``reduce.py:313``)
STAGE_CHAIN_BLOCKS = 3


def plan_stage_feed_batch(F: int, B: int, C: int, T: int,
                          requested: int = 0, n_arrays: int = 1,
                          hbm_bytes: int | None = None,
                          headroom: float = 0.9) -> int:
    """Largest feed chunk of a whole-observation stage pass that fits
    the budget (``reduce.py:316``): ``n_arrays`` resident f32[B, C, T]
    arrays per feed plus ``STAGE_CHAIN_BLOCKS`` raw-sized blocks of one
    feed; ``requested`` > 0 is an upper bound; always >= 1. On the auto
    path (``requested`` 0) a measured ``[tuning]`` winner for this
    ``(F, B, C, T)`` bucket becomes the bound (the fit still caps it)."""
    budget = int((hbm_bytes or device_hbm_bytes()) * headroom)
    unit = B * C * T * 4 * max(int(n_arrays), 1)
    work = STAGE_CHAIN_BLOCKS * B * C * T * 4
    fit = max((budget - work) // max(unit, 1), 1)
    if not requested:
        from comapreduce_tpu_torch.tuning.cache import TUNING

        if TUNING.enabled:
            from comapreduce_tpu_torch.tuning.space import stage_bucket

            win = TUNING.winner("stage",
                                stage_bucket(F, B, C, T, n_arrays))
            if win and win.get("feed_batch"):
                requested = int(win["feed_batch"])
    fb = F if not requested else min(int(requested), F)
    return int(max(min(fb, fit), 1))


def stage_feed_batches(F: int, B: int, C: int, T: int,
                       requested: int = 0, n_arrays: int = 1,
                       hbm_bytes: int | None = None) -> list[list[int]]:
    """Feed-index chunks for one whole-observation stage pass, sized by
    :func:`plan_stage_feed_batch`."""
    fb = plan_stage_feed_batch(F, B, C, T, requested=requested,
                               n_arrays=n_arrays, hbm_bytes=hbm_bytes)
    return [list(range(i, min(i + fb, F))) for i in range(0, F, fb)]


class ShapeBuckets:
    """Campaign shape canonicalisation (``reduce.py:368``): each of
    ``(T, S, L)`` rounds UP to its quantum (0 leaves the axis exact).
    The padded time tail ships as NaN (zero validity), padded scans have
    length 0, and ``L`` may exceed the longest scan. Value-hashable."""

    def __init__(self, t_quantum: int = 0, scan_quantum: int = 0,
                 l_quantum: int = 0):
        self.t_quantum = max(int(t_quantum or 0), 0)
        self.scan_quantum = max(int(scan_quantum or 0), 0)
        self.l_quantum = max(int(l_quantum or 0), 0)

    def _key(self):
        return (self.t_quantum, self.scan_quantum, self.l_quantum)

    def __eq__(self, other):
        return (type(other) is ShapeBuckets and
                self._key() == other._key())

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"ShapeBuckets(t_quantum={self.t_quantum}, "
                f"scan_quantum={self.scan_quantum}, "
                f"l_quantum={self.l_quantum})")

    @property
    def enabled(self) -> bool:
        return bool(self.t_quantum or self.scan_quantum or self.l_quantum)

    @staticmethod
    def _up(n: int, q: int) -> int:
        return int(n) if q <= 0 or n <= 0 else -(-int(n) // q) * q

    def round_T(self, T: int) -> int:
        return self._up(T, self.t_quantum)

    def round_S(self, S: int) -> int:
        return self._up(S, self.scan_quantum)

    def round_L(self, L: int) -> int:
        return self._up(L, self.l_quantum)

    def canonical(self, T: int, S: int, L: int) -> tuple:
        """The bucket ``(T, S, L)`` falls in."""
        return (self.round_T(T), self.round_S(S), self.round_L(L))

    def overhead_bound(self, T: int, S: int, L: int) -> float:
        """Upper bound on the fractional sample-count overhead of
        padding ``(T, S, L)`` to its bucket."""
        Tb, Sb, Lb = self.canonical(T, S, L)
        raw = max(T, 1) * max(S, 1) * max(L, 1)
        return (Tb * max(Sb, 1) * max(Lb, 1)) / raw - 1.0

    @classmethod
    def coerce(cls, value) -> "ShapeBuckets":
        """None / dict / ShapeBuckets -> ShapeBuckets (``None`` is the
        disabled identity policy)."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            known = {k: value[k] for k in
                     ("t_quantum", "scan_quantum", "l_quantum")
                     if k in value}
            unknown = set(value) - set(known)
            if unknown:
                raise ValueError(
                    f"unknown shape-bucket keys: {sorted(unknown)}")
            return cls(**known)
        raise TypeError(f"cannot build ShapeBuckets from {type(value)}")


def pad_time_axis(x: np.ndarray, n_to: int,
                  fill: str = "nan") -> np.ndarray:
    """Pad a host array's trailing (time) axis up to ``n_to`` samples:
    ``'nan'`` (invalid tail), ``'edge'`` (repeat the last sample, for
    operands that multiply into masked sums) or ``'zero'`` (masks)."""
    n = int(x.shape[-1])
    n_to = int(n_to)
    if n_to <= n:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n_to - n)]
    if fill == "edge":
        return np.pad(x, pad, mode="edge")
    if fill == "zero":
        return np.pad(x, pad)
    return np.pad(x, pad, constant_values=np.nan)


def pad_scan_geometry(starts: np.ndarray, lengths: np.ndarray,
                      n_to: int):
    """Pad scan ``starts``/``lengths`` up to ``n_to`` scans with
    zero-length scans at start 0 (all-masked)."""
    S = len(starts)
    n_to = int(n_to)
    if n_to <= S:
        return starts, lengths
    z = np.zeros(n_to - S, dtype=np.asarray(starts).dtype)
    return (np.concatenate([np.asarray(starts), z]),
            np.concatenate([np.asarray(lengths),
                            np.zeros(n_to - S,
                                     np.asarray(lengths).dtype)]))
