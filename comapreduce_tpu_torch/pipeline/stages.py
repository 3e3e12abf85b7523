"""Pipeline stages: the ``PipelineFunction`` contract over the port's ops
(port of ``comapreduce_tpu/pipeline/stages.py``).

Each stage is a small dataclass: ``__call__(data, level2) -> STATE``,
``groups`` (its output groups, which drive the runner's resume test) and
``save_data`` (``(datasets, attributes)`` that ``COMAPLevel2.update``
deposits). Stages read the Level-1 store on the host, run their device
work on ``device`` (set by the :class:`~.runner.Runner`; ``None`` is
the card, as for every entry point of the port) and hand numpy arrays to
the Level-2 store.

Ported stages: ``CheckLevel1File``, ``AssignLevel1Data``,
``MeasureSystemTemperature``, ``AtmosphereRemoval``,
``Level1Averaging``, ``Level1AveragingGainCorrection``, ``Spikes``,
``Level2FitPowerSpectrum``, ``NoiseStatistics`` and
``WriteLevel2Data``. ``figure_dir`` (``diagnostics``),
``normalised_mask_db`` (``database/``) and ``backend = "numpy"``
(``backends/``) raise ``NotImplementedError`` when set; the reference's
``warm_programs`` (XLA ahead-of-time compiles) has no counterpart.

Feed batches follow the reference's planner (``ops.reduce``): a stage
pass keeps its planned chunk of raw counts on the device and works
through it one feed at a time, as the reference's ``lax.map`` does; the
reduction takes ``feed_batch`` feeds per batch and streams scans as
``plan_reduce_memory`` decides.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from comapreduce_tpu_torch._device import resolve_device
from comapreduce_tpu_torch.data.scan_edges import segment_ids_from_edges
from comapreduce_tpu_torch.ops import power as power_ops
from comapreduce_tpu_torch.ops import vane as vane_ops
from comapreduce_tpu_torch.ops.atmosphere import fit_atmosphere_segments
from comapreduce_tpu_torch.ops.average import (edge_channel_mask,
                                               frequency_bin)
from comapreduce_tpu_torch.ops.reduce import (ReduceConfig, ShapeBuckets,
                                              device_hbm_bytes,
                                              pad_scan_geometry,
                                              pad_time_axis,
                                              plan_reduce_memory,
                                              reduce_feeds,
                                              scan_starts_lengths,
                                              stage_feed_batches)
from comapreduce_tpu_torch.ops.spikes import spike_mask
from comapreduce_tpu_torch.ops.stats import auto_rms
from comapreduce_tpu_torch.pipeline.registry import register

__all__ = ["CheckLevel1File", "AssignLevel1Data",
           "MeasureSystemTemperature", "AtmosphereRemoval",
           "Level1Averaging", "Level1AveragingGainCorrection", "Spikes",
           "Level2FitPowerSpectrum", "NoiseStatistics", "WriteLevel2Data",
           "mean_vane_tsys_gain", "bucket_scan_lengths",
           "first_fitted_scan"]

logger = logging.getLogger("comapreduce_tpu_torch")

# stage options whose machinery is not ported: (option, module it needs)
_UNPORTED_OPTIONS = (("figure_dir", "diagnostics"),
                     ("normalised_mask_db", "database/normalised_mask"))


@dataclass
class _StageBase:
    """Shared stage state: outputs staged for ``COMAPLevel2.update``."""

    overwrite: bool = False
    STATE: bool = True
    groups: tuple = ()
    # campaign shape policy (ops.reduce.ShapeBuckets | dict | None = off)
    shape_buckets: object = None
    # the device the stage computes on (None: the card)
    device: object = None
    _data: dict = field(default_factory=dict, repr=False)
    _attrs: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.refuse_unported()

    def refuse_unported(self) -> None:
        """Raise ``NotImplementedError`` naming a set option whose
        machinery is not ported."""
        for opt, module in _UNPORTED_OPTIONS:
            if getattr(self, opt, ""):
                raise NotImplementedError(
                    f"{self.name}: {opt} needs {module}, which is not "
                    "ported")

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def save_data(self):
        return self._data, self._attrs

    def pre_init(self, data) -> None:
        pass

    def clear_outputs(self) -> None:
        """Drop staged outputs (the runner calls this before each file)."""
        self._data = {}
        self._attrs = {}

    def _device(self) -> torch.device:
        self.refuse_unported()
        return resolve_device(self.device)

    def __str__(self) -> str:
        return self.name


@register(backend="any")
@dataclass
class CheckLevel1File(_StageBase):
    """Gate: files under ``min_duration_seconds`` or whose comment names
    a bad keyword abort the chain (``stages.py:109``)."""

    min_duration_seconds: float = 300.0
    bad_keywords: tuple = ("sky dip", "skydip", "sky nod", "test")
    overwrite: bool = True

    def __call__(self, data, level2) -> bool:
        import re

        mjd = data.mjd
        duration = float(mjd[-1] - mjd[0]) * 86400.0
        comment = data.comment.lower()
        bad = next((k for k in self.bad_keywords
                    if re.search(rf"\b{re.escape(k)}\b", comment)), None)
        self.STATE = True
        if duration < self.min_duration_seconds:
            logger.info("CheckLevel1File: obs %s too short (%.0f s)",
                        data.obsid, duration)
            self.STATE = False
        elif bad is not None:
            logger.info("CheckLevel1File: obs %s flagged (%r in comment)",
                        data.obsid, bad)
            self.STATE = False
        return self.STATE


@register(backend="any")
@dataclass
class AssignLevel1Data(_StageBase):
    """Copy pointing and metadata from Level-1 into the Level-2 store
    (``stages.py:143``)."""

    groups: tuple = ("spectrometer",)

    def __call__(self, data, level2) -> bool:
        self._data = {
            "spectrometer/MJD": data.mjd,
            "spectrometer/feeds": data.feeds,
            "spectrometer/features": data.materialise("spectrometer/features"),
            "spectrometer/frequency": data.frequency,
            "spectrometer/pixel_pointing/pixel_ra": np.asarray(data.ra),
            "spectrometer/pixel_pointing/pixel_dec": np.asarray(data.dec),
            "spectrometer/pixel_pointing/pixel_az": np.asarray(data.az),
            "spectrometer/pixel_pointing/pixel_el": np.asarray(data.el),
        }
        self._attrs = {"comap": {
            "obsid": data.obsid,
            "source": data.attrs("comap", "source"),
            "comment": data.comment,
        }}
        self.STATE = True
        return True


@register()
@dataclass
class MeasureSystemTemperature(_StageBase):
    """Vane calibration: per-channel system temperature and gain per vane
    event (``stages.py:221``); writes ``vane/system_temperature`` and
    ``vane/system_gain``, each ``(n_events, F, B, C)``."""

    groups: tuple = ("vane",)
    pad: int = 50
    figure_dir: str = ""

    def __call__(self, data, level2) -> bool:
        dev = self._device()
        tod = data["spectrometer/tod"]

        def reader(s, e):
            return tod[..., s:e]

        tsys, gain = vane_ops.measure_system_temperature(
            reader, data.vane_flag, data.vane_temperature, pad=self.pad,
            device=dev)
        if tsys is None:
            logger.warning("MeasureSystemTemperature: obs %s has no vane "
                           "events", data.obsid)
            self.STATE = False
            return False
        self._data = {
            "vane/system_temperature": tsys.cpu().numpy(),
            "vane/system_gain": gain.cpu().numpy(),
        }
        self.STATE = True
        return True


def _f32(x, dev) -> torch.Tensor:
    """A host array as f32 on ``dev`` (the reference's ``jnp.asarray``
    narrows float64 host arrays to f32 the same way)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)


def _stage_buckets(stage) -> ShapeBuckets:
    """The stage's campaign shape policy (identity when unset)."""
    return ShapeBuckets.coerce(getattr(stage, "shape_buckets", None))


def _feed_chunks(data, F, B, C, Tb, requested, dev):
    """Planner-sized feed chunks, each read feed by feed into one
    resident f32[f, B, C, Tb] device tensor (NaN time tail past T)."""
    for idx in stage_feed_batches(F, B, C, Tb, requested,
                                  hbm_bytes=device_hbm_bytes(device=dev)):
        raw = torch.empty((len(idx), B, C, Tb), dtype=torch.float32,
                          device=dev)
        for i, j in enumerate(idx):
            feed = np.asarray(data.read_tod_feed(j), dtype=np.float32)
            raw[i].copy_(torch.from_numpy(pad_time_axis(feed, Tb)))
            del feed
        yield idx, raw


def mean_vane_tsys_gain(level2):
    """Event-averaged (tsys, gain), each f32[F, B, C]; channels a vane
    event failed to calibrate (0) are left out of their average
    (``stages.py:341``)."""
    tsys = np.asarray(level2.system_temperature, dtype=np.float32)
    gain = np.asarray(level2.system_gain, dtype=np.float32)
    ok_t = (tsys > 0).sum(axis=0)
    ok_g = (gain > 0).sum(axis=0)
    tsys_m = tsys.sum(axis=0) / np.maximum(ok_t, 1)
    gain_m = gain.sum(axis=0) / np.maximum(ok_g, 1)
    return tsys_m, gain_m


@register()
@dataclass
class AtmosphereRemoval(_StageBase):
    """Per-(scan, feed, band, channel) regression of the TOD against
    airmass; stores ``atmosphere/fit_values`` (S, F, B, 2, C)
    (``stages.py:522``)."""

    groups: tuple = ("atmosphere",)
    # feeds per chunk: 0 = as many as the planner fits on the device
    feed_batch: int = 0

    def __call__(self, data, level2) -> bool:
        dev = self._device()
        edges = data.scan_edges
        if len(edges) == 0:
            logger.warning("AtmosphereRemoval: obs %s has no scans",
                           data.obsid)
            self.STATE = False
            return False
        S = len(edges)
        F, B, C, T = (int(x) for x in data.tod_shape)
        bk = _stage_buckets(self)
        Tb, Sb = bk.round_T(T), bk.round_S(S)
        seg = segment_ids_from_edges(edges, T).astype(np.int32)
        seg = torch.from_numpy(pad_time_axis(seg, Tb, fill="zero")).to(dev)
        airmass_all = np.asarray(data.airmass).astype(np.float32)
        out = np.zeros((S, F, B, 2, C), np.float32)
        for idx, raw in _feed_chunks(data, F, B, C, Tb, self.feed_batch,
                                     dev):
            for i, j in enumerate(idx):
                r = raw[i]
                a = _f32(pad_time_axis(airmass_all[j], Tb, fill="edge"),
                         dev)
                mask = torch.isfinite(r).to(torch.float32)
                off, atm = fit_atmosphere_segments(
                    torch.nan_to_num(r), a, seg, mask, n_scans=Sb)
                # (B, C, Sb) pair -> (Sb, B, 2, C) -> first S scans
                blk = torch.stack([off, atm], dim=0).permute(3, 1, 0, 2)
                out[:, j] = blk[:S].cpu().numpy()
            del raw
        self._data = {"atmosphere/fit_values": out}
        self.STATE = True
        return True


@register()
@dataclass
class Level1Averaging(_StageBase):
    """Frequency binning without gain correction (``stages.py:615``):
    counts / vane gain, 1/Tsys^2 weights with the edge and band-centre
    channels cut, then the weighted in-bin mean and standard deviation
    over ``frequency_bin_size`` channels; NaN samples carry zero weight.
    Writes ``frequency_binned/{tod, tod_stddev, scan_edges}``."""

    groups: tuple = ("frequency_binned",)
    frequency_bin_size: int = 512
    feed_batch: int = 0
    normalised_mask_db: str = ""

    def __call__(self, data, level2) -> bool:
        dev = self._device()
        try:
            tsys, gain = mean_vane_tsys_gain(level2)
        except KeyError:
            logger.warning("Level1Averaging: obs %s has no vane "
                           "calibration", data.obsid)
            self.STATE = False
            return False
        F, B, C, T = (int(x) for x in data.tod_shape)
        bin_size = min(self.frequency_bin_size, C)

        def s(n):
            return max(int(round(n * C / 1024.0)), 1)
        chan_mask = edge_channel_mask(C, s(10), s(1), s(2)).numpy()
        w = np.where(tsys > 0, 1.0 / np.maximum(tsys, 1e-10) ** 2, 0.0)
        w = (w * chan_mask).astype(np.float32)          # (F, B, C)
        nb = C // bin_size
        Tb = _stage_buckets(self).round_T(T)
        tod_out = np.zeros((F, B, nb, T), np.float32)
        std_out = np.zeros((F, B, nb, T), np.float32)
        for idx, raw in _feed_chunks(data, F, B, C, Tb, self.feed_batch,
                                     dev):
            for i, j in enumerate(idx):
                r = raw[i]
                g = _f32(gain[j], dev)
                tod = r / torch.where(g > 0, g, torch.ones_like(g))[..., None]
                avg, std = frequency_bin(tod, _f32(w[j], dev), bin_size,
                                         valid=torch.isfinite(r))
                tod_out[j] = avg[..., :T].cpu().numpy()
                std_out[j] = std[..., :T].cpu().numpy()
            del raw
        self._data = {
            "frequency_binned/tod": tod_out,
            "frequency_binned/tod_stddev": std_out,
            "frequency_binned/scan_edges": np.asarray(data.scan_edges),
        }
        self.STATE = True
        return True


@register()
@dataclass
class Level1AveragingGainCorrection(_StageBase):
    """The Level-1 -> Level-2 reduction (``stages.py:701``): feeds in
    batches of ``feed_batch`` through :func:`~..ops.reduce.reduce_feeds`
    (NaN fill, atmosphere subtraction, radiometer normalisation,
    median-filter high-pass, gain-fluctuation solve, Tsys-weighted band
    average), the next batch read on a worker thread while the device
    reduces the current one. Writes ``averaged_tod/{tod, tod_original,
    weights, scan_edges}``."""

    groups: tuple = ("averaged_tod",)
    medfilt_window: int = 6000
    # None = two-level filter beyond 512-sample windows; 1 = exact
    medfilt_stride: int | None = None
    pad_to: int = 128
    # feeds per batch (0 = all feeds at once), checked against the
    # device memory budget by plan_reduce_memory before any work
    feed_batch: int = 2
    # scans per chunk (None = auto: all at once when the budget allows)
    scan_batch: int | None = None
    prefetch: bool = True
    figure_dir: str = ""
    normalised_mask_db: str = ""

    def __call__(self, data, level2) -> bool:
        dev = self._device()
        edges = np.asarray(data.scan_edges)
        if len(edges) == 0:
            logger.warning("Level1AveragingGainCorrection: obs %s has no "
                           "scans", data.obsid)
            self.STATE = False
            return False
        try:
            tsys, sys_gain = mean_vane_tsys_gain(level2)
        except KeyError:
            logger.warning("Level1AveragingGainCorrection: obs %s has no "
                           "vane calibration", data.obsid)
            self.STATE = False
            return False

        F, B, C, T = (int(x) for x in data.tod_shape)
        starts, lengths, L = scan_starts_lengths(edges, pad_to=self.pad_to)
        # campaign bucket: NaN time tail, zero-length padding scans, L on
        # the bucket grid; the filter window stays clamped to the
        # unpadded L and reflects there (fold_len)
        bk = _stage_buckets(self)
        Tb = bk.round_T(T)
        L_raw = L
        L = bk.round_L(L)
        Sb = bk.round_S(len(edges))
        starts, lengths = pad_scan_geometry(starts, lengths, Sb)
        freq = data.frequency.astype(np.float32)
        f0 = freq.mean(axis=1, keepdims=True)
        freq_scaled = _f32((freq - f0) / f0, dev)
        airmass_all = np.asarray(data.airmass).astype(np.float32)

        fb = min(self.feed_batch or F, F)
        scan_batch = plan_reduce_memory(
            fb, B, C, Tb, Sb, L, self.scan_batch,
            hbm_bytes=device_hbm_bytes(device=dev))
        if scan_batch != self.scan_batch:
            logger.info("Level1AveragingGainCorrection: streaming %s "
                        "scans per chunk to fit device memory", scan_batch)
        cfg = ReduceConfig(C, medfilt_window=min(self.medfilt_window, L_raw),
                           is_calibrator=data.is_calibrator,
                           medfilt_stride=self.medfilt_stride,
                           scan_batch=scan_batch)
        batches = [list(range(i, min(i + fb, F))) for i in range(0, F, fb)]

        def load(idx):
            """One feed batch from the lazy store (NaNs ride along: the
            reduction derives validity on the device)."""
            raw = np.stack([np.asarray(data.read_tod_feed(i),
                                       dtype=np.float32) for i in idx])
            return (pad_time_axis(raw, Tb),
                    pad_time_axis(airmass_all[idx], Tb, fill="edge"))

        tod_out = np.zeros((F, B, T), np.float32)
        orig_out = np.zeros((F, B, T), np.float32)
        wei_out = np.zeros((F, B, T), np.float32)
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(load, batches[0])
            for bi, idx in enumerate(batches):
                raw, am = fut.result()
                if self.prefetch and bi + 1 < len(batches):
                    fut = ex.submit(load, batches[bi + 1])
                raw_t = _f32(raw, dev)
                del raw
                res = reduce_feeds(
                    raw_t, _f32(am, dev), starts, lengths,
                    _f32(tsys[idx], dev), _f32(sys_gain[idx], dev),
                    freq_scaled, cfg, L=L,
                    fold_len=L_raw if bk.enabled else None)
                del raw_t
                tod_out[idx] = res["tod"][..., :T].cpu().numpy()
                orig_out[idx] = res["tod_original"][..., :T].cpu().numpy()
                wei_out[idx] = res["weights"][..., :T].cpu().numpy()
                del res
                if not self.prefetch and bi + 1 < len(batches):
                    fut = ex.submit(load, batches[bi + 1])
        self._data = {
            "averaged_tod/tod": tod_out,
            "averaged_tod/tod_original": orig_out,
            "averaged_tod/weights": wei_out,
            "averaged_tod/scan_edges": edges,
        }
        self.STATE = True
        return True


@register()
@dataclass
class Spikes(_StageBase):
    """Spike flagging of the averaged TOD -> ``spikes/spike_mask``
    (F, B, T) uint8 (``stages.py:930``)."""

    groups: tuple = ("spikes",)
    window: int = 501
    threshold: float = 10.0
    pad: int = 100

    def __call__(self, data, level2) -> bool:
        dev = self._device()
        tod = np.asarray(level2.tod, dtype=np.float32)
        # validity from the reduction's weights (zero outside scans); the
        # tod != 0 sentinel only for stores without weights
        if "averaged_tod/weights" in level2:
            valid = (np.asarray(level2["averaged_tod/weights"],
                                dtype=np.float32) > 0).astype(np.float32)
        else:
            valid = (tod != 0).astype(np.float32)
        T = tod.shape[-1]
        mask = spike_mask(_f32(tod, dev),
                          window=min(self.window, max(3, T // 2 * 2 - 1)),
                          threshold=self.threshold, pad=self.pad,
                          valid=_f32(valid, dev))
        self._data = {"spikes/spike_mask":
                      mask.cpu().numpy().astype(np.uint8)}
        self.STATE = True
        return True


def bucket_scan_lengths(edges: np.ndarray, quantum: int,
                        max_buckets: int = 0) -> dict:
    """Group scan indices by quantised fit length ``{length: [scan ids]}``
    (``stages.py:959``): each scan fits at its length rounded down to
    ``quantum`` (scans shorter than it at an even length); under 16
    samples is dropped. ``max_buckets > 0`` merges the sorted distinct
    lengths into that many contiguous groups, each at its minimum."""
    q = max(int(quantum), 1)
    buckets: dict[int, list[int]] = {}
    for si, (s, e) in enumerate(np.asarray(edges)):
        ln = int(e - s)
        lq = (ln // q) * q if ln >= q else ln // 2 * 2
        if lq >= 16:
            buckets.setdefault(lq, []).append(si)

    if max_buckets > 0 and len(buckets) > max_buckets:
        n0 = len(buckets)
        groups = np.array_split(np.asarray(sorted(buckets)), max_buckets)
        merged: dict[int, list[int]] = {}
        worst = 0
        for g in groups:
            if not g.size:
                continue
            tgt = int(g[0])
            worst = max(worst, int(g[-1]) - tgt)
            for ln in g:
                merged.setdefault(tgt, []).extend(buckets[int(ln)])
        buckets = {ln: sorted(v) for ln, v in merged.items()}
        logger.warning(
            "bucket_scan_lengths: %d distinct fit lengths exceed the "
            "cap of %d; merged to %d buckets (up to %d extra samples "
            "trimmed per scan)", n0, max_buckets, len(buckets), worst)
    return buckets


def first_fitted_scan(buckets: dict, edges: np.ndarray):
    """(scan id, fit length, start) of the first fitted scan."""
    si0 = min(min(v) for v in buckets.values())
    lq0 = next(lq for lq, v in sorted(buckets.items()) if si0 in v)
    return si0, lq0, int(np.asarray(edges)[si0, 0])


@register()
@dataclass
class Level2FitPowerSpectrum(_StageBase):
    """Per-(feed, band, scan) noise power-spectrum fit of the averaged
    TOD (``stages.py:1016``), red-noise model by default. Each scan fits
    at its own length rounded down to ``length_quantum``; scans too short
    to fit hold NaN. Writes ``{out_group}/{fnoise_fit_parameters
    (F, B, S, 3), auto_rms (F, B, S)}``."""

    groups: tuple = ("fnoise_fits",)
    nbins: int = 30
    sample_rate: float = 50.0
    model_name: str = "red_noise"
    out_group: str = "fnoise_fits"
    mask_peaks: bool = True
    length_quantum: int = 128
    max_length_buckets: int = 16
    figure_dir: str = ""

    def __call__(self, data, level2) -> bool:
        dev = self._device()
        tod = np.asarray(level2.tod, dtype=np.float32)  # (F, B, T)
        edges = np.asarray(level2.scan_edges)
        if len(edges) == 0:
            self.STATE = False
            return False
        buckets = bucket_scan_lengths(edges, self.length_quantum,
                                      self.max_length_buckets)
        if not buckets:
            self.STATE = False
            return False
        F, B = tod.shape[:2]
        S = len(edges)
        params = np.full((F, B, S, 3), np.nan, np.float32)
        rms = np.full((F, B, S), np.nan, np.float32)
        for lq, sids in sorted(buckets.items()):
            blocks = _f32(np.stack(
                [tod[..., edges[si, 0]:edges[si, 0] + lq] for si in sids],
                axis=2), dev)                             # (F, B, s, lq)
            fit = power_ops.fit_observation_noise(
                blocks, sample_rate=self.sample_rate, nbins=self.nbins,
                model_name=self.model_name, mask_peaks=self.mask_peaks)
            params[:, :, sids] = fit.cpu().numpy()
            rms[:, :, sids] = auto_rms(blocks).cpu().numpy()
        self._data = {
            f"{self.out_group}/fnoise_fit_parameters": params,
            f"{self.out_group}/auto_rms": rms,
        }
        self.STATE = True
        return True


@register()
@dataclass
class NoiseStatistics(Level2FitPowerSpectrum):
    """Knee-model variant writing ``noise_statistics/*``
    (``stages.py:1101``)."""

    groups: tuple = ("noise_statistics",)
    model_name: str = "knee"
    out_group: str = "noise_statistics"


@register(backend="any")
@dataclass
class WriteLevel2Data(_StageBase):
    """Write the Level-2 store to its file (``stages.py:1112``), into
    ``output_dir`` when set."""

    overwrite: bool = True
    output_dir: str = ""

    def __call__(self, data, level2) -> bool:
        path = level2.filename
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            path = os.path.join(self.output_dir, os.path.basename(path))
            level2.filename = path
        level2.write(path)
        self.STATE = True
        return True
