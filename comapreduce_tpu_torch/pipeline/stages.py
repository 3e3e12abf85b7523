"""Pipeline stages: the ``PipelineFunction`` contract over the port's ops
(port of ``comapreduce_tpu/pipeline/stages.py``).

Each stage is a small dataclass: ``__call__(data, level2) -> STATE``,
``groups`` (its output groups, which drive the runner's resume test) and
``save_data`` (``(datasets, attributes)`` that ``COMAPLevel2.update``
deposits). Stages read the Level-1 store on the host, run their device
work on ``device`` (set by the :class:`~.runner.Runner`; ``None`` is
the card, as for every entry point of the port) and hand numpy arrays to
the Level-2 store.

Every stage of the reference is ported: ``CheckLevel1File``,
``AssignLevel1Data``, ``UseLevel2Pointing``,
``MeasureSystemTemperature``, ``SkyDip``, ``AtmosphereRemoval``,
``Level1Averaging``, ``Level1AveragingGainCorrection``, ``Spikes``,
``Level2FitPowerSpectrum``, ``NoiseStatistics``, ``WriteLevel2Data`` and
``Level2Timelines``, with their ``figure_dir`` (QA figures through
:mod:`~comapreduce_tpu_torch.diagnostics`, matplotlib on the host) and
``normalised_mask_db`` (the fleet channel mask of
:mod:`~comapreduce_tpu_torch.database`). ``backend = "numpy"`` picks
the f64 host stages of :mod:`~comapreduce_tpu_torch.backends`.

``SkyDip``, ``AtmosphereRemoval``, ``Level1Averaging`` and
``Level1AveragingGainCorrection`` carry the reference's
``warm_programs(F, B, C, T, S, L, calibrator)`` hook of the campaign
warm-up (:mod:`~comapreduce_tpu_torch.pipeline.campaign`): where the
reference compiles the stage's XLA programs ahead of time, the port
builds and loads the kernel libraries the stage launches (K1 and K2 for
the reduction; the other three launch no hand-written kernel), since
eager PyTorch compiles nothing else. With telemetry on, each of them
records its device call's program (argument, output and temporary
bytes) at its first call of a shape bucket
(:mod:`~comapreduce_tpu_torch.telemetry.programs`), where the reference
records its warm-up compiles.

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

from comapreduce_tpu_torch import _build
from comapreduce_tpu_torch._device import resolve_device
from comapreduce_tpu_torch.data.scan_edges import segment_ids_from_edges
from comapreduce_tpu_torch.ops import power as power_ops
from comapreduce_tpu_torch.ops import vane as vane_ops
from comapreduce_tpu_torch.ops.atmosphere import fit_atmosphere_segments
from comapreduce_tpu_torch.ops.average import (edge_channel_mask,
                                               frequency_bin)
from comapreduce_tpu_torch.ops.reduce import (KERNEL_LIBRARIES,
                                              ReduceConfig, ShapeBuckets,
                                              device_hbm_bytes,
                                              pad_scan_geometry,
                                              pad_time_axis,
                                              plan_reduce_memory,
                                              scan_starts_lengths,
                                              stage_feed_batches)
from comapreduce_tpu_torch.ops.segment import plan_segments
from comapreduce_tpu_torch.ops.spikes import spike_mask
from comapreduce_tpu_torch.ops.stats import auto_rms
from comapreduce_tpu_torch.parallel.mesh import (feed_time_mesh,
                                                 local_devices)
from comapreduce_tpu_torch.parallel.multihost import rank_info
from comapreduce_tpu_torch.parallel.sharded import reduce_feeds_sharded
from comapreduce_tpu_torch.pipeline.registry import register
from comapreduce_tpu_torch.telemetry.programs import PROGRAMS

__all__ = ["CheckLevel1File", "AssignLevel1Data", "UseLevel2Pointing",
           "MeasureSystemTemperature", "SkyDip", "AtmosphereRemoval",
           "Level1Averaging", "Level1AveragingGainCorrection", "Spikes",
           "Level2FitPowerSpectrum", "NoiseStatistics", "WriteLevel2Data",
           "Level2Timelines", "apply_fleet_channel_mask",
           "mean_vane_tsys_gain", "bucket_scan_lengths",
           "first_fitted_scan"]

logger = logging.getLogger("comapreduce_tpu_torch")


@dataclass
class _StageBase:
    """Shared stage state: outputs staged for ``COMAPLevel2.update``."""

    overwrite: bool = False
    STATE: bool = True
    groups: tuple = ()
    # campaign shape policy (ops.reduce.ShapeBuckets | dict | None = off)
    shape_buckets: object = None
    # end-to-end precision policy (ops.precision.PrecisionPolicy | None:
    # identity), set by the Runner from [precision]. A bf16 TOD payload
    # needs no stage code: its reads widen to f32 on the host
    precision: object = None
    # the device the stage computes on (None: the card)
    device: object = None
    _data: dict = field(default_factory=dict, repr=False)
    _attrs: dict = field(default_factory=dict, repr=False)

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
        return resolve_device(self.device)

    def __str__(self) -> str:
        return self.name


class _WarmsLibraries:
    """The campaign warm-up hook of a stage (``stages.py:442``): build
    and load the kernel libraries ``kernel_libraries`` the stage
    launches, on a CUDA device (the CPU runs the plain versions)."""

    kernel_libraries = ()

    def warm_programs(self, F, B, C, T, S, L, calibrator=False):
        del F, B, C, T, S, L, calibrator   # one library serves any shape
        if self.kernel_libraries and self._device().type == "cuda":
            _build.build(self.kernel_libraries)


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


@register(backend="any")
@dataclass
class UseLevel2Pointing(_StageBase):
    """Re-read pointing from an existing Level-2 file into both the
    Level-1 view and the Level-2 store (``stages.py:171``). Acts only
    when ``overwrite`` is set and the Level-2 file exists; warns when
    products of the previous pointing (``skydip``, ``atmosphere``,
    ``averaged_tod``) already sit in the store."""

    overwrite: bool = False

    def __call__(self, data, level2) -> bool:
        self.STATE = True
        if not self.overwrite or not os.path.exists(level2.filename):
            return True
        import h5py

        with h5py.File(level2.filename, "r") as h:
            base = "spectrometer/pixel_pointing"
            if f"{base}/pixel_ra" not in h:
                logger.warning("UseLevel2Pointing: %s has no pointing",
                               level2.filename)
                return True
            pointing = {k: h[f"{base}/pixel_{k}"][...]
                        for k in ("ra", "dec", "az", "el")}
        for store in (data, level2):
            for k, v in pointing.items():
                setattr(store, k, v)
        stale = [g for g in ("skydip", "atmosphere", "averaged_tod")
                 if level2.contains_groups((g,))]
        if stale:
            logger.warning(
                "UseLevel2Pointing: %s in %s were computed from the "
                "PREVIOUS pointing; re-run those stages with "
                "overwrite=True to refresh them", ", ".join(stale),
                os.path.basename(level2.filename))
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
        if self.figure_dir:
            self._plot(data, reader, self._data["vane/system_temperature"],
                       dev)
        self.STATE = True
        return True

    def _plot(self, data, reader, tsys, dev):
        """First vane event, feed 0: hot/cold selection and Tsys
        (``VaneCalibration.py:173-190``)."""
        from comapreduce_tpu_torch import diagnostics

        events = vane_ops.find_vane_events(data.vane_flag)
        if not len(events):
            return
        n = len(data.vane_flag)
        s = max(0, int(events[0][0]) - self.pad)
        e = min(n, int(events[0][1]) + self.pad)
        ev = np.asarray(reader(s, e), dtype=np.float32)[0]  # (B, C, t)
        band_avg = ev.mean(axis=1)
        hot, cold = vane_ops.hot_cold_masks(_f32(band_avg, dev))
        diagnostics.plot_vane_event(
            diagnostics.figure_path(self.figure_dir, data.obsid,
                                    "vane_feed00_event00"),
            band_avg, hot.cpu().numpy(), cold.cpu().numpy(), tsys[0, 0],
            feed=0)


def _f32(x, dev) -> torch.Tensor:
    """A host array as f32 on ``dev`` (the reference's ``jnp.asarray``
    narrows float64 host arrays to f32 the same way)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)


def _stage_buckets(stage) -> ShapeBuckets:
    """The stage's campaign shape policy (identity when unset)."""
    return ShapeBuckets.coerce(getattr(stage, "shape_buckets", None))


def _feed_tensors(data, F, B, C, Tb, requested, dev):
    """``(j, f32[B, C, Tb])``: each feed of ``data`` read onto ``dev`` as
    a tensor of its own (NaN time tail past T), in the planner's chunk
    order, when the caller's loop reaches it; the caller drops each
    before the next is read (at most two are live). The chunks are the
    reference's plan, but no block of a chunk's feeds is allocated: a
    full-width chunk of 19 feeds is 39.5 GiB in one piece, which a card
    that already ran one file can fail to find contiguous even with that
    much reserved-but-free memory."""
    for idx in stage_feed_batches(F, B, C, Tb, requested,
                                  hbm_bytes=device_hbm_bytes(device=dev)):
        for j in idx:
            feed = np.asarray(data.read_tod_feed(j), dtype=np.float32)
            raw = torch.empty((B, C, Tb), dtype=torch.float32, device=dev)
            raw.copy_(torch.from_numpy(pad_time_axis(feed, Tb)))
            del feed
            yield j, raw
            del raw


def apply_fleet_channel_mask(tsys, db_file: str, obsid: int):
    """Zero the Tsys of fleet-masked channels (zero weight) when
    ``db_file`` names an observation database (``stages.py:328``); a
    no-op on the empty default, fail-open with a warning otherwise."""
    if not db_file:
        return tsys
    from comapreduce_tpu_torch.database.normalised_mask import \
        apply_mask_to_tsys

    return apply_mask_to_tsys(tsys, db_file, obsid)


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
class SkyDip(_WarmsLibraries, _StageBase):
    """Per-channel linear fit of the TOD against airmass -> ``skydip/fits``
    (F, B, 2, C): [offset, slope per airmass] (``stages.py:356``).

    The default mode fits the current file's own elevation coverage
    (vane samples left out); ``sky_nod_obsid`` >= 0 or ``sky_nod_file``
    fits the prior sky-nod observation instead (``sky_nod_obsid = 0``:
    the observation before this one, found by
    :func:`~..data.level.find_level1_by_obsid`), its counts divided by
    the current vane gain and cut to ``el_min``-``el_max`` deg. A
    missing, unreadable or non-sky-nod prior file is a logged no-op; a
    prior file of another layout, or no sample in the window, fails the
    stage. The prior file is read through ``ingest.loaders.load_level1``
    (its TOD lazy), so a caller serving Level-1 stores from memory serves
    it too. Feeds are read one at a time (``feed_batch``) and go through
    :func:`fit_atmosphere_segments` with one segment."""

    groups: tuple = ("skydip",)
    # feeds per chunk: 0 = one (the stage fits feed by feed, so a larger
    # chunk only holds more of the card; the reference's 0 is the
    # planner's chunk, all 19 feeds of a full-length file)
    feed_batch: int = 0
    # prior-observation sky-nod mode (-1 = off: fit the current file)
    sky_nod_obsid: int = -1
    sky_nod_file: str = ""
    # elevation window of the sky-nod fit (Level1Averaging.py:124)
    el_min: float = 40.0
    el_max: float = 55.0
    figure_dir: str = ""

    def __call__(self, data, level2) -> bool:
        self.STATE = True
        if self.sky_nod_file or self.sky_nod_obsid >= 0:
            return self._fit_sky_nod(data, level2)
        fits = self._fit_file(data, gain=None,
                              tmask=~np.asarray(data.vane_flag))
        self._data = {"skydip/fits": fits}
        self._plot(data, fits)
        return True

    def _plot(self, data, fits: np.ndarray) -> None:
        """Feed-0 offset and slope against frequency
        (``Level1Averaging.py:137-155``)."""
        if not self.figure_dir:
            return
        from comapreduce_tpu_torch import diagnostics

        diagnostics.plot_skydip_fit(
            diagnostics.figure_path(self.figure_dir, data.obsid,
                                    "skydip_feed00"),
            np.asarray(data.frequency), fits[0], feed=0)

    def _fit_file(self, data, gain, tmask) -> np.ndarray:
        """Per-channel (offset, slope) over the ``tmask``-selected samples
        of ``data``; ``gain`` (F, B, C) divides the counts into kelvin
        when given (channels without a gain drop out)."""
        dev = self._device()
        F, B, C, T = (int(x) for x in data.tod_shape)
        Tb = _stage_buckets(self).round_T(T)
        tmask = np.broadcast_to(np.asarray(tmask), (F, T))
        # one global segment: the padded tail carries zero time mask
        seg = np.zeros(Tb, np.int32)
        plan = plan_segments(seg, 1)
        seg_t = torch.as_tensor(seg, device=dev)
        airmass_all = np.asarray(data.airmass).astype(np.float32)
        fits = np.zeros((F, B, 2, C), np.float32)
        for j, r in _feed_tensors(data, F, B, C, Tb,
                                  self.feed_batch or 1, dev):
            if gain is not None:
                g = _f32(gain[j], dev)[..., None]
                r = torch.where(g > 0, r / torch.where(g > 0, g, 1.0),
                                torch.nan)
            a = _f32(pad_time_axis(airmass_all[j], Tb, fill="edge"), dev)
            tm = _f32(pad_time_axis(tmask[j].astype(np.float32), Tb,
                                    fill="zero"), dev)
            mask = torch.isfinite(r).to(torch.float32) * tm
            off, slope = PROGRAMS.record_call(
                "skydip.atmosphere_fit", fit_atmosphere_segments,
                torch.nan_to_num(r), a, seg_t, mask, n_scans=1, plan=plan)
            fits[j] = torch.stack([off[..., 0], slope[..., 0]],
                                  dim=-2).cpu().numpy()
        return fits

    def _fit_sky_nod(self, data, level2) -> bool:
        from comapreduce_tpu_torch.data.level import find_level1_by_obsid
        from comapreduce_tpu_torch.ingest import loaders

        path = self.sky_nod_file
        if not path:
            target = (data.obsid - 1 if self.sky_nod_obsid == 0
                      else self.sky_nod_obsid)
            path = find_level1_by_obsid(
                os.path.dirname(data.source_filename) or ".", target)
            if path is None:
                logger.info("SkyDip: no file for obsid %s; skipping",
                            target)
                return True
        try:
            prev = loaders.load_level1(path, eager_tod=False)
        except OSError as exc:
            logger.warning("SkyDip: cannot read sky-nod %s (%s); skipping",
                           path, exc)
            return True
        comment = prev.comment.lower()
        if "sky nod" not in comment and "sky dip" not in comment:
            logger.info("SkyDip: %s is not a sky-nod (comment %r); "
                        "skipping", path, prev.comment)
            return True
        try:
            _, gain = mean_vane_tsys_gain(level2)
        except KeyError:
            logger.warning("SkyDip: obs %s has no vane calibration",
                           data.obsid)
            self.STATE = False
            return False
        if tuple(prev.tod_shape[:3]) != gain.shape:
            logger.warning("SkyDip: sky-nod %s shape %s does not match "
                           "the current gain %s; skipping", path,
                           tuple(prev.tod_shape[:3]), gain.shape)
            self.STATE = False
            return False
        el = np.asarray(prev.el, dtype=np.float32)  # (F, T)
        tmask = (el > self.el_min) & (el < self.el_max) \
            & ~np.asarray(prev.vane_flag)[None, :]
        if not tmask.any():
            logger.warning("SkyDip: sky-nod %s has no samples in the "
                           "%.0f-%.0f deg window", path, self.el_min,
                           self.el_max)
            self.STATE = False
            return False
        fits = self._fit_file(prev, gain=gain, tmask=tmask)
        self._data = {"skydip/fits": fits}
        self._attrs = {"skydip": {"sky_nod_obsid": prev.obsid,
                                  "sky_nod_file": os.path.basename(path)}}
        self._plot(prev, fits)
        return True


@register()
@dataclass
class AtmosphereRemoval(_WarmsLibraries, _StageBase):
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
        # the fixed-order sums planned once, on the host; the padded tail
        # (id 0, zero mask) adds nothing to scan 0
        seg = pad_time_axis(segment_ids_from_edges(edges, T).astype(
            np.int32), Tb, fill="zero")
        plan = plan_segments(seg, Sb)
        seg_t = torch.as_tensor(seg, device=dev)
        airmass_all = np.asarray(data.airmass).astype(np.float32)
        out = np.zeros((S, F, B, 2, C), np.float32)
        for j, r in _feed_tensors(data, F, B, C, Tb, self.feed_batch, dev):
            a = _f32(pad_time_axis(airmass_all[j], Tb, fill="edge"), dev)
            mask = torch.isfinite(r).to(torch.float32)
            off, atm = PROGRAMS.record_call(
                "atmosphere.scan_fit", fit_atmosphere_segments,
                torch.nan_to_num(r), a, seg_t, mask, n_scans=Sb, plan=plan)
            # (B, C, Sb) pair -> (Sb, B, 2, C) -> first S scans
            blk = torch.stack([off, atm], dim=0).permute(3, 1, 0, 2)
            out[:, j] = blk[:S].cpu().numpy()
        self._data = {"atmosphere/fit_values": out}
        self.STATE = True
        return True


@register()
@dataclass
class Level1Averaging(_WarmsLibraries, _StageBase):
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
        tsys = apply_fleet_channel_mask(tsys, self.normalised_mask_db,
                                        data.obsid)
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
        for j, r in _feed_tensors(data, F, B, C, Tb, self.feed_batch, dev):
            g = _f32(gain[j], dev)
            tod = r / torch.where(g > 0, g, torch.ones_like(g))[..., None]
            avg, std = PROGRAMS.record_call(
                "level1.frequency_bin", frequency_bin, tod,
                _f32(w[j], dev), bin_size, valid=torch.isfinite(r))
            tod_out[j] = avg[..., :T].cpu().numpy()
            std_out[j] = std[..., :T].cpu().numpy()
        self._data = {
            "frequency_binned/tod": tod_out,
            "frequency_binned/tod_stddev": std_out,
            "frequency_binned/scan_edges": np.asarray(data.scan_edges),
        }
        self.STATE = True
        return True


@register()
@dataclass
class Level1AveragingGainCorrection(_WarmsLibraries, _StageBase):
    """The Level-1 -> Level-2 reduction (``stages.py:701``): feeds in
    batches of ``feed_batch`` (rounded up to a multiple of the local
    devices) through :func:`~..parallel.sharded.reduce_feeds_sharded`
    over a mesh of the local devices, each reducing its feeds one at a
    time (NaN fill, atmosphere subtraction, radiometer normalisation,
    median-filter high-pass, gain-fluctuation solve, Tsys-weighted band
    average), the next batch read on a worker thread while the devices
    reduce the current one. On one device this is
    :func:`~..ops.reduce.reduce_feeds`, bit for bit. Writes
    ``averaged_tod/{tod, tod_original, weights, scan_edges}``."""

    kernel_libraries = KERNEL_LIBRARIES

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
        tsys = apply_fleet_channel_mask(tsys, self.normalised_mask_db,
                                        data.obsid)

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

        # feeds split over a mesh of the LOCAL devices (a multi-rank run
        # is data parallel over files); batches padded to a multiple of
        # it, each device's share checked against its memory
        mesh = feed_time_mesh(local_devices(dev),
                              n_feed=len(local_devices(dev)))
        n_dev = mesh.shape["feed"]
        fb = -(-min(self.feed_batch or F, F) // n_dev) * n_dev
        scan_batch = plan_reduce_memory(
            fb // n_dev, B, C, Tb, Sb, L, self.scan_batch,
            hbm_bytes=device_hbm_bytes(device=dev), suggest_scale=n_dev)
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
        dg0 = None
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(load, batches[0])
            for bi, idx in enumerate(batches):
                raw, am = fut.result()
                if self.prefetch and bi + 1 < len(batches):
                    fut = ex.submit(load, batches[bi + 1])
                raw_t = _f32(raw, dev)
                del raw
                res = PROGRAMS.record_call(
                    "level1.reduce_feeds", reduce_feeds_sharded, mesh,
                    raw_t, None, _f32(am, dev), starts, lengths,
                    _f32(tsys[idx], dev), _f32(sys_gain[idx], dev),
                    freq_scaled, cfg, L=L,
                    fold_len=L_raw if bk.enabled else None)
                del raw_t
                tod_out[idx] = res["tod"][..., :T].cpu().numpy()
                orig_out[idx] = res["tod_original"][..., :T].cpu().numpy()
                wei_out[idx] = res["weights"][..., :T].cpu().numpy()
                if bi == 0 and self.figure_dir:
                    dg0 = res["dg"][0].cpu().numpy()    # (S, L), feed 0
                del res
                if not self.prefetch and bi + 1 < len(batches):
                    fut = ex.submit(load, batches[bi + 1])
        if dg0 is not None:
            from comapreduce_tpu_torch import diagnostics

            s0, e0 = int(edges[0][0]), int(edges[0][1])
            diagnostics.plot_gain_solution(
                diagnostics.figure_path(self.figure_dir, data.obsid,
                                        "gain_feed00_scan00"),
                tod_out[0, 0, s0:e0], dg0[0][:e0 - s0], feed=0, scan=0)
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
        if self.figure_dir:
            self._plot(data, tod, edges, buckets, params, dev)
        self._data = {
            f"{self.out_group}/fnoise_fit_parameters": params,
            f"{self.out_group}/auto_rms": rms,
        }
        self.STATE = True
        return True

    def _plot(self, data, tod, edges, buckets, params, dev) -> None:
        """Feed 0, band 0, first fitted scan: the binned PSD and its fit
        (``Level2Data.py:300-327``)."""
        from comapreduce_tpu_torch import diagnostics

        si0, lq0, s0 = first_fitted_scan(buckets, edges)
        freqs, ps = power_ops.psd(_f32(tod[0, 0, s0:s0 + lq0], dev),
                                  self.sample_rate)
        nu, pb, _ = power_ops.log_bin_psd(freqs, ps, nbins=self.nbins)
        model = (power_ops.red_noise_model if self.model_name == "red_noise"
                 else power_ops.knee_model)
        diagnostics.plot_power_spectrum_fit(
            diagnostics.figure_path(
                self.figure_dir, data.obsid,
                f"{self.out_group}_feed00_band00_scan{si0:02d}"),
            nu.cpu().numpy(), pb.cpu().numpy(), params[0, 0, si0],
            lambda p, x: model(torch.as_tensor(p),
                               torch.as_tensor(x)).numpy())


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


@register(backend="any")
@dataclass
class Level2Timelines(_StageBase):
    """Fleet timelines product (``gains.hd5``) from Level-2 files
    (``stages.py:1134``), host work only.

    With ``filelist`` set, rank 0 builds the product over that filelist
    once per pass (memoised on the filelist's path, mtime and size) and
    writes ``output_path``; other ranks do nothing. With ``filelist``
    empty, each processed file's row is added to the rows seen so far
    and the product rewritten after every file, under a ``_rank{r}``
    suffix when several ranks run (``cli/merge_gains`` merges them)."""

    overwrite: bool = True
    filelist: str = ""
    output_path: str = "gains.hd5"

    def _out_path(self) -> str:
        rank, n_ranks = rank_info()
        if n_ranks <= 1:
            return self.output_path
        base, ext = os.path.splitext(self.output_path)
        return f"{base}_rank{rank}{ext}"

    def __call__(self, data, level2) -> bool:
        from comapreduce_tpu_torch.summary import (assemble_timelines,
                                                   timeline_row,
                                                   write_gains)

        self.STATE = True
        if self.filelist:
            try:
                st = os.stat(self.filelist)
                done_key = (self.filelist, st.st_mtime_ns, st.st_size)
            except OSError:
                done_key = (self.filelist, None, None)
            if rank_info()[0] != 0 or \
                    getattr(self, "_done_key", None) == done_key:
                return True
            from comapreduce_tpu_torch.pipeline.config import read_filelist

            rows = [r for r in map(timeline_row,
                                   read_filelist(self.filelist))
                    if r is not None]
            write_gains(self.output_path, assemble_timelines(rows))
            self._done_key = done_key
            return True
        cache = getattr(self, "_rows", {})
        if level2.filename not in cache:
            cache[level2.filename] = timeline_row(level2.filename)
        self._rows = cache
        rows = [r for r in cache.values() if r is not None]
        write_gains(self._out_path(), assemble_timelines(rows))
        return True
