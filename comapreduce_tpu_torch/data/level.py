"""COMAP Level-1 / Level-2 file views (a numpy copy of
``comapreduce_tpu/data/level.py``).

Domain wrappers over :class:`HDF5Store`: feature-bit decoding, vane
flags and the vane load temperature model, scan edges, pointing
accessors, airmass, and the ``contains``/``update`` resume contract the
pipeline runner uses. HDF5 paths follow the COMAP data format.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from comapreduce_tpu_torch.data import scan_edges as se
from comapreduce_tpu_torch.data.hdf5io import HDF5Store

__all__ = ["COMAPLevel1", "COMAPLevel2", "CALIBRATOR_NAMES",
           "decode_features", "find_level1_by_obsid"]

# Calibrator source names recognised by the pipeline
# (reference Tools/Coordinates.py:7-15 CalibratorList).
CALIBRATOR_NAMES = ("TauA", "CasA", "CygA", "jupiter", "Jupiter", "mars",
                    "venus", "moon")

# MJD of 2022-02-01 00:00 UTC: vane thermometry epoch switch
# (DataHandling.py:320-326). Time('2022-02-01').mjd == 59611.0.
_VANE_EPOCH_MJD = 59611.0
_KELVIN_OFFSET = 273.15


def find_level1_by_obsid(data_dir: str, obsid: int) -> str | None:
    """Path of the Level-1 file for ``obsid`` in ``data_dir``, or None.

    Matches the COMAP naming scheme ``comap-{obsid:07d}-*.hd5`` first,
    then any ``*.hd5`` whose LEADING filename token (optionally after a
    ``comap``/``comp`` prefix) is the obsid — a timestamp later in the
    name that merely contains the digits (e.g. ``-010000.`` vs obsid
    10000) can never match (parity: ``read_data_file_by_obsid``,
    ``Analysis/DataHandling.py`` — the prior-observation lookup the
    SkyDip stage uses)."""
    import glob
    import os
    import re

    hits = sorted(glob.glob(os.path.join(data_dir,
                                         f"comap-{int(obsid):07d}-*.hd5")))
    if hits:
        return hits[0]
    token = re.compile(rf"^(?:[A-Za-z]+[-_])?0*{int(obsid)}(?=[-_.])")
    for path in sorted(glob.glob(os.path.join(data_dir, "*.hd5"))):
        if token.match(os.path.basename(path)):
            return path
    return None


def decode_features(features: np.ndarray) -> np.ndarray:
    """Decode the feature register into bit indices: ``f -> log2(f)``.

    The telescope writes a one-hot feature word per sample; the pipeline works
    with the bit *index* (``DataHandling.py:342-349``). Zero stays zero.
    """
    f = np.asarray(features).astype(np.float64).copy()
    good = f > 0
    f[good] = np.log2(f[good])
    return f.astype(np.int64)


@dataclass
class _COMAPCommon(HDF5Store):
    """Shared Level-1/Level-2 accessors."""

    vane_bit: int = 13
    bad_keywords: tuple = ()

    @property
    def obsid(self) -> int:
        try:
            return int(self.attrs("comap", "obsid"))
        except KeyError:
            return -1

    @property
    def comment(self) -> str:
        try:
            return str(self.attrs("comap", "comment"))
        except KeyError:
            return ""

    @property
    def source_name(self) -> str:
        """First source token that is not a bad keyword (e.g. 'co2,sky')."""
        try:
            raw = str(self.attrs("comap", "source"))
        except KeyError:
            return ""
        parts = raw.split(",")
        if len(parts) == 1:
            return parts[0]
        keep = [s for s in parts if s not in self.bad_keywords]
        return keep[0] if keep else ""

    @property
    def is_calibrator(self) -> bool:
        return self.source_name in CALIBRATOR_NAMES

    @property
    def features(self) -> np.ndarray:
        if "spectrometer/features" not in self:
            raise KeyError("file contains no spectrometer/features")
        return decode_features(self.materialise("spectrometer/features"))

    @property
    def vane_flag(self) -> np.ndarray:
        return self.features == self.vane_bit

    @property
    def on_source(self) -> np.ndarray:
        """13 = vane, 0 = idle, 16 = source stare (ignored)."""
        f = self.features
        return (f != self.vane_bit) & (f != 0) & (f != 16)

    @property
    def mjd(self) -> np.ndarray:
        return self.materialise("spectrometer/MJD")

    @property
    def feeds(self) -> np.ndarray:
        return self.materialise("spectrometer/feeds")

    # pointing --------------------------------------------------------------
    @property
    def ra(self):
        return self["spectrometer/pixel_pointing/pixel_ra"]

    @ra.setter
    def ra(self, v):
        self["spectrometer/pixel_pointing/pixel_ra"] = v

    @property
    def dec(self):
        return self["spectrometer/pixel_pointing/pixel_dec"]

    @dec.setter
    def dec(self, v):
        self["spectrometer/pixel_pointing/pixel_dec"] = v

    @property
    def az(self):
        return self["spectrometer/pixel_pointing/pixel_az"]

    @az.setter
    def az(self, v):
        self["spectrometer/pixel_pointing/pixel_az"] = v

    @property
    def el(self):
        return self["spectrometer/pixel_pointing/pixel_el"]

    @el.setter
    def el(self, v):
        self["spectrometer/pixel_pointing/pixel_el"] = v

    @property
    def airmass(self) -> np.ndarray:
        """Plane-parallel airmass 1/sin(el) (``DataHandling.py:398-401``)."""
        return 1.0 / np.sin(np.radians(np.asarray(self.el)))

    def _scan_edges_from_features(self) -> np.ndarray:
        if self.is_calibrator:
            return se.scan_edges_calibrator(self.on_source)
        return se.scan_edges_source(
            self.materialise("hk/antenna0/deTracker/lissajous_status"),
            self.materialise("hk/antenna0/deTracker/utc"),
            self.mjd,
            self.features,
        )


@dataclass
class COMAPLevel1(_COMAPCommon):
    """Level-1 raw-data view; TOD stays lazy (`spectrometer/tod` ~GBs)."""

    name: str = "COMAPLevel1"
    lazy_paths: tuple = ("spectrometer/tod",)

    @property
    def tod_shape(self) -> tuple:
        return self["spectrometer/tod"].shape  # (F, B, C, T)

    @property
    def frequency(self) -> np.ndarray:
        """Channel frequencies in GHz, shape (B, C)."""
        return self.materialise("spectrometer/frequency")

    @property
    def vane_temperature(self) -> float:
        """Hot-load temperature in K.

        Before 2022-02-01 the vane thermometer is trusted directly; after,
        it is predicted from the shroud temperature with the linear model
        fitted on pre-2022 data (``DataHandling.py:316-326``). Sensor values
        are stored in centi-Kelvin-above-Celsius units (/100 + 273.15).
        """
        if float(self.mjd[0]) < _VANE_EPOCH_MJD:
            t = np.nanmean(self.materialise("hk/antenna0/vane/Tvane"))
            return float(t) / 100.0 + _KELVIN_OFFSET
        t = np.nanmean(self.materialise("hk/antenna0/vane/Tshroud"))
        tshroud = float(t) / 100.0 + _KELVIN_OFFSET
        return 0.2702 * tshroud + 213.0

    @property
    def scan_edges(self) -> np.ndarray:
        return self._scan_edges_from_features()

    def read_tod_feed(self, ifeed: int) -> np.ndarray:
        """Read one feed's raw TOD (B, C, T) from the lazy dataset."""
        return np.asarray(self["spectrometer/tod"][ifeed])


@dataclass
class COMAPLevel2(_COMAPCommon):
    """Level-2 reduced-data view. The file itself is the pipeline checkpoint.

    ``contains``/``update`` implement the resume contract: a stage is skipped
    when all its output groups are already present, and stages deposit their
    outputs via ``update`` (``DataHandling.py:417-448``).
    """

    name: str = "COMAPLevel2"
    filename: str = "pipeline_output.hd5"

    def __post_init__(self):
        import os

        if self.filename and os.path.exists(self.filename):
            self.read(self.filename)

    def contains(self, stage) -> bool:
        return self.contains_groups(getattr(stage, "groups", ()))

    def update(self, stage) -> None:
        data, attrs = stage.save_data
        for k, v in data.items():
            if v is not None:
                self[k] = v
        for path, kv in attrs.items():
            for k, v in kv.items():
                self.set_attrs(path, k, v)

    @property
    def tod(self):
        return self["averaged_tod/tod"]  # (F, B, T)

    @tod.setter
    def tod(self, v):
        self["averaged_tod/tod"] = v

    @property
    def tod_shape(self) -> tuple:
        return self["averaged_tod/tod"].shape

    @property
    def nbands(self) -> int:
        return self.tod_shape[1]

    @property
    def scan_edges(self) -> np.ndarray:
        if "averaged_tod/scan_edges" in self:
            return np.asarray(self["averaged_tod/scan_edges"])
        if "frequency_binned/scan_edges" in self:
            return np.asarray(self["frequency_binned/scan_edges"])
        return self._scan_edges_from_features()

    @property
    def system_temperature(self):
        return self["vane/system_temperature"]

    @system_temperature.setter
    def system_temperature(self, v):
        self["vane/system_temperature"] = v

    @property
    def system_gain(self):
        return self["vane/system_gain"]

    @system_gain.setter
    def system_gain(self, v):
        self["vane/system_gain"] = v

    def tod_auto_rms(self, ifeed: int, iband: int) -> float:
        """Adjacent-pair rms of the nonzero samples
        (``DataHandling.py:591-597``)."""
        tod = np.asarray(self["averaged_tod/tod"][ifeed, iband])
        tod = tod[tod != 0]
        n = tod.size // 2 * 2
        diff = tod[0:n:2] - tod[1:n:2]
        return float(np.nanstd(diff) / np.sqrt(2.0))
