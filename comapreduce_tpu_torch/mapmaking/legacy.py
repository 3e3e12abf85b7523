"""Legacy Level-2 ("fg-survey") read path (port of
``comapreduce_tpu/mapmaking/legacy.py``).

The reference's older map-making generation reads per-channel Level-2
files — ``level2/averaged_tod`` of shape (F, 4, 64, T) plus per-scan
statistics — and cleans each channel with stored coefficients before
averaging channels into one stream per feed
(``MapMaking/Types.py:550-623`` ``DataLevel2AverageHPX.getTOD``,
``MapMaking/DataReader.py:32-449`` ``ReadDataLevel2``). Per sample:

1. subtract the stored per-scan median-filter template scaled by the
   channel's ``filter_coefficients``;
2. subtract the atmosphere/ground model: the per-(band, scan) ``atmos``
   value stretched over the scan by the airmass (1/sin el) and scaled by
   the channel's ``atmos_coefficients``;
3. subtract the channel's scan median;
4. calibrate by the per-channel calibration factor;
5. average unmasked channels weighted by ``1/wnoise_auto^2``; the sample
   weight is the summed inverse variance.

Scans are truncated to offset multiples (``countDataSize`` semantics) and
concatenated across files into flat destriper vectors. The upstream class
is bit-rotted at HEAD (its ``AtmosGroundModel`` import no longer exists);
this is the working equivalent, kept numpy/h5py host-side — it is an IO
path, not device math, the reference's code line for line.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from comapreduce_tpu_torch.data.hdf5io import safe_hdf5_open

__all__ = ["LegacyLevel2Data", "read_legacy_level2"]

logger = logging.getLogger("comapreduce_tpu_torch")


@dataclass
class LegacyLevel2Data:
    """Flat destriper vectors from legacy Level-2 files."""

    tod: np.ndarray        # f32[N]
    weights: np.ndarray    # f32[N]
    az: np.ndarray         # f32[N]
    el: np.ndarray         # f32[N]
    file_ids: np.ndarray   # i32[N]
    files: list


def _clean_feed_scan(tod, medfilt, medfilt_coef, atmos_val, atmos_coef,
                     el, cal_factors, channel_mask, wnoise):
    """Clean one (feed, scan) block (B, C, N) -> (avg(N), weight(N)).

    Vectorised over channels (the reference loops band x channel in
    Python, ``Types.py:592-599``).
    """
    B, C, N = tod.shape
    airmass = 1.0 / np.clip(np.sin(np.radians(el)), 0.05, None)
    # (B, C, N) models
    mdl = (medfilt[:, None, :N] * medfilt_coef[..., None]
           + (atmos_val[:, None, None] * airmass[None, None, :])
           * atmos_coef[..., None])
    cleaned = tod - mdl
    cleaned = cleaned - np.nanmedian(cleaned, axis=-1)[..., None]
    cal = np.where(cal_factors > 0, cal_factors, 1.0)
    cleaned = cleaned / cal[..., None]

    good = (channel_mask
            & np.isfinite(cleaned).all(axis=-1)
            & np.isfinite(wnoise)
            & (wnoise > 0))
    ivar = np.where(good, 1.0 / np.maximum(wnoise, 1e-30) ** 2, 0.0)
    bot = ivar.sum()
    if bot <= 0:
        return np.zeros(N), np.zeros(N)
    top = np.einsum("bcn,bc->n", np.where(good[..., None], cleaned, 0.0),
                    ivar)
    return top / bot, np.full(N, bot)


def read_legacy_level2(filenames, feeds=None, offset_length: int = 50,
                       channel_mask: np.ndarray | None = None,
                       cal_factors: np.ndarray | None = None):
    """Read legacy-format Level-2 files into flat destriper vectors.

    Expected schema (``Types.py:550-623``): ``level2/averaged_tod``
    (F, B, C, T), ``level2/Statistics/{scan_edges, filter_coefficients
    (F,B,C,S,1), atmos (F,B,S), atmos_coefficients (F,B,C,S,1),
    wnoise_auto (F,B,C,S... trailing 1), FilterTod_ScanXX (F,B,N)}``, and
    ``level1/spectrometer/pixel_pointing/pixel_{az,el}`` (F, T).

    ``feeds``: feed indices to use (default: all); ``channel_mask``: bool
    (F, B, C), True = use channel (the reference stores the inverse
    "masked" sense; pass usable-channel True here); ``cal_factors``:
    (F, B, C) calibration divisors (default 1).
    """
    tods, weis, azs, els, fids = [], [], [], [], []
    used = []
    for fid, filename in enumerate(filenames):
        try:
            with safe_hdf5_open(filename, "r") as h:
                tod_d = h["level2/averaged_tod"]
                F, B, C, T = tod_d.shape
                sel = list(range(F)) if feeds is None else list(feeds)
                edges = h["level2/Statistics/scan_edges"][...]
                mf_coef = h["level2/Statistics/filter_coefficients"][...]
                atmos = h["level2/Statistics/atmos"][...]
                at_coef = h["level2/Statistics/atmos_coefficients"][...]
                wn = h["level2/Statistics/wnoise_auto"][...]
                az_d = h["level1/spectrometer/pixel_pointing/pixel_az"]
                el_d = h["level1/spectrometer/pixel_pointing/pixel_el"]
                cmask = (np.ones((F, B, C), bool) if channel_mask is None
                         else np.asarray(channel_mask, bool))
                cal = (np.ones((F, B, C)) if cal_factors is None
                       else np.asarray(cal_factors, np.float64))
                for ifeed in sel:
                    tod_f = tod_d[ifeed].astype(np.float64)
                    az_f = az_d[ifeed].astype(np.float64)
                    el_f = el_d[ifeed].astype(np.float64)
                    for iscan, (start, end) in enumerate(edges):
                        start, end = int(start), int(end)
                        n = (end - start) // offset_length * offset_length
                        if n <= 0:
                            continue
                        end = start + n
                        medfilt = h["level2/Statistics/"
                                    f"FilterTod_Scan{iscan:02d}"][ifeed]
                        avg, w = _clean_feed_scan(
                            tod_f[..., start:end], medfilt,
                            mf_coef[ifeed, ..., iscan, 0],
                            atmos[ifeed, :, iscan],
                            at_coef[ifeed, ..., iscan, 0],
                            el_f[start:end], cal[ifeed],
                            cmask[ifeed],
                            wn[ifeed, ..., iscan, 0]
                            if wn.ndim == 5 else wn[ifeed, ..., iscan])
                        tods.append(avg.astype(np.float32))
                        weis.append(w.astype(np.float32))
                        azs.append(az_f[start:end].astype(np.float32))
                        els.append(el_f[start:end].astype(np.float32))
                        fids.append(np.full(n, fid, np.int32))
            used.append(filename)
        except (OSError, KeyError) as err:
            logger.warning("BAD FILE %s (%s)", filename, err)
    if not tods:
        z = np.zeros(0, np.float32)
        return LegacyLevel2Data(z, z, z, z, np.zeros(0, np.int32), [])
    return LegacyLevel2Data(
        np.concatenate(tods), np.concatenate(weis), np.concatenate(azs),
        np.concatenate(els), np.concatenate(fids), used)
