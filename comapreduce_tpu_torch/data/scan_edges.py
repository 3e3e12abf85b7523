"""Scan segmentation on the host (a numpy copy of
``comapreduce_tpu/data/scan_edges.py``).

A scan is a contiguous stretch where the telescope is scanning (drive
tracker status == 1, interpolated onto the spectrometer time grid);
calibrator observations use the min/max extent of the on-source feature
flags; a flat-zero tracker status falls back to feature bit 9. Edges are
``(n_scans, 2)`` int arrays of half-open ``[start, end)`` sample indices.
"""

from __future__ import annotations

import numpy as np

__all__ = ["previous_interp", "edges_from_status", "scan_edges_source",
           "scan_edges_calibrator", "segment_ids_from_edges"]


def previous_interp(x_new: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Piecewise-previous interpolation with end extrapolation.

    Equivalent of ``scipy.interpolate.interp1d(kind='previous',
    fill_value='extrapolate')`` used at ``DataHandling.py:216-217`` — kept
    dependency-free and O(n log n).
    """
    idx = np.searchsorted(x, x_new, side="right") - 1
    idx = np.clip(idx, 0, len(x) - 1)
    return y[idx]


def edges_from_status(status: np.ndarray, code: int = 1) -> np.ndarray:
    """Half-open [start, end) runs where ``status == code``."""
    on = (status == code).astype(np.int8)
    d = np.diff(np.concatenate(([0], on, [0])))
    starts = np.where(d == 1)[0]
    ends = np.where(d == -1)[0]
    return np.stack([starts, ends], axis=1).astype(np.int64)


def scan_edges_source(scan_status: np.ndarray, scan_utc: np.ndarray,
                      mjd: np.ndarray, features: np.ndarray,
                      status_code: int = 1) -> np.ndarray:
    """Scan edges for field observations.

    Interpolate the drive tracker status onto the spectrometer MJD grid and
    take contiguous runs of ``status_code``. If the tracker never reports
    scanning, fall back to the span of feature bit 9
    (``DataHandling.py:218-226``).
    """
    if np.sum(scan_status) == 0:
        sel = np.where(features == 9)[0]
        if sel.size == 0:
            return np.zeros((0, 2), dtype=np.int64)
        return np.array([[sel[0], sel[-1] + 1]], dtype=np.int64)
    status = previous_interp(mjd, scan_utc, scan_status)
    return edges_from_status(status, status_code)


def scan_edges_calibrator(on_source: np.ndarray) -> np.ndarray:
    """Single scan spanning the on-source extent (``DataHandling.py:231-245``)."""
    idx = np.where(on_source)[0]
    if idx.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    return np.array([[idx.min(), idx.max() + 1]], dtype=np.int64)


def segment_ids_from_edges(edges: np.ndarray, n_samples: int) -> np.ndarray:
    """Per-sample scan id; -1 outside any scan.

    This is the bridge from ragged host-side scans to fixed-shape device
    arrays: kernels consume ``(tod, scan_ids, mask)`` and use segment
    reductions instead of Python scan loops.
    """
    ids = np.full(n_samples, -1, dtype=np.int32)
    for i, (s, e) in enumerate(np.asarray(edges, dtype=np.int64)):
        ids[s:e] = i
    return ids
