"""One COMAP constant-elevation-scan observation, made on the card.

A copy of ``comapreduce_tpu_torch.flagship``'s generator (``ces_pixels``,
``observation_geometry``, ``make_flagship_inputs``; itself the
reference bench's, ``bench.py:438-464``), with two changes: every feed's
raw counts are drawn once in set-up and held resident on the card, so
the window hands out the same tensors and draws nothing; and a fixed
share of in-scan samples is flagged (drawn from the seed), so the
masked fill (K1) has samples to fill.

Per feed: gains ~1e6 (1 + 0.1 N), Tsys ~45 (1 + 0.2 U), counts =
gain Tsys (1 + 0.01 N); a vane event whose first half sees the 290 K
load; airmass 1.2 (a constant-elevation scan).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import stream_seed

VANE_LOAD_K = 290.0


def ces_triangle(T: int, nx: int, feed: int, n_feeds: int) -> np.ndarray:
    """The azimuth triangle in [0, 1]: one sweep across ``nx`` columns
    at ~10 px/s, feeds offset in phase."""
    t = np.arange(T, dtype=np.float64)
    period = 2.0 * nx / 10.0 * 50.0
    phase = (t / period + feed / max(n_feeds, 1)) % 1.0
    return np.where(phase < 0.5, phase * 2, 2 - 2 * phase)


def ces_xy(T: int, nx: int, ny: int, feed: int, n_feeds: int):
    """The raster's ``(x, y)`` in pixels over an (ny, nx) field: azimuth
    triangles while the field drifts through elevation rows, feeds
    offset across the focal plane."""
    t = np.arange(T, dtype=np.float64)
    x = ces_triangle(T, nx, feed, n_feeds) * (nx - 1)
    y = (t / T) * (ny - 1 - 8) + (feed * 8) / max(n_feeds, 1)
    return x, y


def ces_pixels(T: int, nx: int, ny: int, feed: int, n_feeds: int):
    """The raster of :func:`ces_xy` as a pixel stream."""
    x, y = ces_xy(T, nx, ny, feed, n_feeds)
    return (np.round(y) * nx + np.round(x)).astype(np.int32)


def n_samples(cfg: dict) -> int:
    return cfg["gap"] + cfg["n_scans"] * (cfg["scan_samples"] + cfg["gap"])


def geometry(cfg: dict, seed: int, flag_fraction: float):
    """``(edges i64[S, 2], scan_mask f32[T], freq f32[B, C], pixels
    i64[F*T + pad])``: the scan layout, the time mask (in-scan samples
    1, a fixed count of them flagged 0 at places drawn from ``seed``),
    the frequency offsets and the flat offset-padded pointing."""
    edges, t = [], cfg["gap"]
    for _ in range(cfg["n_scans"]):
        edges.append((t, t + cfg["scan_samples"]))
        t += cfg["scan_samples"] + cfg["gap"]
    T = t
    edges = np.asarray(edges, dtype=np.int64)
    scan_mask = np.zeros(T, np.float32)
    for s, e in edges:
        scan_mask[s:e] = 1.0
    inside = np.flatnonzero(scan_mask)
    n_flag = int(round(flag_fraction * inside.size))
    rng = np.random.default_rng(stream_seed(seed, 1))
    scan_mask[rng.choice(inside, n_flag, replace=False)] = 0.0
    F, B, C = cfg["n_feeds"], cfg["n_bands"], cfg["n_channels"]
    freq = np.broadcast_to(np.linspace(-0.1, 0.1, C), (B, C)).astype(
        np.float32)
    npix = cfg["nx"] * cfg["ny"]
    pix = np.stack([ces_pixels(T, cfg["nx"], cfg["ny"], f, F)
                    for f in range(F)]).reshape(-1).astype(np.int64)
    n_pad = (-pix.size) % cfg["offset_length"]
    pix = np.concatenate([pix, np.full(n_pad, npix, np.int64)])
    return edges, scan_mask, freq, pix


def make_feeds(cfg: dict, seed: int, device) -> list[dict]:
    """Every feed's raw data on ``device``, drawn from ``(seed, feed)``:
    ``tod`` f32[B, C, T], ``vane_tod`` f32[B, C, V], ``airmass``
    f32[T]."""
    B, C, T = cfg["n_bands"], cfg["n_channels"], n_samples(cfg)
    V = cfg["vane_samples"]
    dev = torch.device(device)
    step = torch.where(torch.arange(V, device=dev) < V // 2,
                       VANE_LOAD_K, 0.0)
    airmass = torch.full((T,), 1.2, device=dev)
    feeds = []
    for f in range(cfg["n_feeds"]):
        g = torch.Generator(device=dev)
        g.manual_seed(stream_seed(seed, 2, f))
        gain = 1e6 * (1.0 + 0.1 * torch.randn((B, C), generator=g,
                                               device=dev))
        tsys = 45.0 * (1.0 + 0.2 * torch.rand((B, C), generator=g,
                                              device=dev))
        tod = torch.randn((B, C, T), generator=g, device=dev)
        tod.mul_(0.01).add_(1.0).mul_((gain * tsys).unsqueeze(-1))
        vane = torch.randn((B, C, V), generator=g, device=dev)
        vane.mul_(1e-3).add_(1.0).mul_(
            gain.unsqueeze(-1) * (tsys.unsqueeze(-1) + step))
        feeds.append({"tod": tod, "vane_tod": vane, "airmass": airmass})
    return feeds
