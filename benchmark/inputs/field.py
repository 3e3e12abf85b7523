"""A field observed many times: the band data a map-maker reads.

A copy of ``comapreduce_tpu_torch.fieldrun``'s model
(``field_geometry``, ``make_field_band``), drawn on the card from the
seed and handed over as host numpy, as the Level-2 reader hands it,
with one change: every observation has a pointing of its own. Each
(observation, feed) stream is the constant-elevation raster of
:mod:`benchmark.inputs.flagship` truncated to whole offsets, on a square
that fits the field whichever way it is turned; observation ``o`` of
``n_obs`` turns it by ``o pi / n_obs`` about the field's centre (the sky
turns against the scan from one observation to the next, and the
observations cross-link). Each band: a white sky, per-stream random-walk
(1/f-like) offsets, a per-stream ground term ``g0 + g1 az``, white
noise; weights uniform in [0.5, 2] with a fixed share set to zero.
The pointing is the configuration's, the same for every seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.inputs import stream_seed
from benchmark.inputs.flagship import ces_triangle, ces_xy


def stream_samples(cfg: dict) -> int:
    L = cfg["offset_length"]
    return (cfg["raw_samples"] // L) * L


def geometry(cfg: dict, device="cpu"):
    """``(pixels i32[N], ground_ids i32[N], az f32[N])`` on the host,
    streams in (observation, feed) order (worked out on ``device``)."""
    n, nx, ny, F, O = stream_samples(cfg), cfg["nx"], cfg["ny"], \
        cfg["n_feeds"], cfg["n_obs"]
    if nx != ny:
        raise ValueError(f"turned rasters need a square field, "
                         f"got {nx} x {ny}")
    # a side-m square keeps inside the field however it is turned
    m = int((nx - 1) / math.sqrt(2)) + 1
    raw = cfg["raw_samples"]
    dev = torch.device(device)
    xy = [ces_xy(raw, m, m, f, F) for f in range(F)]
    centre = (m - 1) / 2
    x = torch.as_tensor(np.stack([a[:n] for a, _ in xy]), device=dev)
    y = torch.as_tensor(np.stack([b[:n] for _, b in xy]), device=dev)
    x, y = x - centre, y - centre
    turn = torch.arange(O, dtype=torch.float64, device=dev) * (math.pi / O)
    c, s = torch.cos(turn)[:, None, None], torch.sin(turn)[:, None, None]
    px = torch.round((nx - 1) / 2 + c * x - s * y)
    py = torch.round((ny - 1) / 2 + s * x + c * y)
    pix = (py * nx + px).reshape(-1)
    del px, py
    if bool(((pix < 0) | (pix >= nx * ny)).any()):
        raise ValueError("the raster leaves the field")
    pix = pix.to(torch.int32).cpu().numpy()
    az_rows = np.stack([(2.0 * ces_triangle(raw, m, f, F)[:n] - 1.0)
                        for f in range(F)]).astype(np.float32)
    az = np.tile(az_rows.reshape(-1), O)
    gid = np.repeat(np.arange(O * F, dtype=np.int32), n)
    return pix, gid, az


def make_band(cfg: dict, model: dict, pix_dev: torch.Tensor,
              gid_dev: torch.Tensor, az_dev: torch.Tensor, seed: int,
              band: int):
    """One band's ``(tod, weights)`` as f32 tensors on the card, drawn
    from ``(seed, band)``; ``pix_dev``/``gid_dev`` are i64 and ``az_dev``
    f32, all [N] on the card."""
    dev = pix_dev.device
    L = cfg["offset_length"]
    N = pix_dev.numel()
    ng = cfg["n_obs"] * cfg["n_feeds"]
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, 3, band))
    sky = model["sky_rms"] * torch.randn(cfg["nx"] * cfg["ny"],
                                         generator=g, device=dev)
    steps = model["drift_step"] * torch.randn((ng, N // L // ng),
                                              generator=g, device=dev)
    offsets = torch.cumsum(steps, dim=1).reshape(-1)
    g0 = model["g0_rms"] * torch.randn(ng, generator=g, device=dev)
    g1 = model["g1_rms"] * torch.randn(ng, generator=g, device=dev)
    tod = torch.randn(N, generator=g, device=dev).mul_(model["white_rms"])
    tod += sky[pix_dev]
    tod += torch.repeat_interleave(offsets, L)
    tod += g0[gid_dev] + g1[gid_dev] * az_dev
    w = torch.rand(N, generator=g, device=dev).mul_(1.5).add_(0.5)
    zero = torch.rand(N, generator=g, device=dev) < \
        model["zero_weight_fraction"]
    w.masked_fill_(zero, 0.0)
    return tod, w
