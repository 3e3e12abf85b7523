"""A synthetic field run for the band solve: several observations of the
flagship's 19-feed CES raster through
:func:`~comapreduce_tpu_torch.cli.run_destriper.solve_band` with the
ground template and the two-level preconditioner — the path the
map-maker's ``[Inputs] ground : true`` field runs take
(``comapreduce_tpu/cli/run_destriper.py:1293-1308``).

Geometry (:func:`field_geometry`): each (observation, feed) stream is the
flagship's ``ces_pixels`` raster truncated to whole offsets, the data
layer's rule, so every ground group (one per stream) is offset-aligned.
``ces_pixels`` sweeps the az triangle exactly along the field's x axis,
which makes an az-linear template degenerate with a sky gradient in x;
odd observations therefore scan with x and y swapped, as the rising and
setting passes of a field cross-link it. ``az`` is the triangle
normalised to [-1, 1].

Signal (:func:`make_field_band`, numpy, seeded per band): a white sky,
per-group random-walk (1/f-like) offset drifts, a per-group ground term
``g0 + g1 * az``, white noise; weights uniform in [0.5, 2] with a few
zeros.

The matched-1/f variant (:func:`make_field_band_1f`) feeds the
offsets-only solve with the banded noise prior: no ground term, each
group's correlated noise drawn from the 1/f PSD its quality record
states, inverse-variance weights, and the records themselves (one group
without a record and one flagged, so the prior's fallbacks are taken).
Every band carries its per-group metadata (:func:`field_groups`), which
the banded prior joins against the records.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from comapreduce_tpu_torch.flagship import FULL, ces_pixels, ces_triangle
from comapreduce_tpu_torch.mapmaking.destriper import ground_ids_per_offset
from comapreduce_tpu_torch.mapmaking.leveldata import DestriperData

__all__ = ["FieldShape", "FIELD_FULL", "FIELD_SMALL", "OFFSET_LENGTH",
           "SOLVE_KW", "MG_KW", "SAMPLE_RATE", "field_geometry",
           "field_groups", "make_field_band", "make_field_band_1f",
           "invariants", "slope_errors", "SLOPE_ATOL"]

#: the band solve's settings for a ground field run: the ``run_destriper``
#: CLI defaults (``comapreduce_tpu/cli/run_destriper.py:1276-1308``:
#: offset length 50, ``niter`` 100, threshold 1e-6, two-level
#: preconditioner with coarse block 8)
OFFSET_LENGTH = 50
SOLVE_KW = dict(offset_length=OFFSET_LENGTH, use_ground=True, coarse_block=8,
                n_iter=100, threshold=1e-6)
#: ``[Destriper] preconditioner = multigrid`` at the CLI's defaults
#: (``comapreduce_tpu/cli/run_destriper.py:295-297``): two levels of
#: offset blocks from block 8, one smoothing step
MG_KW = {"levels": 2, "smooth": 1, "block": 8}
#: COMAP's Level-2 sample rate, Hz
SAMPLE_RATE = 50.0

SKY_RMS = 1.0
DRIFT_STEP = 0.05        # random-walk step of the offsets, per offset
G0_RMS = 1.0
G1_RMS = 0.5
WHITE_RMS = 0.1
ZERO_WEIGHT_FRACTION = 1e-3
# the matched-1/f variant: the reference's own fixture
# (tests/test_noise_weight.py::_matched_1f_problem), each group's
# parameters spread around it
NOISE_SIGMA = 0.05
NOISE_FKNEE = 1.0
NOISE_ALPHA = -1.5

#: largest |recovered - injected| az slope allowed per group, after the
#: one shift per scan orientation is taken out (:func:`slope_errors`).
#: Each group's scan is a straight line on the sky, so a sky gradient
#: along it is exactly an az-linear template, and its component across
#: the scan is slow enough for the offsets to absorb: a linear sky
#: gradient shifts every slope of one orientation alike and is barely
#: pinned. Measured on the CPU with numpy seeds 5-7 after the 100
#: iterations of the CLI default: at FIELD_SMALL at most 0.017, and
#: growing with size while the solve stays unconverged — 0.04 at
#: 4 x 4 x 20 000 samples on 64 x 64, 0.049 at 4 x 19 x 30 000 on
#: 128 x 128, 0.074 at 4 x 19 x 60 000 on 240 x 240 (the uncentred
#: errors reach 0.31 there); on an H100 at FIELD_FULL 0.075-0.107 over
#: the four bands (PERF.md). 0.25 is half the injected slopes' rms: a
#: template the solve lost (errors ~ the slopes themselves, up to ~1.2
#: over 76 groups) fails it.
SLOPE_ATOL = 0.25


@dataclass(frozen=True)
class FieldShape:
    """Observations x feeds of raw CES streams over an (ny, nx) field,
    and the number of bands."""

    n_obs: int
    n_feeds: int
    raw_samples: int
    nx: int
    ny: int
    n_bands: int = 4

    @property
    def stream_samples(self) -> int:
        return (self.raw_samples // OFFSET_LENGTH) * OFFSET_LENGTH

    @property
    def n_groups(self) -> int:
        return self.n_obs * self.n_feeds


#: four observations of the flagship pointing: 4 x 19 x 135 700 =
#: 10 313 200 samples per band, 76 groups, a 480 x 480 field
FIELD_FULL = FieldShape(4, FULL.n_feeds, FULL.n_samples, FULL.nx, FULL.ny)
#: the same path at a size the CPU tests take
FIELD_SMALL = FieldShape(2, 2, 4000, 12, 12, n_bands=2)


def field_geometry(shape: FieldShape):
    """``(pixels i32[N], ground_ids i32[N], az f32[N])`` of the field run,
    streams in (observation, feed) order."""
    if shape.nx != shape.ny:
        raise ValueError("cross-linked passes swap x and y: the field "
                         f"must be square, got {shape.nx} x {shape.ny}")
    n, nx, F = shape.stream_samples, shape.nx, shape.n_feeds
    npix = nx * shape.ny
    pix, gid, az = [], [], []
    for o in range(shape.n_obs):
        for f in range(F):
            p = ces_pixels(shape.raw_samples, nx, shape.ny, f, F)[:n]
            if ((p < 0) | (p >= npix)).any():
                raise ValueError("the raster leaves the field")
            if o % 2:
                p = (p % nx) * nx + p // nx
            pix.append(p)
            gid.append(np.full(n, o * F + f, np.int32))
            tri = ces_triangle(shape.raw_samples, nx, f, F)[:n]
            az.append((2.0 * tri - 1.0).astype(np.float32))
    return (np.concatenate(pix).astype(np.int32), np.concatenate(gid),
            np.concatenate(az))


def field_groups(shape: FieldShape) -> list:
    """Per-group metadata in group order (observation, feed): the file
    ``obs{o}.h5``, the feed, the sample rate and the kept samples."""
    return [{"file": f"obs{o}.h5", "feed": f, "sample_rate": SAMPLE_RATE,
             "n_samples": shape.stream_samples}
            for o in range(shape.n_obs) for f in range(shape.n_feeds)]


def make_field_band(shape: FieldShape, geometry, band: int,
                    seed: int = 5):
    """One band's :class:`DestriperData` and its truth
    (``{"sky", "offsets", "ground"}``), drawn with numpy from
    ``(seed, band)``."""
    pix, gid, az = geometry
    L = OFFSET_LENGTH
    N = pix.size
    ng = shape.n_groups
    rng = np.random.default_rng([seed, band])
    sky = rng.normal(0.0, SKY_RMS, shape.nx * shape.ny)
    steps = rng.normal(0.0, DRIFT_STEP, (ng, N // L // ng))
    offsets = np.cumsum(steps, axis=1).reshape(-1)
    ground = np.stack([rng.normal(0.0, G0_RMS, ng),
                       rng.normal(0.0, G1_RMS, ng)], axis=-1)
    tod = (sky[pix] + np.repeat(offsets, L) + ground[gid, 0]
           + ground[gid, 1] * az + rng.normal(0.0, WHITE_RMS, N))
    w = rng.uniform(0.5, 2.0, N)
    w[rng.random(N) < ZERO_WEIGHT_FRACTION] = 0.0
    data = DestriperData(tod=tod.astype(np.float32), pixels=pix,
                         weights=w.astype(np.float32), ground_ids=gid,
                         az=az, n_groups=ng, npix=shape.nx * shape.ny,
                         groups=field_groups(shape))
    return data, {"sky": sky, "offsets": offsets, "ground": ground}


def make_field_band_1f(shape: FieldShape, geometry, band: int,
                       seed: int = 5):
    """One band of the matched-1/f field run, drawn with numpy from
    ``(seed, band)``: ``(data, truth, quality)``.

    Each (observation, feed) group gets a 1/f model near the reference
    fixture's (white sigma 0.05 x [0.8, 1.25], knee 1 Hz x [0.7, 1.3],
    slope -1.5 + [-0.2, 0.2]); its correlated noise is drawn from
    ``sigma^2 (f / fknee)^alpha`` with random phases, plus white noise
    of rms sigma, on a white sky; its weights are ``1 / sigma^2``. No
    ground term. ``quality`` holds one record per group
    (``{"file", "feed", "band", "white_sigma", "fknee_hz", "alpha"}``)
    except group 1, which has none, and group ``n_groups - 2``, whose
    record is flagged: the banded prior keeps white weighting on those
    two. ``truth`` is ``{"sky", "corr"}`` (the correlated noise)."""
    pix, gid, az = geometry
    ng, T = shape.n_groups, shape.stream_samples
    if ng < 3:
        raise ValueError(f"the planted fallbacks need 3 groups, got {ng}")
    rng = np.random.default_rng([seed, band, 1])
    sky = rng.normal(0.0, SKY_RMS, shape.nx * shape.ny)
    sigma = NOISE_SIGMA * rng.uniform(0.8, 1.25, ng)
    fknee = NOISE_FKNEE * rng.uniform(0.7, 1.3, ng)
    alpha = NOISE_ALPHA + rng.uniform(-0.2, 0.2, ng)
    freqs = np.fft.rfftfreq(T, d=1.0 / SAMPLE_RATE)
    psd = np.zeros((ng, freqs.size))
    psd[:, 1:] = (sigma[:, None] ** 2
                  * (freqs[1:] / fknee[:, None]) ** alpha[:, None])
    amp = np.sqrt(psd * T * SAMPLE_RATE / 2.0) / np.sqrt(SAMPLE_RATE)
    phase = (rng.normal(size=psd.shape)
             + 1j * rng.normal(size=psd.shape))
    corr = np.fft.irfft(amp * phase, n=T, axis=-1).reshape(-1)
    white = np.repeat(sigma, T) * rng.normal(size=ng * T)
    tod = sky[pix] + corr + white
    w = np.repeat(1.0 / sigma ** 2, T)
    groups = field_groups(shape)
    absent, flagged = 1, ng - 2
    quality = []
    for g, meta in enumerate(groups):
        if g == absent:
            continue
        rec = {"file": meta["file"], "feed": meta["feed"], "band": band,
               "white_sigma": float(sigma[g]), "fknee_hz": float(fknee[g]),
               "alpha": float(alpha[g])}
        if g == flagged:
            rec["flagged"] = True
        quality.append(rec)
    data = DestriperData(tod=tod.astype(np.float32), pixels=pix,
                         weights=w.astype(np.float32), ground_ids=gid,
                         az=az, n_groups=ng,
                         npix=shape.nx * shape.ny, groups=groups)
    return data, {"sky": sky, "corr": corr}, quality


def invariants(result, data: DestriperData, offset_length: int) -> dict:
    """The null-space-invariant products of a ground solve, as numpy:
    the az slopes ``ground[:, 1]``, the per-offset baseline
    ``offsets + ground[group, 0]`` and the destriped map on hit pixels,
    each of the last two minus its mean (the system trades a global
    constant between map and baselines, and each group's ``g0`` against
    its offsets)."""
    g = result.ground.detach().cpu().numpy()
    gid_off = ground_ids_per_offset(data.ground_ids, offset_length)
    base = result.offsets.detach().cpu().numpy() + g[gid_off, 0]
    hit = result.hit_map.detach().cpu().numpy() > 0
    m = result.destriped_map.detach().cpu().numpy()[hit]
    return {"slopes": g[:, 1], "baseline": base - base.mean(),
            "map": m - m.mean()}


def slope_errors(result, truth: dict, shape: FieldShape) -> np.ndarray:
    """Recovered minus injected az slope per group, less the mean of
    that difference over the groups of the same scan orientation (even
    or odd observation): the shift a linear sky gradient makes
    indistinguishable (see :data:`SLOPE_ATOL`)."""
    err = result.ground[:, 1].detach().cpu().numpy() - truth["ground"][:, 1]
    orient = (np.arange(shape.n_groups) // shape.n_feeds) % 2
    for o in (0, 1):
        err[orient == o] -= err[orient == o].mean()
    return err
