"""``FitSource``: calibrator source fitting (port of
``comapreduce_tpu/calibration/source_fit.py``, ``AstroCalibration.py``
parity).

For a calibrator observation: the source position (catalogue or
ephemerides), the pointing rotated into source-relative tangent-plane
coordinates, the Level-2 TOD high-passed by a rolling median (K2 on the
card: one launch over every (feed, band) row) and binned into one small
map per (feed, band) with the port's ``accumulate_weights``/``bin_map``
(every map of the observation in one segment sum over one pixel stream,
in a fixed order on the card), then a rotated
2-D Gaussian fitted to all maps as one batch
(:mod:`comapreduce_tpu_torch.calibration.fitting`).

Writes ``{source}_source_fit/{fits, errors, chi2}`` with the reference's
parameter order (``AstroCalibration.py:560-562``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from comapreduce_tpu_torch.astro import coordinates as coords
from comapreduce_tpu_torch.calibration import fitting
from comapreduce_tpu_torch.mapmaking.binning import (accumulate_weights,
                                                     bin_map, pixel_stream)
from comapreduce_tpu_torch.mapmaking.wcs import WCS
from comapreduce_tpu_torch.ops.median_filter import rolling_median
from comapreduce_tpu_torch.pipeline.registry import register
from comapreduce_tpu_torch.pipeline.stages import _StageBase

__all__ = ["FitSource", "bin_source_maps", "fit_source_maps"]

logger = logging.getLogger("comapreduce_tpu_torch")

ERROR_FUNCS = ("analytic", "bootstrap", "posterior")


def bin_source_maps(tod: torch.Tensor, weights: torch.Tensor, dx, dy,
                    wcs: WCS, medfilt_window: int = 401):
    """High-pass + bin all (feed, band) streams into source-relative maps
    (``source_fit.py:37``).

    ``tod``/``weights``: f32[F, B, T] on the device the work runs on;
    ``dx``/``dy``: f32[F, T] [deg] (host arrays: the pixelisation runs on
    the host, as in the reference). Returns (maps, wmaps), each
    f32[F, B, npix] on the device of ``tod``.
    """
    F, B, T = tod.shape
    hp = tod - rolling_median(tod, min(medfilt_window,
                                       max(3, T // 2 * 2 - 1)))
    npix = wcs.npix
    pix = np.stack([wcs.ang2pix(dx[f], dy[f]) for f in range(F)])  # (F, T)
    # map (f, b) owns ids [(f B + b) npix, (f B + b + 1) npix); a sample
    # outside the field stays -1, the drop slot of every map
    base = (np.arange(F * B, dtype=np.int64) * npix).reshape(F, B, 1)
    ids = np.where(pix[:, None, :] >= 0, pix[:, None, :] + base, -1)
    ids = pixel_stream(torch.as_tensor(ids.reshape(-1), device=tod.device),
                       F * B * npix)
    w = weights.reshape(-1)
    sw = accumulate_weights(ids, w, F * B * npix)
    maps = bin_map(hp.reshape(-1), ids, w, F * B * npix, sum_w=sw)
    return maps.reshape(F, B, npix), sw.reshape(F, B, npix)


def _source_plane_coords(wcs: WCS, device) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """f32 (x, y) [deg] of every pixel centre of a source-relative
    ``wcs``, the longitude wrapped to (-180, 180] around the source."""
    xg, yg = wcs.pixel_centers()
    x = torch.as_tensor(xg.ravel(), dtype=torch.float32, device=device)
    x = (x + 180.0) % 360.0 - 180.0
    y = torch.as_tensor(yg.ravel(), dtype=torch.float32, device=device)
    return x, y


def fit_source_maps(maps: torch.Tensor, wmaps: torch.Tensor, wcs: WCS,
                    beam_fwhm_deg: float = 0.075,
                    error_func: str = "analytic", seed: int = 0,
                    n_boot: int = 64, n_steps: int = 1500):
    """Fit every (feed, band) map as one batch (``source_fit.py:61``).
    ``maps``/``wmaps``: f32[F, B, npix] tensors on the device the fits
    run on. Returns numpy (params, errors, chi2) with shapes (F, B, 7),
    (F, B, 7), (F, B).

    ``error_func`` selects the error estimate, the reference's
    ``Gauss2dRot_General`` choices (``Tools/Fitting.py:363-531``):
    'analytic' (inv(J^T J)), 'bootstrap' (pixel resampling, ``n_boot``
    replicas a map) or 'posterior' (Metropolis chains of ``n_steps``),
    their draws from a generator seeded with ``seed``. A map with no more
    hit pixels than parameters gets NaN errors.
    """
    if error_func not in ERROR_FUNCS:
        # fail before the LM pass, not after it
        raise ValueError(f"unknown error_func {error_func!r} (use "
                         "'analytic', 'bootstrap', or 'posterior')")
    x, y = _source_plane_coords(wcs, maps.device)
    flat_m = maps.reshape(-1, maps.shape[-1])
    flat_w = wmaps.reshape(-1, wmaps.shape[-1])
    p0 = fitting.initial_guess(flat_m, x, y, flat_w, beam_fwhm_deg)
    p, e, c2 = fitting.fit_gauss2d(flat_m, x, y, flat_w, p0)
    # the analytic pass converged p and its covariance: the bootstrap and
    # the chains start from it without another LM solve
    if error_func != "analytic":
        gen = torch.Generator(device=maps.device)
        gen.manual_seed(seed)
        if error_func == "bootstrap":
            _, e = fitting.bootstrap_fit_gauss2d(
                gen, flat_m, x, y, flat_w, p, n_boot=n_boot, refit=False)
        else:
            _, samples, _ = fitting.posterior_fit_gauss2d(
                gen, flat_m, x, y, flat_w, p, n_steps=n_steps,
                proposal_sigma=e)
            e = samples.reshape(samples.shape[0], -1,
                                samples.shape[-1]).std(dim=1,
                                                       correction=0)
    # every path: a dead map gets NaN errors, never a ~0 error bar that
    # inverse-variance weights would read as infinite precision
    dead = (flat_w > 0).sum(-1) <= e.shape[-1]
    e = torch.where(dead[:, None], torch.full_like(e, np.nan), e)
    F, B = maps.shape[:2]
    return (p.reshape(F, B, -1).cpu().numpy(),
            e.reshape(F, B, -1).cpu().numpy(),
            c2.reshape(F, B).cpu().numpy())


@register()
@dataclass
class FitSource(_StageBase):
    """Pipeline stage: fit the calibrator source of an observation
    (``source_fit.py:123``).

    ``variant`` names the expected source (legacy ``FitSource(jupiter)``
    sections); by default the file's own source attribute is used. A
    file whose source is no calibrator sets ``STATE = False`` (the
    runner then stops the file's chain there, as the reference's
    does). ``figure_dir`` writes the feed-0, band-0 postage stamp with
    its fit and, for ``error_func = 'posterior'``, the corner plot of
    its chain (``diagnostics``)."""

    variant: str = ""
    nx: int = 120
    ny: int = 120
    cdelt_deg: float = 1.0 / 60.0     # reference: 0.5' over 200 pix;
    beam_fwhm_deg: float = 0.075      # same 1.67 deg square field
    medfilt_window: int = 401
    error_func: str = "analytic"
    figure_dir: str = ""

    def pre_init(self, data) -> None:
        # groups depend on the observed source; the runner calls pre_init
        # before the contains() resume check (Running.py:141-143)
        src = self.variant or data.source_name or "source"
        self.groups = (f"{src}_source_fit",)

    def source_maps(self, data, level2):
        """The observation's source-relative maps: ``(maps, wmaps, wcs,
        (src, ra0, dec0))``, the maps f32[F, B, npix] on the stage's
        device (the Level-2 TOD high-passed on K2 and binned)."""
        dev = self._device()
        src = self.variant or data.source_name
        tod = torch.as_tensor(np.asarray(level2.tod, dtype=np.float32),
                              device=dev)                       # (F, B, T)
        weights = torch.as_tensor(np.asarray(
            level2["averaged_tod/weights"], dtype=np.float32), device=dev)
        ra = np.asarray(data.ra, np.float64)                    # (F, T)
        dec = np.asarray(data.dec, np.float64)
        ra0, dec0, _ = coords.source_position(src,
                                              float(np.mean(data.mjd)))
        F = tod.shape[0]
        dx = np.empty_like(ra, dtype=np.float64)
        dy = np.empty_like(dec, dtype=np.float64)
        for f in range(F):
            dx[f], dy[f] = coords.rotate(ra[f], dec[f], float(ra0),
                                         float(dec0))
        wcs = WCS.from_field((0.0, 0.0), (self.cdelt_deg, self.cdelt_deg),
                             (self.nx, self.ny))
        maps, wmaps = bin_source_maps(tod, weights, dx.astype(np.float32),
                                      dy.astype(np.float32), wcs,
                                      self.medfilt_window)
        return maps, wmaps, wcs, (src, float(ra0), float(dec0))

    def __call__(self, data, level2) -> bool:
        self._device()
        src = self.variant or data.source_name
        if not data.is_calibrator and src not in coords.CALIBRATORS \
                and src.lower() not in ("jupiter", "moon", "mars", "venus"):
            logger.info("FitSource: %s is not a calibrator; skipping",
                        src or "<none>")
            self.STATE = False
            return False
        maps, wmaps, wcs, (src, ra0, dec0) = self.source_maps(data, level2)
        params, errors, chi2 = fit_source_maps(maps, wmaps, wcs,
                                               self.beam_fwhm_deg,
                                               error_func=self.error_func)
        g = f"{src}_source_fit"
        if self.figure_dir:
            self._plot(data, maps, wmaps, wcs, params, errors, src, g)
        self._data = {f"{g}/fits": params, f"{g}/errors": errors,
                      f"{g}/chi2": chi2}
        self._attrs = {g: {"source": src, "ra0": ra0, "dec0": dec0,
                           "mjd": float(np.mean(data.mjd))}}
        self.STATE = True
        return True

    def _plot(self, data, maps, wmaps, wcs, params, errors, src, g):
        """Feed 0, band 0: the postage stamp with the fitted beam
        (``AstroCalibration.py:615-641``) and, for posterior errors, the
        corner plot of a chain seeded at the fit (``Fitting.py:363-531``).
        """
        from comapreduce_tpu_torch import diagnostics

        m2d = maps[0, 0].cpu().numpy().reshape(self.ny, self.nx)
        p = np.asarray(params[0, 0], np.float64).copy()
        if p.size >= 5:   # world offsets (deg) -> pixel coordinates
            p[1] = p[1] / self.cdelt_deg + self.nx / 2.0
            p[3] = p[3] / self.cdelt_deg + self.ny / 2.0
            p[2] = p[2] / self.cdelt_deg
            p[4] = p[4] / self.cdelt_deg
        diagnostics.plot_source_fit(
            diagnostics.figure_path(self.figure_dir, data.obsid,
                                    f"{g}_feed00_band00"),
            m2d, p, source=src, feed=0, band=0)
        if self.error_func != "posterior" or \
                not np.isfinite(errors[0, 0]).all():
            return
        x, y = _source_plane_coords(wcs, maps.device)
        gen = torch.Generator(device=maps.device)
        gen.manual_seed(0)
        as_row = lambda v: torch.as_tensor(  # noqa: E731
            np.asarray(v, np.float32)[None], device=maps.device)
        _, samples, _ = fitting.posterior_fit_gauss2d(
            gen, maps[0, 0][None], x, y, wmaps[0, 0][None],
            as_row(params[0, 0]), proposal_sigma=as_row(errors[0, 0]))
        diagnostics.plot_sed_corner(
            diagnostics.figure_path(self.figure_dir, data.obsid,
                                    f"{g}_feed00_band00_posterior"),
            samples.reshape(-1, params.shape[-1]).cpu().numpy(),
            ["A", "x0", "sx", "y0", "sy", "theta", "off"])
