"""The band solve of the destriping map-maker (port of
``comapreduce_tpu/cli/run_destriper.py``: ``_memoized``,
``_planned_solver``, ``_attach_dict`` and the non-sharded branch of
``solve_band``), plus :func:`pointing_plan`, the memoised plan.

:func:`solve_band` destripes one already-read band on the card (or on
the CPU when asked): offset-aligned ground groups go to the planned
joint [offsets; ground] solve, unaligned ones to the scatter path; the
two-level preconditioner rides ``coarse_block`` and the multigrid
V-cycle ``mg`` on the planned path, and a solve either makes diverge is
re-solved under plain Jacobi. ``noise_weight`` adds the measured-noise
banded offset prior to the offsets-only solves. The pointing plan, the
coarse pattern and the multigrid patterns are memoised on a digest of
the pixel stream, so the bands of one pointing share one host build of
each.

Host set-up stages log their wall clock on the ``comapreduce_tpu_torch``
logger at INFO level with ``extra={"stage": name, "seconds": s}``
(``plan_build``, ``coarse_pattern`` and ``mg_patterns`` once per
pointing, ``coarse_build`` and ``mg_build`` once per band).

Not ported yet (``NotImplementedError``): ``sharded``, ``watchdog``,
the checkpointed solve and the INI entry point (``main``).
"""

from __future__ import annotations

import functools
import hashlib
import logging
import time

import numpy as np
import torch

from comapreduce_tpu_torch._device import resolve_device
from comapreduce_tpu_torch.mapmaking.destriper import (
    MultigridUnavailable, _check_precond, build_coarse_preconditioner,
    build_multigrid_hierarchy, coarse_pattern, destripe, destripe_planned,
    ground_ids_per_offset, multigrid_patterns)
from comapreduce_tpu_torch.mapmaking.noise_weight import build_banded_weight
from comapreduce_tpu_torch.mapmaking.pointing_plan import build_pointing_plan

__all__ = ["solve_band", "pointing_plan"]

logger = logging.getLogger("comapreduce_tpu_torch")

# host memo: a multi-band run shares one pointing, so bands 1..3 reuse
# band 0's plan and coarse pattern; keyed on a digest of the pixel content
_PLAN_MEMO: dict = {}


def _memoized(tag: str, pixels: np.ndarray, extra_key: tuple, build):
    """Digest-keyed memo, one slot per tag (``run_destriper.py:63``)."""
    pixels = np.ascontiguousarray(pixels)
    key = (pixels.shape, str(pixels.dtype), extra_key,
           hashlib.sha1(memoryview(pixels)).hexdigest())
    slot = _PLAN_MEMO.get(tag)
    if slot is None or slot[0] != key:
        _PLAN_MEMO[tag] = slot = (key, build(pixels))
    return slot[1]


def pointing_plan(pixels: np.ndarray, npix: int, offset_length: int,
                  pair_batch: int | None = None):
    """The pointing plan of ``pixels``, built on the host once per
    pointing and memoised on a digest of the pixel content, so the bands
    of one pointing share it (the reference memoises its jitted solver
    around the plan, ``run_destriper.py:79``; there is no compilation to
    memoise here)."""
    def build(pix):
        t0 = time.perf_counter()
        plan = build_pointing_plan(pix, npix, offset_length,
                                   pair_batch=pair_batch)
        dt = time.perf_counter() - t0
        logger.info("pointing plan built on the host in %.3f s", dt,
                    extra={"stage": "plan_build", "seconds": dt})
        return plan

    return _memoized("plan", pixels,
                     (int(npix), int(offset_length), pair_batch), build)


def _planned_solver(pixels: np.ndarray, npix: int, offset_length: int,
                    n_iter: int, threshold: float, n_groups: int = 0,
                    precond: str = "jacobi", pair_batch: int | None = None,
                    mg_smooth: int = 1, cg_dot: str = "f32",
                    trace_iters: int = 0):
    """``destripe_planned`` bound to the memoised plan of ``pixels``
    (``run_destriper.py:79``)."""
    return functools.partial(
        destripe_planned,
        plan=pointing_plan(pixels, npix, offset_length, pair_batch),
        n_iter=n_iter, threshold=threshold, n_groups=n_groups,
        mg_smooth=mg_smooth, precond=precond, cg_dot=cg_dot,
        trace_iters=trace_iters)


def _coarse_pattern(pixels: np.ndarray, npix: int, offset_length: int,
                    block: int) -> dict:
    """The weights-independent half of the two-level build, memoised like
    the plan: every band of one pointing shares it, as the reference's
    joint path shares one (``run_destriper.py:1106``)."""
    def build(pix):
        t0 = time.perf_counter()
        pat = coarse_pattern(pix, npix, offset_length, block=block)
        dt = time.perf_counter() - t0
        logger.info("coarse pattern built on the host in %.3f s", dt,
                    extra={"stage": "coarse_pattern", "seconds": dt})
        return pat

    return _memoized("coarse-pattern", pixels,
                     (int(npix), int(offset_length), int(block)), build)


def _mg_patterns(pixels: np.ndarray, npix: int, offset_length: int,
                 block: int, levels: int) -> dict:
    """The weights-independent half of the multigrid build, memoised like
    the coarse pattern (the reference's joint path shares one pattern set
    across bands, ``run_destriper.py:1123``). Raises
    :class:`MultigridUnavailable` on a geometry with no ladder."""
    def build(pix):
        t0 = time.perf_counter()
        pats = multigrid_patterns(pix, npix, offset_length, block=block,
                                  levels=levels)
        dt = time.perf_counter() - t0
        logger.info("multigrid patterns built on the host in %.3f s", dt,
                    extra={"stage": "mg_patterns", "seconds": dt})
        return pats

    return _memoized("mg-patterns", pixels,
                     (int(npix), int(offset_length), int(block),
                      int(levels)), build)


def _build_banded(data, noise_weight, quality, band, offset_length,
                  n_offsets, unit=""):
    """The measured-noise banded prior of one band
    (``run_destriper.py:393``), every white fallback named in one
    warning. ``None`` when the knob is off or every group fell back (the
    white-weight solve then runs)."""
    if not noise_weight:
        return None
    banded, report = build_banded_weight(
        data.groups, quality or [], n_offsets, offset_length, band=band,
        bandwidth=int(noise_weight.get("bandwidth", 4)))
    if report["fallbacks"]:
        detail = ", ".join(f"{f['file']}/feed{f['feed']}:{f['reason']}"
                           for f in report["fallbacks"][:8])
        more = len(report["fallbacks"]) - 8
        logger.warning(
            "noise_weight=banded %s: %d group(s) kept white weighting "
            "(%s%s)", unit or "<band>", report["white"], detail,
            f", +{more} more" if more > 0 else "")
    if banded is None:
        logger.warning(
            "noise_weight=banded %s: every group fell back to white — "
            "running the white-weight solve (exact parity)",
            unit or "<band>")
    else:
        logger.info("noise_weight=banded %s: %d/%d group(s) weighted "
                    "from measured fits", unit or "<band>",
                    report["banded"], report["banded"] + report["white"])
    return banded


def _attach_dict(data, result):
    """Stamp the seen-pixel dictionary of a compacted solve onto the
    result (``run_destriper.py:220``)."""
    space = getattr(data, "pixel_space", None)
    if space is not None and space.compacted:
        return result._replace(sky_pixels=space.pixels)
    return result


def solve_band(data, offset_length=50, n_iter=100, threshold=1e-6,
               use_ground=False, sharded=False, coarse_block=0,
               watchdog=None, unit="", precond="jacobi", pair_batch=None,
               mg=None, x0=None, cg_dot="f32", noise_weight=None,
               quality=None, band=0, trace_iters=None, device=None):
    """Destripe one already-read band (``run_destriper.py:448``).

    ``data``: a :class:`~comapreduce_tpu_torch.mapmaking.leveldata.
    DestriperData` of numpy arrays; the solve runs on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``). Samples
    past the last whole offset are dropped. ``use_ground`` adds the
    per-group az-linear template: offset-aligned groups take the planned
    joint solve, others the scatter path under Jacobi.

    ``coarse_block > 0`` builds the two-level preconditioner on the host;
    ``mg`` (``{"levels", "smooth", "block"}``, the ``[Destriper]
    preconditioner = multigrid`` knobs) the multigrid hierarchy instead,
    falling back to Jacobi with a warning on a geometry too small for any
    level. A solve that diverges under either is re-solved with Jacobi —
    cold for the ground solve, from the best iterate otherwise.

    ``noise_weight`` (``{"bandwidth": q}``), ``quality`` (quality-ledger
    records) and ``band`` add the measured-noise banded offset prior
    (:func:`~comapreduce_tpu_torch.mapmaking.noise_weight.
    build_banded_weight` over ``data.groups``) to the offsets-only
    solve; the joint ground solve keeps white weighting, with a warning.
    ``cg_dot="compensated"`` runs the CG dots in float-float. ``x0``
    warm-starts the offsets-only solve. ``trace_iters=None`` means 0."""
    _check_precond(precond, coarse=coarse_block or None, mg=mg)
    unported = {"sharded": sharded or None, "watchdog": watchdog}
    for name, val in unported.items():
        if val is not None:
            raise NotImplementedError(
                f"solve_band({name}=...) is not ported yet")
    dev = resolve_device(device)
    trace_iters = int(trace_iters or 0)
    if noise_weight and use_ground:
        # the banded prior composes with the offsets-only operator; the
        # joint ground solve keeps the white-weight system
        logger.warning("noise_weight=banded: the joint ground solve "
                       "keeps white weighting")
        noise_weight = None
    if x0 is not None and use_ground:
        logger.warning("solver warm start x0 ignored: only the "
                       "offsets-only planned solve supports it")
        x0 = None
    L = int(offset_length)
    n = (np.size(data.tod) // L) * L

    def on_dev(a, dtype):
        return torch.as_tensor(np.asarray(a[:n], dtype), device=dev)

    tod = on_dev(data.tod, np.float32)
    weights = on_dev(data.weights, np.float32)
    gid_off = None
    if use_ground:
        try:
            gid_off = ground_ids_per_offset(np.asarray(data.ground_ids[:n]),
                                            L)
        except ValueError:
            gid_off = None
        if gid_off is None:
            # groups not offset-aligned: the scatter path takes
            # per-sample group ids
            if coarse_block or mg:
                logger.warning("%s active but the ground groups are not "
                               "offset-aligned; scatter fallback runs "
                               "Jacobi only",
                               "multigrid" if mg else "coarse_precond")
            return _attach_dict(data, destripe(
                tod, on_dev(data.pixels, np.int64), weights, data.npix,
                offset_length=L, n_iter=n_iter, threshold=threshold,
                ground_ids=on_dev(data.ground_ids, np.int64),
                az=on_dev(data.az, np.float32), n_groups=data.n_groups,
                precond=precond, cg_dot=cg_dot))
    pixels = np.asarray(data.pixels[:n])
    w_host = np.asarray(data.weights[:n])
    kwargs = {}
    if coarse_block:
        pattern = _coarse_pattern(pixels, data.npix, L, int(coarse_block))
        t0 = time.perf_counter()
        grp, aci = build_coarse_preconditioner(
            pixels, w_host, data.npix, L, block=int(coarse_block),
            pattern=pattern)
        dt = time.perf_counter() - t0
        logger.info("coarse preconditioner built on the host in %.3f s",
                    dt, extra={"stage": "coarse_build", "seconds": dt})
        kwargs["coarse"] = (torch.as_tensor(grp, device=dev),
                            torch.as_tensor(aci, device=dev))
    elif mg is not None:
        try:
            pats = _mg_patterns(pixels, data.npix, L, int(mg["block"]),
                                int(mg["levels"]))
        except MultigridUnavailable as exc:
            # a 1-block coarse system is pure null mode and would diverge
            # by construction: Jacobi instead, loudly
            logger.warning("multigrid unavailable for this geometry (%s); "
                           "running Jacobi", exc)
            mg = None
        else:
            t0 = time.perf_counter()
            kwargs["mg"] = build_multigrid_hierarchy(
                pixels, w_host, data.npix, L, patterns=pats)
            dt = time.perf_counter() - t0
            logger.info("multigrid hierarchy built on the host in %.3f s",
                        dt, extra={"stage": "mg_build", "seconds": dt})
    banded = _build_banded(data, noise_weight, quality, band, L, n // L,
                           unit=unit)
    if banded is not None:
        kwargs["banded"] = (torch.as_tensor(banded[0], device=dev),
                            torch.as_tensor(banded[1], device=dev))
    # the banded prior belongs to the system (A + B), not to the
    # preconditioner: the re-solve below keeps it
    sys_kw = {"banded": kwargs["banded"]} if "banded" in kwargs else {}
    fn = _planned_solver(pixels, data.npix, L, n_iter, threshold,
                         n_groups=data.n_groups if use_ground else 0,
                         precond=precond, pair_batch=pair_batch,
                         mg_smooth=int(mg["smooth"]) if mg else 1,
                         cg_dot=cg_dot, trace_iters=trace_iters)
    ground_kw = {}
    if use_ground:
        ground_kw = {"ground_off": torch.as_tensor(gid_off, device=dev),
                     "az": on_dev(data.az, np.float32)}
    elif x0 is not None:
        kwargs["x0"] = torch.as_tensor(np.asarray(x0), device=dev)
    result = fn(tod, weights, **ground_kw, **kwargs)
    if ("coarse" in kwargs or "mg" in kwargs) and bool(torch.any(
            torch.as_tensor(result.diverged) != 0)):
        # the divergence tripwire fired under the two-level or multigrid
        # preconditioner: re-solve under plain Jacobi, recorded, not
        # silent (run_destriper.py:795)
        which = "multigrid" if "mg" in kwargs else "coarse"
        if use_ground:
            logger.warning("CG diverged under the %s preconditioner "
                           "(%s); re-solving ground solve with Jacobi "
                           "from a cold start", which, unit or "band")
            result = fn(tod, weights, **ground_kw)
        else:
            logger.warning("CG diverged under the %s preconditioner "
                           "(%s); re-solving with Jacobi from the best "
                           "iterate", which, unit or "band")
            result = fn(tod, weights, x0=result.offsets, **sys_kw)
    return _attach_dict(data, result)
