"""The destriping map-maker's entry point (port of
``comapreduce_tpu/cli/run_destriper.py``)::

    python -m comapreduce_tpu_torch.cli.run_destriper [--device=cpu] \
        parameters.ini

:func:`main` reads the INI (``[Inputs]``, ``[Pixelization]``,
``[Destriper]``, ``[Precision]``), reads each band of the filelist's
Level-2 files (:func:`~comapreduce_tpu_torch.mapmaking.leveldata.
read_comap_data`), solves it and writes ``{prefix}_band{b}.fits`` into
``output_dir``: by default all bands as one multi-RHS solve
(:func:`make_band_maps_joint`), per band (:func:`make_band_map`) under
``ground : true`` or ``joint : false``, in checkpointed chunks under
``[Destriper] checkpoint_every``. It runs on the card; ``--device=cpu``
runs the plain versions. :func:`parse_destriper_section` validates the
``[Destriper]`` section as the reference does.

:func:`solve_band` destripes one already-read band on the card (or on
the CPU when asked): offset-aligned ground groups go to the planned
joint [offsets; ground] solve, unaligned ones to the scatter path; the
two-level preconditioner rides ``coarse_block`` and the multigrid
V-cycle ``mg`` on the planned path, and a solve either makes diverge is
re-solved under plain Jacobi. ``noise_weight`` adds the measured-noise
banded offset prior to the offsets-only solves. ``watchdog`` puts the
solve under the ``mapmaking.cg_solve`` wall budget. The pointing plan,
the coarse pattern and the multigrid patterns are memoised on a digest
of the pixel stream, so the bands of one pointing share one host build
of each.

:func:`solve_band_checkpointed` runs the band solve in warm-started
chunks with a durable snapshot after each, so a killed solve resumes.
:func:`solve_bands_joint` solves every band of one pointing as one
multi-RHS CG (the reference's default multi-band route), and
:func:`write_band_map` writes a result as a WCS image or a HEALPix map.

Host set-up stages log their wall clock on the ``comapreduce_tpu_torch``
logger at INFO level with ``extra={"stage": name, "seconds": s}``
(``plan_build``, ``coarse_pattern`` and ``mg_patterns`` once per
pointing, ``coarse_build`` and ``mg_build`` once per band).

:func:`main` runs the reference's ``[Resilience]`` runtime around the
reads (the quarantine ledger, retry, chaos, the read watchdog, masked
events of the non-finite scrub) with a heartbeat in the state directory
(``[Inputs] log_dir``, default ``<output_dir>/logs``) and, unless
``lease_ttl_s : 0``, claims its file set under heartbeat-fenced leases in
``<state_dir>/destriper``, committed once the maps are written;
``--retry-quarantined`` re-admits quarantined files. ``[Slo]
exclude_flagged`` drops the files whose quality records (the ledger
``run_average`` wrote into the same state directory) are flagged, and
``[Destriper] noise_weight = banded`` weights each group's offsets with
the banded prior built from those records' noise fits.

The ``[Inputs]`` ingest knobs run as in the reference: ``prefetch``
reads ahead on a background thread, ``cache_mb`` (with ``spill_dir``)
keeps one :class:`~comapreduce_tpu_torch.ingest.BlockCache` across the
band reads, so the bands after the first decode nothing, and
``writeback`` writes band N's FITS maps on a background writer while band
N + 1 solves, with a flush barrier before exit. ``[Precision] tod_dtype
= bf16`` narrows the streamed TOD (refused on a dense HEALPix map, where
it buys nothing).

``[Telemetry]`` (``enabled``, ``flush_s``, ``jax_profiler``) opens rank
0's event stream in the state directory: the reads' spans, the
checkpointed solve's ``destriper.cg_chunk`` spans, and every planned
solve's per-iteration trace (``solver.rank0.jsonl``, with the
``solver.*`` progress gauges). ``--live-port=N`` serves the live
observability sidecar (:class:`~comapreduce_tpu_torch.telemetry.live.
LiveServer`) over the state directory while the run goes on.

``[Control] solver_policy`` re-picks the preconditioner rung from this
state directory's solver traces and the run registry
(:func:`~comapreduce_tpu_torch.control.policy.choose_solver`, every
override an auditable ``control.decision``); its program-cost and
``[Tuning]`` sources are not ported.

Not ported (``NotImplementedError``, naming the knob): ``sharded``;
``kernels`` other than ``auto`` (they select TPU implementations); and in
:func:`main` more than one rank (``COMAP_NRANKS``), ``[Inputs]
compile_cache_dir`` (XLA's persistent compilation cache) and
``[Tuning]``. The rules are those of
:func:`~comapreduce_tpu_torch.pipeline.runner.unported_knobs`, the INI
sections mapped onto its tables.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import os
import sys
import time

import numpy as np
import torch

from comapreduce_tpu_torch._device import resolve_device
from comapreduce_tpu_torch.control.config import ControlConfig
from comapreduce_tpu_torch.mapmaking import healpix as hp
from comapreduce_tpu_torch.mapmaking.destriper import (
    MultigridUnavailable, _check_precond, build_coarse_preconditioner,
    build_multigrid_hierarchy, coarse_pattern, destripe, destripe_planned,
    ground_ids_per_offset, load_solver_checkpoint, multigrid_patterns,
    save_solver_checkpoint, stack_multigrid, watched_solve)
from comapreduce_tpu_torch.mapmaking.fits_io import (write_fits_image,
                                                     write_healpix_map)
from comapreduce_tpu_torch.mapmaking.noise_weight import (build_banded_weight,
                                                          stack_banded)
from comapreduce_tpu_torch.mapmaking.pixel_space import PixelSpace
from comapreduce_tpu_torch.mapmaking.pointing_plan import build_pointing_plan
from comapreduce_tpu_torch.telemetry import solver_trace
from comapreduce_tpu_torch.telemetry.core import TELEMETRY

__all__ = ["main", "make_band_map", "make_band_maps_joint",
           "parse_destriper_section", "solve_band",
           "solve_band_checkpointed", "checkpoint_id", "solve_bands_joint",
           "band_map_writer", "write_band_map", "pointing_plan"]

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
                    compact: bool = False, precond: str = "jacobi",
                    pair_batch: int | None = None, mg_smooth: int = 1,
                    cg_dot: str = "f32", trace_iters: int = 0):
    """``destripe_planned`` bound to the memoised plan of ``pixels``
    (``run_destriper.py:79``). ``compact=True`` returns ``(fn, uniq)``:
    the solve returns maps over the plan's hit pixels ``uniq`` only, and
    the caller expands them on the host."""
    plan = pointing_plan(pixels, npix, offset_length, pair_batch)
    fn = functools.partial(
        destripe_planned, plan=plan, n_iter=n_iter, threshold=threshold,
        n_groups=n_groups, dense_maps=not compact, mg_smooth=mg_smooth,
        precond=precond, cg_dot=cg_dot, trace_iters=trace_iters)
    if compact:
        return fn, np.asarray(plan.uniq_pixels)
    return fn


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


def _host(x) -> np.ndarray:
    """A result field as host numpy (one copy off the card)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _expand_compact(uniq: np.ndarray, npix: int, compact) -> np.ndarray:
    """Compact (hit-pixel) map over ``uniq`` -> the band's full pixel
    space, on the host (``run_destriper.py:195``)."""
    full = np.zeros(npix, np.float32)
    full[uniq] = _host(compact)[: uniq.size]
    return full


def _expand_joint_results(res, uniq: np.ndarray, npix: int, nb: int):
    """Split one compact multi-RHS result into per-band dense results
    (``run_destriper.py:203``): the destriped, naive and weight maps are
    expanded on the host per band, the hit map (pointing alone) once;
    offsets and residuals stay per-band rows on the solve's device.
    ``diverged`` may be one flag for all bands (0-d)."""
    maps = {k: _host(getattr(res, k)) for k in
            ("destriped_map", "naive_map", "weight_map")}
    hit_full = _expand_compact(uniq, npix, res.hit_map)
    div = _host(res.diverged)
    return [res._replace(
        offsets=res.offsets[i],
        destriped_map=_expand_compact(uniq, npix, maps["destriped_map"][i]),
        naive_map=_expand_compact(uniq, npix, maps["naive_map"][i]),
        weight_map=_expand_compact(uniq, npix, maps["weight_map"][i]),
        hit_map=hit_full,
        residual=res.residual[i],
        diverged=div[i] if div.ndim else div) for i in range(nb)]


def _watched_cg(solve, watchdog, unit: str, device: torch.device):
    """Run ``solve`` under the ``mapmaking.cg_solve`` wall budget and
    turn a blown hard deadline into the operator warning
    (``run_destriper.py:430``), for the per-band and joint solves alike.

    The watch closes when the watched callable returns, and a solve on
    the card returns once its last kernels are queued: the callable
    waits for ``device`` first, so the watchdog times the solve, not
    its launches."""
    def synced():
        result = solve()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return result

    result, state = watched_solve(synced, watchdog, unit=unit)
    if state is not None and state.hard_expired:
        logger.warning(
            "CG solve %s blew its wall budget (%.1f s > hard "
            "%.1f s); the map below is LATE, not wrong — raise the "
            "mapmaking.cg_solve deadline or investigate the stall",
            unit or "<band>", state.elapsed_s, state.hard_s)
    return result


def _attach_dict(data, result):
    """Stamp the seen-pixel dictionary of a compacted solve onto the
    result (``run_destriper.py:220``)."""
    space = getattr(data, "pixel_space", None)
    if space is not None and space.compacted:
        return result._replace(sky_pixels=space.pixels)
    return result


class _Tracer:
    """Records a planned solve's trace (``telemetry.solver_trace``) under
    the reference's labels, letter for letter, since ``solver_report``
    groups convergence by them: ``precond_id`` is the applied
    preconditioner (``multigrid``, ``twolevel`` or ``precond``, plus
    ``|nw=banded``; ``jacobi-fallback`` once the divergence re-solve
    runs) and ``|L{offset_length}``, ``precision_id``
    ``tod={dtype}|cgdot={cg_dot}``, ``bucket`` ``L={L}|N={samples}``. An
    untraced result records nothing. ``record`` keyword arguments go to
    ``record_solve`` (``band``, ``bands``, ``base``)."""

    def __init__(self, tod, offset_length, threshold, cg_dot, kwargs,
                 precond, **record):
        self.offset_length, self.threshold = offset_length, threshold
        self.banded = "banded" in kwargs
        self.label = ("multigrid" if "mg" in kwargs
                      else "twolevel" if "coarse" in kwargs else precond)
        if self.banded:
            self.label += "|nw=banded"
        self.precision_id = f"tod={getattr(tod, 'dtype', 'f32')}" \
                            f"|cgdot={cg_dot}"
        self.bucket = f"L={offset_length}|N={int(np.size(tod))}"
        self.record = record

    def __call__(self, result):
        if getattr(result, "trace", None) is not None:
            solver_trace.record_solve(
                result, precond_id=f"{self.label}|L{self.offset_length}",
                precision_id=self.precision_id, threshold=self.threshold,
                bucket=self.bucket, **self.record)

    def fallback(self, diverged):
        """Record the diverged attempt (the decay that tripped the
        monitor is what ``solver_report`` is opened for); later records
        carry the Jacobi re-solve's label."""
        self(diverged)
        self.label = "jacobi-fallback" + ("|nw=banded" if self.banded
                                          else "")


def solve_band(data, offset_length=50, n_iter=100, threshold=1e-6,
               use_ground=False, sharded=False, coarse_block=0,
               watchdog=None, unit="", precond="jacobi", pair_batch=None,
               mg=None, x0=None, cg_dot="f32", noise_weight=None,
               quality=None, band=0, trace_iters=None, trace_base=0,
               device=None):
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
    warm-starts the offsets-only solve.

    ``watchdog`` (a :class:`~comapreduce_tpu_torch.resilience.watchdog.
    Watchdog`) puts the whole solve, re-solves included, under the
    ``mapmaking.cg_solve`` wall budget; a blown hard deadline logs a
    warning naming ``unit`` (the result is late, not wrong).

    ``trace_iters`` controls the per-iteration solver trace
    (:mod:`~comapreduce_tpu_torch.telemetry.solver_trace`,
    docs/OPERATIONS.md §17): ``None`` (the default) traces the planned
    paths to depth ``n_iter`` whenever telemetry is on, ``0`` turns the
    trace off, and a positive depth caps the history. The loop fills
    the histories on the device; they are copied to the host once, after
    the solve, and a traced solve appends iteration and summary records
    to ``solver.rank{r}.jsonl`` under the telemetry log dir.
    ``trace_base`` offsets the recorded global iteration numbers (the
    checkpointed chunk loop passes its running count). The scatter
    fallback stays untraced."""
    _check_precond(precond, coarse=coarse_block or None, mg=mg)
    if sharded:
        raise NotImplementedError("solve_band(sharded=...) is not ported "
                                  "yet")
    dev = resolve_device(device)
    if trace_iters is None:
        trace_iters = int(n_iter) if solver_trace.trace_enabled() else 0
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
    if watchdog is not None:
        return _watched_cg(
            lambda: solve_band(data, offset_length=offset_length,
                               n_iter=n_iter, threshold=threshold,
                               use_ground=use_ground,
                               coarse_block=coarse_block, unit=unit,
                               precond=precond, pair_batch=pair_batch,
                               mg=mg, x0=x0, cg_dot=cg_dot,
                               noise_weight=noise_weight, quality=quality,
                               band=band, trace_iters=trace_iters,
                               trace_base=trace_base, device=dev),
            watchdog, unit, dev)
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
    trace = _Tracer(data.tod, offset_length, threshold, cg_dot, kwargs,
                    precond, band=unit or "band", base=trace_base)
    result = fn(tod, weights, **ground_kw, **kwargs)
    if ("coarse" in kwargs or "mg" in kwargs) and bool(torch.any(
            torch.as_tensor(result.diverged) != 0)):
        # the divergence tripwire fired under the two-level or multigrid
        # preconditioner: re-solve under plain Jacobi, recorded, not
        # silent (run_destriper.py:795)
        which = "multigrid" if "mg" in kwargs else "coarse"
        trace.fallback(result)
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
    trace(result)
    return _attach_dict(data, result)


def checkpoint_id(data, offset_length=50, threshold=1e-6, precond_tag="",
                  **kw) -> str:
    """The id a solver snapshot of :func:`solve_band_checkpointed` is
    written and loaded under (``run_destriper.py:906-928``, character for
    character, so snapshots keep the reference's refusal rules across
    packages): the solve configuration and the trimmed sample count, plus
    ``cgdot=``, ``nw=banded`` and ``precond_tag`` when set. ``kw`` are
    :func:`solve_band`'s knobs."""
    mg = kw.get("mg") or {}
    precond_id = "|".join(str(v) for v in (
        kw.get("precond", "jacobi"), int(kw.get("coarse_block", 0) or 0),
        int(mg.get("block", 0) or 0), offset_length, threshold,
        (int(data.tod.size) // offset_length) * offset_length))
    if kw.get("cg_dot", "f32") != "f32":
        precond_id = f"{precond_id}|cgdot={kw['cg_dot']}"
    if kw.get("noise_weight"):
        precond_id = f"{precond_id}|nw=banded"
    if precond_tag:
        precond_id = f"{precond_id}|{precond_tag}"
    return precond_id


def solve_band_checkpointed(data, checkpoint_path, checkpoint_every,
                            offset_length=50, n_iter=100,
                            threshold=1e-6, watchdog=None, unit="",
                            x0=None, precond_tag="", **kw):
    """:func:`solve_band` in durable checkpoint/resume chunks
    (``run_destriper.py:842``, ``[Destriper] checkpoint_every``).

    The band solves in chunks of ``checkpoint_every`` iterations, each
    warm-started from the last iterate through ``solve_band``'s ``x0``;
    after every chunk ``(x, iterations done, residual history,
    preconditioner id)`` is durably written to ``checkpoint_path``
    (:func:`~comapreduce_tpu_torch.mapmaking.destriper.
    save_solver_checkpoint`, the offsets taken off the solve's device as
    f32 numpy). A relaunch loads the snapshot and pays only the
    remaining iterations; a torn, foreign-schema or other-operator
    snapshot is discarded and the solve starts cold. The snapshot is
    deleted once the solve completes. Warm-started chunks follow another
    Krylov path than one uninterrupted solve, so a chunked solve agrees
    with an unchunked one only to the solver's tolerance.

    ``x0`` is an initial warm start, used only when no snapshot resumes.
    ``precond_tag`` is appended to the preconditioner id. ``kw`` goes to
    :func:`solve_band` (``device`` included). With ``checkpoint_every <=
    0`` or on the ground path (no ``x0`` warm start there) this is one
    plain :func:`solve_band`. Returns the last chunk's result with the
    cumulative ``n_iter`` and the last residual."""
    chunk = int(checkpoint_every)
    if chunk <= 0 or kw.get("sharded") or kw.get("use_ground"):
        if chunk > 0:
            logger.warning(
                "checkpoint_every=%d ignored: the sharded/ground solve "
                "paths have no x0 warm start, so a resumed chunk would "
                "restart cold and checkpointing would only add I/O",
                chunk)
        return solve_band(data, offset_length=offset_length,
                          n_iter=n_iter, threshold=threshold,
                          watchdog=watchdog, unit=unit, x0=x0, **kw)
    precond_id = checkpoint_id(data, offset_length, threshold,
                               precond_tag, **kw)
    snap = load_solver_checkpoint(checkpoint_path, precond_id=precond_id)
    x0 = None if x0 is None else np.asarray(_host(x0), np.float32)
    done, residuals = 0, []
    if snap is not None:
        x0 = np.asarray(snap["offsets"])
        done = int(snap["n_done"])
        residuals = list(snap["residuals"])
        logger.info("solver checkpoint %s: resuming %s at iteration %d "
                    "of %d", checkpoint_path, unit or "<band>", done,
                    n_iter)
    result = None
    while True:
        step = max(min(chunk, n_iter - done), 1)
        t_chunk = time.perf_counter()
        result = solve_band(data, offset_length=offset_length,
                            n_iter=step, threshold=threshold,
                            watchdog=watchdog, unit=unit, x0=x0,
                            trace_base=done, **kw)
        ran = int(result.n_iter)
        done += ran
        residual = float(result.residual)
        residuals.append(residual)
        x0 = result.offsets.detach().to("cpu", torch.float32).numpy()
        save_solver_checkpoint(checkpoint_path, x0, done, residuals,
                               precond_id)
        TELEMETRY.event_span("destriper.cg_chunk",
                             time.perf_counter() - t_chunk,
                             unit=unit or "<band>", iters=ran,
                             n_done=done, residual=residual,
                             precond_id=precond_id)
        # ran < step: the chunk converged (or was converged on entry)
        # before its budget ran out
        if done >= n_iter or residual <= threshold or ran < step:
            break
    try:
        os.unlink(checkpoint_path)
    except OSError:
        pass
    return result._replace(n_iter=torch.tensor(done, dtype=torch.int32),
                           residual=torch.tensor(residuals[-1],
                                                 dtype=torch.float32))


def solve_bands_joint(datas, bands, offset_length=50, n_iter=100,
                      threshold=1e-6, coarse_block=0, watchdog=None,
                      precond="jacobi", pair_batch=None, mg=None,
                      cg_dot="f32", noise_weight=None, quality=None,
                      trace_iters=None, device=None):
    """All bands of one pointing in one multi-RHS planned solve: the
    non-sharded solve of ``make_band_maps_joint``
    (``run_destriper.py:1006-1175``) over bands already read.

    ``datas``: one :class:`~comapreduce_tpu_torch.mapmaking.leveldata.
    DestriperData` per entry of ``bands``. Returns ``None`` when their
    sample counts or pixel streams differ (the reference's ``(datas,
    None)``: the caller then solves each band with :func:`solve_band` on
    the same ``datas``); otherwise one result per band.

    The ``(nb, n)`` TOD and weights are stacked on ``device`` (default
    ``cuda``); ``coarse_block`` builds one coarse pattern and ``mg`` one
    multigrid pattern set, each with one build per band, stacked;
    ``noise_weight`` stacks the per-band banded priors. The compact solve
    (maps over the plan's hit pixels) runs under ``watchdog`` as unit
    ``joint``; if it diverges under the coarse or multigrid
    preconditioner it is re-solved with Jacobi from its best iterates,
    keeping the banded prior (``joint(fallback)``). The maps are expanded
    on the host, and a compacted pixel space's dictionary is stamped on
    each band's result.

    ``trace_iters`` is :func:`solve_band`'s: ``None`` traces to depth
    ``n_iter`` whenever telemetry is on, ``0`` turns the trace off. A
    traced joint solve records one stream per band (``band{b}``) through
    :func:`~comapreduce_tpu_torch.telemetry.solver_trace.record_solve`'s
    multi-RHS path. (The reference's joint route passes no depth and
    records nothing; the records here are those its ``record_solve``
    writes for a multi-RHS result.)"""
    dev = resolve_device(device)
    if trace_iters is None:
        trace_iters = int(n_iter) if solver_trace.trace_enabled() else 0
    pix0 = np.asarray(datas[0].pixels)
    for d in datas[1:]:
        if np.size(d.tod) != np.size(datas[0].tod) \
                or not np.array_equal(np.asarray(d.pixels), pix0):
            return None
    npix = datas[0].npix
    nb = len(bands)
    L = int(offset_length)
    n = (np.size(datas[0].tod) // L) * L
    pix = pix0[:n]
    tod = torch.empty((nb, n), dtype=torch.float32, device=dev)
    wgt = torch.empty((nb, n), dtype=torch.float32, device=dev)
    w_host = []
    for i, d in enumerate(datas):
        w_host.append(np.asarray(d.weights[:n], np.float32))
        tod[i] = torch.as_tensor(np.asarray(d.tod[:n], np.float32))
        wgt[i] = torch.as_tensor(w_host[i])
    kwargs = {}
    if coarse_block:
        pat = _coarse_pattern(pix, npix, L, int(coarse_block))
        pre = []
        for i in range(nb):
            t0 = time.perf_counter()
            pre.append(build_coarse_preconditioner(
                pix, w_host[i], npix, L, block=int(coarse_block),
                pattern=pat))
            dt = time.perf_counter() - t0
            logger.info("coarse preconditioner built on the host in "
                        "%.3f s", dt,
                        extra={"stage": "coarse_build", "seconds": dt})
        kwargs["coarse"] = (torch.as_tensor(pre[0][0], device=dev),
                            torch.as_tensor(np.stack([p[1] for p in pre]),
                                            device=dev))
    elif mg is not None:
        try:
            pats = _mg_patterns(pix, npix, L, int(mg["block"]),
                                int(mg["levels"]))
        except MultigridUnavailable as exc:
            logger.warning("multigrid unavailable for this geometry "
                           "(%s); running Jacobi", exc)
            mg = None
        else:
            hier = []
            for i in range(nb):
                t0 = time.perf_counter()
                hier.append(build_multigrid_hierarchy(
                    pix, w_host[i], npix, L, patterns=pats))
                dt = time.perf_counter() - t0
                logger.info("multigrid hierarchy built on the host in "
                            "%.3f s", dt,
                            extra={"stage": "mg_build", "seconds": dt})
            kwargs["mg"] = stack_multigrid(hier)
    if noise_weight:
        banded = stack_banded(
            [_build_banded(datas[i], noise_weight, quality, b, L, n // L,
                           unit=f"band{b}(joint)")
             for i, b in enumerate(bands)])
        if banded is not None:
            kwargs["banded"] = (torch.as_tensor(banded[0], device=dev),
                                torch.as_tensor(banded[1], device=dev))
    # the banded prior is part of the linear system, not the
    # preconditioner: the divergence re-solve keeps it
    sys_kw = {"banded": kwargs["banded"]} if "banded" in kwargs else {}
    fn, uniq = _planned_solver(pix, npix, L, n_iter, threshold,
                               compact=True, precond=precond,
                               pair_batch=pair_batch,
                               mg_smooth=int(mg["smooth"]) if mg else 1,
                               cg_dot=cg_dot, trace_iters=trace_iters)
    trace = _Tracer(datas[0].tod, offset_length, threshold, cg_dot, kwargs,
                    precond, band="joint",
                    bands=[f"band{b}" for b in bands])
    res = _watched_cg(lambda: fn(tod, wgt, **kwargs), watchdog, "joint",
                      dev)
    if ("coarse" in kwargs or "mg" in kwargs) and bool(torch.any(
            torch.as_tensor(res.diverged) != 0)):
        logger.warning(
            "joint CG diverged under the %s preconditioner "
            "(diverged=%s); re-solving with Jacobi from the best "
            "iterates", "multigrid" if "mg" in kwargs else "coarse",
            _host(res.diverged))
        trace.fallback(res)
        first = res
        res = _watched_cg(
            lambda: fn(tod, wgt, x0=first.offsets, **sys_kw),
            watchdog, "joint(fallback)", dev)
    trace(res)
    return [_attach_dict(d, r) for d, r in
            zip(datas, _expand_joint_results(res, uniq, npix, nb))]


def band_map_writer(path, data, result):
    """Materialise the output maps on the host and return a zero-argument
    writer over them (``run_destriper.py:1178``). The writer captures
    only the maps and the map geometry, never the band's ``data``.

    A result's maps may lie on the card: they are copied to host numpy
    here, once. The seen-pixel dictionary comes from
    ``result.sky_pixels`` when the solve attached one, else from
    ``data``. Written products are always f32, asserted here."""
    maps = {
        "DESTRIPED": np.array(_host(result.destriped_map), np.float32),
        "NAIVE": np.array(_host(result.naive_map), np.float32),
        "WEIGHTS": np.array(_host(result.weight_map), np.float32),
        "HITS": np.array(_host(result.hit_map), np.float32),
    }
    assert all(v.dtype == np.float32 for v in maps.values()), \
        "map products must be f32 regardless of the precision policy"
    wcs, sky_pixels, nside = data.wcs, data.sky_pixels, data.nside
    space = getattr(data, "pixel_space", None)
    if getattr(result, "sky_pixels", None) is not None:
        npix_sky = wcs.npix if wcs is not None else hp.nside2npix(nside)
        space = PixelSpace.from_dictionary(
            np.asarray(result.sky_pixels), npix_sky)
        sky_pixels = space.pixels

    def write() -> None:
        if wcs is not None:
            # compacted WCS solves scatter to the field here, the one
            # write-time expansion; dense solves pass through
            vals = maps if space is None or not space.compacted else \
                {k: space.expand(v) for k, v in maps.items()}
            shaped = {k: v.reshape(wcs.ny, wcs.nx)
                      for k, v in vals.items()}
            write_fits_image(path, shaped, header=dict(wcs.header_cards()))
        elif sky_pixels is not None:
            # compacted HEALPix: partial map over the dictionary
            write_healpix_map(path, maps, sky_pixels, nside)
        else:
            # dense HEALPix: every sky pixel explicit
            write_healpix_map(path, maps,
                              np.arange(maps["WEIGHTS"].shape[-1],
                                        dtype=np.int64), nside)

    return write


def write_band_map(path, data, result):
    """Write the destriped, naive, weight and hit maps of one band
    (``run_destriper.py:1237``)."""
    band_map_writer(path, data, result)()


# ``[Destriper]`` knob values (``destriper.py:68``, ``pallas_binning.py:84``)
CONFIG_PRECONDITIONERS = ("none", "jacobi", "twolevel", "multigrid")
CONFIG_KERNELS = ("auto", "xla", "pallas", "interpret")


def _refuse_kernels(kernels: str) -> None:
    if str(kernels) != "auto":
        raise NotImplementedError(
            f"[Destriper] kernels = {kernels}: it selects the JAX package's "
            "TPU or XLA implementations; the port runs its CUDA kernels "
            "(kernels = auto)")


def parse_destriper_section(destr: dict, coarse_default: int = 0):
    """``[Destriper]`` knobs -> ``(precond, coarse_block, pair_batch, mg,
    kernels, noise_weight)``, validated as the reference does
    (``run_destriper.py:232``), with the same exceptions:
    ``preconditioner = none | jacobi | twolevel | multigrid`` (absent: the
    ``[Inputs] coarse_precond`` default ``coarse_default`` stands),
    ``coarse_block`` only under twolevel, ``mg_levels``/``mg_smooth``/
    ``mg_block`` only under multigrid, ``pair_batch = N | auto``,
    ``checkpoint_every >= 0`` (returned by the caller), ``kernels = auto |
    xla | pallas | interpret`` and ``noise_weight = white | banded`` with
    ``noise_bandwidth`` only under banded. Only ``kernels = auto`` runs
    in the port; the callers refuse the others."""
    coarse_block = int(coarse_default)
    mg = None
    pname = str(destr.get("preconditioner", "")).strip().lower()
    if pname not in ("",) + CONFIG_PRECONDITIONERS:
        raise ValueError(
            f"[Destriper] preconditioner must be "
            f"{'|'.join(CONFIG_PRECONDITIONERS)}, got {pname!r}")
    if "coarse_block" in destr and pname != "twolevel":
        raise ValueError(
            "[Destriper] coarse_block only applies under preconditioner"
            f"=twolevel (preconditioner is {pname or 'absent'!r}); remove "
            "the knob or select twolevel")
    mg_knobs = [k for k in ("mg_levels", "mg_smooth", "mg_block")
                if k in destr]
    if mg_knobs and pname != "multigrid":
        raise ValueError(
            f"[Destriper] {'/'.join(mg_knobs)} only apply under "
            f"preconditioner=multigrid (preconditioner is "
            f"{pname or 'absent'!r}); remove the knob(s) or select "
            "multigrid")
    precond = "none" if pname == "none" else "jacobi"
    if pname in ("none", "jacobi"):
        coarse_block = 0
    elif pname == "multigrid":
        coarse_block = 0
        mg = {"levels": int(destr.get("mg_levels", 2)),
              "smooth": int(destr.get("mg_smooth", 1)),
              "block": int(destr.get("mg_block", 8))}
        if mg["levels"] < 1 or mg["smooth"] < 1 or mg["block"] < 2:
            raise ValueError(
                f"[Destriper] multigrid knobs out of range (mg_levels "
                f">= 1, mg_smooth >= 1, mg_block >= 2): {mg}")
    elif pname == "twolevel":
        if "coarse_block" in destr:
            coarse_block = int(destr["coarse_block"])
            if coarse_block < 1:
                raise ValueError(
                    "[Destriper] coarse_block must be >= 1 under "
                    f"preconditioner=twolevel, got {coarse_block}")
        else:
            coarse_block = coarse_block or 8
    pb_raw = destr.get("pair_batch", "auto")
    pair_batch = (None if str(pb_raw).strip().lower() in ("auto", "")
                  else int(pb_raw))
    if pair_batch is not None and pair_batch < 1:
        raise ValueError(f"[Destriper] pair_batch must be >= 1 or auto, "
                         f"got {pb_raw!r}")
    if int(destr.get("checkpoint_every", 0) or 0) < 0:
        raise ValueError(
            f"[Destriper] checkpoint_every must be >= 0 (0 = off), got "
            f"{destr.get('checkpoint_every')!r}")
    kernels = str(destr.get("kernels", "auto")).strip().lower() or "auto"
    if kernels not in CONFIG_KERNELS:
        raise ValueError(f"[Destriper] kernels must be "
                         f"{'|'.join(CONFIG_KERNELS)}, got "
                         f"{destr.get('kernels')!r}")
    nw_raw = str(destr.get("noise_weight", "white")).strip().lower()
    if nw_raw not in ("", "white", "banded"):
        raise ValueError(f"[Destriper] noise_weight must be white|banded, "
                         f"got {destr.get('noise_weight')!r}")
    if "noise_bandwidth" in destr and nw_raw != "banded":
        raise ValueError(
            "[Destriper] noise_bandwidth only applies under noise_weight"
            f"=banded (noise_weight is {nw_raw or 'absent'!r}); remove "
            "the knob or select banded")
    noise_weight = None
    if nw_raw == "banded":
        noise_weight = {"bandwidth": int(destr.get("noise_bandwidth", 4))}
        if noise_weight["bandwidth"] < 1:
            raise ValueError(
                f"[Destriper] noise_bandwidth must be >= 1, got "
                f"{destr.get('noise_bandwidth')!r}")
    return precond, coarse_block, pair_batch, mg, kernels, noise_weight


def make_band_map(filenames, band, wcs=None, nside=None, galactic=False,
                  offset_length=50, n_iter=100, threshold=1e-6,
                  use_ground=False, use_calibration=True, sharded=False,
                  medfilt_window=400, tod_variant="auto",
                  coarse_block=0, prefetch=0, cache=None,
                  resilience=None, precond="jacobi", pair_batch=None,
                  mg=None, compact="auto", kernels="auto",
                  tod_dtype="f32", cg_dot="f32", noise_weight=None,
                  quality=None, device=None):
    """Read one band of a filelist and destripe it
    (``run_destriper.py:350``): :func:`~comapreduce_tpu_torch.mapmaking.
    leveldata.read_comap_data` then :func:`solve_band`, both on
    ``device`` (default ``cuda``). Returns ``(DestriperData, result)``."""
    from comapreduce_tpu_torch.mapmaking.leveldata import read_comap_data

    _refuse_kernels(kernels)
    if sharded:
        raise NotImplementedError("make_band_map(sharded=...) is not "
                                  "ported")
    dev = resolve_device(device)
    data = read_comap_data(filenames, band=band, wcs=wcs, nside=nside,
                           galactic=galactic, offset_length=offset_length,
                           use_calibration=use_calibration,
                           medfilt_window=medfilt_window,
                           tod_variant=tod_variant,
                           prefetch=prefetch, cache=cache,
                           resilience=resilience, compact=compact,
                           tod_dtype=tod_dtype, device=dev)
    return data, solve_band(data, offset_length=offset_length,
                            n_iter=n_iter, threshold=threshold,
                            use_ground=use_ground,
                            coarse_block=coarse_block,
                            watchdog=getattr(resilience, "watchdog",
                                             None),
                            unit=f"band{band}", precond=precond,
                            pair_batch=pair_batch, mg=mg, cg_dot=cg_dot,
                            noise_weight=noise_weight, quality=quality,
                            band=band, device=dev)


def make_band_maps_joint(filenames, bands, wcs=None, nside=None,
                         galactic=False, offset_length=50, n_iter=100,
                         threshold=1e-6, use_calibration=True,
                         medfilt_window=400, sharded=False,
                         tod_variant="auto", coarse_block=0,
                         prefetch=0, cache=None, resilience=None,
                         watchdog=None, precond="jacobi",
                         pair_batch=None, mg=None, compact="auto",
                         kernels="auto", tod_dtype="f32", cg_dot="f32",
                         noise_weight=None, quality=None, device=None):
    """All bands of a filelist in one multi-RHS solve
    (``run_destriper.py:962``, the non-sharded route): each band read
    with :func:`~comapreduce_tpu_torch.mapmaking.leveldata.
    read_comap_data`, then :func:`solve_bands_joint` on ``device``.
    Returns ``(datas, results)``, or ``(datas, None)`` when the bands'
    sample streams differ; the caller then solves each band of the same
    ``datas`` with :func:`solve_band`."""
    from comapreduce_tpu_torch.mapmaking.leveldata import read_comap_data

    _refuse_kernels(kernels)
    if sharded:
        raise NotImplementedError("make_band_maps_joint(sharded=...) is "
                                  "not ported")
    dev = resolve_device(device)
    datas = [read_comap_data(filenames, band=b, wcs=wcs, nside=nside,
                             galactic=galactic,
                             offset_length=offset_length,
                             use_calibration=use_calibration,
                             medfilt_window=medfilt_window,
                             tod_variant=tod_variant,
                             prefetch=prefetch, cache=cache,
                             resilience=resilience, compact=compact,
                             tod_dtype=tod_dtype, device=dev)
             for b in bands]
    results = solve_bands_joint(
        datas, bands, offset_length=offset_length, n_iter=n_iter,
        threshold=threshold, coarse_block=coarse_block, watchdog=watchdog,
        precond=precond, pair_batch=pair_batch, mg=mg, cg_dot=cg_dot,
        noise_weight=noise_weight, quality=quality, device=dev)
    return datas, results


def _aslist(v):
    return v if isinstance(v, list) else [v]


# the INI sections whose knobs runner.unported_knobs judges, and the
# table each maps onto; [Inputs] is mixed, so only its ingest knobs go
_INI_TABLES = {"tuning": "Tuning"}


def _unported_ini(ini) -> list[str]:
    """``[Section] option`` names of the INI's set knobs whose machinery
    the port lacks: :func:`~comapreduce_tpu_torch.pipeline.runner.
    unported_knobs` over the sections mapped onto its tables."""
    from comapreduce_tpu_torch.ingest.config import IngestConfig
    from comapreduce_tpu_torch.pipeline.runner import unported_knobs

    inputs = ini.get("Inputs", {})
    tables = {t: (dict(ini[s]) if s in ini else None)
              for t, s in _INI_TABLES.items()}
    tables["ingest"] = {k: inputs[k] for k in IngestConfig.KNOBS
                        if k in inputs}
    sections = dict(_INI_TABLES, ingest="Inputs")
    bad = []
    for name in unported_knobs(tables):
        table, knob = name.split(".", 1)
        bad.append(f"[{sections[table]}] {knob}")
    return bad


def main(argv=None, device=None) -> int:
    """The INI entry point (``run_destriper.py:1242``), as rank 0 of 1.
    ``--device=DEV`` (or ``device``) picks the device; default ``cuda``."""
    from comapreduce_tpu_torch.ingest.config import IngestConfig
    from comapreduce_tpu_torch.mapmaking.leveldata import read_comap_data
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.ops.precision import PrecisionPolicy
    from comapreduce_tpu_torch.pipeline.config import (IniConfig,
                                                       read_filelist)
    from comapreduce_tpu_torch.pipeline.scheduler import Scheduler
    from comapreduce_tpu_torch.resilience.config import ResilienceConfig
    from comapreduce_tpu_torch.telemetry.core import TelemetryConfig
    from comapreduce_tpu_torch.telemetry.quality import (SloConfig,
                                                         flagged_files,
                                                         read_quality)

    argv = sys.argv[1:] if argv is None else argv
    retry_quarantined = False
    live_port = None
    rest = []
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag == "--live-port":
            # the live observability sidecar (docs/OPERATIONS.md §16)
            live_port = int(a.split("=", 1)[1])
        elif flag == "--device":
            device = a.split("=", 1)[1]
        elif a == "--retry-quarantined":
            retry_quarantined = True
        else:
            rest.append(a)
    if len(rest) != 1:
        print("usage: python -m comapreduce_tpu_torch.cli.run_destriper "
              "[--device=DEV] [--retry-quarantined] [--live-port=N] "
              "parameters.ini",
              file=sys.stderr)
        return 2
    ini = IniConfig(rest[0])
    inputs = ini.get("Inputs", {})
    pixel = ini.get("Pixelization", {})
    n_ranks = int(os.environ.get("COMAP_NRANKS") or 1)
    if n_ranks > 1:
        raise NotImplementedError(
            f"COMAP_NRANKS={n_ranks}: several ranks (filelist shards, "
            "per-rank maps) are not ported; the port runs as rank 0 of 1")
    bad = _unported_ini(ini)
    if bool(inputs.get("sharded", False)):
        bad.append("[Inputs] sharded")
    if bad:
        raise NotImplementedError(
            "not ported: " + ", ".join(bad) + " (the port runs without "
            "XLA's compile_cache_dir or [Tuning])")
    dev = resolve_device(device)
    filelist = read_filelist(inputs["filelist"])
    out_dir = inputs.get("output_dir", ".")
    os.makedirs(out_dir, exist_ok=True)
    prefix = inputs.get("prefix", "map")
    bands = [int(b) for b in _aslist(inputs.get("bands", [0, 1, 2, 3]))]
    offset_length = int(inputs.get("offset_length", 50))
    n_iter = int(inputs.get("niter", 100))
    threshold = float(inputs.get("threshold", 1e-6))
    calibrator = bool(inputs.get("calibrator", False))
    if calibrator:  # the reference's overrides
        offset_length = int(inputs.get("offset_length", 250))
        threshold = 1.0

    wcs = nside = None
    if str(pixel.get("type", "wcs")).lower() == "healpix":
        nside = int(pixel.get("nside", 512))
    else:
        crval = [float(x) for x in _aslist(pixel.get("crval", [0.0, 0.0]))]
        cdelt = [float(x) for x in _aslist(pixel.get(
            "cdelt", [1.0 / 60.0, 1.0 / 60.0]))]
        shape = [int(x) for x in _aslist(pixel.get("shape", [480, 480]))]
        wcs = WCS.from_field(tuple(crval), tuple(cdelt), tuple(shape))

    use_ground = bool(inputs.get("ground", False))
    use_cal = bool(inputs.get("calibration", True))
    galactic = bool(pixel.get("galactic", False))
    tod_variant = str(inputs.get("tod_variant", "auto"))
    # the two-level preconditioner (block 8) is the field-run default;
    # calibrator runs (threshold 1) converge in a few iterations without
    # it. `coarse_precond : 0` disables it
    coarse_block = int(inputs.get("coarse_precond",
                                  0 if calibrator else 8))
    destr_sec = ini.get("Destriper", {})
    precond, coarse_block, pair_batch, mg, kernels, noise_weight = \
        parse_destriper_section(destr_sec, coarse_block)
    _refuse_kernels(kernels)
    checkpoint_every = int(destr_sec.get("checkpoint_every", 0) or 0)
    # validated at config load, before any file is read
    compact = str(pixel.get("compact", "auto")).strip().lower()
    if compact not in ("auto", "true", "false"):
        raise ValueError(f"[Pixelization] compact must be "
                         f"auto|true|false, got {compact!r}")
    prec = PrecisionPolicy.coerce(dict(ini.get("Precision", {})) or None)
    if prec.tod_dtype == "bf16" and nside is not None \
            and compact == "false":
        # dense HEALPix map vectors dominate memory: narrowed TOD buys
        # nothing there, and the solve would still take the rounding
        raise ValueError(
            "[Precision] tod_dtype = bf16 with [Pixelization] "
            "compact = false on a HEALPix grid: dense map vectors "
            "dominate memory, so narrowed TOD buys nothing here — "
            "set compact : auto/true, or tod_dtype : f32")
    # [Inputs] ingest: read-ahead, and one cache across the band reads
    ingest_cfg = IngestConfig.from_mapping(inputs)
    prefetch = ingest_cfg.prefetch
    cache = ingest_cfg.make_cache()
    # [Resilience]: coerce, so a typo'd knob raises; the campaign
    # default turns elastic claiming on unless lease_ttl_s is given.
    # One runtime (one ledger) serves every band's read
    res_cfg = ResilienceConfig.coerce_campaign(
        dict(ini.get("Resilience", {})))
    if retry_quarantined:
        res_cfg = dataclasses.replace(res_cfg, retry_quarantined=True)
    # run state (heartbeats, leases, solver snapshots, the quality
    # ledger run_average wrote) under `[Inputs] log_dir`, default
    # <output_dir>/logs
    state_dir = str(inputs.get("log_dir", "") or
                    os.path.join(out_dir, "logs"))
    os.makedirs(state_dir, exist_ok=True)
    # [Control] solver_policy (default off): re-pick the preconditioner
    # rung from evidence — this state dir's solver traces and the
    # run-registry iteration delta — instead of trusting the static
    # [Destriper] knobs (run_destriper.py:1461). Every override is an
    # auditable control.decision event; no evidence leaves the static
    # config byte-for-byte. Rung evidence is folded per shape bucket:
    # only solves stamped with this run's offset-length bucket argue
    # its rungs.
    control_cfg = ControlConfig.coerce(dict(ini.get("Control", {}))
                                       or None)
    if control_cfg.solver_policy:
        from comapreduce_tpu_torch.control.policy import choose_solver
        from comapreduce_tpu_torch.telemetry.registry import \
            default_registry_path

        # the effective rung the decisions are measured against (the
        # parse collapses twolevel/multigrid into flags)
        rung = ("multigrid" if mg is not None
                else "twolevel" if coarse_block > 0
                else precond)
        choice = choose_solver(
            state_dir,
            static={"preconditioner": rung,
                    "mg_block": mg["block"] if mg else None,
                    "pair_batch": pair_batch,
                    "offset_length": offset_length},
            registry_path=default_registry_path(),
            bucket=f"L={offset_length}")
        for reason in choice.get("reasons", ()):
            logger.warning("[Control] solver_policy: %s", reason)
        overrides = {k: v for k, v in choice.items() if k != "reasons"}
        if overrides:
            # apply by re-parsing an overridden copy of [Destriper] so
            # every knob validation (mg ranges, coarse_block gating)
            # governs the policy's picks too
            destr_over = dict(destr_sec)
            new_rung = str(overrides.get("preconditioner", rung))
            destr_over["preconditioner"] = new_rung
            if new_rung != "twolevel":
                destr_over.pop("coarse_block", None)
            if new_rung != "multigrid":
                for k in ("mg_levels", "mg_smooth", "mg_block"):
                    destr_over.pop(k, None)
            elif "mg_block" in overrides:
                destr_over["mg_block"] = int(overrides["mg_block"])
            if "pair_batch" in overrides:
                destr_over["pair_batch"] = int(overrides["pair_batch"])
            precond, coarse_block, pair_batch, mg, kernels, \
                noise_weight = parse_destriper_section(
                    destr_over, int(inputs.get("coarse_precond",
                                               0 if calibrator else 8)))
    # [Telemetry]: this rank's event stream beside the leases and
    # heartbeats, so the map-maker's spans and solver traces merge with
    # a reduction campaign's
    tcfg = TelemetryConfig.coerce(dict(ini.get("Telemetry", {})) or None)
    if tcfg.enabled and not TELEMETRY.enabled:
        TELEMETRY.configure(state_dir, rank=0, flush_s=tcfg.flush_s,
                            jax_profiler=tcfg.jax_profiler)
    resilience = res_cfg.make_runtime(out_dir, rank=0, n_ranks=1,
                                      state_dir=state_dir)
    live = None
    if live_port is not None:
        # one sidecar per campaign: the plane reads every rank's state
        # off disk
        from comapreduce_tpu_torch.telemetry.live import LiveServer

        live = LiveServer(state_dir, port=live_port,
                          stale_s=res_cfg.lease_ttl_s or 60.0,
                          n_ranks=1).start()
        print(f"live plane: http://{live.host}:{live.port}/metrics",
              flush=True)
    # [Slo] exclude_flagged (default off): files whose latest quality
    # record is flagged drop out like quarantined ones
    slo_cfg = SloConfig.coerce(dict(ini.get("Slo", {})) or None)
    if slo_cfg.exclude_flagged:
        flagged = flagged_files(state_dir)
        kept = [f for f in filelist if os.path.basename(f) not in flagged]
        if len(kept) < len(filelist):
            logger.warning(
                "[Slo] exclude_flagged: dropping %d of %d file(s) "
                "with flagged quality records",
                len(filelist) - len(kept), len(filelist))
        filelist = kept
    writeback = None
    if ingest_cfg.writeback >= 1:
        # band N + 1's solve overlaps band N's FITS write; the flush
        # barrier below surfaces any write error before exit
        from comapreduce_tpu_torch.data.writeback import Writeback

        writeback = Writeback(depth=ingest_cfg.writeback,
                              watchdog=resilience.watchdog,
                              chaos=resilience.chaos,
                              name="map-writeback")
    if resilience.heartbeat is not None:
        resilience.heartbeat.start()
    sched = None
    if res_cfg.lease_ttl_s > 0:
        # claim the file set under leases up front (a dead rank's expired
        # leases are stolen here), in a destriper-owned subdirectory so
        # the reduction's done leases are never taken for this run's;
        # sorted, so the map over a stolen set equals a clean run's
        sched = Scheduler(list(filelist),
                          os.path.join(state_dir, "destriper"),
                          heartbeat_dir=state_dir, rank=0, n_ranks=1,
                          lease_ttl_s=res_cfg.lease_ttl_s,
                          steal_after_s=res_cfg.steal_after_s,
                          ledger=resilience.ledger,
                          chaos=resilience.chaos,
                          heartbeat=resilience.heartbeat)
        filelist = sorted(sched.claim_iter())
    quality = None
    if noise_weight:
        # the measured per-(file, feed, band) noise fits come from the
        # quality ledger in the same state directory; none is not an
        # error: every group then keeps white weighting
        quality = read_quality(state_dir)
        if not quality:
            logger.warning(
                "noise_weight=banded: no quality records under %s — "
                "all groups will keep white weighting", state_dir)
    if checkpoint_every > 0 and use_ground:
        # the ground solve has no warm start: a resumed chunk would
        # restart cold and only pay snapshot I/O
        logger.warning(
            "[Destriper] checkpoint_every=%d disabled: the "
            "sharded/ground solve paths have no warm-start resume",
            checkpoint_every)
        checkpoint_every = 0
    # bands of one pointing solve as one multi-RHS CG; ground solves keep
    # their own path, and `[Inputs] joint : false` forces per-band solves
    use_joint = bool(inputs.get("joint", True))
    if checkpoint_every > 0 and use_joint and len(bands) > 1:
        # snapshots are per band; the multi-RHS solve cannot checkpoint
        logger.info("checkpoint_every=%d: per-band checkpointed solves "
                    "(joint multi-RHS path disabled for this run)",
                    checkpoint_every)
        use_joint = False
    joint_datas = joint_results = None
    if use_joint and len(bands) > 1 and not use_ground:
        joint_datas, joint_results = make_band_maps_joint(
            filelist, bands, wcs=wcs, nside=nside, galactic=galactic,
            offset_length=offset_length, n_iter=n_iter,
            threshold=threshold, use_calibration=use_cal,
            tod_variant=tod_variant, coarse_block=coarse_block,
            prefetch=prefetch, cache=cache,
            resilience=resilience, watchdog=resilience.watchdog,
            precond=precond, pair_batch=pair_batch, mg=mg,
            compact=compact, tod_dtype=prec.tod_dtype, cg_dot=prec.cg_dot,
            noise_weight=noise_weight, quality=quality, device=dev)
        if joint_results is None:
            print("bands read different sample sets; falling back to "
                  "per-band solves (reusing the reads)")

    for i, band in enumerate(bands):
        if joint_results is not None:
            data, result = joint_datas[i], joint_results[i]
        elif joint_datas is not None:
            data = joint_datas[i]
            result = solve_band(data, offset_length=offset_length,
                                n_iter=n_iter, threshold=threshold,
                                coarse_block=coarse_block,
                                watchdog=resilience.watchdog,
                                unit=f"band{band}", precond=precond,
                                pair_batch=pair_batch, mg=mg,
                                cg_dot=prec.cg_dot,
                                noise_weight=noise_weight,
                                quality=quality, band=band, device=dev)
        elif checkpoint_every > 0:
            # make_band_map's read, the solve in durable chunks
            data = read_comap_data(
                filelist, band=band, wcs=wcs, nside=nside,
                galactic=galactic, offset_length=offset_length,
                use_calibration=use_cal, medfilt_window=400,
                tod_variant=tod_variant, prefetch=prefetch, cache=cache,
                resilience=resilience, compact=compact,
                tod_dtype=prec.tod_dtype, device=dev)
            ckpt = os.path.join(state_dir,
                                f"solver.{prefix}.band{band}.rank0.npz")
            result = solve_band_checkpointed(
                data, ckpt, checkpoint_every,
                offset_length=offset_length, n_iter=n_iter,
                threshold=threshold, watchdog=resilience.watchdog,
                unit=f"band{band}", coarse_block=coarse_block,
                precond=precond, pair_batch=pair_batch, mg=mg,
                cg_dot=prec.cg_dot, noise_weight=noise_weight,
                quality=quality, band=band, device=dev)
        else:
            data, result = make_band_map(
                filelist, band, wcs=wcs, nside=nside, galactic=galactic,
                offset_length=offset_length, n_iter=n_iter,
                threshold=threshold, use_ground=use_ground,
                use_calibration=use_cal, tod_variant=tod_variant,
                coarse_block=coarse_block, prefetch=prefetch, cache=cache,
                resilience=resilience,
                precond=precond, pair_batch=pair_batch, mg=mg,
                compact=compact, tod_dtype=prec.tod_dtype,
                cg_dot=prec.cg_dot, noise_weight=noise_weight,
                quality=quality, device=dev)
        path = os.path.join(out_dir, f"{prefix}_band{band}.fits")
        if writeback is None:
            write_band_map(path, data, result)
        else:
            writeback.submit(path, band_map_writer(path, data, result))
        print(f"band {band}: {len(data.files)} files, "
              f"{data.tod.size} samples, {int(result.n_iter)} CG iters, "
              f"residual {float(result.residual):.2e} -> {path}")
        if float(result.residual) > threshold:
            # an unconverged solve leaves large-scale stripes in the map
            logger.warning(
                "band %d did NOT reach threshold %.0e (residual %.2e "
                "after %d iterations)%s", band, threshold,
                float(result.residual), int(result.n_iter),
                " — coarse_precond active: if a 'Jacobi only' fallback "
                "warning appeared above it did not apply; otherwise "
                "raise niter (or the coarse block size)"
                if coarse_block
                else " — consider [Inputs] coarse_precond : 8 "
                "(two-level preconditioner; docs/OPERATIONS.md §3)")
    if writeback is not None:
        # the exit barrier: every queued map committed, or the run fails
        try:
            writeback.flush()
        finally:
            writeback.close()
    if sched is not None:
        # commit only after the maps are written: a lease committed
        # against an unwritten map would lose the files on a crash
        for f in filelist:
            if not sched.commit(f):
                logger.warning(
                    "lease commit fence-rejected for %s: this rank's "
                    "lease was stolen (stale heartbeat?) and the file "
                    "redone elsewhere; its partial products here are "
                    "superseded", f)
        logger.info("elastic campaign rank 0: %s", sched.stats)
        leftover = sched.release_held()
        if leftover:
            logger.warning("released %d uncommitted lease(s)", leftover)
    if resilience.ledger is not None and resilience.ledger.entries:
        print(f"quarantine ledger {resilience.ledger.path}: "
              f"{resilience.ledger.summary()}")
    if resilience.heartbeat is not None:
        resilience.heartbeat.stop(final_stage="run_destriper.done")
    if live is not None:
        live.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
