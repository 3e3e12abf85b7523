"""The pipeline executor: per-file stage loop with resume, atomic
checkpoints and the resilience runtime (port of
``comapreduce_tpu/pipeline/runner.py``).

``Runner.run_tod`` walks a filelist file by file: each stage is skipped
when the Level-2 checkpoint already contains its groups (unless it
overwrites), a falsy ``STATE`` aborts the file, and the Level-2 file is
written atomically after every stage, so the file is the checkpoint.
Stages compute on ``device`` (``None``: the card; ``"cpu"`` runs the
plain versions).

Around the loop runs the reference's resilience runtime, built once per
``Runner`` from ``[resilience]`` (``resilience.ResilienceConfig``): files
the quarantine ledger marks bad are skipped without a read (until
``retry_quarantined``), transient read and stage-chain failures retry
with backoff, failures are ledgered by class and disposition, chaos
(``inject``) wraps the loader, a heartbeat ticks in the state directory,
and with ``lease_ttl_s > 0`` (the default of :meth:`Runner.from_config`)
files are claimed under heartbeat-fenced leases from the elastic
:class:`~comapreduce_tpu_torch.pipeline.scheduler.Scheduler` instead of
the static ``rank::n_ranks`` shard. After each finished file the
``[quality]`` ledger gets one record per (feed, band), checked against
``[slo]``. A file whose read or stage chain fails takes a ``None`` slot
("BAD FILE") and the run goes on. ``run_astro_cal`` is ``run_average``'s
second pass with a calibrator filelist: an ``ApplyCalibration`` sub-run
over the same files on the static shard.

With ``[ingest] prefetch >= 1`` a background thread reads ahead over the
files while the current file's chain computes, ``cache_mb`` keeps decoded
files in a Runner-lifetime :class:`~comapreduce_tpu_torch.ingest.
BlockCache` (so ``run_astro_cal``'s pass, or a second ``run_tod``, is
served from memory), ``writeback >= 1`` commits the stage checkpoints on
an ordered background writer with a per-file flush barrier, and
``[precision] tod_dtype = bf16`` narrows the TOD of eager reads before the
cache (the stages widen it back on the host, exactly).

``[telemetry] enabled`` opens this rank's event stream
(``events.rank{r}.jsonl`` in the state directory) on the first
``run_tod``: every file's read and compute and every stage run as spans
with the reference's names and units, and ``timings`` is a
:class:`~comapreduce_tpu_torch.telemetry.StageTimings`. ``jax_profiler``
brackets the second successfully read file (the first steady one) in
``torch.profiler``, its Chrome trace under ``<log_dir>/jax_trace/``;
``profile_dir`` traces every ``run_file`` into that directory.

``[campaign]`` pads each observation up to its shape bucket in the
stages (``ops.reduce.ShapeBuckets``) and, with ``warm_compile`` and
``[ingest] compile_cache_dir``, builds the stages' kernel libraries on a
background thread while the first file is read
(:mod:`~comapreduce_tpu_torch.pipeline.campaign`; the warm-up is kept as
:attr:`Runner.warmup`). ``compile_cache_dir`` is where the kernel
libraries are kept. ``[tuning]`` opens the process-wide winners cache
(:data:`~comapreduce_tpu_torch.tuning.TUNING`) in the state directory,
which the stages' feed-batch planner consults. ``[control]`` runs:
``admission`` gates the elastic scheduler's claims behind the SLO-driven
shed/defer loop (:class:`~comapreduce_tpu_torch.control.admission.
AdmissionController`); ``autoscale`` and ``solver_policy`` are read by
the supervisor sidecar and the map-maker's CLI. Every knob of the
reference runs; an unknown option raises ``ValueError``.
:meth:`Runner.from_legacy_config` builds a runner from a legacy INI.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import socket
import sys
import time
from dataclasses import dataclass, field

from comapreduce_tpu_torch._device import resolve_device
from comapreduce_tpu_torch.control.config import ControlConfig
from comapreduce_tpu_torch.data.level import COMAPLevel1, COMAPLevel2
from comapreduce_tpu_torch.ingest.config import IngestConfig
from comapreduce_tpu_torch.ops.precision import PrecisionPolicy
from comapreduce_tpu_torch.pipeline import config as cfg_mod
from comapreduce_tpu_torch.pipeline.campaign import CampaignConfig
from comapreduce_tpu_torch.pipeline.registry import resolve
from comapreduce_tpu_torch.pipeline.scheduler import Scheduler
from comapreduce_tpu_torch.resilience.config import ResilienceConfig
from comapreduce_tpu_torch.resilience.integrity import drop_sidecar
from comapreduce_tpu_torch.resilience.retry import (classify_error,
                                                    is_lock_error)
from comapreduce_tpu_torch.telemetry.core import (TELEMETRY, DeviceTrace,
                                                  StageTimings,
                                                  TelemetryConfig)
from comapreduce_tpu_torch.telemetry.quality import QualityConfig, SloConfig
from comapreduce_tpu_torch.tuning.cache import TUNING, TuningConfig

__all__ = ["Runner", "set_logging", "level2_path", "unported_knobs"]

logger = logging.getLogger("comapreduce_tpu_torch")

# the config tables whose option names are checked here (the
# reference's KNOBS; every option of theirs runs); [precision],
# [resilience], [telemetry], [quality], [slo] and [control] are validated
# by their own coerce()
_TABLES = {"ingest": IngestConfig.KNOBS, "campaign": CampaignConfig.KNOBS,
           "tuning": TuningConfig.KNOBS}


def unported_knobs(tables: dict) -> list[str]:
    """Names (``table.option``) of the set config knobs whose machinery
    the port lacks: none since ``[campaign]``, ``[tuning]`` and
    ``[ingest] compile_cache_dir`` were ported. ``tables`` maps a table
    name to its mapping, config object or ``None``; an option
    ``[ingest]``, ``[campaign]`` or ``[tuning]`` does not know raises
    ``ValueError``, as the reference's config coercion does."""
    for table, knobs in _TABLES.items():
        value = tables.get(table)
        if isinstance(value, dict):
            unknown = sorted(set(value) - set(knobs))
            if unknown:
                raise ValueError(f"unknown [{table}] option(s) {unknown}")
    return []


def set_logging(base: str = "pipeline", log_dir: str = ".",
                rank: int = 0, level: str = "INFO") -> str:
    """Per-rank logfile plus an excepthook that logs uncaught errors
    (``runner.py:37``). Returns the log path."""
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    host = socket.gethostname()
    path = os.path.join(
        log_dir, f"{base}_{stamp}_{host}_PID{os.getpid()}_rank{rank}.log")
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))

    prev_hook = sys.excepthook
    if getattr(prev_hook, "_comap_excepthook", False):
        prev_hook = prev_hook._comap_prev

    def excepthook(exc_type, exc, tb):
        logger.error("rank %d: uncaught exception", rank,
                     exc_info=(exc_type, exc, tb))
        prev_hook(exc_type, exc, tb)

    excepthook._comap_excepthook = True
    excepthook._comap_prev = prev_hook
    sys.excepthook = excepthook
    return path


def level2_path(output_dir: str, level1_filename: str,
                prefix: str = "Level2") -> str:
    base = os.path.basename(level1_filename)
    return os.path.join(output_dir, f"{prefix}_{base}")


def _record_timing(timings, name: str, seconds: float, **kw) -> None:
    """Append into ``timings`` through the spans-backed adapter when
    present; a caller-supplied plain dict still works (and simply has
    no skip tracking or span emission)."""
    rec = getattr(timings, "record", None)
    if rec is not None:
        rec(name, seconds, **kw)
    else:
        timings.setdefault(name, []).append(float(seconds))


@dataclass
class Runner:
    """Run a stage chain over a filelist (``runner.py:92``).

    ``processes`` are instantiated stages (:mod:`stages`); build them from
    a config with :meth:`from_config`. Rank ``r`` of ``n_ranks`` takes
    the files ``i`` with ``i % n_ranks == r`` on the static shard.
    ``timings`` collects each stage's wall seconds per file. The config
    tables (``ingest``, ``resilience``, ``quality``, ...) are mappings,
    their config objects, or ``None`` (the reference's defaults: a direct
    ``Runner`` with ``resilience=None`` ledgers into
    ``<output_dir>/quarantine.jsonl`` on the static shard).
    ``state_dir`` holds the run state (heartbeats, leases, the queue
    manifest and the quality ledger; '' keeps it beside the outputs)."""

    processes: list = field(default_factory=list)
    output_dir: str = "."
    prefix: str = "Level2"
    rank: int = 0
    n_ranks: int = 1
    timings: dict = field(default_factory=StageTimings)
    profile_dir: str = ""
    ingest: object = None
    resilience: object = None
    state_dir: str = ""
    campaign: object = None
    telemetry: object = None
    precision: object = None
    quality: object = None
    slo: object = None
    control: object = None
    tuning: object = None
    # the device the stages compute on (None: the card)
    device: object = None
    # the last run_tod's campaign warm-up (pipeline.campaign.Warmup;
    # None: none started)
    warmup: object = field(default=None, repr=False)
    # cumulative async-writeback stats ({"writes", "write_s",
    # "flush_wait_s", ...}) over this Runner's run_tod calls
    writeback_stats: dict = field(default_factory=dict)
    # the BlockCache lives on the Runner, not the run_tod call: a
    # reduction followed by run_astro_cal re-reads the same files
    _ingest_cache: object = field(default=None, repr=False)
    # the live async writer during a run_tod call (None: synchronous
    # checkpoints)
    _writeback: object = field(default=None, repr=False)
    # the built Resilience runtime: one ledger for the Runner's lifetime
    _resilience: object = field(default=None, repr=False)
    # the live elastic scheduler during a run_tod call (None: static
    # shard)
    _scheduler: object = field(default=None, repr=False)
    # the last run_tod's scheduler stats ({}: static shard)
    scheduler_stats: dict = field(default_factory=dict, repr=False)

    def _tables(self) -> dict:
        return {k: getattr(self, k) for k in _TABLES}

    def shard_iter(self, filelist):
        """Lazy round-robin shard: rank r takes files ``i % n_ranks ==
        r``."""
        for i, f in enumerate(filelist):
            if i % self.n_ranks == self.rank:
                yield f

    def shard(self, filelist: list[str]) -> list[str]:
        return list(self.shard_iter(filelist))

    def run_tod(self, filelist: list[str]) -> list:
        """The TOD-reduction loop (``runner.py:211``): one Level-2 store
        per processed file, ``None`` for a file whose read or stage chain
        failed. Files the quarantine ledger skips get no slot. With
        ``lease_ttl_s > 0`` the files come from the elastic scheduler,
        each committed through its lease once handled."""
        from comapreduce_tpu_torch.ingest.loaders import level1_stream

        unported_knobs(self._tables())
        dev = resolve_device(self.device)
        for p in self.processes:
            # before the warm-up: it builds for the stages' device
            if hasattr(p, "device"):
                p.device = dev
        os.makedirs(self.output_dir, exist_ok=True)
        cfg = IngestConfig.coerce(self.ingest)
        camp = CampaignConfig.coerce(self.campaign)
        tcfg = TelemetryConfig.coerce(self.telemetry)
        prec = PrecisionPolicy.coerce(self.precision)
        # [quality]/[slo] validated up front, so a typo'd knob raises at
        # run start, not inside the per-file best-effort ledger path
        QualityConfig.coerce(self.quality)
        SloConfig.coerce(self.slo)
        ControlConfig.coerce(self.control)
        tun = TuningConfig.coerce(self.tuning)
        if tun.enabled and not TUNING.enabled:
            # process-wide, like the telemetry registry: the first
            # enabled Runner opens the winners cache
            TUNING.configure(self.state_dir or self.output_dir, tun)
        if tcfg.enabled and not TELEMETRY.enabled:
            # the registry is process-wide: the first enabled Runner
            # opens this rank's stream; sub-runs (run_astro_cal) and
            # later run_tod calls append to the same stream
            TELEMETRY.configure(self.state_dir or self.output_dir,
                                rank=self.rank, flush_s=tcfg.flush_s,
                                jax_profiler=tcfg.jax_profiler)
        buckets = camp.shape_buckets()
        if buckets.enabled:
            # each stage pads an observation up to its campaign bucket
            for p in self.processes:
                if hasattr(p, "shape_buckets"):
                    p.shape_buckets = buckets
        if prec.enabled:
            # the whole policy goes to the stages that carry the knob
            for p in self.processes:
                if hasattr(p, "precision"):
                    p.precision = prec
        if cfg.compile_cache_dir:
            from comapreduce_tpu_torch.pipeline.campaign import \
                enable_compile_cache

            enable_compile_cache(cfg.compile_cache_dir)
        if self._ingest_cache is None:
            self._ingest_cache = cfg.make_cache()
        cache = self._ingest_cache
        if (prec.tod_dtype != "f32" and cache is None
                and not (cfg.eager_tod and cfg.prefetch >= 1)):
            # the narrowing runs in the eager loader: on the lazy serial
            # path the knob does nothing, which is said, not hidden
            logger.warning(
                "[precision] tod_dtype = %s has no effect on the lazy "
                "serial ingest path (prefetch = 0, no cache): the "
                "narrowing runs in the eager loader. Set [ingest] "
                "prefetch >= 1 (or cache_mb > 0) to stream narrowed "
                "TOD.", prec.tod_dtype)
        res = self._resilience_runtime()
        if camp.warm_compile:
            # the stages' kernel libraries built on a daemon thread while
            # the first file is read (runner.py:299)
            if not cfg.compile_cache_dir:
                logger.warning(
                    "campaign warm_compile needs [ingest] "
                    "compile_cache_dir (the kernel libraries' cache); "
                    "skipping warm-up")
            elif not isinstance(filelist, (list, tuple)):
                logger.warning(
                    "campaign warm_compile needs a concrete filelist "
                    "(got a one-shot iterable); skipping warm-up")
            else:
                from comapreduce_tpu_torch.pipeline.campaign import \
                    start_warmup

                self.warmup = start_warmup(
                    self.processes, self.shard(list(filelist)),
                    buckets=buckets)
        wb = None
        if cfg.writeback >= 1:
            from comapreduce_tpu_torch.data.writeback import Writeback

            wb = Writeback(
                depth=cfg.writeback, watchdog=res.watchdog,
                chaos=res.chaos,
                on_hang=lambda f: res.record_hang(
                    f, stage="writeback.write",
                    message="checkpoint write never returned; "
                            "writer abandoned"))
        self._writeback = wb
        if res.heartbeat is not None:
            # before the first claim: a live heartbeat is what keeps this
            # rank's leases from being stolen
            res.heartbeat.start()
        sched = None
        if res.lease_ttl_s > 0:
            sched = Scheduler(
                list(filelist), state_dir=res.state_dir or
                self.state_dir or self.output_dir,
                rank=self.rank, n_ranks=self.n_ranks,
                lease_ttl_s=res.lease_ttl_s,
                steal_after_s=res.steal_after_s,
                ledger=res.ledger, chaos=res.chaos,
                heartbeat=res.heartbeat,
                admission=self._admission_gate(res))
            source = sched.claim_iter()
        else:
            if self._admission_gate(res) is not None:
                logger.warning(
                    "[control] admission is on but the shard is STATIC "
                    "([resilience] lease_ttl_s = 0): a static shard "
                    "has no claim/defer cycle, so admission control "
                    "is inert for this run")
            source = self.shard_iter(filelist)
        self._scheduler = sched
        results = []
        stream = level1_stream(self._admitted(source, res),
                               prefetch=cfg.prefetch, cache=cache,
                               eager_tod=cfg.eager_tod,
                               eager_for=self._needs_tod,
                               tod_dtype=prec.tod_dtype,
                               retry=res.retry, chaos=res.chaos,
                               watchdog=res.watchdog,
                               on_hang=lambda f: res.record_hang(
                                   f, stage="ingest.close",
                                   message="loader never returned; "
                                           "prefetcher abandoned"))
        try:
            self._consume_stream(stream, results, res)
        finally:
            if sched is not None:
                self._scheduler = None
                n = sched.release_held()
                if n:
                    logger.warning("rank %d: released %d unprocessed "
                                   "claim(s) on shutdown", self.rank, n)
                logger.info("scheduler rank %d: %s", self.rank,
                            sched.stats)
                self.scheduler_stats = dict(sched.stats)
            stream.close()
            if wb is not None:
                self._writeback = None
                try:
                    wb.close()
                finally:
                    for k, v in wb.stats.items():
                        self.writeback_stats[k] = \
                            self.writeback_stats.get(k, 0) + v
            if res.heartbeat is not None:
                res.heartbeat.stop(final_stage="run_tod.done")
        if res.ledger is not None and res.ledger.entries:
            logger.info("quarantine ledger %s: %s", res.ledger.path,
                        res.ledger.summary())
        return results

    def _resilience_runtime(self):
        """The Runner-lifetime Resilience bundle, built on first use
        (``runner.py:420``): repeated ``run_tod`` calls consult one
        ledger. Several ranks get per-rank ledger files."""
        if self._resilience is None:
            cfg = ResilienceConfig.coerce(self.resilience)
            self._resilience = cfg.make_runtime(
                self.output_dir, rank=self.rank, n_ranks=self.n_ranks,
                state_dir=self.state_dir)
            if self._resilience.watchdog is not None:
                # the Runner's per-stage timings feed the adaptive
                # deadlines
                self._resilience.watchdog.timings = self.timings
        return self._resilience

    def _admission_gate(self, res):
        """The SLO-driven admission controller for this rank's elastic
        scheduler, or None when ``[control] admission`` is off — None
        keeps the scheduler byte-for-byte on its uncontrolled path
        (``runner.py:437``)."""
        ccfg = ControlConfig.coerce(self.control)
        if not ccfg.admission:
            return None
        from comapreduce_tpu_torch.control.admission import \
            AdmissionController

        return AdmissionController(
            ccfg, res.state_dir or self.state_dir or self.output_dir,
            rank=self.rank)

    def _admitted(self, source, res):
        """``source`` minus currently-quarantined files (no read, one log
        line). A claimed-but-quarantined unit is committed at once:
        skipping it durably is handling it, and an open lease would make
        every other rank steal and re-skip it."""
        for f in source:
            if res.admit(f):
                yield f
            else:
                logger.warning("rank %d: %s is quarantined — skipping "
                               "(re-admit with --retry-quarantined)",
                               self.rank, f)
                self._commit_unit(f)

    def _commit_unit(self, filename: str) -> None:
        """Elastic mode: publish this unit done through the lease
        generation fence (no-op on the static shard)."""
        sched = self._scheduler
        if sched is None:
            return
        if not sched.commit(filename):
            logger.warning(
                "rank %d: commit of %s REJECTED at the lease "
                "generation fence — the unit was stolen and redone "
                "elsewhere; this rank's late result is superseded",
                self.rank, filename)

    def _consume_stream(self, stream, results: list, res=None) -> None:
        """The per-file loop over the read stream (``runner.py:484``):
        a failed read or stage chain is a BAD FILE, ledgered by class
        (a stage-chain failure never quarantines its input), and the
        run goes on."""
        if res is None:
            res = self._resilience_runtime()
        hb, wd = res.heartbeat, res.watchdog
        n_ok = 0
        for item in stream:
            logger.info("rank %d: processing %s", self.rank, item.filename)
            if hb is not None:
                hb.note(stage="stage_chain", unit=item.filename)
            # an errored read records a SKIPPED 0.0: the per-file lists
            # stay index-aligned without feeding failure durations into
            # the adaptive deadline percentile. emit=False: the loader
            # already published the read's true interval as a span
            _record_timing(self.timings, "ingest.read",
                           item.read_s if item.error is None else 0.0,
                           skipped=item.error is not None,
                           unit=item.filename, emit=False)
            t0 = time.perf_counter()
            if item.error is not None:
                logger.error("BAD FILE %s", item.filename,
                             exc_info=item.error)
                res.record_failure(item.filename, item.error,
                                   stage="ingest.read")
                results.append(None)
                _record_timing(self.timings, "ingest.compute", 0.0,
                               skipped=True, unit=item.filename)
                if hb is not None:
                    hb.advance(files_failed=1)
                self._commit_unit(item.filename)
                continue
            # a retry-saved read is bookkeeping only, never skipped
            res.record_recovered(item.filename, item.retries,
                                 stage="ingest.read")
            # [telemetry] jax_profiler: bracket exactly ONE steady-state
            # file (the second success: the first paid the kernel builds)
            prof = TELEMETRY.maybe_jax_profile(steady=n_ok == 1)
            try:
                with prof or contextlib.nullcontext(), \
                        TELEMETRY.span("ingest.compute",
                                       unit=item.filename):
                    if wd is not None:
                        # soft/hard monitoring only: a stage chain
                        # driving the card cannot be cancelled in place
                        with wd.watch("pipeline.stage_chain",
                                      unit=item.filename):
                            value = self._run_file_with_retry(item, res)
                    else:
                        value = self._run_file_with_retry(item, res)
                results.append(value)
                n_ok += 1
                if hb is not None:
                    hb.advance(files_done=1)
                self._ledger_quality(item.filename, value, res)
            except Exception as exc:
                logger.exception("BAD FILE %s", item.filename)
                res.record_failure(item.filename, exc,
                                   stage="stage_chain",
                                   may_quarantine=False)
                results.append(None)
                if hb is not None:
                    hb.advance(files_failed=1)
            finally:
                # emit=False: the compute span above carries the true
                # interval (an error attr on a failed chain included)
                _record_timing(self.timings, "ingest.compute",
                               time.perf_counter() - t0, emit=False)
                self._commit_unit(item.filename)

    def _run_file_with_retry(self, item, res):
        """The per-file stage loop under the retry policy: a transient
        failure re-runs the chain (resume-safe: completed stages skip
        off the checkpoint); permanent errors propagate at once."""
        from comapreduce_tpu_torch.resilience.retry import retry_call

        value, retries = retry_call(
            lambda: self.run_file(item.filename, data=item.payload),
            res.retry, key=item.filename,
            label=f"stage chain {item.filename}")
        res.record_recovered(item.filename, retries, stage="stage_chain")
        return value

    def _ledger_quality(self, filename: str, value, res) -> None:
        """Assemble and ledger the per-(feed, band) quality records of one
        finished file (``runner.py:595``). Best-effort by design: quality
        bookkeeping never fails a file whose chain succeeded, so every
        exception is logged and swallowed."""
        try:
            from comapreduce_tpu_torch.telemetry import quality as q

            qcfg = q.QualityConfig.coerce(self.quality)
            if not qcfg.enabled or value is None:
                return
            slo = q.SloConfig.coerce(self.slo)
            prec = PrecisionPolicy.coerce(self.precision)
            records = q.assemble_quality_records(
                value, filename, rank=self.rank,
                precision_id=f"tod={prec.tod_dtype}|cgdot={prec.cg_dot}",
                masked=q.masked_from_ledger(res.ledger, filename))
            for rec in records:
                rec["flags"] = q.evaluate_record(rec, slo)
                rec["flagged"] = bool(rec["flags"])
            q.append_quality(
                q.quality_path(self.state_dir or self.output_dir,
                               self.rank), records)
            q.emit_alerts(records)
        except Exception:
            logger.exception("quality ledger failed for %s", filename)

    def _needs_tod(self, filename: str) -> bool:
        """False when every output-producing stage of this file's chain
        will resume-skip (``runner.py:624``): then the reader does not
        materialise its TOD only for the chain to drop it. Lazy is always
        correct, eager only the read-ahead, so a misprediction never
        changes results. The probe verifies the checkpoint against its
        sidecar and lists its top-level groups only; an unreadable one
        is ledgered and re-reduced."""
        from comapreduce_tpu_torch.data.hdf5io import safe_hdf5_open
        from comapreduce_tpu_torch.resilience.integrity import verify_file

        l2path = level2_path(self.output_dir, filename, self.prefix)
        if not os.path.exists(l2path):
            return True
        try:
            verify_file(l2path, kind="checkpoint")
            with safe_hdf5_open(l2path, "r") as f:
                have = set(f.keys())
        except Exception as exc:
            logger.warning("corrupt/unreadable Level-2 checkpoint %s "
                           "(%s: %s); re-reducing %s from Level-1",
                           l2path, type(exc).__name__, exc, filename)
            self._quarantine_checkpoint(l2path, filename, exc)
            return True

        def contained(p) -> bool:
            return all(g.split("/")[0] in have
                       for g in getattr(p, "groups", ()))

        return any(
            getattr(p, "groups", ()) and
            (not contained(p) or getattr(p, "overwrite", False))
            for p in self.processes)

    def _quarantine_checkpoint(self, l2path: str, filename: str,
                               exc: BaseException) -> None:
        """Ledger a corrupt Level-2 checkpoint (``runner.py:683``):
        quarantined until the re-reduction rewrites it. Idempotent, and
        lock contention is exempt."""
        res = self._resilience_runtime()
        if res.ledger is None or is_lock_error(exc) \
                or res.ledger.is_quarantined(l2path):
            return
        fclass = classify_error(exc)
        res.ledger.record(l2path, error=exc,
                          failure_class=fclass,
                          disposition=("corrupt" if fclass == "corrupt"
                                       else "quarantined"),
                          stage="resume.checkpoint",
                          message=f"unreadable checkpoint for "
                                  f"{filename}: {exc}")

    def run_file(self, filename: str, data=None) -> COMAPLevel2:
        """One file's stage chain; with ``profile_dir`` set, under a
        ``torch.profiler`` trace written into that directory."""
        if self.profile_dir:
            with DeviceTrace(self.profile_dir):
                return self._run_file(filename, data)
        return self._run_file(filename, data)

    def _run_file(self, filename: str, data=None) -> COMAPLevel2:
        """One file's stage chain (``runner.py:719``) on this runner's
        device."""
        dev = resolve_device(self.device)
        for p in self.processes:
            if hasattr(p, "device"):
                p.device = dev
        if data is None:
            data = COMAPLevel1()
            data.read(filename)
        lvl2 = self._open_level2(
            level2_path(self.output_dir, filename, self.prefix), filename)
        wrote = False
        for process in self.processes:
            pname = getattr(process, "name", type(process).__name__)
            process.pre_init(data)
            if lvl2.contains(process) and not process.overwrite:
                logger.info("%s: contained, skipping", pname)
                continue
            if hasattr(process, "clear_outputs"):
                process.clear_outputs()
            t0 = time.perf_counter()
            with TELEMETRY.span(pname, unit=os.path.basename(filename)):
                state = process(data, lvl2)
            dt = time.perf_counter() - t0
            _record_timing(self.timings, pname, dt, emit=False)
            logger.info("%s: %.3f s (STATE=%s)", pname, dt, bool(state))
            if not state:
                logger.info("%s returned falsy STATE; aborting %s",
                            pname, filename)
                break
            lvl2.update(process)
            self._checkpoint(lvl2)
            wrote = True
        if self._writeback is not None:
            # the per-file barrier: every queued checkpoint of this file
            # commits before its result exists, and a failed write
            # raises here, inside the file's retry / quarantine net
            self._writeback.flush(lvl2.filename)
        res = self._resilience_runtime()
        if wrote and res.ledger is not None and \
                res.ledger.is_quarantined(lvl2.filename):
            # a corrupt checkpoint rewritten whole: lift its quarantine
            res.ledger.record(lvl2.filename, disposition="recovered",
                              stage="resume.checkpoint",
                              message="checkpoint rewritten by "
                                      "re-reduction")
        return lvl2

    def _open_level2(self, l2path: str, filename: str) -> COMAPLevel2:
        """The Level-2 checkpoint of ``filename`` at ``l2path``: read when
        it exists, empty when it does not; an unreadable one (partial
        copy, bit rot) is ledgered, removed, and started fresh under the
        same name (the first stage's atomic write replaces it whole)."""
        try:
            return COMAPLevel2(filename=l2path)
        except Exception as exc:
            if is_lock_error(exc):
                raise
            logger.warning("unreadable Level-2 checkpoint %s (%s: %s); "
                           "starting fresh", l2path, type(exc).__name__,
                           exc)
            self._quarantine_checkpoint(l2path, filename, exc)
            try:
                os.unlink(l2path)
            except OSError:
                pass
            drop_sidecar(l2path)
            lvl2 = COMAPLevel2(filename="")
            lvl2.filename = l2path
            return lvl2

    def _checkpoint(self, lvl2) -> None:
        """One stage checkpoint: an atomic write of the Level-2 file (a
        ``bit_rot`` drill then damages the committed file), or with
        ``[ingest] writeback >= 1`` a host snapshot queued on the ordered
        background writer (which gives the drill the same shot)."""
        wb = self._writeback
        if wb is not None:
            from comapreduce_tpu_torch.data.writeback import snapshot_store

            wb.submit_store(lvl2.filename, snapshot_store(lvl2))
            return
        lvl2.write(lvl2.filename, atomic=True)
        chaos = self._resilience_runtime().chaos
        if chaos is not None:
            chaos.maybe_bit_rot(lvl2.filename)

    def run_astro_cal(self, filelist: list[str],
                      calibrator_level2: list[str],
                      cache_path: str = "") -> list:
        """Apply astronomical calibration factors to target files
        (``runner.py:825``, ``Running.run_astro_cal``): factors are
        harvested from the calibrator Level-2 files (or the ``.npz`` at
        ``cache_path``) and the nearest-in-MJD factor is written into
        each target's Level-2 store by an ``ApplyCalibration`` sub-run.

        The apply pass re-walks the same filelist whose reduction leases
        are already committed in the state directory: under elastic
        claiming the sub-run would find every unit done and calibrate
        nothing, so it always takes the static ``rank::n_ranks`` shard
        (``lease_ttl_s`` 0). It shares this runner's ledger, heartbeat,
        chaos, quality, timings and block cache (a file the reduction
        cached is not read again), and is built as this runner's own
        class, so a subclass's Level-2 and checkpoint hooks hold for it
        too. As in the reference, the sub-run takes the identity
        precision policy."""
        from comapreduce_tpu_torch.calibration.apply_cal import \
            ApplyCalibration

        stage = ApplyCalibration(
            calibrator_filelist=tuple(calibrator_level2),
            cache_path=cache_path)
        res = self._resilience_runtime()
        if res.lease_ttl_s > 0:
            res = dataclasses.replace(res, lease_ttl_s=0.0)
        sub = type(self)(processes=[stage], output_dir=self.output_dir,
                         prefix=self.prefix, rank=self.rank,
                         n_ranks=self.n_ranks, timings=self.timings,
                         ingest=self.ingest, resilience=self.resilience,
                         telemetry=self.telemetry, quality=self.quality,
                         slo=self.slo, state_dir=self.state_dir,
                         device=self.device,
                         _ingest_cache=self._ingest_cache,
                         _resilience=res)
        results = sub.run_tod(filelist)
        self._ingest_cache = sub._ingest_cache
        return results

    @classmethod
    def from_config(cls, config: dict | str, rank: int = 0,
                    n_ranks: int = 1, device=None) -> "Runner":
        """Build from a TOML config (path or parsed dict,
        ``runner.py:864``): ``[Global] processes``, ``output_dir``,
        ``prefix``, ``log_dir`` (the state directory) and ``backend``,
        one table of kwargs per stage, and the ``[resilience]`` (elastic
        claiming on unless ``lease_ttl_s`` is given), ``[quality]`` and
        ``[slo]`` tables, ``[telemetry]``, ``[control]``, ``[campaign]``
        and ``[tuning]``. An unknown option raises ``ValueError``."""
        if isinstance(config, str):
            config = cfg_mod.load_toml(config)
        tables = {k: config.get(k) for k in _TABLES}
        unported_knobs(tables)
        tables["ingest"] = IngestConfig.coerce(tables["ingest"])
        tables["campaign"] = CampaignConfig.coerce(tables["campaign"])
        tables["tuning"] = TuningConfig.coerce(tables["tuning"])
        tables["telemetry"] = TelemetryConfig.coerce(config.get("telemetry"))
        tables["precision"] = PrecisionPolicy.coerce(
            config.get("precision"))
        glob = config.get("Global", {})
        backend = glob.get("backend")
        processes = []
        for name in glob.get("processes", []):
            kwargs = dict(config.get(name, {}))
            kwargs.setdefault("backend", backend)
            processes.append(resolve(name, **kwargs))
        output_dir = glob.get("output_dir", ".")
        return cls(processes=processes, output_dir=output_dir,
                   prefix=glob.get("prefix", "Level2"),
                   state_dir=str(glob.get("log_dir", "") or
                                 os.path.join(output_dir, "logs")),
                   rank=rank, n_ranks=n_ranks, device=device,
                   resilience=ResilienceConfig.coerce_campaign(
                       config.get("resilience")),
                   quality=QualityConfig.coerce(config.get("quality")),
                   slo=SloConfig.coerce(config.get("slo")),
                   control=ControlConfig.coerce(config.get("control")),
                   **tables)

    @classmethod
    def from_legacy_config(cls, ini_path: str, rank: int = 0,
                           n_ranks: int = 1, device=None) -> "Runner":
        """Build from a legacy INI (``runner.py:942``): the
        ``Module.Class(variant)`` jobs of ``[Inputs] pipeline`` through
        the registry, ``[Inputs]`` for the directories and the ingest
        knobs, and the ``[Resilience]`` (elastic claiming on unless
        ``lease_ttl_s`` is given), ``[Campaign]``, ``[Telemetry]``,
        ``[Quality]``, ``[Slo]``, ``[Control]`` and ``[Tuning]``
        sections under the TOML tables' names; a dedicated section
        rejects an unknown option."""
        ini = cfg_mod.IniConfig(ini_path)
        processes = [resolve(name, **kwargs)
                     for name, kwargs in ini.pipeline_jobs()]
        inputs = ini.get("Inputs", {})
        output_dir = inputs.get("output_dir", ".")

        def section(name):
            return dict(ini.get(name, {})) or None

        return cls(processes=processes, output_dir=output_dir,
                   state_dir=str(inputs.get("log_dir", "") or
                                 os.path.join(output_dir, "logs")),
                   rank=rank, n_ranks=n_ranks, device=device,
                   ingest=IngestConfig.from_mapping(inputs),
                   resilience=ResilienceConfig.coerce_campaign(
                       dict(ini.get("Resilience", {}))),
                   campaign=CampaignConfig.coerce(
                       dict(ini.get("Campaign", {}))),
                   telemetry=TelemetryConfig.coerce(section("Telemetry")),
                   quality=QualityConfig.coerce(section("Quality")),
                   slo=SloConfig.coerce(section("Slo")),
                   control=ControlConfig.coerce(section("Control")),
                   tuning=TuningConfig.coerce(section("Tuning")))
