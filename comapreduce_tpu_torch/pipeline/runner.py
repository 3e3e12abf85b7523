"""The pipeline executor: per-file stage loop with resume and atomic
checkpoints (port of ``comapreduce_tpu/pipeline/runner.py``).

``Runner.run_tod`` walks this rank's static ``rank::n_ranks`` shard of a
filelist, file by file: each stage is skipped when the Level-2
checkpoint already contains its groups (unless it overwrites), a falsy
``STATE`` aborts the file, and the Level-2 file is written atomically
after every stage, so the file is the checkpoint. A file whose read or
stage chain raises takes a ``None`` slot ("BAD FILE") and the run goes
on. Stages compute on ``device`` (``None``: the card; ``"cpu"`` runs the
plain versions).

The reference's knobs whose machinery is not ported raise
``NotImplementedError`` naming the knob, in :meth:`Runner.from_config`
and in :meth:`Runner.run_tod`: ``[ingest]`` beyond the serial path,
``[resilience]`` beyond ``quarantine = "off"`` with ``lease_ttl_s = 0``
(no quarantine ledger, retry, heartbeat, lease or scheduler),
``[campaign]``, ``[telemetry]``, a ``[precision]`` other than f32,
``[quality]`` unless ``enabled = false`` (the reference's default is
on), ``[slo]``, ``[control]``, ``[tuning]`` and ``profile_dir``.
"""

from __future__ import annotations

import logging
import os
import socket
import sys
import time
from dataclasses import dataclass, field

from comapreduce_tpu_torch._device import resolve_device
from comapreduce_tpu_torch.data.level import COMAPLevel1, COMAPLevel2
from comapreduce_tpu_torch.pipeline import config as cfg_mod
from comapreduce_tpu_torch.pipeline.registry import resolve

__all__ = ["Runner", "set_logging", "level2_path", "unported_knobs"]

logger = logging.getLogger("comapreduce_tpu_torch")

# each config table's options (the reference's KNOBS), and the values
# the port runs; any other value of a known option is unported
_TABLES = {
    "ingest": {"prefetch": 0, "cache_mb": 0, "spill_dir": "",
               "eager_tod": None, "compile_cache_dir": "", "writeback": 0},
    "resilience": {"quarantine": "off", "lease_ttl_s": 0},
    "campaign": {"t_quantum": 0, "scan_quantum": 0, "l_quantum": 0,
                 "warm_compile": False},
    "telemetry": {"enabled": False, "flush_s": None,
                  "jax_profiler": False},
    "precision": {"tod_dtype": "f32", "cg_dot": "f32"},
    "quality": {"enabled": False},
    "slo": {},
    "control": {},
    "tuning": {"enabled": False, "device_hbm_mb": None,
               "max_candidates": None, "repeats": None,
               "min_improvement": None},
}
_RESILIENCE_KNOBS = ("quarantine", "max_retries", "retry_base_s",
                     "retry_max_s", "retry_jitter", "retry_quarantined",
                     "inject", "inject_seed", "deadlines", "deadline_scale",
                     "deadline_min_s", "hang_grace_s", "heartbeat_s",
                     "straggler_timeout_s", "lease_ttl_s", "steal_after_s")
_KNOWN = {
    "resilience": _RESILIENCE_KNOBS,
    "slo": ("max_tsys_k", "min_tsys_k", "max_white_sigma", "max_fknee_hz",
            "max_spike_fraction", "max_masked_fraction", "exclude_flagged"),
    "control": ("autoscale", "min_ranks", "max_ranks",
                "target_files_per_hour", "cooldown_s", "poll_s",
                "liveness_ttl_s", "admission", "shed_high_water",
                "shed_low_water", "solver_policy"),
}
_OFF = ("off", "none", "false", "")


def _ported_value(table: str, key: str, value) -> bool:
    want = _TABLES[table].get(key, ...)
    if want is ...:
        return False
    if want is None:                     # inert while its table is off
        return True
    if table == "resilience" and key == "quarantine":
        return value is None or value is False or \
            str(value).strip().lower() in _OFF
    if table == "precision":
        return str(value).strip().lower() in ("f32", "float32")
    if isinstance(want, bool):
        return bool(value) is want
    if isinstance(want, (int, float)):
        return float(value or 0) == want
    return str(value or "") == want


def unported_knobs(tables: dict, campaign_defaults: bool = False,
                   profile_dir: str = "") -> list[str]:
    """Names (``table.option``) of the set config knobs whose machinery
    the port lacks; ``tables`` maps a table name to its mapping or
    ``None``. ``campaign_defaults``: the table defaults of the reference's
    config entry points (elastic claiming unless ``lease_ttl_s`` is
    given). An option no table knows raises ``ValueError``, as the
    reference's config coercion does."""
    bad = []
    for table in _TABLES:
        value = tables.get(table)
        if value is None:
            if table == "resilience":
                bad.append("resilience.quarantine")
            elif table == "quality":
                bad.append("quality.enabled")
            continue
        value = dict(value)
        known = _KNOWN.get(table, tuple(_TABLES[table]))
        unknown = sorted(set(value) - set(known))
        if unknown:
            raise ValueError(f"unknown [{table}] option(s) {unknown}")
        if table == "resilience" and "quarantine" not in value:
            bad.append("resilience.quarantine")
        if table == "resilience" and campaign_defaults \
                and "lease_ttl_s" not in value:
            bad.append("resilience.lease_ttl_s")
        if table == "quality" and "enabled" not in value:
            bad.append("quality.enabled")
        bad += [f"{table}.{k}" for k, v in value.items()
                if not _ported_value(table, k, v)]
    if profile_dir:
        bad.append("profile_dir")
    return bad


def _refuse(bad: list[str]) -> None:
    if bad:
        raise NotImplementedError(
            "not ported: " + ", ".join(bad) + " (the port runs [ingest] "
            "serially, [resilience] with quarantine = \"off\" and "
            "lease_ttl_s = 0, and [quality] enabled = false)")


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


def _is_lock_error(exc: BaseException) -> bool:
    """HDF5/NFS lock contention: another writer holds a healthy file."""
    if not isinstance(exc, OSError):
        return False
    msg = str(exc).lower()
    return (isinstance(exc, BlockingIOError) or "lock" in msg
            or "resource temporarily unavailable" in msg)


@dataclass
class Runner:
    """Run a stage chain over a filelist (``runner.py:92``).

    ``processes`` are instantiated stages (:mod:`stages`); build them from
    a config with :meth:`from_config`. Rank ``r`` of ``n_ranks`` takes
    the files ``i`` with ``i % n_ranks == r``. ``timings`` collects each
    stage's wall seconds per file. The config tables (``ingest``,
    ``resilience``, ``quality``, ...) are mappings or ``None`` (the
    reference's defaults)."""

    processes: list = field(default_factory=list)
    output_dir: str = "."
    prefix: str = "Level2"
    rank: int = 0
    n_ranks: int = 1
    timings: dict = field(default_factory=dict)
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
        """The TOD-reduction loop (``runner.py:211``) over this rank's
        shard: one Level-2 store per file, ``None`` for a file whose
        read or stage chain failed."""
        from comapreduce_tpu_torch.ingest.loaders import level1_stream

        _refuse(unported_knobs(self._tables(),
                               profile_dir=self.profile_dir))
        resolve_device(self.device)
        os.makedirs(self.output_dir, exist_ok=True)
        results = []
        for item in level1_stream(self.shard_iter(filelist)):
            logger.info("rank %d: processing %s", self.rank, item.filename)
            self.timings.setdefault("ingest.read", []).append(
                item.read_s if item.error is None else 0.0)
            t0 = time.perf_counter()
            if item.error is not None:
                logger.error("BAD FILE %s", item.filename,
                             exc_info=item.error)
                results.append(None)
                self.timings.setdefault("ingest.compute", []).append(0.0)
                continue
            try:
                results.append(self.run_file(item.filename,
                                             data=item.payload))
            except Exception:
                logger.exception("BAD FILE %s", item.filename)
                results.append(None)
            finally:
                self.timings.setdefault("ingest.compute", []).append(
                    time.perf_counter() - t0)
        return results

    def run_file(self, filename: str, data=None) -> COMAPLevel2:
        _refuse(["profile_dir"] if self.profile_dir else [])
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
        l2path = level2_path(self.output_dir, filename, self.prefix)
        try:
            lvl2 = COMAPLevel2(filename=l2path)
        except Exception as exc:
            if _is_lock_error(exc):
                raise
            # an unreadable checkpoint (partial copy, bit rot): start
            # fresh under the same name; the first stage's atomic write
            # replaces it whole
            logger.warning("unreadable Level-2 checkpoint %s (%s: %s); "
                           "starting fresh", l2path, type(exc).__name__,
                           exc)
            try:
                os.unlink(l2path)
            except OSError:
                pass
            from comapreduce_tpu_torch.resilience.integrity import \
                drop_sidecar

            drop_sidecar(l2path)
            lvl2 = COMAPLevel2(filename="")
            lvl2.filename = l2path
        for process in self.processes:
            pname = getattr(process, "name", type(process).__name__)
            process.pre_init(data)
            if lvl2.contains(process) and not process.overwrite:
                logger.info("%s: contained, skipping", pname)
                continue
            if hasattr(process, "clear_outputs"):
                process.clear_outputs()
            t0 = time.perf_counter()
            state = process(data, lvl2)
            dt = time.perf_counter() - t0
            self.timings.setdefault(pname, []).append(dt)
            logger.info("%s: %.3f s (STATE=%s)", pname, dt, bool(state))
            if not state:
                logger.info("%s returned falsy STATE; aborting %s",
                            pname, filename)
                break
            lvl2.update(process)
            self._checkpoint(lvl2)
        return lvl2

    def _checkpoint(self, lvl2) -> None:
        """One stage checkpoint: an atomic write of the Level-2 file."""
        lvl2.write(lvl2.filename, atomic=True)

    @classmethod
    def from_config(cls, config: dict | str, rank: int = 0,
                    n_ranks: int = 1, device=None) -> "Runner":
        """Build from a TOML config (path or parsed dict,
        ``runner.py:864``): ``[Global] processes``, ``output_dir``,
        ``prefix``, ``log_dir`` and ``backend``, and one table of kwargs
        per stage. An unported knob raises ``NotImplementedError``."""
        if isinstance(config, str):
            config = cfg_mod.load_toml(config)
        tables = {k: config.get(k) for k in _TABLES}
        _refuse(unported_knobs(tables, campaign_defaults=True))
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
                   rank=rank, n_ranks=n_ranks, device=device, **tables)
