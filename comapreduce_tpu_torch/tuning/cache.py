"""The autotuner's durable winners ledger and the ``TUNING`` singleton
(port of ``comapreduce_tpu/tuning/cache.py``).

Winners are a property of the hardware and the program, so they are
kept: ``tuning.jsonl`` under the run's state directory, one sealed JSON
object per line, appended with the port's other ledgers' torn-line
discipline, read latest-wins per key with torn and seal-violating lines
dropped. Record schema (``_sha256`` the embedded line seal)::

    {"schema": 1, "kind": "tuning", "key": "9f2c...", "group": "solver",
     "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
     "bucket": {"group": "solver", "L": 50}, "precision_id": "",
     "space_version": 1, "winner": {"mg_block": 8, "mg_smooth": 1},
     "default": {"mg_block": 8, "mg_smooth": 1}, "best_ms": 8.1,
     "default_ms": 8.3, "candidates": 6, "measurements": 14,
     "t": "2026-10-18T07:00:00Z", "_sha256": "..."}

``key`` is a content hash of the identity tuple (platform, device kind,
bucket, precision id, knob-space version, group), derived byte for byte
as the reference derives it. The port's identity is ``("gpu",
torch.cuda.get_device_name())`` on the card and ``("cpu", "cpu")`` on
the CPU — the reference's CPU identity, so a ``tuning.jsonl`` written on
the CPU by either package keys the same winners in both.

:data:`TUNING` is what the consult sites ask (``ops.reduce.
plan_stage_feed_batch``, ``mapmaking.pointing_plan.build_pointing_plan``,
``cli.run_destriper.main`` and ``control.policy``), behind the strict
``[tuning]`` table; disabled (no table) every lookup is None.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time

__all__ = ["TUNING", "TuningCache", "TuningConfig", "content_key",
           "read_tuning", "tuning_path"]

logger = logging.getLogger("comapreduce_tpu_torch")

TUNING_SCHEMA = 1


def tuning_path(directory: str) -> str:
    return os.path.join(directory or ".", "tuning.jsonl")


def content_key(platform: str, device_kind: str, bucket,
                precision_id: str = "", space_version: int = 1,
                group: str = "") -> str:
    """Content hash of one winner's identity.

    ``bucket`` may be a dict, tuple/list, or scalar — it is embedded
    in canonical sorted-keys JSON, so two callers passing the same
    bucket with different dict insertion orders produce the SAME key
    (asserted in tests). Changing any identity field — including the
    knob-space version — changes the key, which is how a space
    revision retires every old winner without a migration."""
    ident = {"platform": str(platform), "device_kind": str(device_kind),
             "bucket": bucket, "precision_id": str(precision_id),
             "space_version": int(space_version), "group": str(group)}
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def read_tuning(source) -> dict:
    """``{key: record}`` from a directory (its ``tuning.jsonl``) or one
    path — latest-wins per key; torn, unparseable and seal-violating
    lines dropped (the house JSONL reader contract)."""
    from comapreduce_tpu_torch.resilience.integrity import check_line

    path = tuning_path(source) if os.path.isdir(str(source)) \
        else str(source)
    latest: dict = {}
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return latest
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            body, verdict = check_line(line.decode("utf-8", "replace"))
        except Exception:
            continue
        if body is None or verdict is False:
            continue
        if not isinstance(body, dict) or body.get("kind") != "tuning":
            continue
        key = body.get("key")
        if key:
            latest[str(key)] = body
    return latest


class TuningCache:
    """The winners ledger: latest-wins reads, sealed torn-line-safe
    appends, and hit/miss accounting (a warm second run is all hits and
    zero measurements)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._records: dict | None = None
        self.hits = 0
        self.misses = 0

    def load(self) -> dict:
        with self._lock:
            if self._records is None:
                self._records = read_tuning(self.path)
            return self._records

    def get(self, key: str) -> dict | None:
        rec = self.load().get(str(key))
        with self._lock:
            if rec is None:
                self.misses += 1
            else:
                self.hits += 1
        return rec

    def put(self, record: dict) -> dict:
        """Seal and append one winner record (and serve it to this
        process's later gets without a re-read). I/O failure is logged
        and swallowed — a read-only log_dir costs durability, never
        the sweep's result."""
        from comapreduce_tpu_torch.resilience.integrity import seal_line

        rec = dict(record)
        rec.setdefault("schema", TUNING_SCHEMA)
        rec.setdefault("kind", "tuning")
        rec.setdefault("t", time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime()))
        line = seal_line(rec)
        with self._lock:
            if self._records is None:
                self._records = read_tuning(self.path)
            self._records[str(rec.get("key"))] = rec
        try:
            os.makedirs(os.path.dirname(self.path) or ".",
                        exist_ok=True)
            needs_nl = False
            try:
                with open(self.path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    needs_nl = f.read(1) != b"\n"
            except OSError:
                pass
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(("\n" if needs_nl else "") + line + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as exc:
            logger.warning("tuning cache append to %s failed (%s: %s)",
                           self.path, type(exc).__name__, exc)
        return rec


class TuningConfig:
    """The strict ``[tuning]`` table (TOML) / ``[Tuning]`` section
    (INI). Absent table = disabled = byte-identical pipeline; a typo'd
    knob raises at config load (the ``[Destriper]``/``[Resilience]``
    contract).

    - ``enabled``         consult (and, for the sweep tools, write)
      the winners cache. Default False.
    - ``device_hbm_mb``   declared device memory for the memory
      auto-sizers (``ops.reduce.device_hbm_bytes``, through
      ``set_device_hbm_override``); 0 = ask the device (the card's
      total, or the 16 GiB default on the CPU).
    - ``max_candidates``  grid cap per sweep after the cost-prior
      prune (default 8).
    - ``repeats``         repetitions the successive-halving schedule
      grows to for the surviving candidates (default 3).
    - ``min_improvement`` the noise floor: a measured winner must beat
      the default by this fraction or the default is kept (default
      0.05 — tuned knobs can then never be slower than defaults
      beyond noise).
    """

    KNOBS = ("enabled", "device_hbm_mb", "max_candidates", "repeats",
             "min_improvement")

    def __init__(self, enabled: bool = False, device_hbm_mb: int = 0,
                 max_candidates: int = 8, repeats: int = 3,
                 min_improvement: float = 0.05):
        self.enabled = bool(enabled)
        self.device_hbm_mb = int(device_hbm_mb)
        self.max_candidates = int(max_candidates)
        self.repeats = int(repeats)
        self.min_improvement = float(min_improvement)
        if self.device_hbm_mb < 0:
            raise ValueError(f"[tuning] device_hbm_mb must be >= 0 "
                             f"(0 = ask the backend), got "
                             f"{device_hbm_mb!r}")
        if self.max_candidates < 1:
            raise ValueError(f"[tuning] max_candidates must be >= 1, "
                             f"got {max_candidates!r}")
        if self.repeats < 1:
            raise ValueError(f"[tuning] repeats must be >= 1, got "
                             f"{repeats!r}")
        if not 0.0 <= self.min_improvement < 1.0:
            raise ValueError(f"[tuning] min_improvement must be in "
                             f"[0, 1), got {min_improvement!r}")

    @classmethod
    def coerce(cls, value) -> "TuningConfig":
        """None / dict / TuningConfig -> TuningConfig; unknown keys
        raise (fail at config load, before any campaign-scale work).
        A non-empty dict without an explicit ``enabled`` knob means
        the operator wrote the table to turn the tuner on."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            known = {k: value[k] for k in cls.KNOBS if k in value}
            unknown = set(value) - set(known)
            if unknown:
                raise ValueError(
                    f"unknown tuning keys: {sorted(unknown)} "
                    f"(knobs: {list(cls.KNOBS)})")
            if known and "enabled" not in known:
                known["enabled"] = True
            if "enabled" in known:
                known["enabled"] = _as_bool(known["enabled"])
            return cls(**known)
        raise TypeError(f"cannot build TuningConfig from {type(value)}")


def _as_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def _backend_identity() -> tuple:
    """(platform, device kind) of this process: ``("gpu", the card's
    name)`` with a CUDA card, else ``("cpu", "cpu")``, the reference's
    CPU identity."""
    import torch

    if torch.cuda.is_available():
        return ("gpu", str(torch.cuda.get_device_name()))
    return ("cpu", "cpu")


class TuningRuntime:
    """Process-wide tuned-knob lookup (the TELEMETRY/PROGRAMS shape:
    disabled it costs one attribute check; ``configure`` binds it to a
    run's log_dir, ``close`` resets for the next run/test)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._cache: TuningCache | None = None
        self._config = TuningConfig()
        self._identity: tuple | None = None

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def config(self) -> TuningConfig:
        return self._config

    @property
    def cache(self) -> TuningCache | None:
        return self._cache

    def configure(self, log_dir: str,
                  config: TuningConfig | dict | None = None
                  ) -> "TuningRuntime":
        from comapreduce_tpu_torch.ops.reduce import set_device_hbm_override

        cfg = TuningConfig.coerce(config)
        with self._lock:
            self._config = cfg
            self._cache = TuningCache(tuning_path(log_dir))
            self._enabled = cfg.enabled
            self._identity = None
        set_device_hbm_override(cfg.device_hbm_mb << 20
                                if cfg.device_hbm_mb else 0)
        return self

    def close(self) -> None:
        from comapreduce_tpu_torch.ops.reduce import set_device_hbm_override

        with self._lock:
            self._enabled = False
            self._cache = None
            self._config = TuningConfig()
            self._identity = None
        set_device_hbm_override(0)

    def identity(self) -> tuple:
        with self._lock:
            if self._identity is None:
                self._identity = _backend_identity()
            return self._identity

    def winner(self, group: str, bucket, precision_id: str = ""
               ) -> dict | None:
        """The cached winning knob dict for one (group, bucket) on this
        process's backend, or None (disabled / never measured). The
        cache counts the hit either way — the warm-cache gate's
        observable."""
        if not self._enabled or self._cache is None:
            return None
        from comapreduce_tpu_torch.tuning.space import SPACE_VERSION

        platform, device_kind = self.identity()
        key = content_key(platform, device_kind, bucket,
                          precision_id=precision_id,
                          space_version=SPACE_VERSION, group=group)
        rec = self._cache.get(key)
        if rec is None:
            return None
        win = rec.get("winner")
        return dict(win) if isinstance(win, dict) else None


TUNING = TuningRuntime()
