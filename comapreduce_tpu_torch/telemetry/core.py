"""Process-wide telemetry registry: structured spans and counters (the
part of ``comapreduce_tpu/telemetry/core.py`` that the resilience layer
and the checkpointed solve report into, copied so that the event lines
it writes have the reference's format).

One ``Telemetry`` singleton (``TELEMETRY``) per process emits
structured events to an append-only per-rank ``events.rank{r}.jsonl``
stream under the directory :meth:`Telemetry.configure` names. The
writer repairs a torn trailing line with a newline before appending, so
a crash mid-write costs at most one line and never glues two records.

Event kinds (one JSON object per line, ``mono`` = ``time.monotonic()``
seconds in the writer's clock domain, aligned across ranks through each
stream's ``meta`` anchor ``wall0``/``mono0``):

- ``meta``    stream header: schema, rank, pid, host, wall0/mono0.
- ``begin``   a span opened (id, name, unit, tid, mono, parent).
- ``span``    a span closed: begin fields + ``dur`` (seconds) +
  ``attrs``.
- ``counter`` a monotonic-count delta sample (``value`` adds).
- ``gauge``   a point-in-time level (``value`` replaces).

Disabled (the default), every public call is one attribute check and
``span()`` returns a shared no-op context manager. Enabled, events
buffer in memory and a daemon thread drains them every ``flush_s``
seconds.

Registered gauges (:meth:`Telemetry.register_gauge`) are sampled on
every flush beat. The serving lane (:data:`SERVING_LANE_BASE`,
:func:`serving_lane_rank`) gives each map or tile server a stream of its
own, and :class:`RequestMetrics` is the ``/metrics`` histogram of the
tile server and the live sidecar, in the reference's exact Prometheus
schema.

``StageTimings`` is the spans-backed drop-in for ``Runner.timings``: a
real ``dict[str, list[float]]`` whose ``record()`` also emits a
completed span and tracks which entries are skip-path placeholders;
``samples(name)`` returns only the real measurements, which is what the
watchdog's adaptive percentile reads. ``TelemetryConfig`` is the
``[telemetry]`` table (``enabled``, ``flush_s``, ``jax_profiler``).

The device-trace knob keeps the reference's name, ``jax_profiler``, so
shipped and user configs run unchanged: :meth:`Telemetry.
maybe_jax_profile` brackets exactly one steady-state file per configure
in ``torch.profiler.profile`` (CPU and, with a card, CUDA activities)
and writes its Chrome trace under ``<log_dir>/jax_trace/``. What the
port compiles is its kernel libraries (``pipeline.campaign``): each
``nvcc`` build is a ``jax.compile`` span and counts
``jax.compile_cache.misses``, a library found on disk counts
``jax.compile_cache.hits``, under the reference's names. The program
registry (:mod:`~comapreduce_tpu_torch.telemetry.programs`, one eager
call measured per stage program and shape bucket) rides the same switch,
as there.
"""

from __future__ import annotations

import atexit
import bisect
import itertools
import json
import logging
import os
import re
import socket
import threading
import time

__all__ = ["TELEMETRY", "Telemetry", "TelemetryConfig", "StageTimings",
           "RequestMetrics", "LATENCY_BUCKETS_S",
           "serving_lane_rank", "SERVING_LANE_BASE"]

logger = logging.getLogger("comapreduce_tpu_torch")

_SCHEMA = 1

#: first telemetry rank of the SERVING lane: reducer ranks are the
#: campaign's real ranks (0..N-1), long-lived serving processes (map
#: server, tile server) write at >= this so the streams never collide
SERVING_LANE_BASE = 1000

_RANK_STREAM_RE = re.compile(r"^events\.rank(\d+)\.jsonl$")


def serving_lane_rank(log_dir: str,
                      base: int = SERVING_LANE_BASE) -> int:
    """The next free serving-lane rank in ``log_dir``: one past the
    highest existing ``events.rank{r}.jsonl`` with ``r >= base``
    (``base`` itself when the lane is empty). Span/event ids are
    per-process, so two servers appending to one stream would
    interleave unrelated spans — every serving process (and every
    restart of one) takes a fresh stream instead."""
    best = int(base) - 1
    try:
        names = os.listdir(log_dir or ".")
    except OSError:
        names = []
    for name in names:
        m = _RANK_STREAM_RE.match(name)
        if m and int(m.group(1)) >= int(base):
            best = max(best, int(m.group(1)))
    return best + 1


def _json_safe(obj):
    """Best-effort scalarisation for numpy and torch leaves in attrs."""
    try:
        return float(obj)
    except Exception:
        return str(obj)


class _NullSpan:
    """The disabled-path span: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return None


_NULL_SPAN = _NullSpan()


class Span:
    """A live span (use through ``Telemetry.span`` as a context
    manager). ``begin`` is written on entry so a rank SIGKILLed
    mid-span still leaves evidence; the full record with ``dur``
    replaces it on exit. ``set(**attrs)`` attaches attributes any time
    before exit; an exception exits the span with an ``error`` attr."""

    __slots__ = ("_tele", "name", "unit", "attrs", "id", "parent", "t0")

    def __init__(self, tele: "Telemetry", name: str, unit: str,
                 attrs: dict):
        self._tele = tele
        self.name = name
        self.unit = unit
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tele = self._tele
        self.id = next(tele._ids)
        stack = tele._stack()
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self.t0 = time.monotonic()
        ev = {"kind": "begin", "id": self.id, "name": self.name,
              "mono": self.t0, "tid": threading.current_thread().name}
        if self.unit:
            ev["unit"] = self.unit
        if self.parent:
            ev["parent"] = self.parent
        tele._emit(ev)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tele = self._tele
        dur = time.monotonic() - self.t0
        stack = tele._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        ev = {"kind": "span", "id": self.id, "name": self.name,
              "mono": self.t0, "dur": dur,
              "tid": threading.current_thread().name}
        if self.unit:
            ev["unit"] = self.unit
        if self.parent:
            ev["parent"] = self.parent
        if self.attrs:
            ev["attrs"] = self.attrs
        tele._emit(ev)
        return False


class Telemetry:
    """The process-wide registry. Disabled until :meth:`configure`."""

    def __init__(self):
        self._enabled = False
        self._lock = threading.Lock()
        self._buf: list[dict] = []
        self._path = ""
        self._rank = 0
        self._flush_s = 2.0
        self.jax_profiler = False
        self._jax_profiled = False
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._gauges: dict = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._write_failed = False

    # -- lifecycle ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def path(self) -> str:
        return self._path

    @property
    def log_dir(self) -> str:
        return os.path.dirname(self._path) if self._path else ""

    def configure(self, log_dir: str, rank: int = 0, *,
                  flush_s: float = 2.0,
                  jax_profiler: bool = False) -> "Telemetry":
        """Open (or re-open) the per-rank event stream and start the
        flush thread. Re-configuring into the same file appends — the
        stream is append-only by contract, like the quarantine ledger."""
        self.close()
        os.makedirs(log_dir or ".", exist_ok=True)
        self._path = os.path.join(log_dir or ".",
                                  f"events.rank{int(rank)}.jsonl")
        self._rank = int(rank)
        self._flush_s = max(float(flush_s), 0.05)
        self.jax_profiler = bool(jax_profiler)
        self._jax_profiled = False
        self._write_failed = False
        self._stop = threading.Event()
        self._enabled = True
        # the stream anchor: readers align this rank's mono clock onto
        # wall time through (wall0, mono0) — mono clocks of different
        # hosts share no epoch, so every cross-rank merge needs this
        self._emit({"kind": "meta", "schema": _SCHEMA, "rank": self._rank,
                    "pid": os.getpid(), "host": socket.gethostname(),
                    "wall0": time.time(), "mono0": time.monotonic()})
        self.flush()
        self._thread = threading.Thread(target=self._flush_loop,
                                        name="telemetry-flush",
                                        daemon=True)
        self._thread.start()
        # kernel-library builds become spans and counters
        from comapreduce_tpu_torch import _build
        from comapreduce_tpu_torch.telemetry.programs import PROGRAMS

        _build.add_listener(_on_library_event)
        # the program registry rides the same switch (core.py:243)
        PROGRAMS.configure(log_dir, rank)
        return self

    def close(self) -> None:
        """Stop the flush thread and drain the buffer. Idempotent;
        leaves the registry disabled (configure() re-enables)."""
        thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        if self._enabled:
            self._poll_gauges()
            self.flush()
        self._enabled = False
        self._gauges.clear()
        from comapreduce_tpu_torch.telemetry.programs import PROGRAMS

        PROGRAMS.close()

    # -- emission ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._buf.append(ev)

    def span(self, name: str, unit: str = "", **attrs):
        """Context manager timing a live region (writes begin + span)."""
        if not self._enabled:
            return _NULL_SPAN
        return Span(self, name, unit, attrs)

    def event_span(self, name: str, dur_s: float, unit: str = "",
                   skipped: bool = False, **attrs) -> None:
        """A completed span reported post-hoc: the common pattern for
        regions whose duration the caller already measured. Emitted
        promptly after the region ends, its ``[now-dur, now]`` interval
        is the region's true extent (what the overlap fractions in
        ``campaign_report`` integrate). ``skipped`` marks placeholder
        durations (error/resume paths) that summaries must not count."""
        if not self._enabled:
            return
        end = time.monotonic()
        dur = max(float(dur_s), 0.0)
        if skipped:
            attrs["skipped"] = True
        stack = self._stack()
        ev = {"kind": "span", "id": next(self._ids), "name": name,
              "mono": end - dur, "dur": dur,
              "tid": threading.current_thread().name}
        if unit:
            ev["unit"] = unit
        if stack:
            ev["parent"] = stack[-1]
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)

    def counter(self, name: str, value: float = 1, **attrs) -> None:
        """A monotonic-count delta (``value`` ADDS to the series)."""
        if not self._enabled:
            return
        ev = {"kind": "counter", "name": name, "mono": time.monotonic(),
              "value": value}
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)

    def gauge(self, name: str, value: float, **attrs) -> None:
        """A point-in-time level (queue depth, bytes resident)."""
        if not self._enabled:
            return
        ev = {"kind": "gauge", "name": name, "mono": time.monotonic(),
              "value": value}
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)

    def register_gauge(self, name: str, fn) -> None:
        """Register ``fn() -> number|None`` to be sampled on every
        flush beat (a no-op while disabled)."""
        if not self._enabled:
            return
        with self._lock:
            self._gauges[name] = fn

    def maybe_jax_profile(self, steady: bool):
        """The opt-in device-trace hook (``[telemetry] jax_profiler``):
        returns a context manager bracketing exactly ONE steady-state
        file per configure in ``torch.profiler.profile``, writing its
        Chrome trace under ``<log_dir>/jax_trace`` so the card's kernel
        timeline lines up with the host spans. None everywhere else."""
        if not (self._enabled and self.jax_profiler and steady) \
                or self._jax_profiled:
            return None
        self._jax_profiled = True
        return DeviceTrace(os.path.join(self.log_dir or ".", "jax_trace"))

    # -- flushing ----------------------------------------------------------
    def _flush_loop(self) -> None:
        while not self._stop.wait(self._flush_s):
            self._poll_gauges()
            self.flush()

    def _poll_gauges(self) -> None:
        with self._lock:
            gauges = list(self._gauges.items())
        for name, fn in gauges:
            try:
                value = fn()
            except Exception:  # a closed subsystem's gauge: drop it
                with self._lock:
                    self._gauges.pop(name, None)
                continue
            if value is not None:
                self.gauge(name, value)

    def flush(self) -> None:
        """Drain the buffer to the stream (torn-line-safe append)."""
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf or not self._path:
            return
        payload = "".join(
            json.dumps(ev, separators=(",", ":"), default=_json_safe)
            + "\n" for ev in buf)
        try:
            # "a+b", not "ab": the torn-tail probe READS the last byte,
            # and a write-only append handle turns that read into
            # io.UnsupportedOperation (an OSError), silently skipping
            # the heal; O_APPEND still pins every write to the end
            with open(self._path, "a+b") as f:
                # heal a torn trailing line from a previous crash with
                # a newline FIRST: the stump stays (the reader drops
                # it), but it can never glue onto this batch's first
                # record (the ledger's exact discipline)
                needs_nl = False
                try:
                    f.seek(-1, os.SEEK_END)
                    needs_nl = f.read(1) != b"\n"
                except OSError:
                    pass
                f.write((b"\n" if needs_nl else b"")
                        + payload.encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
        except OSError as exc:
            if not self._write_failed:  # warn once, never kill the run
                self._write_failed = True
                logger.warning("telemetry: cannot append to %s (%s); "
                               "events are being dropped",
                               self._path, exc)


TELEMETRY = Telemetry()


def _on_library_event(event: str, name: str, seconds: float) -> None:
    """A kernel-library build (``_build``) as the reference reports an XLA
    compile: a ``jax.compile`` span and a cache miss, which a steady
    campaign segment shows none of; a library found on disk a cache
    hit."""
    if event == "build":
        TELEMETRY.counter("jax.compile_cache.misses")
        TELEMETRY.event_span("jax.compile", seconds, library=name)
    else:
        TELEMETRY.counter("jax.compile_cache.hits")
atexit.register(TELEMETRY.close)


class DeviceTrace:
    """``torch.profiler.profile`` over one region, its Chrome trace
    exported into ``out`` on exit (``<host>_<pid>.<ns>.pt.trace.json``,
    the profiler's own file naming). CPU activities always, CUDA ones
    when torch sees a card. A profiler that cannot start is warned about
    and the region runs unprofiled, as the reference does."""

    def __init__(self, out: str):
        self.out = out
        self._prof = None

    def __enter__(self):
        try:
            import torch
            import torch.profiler as tp

            os.makedirs(self.out, exist_ok=True)
            acts = [tp.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(tp.ProfilerActivity.CUDA)
            prof = tp.profile(
                activities=acts,
                on_trace_ready=tp.tensorboard_trace_handler(self.out))
            prof.__enter__()
            self._prof = prof
        except Exception as exc:  # profiler unavailable here
            logger.warning("telemetry: torch.profiler unavailable (%s); "
                           "skipping device trace", exc)
            self._prof = None
        return self

    def __exit__(self, *exc) -> bool:
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.__exit__(*exc)
        return False


class TelemetryConfig:
    """The ``[telemetry]`` config table as a value object.

    Knobs (all optional):

    - ``enabled``       bool, default False — the whole subsystem is
      opt-in; disabled it costs one attribute check per call site.
    - ``flush_s``       float, default 2.0 — event-buffer drain (and
      gauge sampling) period.
    - ``jax_profiler``  bool, default False — bracket one steady-state
      file per run in ``torch.profiler.profile`` (a Chrome trace of the
      host and the card under ``<log_dir>/jax_trace``; the reference's
      knob name, kept so configs run unchanged).

    ``coerce`` accepts a TelemetryConfig (pass-through), a mapping, or
    None, and rejects unknown keys — the same contract as
    ``IngestConfig.coerce`` (a typo'd knob must raise, not silently
    run with the default).
    """

    KNOBS = ("enabled", "flush_s", "jax_profiler")

    __slots__ = KNOBS

    def __init__(self, enabled: bool = False, flush_s: float = 2.0,
                 jax_profiler: bool = False):
        self.enabled = bool(enabled)
        self.flush_s = max(float(flush_s), 0.05)
        self.jax_profiler = bool(jax_profiler)

    @classmethod
    def coerce(cls, value) -> "TelemetryConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        unknown = set(value) - set(cls.KNOBS)
        if unknown:
            raise ValueError(
                f"unknown [telemetry] option(s) {sorted(unknown)}; "
                f"valid: {list(cls.KNOBS)}")
        return cls(**dict(value))

    def __repr__(self) -> str:  # debugging aid
        return (f"TelemetryConfig(enabled={self.enabled}, "
                f"flush_s={self.flush_s}, "
                f"jax_profiler={self.jax_profiler})")


class StageTimings(dict):
    """``Runner.timings``, spans-backed.

    A genuine ``dict[str, list[float]]`` — every existing consumer
    (``watchdog.timings.get(name, ())``, ``sorted(runner.timings.
    items())``) works unchanged, and per-file index alignment across
    lists is preserved because placeholders are still appended. On top:

    - ``record(name, seconds, skipped=..., unit=..., emit=...)``
      appends AND (when telemetry is enabled and ``emit``) publishes a
      completed span; ``skipped=True`` marks error/resume placeholders.
    - ``samples(name)`` returns only the non-skipped measurements —
      the watchdog's adaptive percentile reads THIS, so placeholder
      zeros never drag deadline budgets toward zero.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._skips: dict[str, set] = {}

    def record(self, name: str, seconds: float, *,
               skipped: bool = False, unit: str = "",
               emit: bool = True, **attrs) -> None:
        vals = self.setdefault(name, [])
        vals.append(float(seconds))
        if skipped:
            self._skips.setdefault(name, set()).add(len(vals) - 1)
        if emit and TELEMETRY.enabled:
            TELEMETRY.event_span(name, seconds, unit=unit,
                                 skipped=skipped, **attrs)

    def samples(self, name: str) -> list:
        """Non-placeholder durations (the adaptive-deadline feed)."""
        vals = self.get(name)
        if not vals:
            return []
        skips = self._skips.get(name)
        if not skips:
            return list(vals)
        return [v for i, v in enumerate(vals) if i not in skips]


#: request-latency histogram bounds (seconds) shared by every HTTP
#: surface: localhost JSON endpoints live in the 1-10 ms bins,
#: tile/cutout transfers reach the 100 ms+ bins, and the +Inf bucket
#: catches stalls. Fixed bounds keep scrapes mergeable across restarts.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class RequestMetrics:
    """Per-request HTTP telemetry: a Prometheus cumulative latency
    histogram plus per-(route, status) counters, shared by the live
    sidecar (``telemetry/live.py``) and the tile server
    (``tiles/http.py``) so both /metrics surfaces speak the same
    schema.

    ``observe()`` is handler-thread-safe and costs one lock + one
    bisect; ``prom_lines()`` renders::

        comap_<name>_request_duration_seconds_bucket{le="0.005"} 4
        comap_<name>_request_duration_seconds_sum 0.012
        comap_<name>_request_duration_seconds_count 5
        comap_<name>_requests_total{route="/metrics",status="200"} 5
    """

    def __init__(self, name: str,
                 buckets: tuple = LATENCY_BUCKETS_S):
        self.name = str(name)
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1: +Inf
        self._sum_s = 0.0
        self._n = 0
        self._routes: dict = {}

    def observe(self, route: str, status: int, dur_s: float) -> None:
        dur_s = max(float(dur_s), 0.0)
        i = bisect.bisect_left(self.buckets, dur_s)
        with self._lock:
            self._counts[i] += 1
            self._sum_s += dur_s
            self._n += 1
            key = (str(route), int(status))
            self._routes[key] = self._routes.get(key, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self._counts), "sum_s": self._sum_s,
                    "n": self._n, "routes": dict(self._routes)}

    def prom_lines(self) -> list:
        snap = self.snapshot()
        base = f"comap_{self.name}_request_duration_seconds"
        lines = [f"# TYPE {base} histogram"]
        cum = 0
        for bound, count in zip(self.buckets, snap["counts"]):
            cum += count
            lines.append(f'{base}_bucket{{le="{bound:g}"}} {cum}')
        cum += snap["counts"][-1]
        lines.append(f'{base}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{base}_sum {snap['sum_s']:.9g}")
        lines.append(f"{base}_count {snap['n']}")
        total = f"comap_{self.name}_requests_total"
        if snap["routes"]:
            lines.append(f"# TYPE {total} counter")
        for (route, status), n in sorted(snap["routes"].items()):
            lines.append(
                f'{total}{{route="{route}",status="{status}"}} {n}')
        return lines
