"""Campaign executor support: shape buckets, kernel-library warm-up and
build counters (port of ``comapreduce_tpu/pipeline/campaign.py``).

- :class:`CampaignConfig` — the ``[campaign]`` TOML table /
  ``[Campaign]`` INI section: the :class:`~comapreduce_tpu_torch.ops.
  reduce.ShapeBuckets` quanta plus the ``warm_compile`` switch. All
  defaults off.
- :func:`enable_compile_cache` — the ``[ingest] compile_cache_dir``
  knob.
- :func:`start_warmup` / :class:`Warmup` — probes every file's geometry
  on a background thread, overlapped with the first file's read, and
  calls each stage's ``warm_programs`` once per distinct bucket.
- :class:`CompileCounter` — counts builds, libraries found on disk and
  build seconds.

What "compile" means in the port. Eager PyTorch compiles no programs:
a stage's device work at a new shape runs at once. What the port
compiles is its hand-written kernel libraries — ``_build.build`` runs
``nvcc`` for ``sm_90a`` once per ``csrc/*.cu`` source, and the library
is keyed by a hash of its source, so it serves every shape. So:

- :func:`enable_compile_cache` points ``_build``'s library directory at
  ``cache_dir``: a second process finds its libraries there and builds
  nothing. That is the persistent cache, and unlike the reference's it
  needs no threshold knobs;
- a stage's ``warm_programs`` builds (or finds on disk) and loads the
  libraries its ``__call__`` launches, so the main path's first launch
  builds nothing;
- :class:`CompileCounter` keeps the reference's snapshot keys:
  ``backend_compiles`` (``nvcc`` runs), ``cache_misses`` (the same
  runs: a library not on disk), ``cache_hits`` (libraries loaded from
  disk without a build) and ``compile_s`` (build seconds). A library
  already loaded in the process is no event, as a jit call that hits its
  in-process cache is none.

The warm-up is best effort, as the reference's is: a failed build is
recorded in :attr:`Warmup.errors` and logged, and the main path's own
build then raises (``_build.build`` has no fallback). Unlike the
reference's AOT compiles, which reach a run only through the persistent
cache, a warm-up build is loaded into the process, so ``warm_compile``
without ``compile_cache_dir`` still warms the run; it is skipped with
the reference's warning all the same, so the two packages run the same
configs the same way.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass

import numpy as np

from comapreduce_tpu_torch import _build
from comapreduce_tpu_torch.ops.reduce import ShapeBuckets, scan_starts_lengths

__all__ = ["CampaignConfig", "CompileCounter", "enable_compile_cache",
           "probe_observation", "campaign_bucket_set", "Warmup",
           "start_warmup"]

logger = logging.getLogger("comapreduce_tpu_torch")


@dataclass(frozen=True)
class CampaignConfig:
    """Knobs of the campaign layer (``campaign.py:51``).

    ``t_quantum`` / ``scan_quantum`` / ``l_quantum``: the
    :class:`~comapreduce_tpu_torch.ops.reduce.ShapeBuckets` quanta (0 =
    that axis stays per-file exact); padded samples are masked, so
    bucketed outputs match the unpadded path. ``warm_compile``: build
    the stages' kernel libraries on a background thread overlapped with
    the first file's read (needs ``[ingest] compile_cache_dir``)."""

    t_quantum: int = 0
    scan_quantum: int = 0
    l_quantum: int = 0
    warm_compile: bool = False

    def __post_init__(self):
        for k in ("t_quantum", "scan_quantum", "l_quantum"):
            object.__setattr__(self, k, max(int(getattr(self, k) or 0), 0))
        object.__setattr__(self, "warm_compile", bool(self.warm_compile))

    KNOBS = ("t_quantum", "scan_quantum", "l_quantum", "warm_compile")

    @classmethod
    def coerce(cls, value) -> "CampaignConfig":
        """None / dict / CampaignConfig; unknown keys raise."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            known = {k: value[k] for k in cls.KNOBS if k in value}
            unknown = set(value) - set(known)
            if unknown:
                raise ValueError(
                    f"unknown campaign keys: {sorted(unknown)}")
            return cls(**known)
        raise TypeError(f"cannot build CampaignConfig from {type(value)}")

    def shape_buckets(self) -> ShapeBuckets:
        return ShapeBuckets(t_quantum=self.t_quantum,
                            scan_quantum=self.scan_quantum,
                            l_quantum=self.l_quantum)


_CACHE_DIR_ENABLED: str | None = None


def enable_compile_cache(cache_dir: str) -> bool:
    """Keep the kernel libraries in ``cache_dir`` (idempotent; returns
    True when active): later builds land there and a later process loads
    them from there. Libraries of another directory already loaded stay
    loaded, but each kernel's next launch uses the one in ``cache_dir``,
    built or found there first."""
    global _CACHE_DIR_ENABLED
    if not cache_dir:
        return False
    if _CACHE_DIR_ENABLED == cache_dir:
        return True
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    _CACHE_DIR_ENABLED = cache_dir
    logger.info("kernel-library compile cache enabled at %s", cache_dir)
    return True


_ACTIVE_COUNTERS: list = []
_HOOK_LOCK = threading.Lock()
_HOOKS_INSTALLED = False


def _on_build_event(event: str, name: str, seconds: float) -> None:
    for c in list(_ACTIVE_COUNTERS):
        if event == "build":
            c._bump("backend_compiles", seconds)
            c._bump("cache_misses")
        else:
            c._bump("cache_hits")
        c._note(event, name)


def _install_hooks() -> None:
    global _HOOKS_INSTALLED
    with _HOOK_LOCK:
        if not _HOOKS_INSTALLED:
            _build.add_listener(_on_build_event)
            _HOOKS_INSTALLED = True


class CompileCounter:
    """Counts kernel-library builds (``campaign.py:183``).

    ``counts``: ``backend_compiles`` and ``cache_misses`` (``nvcc``
    runs), ``cache_hits`` (libraries found on disk), ``compile_s``
    (build seconds). ``events`` lists ``(event, library, thread name)``
    in order, so a caller can tell the warm-up thread's builds from the
    main path's. Use :meth:`install` / :meth:`remove` or ``with``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {"backend_compiles": 0, "cache_hits": 0,
                       "cache_misses": 0, "compile_s": 0.0}
        self.events: list[tuple[str, str, str]] = []

    def _bump(self, key: str, duration: float = 0.0) -> None:
        with self._lock:
            self.counts[key] += 1
            if duration:
                self.counts["compile_s"] += float(duration)

    def _note(self, event: str, name: str) -> None:
        with self._lock:
            self.events.append((event, name,
                                threading.current_thread().name))

    def install(self) -> "CompileCounter":
        _install_hooks()
        if self not in _ACTIVE_COUNTERS:
            _ACTIVE_COUNTERS.append(self)
        return self

    def remove(self) -> None:
        try:
            _ACTIVE_COUNTERS.remove(self)
        except ValueError:
            pass

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)

    def __enter__(self) -> "CompileCounter":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.remove()


def probe_observation(path: str, pad_to: int = 128) -> dict:
    """Header-only geometry of one Level-1 file: ``{F, B, C, T, S, L,
    calibrator}`` (``campaign.py:262``); a ``synth://`` member is
    arithmetic on its scenario."""
    from comapreduce_tpu_torch.data.level import COMAPLevel1

    if path.startswith("synth://"):
        from comapreduce_tpu_torch.synthetic.memsource import probe_virtual

        return probe_virtual(path, pad_to=pad_to)
    data = COMAPLevel1()
    data.read(path)
    try:
        F, B, C, T = (int(x) for x in data.tod_shape)
        edges = np.asarray(data.scan_edges)
        calibrator = bool(data.is_calibrator)
    finally:
        data.close()
    if len(edges):
        _, _, L = scan_starts_lengths(edges, pad_to=pad_to)
    else:
        L = int(pad_to)
    return {"F": F, "B": B, "C": C, "T": T, "S": int(len(edges)),
            "L": int(L), "calibrator": calibrator}


def campaign_bucket_set(shapes, buckets: ShapeBuckets) -> set:
    """Distinct canonical buckets ``{(F, B, C, Tb, Sb, Lb, calibrator)}``
    of a probed shape list."""
    out = set()
    for s in shapes:
        Tb, Sb, Lb = buckets.canonical(s["T"], s["S"], s["L"])
        out.add((s["F"], s["B"], s["C"], Tb, Sb, Lb,
                 bool(s.get("calibrator", False))))
    return out


class Warmup:
    """Background warm-up of the campaign's bucket set
    (``campaign.py:304``): probes every file, and calls each stage's
    ``warm_programs(**shape)`` once per distinct bucket (the canonical
    bucket when ``buckets`` is given, else the raw geometry). Failures
    are logged and listed in :attr:`errors`, never raised."""

    def __init__(self, stages, files, pad_to: int = 128,
                 buckets: ShapeBuckets | None = None):
        self._stages = [s for s in stages
                        if callable(getattr(s, "warm_programs", None))]
        self._files = list(files)
        self._pad_to = int(pad_to)
        self._buckets = buckets
        self.warmed: list[dict] = []
        self.errors: list[str] = []
        self.shapes: list[dict] = []
        self._thread = threading.Thread(target=self._run,
                                        name="campaign-warmup",
                                        daemon=True)

    def start(self) -> "Warmup":
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout=timeout)

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    def _run(self) -> None:
        seen: set = set()
        for path in self._files:
            try:
                shape = probe_observation(path, pad_to=self._pad_to)
            except Exception as exc:  # noqa: BLE001 — probe-only
                self.errors.append(f"probe {path}: {exc!r}")
                continue
            self.shapes.append(shape)
            if self._buckets is not None:
                key = ((shape["F"], shape["B"], shape["C"])
                       + self._buckets.canonical(shape["T"], shape["S"],
                                                 shape["L"])
                       + (bool(shape.get("calibrator", False)),))
            else:
                key = tuple(sorted(shape.items()))
            if key in seen:
                continue
            seen.add(key)
            for stage in self._stages:
                try:
                    stage.warm_programs(**shape)
                    self.warmed.append(
                        {"stage": getattr(stage, "name",
                                          type(stage).__name__), **shape})
                except Exception as exc:  # noqa: BLE001 — best effort
                    self.errors.append(
                        f"{type(stage).__name__} @ {shape}: {exc!r}")
                    logger.warning(
                        "campaign warm-up: %s failed for %s: %s",
                        type(stage).__name__, shape, exc)


def start_warmup(stages, files, pad_to: int = 128,
                 buckets: ShapeBuckets | None = None) -> Warmup:
    """Start (and return) a daemon :class:`Warmup` over ``files``."""
    return Warmup(stages, files, pad_to=pad_to, buckets=buckets).start()
