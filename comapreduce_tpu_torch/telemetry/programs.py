"""Program cost and memory registry (port of
``comapreduce_tpu/telemetry/programs.py``).

The ``PROGRAMS`` singleton keeps one record per program name x shape
bucket x precision id (x kernels), deduped in the process and appended
torn-line-safe to ``programs.jsonl`` under the run's state directory. It
rides ``TELEMETRY.configure`` / ``close``: telemetry on means the
registry is on. Record schema (one JSON object per line)::

    {"schema": 1, "kind": "program", "name": "level1.reduce_feeds",
     "shape_bucket": "f32[2,4,1024,16384]", "precision_id": "",
     "backend": "gpu", "rank": 0, "t": "2026-10-18T07:00:00Z",
     "argument_bytes": 536870912, "output_bytes": 786432,
     "temp_bytes": 1610612736}

What a program is in the port. Eager PyTorch compiles no executable to
analyse, so :func:`analyze` measures one eager call of the stage's
device function at its first call of a bucket: ``argument_bytes`` and
``output_bytes`` are the sizes of its tensor arguments and results, and
``temp_bytes`` — on a CUDA device only — is the peak the caching
allocator reached during the call (``torch.cuda.max_memory_allocated``,
its peak reset just before) above what was allocated when the call
began, less the outputs. The reference's ``flops``, ``bytes_accessed``
and ``code_bytes`` come from XLA's cost and memory analyses and are left
out; its schema allows absent keys, and :func:`hbm_regressions` reads
only ``temp_bytes + output_bytes``. ``backend`` is ``"gpu"`` or
``"cpu"``: the device the call ran on.
"""

from __future__ import annotations

import glob as _glob
import json
import logging
import os
import threading
import time

__all__ = ["PROGRAMS", "ProgramRegistry", "analyze", "hbm_regressions",
           "program_key", "programs_path", "read_programs",
           "shape_bucket"]

logger = logging.getLogger("comapreduce_tpu_torch")

PROGRAMS_SCHEMA = 1

# the HBM gate's slack over its baseline (``programs.py:49``)
HBM_SLACK = 1.25

_SHORT = {"float32": "f32", "float64": "f64", "bfloat16": "bf16",
          "float16": "f16", "int32": "i32", "int64": "i64",
          "uint32": "u32", "bool": "b1"}


def programs_path(directory: str) -> str:
    return os.path.join(directory or ".", "programs.jsonl")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def shape_bucket(*args, **kwargs) -> str:
    """A stable shape signature of example arguments (tensors or arrays):
    ``f32[4096,64]xf32[4096]`` (``programs.py:57``). Leaves without a
    shape and dtype are skipped; more than 12 truncate with a ``+N``
    tail."""
    parts = []
    for leaf in _leaves((args, kwargs)):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        name = str(dtype).removeprefix("torch.")
        name = getattr(dtype, "name", name)
        parts.append(f"{_SHORT.get(name, name)}"
                     f"[{','.join(str(int(d)) for d in shape)}]")
    if len(parts) > 12:
        parts, extra = parts[:12], len(parts) - 12
        parts.append(f"+{extra}")
    return "x".join(parts)


def program_key(name: str, bucket: str = "",
                precision_id: str = "", kernels: str = "") -> str:
    """Registry identity of one program (``programs.py:88``)."""
    key = f"{name}|{bucket}|{precision_id}"
    if kernels:
        key = f"{key}|kernels={kernels}"
    return key


def _nbytes(tree) -> int:
    import torch

    n = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            n += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes") and hasattr(leaf, "shape"):
            n += int(leaf.nbytes)
    return n


def _cuda_device(tree):
    import torch

    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


def analyze(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once and measure it: returns
    ``(result, {argument_bytes, output_bytes[, temp_bytes]})``.
    ``temp_bytes`` is measured only when an argument lies on a CUDA
    device (the caching allocator's peak above the call's start, less
    the outputs, the peak reset first)."""
    import torch

    dev = _cuda_device((args, kwargs))
    if dev is not None:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    result = fn(*args, **kwargs)
    out = {"argument_bytes": _nbytes((args, kwargs)),
           "output_bytes": _nbytes(result)}
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        out["temp_bytes"] = int(max(peak - before - out["output_bytes"], 0))
    return result, out


class ProgramRegistry:
    """Process-wide program registry (``programs.py:133``): disabled it
    costs one attribute check; ``configure`` rides
    ``Telemetry.configure``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._path = ""
        self._rank = 0
        self._seen: set = set()
        self._records: list = []

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def path(self) -> str:
        return self._path

    def configure(self, log_dir: str, rank: int = 0) -> "ProgramRegistry":
        with self._lock:
            self._path = programs_path(log_dir)
            self._rank = int(rank)
            self._enabled = True
        return self

    def close(self) -> None:
        with self._lock:
            self._enabled = False
            self._seen.clear()
            self._records.clear()

    def seen(self, name: str, bucket: str = "",
             precision_id: str = "", kernels: str = "") -> bool:
        return program_key(name, bucket, precision_id,
                           kernels) in self._seen

    def snapshot(self) -> list:
        with self._lock:
            return list(self._records)

    def record(self, name: str, analysis: dict, *, shape_bucket: str = "",
               precision_id: str = "", kernels: str = "",
               backend: str = "", extra: dict | None = None):
        """Append one program's record (``programs.py:178``) from an
        :func:`analyze` result; a key already recorded is dropped."""
        if not self._enabled:
            return None
        key = program_key(name, shape_bucket, precision_id, kernels)
        with self._lock:
            if key in self._seen:
                return None
            self._seen.add(key)
        rec = {"schema": PROGRAMS_SCHEMA, "kind": "program",
               "name": str(name), "shape_bucket": shape_bucket,
               "precision_id": precision_id, "backend": backend,
               "rank": self._rank,
               "t": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
        if kernels:
            rec["kernels"] = str(kernels)
        rec.update(analysis)
        if extra:
            rec.update(extra)
        with self._lock:
            self._records.append(rec)
        # (the reference's programs.recorded counter passes name= twice
        # and never lands in its stream; the port emits none either)
        self._append([rec])
        return rec

    def record_call(self, name: str, fn, *args, precision_id: str = "",
                    bucket: str | None = None, kernels: str = "",
                    **kwargs):
        """``fn(*args, **kwargs)``, measured and recorded the first time
        its key is seen while the registry is on (the port's counterpart
        of ``record_jit``, ``programs.py:223``); otherwise just the call.
        Returns the call's result."""
        if not self._enabled:
            return fn(*args, **kwargs)
        if bucket is None:
            bucket = shape_bucket(*args, **kwargs)
        if self.seen(name, bucket, precision_id, kernels):
            return fn(*args, **kwargs)
        result, analysis = analyze(fn, *args, **kwargs)
        dev = _cuda_device((args, kwargs))
        self.record(name, analysis, shape_bucket=bucket,
                    precision_id=precision_id, kernels=kernels,
                    backend="cpu" if dev is None else "gpu")
        return result

    def _append(self, records: list) -> None:
        """The quality ledger's torn-line-safe append (one O_APPEND write
        a batch, a missing trailing newline repaired first)."""
        if not self._path:
            return
        try:
            os.makedirs(os.path.dirname(self._path) or ".",
                        exist_ok=True)
            needs_nl = False
            try:
                with open(self._path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    needs_nl = f.read(1) != b"\n"
            except OSError:
                pass
            payload = "".join(
                json.dumps(r, separators=(",", ":")) + "\n"
                for r in records)
            with open(self._path, "a", encoding="utf-8") as f:
                f.write(("\n" if needs_nl else "") + payload)
                f.flush()
                os.fsync(f.fileno())
        except OSError as exc:
            logger.warning("programs registry append to %s failed "
                           "(%s: %s)", self._path,
                           type(exc).__name__, exc)


PROGRAMS = ProgramRegistry()


def read_programs(source) -> list:
    """Program records from a directory (its ``programs*.jsonl``), one
    path, or a list of paths — latest wins per key, torn lines dropped
    (``programs.py:283``)."""
    if isinstance(source, (list, tuple)):
        paths = [str(p) for p in source]
    elif os.path.isdir(source):
        paths = sorted(_glob.glob(os.path.join(source,
                                               "programs*.jsonl")))
    else:
        paths = [str(source)]
    latest: dict = {}
    for path in paths:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except Exception:
                continue
            if not isinstance(rec, dict) or rec.get("kind") != "program":
                continue
            key = program_key(rec.get("name", ""),
                              rec.get("shape_bucket", ""),
                              rec.get("precision_id", ""),
                              rec.get("kernels", ""))
            latest[key] = rec
    return [latest[k] for k in sorted(latest)]


def hbm_regressions(current: list, baseline: dict,
                    slack: float = HBM_SLACK) -> list:
    """Per-program ``temp_bytes + output_bytes`` against a baseline
    ``{key: bytes}`` (``programs.py:319``); returns failure strings."""
    failures = []
    for rec in current:
        key = program_key(rec.get("name", ""),
                          rec.get("shape_bucket", ""),
                          rec.get("precision_id", ""),
                          rec.get("kernels", ""))
        hbm = (rec.get("temp_bytes") or 0) + (rec.get("output_bytes")
                                              or 0)
        base = baseline.get(key)
        if base is None or base <= 0 or hbm <= 0:
            continue
        if hbm > base * slack:
            failures.append(
                f"program HBM regression: {key} temp+output "
                f"{hbm} B > baseline {base} B x {slack:.2f}")
    return failures
