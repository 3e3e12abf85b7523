"""One run of one cell: set-up, the measured window, the traced
window's readings, the check against the plain reference, the result.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json``, its configuration's file (``configs/<config>.json``),
its own file (``workloads/<cell>.json``: driver, traffic parameters,
limits), the driver (``drivers/<driver>.py``) and one reader per
per-layer metric (``metrics/<metric>.py``).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import logging
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark import trace as tr
from benchmark.check import judge
from benchmark.imports import forbidden_modules

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM_LOGGER = "comapreduce_tpu_torch"


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    sizes: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    if manifest is None:
        manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"]
                  if c["name"] == entry["config"])
    sizes = json.loads((ROOT / config["file"]).read_text())
    traffic = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    return Cell(name, entry, config, sizes, traffic,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)])


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def load_metric(name: str):
    """The reader ``metrics/<name>.py`` (names hold dots, so by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class StageLog(logging.Handler):
    """The program's logged set-up stages (records with ``stage`` and
    ``seconds``, until ``recording`` is cleared); its warnings go on to
    standard error."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.recording = True
        self.setup: list = []

    def emit(self, record):
        if hasattr(record, "stage") and hasattr(record, "seconds"):
            if self.recording:
                self.setup.append((record.stage, float(record.seconds)))
        elif record.levelno >= logging.WARNING:
            print(f"[program] {record.getMessage()}", file=sys.stderr)


@dataclass
class Context:
    """What a per-layer reader reads."""

    cell: str
    sizes: dict
    driver: object
    records: list
    window_s: float
    stages: StageLog
    trace: tr.Analysis | None = None
    probes: dict = field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float | None = None,
        manifest: dict | None = None, sizes: dict | None = None) -> dict:
    """One run; returns the result line's object (``compared`` last).
    ``sizes`` replaces keys of the configuration (the tests' small
    shapes on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell = load_cell(cell_name, manifest)
    cell.sizes.update(sizes or {})
    stages = StageLog()
    plog = logging.getLogger(PROGRAM_LOGGER)
    plog.setLevel(logging.INFO)
    plog.addHandler(stages)
    try:
        driver = load_driver(cell.traffic["driver"]).Driver(
            cell.sizes, cell.traffic, seed, dev)
        _sync(dev)
        setup_s = time.perf_counter() - t_start
        print(f"setup: {setup_s:.3f} s ({getattr(driver, 'timings', {})})",
              file=sys.stderr)
        stages.recording = False
        readers = ({m["name"]: load_metric(m["name"])
                    for m in cell.per_layer} if trace else {})
        probes = {n: r.probe() for n, r in readers.items()
                  if hasattr(r, "probe")}
        for p in probes.values():
            p.install()
        records: list = []
        tracer = tr.Tracer() if trace else contextlib.nullcontext()
        span = (tracer.span if trace
                else (lambda name: contextlib.nullcontext()))
        try:
            with tracer:
                with span("window"):
                    w0 = time.perf_counter()
                    t_unit = w0
                    while True:
                        with span(driver.unit):
                            records.append(driver.step())
                        t = time.perf_counter()
                        records[-1]["unit_s"] = t - t_unit
                        t_unit = t
                        if t - w0 >= seconds:
                            break
                    _sync(dev)
                    window_s = time.perf_counter() - w0
        finally:
            for p in probes.values():
                p.uninstall()
        units = sorted(r["unit_s"] for r in records)
        print(f"window: {window_s:.3f} s, {len(records)} {driver.unit}s, "
              f"each {units[0]:.4f} / {units[len(units) // 2]:.4f} / "
              f"{units[-1]:.4f} s (least / median / most)"
              + (f"; {sum(r['n_iter'] for r in records) / len(records):.2f}"
                 " CG iterations a unit" if "n_iter" in records[0] else ""),
              file=sys.stderr)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        analysis = tracer.analysis() if trace else None
        if analysis is not None:
            print(f"trace: {analysis.n_device_ops()} device operations; "
                  f"the first {analysis.lead_s:.6f} s after the window "
                  f"opens, the last ends {analysis.tail_s:.6f} s before "
                  "it closes", file=sys.stderr)
        ctx = Context(cell.name, cell.sizes, driver, records, window_s,
                      stages, analysis,
                      {n: p.calls for n, p in probes.items()})
        if trace:
            metrics = {}
            for m in cell.per_layer:
                v = readers[m["name"]].read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        else:
            e2e = driver.end_to_end(records, window_s)
            e2e["setup_s"] = setup_s
            metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        driver.release()
        del ctx
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers, failed = judge(driver.compare(records, "f64"),
                                cell.traffic["limits"])
    finally:
        plog.removeHandler(stages)
    correct = all(n["value"] <= n["limit"] for n in numbers)
    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": int(cell.entry["chips"]),
                      "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = analysis.busy_s
        out["device"]["window_s"] = analysis.window_s
        out["breakdown"] = analysis.breakdown()
    out["compared"] = {n["name"]: {"value": n["value"], "limit": n["limit"]}
                       for n in numbers}
    return out


def emit(out: dict) -> int:
    """Print the result (the compared numbers last on standard error,
    the object last on standard output); refuse to print when a
    forbidden module is loaded."""
    bad = forbidden_modules(sys.modules)
    if bad:
        print("forbidden modules loaded: " + ", ".join(sorted(bad)),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, n in out["compared"].items():
        v = n["value"]
        print(f"compared {name} {v!r} limit {n['limit']!r} "
              f"{'ok' if v <= n['limit'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=True))
    sys.stdout.flush()
    return 0

