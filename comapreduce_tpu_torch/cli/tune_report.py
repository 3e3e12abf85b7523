"""Operator view of the shape-bucket autotuner's winners cache (port of
``tools/tune_report.py``).

    python -m comapreduce_tpu_torch.cli.tune_report LOG_DIR_OR_FILE [--json]
    python -m comapreduce_tpu_torch.cli.tune_report --selftest

Reads ``tuning.jsonl`` under the run's ``[Global] log_dir``
(``comapreduce_tpu_torch.tuning.cache``, the sealed latest-wins winners
ledger) and
renders one row per cached winner:

- the identity axes: knob group, backend platform / device kind, shape
  bucket, precision policy, knob-space version;
- the winning knob values against the defaults they beat, with the
  measured walls (``best_ms`` vs ``default_ms``) and the speedup;
- the sweep's cost: candidates timed and total measurements — the
  numerator of the amortization math in docs/OPERATIONS.md §21;
- a trailing summary: how many winners differ from their defaults
  (rows marked ``=`` kept the default — the noise floor held) and the
  total sweep measurements the cache now saves every warm campaign.

Torn, tampered and stale-space lines never reach the table — the
reader inherits the ledger's seal-verified latest-wins contract.

``--selftest`` writes winners through the real sealed append path
(including a torn trailing line and a superseded key), reads them back
and validates the report — the CI smoke.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

__all__ = ["main", "render", "selftest", "summarize_tuning"]


def summarize_tuning(records: dict) -> dict:
    """Fold the ``{key: record}`` cache into the report structure:
    rows sorted by (group, bucket), plus the totals the operator
    actually asks for (sweeps saved, winners beating defaults)."""
    rows = []
    for key, rec in records.items():
        winner = rec.get("winner") or {}
        default = rec.get("default") or {}
        best = rec.get("best_ms")
        base = rec.get("default_ms")
        rows.append({
            "key": str(key)[:12],
            "group": rec.get("group", ""),
            "platform": rec.get("platform", ""),
            "device_kind": rec.get("device_kind", ""),
            "bucket": rec.get("bucket"),
            "precision_id": rec.get("precision_id", ""),
            "space_version": rec.get("space_version"),
            "winner": winner,
            "default": default,
            "tuned": winner != default,
            "best_ms": best,
            "default_ms": base,
            "speedup": (round(base / best, 3)
                        if best and base else None),
            "candidates": rec.get("candidates"),
            "measurements": rec.get("measurements"),
            "t": rec.get("t", ""),
        })
    rows.sort(key=lambda r: (r["group"], json.dumps(r["bucket"],
                                                    sort_keys=True,
                                                    default=str)))
    return {
        "n_winners": len(rows),
        "n_tuned": sum(1 for r in rows if r["tuned"]),
        "measurements_saved": sum(int(r["measurements"] or 0)
                                  for r in rows),
        "rows": rows,
    }


def _bucket_str(bucket) -> str:
    if isinstance(bucket, dict):
        return "|".join(f"{k}={bucket[k]}" for k in sorted(bucket)
                        if k != "group")
    return str(bucket)


def _knobs_str(combo) -> str:
    if isinstance(combo, dict):
        return " ".join(f"{k}={combo[k]}" for k in sorted(combo))
    return str(combo)


def render(report: dict) -> str:
    lines = ["shape-bucket autotuner winners "
             f"({report['n_winners']} cached, {report['n_tuned']} beat "
             "their defaults)", ""]
    header = (f"{'group':<8} {'bucket':<22} {'winner':<28} "
              f"{'vs default':<24} {'speedup':>8} {'meas':>5}")
    lines += [header, "-" * len(header)]
    for r in report["rows"]:
        mark = " " if r["tuned"] else "="
        speed = f"{r['speedup']:.2f}x" if r["speedup"] else "-"
        walls = (f"{r['best_ms']}ms vs {r['default_ms']}ms"
                 if r["best_ms"] is not None else "-")
        lines.append(
            f"{r['group']:<8} {_bucket_str(r['bucket']):<22} "
            f"{mark}{_knobs_str(r['winner']):<27} {walls:<24} "
            f"{speed:>8} {r['measurements'] or 0:>5}")
    lines += ["", f"rows marked '=' kept the default (noise floor "
                  "held); a warm campaign re-measures nothing — "
                  f"{report['measurements_saved']} sweep "
                  "measurement(s) amortised (docs/OPERATIONS.md §21)"]
    return "\n".join(lines)


def selftest() -> int:
    from comapreduce_tpu_torch.tuning.cache import (TuningCache, content_key,
                                              read_tuning, tuning_path)

    work = tempfile.mkdtemp(prefix="tune_report_selftest_")
    path = tuning_path(work)
    cache = TuningCache(path)
    key_p = content_key("cpu", "cpu", {"group": "plan", "N": 36864,
                                       "L": 50}, "", 1, "plan")
    key_s = content_key("cpu", "cpu", {"group": "solver", "L": 50},
                        "", 1, "solver")
    # a superseded winner first: latest-wins must hide it
    cache.put({"key": key_p, "group": "plan", "platform": "cpu",
               "device_kind": "cpu", "bucket": {"group": "plan",
                                                "N": 36864, "L": 50},
               "space_version": 1, "winner": {"pair_batch": 8},
               "default": {"pair_batch": 1}, "best_ms": 9.0,
               "default_ms": 12.0, "candidates": 4, "measurements": 9})
    cache.put({"key": key_p, "group": "plan", "platform": "cpu",
               "device_kind": "cpu", "bucket": {"group": "plan",
                                                "N": 36864, "L": 50},
               "space_version": 1, "winner": {"pair_batch": 4},
               "default": {"pair_batch": 1}, "best_ms": 8.1,
               "default_ms": 11.9, "candidates": 4, "measurements": 9})
    cache.put({"key": key_s, "group": "solver", "platform": "cpu",
               "device_kind": "cpu", "bucket": {"group": "solver",
                                                "L": 50},
               "space_version": 1,
               "winner": {"mg_block": 8, "mg_smooth": 1},
               "default": {"mg_block": 8, "mg_smooth": 1},
               "best_ms": 5.0, "default_ms": 5.0, "candidates": 6,
               "measurements": 12})
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"kind": "tuning", "key": "torn')  # no newline: torn

    records = read_tuning(work)
    assert len(records) == 2, f"expected 2 keys, got {len(records)}"
    report = summarize_tuning(records)
    assert report["n_winners"] == 2 and report["n_tuned"] == 1, report
    by_group = {r["group"]: r for r in report["rows"]}
    assert by_group["plan"]["winner"] == {"pair_batch": 4}, \
        "latest-wins lost: the superseded pair_batch=8 row surfaced"
    assert by_group["plan"]["speedup"] and \
        by_group["plan"]["speedup"] > 1.0
    assert not by_group["solver"]["tuned"], \
        "a default-keeping winner must render as '=' (not tuned)"
    assert report["measurements_saved"] == 21
    out = render(report)
    assert "pair_batch=4" in out and "§21" in out
    print(out)
    print("\ntune_report selftest: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source", nargs="?", default=".",
                    help="run log_dir (or a tuning.jsonl path)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()

    from comapreduce_tpu_torch.tuning.cache import read_tuning

    records = read_tuning(args.source)
    if not records:
        print(f"no tuning winners under {args.source!r} (tuning.jsonl "
              "missing or empty — has a [tuning]-enabled sweep run?)",
              file=sys.stderr)
        return 1
    report = summarize_tuning(records)
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
