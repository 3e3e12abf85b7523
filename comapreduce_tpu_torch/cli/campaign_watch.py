"""Watch a running campaign: live plane, health probe, run trends (port of
``tools/campaign_watch.py``).

Subcommands::

    serve    run the live observability sidecar (blocking):
             /metrics (Prometheus), /healthz, /v1/campaign,
             /v1/quality over one campaign state directory
    status   one-shot campaign report (the watchdog report — schema 3
             with the supervisor block when a control plane ran,
             schema 2 otherwise — fetched from a running sidecar with
             --url, else built straight from the state directory;
             local reads also surface the latest control.decision
             events, docs/OPERATIONS.md §19)
    check    liveness probe for cron/CI: exit 0 healthy, 1 not
             (same rule as /healthz and watchdog_report's exit code)
    trend    compare the newest run-registry record against the
             trailing window; exit 1 on regression

Examples::

    python -m comapreduce_tpu_torch.cli.campaign_watch serve run/logs \
        --port 9100
    python -m comapreduce_tpu_torch.cli.campaign_watch status run/logs \
        --stale-s 30
    python -m comapreduce_tpu_torch.cli.campaign_watch check run/logs \
        --n-ranks 3
    python -m comapreduce_tpu_torch.cli.campaign_watch trend \
        --kind perf_gate --window 5

``serve``/``status``/``check`` read the same on-disk state as
``cli.watchdog_report`` — heartbeats, leases, the quarantine and
quality ledgers — and never write. The runbook is
docs/OPERATIONS.md §16.
"""

from __future__ import annotations

import argparse
import json

from comapreduce_tpu_torch.resilience.status import (build_report,
                                                     report_healthy)
from comapreduce_tpu_torch.telemetry.registry import (
    default_registry_path, format_trend, read_runs, trend)


def cmd_serve(args) -> int:
    from comapreduce_tpu_torch.telemetry.live import LiveServer

    srv = LiveServer(args.state_dir, host=args.host, port=args.port,
                     stale_s=args.stale_s, n_ranks=args.n_ranks)
    print(f"live plane: http://{srv.host}:{srv.port}/metrics  "
          f"/healthz  /v1/campaign  /v1/quality")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.stop()
    return 0


def _fetch_report(args) -> dict:
    if args.url:
        from urllib.request import urlopen

        with urlopen(args.url.rstrip("/") + "/v1/campaign",
                     timeout=10) as r:
            return json.load(r)
    return build_report(args.state_dir, stale_s=args.stale_s,
                        n_ranks=args.n_ranks)


def _render_decisions(state_dir: str, last: int = 10) -> str:
    """The latest ``control.decision`` events of this campaign, one
    line each — the control plane's audit trail in the live view
    (docs/OPERATIONS.md §19). Empty string when no loop ever decided
    anything here (no control plane ran, or every loop is off)."""
    from comapreduce_tpu_torch.control.decisions import read_decisions

    events = read_decisions(state_dir)
    if not events:
        return ""
    lines = [f"control decisions ({len(events)} total, "
             f"latest {min(last, len(events))}):"]
    for e in events[-last:]:
        lines.append(f"  {e.get('t')} [{e.get('loop')}] "
                     f"{e.get('action'):<10} {e.get('reason')}")
    return "\n".join(lines)


def cmd_status(args) -> int:
    from comapreduce_tpu_torch.cli.watchdog_report import render_text

    rep = _fetch_report(args)
    if args.json:
        print(json.dumps(rep, sort_keys=True))
    else:
        print(render_text(rep))
        # the decision ledger is on-disk state (not part of the
        # /v1/campaign payload) — readable only when we have the dir
        if not args.url:
            dec = _render_decisions(rep.get("output_dir")
                                    or args.state_dir)
            if dec:
                print()
                print(dec)
    return 0 if report_healthy(rep) else 1


def cmd_check(args) -> int:
    rep = _fetch_report(args)
    ok = report_healthy(rep)
    stuck = bool((rep.get("supervisor") or {}).get("stuck"))
    n_corrupt = (rep.get("n_corrupt", 0)
                 + rep.get("n_corrupt_ledger_lines", 0))
    print(f"{'healthy' if ok else 'UNHEALTHY'}: "
          f"{rep['n_stale']} stale rank(s), "
          f"{rep['n_expired_leases']} expired lease(s)"
          + (", STUCK supervisor" if stuck else "")
          + (f", {n_corrupt} CORRUPT artifact(s)/line(s) — run "
             "python -m comapreduce_tpu_torch.cli.campaign_fsck"
             if n_corrupt else "")
          + f" ({rep['output_dir']})")
    return 0 if ok else 1


def cmd_trend(args) -> int:
    path = args.registry or default_registry_path()
    runs = read_runs(path, kind=args.kind)
    res = trend(runs, window=args.window, tolerance=args.tolerance)
    print(f"registry: {path}"
          + (f" (kind={args.kind})" if args.kind else ""))
    print(format_trend(res))
    return 0 if res["ok"] else 1


def _add_state_args(ap) -> None:
    ap.add_argument("state_dir", nargs="?", default=".",
                    help="campaign state dir ([Global] log_dir; "
                    "<output_dir>/logs also resolves)")
    ap.add_argument("--url", default="",
                    help="fetch from a running sidecar instead of "
                    "reading the state dir (e.g. http://host:9100)")
    ap.add_argument("--stale-s", type=float, default=60.0,
                    help="heartbeat TTL for the probe (default 60; "
                    "pass the campaign's lease_ttl_s)")
    ap.add_argument("--n-ranks", type=int, default=0,
                    help="expected rank count (default: ranks with "
                    "heartbeat files)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run the live HTTP sidecar")
    s.add_argument("state_dir")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=9100)
    s.add_argument("--stale-s", type=float, default=60.0)
    s.add_argument("--n-ranks", type=int, default=0)
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("status", help="print the campaign report")
    _add_state_args(s)
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_status)

    s = sub.add_parser("check", help="liveness probe (exit 0/1)")
    _add_state_args(s)
    s.set_defaults(fn=cmd_check)

    s = sub.add_parser("trend",
                       help="latest registry record vs trailing window")
    s.add_argument("--registry", default="",
                   help="runs.jsonl path (default: "
                   "$COMAP_RUNS_REGISTRY or evidence/runs.jsonl)")
    s.add_argument("--kind", default=None,
                   help="only compare records of this kind")
    s.add_argument("--window", type=int, default=5)
    s.add_argument("--tolerance", type=float, default=0.2,
                   help="fractional slack before a metric counts as "
                   "regressed (default 0.2)")
    s.set_defaults(fn=cmd_trend)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
