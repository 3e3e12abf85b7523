"""Operator stall report: render heartbeats + quarantine ledger (port of
``tools/watchdog_report.py``).

Usage::

    python -m comapreduce_tpu_torch.cli.watchdog_report OUTPUT_DIR \
        [--stale-s 60] [--n-ranks N] [--json]

Reads every ``heartbeat.rank*.json``, ``quarantine*.jsonl``,
``lease.*.json`` and the ``queue.json`` manifest in the run's state
directory (the directory given, falling back to ``<dir>/logs`` — the
default ``[Global] log_dir`` layout) and answers the on-call questions
in one screen: which ranks are alive, where each one is
(stage/unit/progress counters), how stale each heartbeat is, which
operations stalled or hung, which units the run deferred
(``rejected``) or durably skipped (``quarantined``), and — for
elastic campaigns (docs/OPERATIONS.md §11) — who holds which lease at
what generation, how many units are done/claimed/pending, and whether
any expired lease is sitting unreclaimed.

The report itself is built by
:mod:`comapreduce_tpu_torch.resilience.status` (shared with the live
observability plane's ``/v1/campaign`` endpoint —
docs/OPERATIONS.md §16); this tool only renders and sets the exit
code.

When a control-plane supervisor ran in the same state directory
(``supervisor.json`` present — docs/OPERATIONS.md §19) the report is
schema 3 and adds the supervisor block: desired vs live ranks, the
last ``control.decision``, the shed backlog, and a STUCK verdict when
the supervisor stopped republishing mid-campaign.

Exit code: 0 when every expected rank's heartbeat is fresher than
``--stale-s`` AND no lease is expired-but-unreclaimed AND no stuck
supervisor; 1 otherwise
(so the report doubles as a liveness probe in cron/CI). ``--n-ranks``
sets the expected rank count (default: the ranks that have heartbeat
files — a fully dead rank that never wrote one can only be caught
with an explicit count). ``--stale-s`` doubles as the lease-expiry
TTL for the report (pass the campaign's ``lease_ttl_s`` to match the
scheduler's view).

The runbook lives in docs/OPERATIONS.md ("Hangs, deadlines &
heartbeats").
"""

from __future__ import annotations

import argparse
import json
import os

from comapreduce_tpu_torch.resilience.status import (build_report,
                                                     report_healthy)


def render_text(rep: dict) -> str:
    lines = [f"watchdog report — {rep['output_dir']} "
             f"(stale threshold {rep['stale_s']:.0f} s)", ""]
    if not rep["ranks"]:
        lines.append("no heartbeat files found (heartbeat_s = 0, or "
                     "the run never started)")
    for r in rep["ranks"]:
        if not r.get("present"):
            lines.append(f"  rank {r['rank']}: NO HEARTBEAT "
                         "(never started, or died before first beat)")
            continue
        flag = "STALE" if r["stale"] else "ok"
        prog = " ".join(f"{k}={v}" for k, v in
                        sorted(r["progress"].items())) or "-"
        lines.append(
            f"  rank {r['rank']} [{flag}] age {r['age_s']:.1f} s  "
            f"seq {r['seq']}  {r['host']}:{r['pid']}")
        lines.append(f"    at: {r['stage'] or '-'}  "
                     f"unit: {r['unit'] or '-'}  progress: {prog}")
        dl = r.get("deadline")
        if dl:
            lines.append(f"    last deadline event: {dl.get('name')} "
                         f"{dl.get('state')} after "
                         f"{dl.get('elapsed_s')} s")
    lines.append("")
    sup = rep.get("supervisor")
    if sup:
        # schema 3: a control plane ran here — desired vs live ranks,
        # the last decision, and the shed backlog are the on-call view
        flag = ("  STUCK (stopped republishing mid-campaign)"
                if sup.get("stuck")
                else "  drained" if sup.get("drained") else "")
        lines.append(
            f"supervisor: desired {sup.get('desired_ranks')} rank(s), "
            f"live {sup.get('live_ranks')}, dead {sup.get('dead_ranks')}"
            f"  (snapshot age {sup.get('age_s', 0):.1f} s){flag}")
        lines.append(
            f"  backlog {sup.get('backlog')}  shed backlog "
            f"{sup.get('shed_backlog')}  "
            f"{sup.get('files_per_hour') or 0:.1f} files/h  "
            f"eta {sup.get('eta_s') if sup.get('eta_s') is not None else '-'} s  "
            f"{sup.get('n_decisions', 0)} decision(s)")
        last = sup.get("last_decision") or {}
        if last:
            lines.append(f"  last decision: [{last.get('loop')}] "
                         f"{last.get('action')} — {last.get('reason')}")
        if sup.get("stuck"):
            lines.append(
                "  a stuck supervisor cannot replace the next dead "
                "rank — restart it (docs/OPERATIONS.md §19)")
        lines.append("")
    if rep.get("queue"):
        q = rep["queue"]
        lines.append(
            f"queue: {q['n_files']} unit(s) — {q['n_done']} done, "
            f"{q['n_claimed']} claimed, {q['n_pending']} pending"
            + (f", {q['n_torn']} torn" if q["n_torn"] else "")
            + (f", {rep['n_stolen']} steal(s) ledgered"
               if rep.get("n_stolen") else ""))
        held: dict = {}
        for l in rep["leases"]:
            if l["state"] == "claimed":
                held.setdefault(l["owner"], []).append(l)
        for owner in sorted(held, key=lambda o: (o is None, o)):
            rows = held[owner]
            lines.append(f"  rank {owner}: {len(rows)} held lease(s)")
            for l in rows:
                flag = "  EXPIRED (unreclaimed)" if l["expired"] else ""
                lines.append(f"    {l['key']}  gen {l['generation']}  "
                             f"age {l['age_s']:.1f} s{flag}")
        torn = [l for l in rep["leases"] if l["state"] == "torn"]
        for l in torn:
            flag = "  EXPIRED (unreclaimed)" if l["expired"] else ""
            lines.append(f"  TORN lease {l['key']}  "
                         f"age {l['age_s']:.1f} s{flag}")
        if rep.get("n_expired_leases"):
            lines.append(
                f"  {rep['n_expired_leases']} expired lease(s) with no "
                "survivor reclaiming them — the campaign is wedged "
                "(docs/OPERATIONS.md §11: start a rank, it will steal)")
        lines.append("")
    if rep["ledger_summary"]:
        lines.append(f"ledger ({', '.join(rep['ledger_files'])}): " +
                     ", ".join(f"{k}: {v}" for k, v in
                               sorted(rep["ledger_summary"].items())))
    else:
        lines.append("ledger: no events")
    for title, rows in (("stall warnings", rep["stalls"]),
                        ("hangs / deferred shards", rep["hangs"]),
                        ("corrupt artifacts",
                         rep.get("corruption", []))):
        if rows:
            lines.append(f"{title} (latest {len(rows)}):")
            for e in rows:
                lines.append(f"  {e['t']} {e['disposition']:<9} "
                             f"{e['stage']:<22} "
                             f"{os.path.basename(e['unit'] or '')} "
                             f"{e['message']}")
    if rep.get("n_corrupt_ledger_lines"):
        lines.append(f"{rep['n_corrupt_ledger_lines']} ledger line(s) "
                     "dropped for failing their integrity seal — run "
                     "python -m comapreduce_tpu_torch.cli.campaign_fsck "
                     "(docs/OPERATIONS.md §20)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output_dir", help="the run's output directory "
                    "(holds heartbeat.rank*.json + quarantine*.jsonl)")
    ap.add_argument("--stale-s", type=float, default=60.0,
                    help="heartbeat age beyond which a rank counts as "
                    "stale (default 60)")
    ap.add_argument("--n-ranks", type=int, default=0,
                    help="expected rank count (default: the ranks that "
                    "wrote heartbeats)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object")
    args = ap.parse_args(argv)

    rep = build_report(args.output_dir, stale_s=args.stale_s,
                       n_ranks=args.n_ranks)
    print(json.dumps(rep) if args.json else render_text(rep))
    return 0 if report_healthy(rep) else 1


if __name__ == "__main__":
    raise SystemExit(main())
