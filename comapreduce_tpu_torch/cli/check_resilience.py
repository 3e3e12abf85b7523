"""Resilience smoke: run the chaos drill, exit 0 iff every promise held.

The port of ``tools/check_resilience.py``. Usage::

    python -m comapreduce_tpu_torch.cli.check_resilience [--device cpu]
        [--workdir DIR] [--seed N] [--keep]
        [--elastic-only | --serving-only | --tiles-only | --synthetic-only
         | --live-only | --integrity-only | --control-only]

Injects one fault of every class (read error, truncated file,
first-attempt flake, NaN burst, slow read, HANGING read) over a
synthetic Level-2 fixture set and asserts the resilience layer's
contract (``comapreduce_tpu_torch/resilience/drill.py``): zero unhandled
exceptions, every fault ledgered with the correct classification
(including the hung read: soft-deadline ``stalled`` warning, then
hard-deadline cancel triaged ``hang``/``rejected``), the destriped map
byte-identical to the clean run with the faulted units zero-weighted,
quarantine skip/re-admit behaving across runs, and every cancelled
hang landing within ``hard deadline + grace`` — the watchdog contract
is exercised on every run.

``--elastic-only`` runs criterion 7 instead: the rank-kill/rank-pause
elastic-campaign drill (``run_elastic_drill`` — three real worker
processes; one SIGKILLed mid-lease, one zombified mid-unit, one
survivor that steals both leases), asserting exactly-once commits, the
zombie's late commit fence-rejected, stolen/recovered ledgered, and
the map byte-identical to a clean run. Kept as a separate CI step
("Rank-kill drill") because it spawns subprocesses and costs ~20 s.

``--serving-only`` runs criterion 8: the incremental map-server drill
(``run_serving_drill`` — server subprocesses folding committed files
in waves), asserting exactly-once folding across epochs, SIGKILL
mid-publish leaving ``current`` on the last complete epoch and the
resumed run byte-identical to an uninterrupted twin, an epoch built
from per-file incremental aggregates byte-identical to a batch
read+solve, and a warm-started epoch converging in strictly fewer CG
iterations than a cold solve of the same census (maps agreeing modulo
the weighted-mean null mode).

``--live-only`` runs the live observability drill (``run_live_drill``
— two real worker ranks under a ``LiveServer`` sidecar, one SIGKILLed
mid-lease then restarted), asserting ``/healthz`` flips 200→503 within
one heartbeat TTL of the kill and back to 200 after the steal +
restart, the ``/metrics`` Prometheus page parses with its commit
counter equal to the scheduler's commit count EXACTLY, and
``/v1/campaign`` serves the schema-2 report
(docs/OPERATIONS.md §16).

``--tiles-only`` runs criterion 9: the map tile read tier drill
(``run_tiles_drill`` — server subprocesses tiling published epochs
into a content-addressed root, a real ``cli.tile_server`` HTTP
front), asserting a SIGKILL between tile object writes and the
manifest rename leaves readers on the previous complete tile set
(old-or-new, never torn), the CLI backfill + fresh-root re-tile is
byte-identical (deterministic encoding; exact deltas), an HTTP cutout
is bit-identical to slicing the expanded epoch FITS with 304s
surviving a ``/v1/current`` rollback, each serving process takes its
own telemetry lane, and ``MapServer.evict`` reproduces the
pre-eviction epoch's tile hashes exactly.

``--synthetic-only`` runs the synthetic scale drill
(``comapreduce_tpu_torch/synthetic/loadgen.py`` — a generated ``synth://``
campaign of ``--n-files`` virtual Level-1 files pointed at three real
elastic reduce ranks, the map server, and the tile tier
simultaneously): rank 1 is SIGKILLed while holding a live lease and a
fresh process rejoins mid-run, asserting exactly-once lease commits
(survivor counts + the stolen leak sum to the campaign), ``/healthz``
flipping 503 within one TTL and recovering after the rejoin, a
mid-run epoch published under load plus a fresh final epoch whose
census is the full campaign, the tile manifest tracking ``current``,
and the ``/metrics`` per-rank commit counters EXACTLY equal to each
surviving scheduler's own count (docs/OPERATIONS.md §18).

``--integrity-only`` runs criterion 10: the end-to-end integrity
plane (docs/OPERATIONS.md §20). One byte is flipped in a committed
artifact of every durable class — Level-2 checkpoint, BlockCache
spill entry, solver snapshot, epoch FITS, tile object, quarantine
ledger line — and the drill asserts ``cli.campaign_fsck``
detects 100% of the damage, every read boundary triages its class
correctly (corrupt disposition / cache miss / cold solve /
``verify_epoch`` problem / ``CorruptArtifactError`` / dropped line),
chaos ``bit_rot`` rot is always detectable and fires at most once per
basename, and ``--repair`` plus re-derivation converges to a final
map byte-identical to the clean run's.

``--control-only`` runs the closed-loop control-plane drill
(``comapreduce_tpu_torch/control/drill.py`` — a ``Supervisor`` + real
``RankManager`` children over a 12-file elastic campaign): the
autoscaler's fill-to-the-floor performs the initial 4-rank rollout,
ranks 0 and 1 are SIGKILLed at their third claim and replaced by
fresh rank ids within one policy decision, a ``load_spike`` chaos
fault lands 3 pre-flagged files mid-run which every rank's admission
gate sheds ``deferred`` under SLO pressure and re-admits when it
clears (never dropped — asserted through the merged quarantine
ledgers), the ``/metrics`` commit counter equals the lease board's
done count EXACTLY, and the final map over the committed set is
byte-identical to an undisturbed run (docs/OPERATIONS.md §19).

Prints one JSON evidence line; non-zero exit (with the broken
criterion named) on any failure. ``--device`` is the drills' device
(default ``cuda``: without a card it raises unless ``--device cpu``);
their worker processes receive it on their command line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workdir", default="",
                    help="fixture/ledger directory (default: a tmpdir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep", action="store_true",
                    help="keep the workdir (inspect the ledger/fixtures)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--elastic-only", action="store_true",
                      help="run only criterion 7 (the rank-kill/"
                      "rank-pause elastic-campaign drill)")
    only.add_argument("--serving-only", action="store_true",
                      help="run only criterion 8 (the incremental "
                      "map-server kill/resume/warm-start drill)")
    only.add_argument("--tiles-only", action="store_true",
                      help="run only criterion 9 (the map tile read "
                      "tier kill/backfill/HTTP/evict drill)")
    only.add_argument("--live-only", action="store_true",
                      help="run only the live observability drill "
                      "(healthz flip on SIGKILL/recovery, exact "
                      "/metrics commit counter)")
    only.add_argument("--synthetic-only", action="store_true",
                      help="run only the synthetic scale drill (a "
                      "generated synth:// campaign through elastic "
                      "ranks + map server + tile tier with a mid-run "
                      "rank kill/rejoin)")
    only.add_argument("--integrity-only", action="store_true",
                      help="run only criterion 10 (the integrity "
                      "plane: one byte flipped per artifact class, "
                      "100%% fsck detection, correct per-class "
                      "triage, repair converges to a byte-identical "
                      "map)")
    only.add_argument("--control-only", action="store_true",
                      help="run only the control-plane drill (the "
                      "supervisor rolls out 4 worker ranks, 2 are "
                      "SIGKILLed mid-campaign and replaced within the "
                      "policy, a load_spike lands flagged files that "
                      "admission sheds 'deferred' and re-admits, with "
                      "exact /metrics commit audit and a byte-"
                      "identical final map)")
    ap.add_argument("--n-files", type=int, default=200,
                    help="campaign size for --synthetic-only "
                    "(default 200)")
    ap.add_argument("--device", default=None,
                    help="the drills' device (default cuda; 'cpu' runs "
                    "the plain PyTorch versions)")
    args = ap.parse_args(argv)

    from comapreduce_tpu_torch.resilience.drill import (run_drill,
                                                        run_elastic_drill,
                                                        run_integrity_drill,
                                                        run_live_drill,
                                                        run_serving_drill,
                                                        run_tiles_drill)

    if args.synthetic_only:
        from comapreduce_tpu_torch.synthetic.loadgen import run_synthetic_drill

        def drill(workdir, seed=0, device=None):
            return run_synthetic_drill(workdir, seed=seed,
                                       n_files=args.n_files, device=device)
    elif args.control_only:
        from comapreduce_tpu_torch.control.drill import run_control_drill

        drill = run_control_drill
    else:
        drill = (run_live_drill if args.live_only
                 else run_integrity_drill if args.integrity_only
                 else run_tiles_drill if args.tiles_only
                 else run_serving_drill if args.serving_only
                 else run_elastic_drill if args.elastic_only
                 else run_drill)
    workdir = args.workdir or tempfile.mkdtemp(prefix="check_resilience_")
    try:
        try:
            evidence = drill(workdir, seed=args.seed, device=args.device)
        except AssertionError as exc:
            print(json.dumps({"ok": False, "criterion": str(exc)}))
            return 1
        print(json.dumps({"ok": True, **evidence}))
        return 0
    finally:
        if not args.keep and not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
