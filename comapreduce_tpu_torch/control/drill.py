"""The control drill: all three control loops closed, under chaos (port
of ``comapreduce_tpu/control/drill.py``).

``run_control_drill`` stages the campaign criterion the control
plane exists for — **kill 2 of 4 ranks mid-campaign, fire a
``load_spike`` burst of SLO-flagged files, and prove the supervised
campaign still finishes exactly-once with every shed unit re-admitted
and the final map byte-identical to an undisturbed run**:

- 12 base Level-2 files are queued for 4 elastic worker ranks
  (``python -m comapreduce_tpu_torch.control.drill --worker``, spawned by
  the :class:`~comapreduce_tpu_torch.control.supervisor.Supervisor` through
  its :class:`~comapreduce_tpu_torch.control.manager.RankManager` — the
  fill-to-the-floor rule performs the initial rollout);
- ranks 0 and 1 draw ``rank_kill`` on their third rotation unit:
  SIGKILLed mid-claim, leases leaked, heartbeats frozen — the
  supervisor's reap + CHANGE-based liveness must spawn fresh
  replacement ranks (never reusing the dead ids) within the policy
  cooldown, recorded as auditable ``control.decision`` events;
- rank 2 draws ``load_spike`` on its first commit: 3 extra files land
  in the shared ``queue.json`` mid-run. All 3 are pre-flagged in the
  data-quality ledger, so every rank's admission gate (shed water
  marks low enough that a mid-campaign backlog means pressure) defers
  them — ``deferred`` quarantine-ledger lines — until the base queue
  drains and pressure clears, when they are re-admitted
  (``readmitted`` lines) and reduced: shed, never dropped;
- a :class:`~comapreduce_tpu_torch.telemetry.live.LiveServer` watches
  throughout; the drill audits ``/metrics``
  ``comap_scheduler_committed_total`` against the lease board's done
  count (workers flush telemetry after every commit, so even a
  SIGKILLed rank's commits are all on disk).

Asserts, in order: the supervisor drained the campaign; every one of
the 15 units has a ``done`` lease (exactly once — the fence makes a
double commit impossible, the count makes a lost unit visible); the
survivors' result manifests cover exactly the units the dead ranks
did not finish; spawn decisions replace ranks {0, 1} with fresh ids;
every spike file has a ``deferred`` AND a later ``readmitted`` ledger
line; ``/metrics`` agrees with the lease board; and the destriped map
over the committed set equals a clean in-process run over the same
15 files to the last byte.

The ranks reduce nothing (they claim, hold and commit); the two maps are
read and solved on ``device`` (default ``cuda``; without a card it
raises unless ``device="cpu"``).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import time

import numpy as np

__all__ = ["run_control_drill"]

logger = logging.getLogger("comapreduce_tpu_torch")


def run_control_drill(workdir: str, seed: int = 0, ttl_s: float = 1.5,
                      hold_s: float = 0.4,
                      timeout_s: float = 120.0, device=None) -> dict:
    """Run the full control drill in ``workdir``; returns the evidence
    dict (see the module docstring for the scenario and asserts)."""
    from urllib.request import urlopen

    from comapreduce_tpu_torch.control.config import ControlConfig
    from comapreduce_tpu_torch.control.decisions import read_decisions
    from comapreduce_tpu_torch.control.manager import RankManager
    from comapreduce_tpu_torch.control.supervisor import Supervisor
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.resilience.drill import (_child_env,
                                                        _device_arg, _read,
                                                        _solve, _write_level2)
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger
    from comapreduce_tpu_torch.resilience.lease import (lease_key, lease_path,
                                                        read_lease)
    from comapreduce_tpu_torch.telemetry.live import LiveServer

    t0 = time.perf_counter()
    _device_arg(device)  # no card: raise before any rank starts
    os.makedirs(workdir, exist_ok=True)
    base, spikes = [], []
    for i in range(12):
        path = os.path.join(workdir, f"Level2_comap-{i:04d}.hd5")
        if not os.path.exists(path):
            _write_level2(path, seed=1000 + seed * 100 + i)
        base.append(os.path.abspath(path))
    for i in range(3):
        path = os.path.join(workdir, f"Level2_spike-{i:04d}.hd5")
        if not os.path.exists(path):
            _write_level2(path, seed=2000 + seed * 100 + i)
        spikes.append(os.path.abspath(path))
    everything = sorted(base + spikes)

    state = os.path.join(workdir, "control")
    shutil.rmtree(state, ignore_errors=True)
    os.makedirs(state)
    flist = os.path.join(state, "filelist.txt")
    with open(flist, "w", encoding="utf-8") as f:
        f.write("\n".join(base) + "\n")
    spike_list = os.path.join(state, "spikes.txt")
    with open(spike_list, "w", encoding="utf-8") as f:
        f.write("\n".join(spikes) + "\n")
    # the spike files arrive already SLO-flagged (a bad-weather session
    # being backfilled): the admission gate's flagged-file sensor reads
    # this data-quality ledger
    t_iso = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    with open(os.path.join(state, "quality.rank99.jsonl"), "w",
              encoding="utf-8") as f:
        for s in spikes:
            f.write(json.dumps({
                "schema": 1, "file": os.path.basename(s), "feed": 0,
                "band": 0, "t": t_iso, "t_unix": time.time(),
                "flagged": True,
                "flags": ["drill: pre-flagged spike file"]}) + "\n")
    # pre-publish the queue manifest (what a campaign's rank 0 would
    # write) so the supervisor's very first sense sees the backlog and
    # fill-to-the-floor performs the initial 4-rank rollout
    with open(os.path.join(state, "queue.json"), "w",
              encoding="utf-8") as f:
        names = [os.path.basename(p) for p in base]
        json.dump({"schema": 1, "n": len(names), "files": names,
                   "t_wall": t_iso}, f)

    # faults: ranks 0/1 die claiming their THIRD rotation unit (files
    # 8/9 under 4-rank rotation) — two commits in, work outstanding,
    # the worst moment; rank 2 spikes at its FIRST commit (file 2)
    kill0 = os.path.basename(base[8])
    kill1 = os.path.basename(base[9])
    spike_at = os.path.basename(base[2])

    def argv_for_rank(rank: int) -> list:
        cmd = [sys.executable, "-m", "comapreduce_tpu_torch.control.drill",
               "--worker", f"--rank={rank}", "--n-ranks=4",
               f"--state-dir={state}", f"--filelist={flist}",
               f"--ttl={ttl_s}", f"--seed={seed}",
               f"--hold-s={hold_s}", "--shed-high=2", "--shed-low=0",
               "--telemetry"]
        if rank == 0:
            cmd.append(f"--chaos=rank_kill@{kill0}")
        elif rank == 1:
            cmd.append(f"--chaos=rank_kill@{kill1}")
        elif rank == 2:
            cmd += [f"--chaos=load_spike@{spike_at}",
                    f"--spike-list={spike_list}"]
        return cmd

    manager = RankManager(argv_for_rank, env=_child_env(),
                          log_dir=os.path.join(state,
                                               "supervisor_logs"))
    cfg = ControlConfig(autoscale=True, min_ranks=4, max_ranks=6,
                        cooldown_s=30.0, poll_s=0.3,
                        liveness_ttl_s=3.0)
    sup = Supervisor(state, cfg, manager=manager, lease_ttl_s=ttl_s)
    srv = LiveServer(state, port=0, stale_s=2.0 * ttl_s,
                     n_ranks=4).start()
    try:
        snap = sup.run(max_s=timeout_s)
        assert snap["drained"], \
            f"control drill: campaign did not drain within " \
            f"{timeout_s:.0f} s: {snap}"
        with urlopen(f"http://{srv.host}:{srv.port}/metrics",
                     timeout=10) as r:
            assert r.status == 200
            prom = r.read().decode("utf-8")
    finally:
        manager.terminate_all()
        srv.stop()

    # -- exactly once: the lease board is the ground truth ----------------
    names_all = sorted(os.path.basename(p) for p in everything)
    done_by = {}
    for p in everything:
        st = read_lease(lease_path(state, lease_key(p)))
        assert st is not None and st.get("state") == "done", \
            f"control drill: lease for {os.path.basename(p)} not " \
            f"done: {st}"
        done_by[os.path.basename(p)] = int(st.get("done_by", -1))
    results = {}
    for fn in os.listdir(state):
        if fn.startswith("result.rank") and fn.endswith(".json"):
            with open(os.path.join(state, fn), encoding="utf-8") as f:
                rec = json.load(f)
            results[rec["rank"]] = rec
    assert 0 not in results and 1 not in results, \
        "control drill: a SIGKILLed rank wrote a result manifest"
    committed = sorted(n for r in results.values()
                       for n in r["committed"])
    finished_by_dead = sorted(n for n, r in done_by.items()
                              if r in (0, 1))
    # multiset equality: the survivors committed exactly the units the
    # dead ranks did not — nothing lost, nothing committed twice
    assert committed == sorted(set(names_all)
                               - set(finished_by_dead)), \
        f"control drill: survivors committed {committed}, expected " \
        f"everything but {finished_by_dead}"
    n_spiked = sum(r["stats"]["spiked"] for r in results.values())
    assert n_spiked == len(spikes), \
        f"control drill: load_spike queued {n_spiked} unit(s), " \
        f"expected {len(spikes)}"

    # -- the autoscaler: dead ranks replaced with FRESH ids ---------------
    decisions = read_decisions(state)
    spawns = [d for d in decisions if d["loop"] == "autoscaler"
              and d["action"] == "spawn"]
    replaced = set()
    spawned = set()
    for d in spawns:
        if d.get("dead"):
            replaced.update(int(r) for r in d["dead"])
            spawned.update(int(r) for r in d.get("ranks", ()))
    assert replaced >= {0, 1}, \
        f"control drill: spawn decisions replaced {sorted(replaced)}," \
        f" expected ranks 0 and 1: {spawns}"
    assert len(spawned) >= 2 and not spawned & {0, 1, 2, 3}, \
        f"control drill: replacement ids {sorted(spawned)} must be " \
        f">= 2 fresh ranks (never a reused id)"
    for r in sorted(spawned):
        assert r in results and results[r]["stats"]["claimed"] >= 0, \
            f"control drill: replacement rank {r} left no result " \
            f"manifest (never ran?)"

    # -- admission: every spike file shed AND re-admitted -----------------
    import glob as _glob

    ledgers = sorted(_glob.glob(os.path.join(state,
                                             "quarantine*.jsonl")))
    led = QuarantineLedger(ledgers[0], read_paths=tuple(ledgers[1:]))
    dispositions: dict = {}
    for e in led.entries:
        b = os.path.basename(e.unit["file"])
        dispositions.setdefault(b, []).append(e.disposition)
    for s in spikes:
        b = os.path.basename(s)
        disp = dispositions.get(b, [])
        assert "deferred" in disp, \
            f"control drill: spike file {b} was never ledgered " \
            f"deferred: {disp}"
        assert "readmitted" in disp, \
            f"control drill: spike file {b} shed but never ledgered " \
            f"readmitted — a shed unit must come back: {disp}"
    admission = [d for d in decisions if d["loop"] == "admission"]
    acts = {d["action"] for d in admission}
    assert {"shed_on", "defer", "shed_off"} <= acts, \
        f"control drill: admission decisions incomplete: {acts}"
    assert snap["shed_backlog"] == 0, \
        f"control drill: {snap['shed_backlog']} unit(s) still shed " \
        f"after the drain — deferred work was dropped"

    # -- /metrics audit: every commit emitted exactly one counter ---------
    committed_metric = 0.0
    for ln in prom.splitlines():
        if ln.startswith("comap_scheduler_committed_total{"):
            committed_metric += float(ln.rsplit(" ", 1)[1])
    assert committed_metric == len(everything), \
        f"control drill: /metrics committed {committed_metric} != " \
        f"{len(everything)} done leases"
    assert "comap_control_decision_total{" in prom, \
        "control drill: /metrics lacks comap_control_decision_total"

    # -- the map: chaos + control changed WHO reduced, never WHAT ---------
    wcs = WCS.from_field((170.25, 52.25), (1.0 / 60, 1.0 / 60),
                         (64, 64))
    by_name = {os.path.basename(p): p for p in everything}
    map_ctl = np.asarray(_solve(_read(
        [by_name[n] for n in names_all], wcs, device=device),
        device).destriped_map)
    map_clean = np.asarray(_solve(_read(everything, wcs, device=device),
                                  device).destriped_map)
    identical = bool(np.array_equal(map_ctl, map_clean))
    assert identical, \
        "control drill: supervised-campaign map != clean run over " \
        "the same 15 files"

    return {
        "control_drained": snap["drained"],
        "control_n_done": snap["n_done"],
        "control_replaced": sorted(replaced),
        "control_spawned": sorted(spawned),
        "control_n_decisions": len(decisions),
        "control_shed": sorted(os.path.basename(s) for s in spikes),
        "control_committed_metric": committed_metric,
        "control_map_byte_identical": identical,
        "control_supervisor_snapshot": {
            k: snap[k] for k in ("desired_ranks", "live_ranks",
                                 "dead_ranks", "shed_backlog",
                                 "n_decisions")},
        "control_wall_s": round(time.perf_counter() - t0, 3),
    }


def _worker_main(argv=None) -> int:
    """One supervised drill rank: heartbeat + admission gate +
    scheduler over the shared state dir. Spawned (and reaped) by the
    supervisor's RankManager; chaos makes rank 0/1 the kill victims
    and rank 2 the load-spike source. Results land in
    ``result.rank<r>.json`` exactly like the elastic drill's."""
    import argparse

    from comapreduce_tpu_torch.control.admission import AdmissionController
    from comapreduce_tpu_torch.control.config import ControlConfig
    from comapreduce_tpu_torch.pipeline.scheduler import Scheduler
    from comapreduce_tpu_torch.resilience.chaos import ChaosMonkey
    from comapreduce_tpu_torch.resilience.heartbeat import Heartbeat
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger
    from comapreduce_tpu_torch.telemetry import TELEMETRY

    p = argparse.ArgumentParser(prog="control-drill-worker")
    p.add_argument("--worker", action="store_true")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--n-ranks", type=int, required=True)
    p.add_argument("--state-dir", required=True)
    p.add_argument("--filelist", required=True)
    p.add_argument("--ttl", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chaos", default="")
    p.add_argument("--spike-list", default="")
    p.add_argument("--hold-s", type=float, default=0.0)
    p.add_argument("--shed-high", type=int, default=16)
    p.add_argument("--shed-low", type=int, default=4)
    p.add_argument("--telemetry", action="store_true")
    a = p.parse_args(argv)
    with open(a.filelist, encoding="utf-8") as f:
        files = [ln.strip() for ln in f if ln.strip()]
    if a.telemetry:
        TELEMETRY.configure(a.state_dir, rank=a.rank, flush_s=0.2)
    hb = Heartbeat(a.state_dir, rank=a.rank,
                   period_s=max(a.ttl / 5.0, 0.05))
    hb.start()
    monkey = None
    if a.chaos:
        monkey = ChaosMonkey(a.chaos, seed=a.seed)
        if a.spike_list:
            with open(a.spike_list, encoding="utf-8") as f:
                monkey.spike_files = [ln.strip() for ln in f
                                      if ln.strip()]
    cfg = ControlConfig(admission=True, shed_high_water=a.shed_high,
                        shed_low_water=a.shed_low)
    gate = AdmissionController(cfg, a.state_dir, rank=a.rank)
    ledger = QuarantineLedger(os.path.join(
        a.state_dir, f"quarantine.rank{a.rank}.jsonl"))
    sched = Scheduler(files, a.state_dir, rank=a.rank,
                      n_ranks=a.n_ranks, lease_ttl_s=a.ttl,
                      poll_s=min(a.ttl / 5.0, 0.25), ledger=ledger,
                      chaos=monkey, heartbeat=hb, admission=gate)
    processed, committed = [], []
    for f in sched.claim_iter():
        processed.append(os.path.basename(f))
        if a.hold_s:
            time.sleep(a.hold_s)
        if sched.commit(f):
            committed.append(os.path.basename(f))
        if a.telemetry:
            # a SIGKILL between this commit and the next claim must
            # not lose the commit's counter — the drill's /metrics
            # audit is EXACT
            TELEMETRY.flush()
    out = {"rank": a.rank, "processed": processed,
           "committed": committed, "stats": sched.stats}
    tmp = os.path.join(a.state_dir, f".result.rank{a.rank}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(out, f)
    os.replace(tmp, os.path.join(a.state_dir,
                                 f"result.rank{a.rank}.json"))
    if a.telemetry:
        TELEMETRY.close()
    hb.stop(final_stage="drill.control.done")
    return 0


if __name__ == "__main__":
    _argv = sys.argv[1:]
    if "--worker" in _argv:
        raise SystemExit(_worker_main(_argv))
    import argparse as _ap

    _p = _ap.ArgumentParser(prog="control-drill")
    _p.add_argument("workdir")
    _p.add_argument("--seed", type=int, default=0)
    _p.add_argument("--timeout-s", type=float, default=120.0)
    _p.add_argument("--device", default=None)
    _a = _p.parse_args(_argv)
    _ev = run_control_drill(_a.workdir, seed=_a.seed,
                            timeout_s=_a.timeout_s, device=_a.device)
    print(json.dumps(_ev, indent=2))
