"""The campaign supervisor: the autoscaler loop, closed (port of
``comapreduce_tpu/control/supervisor.py``).

One poll cycle = **sense → decide → act → publish**:

- **sense** — queue depth from ``queue.json`` + the lease board (done
  / claimed / outstanding counts, commit timestamps for the measured
  files-per-hour rate and its ETA), rank liveness from the
  CHANGE-based :class:`~comapreduce_tpu_torch.resilience.heartbeat
  .HeartbeatWatch` (a crashed rank's final beat never reads alive —
  the file stops changing), child exits from the
  :class:`~comapreduce_tpu_torch.control.manager.RankManager` reap, and the
  shed backlog from the quarantine ledger's ``deferred`` lines;
- **decide** — :class:`~comapreduce_tpu_torch.control.autoscaler
  .AutoscalePolicy` (replace the dead, fill to the floor, scale up
  under cooldown, retire the idle);
- **act** — spawn through the manager; every action is recorded as a
  ``control.decision`` event whether or not it changes anything;
- **publish** — ``supervisor.json`` in the state directory (durable
  replace): desired vs live ranks, backlog, shed backlog, last
  decision, poll period. ``cli.watchdog_report`` renders it as
  its schema-3 supervisor columns and exits 1 on a stuck loop (the
  file's age tells on a supervisor that died mid-campaign).

The supervisor is a *sidecar*: it holds no leases, reduces nothing,
and a campaign runs identically without it — minus the self-healing.
Run it in-process (the control drill) or as the operator CLI::

    python -m comapreduce_tpu_torch.control.supervisor STATE_DIR \\
        --spawn-cmd 'python -m comapreduce_tpu_torch.cli.run_destriper \\
        cfg.ini --rank {rank}' --min-ranks 4 --max-ranks 8

The supervisor touches no device; each rank's command carries its own
(``--device``; the CLIs default to ``cuda``).
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import logging
import os
import shlex
import time

from comapreduce_tpu_torch.control.autoscaler import AutoscalePolicy
from comapreduce_tpu_torch.control.config import ControlConfig
from comapreduce_tpu_torch.control.decisions import record_decision
from comapreduce_tpu_torch.control.manager import RankManager
from comapreduce_tpu_torch.data.durable import durable_replace
from comapreduce_tpu_torch.resilience.heartbeat import (HeartbeatWatch,
                                                        read_heartbeats)
from comapreduce_tpu_torch.resilience.lease import read_lease

__all__ = ["SUPERVISOR_FILE", "Supervisor", "read_supervisor",
           "shed_backlog", "supervisor_stuck"]

logger = logging.getLogger("comapreduce_tpu_torch")

SUPERVISOR_FILE = "supervisor.json"
SUPERVISOR_SCHEMA = 1

#: measured-rate window: commits older than this do not count toward
#: the current files-per-hour estimate
_RATE_WINDOW_S = 300.0


def read_supervisor(state_dir: str) -> dict | None:
    """The latest supervisor snapshot; None when missing/torn (= no
    supervisor ran here — the watchdog stays schema 2)."""
    try:
        with open(os.path.join(state_dir or ".", SUPERVISOR_FILE),
                  "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def supervisor_stuck(snap: dict | None, now: float | None = None,
                     grace: float = 10.0) -> bool:
    """True when a supervisor snapshot exists but has not been
    republished for 5 poll periods (+ ``grace``) with the queue still
    undrained — a control loop that died mid-campaign. A DRAINED
    campaign's supervisor legitimately stops publishing."""
    if snap is None:
        return False
    if snap.get("drained"):
        return False
    now = time.time() if now is None else now
    age = now - float(snap.get("t_unix") or 0.0)
    poll = float(snap.get("poll_s") or 1.0)
    return age > 5.0 * poll + grace


def shed_backlog(state_dir: str) -> int:
    """Units whose LATEST quarantine-ledger line says ``deferred`` —
    shed by admission control and not yet re-admitted."""
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger

    ledgers = sorted(_glob.glob(os.path.join(state_dir or ".",
                                             "quarantine*.jsonl")))
    if not ledgers:
        return 0
    led = QuarantineLedger(ledgers[0], read_paths=tuple(ledgers[1:]))
    return sum(n for k, n in led.summary().items()
               if k.endswith(":deferred"))


class Supervisor:
    """See the module docstring. ``manager=None`` runs the loop
    sensors-and-decisions only (decisions are recorded but nothing is
    spawned) — the dry-run / observe mode."""

    def __init__(self, state_dir: str, config: ControlConfig,
                 manager: RankManager | None = None,
                 lease_ttl_s: float = 60.0, clock=time.monotonic,
                 sleep=time.sleep):
        self.state_dir = state_dir or "."
        self.cfg = ControlConfig.coerce(config)
        self.manager = manager
        self.clock = clock
        self.sleep = sleep
        ttl = self.cfg.liveness_ttl_s or 2.0 * float(lease_ttl_s)
        self.watch = HeartbeatWatch(ttl_s=ttl, clock=clock)
        self.policy = AutoscalePolicy(self.cfg, clock=clock)
        self.desired = self.cfg.min_ranks
        self.last_decision: dict | None = None
        self.n_decisions = 0
        # dead ranks already replaced (or judged not worth replacing):
        # a rank is replaced at most once
        self._replaced: set = set()
        self._crashed: set = set()

    # -- sense ---------------------------------------------------------------
    def _queue_sense(self) -> dict:
        from comapreduce_tpu_torch.pipeline.scheduler import read_manifest

        man = read_manifest(self.state_dir) or {}
        n_files = len(man.get("files", []))
        n_done = n_claimed = 0
        now_unix = time.time()
        recent = 0
        for p in _glob.glob(os.path.join(self.state_dir,
                                         "lease.*.json")):
            st = read_lease(p)
            if st is None:
                continue
            if st.get("state") == "done":
                n_done += 1
                t_done = st.get("t_done_unix")
                if t_done and now_unix - float(t_done) <= _RATE_WINDOW_S:
                    recent += 1
            elif st.get("state") == "claimed":
                n_claimed += 1
        backlog = max(n_files - n_done, 0)
        rate = (recent * 3600.0 / _RATE_WINDOW_S) if recent else None
        return {"n_files": n_files, "n_done": n_done,
                "n_claimed": n_claimed, "backlog": backlog,
                "files_per_hour": rate,
                "eta_s": (backlog * 3600.0 / rate
                          if rate and backlog else None)}

    def sense(self) -> dict:
        crashed = set()
        if self.manager is not None:
            for rank, rc in self.manager.reap():
                if rc != 0:
                    crashed.add(rank)
                    self._crashed.add(rank)
        q = self._queue_sense()
        beats = read_heartbeats(self.state_dir)
        self.watch.observe(beats)
        live = set(self.watch.alive_ranks())
        if self.manager is not None:
            # a just-spawned child that has not written its first beat
            # yet is STARTING, not dead — count it live, or the
            # fill-to-the-floor rule refires every poll of the startup
            # window; once it has a heartbeat file the CHANGE-based
            # verdict governs (a zombie child is still judged dead)
            live |= {r for r in self.manager.live_ranks()
                     if r not in beats}
        # a reaped child is NOT alive, however fresh its final beats
        # still look to the heartbeat watch — the reap outruns the TTL
        live -= self._crashed
        live = sorted(live)
        # dead = heartbeat unchanged past the TTL, plus children the
        # manager just reaped with a non-zero exit (faster than the
        # TTL — the reap is immediate); each replaced at most once
        dead = sorted((set(self.watch.dead_ranks()) | crashed
                       | self._crashed) - self._replaced
                      - set(live))
        q.update({"live_ranks": live, "dead_ranks": dead,
                  "shed_backlog": shed_backlog(self.state_dir)})
        return q

    # -- decide + act --------------------------------------------------------
    def step(self) -> dict:
        """One full cycle; returns the published snapshot."""
        s = self.sense()
        decision = None
        if self.cfg.autoscale:
            reserved = self._replaced | self._crashed
            if self.manager is not None:
                reserved |= set(self.manager.all_ranks())
            decision = self.policy.decide(
                backlog=s["backlog"], live_ranks=s["live_ranks"],
                dead_ranks=s["dead_ranks"], reserved_ranks=reserved,
                files_per_hour=s["files_per_hour"])
        if decision is not None:
            entry = record_decision(
                self.state_dir, "autoscaler", decision.action,
                decision.reason, ranks=list(decision.ranks),
                backlog=s["backlog"], live=list(s["live_ranks"]),
                dead=list(s["dead_ranks"]))
            self.last_decision = entry
            self.n_decisions += 1
            if decision.action == "spawn":
                self._replaced.update(int(r) for r in s["dead_ranks"])
                self.desired = min(
                    max(self.desired,
                        len(s["live_ranks"]) + len(decision.ranks)),
                    self.cfg.max_ranks)
                self.policy.note_spawned()
                if self.manager is not None:
                    for r in decision.ranks:
                        self.manager.spawn(r)
            elif decision.action == "retire":
                self.desired = self.cfg.min_ranks
        return self._publish(s)

    def _publish(self, s: dict) -> dict:
        snap = {"schema": SUPERVISOR_SCHEMA, "t_unix": time.time(),
                "poll_s": self.cfg.poll_s,
                "autoscale": self.cfg.autoscale,
                "desired_ranks": self.desired,
                "live_ranks": s["live_ranks"],
                "dead_ranks": sorted(self._crashed
                                     | set(s["dead_ranks"])
                                     | self._replaced),
                "n_files": s["n_files"], "n_done": s["n_done"],
                "n_claimed": s["n_claimed"], "backlog": s["backlog"],
                "shed_backlog": s["shed_backlog"],
                "files_per_hour": s["files_per_hour"],
                "eta_s": s["eta_s"],
                "drained": bool(s["n_files"]
                                and s["n_done"] >= s["n_files"]),
                "n_decisions": self.n_decisions,
                "last_decision": self.last_decision}
        tmp = os.path.join(self.state_dir,
                           f".{SUPERVISOR_FILE}.{os.getpid()}.tmp")
        try:
            os.makedirs(self.state_dir, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(snap, f)
            durable_replace(tmp, os.path.join(self.state_dir,
                                              SUPERVISOR_FILE))
        except OSError as exc:
            logger.warning("supervisor snapshot write failed (%s: %s)",
                           type(exc).__name__, exc)
        return snap

    def run(self, max_s: float = 0.0) -> dict:
        """Poll until the campaign drains (manifest known and every
        unit done, no live children) or ``max_s`` elapses (0 = no
        limit); returns the final snapshot."""
        t0 = self.clock()
        snap = self.step()
        while True:
            children = (self.manager.live_ranks()
                        if self.manager is not None else [])
            if snap["drained"] and not children:
                return snap
            if max_s and self.clock() - t0 >= max_s:
                logger.warning("supervisor: max_s=%.0f reached with "
                               "backlog %d", max_s, snap["backlog"])
                return snap
            self.sleep(self.cfg.poll_s)
            snap = self.step()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="campaign supervisor: autoscale elastic reducer "
                    "ranks over a lease-queue state directory")
    ap.add_argument("state_dir", help="the campaign's state directory "
                                      "(queue.json / heartbeats / "
                                      "leases)")
    ap.add_argument("--spawn-cmd", default="",
                    help="command template for one rank; '{rank}' is "
                         "substituted (omit to observe without "
                         "acting)")
    ap.add_argument("--min-ranks", type=int, default=1)
    ap.add_argument("--max-ranks", type=int, default=8)
    ap.add_argument("--target-files-per-hour", type=float, default=0.0)
    ap.add_argument("--cooldown-s", type=float, default=30.0)
    ap.add_argument("--poll-s", type=float, default=1.0)
    ap.add_argument("--lease-ttl-s", type=float, default=60.0,
                    help="the campaign's [resilience] lease_ttl_s "
                         "(liveness TTL derives 2x this unless "
                         "--liveness-ttl-s is set)")
    ap.add_argument("--liveness-ttl-s", type=float, default=0.0)
    ap.add_argument("--max-s", type=float, default=0.0,
                    help="stop after this many seconds (0 = until "
                         "the queue drains)")
    ap.add_argument("--json", action="store_true",
                    help="print the final snapshot as JSON")
    args = ap.parse_args(argv)

    cfg = ControlConfig(
        autoscale=True, min_ranks=args.min_ranks,
        max_ranks=args.max_ranks,
        target_files_per_hour=args.target_files_per_hour,
        cooldown_s=args.cooldown_s, poll_s=args.poll_s,
        liveness_ttl_s=args.liveness_ttl_s)
    manager = None
    if args.spawn_cmd:
        template = args.spawn_cmd

        def argv_for_rank(rank: int, _t=template) -> list:
            return [a.replace("{rank}", str(rank))
                    for a in shlex.split(_t)]

        manager = RankManager(argv_for_rank,
                              log_dir=os.path.join(args.state_dir,
                                                   "supervisor_logs"))
    sup = Supervisor(args.state_dir, cfg, manager=manager,
                     lease_ttl_s=args.lease_ttl_s)
    try:
        snap = sup.run(max_s=args.max_s)
    finally:
        if manager is not None:
            manager.terminate_all()
    if args.json:
        print(json.dumps(snap))
    else:
        print(f"supervisor: drained={snap['drained']} "
              f"done={snap['n_done']}/{snap['n_files']} "
              f"live={snap['live_ranks']} decisions="
              f"{snap['n_decisions']}")
    return 0 if snap["drained"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
