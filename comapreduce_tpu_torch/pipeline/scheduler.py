"""Elastic campaign scheduler: a filesystem work queue over lease files
(a copy of ``comapreduce_tpu/pipeline/scheduler.py``; the lease, manifest
and ledger files are the reference's, and each package reads the
other's).

Replaces the static ``files[rank::n_ranks]`` shard with dynamic
claiming: every rank runs the same two-phase loop over the SAME full
filelist, and the lease board (``resilience/lease.py``) arbitrates who
reduces what.

- **Phase 1 (claim pass)** walks the filelist in this rank's shard
  order first (``rank::n_ranks`` rotation — ranks start spread out
  instead of stampeding the same file) and claims every unit whose
  lease name is free. A rank that joins mid-campaign simply starts
  here: whatever is unclaimed is its to take — there is no membership
  list to update.
- **Phase 2 (steal loop)** polls the leftovers: units finished by
  other ranks drop out as ``done``; units whose owner's heartbeat went
  stale past ``lease_ttl_s`` are STOLEN (generation bumped) and
  re-reduced here. A rank that left — crashed, preempted, or paused
  zombie — needs no goodbye: its leases expire and the survivors
  drain them.

The caller must :meth:`commit` each yielded file after reducing it;
commit goes through the board's generation fence, so a zombie's late
commit of a stolen-and-redone unit returns False (counted in
``stats["fence_rejects"]``) and its output must be discarded. Steals
and stolen-unit recoveries are ledgered (``stolen`` / ``recovered``
dispositions) so the operator report can show exactly which units
moved ranks.

No services, no sockets: every rank only ever touches files in one
state directory, with the same durability discipline as
``data/durable.py``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterator

from comapreduce_tpu_torch.data.durable import durable_replace
from comapreduce_tpu_torch.resilience.integrity import check_json, seal_json
from comapreduce_tpu_torch.resilience.lease import Lease, LeaseBoard
from comapreduce_tpu_torch.telemetry.core import TELEMETRY

__all__ = ["Scheduler", "QUEUE_MANIFEST", "extend_manifest",
           "read_manifest"]

logger = logging.getLogger("comapreduce_tpu_torch")

QUEUE_MANIFEST = "queue.json"


def read_manifest(state_dir: str) -> dict | None:
    """Parse the shared queue manifest; None when missing/torn — or
    when the manifest parses but fails its embedded ``_sha256`` seal
    (rotted in place: a wrong file census silently shrinking the
    campaign is the failure mode this rejects)."""
    try:
        with open(os.path.join(state_dir or ".", QUEUE_MANIFEST), "r",
                  encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict):
        return None
    man, verdict = check_json(man)
    if verdict is False:
        logger.warning("queue manifest in %s fails its _sha256 seal; "
                       "ignoring it (run python -m "
                       "comapreduce_tpu_torch.cli.campaign_fsck)",
                       state_dir)
        return None
    return man


def extend_manifest(state_dir: str, new_files) -> list:
    """Append late-arriving units to the shared ``queue.json`` — a
    chaos ``load_spike``, or an operator dropping a fresh observing
    session into a live campaign. Returns the full paths actually
    added (units already queued, by basename, are skipped).

    The manifest keeps listing basenames in ``files`` (what the
    operator report counts); full paths for the additions ride in
    ``added_paths`` so sibling ranks re-polling the manifest
    (``Scheduler`` steal loop) can claim units their own filelist
    never mentioned. Durable replace, same discipline as the first
    write — the burst either landed whole or not at all."""
    man = read_manifest(state_dir) or {"schema": 1, "files": []}
    have = set(man.get("files", []))
    added = [f for f in new_files if os.path.basename(f) not in have]
    if not added:
        return []
    man["files"] = list(man.get("files", [])) + \
        [os.path.basename(f) for f in added]
    man["n"] = len(man["files"])
    paths = dict(man.get("added_paths", {}))
    paths.update({os.path.basename(f): f for f in added})
    man["added_paths"] = paths
    man["t_wall"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    os.makedirs(state_dir or ".", exist_ok=True)
    tmp = os.path.join(state_dir or ".",
                       f".{QUEUE_MANIFEST}.{os.getpid()}.ext.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(seal_json(man), f)
    durable_replace(tmp, os.path.join(state_dir or ".", QUEUE_MANIFEST))
    logger.warning("queue manifest %s: %d late unit(s) appended "
                   "(%d total)", state_dir, len(added), man["n"])
    return added


class Scheduler:
    """Per-rank view of one campaign's work queue.

    Parameters mirror the knobs in ``[resilience]``: ``lease_ttl_s``
    is the owner-heartbeat age beyond which a lease is stealable and
    ``steal_after_s`` the minimum lease-file age (0 = the TTL).
    ``ledger``/``chaos``/``heartbeat`` are the rank's
    :class:`~comapreduce_tpu_torch.resilience.config.Resilience` members —
    the chaos hooks (``rank_kill`` / ``rank_pause``) fire at claim
    time, which is exactly where a preemption or a zombie hurts most.

    ``admission`` is the optional control-plane gate (duck-typed as the
    reference's ``control.admission.AdmissionController``; the port's
    runner passes None, ``[control]`` not being ported):
    consulted on every just-claimed unit, it may answer with a defer
    reason, in which case the claim is released, the unit is ledgered
    ``deferred``, and it re-enters the queue when pressure clears —
    shed, never dropped. ``None`` (the default) admits everything,
    byte-for-byte the pre-control behavior.
    """

    def __init__(self, filelist, state_dir: str, rank: int = 0,
                 n_ranks: int = 1, heartbeat_dir: str | None = None,
                 lease_ttl_s: float = 60.0, steal_after_s: float = 0.0,
                 poll_s: float = 0.25, stall_timeout_s: float = 0.0,
                 ledger=None, chaos=None, heartbeat=None,
                 admission=None, clock=time.monotonic,
                 sleep=time.sleep):
        self.files = list(filelist)
        self.state_dir = state_dir or "."
        self.rank = int(rank)
        self.n_ranks = max(int(n_ranks), 1)
        self.board = LeaseBoard(self.state_dir, rank=self.rank,
                                heartbeat_dir=heartbeat_dir,
                                lease_ttl_s=lease_ttl_s,
                                steal_after_s=steal_after_s)
        self.poll_s = float(poll_s)
        # no unit going done/stolen for this long means the queue is
        # wedged (e.g. a survivor-less campaign): bail out instead of
        # spinning forever — generous default of several TTLs
        self.stall_timeout_s = (float(stall_timeout_s)
                                or 4.0 * self.board.lease_ttl_s + 30.0)
        self.ledger = ledger
        self.chaos = chaos
        self.heartbeat = heartbeat
        self.admission = admission
        self.clock = clock
        self.sleep = sleep
        self._held: dict[str, Lease] = {}
        self._deferred: list[str] = []
        self._outstanding: set[str] = set(self.files)
        self.stats = {"claimed": 0, "stolen": 0, "committed": 0,
                      "recovered": 0, "fence_rejects": 0,
                      "done_elsewhere": 0, "abandoned": 0,
                      "deferred": 0, "readmitted": 0, "spiked": 0}
        self._write_manifest()

    def _bump(self, key: str, n: int = 1) -> None:
        """Stats bump mirrored into the telemetry counter stream —
        claim/steal/fence-reject rates become cross-rank counter
        tracks in campaign_report's merged timeline."""
        self.stats[key] += n
        TELEMETRY.counter("scheduler." + key, n)

    # -- the queue ----------------------------------------------------------
    def claim_iter(self) -> Iterator[str]:
        """Yield every file this rank gets to reduce; returns when the
        whole campaign's queue has drained (every unit done somewhere,
        or abandoned after ``stall_timeout_s`` of no progress)."""
        order = (self.files[self.rank % self.n_ranks::self.n_ranks]
                 + [f for r in range(self.n_ranks)
                    if r != self.rank % self.n_ranks
                    for f in self.files[r::self.n_ranks]])
        pending = []  # held by other ranks: revisit in the steal loop
        for f in order:
            if self.board.is_done(f):
                self._bump("done_elsewhere")
                self._outstanding.discard(f)
                continue
            lease = self.board.claim(f)
            if lease is None:
                pending.append(f)
                continue
            if self._shed(f, lease):
                continue
            yield self._grant(f, lease)
        # steal loop: wait out the other ranks' units
        pending.extend(self._poll_manifest())
        last_progress = self.clock()
        while pending or self._deferred:
            still = []
            progressed = False
            for f in pending:
                if self.board.is_done(f):
                    self._bump("done_elsewhere")
                    self._outstanding.discard(f)
                    progressed = True
                    continue
                lease = self.board.claim(f)  # released or fence-gap
                if lease is None and self.board.expired(f):
                    lease = self.board.steal(f)
                    if lease is not None:
                        self._bump("stolen")
                        self._ledger_steal(f, lease)
                if lease is None:
                    still.append(f)
                    continue
                progressed = True
                if self._shed(f, lease):
                    continue
                yield self._grant(f, lease)
            pending = still
            # late arrivals: a load_spike burst or an operator append
            # lands in the shared manifest mid-campaign
            new = self._poll_manifest()
            if new:
                pending.extend(new)
                progressed = True
            # re-admission pass: shed units return when admission
            # pressure clears, when they finished elsewhere, or when
            # nothing but deferred work remains — a shed unit is
            # never silently dropped
            if self._deferred:
                clear = (self.admission is None or
                         self.admission.pressure_cleared(self.backlog()))
                for f in list(self._deferred):
                    if self.board.is_done(f):
                        self._deferred.remove(f)
                        self._outstanding.discard(f)
                        self._bump("done_elsewhere")
                        progressed = True
                        continue
                    if not clear and pending:
                        continue
                    lease = self.board.claim(f)
                    if lease is None and self.board.expired(f):
                        lease = self.board.steal(f)
                        if lease is not None:
                            self._bump("stolen")
                            self._ledger_steal(f, lease)
                    if lease is None:
                        continue
                    self._deferred.remove(f)
                    self._bump("readmitted")
                    self._ledger_readmitted(f)
                    progressed = True
                    yield self._grant(f, lease)
            if progressed:
                last_progress = self.clock()
            elif self.clock() - last_progress > self.stall_timeout_s:
                self._abandon(pending)
                return
            if pending or self._deferred:
                self.sleep(self.poll_s)

    def backlog(self) -> int:
        """Units this rank still sees as not done anywhere, excluding
        ones it shed (``deferred``) or currently holds — the
        admission-control pressure signal."""
        return max(len(self._outstanding) - len(self._deferred)
                   - len(self._held), 0)

    def commit(self, filename: str) -> bool:
        """Publish ``filename`` done through the generation fence.
        False = the unit was stolen while we worked (we are the
        zombie): the caller MUST discard its result for this unit."""
        lease = self._held.pop(filename, None)
        if lease is None:
            return False
        ok = self.board.commit(lease)
        if ok:
            self._bump("committed")
            self._outstanding.discard(filename)
            if lease.stolen_from is not None:
                self._bump("recovered")
                self._ledger_recovered(filename, lease)
            # wake any map server tailing this campaign (best effort —
            # the done lease is the durable fact, this is only latency)
            try:
                from comapreduce_tpu_torch.serving.watcher import \
                    announce_commit

                announce_commit(self.state_dir, filename)
            except Exception:  # pragma: no cover - advisory only
                pass
            if self.chaos is not None:
                # load_spike: a burst of extra units arrives at commit
                # time — published to the shared manifest so EVERY
                # rank's steal loop (including ours) picks them up
                burst = self.chaos.maybe_spike(filename)
                if burst:
                    added = extend_manifest(self.state_dir, burst)
                    if added:
                        self._bump("spiked", len(added))
        else:
            self._bump("fence_rejects")
        return ok

    def release_held(self) -> int:
        """Give back any claims yielded but never committed (clean
        shutdown mid-queue); returns how many were released."""
        n = 0
        for f, lease in list(self._held.items()):
            if self.board.release(lease):
                n += 1
            self._held.pop(f, None)
        return n

    # -- internals ----------------------------------------------------------
    def _grant(self, filename: str, lease: Lease) -> str:
        self._held[filename] = lease
        self._bump("claimed")
        if self.chaos is not None:
            # rank_kill: SIGKILL self mid-lease (the preempted rank);
            # rank_pause: freeze the heartbeat but keep working (the
            # zombie whose late commit the fence must reject)
            self.chaos.maybe_kill(filename)
            if self.chaos.maybe_pause(filename) and \
                    self.heartbeat is not None:
                self.heartbeat.pause()
        return filename

    def _shed(self, filename: str, lease: Lease) -> bool:
        """Admission-control gate on a just-claimed unit. True = the
        unit was shed: claim released, ledgered ``deferred``, queued
        locally for re-admission when pressure clears."""
        if self.admission is None:
            return False
        reason = self.admission.should_defer(filename, self.backlog())
        if not reason:
            return False
        self.board.release(lease)
        self._deferred.append(filename)
        self._bump("deferred")
        logger.warning("scheduler rank %d: unit %s deferred under "
                       "admission pressure (%s)", self.rank,
                       os.path.basename(filename), reason)
        if self.ledger is not None:
            self.ledger.record(
                filename, error=None, failure_class="quality",
                disposition="deferred", stage="control.admission",
                message=reason)
        return True

    def _poll_manifest(self) -> list:
        """Pick up units appended to the shared manifest after this
        rank built its queue (:func:`extend_manifest` — a load_spike
        burst or an operator append); returns their full paths."""
        man = read_manifest(self.state_dir)
        if man is None:
            return []
        known = {os.path.basename(f) for f in self.files}
        paths = man.get("added_paths", {})
        home = os.path.dirname(self.files[0]) if self.files else ""
        new = []
        for name in man.get("files", []):
            if name in known:
                continue
            new.append(paths.get(name) or
                       (os.path.join(home, name) if home else name))
        if new:
            self.files.extend(new)
            self._outstanding.update(new)
            logger.info("scheduler rank %d: %d late unit(s) joined "
                        "the queue", self.rank, len(new))
        return new

    def _abandon(self, pending) -> None:
        self._bump("abandoned", len(pending))
        for f in pending:
            self._outstanding.discard(f)
        logger.error(
            "scheduler rank %d: queue stalled for %.0f s with %d "
            "unit(s) still leased elsewhere and not expiring — "
            "abandoning them (see the ledger)", self.rank,
            self.stall_timeout_s, len(pending))
        if self.ledger is None:
            return
        for f in pending:
            st = self.board.state(f) or {}
            self.ledger.record(
                f, error=None, failure_class="hang",
                disposition="rejected", stage="scheduler.queue",
                message=f"queue stalled: lease held by rank "
                        f"{st.get('owner')} gen {st.get('generation')} "
                        f"never completed nor expired")

    def _ledger_steal(self, filename: str, lease: Lease) -> None:
        if self.ledger is None:
            return
        self.ledger.record(
            filename, error=None, failure_class="hang",
            disposition="stolen", stage="scheduler.steal",
            message=f"lease stolen from rank {lease.stolen_from} "
                    f"(heartbeat stale past "
                    f"{self.board.lease_ttl_s:g} s); redoing here as "
                    f"gen {lease.generation}")

    def _ledger_readmitted(self, filename: str) -> None:
        if self.ledger is None:
            return
        self.ledger.record(
            filename, error=None, failure_class="quality",
            disposition="readmitted", stage="control.admission",
            message=f"admission pressure cleared; unit re-admitted "
                    f"on rank {self.rank}")

    def _ledger_recovered(self, filename: str, lease: Lease) -> None:
        if self.ledger is None:
            return
        self.ledger.record(
            filename, error=None, failure_class="hang",
            disposition="recovered", stage="scheduler.steal",
            message=f"stolen unit re-reduced and committed by rank "
                    f"{self.rank} at gen {lease.generation}")

    def _write_manifest(self) -> None:
        """Durably publish the campaign's file set once (first rank
        wins; later ranks verify they agree). The manifest is what
        lets ``tools/watchdog_report.py`` count pending units."""
        path = os.path.join(self.state_dir, QUEUE_MANIFEST)
        names = [os.path.basename(f) for f in self.files]
        try:
            with open(path, "r", encoding="utf-8") as f:
                have = json.load(f)
            if sorted(have.get("files", [])) != sorted(names):
                logger.warning(
                    "scheduler rank %d: %s lists %d unit(s) but this "
                    "rank was given %d — ranks should share one "
                    "filelist", self.rank, QUEUE_MANIFEST,
                    len(have.get("files", [])), len(names))
            return
        except (OSError, ValueError):
            pass
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = os.path.join(self.state_dir,
                           f".{QUEUE_MANIFEST}.{os.getpid()}.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(seal_json(
                {"schema": 1, "n": len(names), "files": names,
                 "t_wall": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime())}), f)
        durable_replace(tmp, path)
