"""The autoscale policy: sensors in, spawn/retire decisions out.

Pure decision logic — no filesystem, no subprocesses — so every rule
is unit-testable with plain numbers and the supervisor stays a thin
sense→decide→act shell. Rules, in priority order:

1. **Replace the dead.** A rank judged dead (the CHANGE-based
   :class:`~comapreduce_tpu_torch.resilience.heartbeat.HeartbeatWatch`
   rule) while work remains gets a replacement immediately — a crash
   never waits out the cooldown (the queue's lease TTL already spent
   the detection latency).
2. **Fill to the floor.** Fewer live ranks than ``min_ranks`` while
   work remains spawns up to the floor, also cooldown-exempt.
3. **Scale up under pressure.** Backlog above ``2 x live`` ranks, or
   a measured commit rate below ``target_files_per_hour`` with
   backlog remaining, adds ONE rank per cooldown window — the
   hysteresis that keeps one slow rank from causing spawn thrashing.
4. **Retire the idle.** No backlog and more live ranks than the floor
   yields a ``retire`` decision; elastic ranks drain and exit on
   their own when the queue empties, so retirement is advisory
   bookkeeping (the reap), never a kill — a rank mid-solve finishes.

Every rule is capped at ``max_ranks`` live children.
"""

from __future__ import annotations

import time
from typing import NamedTuple

from comapreduce_tpu_torch.control.config import ControlConfig

__all__ = ["AutoscalePolicy", "ScaleDecision"]


class ScaleDecision(NamedTuple):
    """One policy verdict: ``action`` is ``spawn`` / ``retire``,
    ``ranks`` the rank ids it applies to, ``reason`` the audit
    line."""

    action: str
    ranks: tuple
    reason: str


class AutoscalePolicy:
    """See the module docstring for the rule set."""

    def __init__(self, config: ControlConfig, clock=time.monotonic):
        self.cfg = ControlConfig.coerce(config)
        self.clock = clock
        self._last_scale_up: float | None = None
        self._retired = False

    def _next_ranks(self, live, dead, reserved, n: int) -> tuple:
        """``n`` fresh rank ids past everything ever seen — a
        replacement never reuses a dead rank's id, so its stale
        heartbeat/lease files cannot masquerade as the newcomer's."""
        used = {int(r) for r in live} | {int(r) for r in dead} \
            | {int(r) for r in reserved}
        start = max(used, default=-1) + 1
        return tuple(range(start, start + n))

    def decide(self, *, backlog: int, live_ranks, dead_ranks=(),
               reserved_ranks=(),
               files_per_hour: float | None = None
               ) -> ScaleDecision | None:
        """One sense cycle in, at most one decision out.

        ``backlog`` counts units not yet done anywhere; ``live_ranks``
        / ``dead_ranks`` are the HeartbeatWatch verdicts (dead ranks
        already replaced must be filtered by the caller);
        ``reserved_ranks`` are ids ever used by ANY rank, live or not
        — fresh spawns allocate past them; ``files_per_hour`` is the
        measured commit rate (None = not yet measurable)."""
        cfg = self.cfg
        live = sorted(int(r) for r in live_ranks)
        dead = sorted(int(r) for r in dead_ranks)
        reserved = set(reserved_ranks)
        now = self.clock()
        room = cfg.max_ranks - len(live)

        if backlog > 0 and dead and room > 0:
            n = min(len(dead), room)
            ranks = self._next_ranks(live, dead, reserved, n)
            self._retired = False
            return ScaleDecision(
                "spawn", ranks,
                f"rank(s) {dead} dead (heartbeat unchanged past the "
                f"liveness TTL) with {backlog} unit(s) outstanding; "
                f"spawning {n} replacement(s)")

        if backlog > 0 and len(live) < cfg.min_ranks:
            n = min(cfg.min_ranks - len(live), room)
            if n > 0:
                ranks = self._next_ranks(live, dead, reserved, n)
                self._retired = False
                return ScaleDecision(
                    "spawn", ranks,
                    f"{len(live)} live rank(s) below min_ranks="
                    f"{cfg.min_ranks} with {backlog} unit(s) "
                    f"outstanding")

        if backlog > 0 and room > 0:
            slow = (cfg.target_files_per_hour > 0
                    and files_per_hour is not None
                    and files_per_hour < cfg.target_files_per_hour)
            deep = backlog > 2 * max(len(live), 1)
            cooled = (self._last_scale_up is None
                      or now - self._last_scale_up >= cfg.cooldown_s)
            if (slow or deep) and cooled:
                self._last_scale_up = now
                ranks = self._next_ranks(live, dead, reserved, 1)
                self._retired = False
                why = (f"measured {files_per_hour:.1f} files/h below "
                       f"target {cfg.target_files_per_hour:g}" if slow
                       else f"backlog {backlog} > 2 x {len(live)} "
                            f"live rank(s)")
                return ScaleDecision("spawn", ranks,
                                     why + "; adding one rank")

        if backlog == 0 and len(live) > cfg.min_ranks \
                and not self._retired:
            # advisory: elastic ranks drain and exit on their own —
            # emitted once per idle episode so the ledger shows WHEN
            # the fleet went idle, without a retire line per poll
            self._retired = True
            extra = tuple(live[cfg.min_ranks:])
            return ScaleDecision(
                "retire", extra,
                f"queue drained with {len(live)} live rank(s) above "
                f"min_ranks={cfg.min_ranks}; idle ranks drain and "
                f"exit on their own")
        if backlog > 0:
            self._retired = False
        return None

    def note_spawned(self) -> None:
        """Record an out-of-band spawn (replacement / fill-to-floor)
        so rule 3's cooldown also spaces off it."""
        self._last_scale_up = self.clock()
