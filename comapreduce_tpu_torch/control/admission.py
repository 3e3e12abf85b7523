"""SLO-driven admission control: shed flagged files under pressure.

The manual knob already exists: ``[slo] exclude_flagged`` drops
quality-flagged files from a destriper filelist up front. This loop is
its automatic, reversible form for live campaigns: while the queue
backlog sits above ``shed_high_water``, files whose latest
data-quality record is FLAGGED (``telemetry/quality.py`` SLO rules)
are deferred — claim released, one ``deferred`` line in the
quarantine ledger, one ``defer`` decision event — so the healthy bulk
of the queue drains first. When backlog falls to ``shed_low_water``
(hysteresis against flapping) or nothing but deferred work remains,
the scheduler re-admits every shed unit (``readmitted`` ledger line).
A shed file is therefore delayed, never dropped: the final map sees
every unit exactly once either way, and turning the loop off
reproduces the uncontrolled schedule byte-for-byte.

The controller is consumed by
:class:`~comapreduce_tpu_torch.pipeline.scheduler.Scheduler` through two
duck-typed calls — ``should_defer(filename, backlog)`` on every
just-claimed unit and ``pressure_cleared(backlog)`` before each
re-admission pass — so the scheduler never imports this package.
"""

from __future__ import annotations

import logging
import os
import time

from comapreduce_tpu_torch.control.config import ControlConfig
from comapreduce_tpu_torch.control.decisions import record_decision

__all__ = ["AdmissionController"]

logger = logging.getLogger("comapreduce_tpu_torch")

# re-scan the quality ledger for newly-flagged files at most this
# often: flags arrive at file-completion rate, not claim rate
_FLAGGED_REFRESH_S = 2.0


class AdmissionController:
    """One rank's admission gate (state in memory, evidence on disk).

    ``flagged`` (optional) pins the flagged set for tests; the default
    reads :func:`~comapreduce_tpu_torch.telemetry.quality.flagged_files`
    from the state directory's quality ledgers, refreshed at most
    every couple of seconds.
    """

    def __init__(self, config: ControlConfig, state_dir: str,
                 rank: int = 0, flagged=None, clock=time.monotonic):
        self.cfg = ControlConfig.coerce(config)
        self.state_dir = state_dir or "."
        self.rank = int(rank)
        self.clock = clock
        self._writer = f"rank{self.rank}"
        self._pinned = frozenset(os.path.basename(f) for f in flagged) \
            if flagged is not None else None
        self._flagged: frozenset = self._pinned or frozenset()
        self._flagged_t: float | None = None
        self.shedding = False

    # -- sensors -------------------------------------------------------------
    def flagged_files(self) -> frozenset:
        if self._pinned is not None:
            return self._pinned
        now = self.clock()
        if self._flagged_t is None \
                or now - self._flagged_t >= _FLAGGED_REFRESH_S:
            from comapreduce_tpu_torch.telemetry.quality import flagged_files

            try:
                self._flagged = frozenset(flagged_files(self.state_dir))
            except Exception:  # a torn ledger must not stop admission
                logger.exception("admission: flagged-file scan failed")
            self._flagged_t = now
        return self._flagged

    def _update_pressure(self, backlog: int) -> None:
        cfg = self.cfg
        if not self.shedding and backlog >= cfg.shed_high_water:
            self.shedding = True
            record_decision(
                self.state_dir, "admission", "shed_on",
                f"backlog {backlog} >= shed_high_water="
                f"{cfg.shed_high_water}; deferring flagged files",
                writer=self._writer, rank=self.rank, backlog=backlog)
        elif self.shedding and backlog <= cfg.shed_low_water:
            self.shedding = False
            record_decision(
                self.state_dir, "admission", "shed_off",
                f"backlog {backlog} <= shed_low_water="
                f"{cfg.shed_low_water}; re-admitting deferred files",
                writer=self._writer, rank=self.rank, backlog=backlog)

    # -- the scheduler-facing gate -------------------------------------------
    def should_defer(self, filename: str, backlog: int) -> str | None:
        """Defer reason for a just-claimed unit, or None to admit.
        Only quality-FLAGGED files are ever shed — admission pressure
        never touches healthy data."""
        self._update_pressure(int(backlog))
        if not self.shedding:
            return None
        base = os.path.basename(filename)
        if base not in self.flagged_files():
            return None
        reason = (f"backlog {backlog} above shed water mark and "
                  f"{base} is SLO-flagged; deferred until pressure "
                  f"clears")
        record_decision(self.state_dir, "admission", "defer", reason,
                        writer=self._writer, rank=self.rank,
                        file=base, backlog=int(backlog))
        return reason

    def pressure_cleared(self, backlog: int) -> bool:
        """True when deferred units may re-enter the queue."""
        self._update_pressure(int(backlog))
        return not self.shedding
