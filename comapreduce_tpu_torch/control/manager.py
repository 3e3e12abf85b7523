"""The process-manager backend: actually fork reducer ranks, reap them.

The lease queue makes rank join/leave free (a fresh rank just starts
claiming; a dead rank's leases expire and get stolen), so this layer
is deliberately dumb: spawn a child process for a rank id, poll for
exits, terminate on shutdown. All POLICY — when to spawn, which rank
ids, how many — lives in :mod:`~comapreduce_tpu_torch.control.autoscaler`;
all protocol — how a rank proves liveness, how work moves — lives in
``resilience/``. Keeping the manager mechanism-only is what lets the
control drill swap in a tiny worker entrypoint while production
supervises full ``run_destriper``/``loadgen`` ranks with the same
supervisor.
"""

from __future__ import annotations

import logging
import os
import subprocess
import time

__all__ = ["RankManager"]

logger = logging.getLogger("comapreduce_tpu_torch")


class RankManager:
    """Spawn/reap child processes, one per elastic rank.

    ``argv_for_rank(rank) -> list[str]`` builds the child's command
    line — the supervisor's only coupling to WHAT a rank runs.
    ``log_dir`` (optional) captures each child's stdout+stderr in
    ``rank{r}.out``; without it output is discarded (children keep
    their own per-rank logfiles regardless).
    """

    def __init__(self, argv_for_rank, env: dict | None = None,
                 cwd: str | None = None, log_dir: str = ""):
        self.argv_for_rank = argv_for_rank
        self.env = dict(env) if env is not None else None
        self.cwd = cwd
        self.log_dir = log_dir
        self._procs: dict[int, subprocess.Popen] = {}
        self._logs: dict[int, object] = {}
        # (rank, returncode) history of every reaped child
        self.exited: list = []

    def spawn(self, rank: int) -> int:
        """Fork a child for ``rank``; returns its pid. A rank id with
        a live child is a no-op (its pid is returned) — the supervisor
        never races itself into double-spawning one rank."""
        rank = int(rank)
        proc = self._procs.get(rank)
        if proc is not None and proc.poll() is None:
            return proc.pid
        out = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(self.log_dir, f"rank{rank}.out"),
                       "ab")
            self._logs[rank] = out
        argv = list(self.argv_for_rank(rank))
        proc = subprocess.Popen(argv, stdout=out,
                                stderr=subprocess.STDOUT,
                                env=self.env, cwd=self.cwd)
        self._procs[rank] = proc
        logger.info("rank manager: spawned rank %d (pid %d): %s",
                    rank, proc.pid, " ".join(argv))
        return proc.pid

    def reap(self) -> list:
        """Collect finished children; returns ``[(rank, returncode)]``
        for the ones that exited since the last call."""
        done = []
        for rank, proc in list(self._procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            done.append((rank, rc))
            self.exited.append((rank, rc))
            self._procs.pop(rank, None)
            log = self._logs.pop(rank, None)
            if log is not None:
                try:
                    log.close()
                except OSError:
                    pass
            logger.info("rank manager: rank %d exited rc=%d", rank, rc)
        return done

    def live_ranks(self) -> list:
        """Ranks with a currently-running child, sorted."""
        return sorted(r for r, p in self._procs.items()
                      if p.poll() is None)

    def all_ranks(self) -> list:
        """Every rank id this manager has ever spawned, live or
        exited — the id-allocation floor for fresh spawns."""
        return sorted(set(self._procs)
                      | {r for r, _ in self.exited})

    def terminate_all(self, timeout_s: float = 5.0) -> None:
        """SIGTERM every live child, SIGKILL stragglers past the
        grace period, close log handles — the shutdown path."""
        for proc in self._procs.values():
            if proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + max(timeout_s, 0.0)
        for proc in self._procs.values():
            left = deadline - time.monotonic()
            try:
                proc.wait(timeout=max(left, 0.05))
            except subprocess.TimeoutExpired:
                try:
                    proc.kill()
                    proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        self.reap()
        for log in self._logs.values():
            try:
                log.close()
            except OSError:
                pass
        self._logs.clear()
