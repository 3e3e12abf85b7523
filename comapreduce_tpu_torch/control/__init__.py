"""The closed-loop control plane: sensors to actions (port of
``comapreduce_tpu/control/``).

- :mod:`~comapreduce_tpu_torch.control.supervisor` /
  :mod:`~comapreduce_tpu_torch.control.autoscaler` — the campaign
  supervisor: watches queue depth, rank liveness and measured
  throughput, and decides when to spawn replacement or additional
  elastic ranks (:mod:`~comapreduce_tpu_torch.control.manager` forks and
  reaps them) and when to retire idle ones; its published snapshot
  (``supervisor.json``) is what the campaign status report reads.
- :mod:`~comapreduce_tpu_torch.control.admission` — SLO-pressure
  admission control: sheds quality-flagged files while the queue
  backlog sits above the high-water mark, every shed ledgered
  ``deferred`` and re-admitted when pressure clears.
- :mod:`~comapreduce_tpu_torch.control.policy` — the solver policy
  engine: picks the preconditioner rung from the solver traces and the
  run registry.
- :mod:`~comapreduce_tpu_torch.control.decisions` — the decision
  ledger (``decisions.{writer}.jsonl``) and its ``control.decision``
  counter; :mod:`~comapreduce_tpu_torch.control.drill` — the control
  drill.

All three loops are OFF by default: ``[control]`` absent is
byte-for-byte the uncontrolled pipeline. Every loop is host work.
"""

from comapreduce_tpu_torch.control.config import ControlConfig
from comapreduce_tpu_torch.control.decisions import (DECISION_SCHEMA,
                                                     decisions_paths,
                                                     read_decisions,
                                                     record_decision)

__all__ = ["ControlConfig", "DECISION_SCHEMA", "decisions_paths",
           "read_decisions", "record_decision"]
