"""The ``[control]`` config table (TOML; ``[Control]`` in legacy INI).

One strict-coerce table for all three control loops, following the
``[resilience]`` discipline: a typo'd knob raises at load, every loop
defaults OFF, and ``coerce(None)`` — no table at all — yields the
identity config, byte-for-byte the uncontrolled pipeline.

Autoscaler knobs (docs/OPERATIONS.md §19):

- ``autoscale``              bool, default False — the supervisor loop
- ``min_ranks``              int, default 1 — spawn up to this floor
- ``max_ranks``              int, default 8 — never scale past this
- ``target_files_per_hour``  float, default 0 (off) — scale up while
  the measured commit rate sits below this target and backlog remains
- ``cooldown_s``             float, default 30 — minimum spacing
  between *scale-up* actions (replacing a dead rank and filling to
  ``min_ranks`` bypass the cooldown: a crashed rank must not wait out
  a timer); the anti-thrash hysteresis
- ``poll_s``                 float, default 1.0 — supervisor sense
  period
- ``liveness_ttl_s``         float, default 0 — seconds without a
  heartbeat CHANGE before a rank is judged dead (0 derives
  ``2 x lease_ttl_s`` at runtime)

Admission knobs:

- ``admission``              bool, default False — the shed/defer loop
- ``shed_high_water``        int, default 16 — backlog (not-yet-done,
  non-deferred units) at or above which shedding switches ON
- ``shed_low_water``         int, default 4 — backlog at or below
  which shedding switches OFF (hysteresis band against flapping)

Solver-policy knob:

- ``solver_policy``          bool, default False — pick
  ``preconditioner``/``mg_block``/``pair_batch`` from solver traces,
  registry deltas and the program cost model instead of static config
"""

from __future__ import annotations

__all__ = ["ControlConfig"]


def _bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


class ControlConfig:
    """See the module docstring for knob semantics; ``enabled`` is
    True when ANY loop is on — the cheap gate callers check before
    importing anything heavier."""

    KNOBS = ("autoscale", "min_ranks", "max_ranks",
             "target_files_per_hour", "cooldown_s", "poll_s",
             "liveness_ttl_s", "admission", "shed_high_water",
             "shed_low_water", "solver_policy")

    __slots__ = KNOBS

    def __init__(self, autoscale: bool = False, min_ranks: int = 1,
                 max_ranks: int = 8,
                 target_files_per_hour: float = 0.0,
                 cooldown_s: float = 30.0, poll_s: float = 1.0,
                 liveness_ttl_s: float = 0.0, admission: bool = False,
                 shed_high_water: int = 16, shed_low_water: int = 4,
                 solver_policy: bool = False):
        self.autoscale = _bool(autoscale)
        self.min_ranks = int(min_ranks)
        self.max_ranks = int(max_ranks)
        self.target_files_per_hour = float(target_files_per_hour)
        self.cooldown_s = float(cooldown_s)
        self.poll_s = float(poll_s)
        self.liveness_ttl_s = float(liveness_ttl_s)
        self.admission = _bool(admission)
        self.shed_high_water = int(shed_high_water)
        self.shed_low_water = int(shed_low_water)
        self.solver_policy = _bool(solver_policy)
        if self.min_ranks < 1:
            raise ValueError(
                f"[control] min_ranks must be >= 1, got {self.min_ranks}")
        if self.max_ranks < self.min_ranks:
            raise ValueError(
                f"[control] max_ranks ({self.max_ranks}) must be >= "
                f"min_ranks ({self.min_ranks})")
        if self.shed_low_water > self.shed_high_water:
            raise ValueError(
                f"[control] shed_low_water ({self.shed_low_water}) must "
                f"be <= shed_high_water ({self.shed_high_water})")
        if self.cooldown_s < 0 or self.poll_s <= 0:
            raise ValueError(
                "[control] cooldown_s must be >= 0 and poll_s > 0")

    @property
    def enabled(self) -> bool:
        return self.autoscale or self.admission or self.solver_policy

    @classmethod
    def coerce(cls, value) -> "ControlConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        unknown = set(value) - set(cls.KNOBS)
        if unknown:
            raise ValueError(
                f"unknown [control] option(s) {sorted(unknown)}; "
                f"valid: {list(cls.KNOBS)}")
        return cls(**dict(value))

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={getattr(self, k)}" for k in self.KNOBS)
        return f"ControlConfig({body})"
