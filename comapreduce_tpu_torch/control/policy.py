"""The solver policy engine: evidence-driven solver knobs (port of
``comapreduce_tpu/control/policy.py``).

Static config picks ``[Destriper] preconditioner`` / ``mg_block`` /
``pair_batch`` once, for every shape the campaign will ever see. This
loop picks them from evidence instead:

- the run's own **solver traces** (``solver.rank*.jsonl``, the same
  records ``cli.solver_report`` renders): per-preconditioner-rung
  iteration counts and convergence/stall/divergence verdicts;
- the **run registry delta** (what ``solver_report --registry``
  prints): this run's mean iterations against the trailing-window
  median of the ``*cg_iters*`` registry metrics — a rung suddenly
  needing ``ESCALATE_RATIO`` times its historical iterations gets
  escalated one rung up the ladder before it shows up in wall clocks;
- the **program cost model** (``programs.jsonl``,
  :mod:`~comapreduce_tpu_torch.telemetry.programs`): a program whose
  measured temporaries pass ``PAIR_TEMP_BUDGET`` halves a
  ``pair_batch`` above 1 (the port's records are measured on eager
  calls, the reference's read from XLA's buffer assignment);
- the **[tuning] winners** (:data:`~comapreduce_tpu_torch.tuning.
  TUNING`): a multigrid escalation with no ``mg_block`` configured takes
  the cached ``solver`` winner for this offset length, else the
  documented default of 8.

Every override is recorded as an auditable ``control.decision`` event
(loop ``solver``, action ``override``, carrying the knob, old and new
values, and the evidence in the reason). No evidence → no overrides:
the static config stands, byte-for-byte.
"""

from __future__ import annotations

import logging

from comapreduce_tpu_torch.control.decisions import record_decision

__all__ = ["ESCALATE_RATIO", "PAIR_TEMP_BUDGET", "RUNG_ORDER",
           "choose_solver", "rung_health"]

logger = logging.getLogger("comapreduce_tpu_torch")

#: the preconditioner ladder, weakest to strongest — mirrors
#: mapmaking.destriper.CONFIG_PRECONDITIONERS (asserted in tests so
#: the two homes cannot drift)
RUNG_ORDER = ("none", "jacobi", "twolevel", "multigrid")

#: registry-delta ratio at which a rung is escalated one step
ESCALATE_RATIO = 1.5

#: a program's temporaries above which pair_batch is halved: the
#: reference's 2 GiB, not measured anew on the card
PAIR_TEMP_BUDGET = 2 << 30

def rung_health(records: list, bucket: str = "") -> dict:
    """Fold solver-trace records into per-preconditioner-rung health:
    ``{rung: {"solves", "iters", "converged", "stalled", "diverged"}}``
    — the same rung key ``cli.solver_report`` aggregates by (the
    first ``|`` segment of ``precond_id``).

    ``bucket`` restricts the fold to solves whose stamped shape-bucket
    id starts with the given prefix (per-shape-bucket rungs —
    ``"L=50"`` matches every ``"L=50|N=..."`` stamp). Records without
    a stamp only count under the unrestricted fold, so evidence from
    one geometry never argues a rung for another."""
    out: dict = {}
    for rec in records:
        if rec.get("kind") != "solve":
            continue
        if bucket and not str(rec.get("bucket") or "").startswith(
                str(bucket)):
            continue
        rung = str(rec.get("precond_id") or "").split("|")[0]
        if not rung:
            continue
        agg = out.setdefault(rung, {"solves": 0, "iters": 0,
                                    "converged": 0, "stalled": 0,
                                    "diverged": 0})
        agg["solves"] += 1
        agg["iters"] += int(rec.get("n_iter") or 0)
        agg["converged"] += int(bool(rec.get("converged")))
        agg["stalled"] += int(bool(rec.get("stalled")))
        agg["diverged"] += int(bool(rec.get("diverged")))
    return out


def _registry_worst_ratio(records: list, registry_path: str,
                          window: int) -> float | None:
    """max over ``*cg_iters*`` registry metrics of (this run's mean
    solve iterations) / (trailing-window median) — the
    ``solver_report --registry`` delta, as one number."""
    from comapreduce_tpu_torch.telemetry.registry import read_runs

    solves = [r for r in records if r.get("kind") == "solve"]
    if not solves:
        return None
    cur = sum(int(r.get("n_iter") or 0) for r in solves) / len(solves)
    hist: dict = {}
    for run in read_runs(registry_path)[-window:]:
        for k, v in (run.get("metrics") or {}).items():
            if "cg_iters" in k and isinstance(v, (int, float)):
                hist.setdefault(k, []).append(float(v))
    worst = None
    for vals in hist.values():
        vals = sorted(vals)
        med = vals[len(vals) // 2]
        if med:
            ratio = cur / med
            worst = ratio if worst is None else max(worst, ratio)
    return worst


def _escalate(rung: str) -> str | None:
    try:
        i = RUNG_ORDER.index(rung)
    except ValueError:
        return None
    return RUNG_ORDER[i + 1] if i + 1 < len(RUNG_ORDER) else None


def choose_solver(state_dir: str, static: dict | None = None,
                  registry_path: str = "", window: int = 5,
                  record: bool = True, bucket: str = "") -> dict:
    """Evidence-driven overrides for the destriper's solver knobs.

    ``static`` carries the configured values (``preconditioner``,
    ``mg_block``, ``pair_batch``) the decisions are measured against.
    Returns only the knobs the evidence argues to CHANGE, plus a
    ``reasons`` list; an empty dict (modulo ``reasons``) means the
    static config stands. ``record=False`` suppresses the decision
    ledger (dry-run / report use).

    ``bucket`` restricts the rung-health evidence to solves
    stamped with that shape-bucket prefix — one rung PER BUCKET instead
    of one per run, so a calibrator geometry's easy converges can never
    argue the survey geometry down a rung. When no stamped record
    matches the bucket, the fold falls back to all records (the
    pre-bucket behaviour — old traces stay actionable). Escalations
    into multigrid take the documented default ``mg_block`` of 8 (the
    ``[tuning]`` winners the reference consults are not ported)."""
    static = dict(static or {})
    out: dict = {"reasons": []}

    def decide(knob: str, old, new, reason: str) -> None:
        out[knob] = new
        out["reasons"].append(f"{knob}: {old!r} -> {new!r} ({reason})")
        if record:
            record_decision(state_dir, "solver", "override", reason,
                            writer="solver", knob=knob, old=old,
                            new=new)

    try:
        from comapreduce_tpu_torch.telemetry.solver_trace import read_solver

        records = read_solver(state_dir)
    except Exception:
        logger.exception("solver policy: trace read failed; static "
                         "config stands")
        return out
    if not records:
        return out
    rungs = rung_health(records, bucket=bucket)
    if bucket and not rungs:
        # no stamped evidence for THIS bucket yet: fall back to the
        # whole-run fold rather than flying blind
        rungs = rung_health(records)

    # 1. pick the cheapest HEALTHY rung: converged solves, no stall or
    # divergence on the rung, fewest iterations per solve
    healthy = {r: a for r, a in rungs.items()
               if a["solves"] > 0 and a["converged"] > 0
               and not a["stalled"] and not a["diverged"]}

    def cost(agg) -> float:
        return agg["iters"] / max(agg["solves"], 1)

    chosen = min(healthy, key=lambda r: cost(healthy[r])) \
        if healthy else None
    current = str(static.get("preconditioner") or "")
    if chosen and current and chosen != current \
            and chosen in RUNG_ORDER:
        cur_agg = rungs.get(current)
        sick = bool(cur_agg and (cur_agg["stalled"]
                                 or cur_agg["diverged"]))
        better = (cur_agg is None or not cur_agg["converged"]
                  or cost(healthy[chosen]) < cost(cur_agg))
        if sick or better:
            why = (f"rung '{chosen}' converged at "
                   f"{cost(healthy[chosen]):.1f} iters/solve vs "
                   f"'{current}' at "
                   + (f"{cost(cur_agg):.1f}"
                      if cur_agg and cur_agg["solves"]
                      else "no evidence")
                   + ("; and the configured rung stalled/diverged"
                      if sick else ""))
            decide("preconditioner", current, chosen, why)
            current = chosen

    # 2. registry delta: this run suddenly needs ESCALATE_RATIO x the
    # trailing-window iterations -> escalate one rung up the ladder
    if registry_path:
        try:
            worst = _registry_worst_ratio(records, registry_path,
                                          window)
        except Exception:
            logger.exception("solver policy: registry delta failed")
            worst = None
        if worst is not None and worst >= ESCALATE_RATIO:
            base = str(out.get("preconditioner", current))
            up = _escalate(base)
            if up is not None:
                decide("preconditioner", base, up,
                       f"iteration count at {worst:.2f}x the "
                       f"trailing-{window}-run registry median "
                       f"(escalation threshold {ESCALATE_RATIO:g})")

    # 3. program cost model: a shape bucket whose temporaries blow the
    # budget halves pair_batch for the next solves
    pair_batch = static.get("pair_batch")
    if pair_batch and int(pair_batch) > 1:
        try:
            from comapreduce_tpu_torch.telemetry.programs import \
                read_programs

            progs = read_programs(state_dir)
        except Exception:
            progs = []
        worst_rec = None
        for rec in progs:
            temp = rec.get("temp_bytes") or 0
            if temp > PAIR_TEMP_BUDGET and \
                    (worst_rec is None
                     or temp > (worst_rec.get("temp_bytes") or 0)):
                worst_rec = rec
        if worst_rec is not None:
            decide("pair_batch", int(pair_batch),
                   max(int(pair_batch) // 2, 1),
                   f"program {worst_rec.get('name')!r} bucket "
                   f"{worst_rec.get('shape_bucket')!r} assigns "
                   f"{worst_rec.get('temp_bytes')} temp bytes, over "
                   f"the {PAIR_TEMP_BUDGET} budget")

    # 4. mg_block: escalating INTO multigrid with no block configured
    # gets the measured [tuning] winner for this bucket when the cache
    # holds one, else the documented default so the ladder builds
    if out.get("preconditioner") == "multigrid" \
            and not static.get("mg_block"):
        block, source = 8, "the documented default block of 8"
        try:
            from comapreduce_tpu_torch.tuning.cache import TUNING
            from comapreduce_tpu_torch.tuning.space import solver_bucket

            if TUNING.enabled:
                win = TUNING.winner(
                    "solver",
                    solver_bucket(int(static.get("offset_length")
                                      or 0)))
                if win and win.get("mg_block"):
                    block = int(win["mg_block"])
                    source = (f"the measured [tuning] winner "
                              f"(mg_block={block})")
        except Exception:
            logger.exception("solver policy: tuning cache consult "
                             "failed; using the default block")
        decide("mg_block", static.get("mg_block"), block,
               "multigrid selected with no mg_block configured; "
               f"using {source}")
    return out
