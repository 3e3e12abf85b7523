"""The joint field route's spans and counters in the program's capture
(:func:`benchmark.spans.probe`: one capture for every reader that asks).

The trees read here are those whose root is a finished ``joint`` span
(``cli.run_destriper.solve_bands_joint``), one a solve of the window:
``joint`` -> ``joint.check``, ``joint.upload`` (counter ``h2d_bytes``),
``plan.digest``, ``destripe.setup``, ``destripe.cg`` (``cg.iter``,
``cg.check``), ``destripe.maps``, ``joint.expand``. A program without
these spans, or without the capture, gives no tree, and every reader
returns None.
"""

from __future__ import annotations

from benchmark.spans import host_s

#: the root span of one joint solve
JOINT = "joint"
#: the host's own stages of a solve, which the card waits on
HOST_PREP = ("joint.check", "plan.digest", "joint.expand")


def _roots(cap) -> list:
    if cap is None:
        return []
    return [s["id"] for s in cap.spans
            if s["name"] == JOINT and s["parent"] == 0
            and s["t1"] is not None]


def trees(cap) -> list:
    """The finished spans of each ``joint`` tree, one list a solve, in
    the order the solves ran."""
    out = {r: [] for r in _roots(cap)}
    if out:
        for s in cap.spans:
            if s["root"] in out and s["t1"] is not None:
                out[s["root"]].append(s)
    return list(out.values())


def seconds_a_solve(cap, names) -> float | None:
    """Mean over the solves of the summed host seconds of the spans
    called any of ``names`` (None without a solve)."""
    ts = trees(cap)
    if not ts:
        return None
    return sum(host_s(s) for t in ts for s in t
               if s["name"] in names) / len(ts)


def spans_named(cap, name: str) -> list:
    """The finished spans called ``name`` in the solves' trees."""
    return [s for t in trees(cap) for s in t if s["name"] == name]


def counter_total(cap, name: str):
    """The summed values of the ``name`` counter events in the solves'
    trees."""
    roots = set(_roots(cap))
    if not roots:
        return 0
    return sum(c["value"] for c in cap.counters
               if c["name"] == name and c["root"] in roots)
