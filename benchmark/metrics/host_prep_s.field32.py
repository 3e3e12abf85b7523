"""The host's own stages of a solve, which the card waits on: the summed
host wall of ``joint.check`` (the pointing compared), ``plan.digest``
(the plan memo's SHA-1 of the pixels) and ``joint.expand`` (the maps
expanded on the host), mean over the window's solves."""

from benchmark import joint_spans, spans


def probe():
    return spans.probe()


def read(ctx):
    return joint_spans.seconds_a_solve(
        ctx.probes.get("host_prep_s.field32"), joint_spans.HOST_PREP)
