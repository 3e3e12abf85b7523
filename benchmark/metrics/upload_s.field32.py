"""Mean host wall of ``joint.upload`` a solve: the ``(nb, n)`` TOD and
weight stacks built on the card from the host's Level-2 arrays
(pageable copies)."""

from benchmark import joint_spans, spans


def probe():
    return spans.probe()


def read(ctx):
    return joint_spans.seconds_a_solve(ctx.probes.get("upload_s.field32"),
                                       ("joint.upload",))
