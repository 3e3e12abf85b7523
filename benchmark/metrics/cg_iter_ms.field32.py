"""The mean host wall of one CG iteration of the joint solves (a
``cg.iter`` span in a ``joint`` tree), in milliseconds: dispatch and the
card's work alike, each iteration ending in its host read of the live
flag."""

from benchmark import joint_spans, spans


def probe():
    return spans.probe()


def read(ctx):
    its = joint_spans.spans_named(ctx.probes.get("cg_iter_ms.field32"),
                                  "cg.iter")
    if not its:
        return None
    return 1e3 * sum(spans.host_s(s) for s in its) / len(its)
