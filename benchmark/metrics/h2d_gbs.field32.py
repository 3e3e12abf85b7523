"""The rate of the joint route's uploads on the card: the bytes the
window's solves hand to it (their ``h2d_bytes`` counter events) over the
device seconds of the trace's operations named ``Memcpy HtoD``, in GB/s
(1e9 bytes)."""

from benchmark import joint_spans, spans


def probe():
    return spans.probe()


def read(ctx):
    n = joint_spans.counter_total(ctx.probes.get("h2d_gbs.field32"),
                                  "h2d_bytes")
    if not n or ctx.trace is None:
        return None
    _, secs = ctx.trace.kernel_seconds(("Memcpy HtoD",))
    return n / secs / 1e9 if secs > 0 else None
