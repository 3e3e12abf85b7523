"""K1's share of its roofline over the window: per call, from its shapes
(``work.k1``), over the device time of its kernels in the trace."""

from benchmark.metrics import k1_probe, k1_roofline


def probe():
    return k1_probe()


def read(ctx):
    return k1_roofline(ctx, "k1_roofline.ces")
