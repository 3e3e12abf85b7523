"""K3's share of its roofline over the window's destriper calls: per
call, from its shapes (``work.k3``), over the device time of its
kernels in the trace."""

from benchmark.metrics import k3_probe, k3_roofline


def probe():
    return k3_probe()


def read(ctx):
    return k3_roofline(ctx, "k3_roofline.ces")
