"""The reduction's achieved share of the HBM bandwidth over its wall: the
bytes one observation's reduction must move (``work.reduce``) over the
H100's HBM bandwidth, divided by the mean wall of the reduction stage,
in percent. The wall is the host's clock: it holds the device's idle
time inside the stage too, so this is no kernel roofline."""

from benchmark.metrics import mean_of
from benchmark.work import peaks, reduce


def read(ctx):
    wall = mean_of(ctx, "reduce_s")
    if wall is None:
        return None
    z = ctx.sizes
    n = reduce.bytes_moved(z["n_feeds"], z["n_bands"], z["n_channels"],
                           ctx.driver.n_samples, z["vane_samples"])
    return 100.0 * peaks.bound_s(n) / wall
