"""Mean wall of ``run_flagship``'s reduction stage (vane, per-feed
Level-1 -> Level-2 reduction; synchronised at its ends) an observation
of the window."""

from benchmark.metrics import mean_of


def read(ctx):
    return mean_of(ctx, "reduce_s")
