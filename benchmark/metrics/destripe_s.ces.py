"""Mean wall of ``run_flagship``'s destripe stage (the planned
multi-RHS Jacobi CG; synchronised at its ends) an observation of the
window."""

from benchmark.metrics import mean_of


def read(ctx):
    return mean_of(ctx, "destripe_s")
