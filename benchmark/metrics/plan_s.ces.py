"""Mean wall of ``run_flagship``'s plan stage (the bands' assembly and
``build_pointing_plan`` from the observation's pointing; synchronised at
its ends) an observation of the window."""

from benchmark.metrics import mean_of


def read(ctx):
    return mean_of(ctx, "plan_s")
