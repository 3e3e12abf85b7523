"""Host seconds of the pointing-plan build during set-up, as the
program's logger reports them (records with ``stage=plan_build``)."""


def read(ctx):
    vals = [s for name, s in ctx.stages.setup if name == "plan_build"]
    return sum(vals) if vals else None
