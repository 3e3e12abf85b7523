"""Device operations (kernels, memory copies and sets) in the traced
window per CG iteration of the window's solves."""


def read(ctx):
    iters = sum(r.get("n_iter", 0) for r in ctx.records)
    if ctx.trace is None or iters <= 0:
        return None
    return ctx.trace.n_device_ops() / iters
