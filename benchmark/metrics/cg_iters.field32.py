"""CG iterations a solve of the window (``DestriperResult.n_iter``: the
stopping rule's count), mean over the solves."""

from benchmark.metrics import mean_of


def read(ctx):
    return mean_of(ctx, "n_iter")
