"""The device's idle share of the traced window, in percent."""

from benchmark.metrics import idle_percent


def read(ctx):
    return idle_percent(ctx)
