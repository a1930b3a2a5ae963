"""The share of the traced window in which no operation ran on the
device: one less the union of the trace's device intervals over the
window's length, in percent."""

from tlcbench.metrics._share import idle_pct


def read(ctx):
    return idle_pct(ctx)
