"""Walker steps the simulation completed in the window over its seconds
(host clock; the window ends at the first segment past its length)."""

from tlcbench.metrics._share import rate


def read(ctx):
    return rate(ctx, "steps")
