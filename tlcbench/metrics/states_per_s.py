"""Distinct states found by every check of the window, the stopped one
included, over the window's seconds (host clock)."""

from tlcbench.metrics._share import rate


def read(ctx):
    return rate(ctx, "states")
