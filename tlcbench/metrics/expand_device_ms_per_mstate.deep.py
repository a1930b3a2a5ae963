"""Device milliseconds under the ``expand`` range (the model's
``successors`` and its layout's pack and unpack) per million states
expanded (the engine's ``work_expand_rows``), in the traced checks."""

from tlcbench.metrics._share import expand_ms_per_mstate


def read(ctx):
    return expand_ms_per_mstate(ctx)
