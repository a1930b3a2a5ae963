"""Process start to the first timed check or segment: imports, the
kernels from their cache (built on a checkout's first run), the model,
and one warm check or segment of the cell's binding."""


def read(ctx):
    return ctx.setup_s
