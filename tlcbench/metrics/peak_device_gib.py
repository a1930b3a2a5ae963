"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, in GiB."""


def read(ctx):
    peak = ctx.window.get("peak_bytes", 0)
    return peak / 2**30 if peak > 0 else None
