"""Device milliseconds under the ``expand`` range (the model's
``successors``) per million walker steps of the traced window."""


def read(ctx):
    tr, steps = ctx.trace, ctx.window.get("steps", 0)
    if tr is None or not steps or not tr["range_device_s"]["expand"]:
        return None
    return tr["range_device_s"]["expand"] * 1e3 / (steps / 1e6)
