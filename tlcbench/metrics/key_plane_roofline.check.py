"""K2's layer, the key plane (``ops.tiles.key_plane``): the bytes its
work needs (``roofline/key_plane.py``) at the card's memory rate, over
the device time under its range, in percent."""

from tlcbench.metrics._share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "key_plane", "key_plane")
