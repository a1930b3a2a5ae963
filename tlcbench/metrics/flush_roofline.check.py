"""The flush (``ops.tiles.flush_tiles``: K1, the survivors' compaction,
H1): the bytes its work needs (``roofline/flush.py``) at the card's
memory rate, over the device time under its range, in percent."""

from tlcbench.metrics._share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "flush", "flush")
