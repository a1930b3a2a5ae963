"""Bytes the key plane's work needs: every lane of an expand window
(states expanded times the model's lanes, and the initial states) reads
its packed row (``W`` words) and its valid flag once and writes its
``K`` key columns once.  The counts are the engine's, not a kernel's
launch arguments, so the share reads the same work whatever implements
the layer (the arithmetic of the port's kernel table: 4W + 1 + 4K bytes
a lane)."""


def bytes_needed(counts: dict) -> int:
    return counts["lanes"] * (4 * counts["W"] + 1 + 4 * counts["K"])
