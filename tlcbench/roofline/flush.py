"""Bytes the flush's work needs: every lane reads its ``K`` key columns
and its valid flag, probes one table slot (``K`` words: a present key
is found, a new one meets an empty slot at its first probe at the
table's load), and writes its new-state flag; every new state writes
its key into the table.  Probes past the first, the survivors'
compaction and the insert's claims are what an implementation spends
beyond this."""


def bytes_needed(counts: dict) -> int:
    k = counts["K"]
    return counts["lanes"] * (4 * k + 1 + 4 * k + 1) + counts["new"] * 4 * k
