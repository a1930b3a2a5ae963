"""Incremental checking: digest-verified warm-start artifacts and the
reuse planner — the port's copy of ``pulsar_tlaplus_tpu/warm/``.

``store`` persists one warm artifact per engine config signature — the
run's frame (visited table, rows, logs, level cursor) plus a SHA-256
manifest binding it to the full semantic signature and the port tag —
under the daemon's state dir: per-writer-unique tmp + ``os.replace``
writes, digests verified on every read, a startup sweep that
quarantines unverifiable artifacts, and an LRU byte cap.

``plan`` decides, a submit at a time, whether a stored artifact can be
reused soundly: ``continue`` (identical signature, wider budget: resume
the frame), ``reseed`` (a constant widened on a declared-monotone axis:
the old states stay visited, the saturated suffix replays), or ``cold``
(anything else, with a typed reason; never a wrong verdict).  Only the
daemon (``service/scheduler.py``) drives it.
"""
