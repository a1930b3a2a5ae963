"""Checking as a service — the resident multi-tenant checker daemon of the
port (the counterpart of ``pulsar_tlaplus_tpu/service/``).

A CI fleet submitting Pulsar spec revisions should not pay a process
start, a model build and the kernels' load per verdict.  This package
keeps checkers resident and time-slices the card between jobs:

- :mod:`jobs` — the job model: one queued check (spec + .cfg constant
  bindings + state/time budget) with its own directory, frame,
  telemetry stream and result record.
- :mod:`protocol` — the JSONL wire protocol over a unix socket or an
  authenticated TCP listener (submit/status/result/cancel/watch/
  metrics/ping/shutdown).
- :mod:`auth`, :mod:`admission` — bearer tokens to tenants, quotas and
  load shedding (typed rejections, never silent queueing).
- :mod:`scheduler` — the checker pool (one a device slot) and the FIFO
  + budget-slice scheduler that suspends a running job at a level
  boundary (the engine's cooperative ``suspend_hook``: a frame on disk,
  the device memory freed) and resumes the next; warm starts from
  ``warm/`` (continue, reseed, cold).
- :mod:`server` — the daemon (``cli.py serve``): accept loops, graceful
  SIGTERM shutdown (frame the active job, persist the queue), ``serve
  --recover``.
- :mod:`client` — the thin client (``cli.py submit/status/watch/
  cancel/metrics/top``).

State layout under ``state_dir``::

    serve.sock            the listening unix socket
    serve.lock            one daemon a state dir (flock)
    service.jsonl         the daemon's telemetry stream (job_* events)
    queue.json            the persisted queue (atomic; survives restarts)
    warm/                 warm artifacts (warm/store.py)
    jobs/<job_id>/
        job.json          the submit record (torn-queue rebuild)
        frame.npz         the job's frame (per-job isolation)
        events.jsonl      the job's engine telemetry (one run_id a slice)
        result.json       the final result record
"""
