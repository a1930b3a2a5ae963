#!/usr/bin/env python
"""Telemetry JSONL -> the per-stage table and BENCH keys, for streams the
PyTorch port writes (``check ... -telemetry FILE``).

    python scripts/torch_telemetry_report.py run.jsonl
    python scripts/torch_telemetry_report.py run.jsonl --attribution \
        [--calibration cal.json]
    python scripts/torch_telemetry_report.py a.jsonl --compare b.jsonl
    python scripts/torch_telemetry_report.py run.jsonl --trace out.json

The same options and output as ``scripts/telemetry_report.py``, over
``pulsar_tlaplus_tpu_torch.obs`` (no JAX needed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from pulsar_tlaplus_tpu_torch.obs import report  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="telemetry JSONL -> per-stage table + BENCH keys"
    )
    ap.add_argument("stream", help="telemetry JSONL file")
    ap.add_argument(
        "--compare", default=None, metavar="OTHER",
        help="second stream: renders the two-column differential "
        "table (BASELINE.md round-6 shape) with a ratio column",
    )
    ap.add_argument(
        "--labels", nargs="*", default=None,
        help="column labels (default: file basenames)",
    )
    ap.add_argument(
        "--bench-keys", action="store_true",
        help="print ONLY the fpset_*/ckpt_* BENCH keys as one JSON "
        "object",
    )
    ap.add_argument(
        "--jobs", action="store_true",
        help="render the per-job lifecycle table of a checker-daemon "
        "stream (schema v4 job_* events; v5 adds the per-slice "
        "suspend/restore overhead columns — docs/service.md); when a "
        "dispatcher stream rides along via --compare the table gains "
        "the fleet columns — owning backend, hop count, end-to-end "
        "seconds vs on-device wall — joined per job by its v15 "
        "trace_id (docs/observability.md)",
    )
    ap.add_argument(
        "--attribution", action="store_true",
        help="render the per-stage COST-ATTRIBUTION table from the "
        "run's work-unit counters (v7): a single default-mode fused "
        "run reproduces the BASELINE per-stage shape with no "
        "PTT_STAGE_TIMING / -fuse stage rerun "
        "(docs/observability.md \"Attribution\")",
    )
    ap.add_argument(
        "--calibration", default=None, metavar="FILE",
        help="calibration.json with per-backend unit costs "
        "(scripts/torch_calibrate.py); default: built-in "
        "backend defaults, footnoted as uncalibrated",
    )
    ap.add_argument(
        "--trace", default=None, metavar="OUT.json",
        help="export the stream(s) as Perfetto-loadable Chrome trace "
        "JSON instead of tables (obs/trace.py; --compare streams "
        "render as separate trace processes)",
    )
    args = ap.parse_args(argv)

    paths = [args.stream] + ([args.compare] if args.compare else [])
    labels = args.labels or [
        os.path.splitext(os.path.basename(p))[0] for p in paths
    ]
    if len(labels) != len(paths):
        ap.error("--labels must match the number of streams")
    streams = []
    for lbl, p in zip(labels, paths):
        evs, errs = report.load_events(p)
        for e in errs:
            print(f"{p}: WARNING: {e}", file=sys.stderr)
        if not evs:
            print(f"{p}: no telemetry events", file=sys.stderr)
            return 2
        streams.append((lbl, evs))

    if args.trace:
        from pulsar_tlaplus_tpu_torch.obs import trace as trace_mod

        tr = trace_mod.write_trace(streams, args.trace)
        n = sum(1 for e in tr["traceEvents"] if e.get("ph") != "M")
        print(
            f"wrote {args.trace}: {n} event(s) — open in "
            "https://ui.perfetto.dev"
        )
        return 0

    if args.bench_keys:
        print(json.dumps(report.bench_keys(streams[0][1]), indent=2))
        return 0

    if args.jobs:
        # auto-detect which stream is the dispatcher (it carries the
        # route events) — either argument order works
        fleet_evs = None
        job_evs = None
        for _lbl, evs in streams:
            if any(e.get("event") == "route" for e in evs):
                fleet_evs = fleet_evs if fleet_evs is not None else evs
            elif job_evs is None:
                job_evs = evs
        print(
            report.render_job_table(
                job_evs if job_evs is not None else streams[0][1],
                fleet_events=fleet_evs,
            )
        )
        return 0

    if args.attribution:
        from pulsar_tlaplus_tpu_torch.obs import attribution

        cal = (
            attribution.load_calibration(args.calibration)
            if args.calibration
            else None
        )
        print(attribution.render_attribution(streams, cal))
        return 0

    hd = report.header(streams[0][1])
    if hd is not None:
        print(
            f"run {hd.get('run_id')} — {hd.get('engine')} "
            f"({hd.get('visited_impl')}) on {hd.get('device')}\n"
        )
    print(report.render_stage_table(streams))
    print()
    print("BENCH keys:")
    print(json.dumps(report.bench_keys(streams[0][1]), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
