#!/usr/bin/env python
"""Calibrate the cost-attribution model of the PyTorch port: the unit
costs (ns per expanded row, probed lane, compacted element, appended
row, initial lane; with ``--sweep``, per liveness sweep lane) that
``obs/attribution.py`` prices a run's work units with.

    python scripts/torch_calibrate.py --out cal.json            # the card
    python scripts/torch_calibrate.py --out cal.json --cpu
    python scripts/torch_calibrate.py --out cal.json --config shipped --sweep

It runs the stage loop (``fuse="stage"``) under ``PTT_STAGE_TIMING=1``
on a reference binding — ``full`` (default): the producer modeled,
``RetainNullKey=FALSE``, 253,361 states; ``shipped``: 45,198 states;
``small``: 1,654 states — after one untimed warm-up run, divides each
stage's RTT-corrected seconds by the run's own work units, writes the
calibration to ``--out`` and prints it as one JSON line (with the
card's name).  The drains serialize the loop: this is a measurement
run, slower than a normal check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

CONFIGS = ("full", "shipped", "small")


def binding(config: str):
    """(constants, DeviceChecker knobs) of a reference binding."""
    from pulsar_tlaplus_tpu_torch.ref import pyeval as pe

    if config == "small":
        return pe.Constants(
            message_sent_limit=2, compaction_times_limit=2, num_keys=1,
            num_values=1, max_crash_times=1, model_producer=True,
        ), dict(sub_batch=256, visited_cap=1 << 12)
    if config == "shipped":
        return pe.SHIPPED_CFG, dict(sub_batch=2048, visited_cap=1 << 16)
    return dataclasses.replace(
        pe.SHIPPED_CFG, model_producer=True, retain_null_key=False,
    ), {}


def calibrate(config: str = "full", device=None, sweep: bool = False,
              stream_dir=None):
    """``(calibration dict, the timed run's events)``."""
    os.environ["PTT_STAGE_TIMING"] = "1"  # read at checker construction
    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu_torch.obs import attribution, report

    c, kw = binding(config)
    d = stream_dir or tempfile.mkdtemp(prefix="ptt_calibrate_")
    stream = os.path.join(d, f"calibrate_{config}.jsonl")
    if os.path.exists(stream):
        os.remove(stream)
    try:
        DeviceChecker(CompactionModel(c), invariants=(), fuse="stage",
                      device=device, **kw).run()  # the untimed warm-up
        ck = DeviceChecker(CompactionModel(c), invariants=(), fuse="stage",
                           device=device, telemetry=stream, **kw)
        ck.run()
    finally:
        del os.environ["PTT_STAGE_TIMING"]
    events, _errs = report.load_events(stream)
    cal = attribution.calibrate_from_events(
        events, label=f"scripts/torch_calibrate.py ({config})")
    if sweep:
        from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker

        sw = stream + ".sweep"
        if os.path.exists(sw):
            os.remove(sw)
        LivenessChecker(CompactionModel(c), fairness="wf_next",
                        device=device, telemetry=sw).run()
        sweep_events, _e = report.load_events(sw)
        cal = attribution.sweep_calibrate_from_events(sweep_events, cal)
    return cal, events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="calibration JSON to write")
    ap.add_argument("--config", choices=CONFIGS, default="full")
    ap.add_argument("--cpu", action="store_true", help="calibrate the CPU")
    ap.add_argument("--sweep", action="store_true",
                    help="also calibrate the liveness sweep lane")
    ap.add_argument("--stream-dir", default=None,
                    help="keep the timed run's telemetry stream here")
    args = ap.parse_args(argv)
    from pulsar_tlaplus_tpu_torch.obs import attribution

    cal, _ev = calibrate(args.config, "cpu" if args.cpu else None,
                         args.sweep, args.stream_dir)
    attribution.save_calibration(args.out, cal)
    print(json.dumps(cal, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
