"""The tiered scaled run on the card in both of its loops, in turns:
``fuse="stage"`` (the stage loop from the first level, the tiered path
before the fused handoff) against ``fuse="level"`` (the fused level
until the tiered store must spill, then the stage loop), on the same
budget as chip_smoke.py's phase 11 (the largest whose hot table tops
out at 2^25 slots), order stage, level, level, stage.  Each run's level
sizes are checked against the first's; the script prints one line per
run (its spill and growth log on stderr) and, last on stdout, one JSON
object with the card's name and power limit and every run's wall, host
seconds of cold lookups, D2H + encode seconds, evictions, keys evicted,
misses resolved and the handoff level.

    python3 scripts/torch_tiered_handoff_ab.py        # card only
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCALED_TOTAL = 17_787_334
TCAP = 1 << 25


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tiered_handoff_ab: no CUDA device", file=sys.stderr)
        return 2
    from pulsar_tlaplus_tpu_torch.engine.device_bfs import (
        HBM_HEADROOM,
        DeviceChecker,
    )
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu_torch.ref import pyeval

    c = pyeval.Constants(
        message_sent_limit=64, compaction_times_limit=3, num_keys=8,
        num_values=2, retain_null_key=True, max_crash_times=3,
        model_producer=True, model_consumer=False,
    )
    m = CompactionModel(c)
    kw = dict(max_states=SCALED_TOTAL + 1)
    probe = DeviceChecker(m, hbm_budget="1T", **kw)
    w = probe.WCAP_MAX
    lo = int(probe._device_bytes_est(probe.TCAP0, probe.WCAP0, probe.WCAP0)
             / (1.0 - HBM_HEADROOM))
    hi = int(probe._device_bytes_est(2 * TCAP, w, w)
             / (1.0 - HBM_HEADROOM)) + 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if DeviceChecker(m, hbm_budget=mid, **kw).TCAP_MAX <= TCAP:
            lo = mid
        else:
            hi = mid
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    runs, sizes = [], None
    for fuse in ("stage", "level", "level", "stage"):
        torch.cuda.empty_cache()
        ck = DeviceChecker(m, hbm_budget=lo, fuse=fuse, progress=True,
                           **kw)
        r = ck.run()
        st = ck.last_stats
        if sizes is None:
            sizes = r.level_sizes
        elif r.level_sizes != sizes:
            raise AssertionError(f"{fuse}: level sizes {r.level_sizes}")
        rec = dict(
            fuse=fuse, wall_s=r.wall_s,
            lookup_s=ck.tstore.stats.lookup_s,
            transfer_s=st["spill_transfer_s"],
            evictions=st["spill_evictions"],
            keys_evicted=st["spill_keys_evicted"],
            rows_spilled=st["spill_rows_evicted"],
            misses_resolved=st["spill_misses_resolved"],
            miss_hits=st["spill_miss_hits"],
            hot_keys=st["spill_hot_keys"],
            table=st["fpset_table_cap"],
            handoff_level=st["handoff_level"],
            fused_levels=st["fused_levels_before_handoff"],
            host_syncs=st["host_syncs"],
        )
        runs.append(rec)
        print(rec, flush=True)
    print(json.dumps(dict(device=smi, budget=lo, level_sizes=sizes,
                          runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
