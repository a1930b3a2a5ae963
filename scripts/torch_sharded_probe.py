"""Probe of the mesh-sharded engine on one card (card only):

    python3 scripts/torch_sharded_probe.py

Runs the card tests of the sharded engine, then the scaled compaction
binding (``bench.py:66-77``) to 17,787,334 states on 4 shards of the
one card at sub_batch 2^14, 2^15 and 2^16 (wall, host fetches, card
syncs, peak memory, bytes routed a level, launches), one shard against
the single-card engine in turns, a ``torch.profiler`` trace of the
4-shard and the 1-shard run (device busy, kernel launches, the ops with
the most device time), and the 9m liveness tier explored on 4 shards.
Prints one JSON line a measurement and the card's name and power limit
first.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCALED_TOTAL = 17_787_334


def _syncs(torch, fn):
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
    from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker
    from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
        ShardedDeviceChecker,
    )
    from pulsar_tlaplus_tpu_torch.kernels import build as kernels
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu_torch.ref import pyeval

    if not torch.cuda.is_available():
        print("torch_sharded_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    t = time.time()
    kernels.build()
    kernels.load()
    print(json.dumps(dict(what="build", s=time.time() - t)), flush=True)
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-m", "cuda", "tests/test_torch_cuda.py", "-k",
         "sharded", "-q"], cwd=ROOT, capture_output=True, text=True)
    print(json.dumps(dict(what="card tests", rc=p.returncode,
                          tail=p.stdout.strip().splitlines()[-1:])),
          flush=True)
    c = pyeval.Constants(
        message_sent_limit=64, compaction_times_limit=3, num_keys=8,
        num_values=2, retain_null_key=True, max_crash_times=3,
        model_producer=True, model_consumer=False)

    def sharded(n, sb):
        return ShardedDeviceChecker(CompactionModel(c), n_devices=n,
                                    sub_batch=sb,
                                    max_states=SCALED_TOTAL + 1)

    for sb in (1 << 15, 1 << 14, 1 << 16):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        ck = sharded(4, sb)
        r, n_syncs = _syncs(torch, ck.run)
        st = ck.last_stats
        print(json.dumps(dict(
            what="scaled, 4 shards", sub_batch=sb, wall=r.wall_s,
            totals=list(itertools.accumulate(r.level_sizes)),
            fetches=st["host_syncs"], card_syncs=n_syncs,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            per_shard=ck.last_stats_matrix[:, 0].tolist(),
            level_route_bytes=st["level_route_bytes"],
            launches=dict(kernels.LAUNCHES), flushes=st["flushes"],
            table_slots=st["fpset_table_cap"])), flush=True)
        del ck
    for _ in range(2):
        for name in ("1 shard", "single-card"):
            torch.cuda.empty_cache()
            ck = (sharded(1, 1 << 15) if name == "1 shard"
                  else DeviceChecker(CompactionModel(c),
                                     max_states=SCALED_TOTAL + 1))
            r = ck.run()
            print(json.dumps(dict(
                what=name, wall=r.wall_s,
                totals=list(itertools.accumulate(r.level_sizes)),
                fetches=ck.last_stats["host_syncs"])), flush=True)
            del ck
    for n in (4, 1):
        torch.cuda.empty_cache()
        ck = sharded(n, 1 << 15)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = ck.run()
        ev = prof.key_averages()
        # the device's own events (kernels, copies, fills): the ATen ops
        # above them carry the same device time again
        dev = [e for e in ev if e.self_device_time_total > 0
               and not e.key.startswith("aten::")]
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:14]
        print(json.dumps(dict(
            what=f"profile, {n} shard(s)", wall=r.wall_s, busy_ms=busy,
            idle_share=max(0.0, 1 - busy / 1e3 / r.wall_s),
            device_events=sum(e.count for e in dev),
            fetches=ck.last_stats["host_syncs"],
            top_ops=[(e.key[:60], round(e.self_device_time_total / 1e3, 2),
                      e.count) for e in top])), flush=True)
        del ck, prof
    tier9m = pyeval.Constants(
        message_sent_limit=4, compaction_times_limit=3, num_keys=2,
        num_values=2, retain_null_key=True, max_crash_times=2,
        model_producer=True, model_consumer=False)
    torch.cuda.empty_cache()
    lc = LivenessChecker(CompactionModel(tier9m), fairness="wf_next",
                         n_devices=4, frontier_chunk=1 << 16,
                         visited_cap=1 << 24, max_states=12_000_000,
                         sweep_chunk=1 << 19)
    t = time.time()
    r = lc.run()
    src, _dst, od = lc._edge_cache
    print(json.dumps(dict(
        what="9m liveness, 4 shards", wall=time.time() - t,
        states=r.distinct_states, holds=r.holds, edges=len(src),
        out_deg_hist=np.bincount(od).tolist(),
        phases={k: v for k, v in lc.last_stats.items()
                if k.endswith("_s")})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
