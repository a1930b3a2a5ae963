"""Walls of the compiled compaction model at the 9m binding, in a
process that runs nothing else: the fused level and the stage loop in
turns.

For each bucket floor given (``CompiledSpec.MIN_BUCKET``, the smallest
batch a recorded graph is padded to), this builds the compiled model of
``specs/compaction.tla`` at MessageSentLimit 4, MaxCrashTimes 2,
ModelProducer TRUE (the 9m tier of ``scripts/liveness_scale.py``), runs
it to 9,445,152 states with ``-fuse level`` and then ``-fuse stage``
(2^16-row windows), and prints one JSON line: both walls, the graphs
recorded and their seconds, the replays and their host seconds, and the
seconds Python's garbage collector ran during each run.  The floors run
in the order given, so ``--floors 16384,1024,1024,16384`` compares two
floors in turns.  The card's name and power limit come first.

    python3 scripts/torch_compiled_walls.py [--floors 1024,...]

Runs on the card only (no JAX); builds the kernels from the checkout.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout in place of scripts/, whose profile.py would shadow the
# standard module that torch imports when it records a graph
sys.path[0] = ROOT

STATES, DIAMETER = 9_445_152, 24


def main() -> int:
    import torch

    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
    from pulsar_tlaplus_tpu_torch.frontend.codegen import CompiledSpec
    from pulsar_tlaplus_tpu_torch.frontend.interp import Spec
    from pulsar_tlaplus_tpu_torch.frontend.loader import bind_cfg
    from pulsar_tlaplus_tpu_torch.frontend.parser import parse_file
    from pulsar_tlaplus_tpu_torch.kernels import build as kernels
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

    ap = argparse.ArgumentParser()
    ap.add_argument("--floors", default=str(CompiledSpec.MIN_BUCKET))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_compiled_walls: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    kernels.build()
    kernels.load()
    specs = os.path.join(ROOT, "specs")
    ast = parse_file(os.path.join(specs, "compaction.tla"))
    tlc = cfgmod.load(os.path.join(specs, "compaction.cfg"))

    gc_s = [0.0, 0.0]  # seconds in the collector, start of its last run

    def gc_clock(stage, _info):
        if stage == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]

    gc.callbacks.append(gc_clock)
    for floor in (int(f) for f in args.floors.split(",")):
        CompiledSpec.MIN_BUCKET = floor
        consts = bind_cfg(ast, tlc)
        consts.pop("__string_interning__")
        consts.update(MessageSentLimit=4, MaxCrashTimes=2,
                      ModelProducer=True)
        cs = CompiledSpec(Spec(ast, consts), invariants=tuple(tlc.invariants))
        out = {"floor": floor}
        for fuse in ("level", "stage"):
            gc0 = gc_s[0]
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = DeviceChecker(cs, sub_batch=1 << 16, fuse=fuse,
                              max_states=12_000_000).run()
            torch.cuda.synchronize()
            out[fuse] = round(time.perf_counter() - t, 3)
            out[f"{fuse}_gc_s"] = round(gc_s[0] - gc0, 3)
            if (r.distinct_states, r.diameter, r.violation) != (
                    STATES, DIAMETER, None):
                raise AssertionError(f"{fuse}: {r.distinct_states} states, "
                                     f"diameter {r.diameter}")
        out.update(builds=cs.graph_builds,
                   build_s=round(cs.graph_build_s, 3),
                   replays=cs.graph_calls,
                   replay_s=round(cs.graph_replay_s, 3))
        print(json.dumps(out), flush=True)
        del cs
        gc.collect()
        torch.cuda.empty_cache()
    gc.callbacks.remove(gc_clock)
    return 0


if __name__ == "__main__":
    sys.exit(main())
