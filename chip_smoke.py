"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version on the card (exact equality: integer work;
for the insert tail H1, phase 2d, the table slot for slot), times both
(each kernel through its wrapper, ``ms``, and as raw launches on
preallocated outputs, ``device_ms``), then drives the port's two paths,
each with the kernels' launch counters zeroed before and read after:

- the main path (phases 3-6), in the default fused-level mode: ``cli
  check`` of the shipped compaction cfg, the checker on the
  253,361-state config, both published counterexamples, and the scaled
  bench config to its 17,787,334-state level, counting the card's
  synchronizations beside the checker's ``host_syncs``; phase 6b runs
  the scaled config in the stage loop and holds its level totals, rows
  and logs against phase 6's;
- the tiered store (phases 9-11): the same checks under tight
  ``-hbm-budget``s that force eviction, row spill and cold-miss
  resolution, each held state for state against the untiered run, and
  the scaled config with its hot table capped at 2^25 slots.

- the other three specs (phases 14-17): ``cli check`` of the shipped
  subscription, bookkeeper and georeplication cfgs and of their seeded
  bugs (the JAX engine's gid, depth and actions), the four scaled
  bindings of ``SPEC_SCALED`` to their pinned level totals through the
  CLI and the checker in the fused level (card syncs counted), 16b the
  stage loop held to them (level sizes, rows, logs), and 17 the exact
  K = 3 binding tiered at a hot table of 2^23 slots, equal to its
  untiered run.  Phase 2e holds K2 (exact w = 1 and 3, hashed w = 5),
  K1, H1 and K3 (K = 3) against their plain versions on flushes these
  models make, and phase 18 profiles the K = 3 binding.

- liveness (phases 19-21): ``Termination`` of the 9,445,152-state tier
  of ``scripts/liveness_scale.py`` under ``wf_next`` and ``none``, its
  edge count, out-degree histogram, edge digest and verdicts held to the
  JAX engine's pins (``LIVENESS_PINS``, ``scripts/liveness_pins.py``)
  and its edges to an independent recount of 65,536 sampled states;
  then the 253,361-state config (API, ``cli check -property``, and
  tiered at a tight budget), the ``consumer_on`` lasso oracle and the
  other three specs' shipped cfgs, each to its pins.  Phase 22 holds K2
  against its plain version at the sweep's chunk shape (2^23 lanes).
- simulation (phases 23-24): one round of 4,096 and of 65,536 walkers at
  depth 64 on the scaled config, the card's syncs counted against one a
  segment; both seeded compaction bugs found at the shipped cfg, each
  trace verified and replayed on the oracle, and the same seed's run on
  the CPU identical (trace and counters).  Phase 25 profiles the 9m
  liveness run and the 65,536-walker simulation.

- the spec->kernel compiler (phases 26-30, launch counters zeroed
  around them): ``cli check -force-compile`` of the four shipped cfgs
  and the 253,361-state config, both compaction counterexamples
  replayed step by step through the compiled ``successors`` on the card
  and the interpreter; compiled compaction.tla at the 9m binding in the
  fused level and the stage loop in turns, level sizes equal to the
  hand model's, profiled, with the host seconds per window; the four
  scaled bindings to their pins; a tiered run equal to its untiered
  run; liveness to the ``compiled_full`` pins and the seeded bugs by
  simulation for seeds 0-2.  Phase 2f holds K2 (hashed W = 5 and 7),
  K1 and H1 against their plain versions on compiled models' flushes;
  ``[30c graphs]`` prints each compiled model's graph statistics.

Phase 8 profiles the fused scaled run and fails if the plain probe's
``amin`` scatter (``aten::scatter_reduce_``) shows up in it; phase 8b
profiles the stage loop the same way and prints where the two loops'
device time by op differs.

Each phase prints one line with its seconds.  The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``; any
failed phase exits non-zero without them.  Exits non-zero at once when
no CUDA device is available or the port cannot be imported.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import itertools
import json
import os
import re
import subprocess
import sys
import time
import warnings

# H100 SXM peaks (NVIDIA data sheet) for each kernel's bound: memory
# rate, and the 32-bit non-tensor rate (67 T/s in float32; the kernels'
# integer ALU work is counted against it)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
SCALED_PREV_TOTAL = 636_718  # cumulative states after level 5
SCALED_TOTAL = 17_787_334  # cumulative states after level 6
SEED = 20261017
# the kernels each path runs (the tiered path runs all five)
MAIN_PATH_KERNELS = ("selftest", "member_block", "key_plane", "insert_tail")
TIERED_PATH_KERNELS = MAIN_PATH_KERNELS + ("sieve_mask",)
TIERED_TCAP = 1 << 25  # phase 11's hot-table ceiling
ROOT = os.path.dirname(os.path.abspath(__file__))
SPECS = os.path.join(ROOT, "specs")
# the other three specs.  Shipped cfgs: (distinct states, diameter).
SPEC_SHIPPED = {"subscription": (2272, 24), "bookkeeper": (297, 14),
                "georeplication": (6400, 18)}
# the seeded bugs: spec -> (invariant, CONSTANT overrides of the shipped
# cfg, the JAX engine's violating gid, trace length, actions)
SPEC_BUGS = {
    "subscription": ("ExactlyOnceProcessing", {}, 95, 7, [
        "Publish", "Deliver", "Process", "ConsumerCrash", "Deliver",
        "Process"]),
    "bookkeeper": ("ConfirmedEntryReadable", {"MaxBookieCrashes": 2}, 305,
                   9, ["AddEntry", "WriteLand", "WriteLand", "AckArrive",
                       "AckArrive", "AdvanceLAC", "BookieCrash",
                       "BookieCrash"]),
    "georeplication": ("NoDuplicateDelivery", {}, 79, 5, [
        "Publish", "Replicate", "ReplicatorCrash", "Replicate"]),
}
# the scaled bindings: name -> (spec, CONSTANTS, max_states, level sizes
# of the JAX DeviceChecker's run on the CPU, scripts/spec_scaled_pins.py).
# geo_hashed is cut at 10,000,000 states inside level 15: its 14
# complete levels are pinned
SPEC_SCALED = {
    "subscription": ("subscription", dict(MessageLimit=6, MaxCrashTimes=3),
                     1 << 26, [
        1, 2, 4, 8, 16, 34, 70, 144, 293, 581, 1126, 2123, 3886, 6887,
        11789, 19445, 30826, 46893, 68358, 95427, 127534, 163135, 199697,
        233834, 261742, 279799, 285237, 276825, 255179, 222816, 183690,
        142395, 103314, 69752, 43523, 24910, 12947, 6079, 2555, 989, 352,
        131, 41, 15, 3, 1]),
    "bookkeeper": ("bookkeeper", dict(NumBookies=4, WriteQuorum=3,
                                      AckQuorum=2, EntryLimit=4,
                                      MaxBookieCrashes=1), 1 << 26, [
        1, 5, 8, 26, 78, 219, 616, 1653, 4093, 9295, 19145, 35622, 59912,
        91293, 126313, 159214, 183427, 193750, 188239, 168879, 140400,
        108612, 78652, 53687, 34752, 21684, 13318, 8007, 4446, 2108, 793,
        221, 41, 4]),
    "geo_exact": ("georeplication", dict(NumClusters=3, PublishLimit=2,
                                         MaxReplicatorCrashes=2), 1 << 26, [
        1, 3, 12, 40, 117, 324, 828, 2019, 4626, 10034, 20592, 39954,
        73270, 126891, 207450, 319770, 464331, 634014, 812330, 973923,
        1088484, 1128608, 1078368, 941112, 741211, 517776, 312744, 156936,
        61104, 16224, 2160]),
    "geo_hashed": ("georeplication", dict(NumClusters=4, PublishLimit=2,
                                          MaxReplicatorCrashes=1),
                   10_000_000, [
        1, 4, 22, 100, 401, 1484, 5074, 16188, 48274, 135540, 359486,
        903584, 2158489, 4911548]),
}
SPEC_TIERED_TCAP = 1 << 23  # phase 17's hot-table ceiling (geo_exact)
# liveness: the 9m tier of scripts/liveness_scale.py (MessageSentLimit 4,
# |K| 2, |V| 2, CompactionTimesLimit 3, MaxCrashTimes 2, producer
# modeled), its state count by the native checker, and the knobs of its
# run (windows of 2^16 states, sweep chunks of 2^19 states = 2^23 lanes)
TIER9M_STATES = 9_445_152
TIER9M_LEVELS = [1, 10, 100, 999, 9918, 38601, 68733, 119133, 187335,
                 233496, 332586, 477576, 501867, 667935, 862983, 843660,
                 948429, 1243917, 507969, 810423, 1150785, 138348, 103518,
                 196830]
LIVENESS_9M_KW = dict(frontier_chunk=1 << 16, visited_cap=1 << 24,
                      max_states=12_000_000, sweep_chunk=1 << 19)
# the JAX LivenessChecker's results on the CPU (scripts/liveness_pins.py):
# edge count, bincount of the out-degrees, SHA-256 of the edge list
# (engine/liveness.edge_digest), and per fairness (holds, reason, lasso
# prefix, lasso cycle)
_HOLDS = (True, "all fair behaviors reach the goal", None, None)
_UNFAIR = (False, "stuttering counterexample: initial state #0 may "
           "stutter forever without reaching the goal (no fairness "
           "assumed)", [0], [0])
LIVENESS_PINS = {
    "9m": dict(
        distinct=TIER9M_STATES, edges=17194979,
        out_deg_hist=[1148175, 4179357, 3542940, 0, 0, 0, 0, 0, 0, 61543,
                      268652, 244485],
        edges_sha256="3ff36be381682d3193d0f5490c9bc056"
        "fdad74c19b70573ef95c3d2374c3b0e2",
        verdicts={"wf_next": _HOLDS, "none": _UNFAIR}),
    "full": dict(
        distinct=253361, edges=420805,
        out_deg_hist=[23328, 155358, 60507, 0, 0, 0, 0, 0, 0, 1171, 9073,
                      3924],
        edges_sha256="88103a3ee5b79a9cdd17af9e01a23319"
        "bcad75ea204c3a3ebaac6ff0a275c6b7",
        verdicts={"wf_next": _HOLDS, "none": _UNFAIR}),
    "consumer_on": dict(
        distinct=1654, edges=2597,
        out_deg_hist=[176, 848, 480, 0, 13, 85, 52],
        edges_sha256="50fb1f60d460f8c171e7314c62467516"
        "c925b31175992f1c6e47b33b15780de1",
        verdicts={
            "wf_next": (False, "fair stuttering at a not-goal state with "
                        "no var-changing successor",
                        [0, 1, 6, 30, 86, 162, 270, 394, 522, 678, 834,
                         995, 1187], [1187]),
            "none": _UNFAIR}),
    "subscription": dict(
        distinct=2272, edges=6256, out_deg_hist=[8, 136, 648, 1096, 384],
        edges_sha256="7e44a2a0bb33ad3703aab7d802f13130"
        "64b0854feedf4011fa17d3df88d16c64",
        verdicts={"wf_next": _HOLDS, "none": _UNFAIR}),
    "bookkeeper": dict(
        distinct=297, edges=926, out_deg_hist=[8, 56, 91, 41, 12, 33, 40, 16],
        edges_sha256="6ec4546fa2eff5958b023c1db919161f"
        "3d45d783cebc74c17de9976db8ef72d5",
        verdicts={"wf_next": _HOLDS, "none": _UNFAIR}),
    # the same config on the spec->kernel compiler's model (the JAX
    # compiled LivenessChecker, scripts/liveness_pins.py compiled_full):
    # its edges come out as the hand model's
    "compiled_full": dict(
        distinct=253361, edges=420805,
        out_deg_hist=[23328, 155358, 60507, 0, 0, 0, 0, 0, 0, 1171, 9073,
                      3924],
        edges_sha256="88103a3ee5b79a9cdd17af9e01a23319"
        "bcad75ea204c3a3ebaac6ff0a275c6b7",
        verdicts={"wf_next": _HOLDS, "none": _UNFAIR}),
    "georeplication": dict(
        distinct=6400, edges=26940,
        out_deg_hist=[7, 93, 498, 1359, 1995, 1533, 576, 156, 102, 53, 21, 6,
                      1],
        edges_sha256="21ef24318a31aa0697cabaa8701516e8"
        "4c7f7dfcd3708d8d5c452142e9333429",
        verdicts={"wf_next": _HOLDS, "none": _UNFAIR}),
}
# card syncs a simulation may make beyond one a segment: the result's
# synchronize and first-use constant uploads
SIM_SYNC_SLACK = 4


def _phase(name, fn, failures):
    t = time.time()
    try:
        detail = fn()
        status = "ok"
    except Exception as e:  # noqa: BLE001 — recorded, fails the run below
        detail, status = f"{type(e).__name__}: {e}", "FAILED"
        failures.append(f"{name}: {detail}")
    print(f"[{name}] {status} {time.time() - t:.2f}s {detail}", flush=True)


def _bound(nbytes, ops):
    """(least milliseconds for the work, what bounds it): the bytes
    over the memory rate or the operations over the ALU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _time_ms(torch, fn, iters):
    """Mean milliseconds of ``fn`` on the card (CUDA events, one warm-up
    call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_each(torch, setup, fn, iters):
    """Mean milliseconds of ``fn`` on the card with ``setup`` run before
    each call outside the timed span (CUDA events around each call;
    one untimed warm-up)."""
    setup()
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _card_syncs(torch, fn):
    """``fn()`` and the number of calls that synchronized the host with
    the card meanwhile (PyTorch's sync debug mode warns at each)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return out, n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from pulsar_tlaplus_tpu_torch import cli
        from pulsar_tlaplus_tpu_torch.engine.device_bfs import (
            HBM_HEADROOM,
            DeviceChecker,
        )
        from pulsar_tlaplus_tpu_torch.engine.liveness import (
            LivenessChecker,
            edge_digest,
        )
        from pulsar_tlaplus_tpu_torch.kernels import build as kernels
        from pulsar_tlaplus_tpu_torch.models.compaction import (
            CompactionModel,
        )
        from pulsar_tlaplus_tpu_torch.models import registry
        from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
        from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag
        from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec
        from pulsar_tlaplus_tpu_torch.ref import pyeval
        from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
        from pulsar_tlaplus_tpu_torch.store.budget import (
            fmt_bytes as budget_fmt,
        )
        from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    failures: list = []
    record: dict = {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)

    def rand_i32(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    # ---- 1: build + K0 self-test
    def build():
        t = time.time()
        kernels.build()
        built = time.time() - t
        kernels.load()  # loads, then launches K0 and checks x + 1
        x = torch.arange(8, dtype=torch.int32, device=dev)
        o = torch.empty_like(x)

        def k0():
            kernels.launch("selftest", "ptt_selftest", kernels.ptr(x),
                           kernels.ptr(o), 8, kernels.stream(dev))

        ms = _time_ms(torch, k0, 200)
        err = int((o - (x + 1)).abs().max())
        if err:
            raise AssertionError(f"K0 computed {o.tolist()}")
        lib = kernels.load()["selftest"]

        def raw(fn, *args):
            """A raw ctypes launch (not counted): K0's, and one of a
            kernel that does no work, whose time is the launch floor."""
            def call():
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"raw launch: CUDA error {rc}")
            return call

        st = kernels.stream(dev)
        record["selftest"] = dict(
            ms=ms,
            device_ms=_time_ms(torch, raw(lib.ptt_selftest, kernels.ptr(x),
                                          kernels.ptr(o), 8, st), 200),
            plain_ms=_time_ms(torch, lambda: x + 1, 200),
            max_abs_err=err, bound=_bound(64, 8),
            launch_floor_ms=_time_ms(torch, raw(lib.ptt_empty, st), 200),
        )
        regs = {
            n: re.findall(r"Used \d+ registers[^\n]*",
                          (kernels.BUILD_DIR / f"{n}.log").read_text())
            for n in kernels.SOURCES
            if (kernels.BUILD_DIR / f"{n}.log").exists()
        }
        rec = record["selftest"]
        return (f"nvcc {built:.1f}s; K0 x+1 ok, {ms:.4f} ms through "
                f"kernels.launch, {rec['device_ms']:.4f} ms raw against the "
                f"launch floor {rec['launch_floor_ms']:.4f} ms; ptxas {regs}")

    _phase("1 build+selftest", build, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # ---- 2: kernels against their plain versions on the card
    def k2():
        notes = []
        # the main path's shapes: the shipped cfg's widest window (3645
        # rows x A=7, exact W=2: the unstaged route) and a scaled-config
        # window (2^16 rows x A=34, W=20, 64-bit fingerprints); ragged
        # sizes, 96-bit fingerprints and the runtime-width route (exact
        # W=3, hashed W=7) for coverage
        cases = [
            (KeySpec(42, 2), 3645 * 7),
            (KeySpec(618, 20, 64), (1 << 16) * 34),
            (KeySpec(618, 20, 96), 1_000_003),
            (KeySpec(70, 3), 99_991),
            (KeySpec(224, 7, 64), 99_989),
        ]
        worst = 0
        for ks, nc in cases:
            packed = rand_i32(nc, ks.W)
            valid = torch.rand(nc, device=dev, generator=gen) < 0.8
            got = tiles.key_plane(ks, packed, valid)
            want = tiles.key_plane_plain(ks, packed, valid)
            err = max(
                int((g.long() - w.long()).abs().max()) for g, w in
                zip(got, want)
            )
            if err:
                raise AssertionError(f"K2 W={ks.W} K={ks.ncols}: err {err}")
            worst = max(worst, err)
            notes.append(f"W={ks.W},K={ks.ncols},nc={nc}")
            if ks is cases[1][0]:
                timed = packed, valid
        # timed at the scaled window (the path's widest key plane), on
        # the inputs compared above
        ks, nc = cases[1]
        packed, valid = timed
        nbytes = nc * (ks.W * 4 + 1 + ks.ncols * 4)
        # murmur3: ~5 ops a word plus ~6 a word and column, fmix ~13 a
        # column
        ops = nc * (ks.W * (5 + 6 * ks.ncols) + 13 * ks.ncols)
        # device_ms: raw launches on a preallocated output (no wrapper
        # checks, no allocation)
        out = torch.empty((ks.ncols, nc), dtype=torch.int32, device=dev)
        args = tiles.key_plane_args(ks, packed, valid, out)
        record["key_plane"] = dict(
            ms=_time_ms(torch, lambda: tiles.key_plane(ks, packed, valid),
                        50),
            device_ms=_time_ms(torch, lambda: kernels.launch(*args), 100),
            plain_ms=_time_ms(
                torch, lambda: tiles.key_plane_plain(ks, packed, valid), 5
            ),
            max_abs_err=worst, bytes=nbytes, bound=_bound(nbytes, ops),
        )
        return "equal: " + "; ".join(notes) + (
            f"; timed W=20 K=2 nc={nc}: {record['key_plane']}"
        )

    _phase("2a K2 key_plane vs plain", k2, failures)

    shared = {}

    def k1():
        # a visited table at the scaled run's last tier (2^26 slots)
        # holding 16M keys, filled by the plain insert
        cap, k = 1 << 26, 2
        tcols = fpset.empty_cols(cap, k, dev)
        claims = fpset.new_claims(cap, dev)
        fill = tuple(rand_i32(16 << 20) for _ in range(k))
        for base in range(0, fill[0].shape[0], 1 << 22):
            ks = tuple(c[base: base + (1 << 22)] for c in fill)
            _n, tcols, pending, _r = fpset.probe_insert(
                tcols, ks, ~fpset.all_sentinel(ks), claims=claims
            )
            if pending.any():
                raise AssertionError("plain insert left lanes pending")
        # an accumulator at the path's width: dup-heavy (60% present),
        # SENTINEL lanes, and a partial n_acc
        nq = (1 << 16) * 34
        pick = torch.randint(0, fill[0].shape[0], (nq,), device=dev,
                             generator=gen)
        fresh = torch.rand(nq, device=dev, generator=gen) < 0.4
        kcols = tuple(
            torch.where(fresh, rand_i32(nq), f[pick]) for f in fill
        )
        sent = torch.arange(nq, device=dev) % 97 == 3
        kcols = tuple(torch.where(sent, -1, c).contiguous() for c in kcols)
        lane = torch.arange(nq, device=dev)
        valid = (lane < nq - 12345) & ~fpset.all_sentinel(kcols)
        got = tiles.member_block(tcols, kcols, valid)
        want = tiles.member_block_plain(tcols, kcols, valid)
        shared["flush"] = (tcols, kcols, valid, got[0])
        err = 0
        for g, w, what in zip(got, want, ("member", "resolved")):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"K1 {what}: {int((g != w).sum())} lanes differ"
                )
            err = max(err, int((g.int() - w.int()).abs().max()))
        # the bytes this data needs: keys, valid, both flags, and K
        # table words per probed slot (a lane stops at its key or at
        # the first empty slot); and the distinct 32-byte sectors of
        # the table those probes touch, per lane: slot s lies in sector
        # s >> 2 of the slot-major table, and in sector s >> 3 of each
        # of K separate columns (probe offsets only grow, so a lane's
        # sectors change or repeat, never return)
        h = fpset.slot_hash(kcols)
        probes = torch.zeros(nq, dtype=torch.int64, device=dev)
        sectors = torch.zeros(nq, dtype=torch.int64, device=dev)
        col_sectors = torch.zeros(nq, dtype=torch.int64, device=dev)
        prev = torch.full((nq,), -1, dtype=torch.int64, device=dev)
        prev_col = prev.clone()
        live = valid.clone()
        for r in range(tiles.TILE_R):
            s = (h + (r * (r + 1) >> 1)) & (cap - 1)
            sv = tuple(c[s] for c in tcols)
            probes += live.long()
            sectors += (live & (s >> 2 != prev)).long()
            col_sectors += (live & (s >> 3 != prev_col)).long() * k
            prev = torch.where(live, s >> 2, prev)
            prev_col = torch.where(live, s >> 3, prev_col)
            stop = fpset.all_sentinel(sv) | (
                (sv[0] == kcols[0]) & (sv[1] == kcols[1])
            )
            live = live & ~stop
        n_probes = int(probes.sum())
        n_sectors, n_col_sectors = int(sectors.sum()), int(col_sectors.sum())
        nbytes = nq * (k * 4 + 1 + 2) + n_probes * k * 4
        # slot hash ~10 ops a column, ~2 + 5K a probe
        ops = nq * 10 * k + n_probes * (2 + 5 * k)
        flags = torch.empty((2, nq), dtype=torch.bool, device=dev)
        args = tiles.member_block_args(tcols, kcols, valid, flags[0],
                                       flags[1], tiles.TILE_R)
        record["member_block"] = dict(
            ms=_time_ms(
                torch, lambda: tiles.member_block(tcols, kcols, valid), 50
            ),
            device_ms=_time_ms(torch, lambda: kernels.launch(*args), 100),
            plain_ms=_time_ms(
                torch,
                lambda: tiles.member_block_plain(tcols, kcols, valid), 5,
            ),
            max_abs_err=err, bytes=nbytes, bound=_bound(nbytes, ops),
            sectors=n_sectors,
            # the random sectors alone at the memory rate, and the
            # streamed lane bytes beside them
            sector_floor_ms=(n_sectors * 32 + nq * (k * 4 + 3))
            / HBM_BYTES_PER_S * 1e3,
        )
        return (
            f"equal at cap=2^26 (16M keys, slot-major), nq={nq}: "
            f"{int(got[0].sum())} members, {int((~got[1]).sum())} "
            f"unresolved, {n_probes / max(int(valid.sum()), 1):.3f} "
            f"probes/valid lane, {n_probes} probes = {n_probes * k * 4} B "
            f"of table words in {n_sectors} random 32-byte sectors "
            f"({n_col_sectors} as K separate columns); "
            f"{record['member_block']}"
        )

    _phase("2b K1 member_block vs plain", k1, failures)
    torch.cuda.empty_cache()

    def k3():
        # the tiered path's widest eviction: a 2^25-slot table, half
        # occupied, generations 0-6 on the occupied slots, cutoff 3
        cap, k = TIERED_TCAP, 2
        n = cap + 1
        empty = torch.rand(n, device=dev, generator=gen) < 0.5
        empty[cap] = True
        tcols = fpset.slot_major(
            tuple(torch.where(empty, -1, rand_i32(n)) for _ in range(k))
        )
        g = torch.randint(0, 7, (n,), dtype=torch.int32, device=dev,
                          generator=gen)
        g = torch.where(empty, 0, g)
        lane = torch.arange(n, device=dev)
        cold = ~fpset.all_sentinel(tcols) & (lane < cap) & (g >= 1) & (g <= 3)
        got = tiles.sieve_mask_planes(tcols, g, cold)
        want = tiles.sieve_mask_planes_plain(tcols, g, cold)
        err = 0
        for i, (a, b) in enumerate(zip(got[0] + got[1] + (got[2],),
                                       want[0] + want[1] + (want[2],))):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"K3 plane {i}: {int((a != b).sum())} slots differ"
                )
            err = max(err, int((a.long() - b.long()).abs().max()))
        # per slot: K words, gen and the cold byte in; 2K words and gen
        # out; one select per output word
        nbytes = n * (4 * k + 4 + 1) + n * (8 * k + 4)
        ops = n * (2 * k + 1)
        out = torch.empty((2 * k + 1, n), dtype=torch.int32, device=dev)
        args = tiles.sieve_mask_args(tcols, g, cold, out)
        record["sieve_mask"] = dict(
            ms=_time_ms(
                torch, lambda: tiles.sieve_mask_planes(tcols, g, cold), 50
            ),
            device_ms=_time_ms(torch, lambda: kernels.launch(*args), 50),
            plain_ms=_time_ms(
                torch,
                lambda: tiles.sieve_mask_planes_plain(tcols, g, cold), 10,
            ),
            max_abs_err=err, bytes=nbytes, bound=_bound(nbytes, ops),
        )
        return (
            f"equal on all {2 * k + 1} planes at {n} slots (slot-major "
            f"table), K={k}, "
            f"{int(cold.sum())} cold; {record['sieve_mask']}"
        )

    _phase("2c K3 sieve_mask vs plain", k3, failures)
    torch.cuda.empty_cache()

    # ---- 2d: H1, the insert tail, against its plain chunk loop
    def tail_pair(tcols, ckeys, cids, npend, cw, n_ids,
                  max_probes=fpset.MAX_PROBES):
        """H1 (a raw launch on the wrapper's arguments) and the plain
        loop on two copies of ``tcols``: is_new, the stats and the table
        slot for slot (slot cap is the plain loop's trash row) must be
        equal and the bids left unclaimed.  Returns H1's copy of the
        table, is_new and its four stats (probe rounds, failed lanes,
        grid rounds, grid barriers)."""
        cap = tcols[0].shape[0] - 1
        ta, tb = fpset.slot_major(tcols), fpset.slot_major(tcols)
        ca, cb = fpset.new_claims(cap, dev), fpset.new_claims(cap, dev)
        npd = torch.full((), npend, dtype=torch.int64, device=dev)
        is_new = torch.zeros((n_ids + 1,), dtype=torch.bool, device=dev)
        st = torch.zeros((4,), dtype=torch.int64, device=dev)
        kernels.launch(*fpset.insert_tail_args(
            ta, ckeys, cids, npd, cw, ca, is_new,
            torch.empty((2, len(ckeys) + 2, cw), dtype=torch.int32,
                        device=dev),
            torch.empty((2,), dtype=torch.int32, device=dev), st,
            max_probes))
        gb = fpset.insert_tail_plain(tb, ckeys, cids, npd, cw, cb, n_ids,
                                     max_probes)
        what = []
        if not torch.equal(is_new[:n_ids], gb[0][:n_ids]):
            what.append("is_new")
        if not torch.equal(st[:2], gb[1]):
            what.append(f"stats {st.tolist()} vs {gb[1].tolist()}")
        diff = sum(int((a[:cap] != b[:cap]).sum()) for a, b in zip(ta, tb))
        if diff:
            what.append(f"{diff} table words")
        if not torch.equal(ca, fpset.new_claims(cap, dev)):
            what.append("claims left claimed")
        if what:
            raise AssertionError("H1 vs plain: " + ", ".join(what))
        return ta, is_new[:n_ids], st.tolist()

    def filled(cap, k, n):
        """A slot-major table holding ``n`` random keys (plain insert in
        2^22-key batches) and the keys."""
        tcols = fpset.empty_cols(cap, k, dev)
        claims = fpset.new_claims(cap, dev)
        keys = tuple(rand_i32(n) for _ in range(k))
        for base in range(0, n, 1 << 22):
            ks = tuple(c[base: base + (1 << 22)] for c in keys)
            _n, tcols, pending, _r = fpset.probe_insert(
                tcols, ks, ~fpset.all_sentinel(ks), claims=claims
            )
            if pending.any():
                raise AssertionError("plain insert left lanes pending")
        return tcols, keys

    def probe_work(tcols, ckeys, npend):
        """The probes the survivors need in the final table (a lane's
        resolution round + 1; 64 for a failure) and the distinct random
        32-byte sectors they touch in the slot-major table."""
        cap, k = tcols[0].shape[0] - 1, len(tcols)
        keys = tuple(c[:npend] for c in ckeys)
        h = fpset.slot_hash(keys)
        probes = torch.zeros(npend, dtype=torch.int64, device=dev)
        sectors = torch.zeros_like(probes)
        prev = torch.full_like(probes, -1)
        live = torch.ones(npend, dtype=torch.bool, device=dev)
        for r in range(fpset.MAX_PROBES):
            s = (h + (r * (r + 1) >> 1)) & (cap - 1)
            sec = (s * k) >> 3  # 32 B = 8 words
            probes += live.long()
            sectors += (live & (sec != prev)).long()
            prev = torch.where(live, sec, prev)
            hit = tcols[0][s] == keys[0]
            for a, b in zip(tcols[1:], keys[1:]):
                hit = hit & (a[s] == b)
            live = live & ~hit
            if not bool(live.any()):
                break
        return int(probes.sum()), int(sectors.sum())

    def h1():
        notes = []
        # (a) phase 2b's scaled flush: K1's survivors of the 2.2M-lane
        # accumulator on the 2^26-slot table holding 16M keys
        tcols, kcols, valid, member = shared.pop("flush")
        nq, k = kcols[0].shape[0], len(kcols)
        lane = torch.arange(nq, dtype=torch.int32, device=dev)
        surv = valid & ~member
        ccols, _ = compact_by_flag(~surv, (*kcols, lane))
        ckeys, cids = ccols[:k], ccols[k]
        npend = int(surv.sum())
        cw = max(nq // 4, min(nq, fpset.MIN_STAGE))
        ta, is_new, st = tail_pair(tcols, ckeys, cids, npend, cw, nq)
        n_new = int(is_new.sum())
        probes, sectors = probe_work(ta, ckeys, npend)
        notes.append(
            f"scaled flush: {npend} survivors of {nq} lanes, {n_new} new, "
            f"{st[0]} rounds in {-(-npend // cw)} chunks ({st[2]} grid "
            f"rounds, {st[0] - st[2]} tail rounds, {st[3]} grid "
            f"barriers; tail width {fpset.H1_TAIL}), {probes} probes in "
            f"{sectors} random sectors"
        )
        # timing on a table restored before each call
        snap = fpset.slot_major(tcols)
        work = fpset.slot_major(tcols)
        claims = fpset.new_claims(tcols[0].shape[0] - 1, dev)
        npd = torch.full((), npend, dtype=torch.int64, device=dev)

        def restore():
            for a, b in zip(work, snap):  # views: writes reach the buffer
                a.copy_(b)

        out = (torch.zeros(nq + 1, dtype=torch.bool, device=dev),
               torch.empty((2, k + 2, cw), dtype=torch.int32, device=dev),
               torch.empty(2, dtype=torch.int32, device=dev),
               torch.empty(4, dtype=torch.int64, device=dev))
        args = fpset.insert_tail_args(work, ckeys, cids, npd, cw, claims,
                                      *out)

        def raw_setup():
            restore()
            out[0].zero_()

        nbytes = npend * (4 * k + 4) + probes * 4 * k + n_new * (4 * k + 1)
        # slot hash ~10 ops a column, ~2 + 5K a probe
        ops = npend * 10 * k + probes * (2 + 5 * k)
        def wrapped():
            fpset.insert_tail(work, ckeys, cids, npd, cw, claims, nq)

        def raw():
            kernels.launch(*args)

        # wrapper and raw launches in turns (wrapper, raw, raw, wrapper)
        t = [_time_each(torch, restore, wrapped, 10),
             _time_each(torch, raw_setup, raw, 10),
             _time_each(torch, raw_setup, raw, 10),
             _time_each(torch, restore, wrapped, 10)]
        record["insert_tail"] = dict(
            ms=(t[0] + t[3]) / 2, device_ms=(t[1] + t[2]) / 2, turns=t,
            plain_ms=_time_each(
                torch, restore, lambda: fpset.insert_tail_plain(
                    work, ckeys, cids, npd, cw, claims, nq), 3),
            max_abs_err=0, bytes=nbytes, bound=_bound(nbytes, ops),
            sectors=sectors,
            sector_floor_ms=(sectors * 32 + npend * (4 * k + 4))
            / HBM_BYTES_PER_S * 1e3,
        )
        # the timed calls ran on restored tables: the last one left H1's
        # table
        if not all(torch.equal(a[:-1], b[:-1]) for a, b in zip(work, ta)):
            raise AssertionError("a timed call did not start from the table")
        del tcols, kcols, valid, member, ta, snap, work
        torch.cuda.empty_cache()
        # (b) one chunk of 2^20 lanes, each key eight times: min lane wins
        n = 1 << 20
        base = tuple(rand_i32(n // 8) for _ in range(2))
        perm = torch.randperm(n, device=dev, generator=gen)
        keys = tuple(c.repeat(8)[perm].contiguous() for c in base)
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        _t, is_new, st = tail_pair(fpset.empty_cols(1 << 22, 2, dev), keys,
                                   ids, n, n, n)
        first = torch.full((n // 8,), n, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, perm % (n // 8), ids.long(), "amin")
        if not torch.equal(torch.nonzero(is_new).flatten().sort().values,
                           first.sort().values):
            raise AssertionError("duplicates: a winner is not the min lane")
        notes.append(f"duplicates: {int(is_new.sum())} winners of {n} "
                     f"lanes, stats {st}")
        # (c) a 2^22-slot table filled to load 1/2 by the insert
        cap, n = 1 << 22, 1 << 18
        tcols, _ = filled(cap, 2, cap // 2 - n)
        keys = tuple(rand_i32(n) for _ in range(2))
        _t, is_new, st = tail_pair(tcols, keys, torch.arange(
            n, dtype=torch.int32, device=dev), n, n // 4, n)
        if not 2 <= st[2] < st[0]:
            raise AssertionError(f"load 1/2: no tail after grid rounds {st}")
        notes.append(f"load 1/2: {int(is_new.sum())} new, stats {st}")
        # (d) K = 3: half the survivors already in the table
        cap, n = 1 << 22, 1 << 19
        tcols, fill = filled(cap, 3, 1 << 20)
        pick = torch.randint(0, 1 << 20, (n,), device=dev, generator=gen)
        old = torch.rand(n, device=dev, generator=gen) < 0.5
        keys = tuple(torch.where(old, f[pick], rand_i32(n)) for f in fill)
        _t, is_new, st = tail_pair(tcols, keys, torch.arange(
            n, dtype=torch.int32, device=dev), n, n // 4, n)
        notes.append(f"K=3: {int(is_new.sum())} new of {n}, stats {st}")
        del tcols, fill
        torch.cuda.empty_cache()
        # (f) the other paths of H1's control flow, each in one chunk:
        # (log2 cap, keys filled, lanes, max_probes, the check of the
        # kernel's (rounds, failed, grid rounds, barriers))
        T = fpset.H1_TAIL
        paths = {
            "crosses T in round 0": (
                18, 0, 20_000, 64,
                lambda s: s[2] == 1 and s[0] > 1 and s[3] == 5),
            "never reaches T": (
                17, 1 << 16, 40_000, 2,
                lambda s: s[0] == s[2] == 2 and s[1] > T),
            "max_probes 4 in the grid": (
                15, 1 << 14, 12_000, 4, lambda s: s[0] == 4 and s[1] > 0),
            "max_probes 4 in the tail": (
                15, 1 << 14, 1500, 4,
                lambda s: s[2] == 0 and s[0] == 4 and s[1] > 0),
            "npend 0": (12, 1000, 0, 64, lambda s: s == [0, 0, 0, 0]),
            "npend 1": (12, 1000, 1, 64,
                        lambda s: s[0] >= 1 and s[1:] == [0, 0, 0]),
        }
        for what, (cl, n_fill, n, mp, ok) in paths.items():
            tcols, _ = filled(1 << cl, 2, n_fill)
            m = max(n, 1)
            _t, _n, st = tail_pair(tcols, (rand_i32(m), rand_i32(m)),
                                   torch.arange(m, dtype=torch.int32,
                                                device=dev), n, m, m, mp)
            if not ok(st):
                raise AssertionError(f"{what}: path not taken, stats {st}")
            notes.append(f"{what}: stats {st}")
        # (e) a rehash of a 2^25-slot table at load 1/2 into 2^26 slots:
        # rehash_cols (H1 on the card) against its chunks through the
        # plain loop
        old_t, _ = filled(1 << 25, 2, 1 << 24)
        t0 = time.time()
        got, failed = fpset.rehash_cols(old_t, fpset.empty_cols(1 << 26, 2,
                                                                dev))
        torch.cuda.synchronize()
        t_h1 = time.time() - t0
        want = fpset.empty_cols(1 << 26, 2, dev)
        claims = fpset.new_claims(1 << 26, dev)
        t0 = time.time()
        for b0 in range(0, 1 << 25, 1 << 20):
            ks = tuple(c[b0: b0 + (1 << 20)] for c in old_t)
            occ = ~fpset.all_sentinel(ks)
            cc, _ = compact_by_flag(~occ, (*ks, torch.arange(
                1 << 20, dtype=torch.int32, device=dev)))
            fpset.insert_tail_plain(want, cc[:2], cc[2], occ.sum(), 1 << 20,
                                    claims, 1 << 20)
        torch.cuda.synchronize()
        t_plain = time.time() - t0
        diff = sum(int((a[:-1] != b[:-1]).sum()) for a, b in zip(got, want))
        if diff or int(failed):
            raise AssertionError(f"rehash: {diff} words differ, {int(failed)}"
                                 " failed")
        notes.append(f"rehash 2^25 -> 2^26 (16.8M keys): equal, {t_h1:.3f}s"
                     f" through H1, {t_plain:.3f}s through the plain loop")
        return "equal: " + "; ".join(notes) + f"; {record['insert_tail']}"

    _phase("2d H1 insert_tail vs plain", h1, failures)
    shared.clear()
    torch.cuda.empty_cache()

    # ---- 2e: K2, K1, H1 and K3 at the other specs' shapes, each on a
    # flush (and table) that the spec's model makes on the card
    spec_shapes = []  # one record per (kernel, shape)

    def spec_model(spec, constants):
        model, _c = registry.COMPILED[spec](
            cfgmod.TLCConfig(constants=dict(constants)))
        return model

    def spec_flush(spec, constants, pins=None, level=None, model=None):
        """A checker stopped at the end of BFS level ``level`` (its
        table holds exactly levels 1..level, whose sizes ``pins``
        gives; None: the whole run) and
        the lanes of the flush that would come next: the first window of
        the frontier (the widest level when ``level`` is None), expanded
        and keyed as the engine does.  Returns (checker, packed, valid,
        key cols, window rows).  ``model`` replaces the registry's."""
        model = model or spec_model(spec, constants)
        if level is None:
            ck = DeviceChecker(model, invariants=())
            sizes = ck.run().level_sizes
            level = max(range(1, len(sizes) + 1),
                        key=lambda i: sizes[i - 1])
        else:
            ck = DeviceChecker(model, invariants=(),
                               max_states=sum(pins[:level]))
            sizes = ck.run().level_sizes
            if sizes != pins[:level]:
                raise AssertionError(f"{spec} levels {sizes} != pins")
        base = sum(sizes[: level - 1])
        n = min(sizes[level - 1], ck.G)
        _st, valid, packed, kcols = ck._lanes(ck._rows[base: base + n])
        return ck, packed, valid.reshape(-1), kcols, n

    # these inputs fit the card's 50 MB L2 cache, where back-to-back
    # launches find them: each raw launch is timed twice, cold (a 256 MB
    # fill evicts the L2 before it: the time the byte bound speaks of)
    # and warm (back to back, as a flush finds the keys K2 just wrote)
    l2_evict = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def cold_ms(fn, iters, setup=None):
        def before():
            if setup is not None:
                setup()
            l2_evict.fill_(1)
        return _time_each(torch, before, fn, iters)

    def spec_record(kernel, shape, got_ms, warm_ms, plain_ms, nbytes, ops,
                    **extra):
        bound = _bound(nbytes, ops)
        spec_shapes.append(dict(kernel=kernel, shape=shape,
                                device_ms=got_ms, warm_ms=warm_ms,
                                plain_ms=plain_ms, bound_ms=bound[0],
                                bound_by=bound[1], **extra))
        return (f"{kernel} {shape}: {got_ms:.5f} ms raw with a cold L2 "
                f"({warm_ms:.5f} warm), plain {plain_ms:.4f} ms, bound "
                f"{bound[0]:.5f} ms ({bound[1]})")

    def spec_k2(ck, packed, valid, kcols, shape):
        """K2 against its plain version on the window, then timed."""
        ks, nc = ck.keys, packed.shape[0]
        want = tiles.key_plane_plain(ks, packed, valid)
        for i, (g, w) in enumerate(zip(kcols, want)):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"K2 {shape} column {i}: {int((g != w).sum())} differ")
        out = torch.empty((ks.ncols, nc), dtype=torch.int32, device=dev)
        args = tiles.key_plane_args(ks, packed, valid, out)
        ops = nc * (ks.W * (5 + 6 * ks.ncols) + 13 * ks.ncols) \
            if not ks.exact else nc * ks.ncols
        return spec_record(
            "key_plane", shape,
            cold_ms(lambda: kernels.launch(*args), 50),
            _time_ms(torch, lambda: kernels.launch(*args), 100),
            _time_ms(torch, lambda: tiles.key_plane_plain(ks, packed, valid),
                     5),
            nc * (ks.W * 4 + 1 + ks.ncols * 4), ops, nc=nc)

    def probe_count(tcols, kcols, valid, rounds):
        """The probes K1 makes on this data: a lane stops at its key or
        at the first empty slot, within ``rounds``."""
        cap = tcols[0].shape[0] - 1
        h = fpset.slot_hash(kcols)
        probes = torch.zeros_like(h)
        live = valid.clone()
        for r in range(rounds):
            s = (h + (r * (r + 1) >> 1)) & (cap - 1)
            sv = tuple(c[s] for c in tcols)
            probes += live.long()
            hit = sv[0] == kcols[0]
            for a, b in zip(sv[1:], kcols[1:]):
                hit = hit & (a == b)
            live = live & ~(fpset.all_sentinel(sv) | hit)
        return int(probes.sum())

    def spec_k1_h1(ck, valid, kcols, what):
        """K1 on a flush's key plane against the checker's table, then H1
        on K1's survivors, each against its plain version and timed;
        ``what`` names the shape.  Returns two notes."""
        notes = []
        tcols, k, nq = ck._tcols, ck.K, kcols[0].shape[0]
        cap = tcols[0].shape[0] - 1
        rounds = max(tiles.TILE_R, fpset.DENSE_ROUNDS)
        vl = valid & ~fpset.all_sentinel(kcols)
        got = tiles.member_block(tcols, kcols, vl, rounds)
        want = tiles.member_block_plain(tcols, kcols, vl, rounds)
        for g, w, part in zip(got, want, ("member", "resolved")):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"K1 {what} {part}: {int((g != w).sum())} lanes differ")
        n_probes = probe_count(tcols, kcols, vl, rounds)
        flags = [torch.empty((nq,), dtype=torch.bool, device=dev)
                 for _ in range(2)]
        args = tiles.member_block_args(tcols, kcols, vl, *flags, rounds)
        notes.append(spec_record(
            "member_block", f"{what}, nq={nq} on a 2^{cap.bit_length() - 1}"
            f"-slot table holding {ck._nv} keys",
            cold_ms(lambda: kernels.launch(*args), 50),
            _time_ms(torch, lambda: kernels.launch(*args), 100),
            _time_ms(torch, lambda: tiles.member_block_plain(
                tcols, kcols, vl, rounds), 5),
            nq * (k * 4 + 1 + 2) + n_probes * k * 4,
            nq * 10 * k + n_probes * (2 + 5 * k), nq=nq,
            members=int(got[0].sum())))
        # H1 on K1's survivors, against the plain loop, then timed on a
        # table restored before each launch
        surv = vl & ~got[0]
        lane = torch.arange(nq, dtype=torch.int32, device=dev)
        ccols, _ = compact_by_flag(~surv, (*kcols, lane))
        ckeys, cids = ccols[:k], ccols[k]
        npend = int(surv.sum())
        cw = max(nq // 4, min(nq, fpset.MIN_STAGE))
        ta, is_new, st = tail_pair(tcols, ckeys, cids, npend, cw, nq)
        n_new = int(is_new.sum())
        probes, _sectors = probe_work(ta, ckeys, npend)
        del ta
        snap, work = fpset.slot_major(tcols), fpset.slot_major(tcols)
        claims = fpset.new_claims(cap, dev)
        npd = torch.full((), npend, dtype=torch.int64, device=dev)
        out = (torch.zeros(nq + 1, dtype=torch.bool, device=dev),
               torch.empty((2, k + 2, cw), dtype=torch.int32, device=dev),
               torch.empty(2, dtype=torch.int32, device=dev),
               torch.empty(4, dtype=torch.int64, device=dev))
        args = fpset.insert_tail_args(work, ckeys, cids, npd, cw, claims,
                                      *out)

        def restore():
            for a, b in zip(work, snap):
                a.copy_(b)
            out[0].zero_()

        notes.append(spec_record(
            "insert_tail", f"{what}, {npend} survivors of {nq} lanes, {n_new} "
            f"new, {st[0]} rounds",
            cold_ms(lambda: kernels.launch(*args), 10, restore),
            _time_each(torch, restore, lambda: kernels.launch(*args), 10),
            _time_each(torch, restore, lambda: fpset.insert_tail_plain(
                work, ckeys, cids, npd, cw, claims, nq), 3),
            npend * (4 * k + 4) + probes * 4 * k + n_new * (4 * k + 1),
            npend * 10 * k + probes * (2 + 5 * k), npend=npend))
        del work, snap, claims, out
        return notes

    def k_spec():
        notes = []
        # K2 at w = 1: the shipped subscription cfg's widest window
        consts = {k: int(v) for k, v in cfgmod.load(
            os.path.join(SPECS, "subscription.cfg")).constants.items()}
        ck, packed, valid, kcols, n = spec_flush("subscription", consts)
        notes.append(spec_k2(ck, packed, valid, kcols,
                             f"exact w=1 K=2 ({n} rows x A={ck.A})"))
        # K2 at w = 5: geo_hashed's flush after level 12
        _s, consts, _m, pins = SPEC_SCALED["geo_hashed"]
        ck, packed, valid, kcols, n = spec_flush("georeplication", consts,
                                                 pins, 12)
        notes.append(spec_k2(ck, packed, valid, kcols,
                             f"hashed w=5 K=2 ({n} rows x A={ck.A})"))
        del ck, packed, valid, kcols
        # K2 at w = 3, K1 and H1 at K = 3: geo_exact's flush after level
        # 20, on its table then (levels 1-20)
        _s, consts, _m, pins = SPEC_SCALED["geo_exact"]
        ck, packed, valid, kcols, n = spec_flush("georeplication", consts,
                                                 pins, 20)
        notes.append(spec_k2(ck, packed, valid, kcols,
                             f"exact w=3 K=3 ({n} rows x A={ck.A})"))
        notes += spec_k1_h1(ck, valid, kcols, "K=3")
        tcols, k = ck._tcols, ck.K
        cap = tcols[0].shape[0] - 1
        # K3 at K = 3 on the same table (the tiered path's shape in phase
        # 17): generations 0-6 on the occupied slots, cutoff 3
        ns = cap + 1
        occ = ~fpset.all_sentinel(tcols) & (
            torch.arange(ns, device=dev) < cap)
        g = torch.where(occ, torch.randint(0, 7, (ns,), dtype=torch.int32,
                                           device=dev, generator=gen), 0)
        cold = occ & (g >= 1) & (g <= 3)
        got = tiles.sieve_mask_planes(tcols, g, cold)
        want = tiles.sieve_mask_planes_plain(tcols, g, cold)
        for i, (a, b) in enumerate(zip(got[0] + got[1] + (got[2],),
                                       want[0] + want[1] + (want[2],))):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"K3 K=3 plane {i}: {int((a != b).sum())} slots differ")
        del got, want
        out = torch.empty((2 * k + 1, ns), dtype=torch.int32, device=dev)
        args = tiles.sieve_mask_args(tcols, g, cold, out)
        notes.append(spec_record(
            "sieve_mask", f"K=3 at {ns} slots, {int(cold.sum())} cold",
            cold_ms(lambda: kernels.launch(*args), 20),
            _time_ms(torch, lambda: kernels.launch(*args), 50),
            _time_ms(torch, lambda: tiles.sieve_mask_planes_plain(
                tcols, g, cold), 5),
            ns * (4 * k + 4 + 1) + ns * (8 * k + 4), ns * (2 * k + 1),
            slots=ns))
        return "equal: " + "; ".join(notes)

    _phase("2e K2/K1/H1/K3 at the other specs' shapes vs plain", k_spec,
           failures)
    torch.cuda.empty_cache()

    # ---- 3-6: the main path, launch counters zeroed around it
    kernels.reset_launches()
    per_phase = {}

    def counted(name, fn):
        before = dict(kernels.LAUNCHES)

        def run():
            out = fn()
            per_phase[name] = {
                k: v - before[k] for k, v in kernels.LAUNCHES.items()
            }
            return f"{out}; launches {per_phase[name]}"

        _phase(name, run, failures)

    def shipped():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                           "-config", os.path.join(SPECS, "compaction.cfg")])
        out = buf.getvalue()
        m = re.search(r"(\d+) distinct states found, search depth "
                      r"\(diameter\) (\d+)", out)
        got = (rc, m and (int(m.group(1)), int(m.group(2))))
        if got != (0, (45198, 20)) or "Error" in out:
            raise AssertionError(f"cli check: rc/counts {got}\n{out}")
        return f"cli check: 45198 states, diameter 20, rc 0 ({out.splitlines()[-1]})"

    counted("3 shipped cfg (cli)", shipped)

    # untiered results the tiered runs of phases 9 and 11 must equal
    untiered = {}
    full_cfg = dataclasses.replace(
        pyeval.SHIPPED_CFG, model_producer=True, retain_null_key=False
    )

    def full():
        ck = DeviceChecker(CompactionModel(full_cfg), invariants=())
        r = ck.run()
        got = (r.distinct_states, r.diameter, r.violation, r.deadlock)
        if got != (253361, 23, None, False):
            raise AssertionError(f"got {got}")
        untiered["full"] = (r.level_sizes, ck.merged_rows(),
                            *ck.merged_logs())
        return f"253361 states, diameter 23 ({r.states_per_sec:.0f} st/s)"

    counted("4 producer on, RetainNullKey=FALSE", full)

    def trace_ok(c, inv, trace, actions):
        """The trace starts at Init, replays step by step on the oracle,
        and only its last state violates ``inv``."""
        ok = pyeval.INVARIANTS[inv]
        if trace[0] not in set(pyeval.initial_states(c)):
            raise AssertionError(f"{inv}: trace starts off Init")
        for s, act, t in zip(trace, actions, trace[1:]):
            if not any(
                pyeval.ACTION_NAMES[a] == act and u == t
                for a, u in pyeval.successors(c, s)
            ):
                raise AssertionError(f"{inv}: {act} does not replay")
            if not ok(c, s):
                raise AssertionError(f"{inv}: violated before the end")
        if ok(c, trace[-1]):
            raise AssertionError(f"{inv}: last state does not violate")

    def check_trace(c, inv, depth, r):
        """The run found ``inv`` violated at ``depth`` with a trace that
        replays step by step on the oracle."""
        if (r.violation, r.diameter, len(r.trace or ())) != (
            inv, depth, depth
        ):
            raise AssertionError(f"{inv}: {r.violation} depth {r.diameter}")
        trace_ok(c, inv, r.trace, r.trace_actions)
        return f"{inv} length {depth} replays (gid {r.violation_gid})"

    def bugs():
        notes = []
        for inv, depth in (("CompactedLedgerLeak", 12),
                           ("DuplicateNullKeyMessage", 4)):
            c = pyeval.SHIPPED_CFG
            r = DeviceChecker(CompactionModel(c), invariants=(inv,)).run()
            notes.append(check_trace(c, inv, depth, r))
        return "; ".join(notes)

    counted("5 counterexamples", bugs)

    def scaled_cfg():
        # bench.py's scaled config: |Msgs|=64, |Keys|=8, |Values|=2, 3
        # compactions, 3 crashes, producer on (618-bit states)
        return pyeval.Constants(
            message_sent_limit=64, compaction_times_limit=3, num_keys=8,
            num_values=2, retain_null_key=True, max_crash_times=3,
            model_producer=True, model_consumer=False,
        )

    def scaled():
        torch.cuda.reset_peak_memory_stats(dev)
        ck = DeviceChecker(CompactionModel(scaled_cfg()),
                           max_states=SCALED_TOTAL + 1)
        # every sync of the run is one of the fused level's counted host
        # reads, or one of three outside the loop: the K0 self-test's at
        # the start, the layout's one upload of its constants at the
        # first pack, and the result's synchronize
        r, card_syncs = _card_syncs(torch, ck.run)
        cum, tot = [], 0
        for n in r.level_sizes:
            tot += n
            cum.append(tot)
        if cum[4:6] != [SCALED_PREV_TOTAL, SCALED_TOTAL] or r.violation:
            raise AssertionError(
                f"level totals {cum} (want ...{SCALED_PREV_TOTAL}, "
                f"{SCALED_TOTAL}), violation {r.violation}"
            )
        untiered["scaled"] = (r.level_sizes, *ck.merged_logs())
        untiered["scaled_wall"] = r.wall_s
        nv = r.distinct_states
        untiered["scaled_rows"] = ck.last_bufs["rows"][: nv * ck.W].clone()
        st = ck.last_stats
        if card_syncs > st["host_syncs"] + 3:
            raise AssertionError(
                f"{card_syncs} card syncs against {st['host_syncs']} host "
                "reads + 3"
            )
        return (
            f"level totals {cum} (level 7 partial: stop "
            f"{r.stop_reason}); {r.distinct_states} states in "
            f"{r.wall_s:.2f}s = {r.states_per_sec:.0f} st/s; host_syncs "
            f"{st['host_syncs']} ({card_syncs} card syncs in sync debug "
            f"mode), syncs_per_level {st['syncs_per_level']}, fuse_levels "
            f"{st['fuse_levels']}; table "
            f"{st['fpset_table_cap']} slots, load "
            f"{st['fpset_occupancy']:.3f}; {st['fpset_flushes']} flushes, "
            f"{st['fpset_probe_rounds']} probe rounds; device memory "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB in use, "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB peak"
        )

    counted("6 scaled cfg (618-bit, 64-bit fp)", scaled)

    launches = dict(kernels.LAUNCHES)
    print(f"[7 launches on the main path] {launches}", flush=True)
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} never launched on the main path")

    def scaled_stage():
        ck = DeviceChecker(CompactionModel(scaled_cfg()),
                           max_states=SCALED_TOTAL + 1, fuse="stage")
        r, card_syncs = _card_syncs(torch, ck.run)
        sizes, par, lan = untiered["scaled"]
        nv = r.distinct_states
        rows = untiered.pop("scaled_rows")
        if r.level_sizes != sizes:
            raise AssertionError(f"level sizes {r.level_sizes} != {sizes}")
        got_par, got_lan = ck.merged_logs()
        if not (rows.shape[0] == nv * ck.W
                and torch.equal(ck.last_bufs["rows"][: nv * ck.W], rows)
                and (got_par == par).all() and (got_lan == lan).all()):
            raise AssertionError("rows or logs differ from phase 6's")
        st = ck.last_stats
        del ck, rows
        # the two loops again in turns, on a warm allocator (phase 6 was
        # the first run on an empty one): the scaled config, then the
        # 253,361-state config (launch-bound windows), each run held
        # state for state against phase 4's
        walls = {"scaled": [("level (phase 6)", untiered["scaled_wall"]),
                            ("stage", r.wall_s)], "253361": []}
        for name, fuse in (("scaled", "level"), ("253361", "stage"),
                           ("253361", "level")):
            if name == "scaled":
                m = CompactionModel(scaled_cfg())
                kw = dict(max_states=SCALED_TOTAL + 1)
            else:
                m, kw = CompactionModel(full_cfg), dict(invariants=())
            c2 = DeviceChecker(m, fuse=fuse, **kw)
            r2 = c2.run()
            want = untiered["scaled" if name == "scaled" else "full"]
            got = ([c2.merged_rows()] if name != "scaled" else []) + list(
                c2.merged_logs())
            if r2.level_sizes != want[0] or not all(
                a.shape == b.shape and (a == b).all()
                for a, b in zip(got, want[1:])
            ):
                raise AssertionError(f"{name} {fuse}: differs")
            walls[name].append(
                (f"{fuse} ({c2.last_stats['host_syncs']} syncs)", r2.wall_s))
            del c2
        return (
            f"level totals {list(itertools.accumulate(r.level_sizes))}, "
            f"rows, parent and lane logs equal to phase 6's; "
            f"{nv} states in {r.wall_s:.2f}s = {r.states_per_sec:.0f} st/s; "
            f"host_syncs {st['host_syncs']} ({card_syncs} card syncs), "
            f"syncs_per_level {st['syncs_per_level']}; walls in turns: "
            + "; ".join(f"{k}: " + ", ".join(f"{w} {t:.4f}s" for w, t in v)
                        for k, v in walls.items())
        )

    counted("6b scaled cfg, -fuse stage, against phase 6", scaled_stage)
    torch.cuda.empty_cache()

    # ---- 8: where the time goes in the scaled run (after the counts
    # were read: this run is the profiler's, not the main path's)
    op_ms = {}  # phase -> {PyTorch op: (device ms, calls)}

    def profile(hbm_budget=None, fuse="level", phase="8", model=None,
                max_states=SCALED_TOTAL + 1):
        """One run under ``torch.profiler``: the scaled compaction
        config unless ``model`` is given."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        ck = DeviceChecker(model or CompactionModel(scaled_cfg()),
                           max_states=max_states,
                           hbm_budget=hbm_budget, fuse=fuse)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      acc_events=True) as prof:
            t = time.time()
            r = ck.run()
            torch.cuda.synchronize()
            wall = time.time() - t
        allev = prof.key_averages()
        # kernels and copies only: a CPU op's entry repeats the device
        # time of the kernels it launched
        ev = [e for e in allev if e.device_type == DeviceType.CUDA]

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        busy = sum(dev_us(e) for e in ev) / 1e6
        if busy <= 0:
            return (f"wall {wall:.2f}s; torch.profiler reported no device "
                    "time on this machine")
        top = sorted(ev, key=dev_us, reverse=True)[:6]
        # the same device time by the PyTorch op that launched it
        ops = [e for e in allev
               if e.device_type == DeviceType.CPU and dev_us(e) > 0]
        top_ops = sorted(ops, key=dev_us, reverse=True)[:8]
        op_ms[phase] = {e.key: (dev_us(e) / 1e3, e.count) for e in ops}
        ours = sum(dev_us(e) for e in ev
                   if "member_kernel" in e.key or "key_plane_kernel" in e.key)
        h1 = [e for e in ev if "insert_tail_kernel" in e.key]
        h1_ms = sum(dev_us(e) for e in h1) / 1e3
        k3 = sum(dev_us(e) for e in ev if "sieve_mask_kernel" in e.key)
        # buffer fills (torch.full/zeros), the probe's claims among them
        fills = [e for e in allev if e.key == "aten::fill_"]
        fill_ms = sum(dev_us(e) for e in fills) / 1e3
        n_fill = sum(e.count for e in fills)
        # the probe's gathers, table writes and bids (their totals over
        # the run: the model's own index ops are in the first; a table
        # write's kernel is launched by _index_put_impl_)
        probe_ops = {
            key: (sum(dev_us(e) for e in allev if e.key == key) / 1e3,
                  sum(e.count for e in allev if e.key == key))
            for key in ("aten::index", "aten::_index_put_impl_",
                        "aten::scatter_reduce_")
        }
        syncs = [e for e in allev if e.key == "aten::_local_scalar_dense"]
        n_sync = sum(e.count for e in syncs)
        sync_s = sum(e.self_cpu_time_total for e in syncs) / 1e6
        stream_syncs = sum(e.count for e in allev
                           if e.key == "cudaStreamSynchronize")
        if not ck.tiered and probe_ops["aten::scatter_reduce_"][1]:
            raise AssertionError(
                "aten::scatter_reduce_ ran in the fused scaled run: "
                f"{probe_ops['aten::scatter_reduce_']}"
            )
        spill = ""
        if ck.tiered:
            sp = ck.tstore.stats
            spill = (
                f"; host spill work: {sp.lookup_s:.2f}s of cold lookups "
                f"({sp.miss_batches} batches), {sp.transfer_s:.2f}s of "
                f"D2H + encode, {sp.blocked_s:.2f}s waited on encodes"
            )
        return (
            f"{r.distinct_states} states, wall {wall:.2f}s under the "
            f"profiler; device busy {busy:.3f}s ({busy / wall:.1%} of "
            f"wall, idle {1 - busy / wall:.1%}); K1+K2 {ours / 1e6:.4f}s "
            f"({ours / 1e6 / busy:.2%} of device time); H1 {h1_ms:.1f}ms "
            f"x{sum(e.count for e in h1)} ({h1_ms / 1e3 / busy:.2%}); K3 "
            f"{k3 / 1e6:.4f}s{spill}; host_syncs "
            f"{ck.last_stats['host_syncs']}, syncs_per_level "
            f"{ck.last_stats['syncs_per_level']}; {n_sync} .item calls "
            f"holding {sync_s:.3f}s of host time, {stream_syncs} "
            f"cudaStreamSynchronize; aten::fill_ {fill_ms:.1f}ms "
            f"x{n_fill}; gathers/scatters by op: "
            + "; ".join(f"{key} {ms:.1f}ms x{n}"
                        for key, (ms, n) in probe_ops.items())
            + "; device time by op: "
            + "; ".join(
                f"{e.key} {dev_us(e) / 1e3:.1f}ms x{e.count}"
                for e in top_ops
            )
            + "; top kernels: "
            + "; ".join(
                f"{e.key[:60]} {dev_us(e) / 1e3:.1f}ms x{e.count}"
                for e in top
            )
        )

    _phase("8 profile of the scaled run", profile, failures)
    torch.cuda.empty_cache()

    def profile_stage():
        """The stage loop under the profiler, and where its device time
        by op differs from phase 8's fused run."""
        out = profile(fuse="stage", phase="8b")
        lv, st = op_ms.get("8", {}), op_ms["8b"]
        keys = sorted(set(lv) | set(st), key=lambda k: -abs(
            lv.get(k, (0, 0))[0] - st.get(k, (0, 0))[0]))
        return out.split("; K1+K2")[0] + "; device ms by op, fused " \
            "(phase 8) minus stage: " + "; ".join(
                f"{k} {lv.get(k, (0, 0))[0] - st.get(k, (0, 0))[0]:+.1f}ms "
                f"(x{lv.get(k, (0, 0))[1]} vs x{st.get(k, (0, 0))[1]})"
                for k in keys[:10])

    _phase("8b profile of the scaled run, -fuse stage", profile_stage,
           failures)
    torch.cuda.empty_cache()

    # ---- 9-11: the tiered store, launch counters zeroed around it
    def tight_budget(ck, slack=4096):
        """A budget just above a checker shape's initial tiers, so a
        tiered run must spill."""
        est = ck._device_bytes_est(ck.TCAP0, ck.WCAP0, ck.WCAP0)
        return int(est / (1.0 - HBM_HEADROOM)) + slack

    def same_run(what, want, ck, r):
        """The tiered run's level sizes, merged rows and merged logs
        against the untiered run's."""
        sizes, *arrays = want
        got = [ck.merged_rows()] if len(arrays) == 3 else []
        got += list(ck.merged_logs())
        if r.level_sizes != sizes:
            raise AssertionError(
                f"{what}: level sizes {r.level_sizes} != {sizes}"
            )
        names = ("rows", "parent", "lane")[-len(arrays):]
        for name, a, b in zip(names, got, arrays):
            if a.shape != b.shape or not (a == b).all():
                raise AssertionError(f"{what}: merged {name} differ")
        return "/".join(names)

    def spill_note(ck):
        st = ck.last_stats
        return (
            f"{st['spill_evictions']} evictions, {st['spill_keys_evicted']} "
            f"keys evicted, {st['spill_rows_evicted']} rows spilled, "
            f"{st['spill_misses_resolved']} misses resolved "
            f"({st['spill_miss_hits']} hits), {st['spill_hot_keys']} hot, "
            f"table {st['fpset_table_cap']} slots, budget overridden "
            f"{ck._budget_overridden}"
        )

    def tiered_small():
        # the CLI's checker shape (default windows, -maxstates default)
        probe = DeviceChecker(CompactionModel(pyeval.SHIPPED_CFG),
                              max_states=200_000_000, hbm_budget="1T")
        b = tight_budget(probe)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                           "-config", os.path.join(SPECS, "compaction.cfg"),
                           "-hbm-budget", str(b)])
        out = buf.getvalue()
        m = re.search(r"(\d+) distinct states found, search depth "
                      r"\(diameter\) (\d+)", out)
        got = (rc, m and (int(m.group(1)), int(m.group(2))))
        spill = [ln for ln in out.splitlines() if ln.startswith("Spill (")]
        if got != (0, (45198, 20)) or "Error" in out or not spill:
            raise AssertionError(f"cli check -hbm-budget {b}: {got}\n{out}")
        # the 253,361-state config with windows small enough to evict
        kw = dict(invariants=(), sub_batch=4096, visited_cap=1 << 12)
        b2 = tight_budget(DeviceChecker(CompactionModel(full_cfg),
                                        hbm_budget="1T", **kw))
        ck = DeviceChecker(CompactionModel(full_cfg), hbm_budget=b2, **kw)
        r = ck.run()
        if (r.distinct_states, r.diameter) != (253361, 23):
            raise AssertionError(f"got {r.distinct_states}/{r.diameter}")
        if not (ck.last_stats["spill_evictions"] >= 1
                and ck.last_stats["spill_rows_evicted"] > 0
                and ck.last_stats["spill_misses_resolved"] > 0):
            raise AssertionError(
                f"the budget forced no spill: {spill_note(ck)}"
            )
        same = same_run("253361", untiered["full"], ck, r)
        return (
            f"cli check -hbm-budget {b}: 45198 states, diameter 20, rc 0 "
            f"({spill[0]}); 253361 states, diameter 23 at budget {b2}: "
            f"{same} equal to the untiered run; {spill_note(ck)}"
        )

    def tiered_leak():
        inv = "CompactedLedgerLeak"
        kw = dict(invariants=(inv,), sub_batch=512, visited_cap=1 << 11)
        c = pyeval.SHIPPED_CFG
        b = tight_budget(DeviceChecker(CompactionModel(c), hbm_budget="1T",
                                       **kw))
        ck = DeviceChecker(CompactionModel(c), hbm_budget=b, **kw)
        r = ck.run()
        if r.violation_gid != 23329:
            raise AssertionError(f"{inv}: gid {r.violation_gid}")
        return (f"budget {b}: {check_trace(c, inv, 12, r)}; trace from "
                f"merged logs (row_base {ck._row_base}); {spill_note(ck)}")

    def budget_for_table(m, tcap, **kw):
        """The largest budget whose hot-table ceiling is ``tcap`` slots,
        by bisection on the checker's own tier arithmetic (the ceilings
        grow with the budget)."""
        def ceiling(b):
            return DeviceChecker(m, hbm_budget=b, **kw).TCAP_MAX

        probe = DeviceChecker(m, hbm_budget="1T", **kw)
        w = probe.WCAP_MAX
        lo = tight_budget(probe, slack=0)
        hi = int(probe._device_bytes_est(2 * tcap, w, w)
                 / (1.0 - HBM_HEADROOM)) + 1
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if ceiling(mid) <= tcap:
                lo = mid
            else:
                hi = mid
        return lo

    def tiered_scaled():
        m = CompactionModel(scaled_cfg())
        b = budget_for_table(m, TIERED_TCAP, max_states=SCALED_TOTAL + 1)
        ck = DeviceChecker(m, max_states=SCALED_TOTAL + 1, hbm_budget=b)
        if ck.TCAP_MAX != TIERED_TCAP:
            raise AssertionError(f"budget {b}: table ceiling {ck.TCAP_MAX}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        k3_before = kernels.LAUNCHES["sieve_mask"]
        r = ck.run()
        st = ck.last_stats
        if st["spill_evictions"] < 1 or r.violation:
            raise AssertionError(f"{spill_note(ck)}; {r.violation}")
        same = same_run("scaled", untiered["scaled"], ck, r)
        cum = list(itertools.accumulate(r.level_sizes))
        tiered_budget.append(b)
        return (
            f"budget {b} ({budget_fmt(b)}), table ceiling {TIERED_TCAP}: "
            f"level totals {cum} and merged {same} equal to phase 6's; "
            f"{spill_note(ck)}; K3 launches "
            f"{kernels.LAUNCHES['sieve_mask'] - k3_before}; "
            f"{r.distinct_states} states in {r.wall_s:.2f}s = "
            f"{r.states_per_sec:.0f} st/s; spill transfer "
            f"{st['spill_transfer_s']}s, lookups "
            f"{ck.tstore.stats.lookup_s:.2f}s, encoded "
            f"{st['spill_bytes_comp']} of {st['spill_bytes_raw']} B; peak "
            f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
            f" GiB against the budget's {b / 2**30:.2f} GiB"
        )

    tiered_budget = []
    kernels.reset_launches()
    counted("9 tiered: shipped cfg (cli) + 253361-state config",
            tiered_small)
    counted("10 tiered: CompactedLedgerLeak", tiered_leak)
    counted("11 tiered: scaled cfg, hot table <= 2^25 slots", tiered_scaled)
    tiered_launches = dict(kernels.LAUNCHES)
    print(f"[12 launches on the tiered path] {tiered_launches}", flush=True)
    for name in TIERED_PATH_KERNELS:
        if tiered_launches[name] <= 0:
            failures.append(
                f"kernel {name} never launched on the tiered path"
            )
    # ---- 13: where the time goes in the tiered scaled run (after the
    # counts were read)
    if tiered_budget:
        _phase("13 profile of the tiered scaled run",
               lambda: profile(tiered_budget[0], phase="13"), failures)

    # ---- 14-17: the other three specs (the spec path), launch counters
    # zeroed around them: the shipped cfgs, the seeded bugs and the
    # scaled bindings through the CLI, the checker in both loops, and
    # geo_exact tiered
    spec_dir = os.path.join(ROOT, "build", "spec_cfgs")

    def spec_cfg(spec, constants, tag):
        """The shipped cfg of ``spec``, or a copy of it with
        ``constants`` bound, written under build/spec_cfgs."""
        path = os.path.join(SPECS, f"{spec}.cfg")
        if not constants:
            return path
        with open(path) as f:
            text = f.read()
        for name, v in constants.items():
            text, n = re.subn(rf"(\b{name}\s*=\s*)\d+", rf"\g<1>{v}", text)
            if n != 1:
                raise AssertionError(f"{spec}.cfg binds {name} {n} times")
        os.makedirs(spec_dir, exist_ok=True)
        out = os.path.join(spec_dir, f"{spec}_{tag}.cfg")
        with open(out, "w") as f:
            f.write(text)
        return out

    def spec_cli(spec, cfg, *flags):
        """``cli check`` of ``spec`` at ``cfg``: (exit code, stdout, the
        cumulative level totals of its progress log, (states, diameter)
        of its summary)."""
        out, err = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["check", os.path.join(SPECS, f"{spec}.tla"),
                               "-config", cfg, *flags])
        except SystemExit as e:
            raise AssertionError(f"cli check {spec}: exit {e.code}") from e
        text, log = out.getvalue(), err.getvalue()
        totals = [int(x) for x in re.findall(r"level 1: (\d+) initial", log)]
        totals += [int(x) for x in re.findall(r"\(total (\d+),", log)]
        m = re.search(r"(\d+) distinct states found, search depth "
                      r"\(diameter\) (\d+)", text)
        return rc, text, totals, m and (int(m.group(1)), int(m.group(2)))

    def spec_shipped():
        notes = []
        for spec, want in SPEC_SHIPPED.items():
            rc, text, _t, got = spec_cli(spec, spec_cfg(spec, {}, ""))
            if (rc, got) != (0, want) or "Error" in text:
                raise AssertionError(f"{spec}: rc {rc}, {got}\n{text}")
            notes.append(f"{spec} {got[0]}/{got[1]}: "
                         f"{text.splitlines()[0]}")
        return "; ".join(notes)

    def spec_bugs():
        notes = []
        for spec, (inv, over, gid, depth, actions) in SPEC_BUGS.items():
            cfg = spec_cfg(spec, over, "bug")
            rc, text, _t, got = spec_cli(spec, cfg, "-invariant", inv)
            lines = [f"Error: Invariant {inv} is violated.",
                     "State 1: <Initial predicate>"] + [
                f"State {i + 2}: <{a}>" for i, a in enumerate(actions)]
            if (rc != 1 or not got or got[1] != depth
                    or any(ln not in text for ln in lines)
                    or f"State {depth + 1}:" in text):
                raise AssertionError(f"{spec} {inv}: rc {rc}\n{text}")
            # the checker: the JAX engine's gid, and a trace whose every
            # lane was enabled when replayed
            consts = {k: int(v)
                      for k, v in cfgmod.load(cfg).constants.items()}
            r = DeviceChecker(spec_model(spec, consts),
                              invariants=(inv,)).run()
            got = (r.violation, r.violation_gid, r.diameter, len(r.trace),
                   r.trace_actions)
            if got != (inv, gid, depth, depth, actions):
                raise AssertionError(f"{spec} {inv}: {got}")
            notes.append(f"{spec} {inv}: gid {gid}, {depth} states, "
                         "rendered by the CLI, rc 1")
        return "; ".join(notes)

    spec_runs = {}  # scaled binding -> fused run's sizes, rows, logs, wall

    def spec_scaled():
        notes = []
        for name, (spec, consts, max_states, sizes) in SPEC_SCALED.items():
            pinned = list(itertools.accumulate(sizes))
            cut = max_states < 1 << 26
            rc, text, totals, got = spec_cli(
                spec, spec_cfg(spec, consts, name), "-maxstates",
                str(max_states))
            if (rc != (3 if cut else 0) or totals[: len(pinned)] != pinned
                    or (not cut and got != (pinned[-1], len(sizes)))):
                raise AssertionError(
                    f"{name} cli: rc {rc}, totals {totals} (want "
                    f"{pinned}), {got}\n{text}")
            model = spec_model(spec, consts)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            ck = DeviceChecker(model, max_states=max_states)
            r, card_syncs = _card_syncs(torch, ck.run)
            st = ck.last_stats
            if (r.level_sizes[: len(sizes)] != sizes or r.violation
                    or r.deadlock or r.truncated != cut
                    or (not cut and len(r.level_sizes) != len(sizes))):
                raise AssertionError(
                    f"{name}: levels {r.level_sizes} (want {sizes}), "
                    f"{r.violation}, deadlock {r.deadlock}")
            if card_syncs > st["host_syncs"] + 3:
                raise AssertionError(
                    f"{name}: {card_syncs} card syncs against "
                    f"{st['host_syncs']} host reads + 3")
            spec_runs[name] = (r.level_sizes, ck.merged_rows(),
                               *ck.merged_logs(), r.wall_s,
                               st["host_syncs"])
            notes.append(
                f"{name} (bits {model.layout.total_bits}, W {ck.W}, K "
                f"{ck.K} {'exact' if ck.keys.exact else 'hashed'}, A "
                f"{ck.A}): cli rc {rc}, level totals equal to the pins "
                f"({len(pinned)} levels, {pinned[-1]}); checker "
                f"{r.distinct_states} states, {len(r.level_sizes)} levels "
                f"in {r.wall_s:.3f}s = {r.states_per_sec:.0f} st/s, "
                f"host_syncs {st['host_syncs']} ({card_syncs} card syncs), "
                f"syncs_per_level {st['syncs_per_level']}, fuse_levels "
                f"{st['fuse_levels']}, table {st['fpset_table_cap']} "
                f"slots, {st['fpset_flushes']} flushes, peak "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            del ck
        return "; ".join(notes)

    def spec_stage():
        notes = []
        for name, (spec, consts, max_states, _s) in SPEC_SCALED.items():
            sizes, rows, par, lan, wall, syncs = spec_runs[name]
            ck = DeviceChecker(spec_model(spec, consts),
                               max_states=max_states, fuse="stage")
            r = ck.run()
            got = [ck.merged_rows(), *ck.merged_logs()]
            if r.level_sizes != sizes or not all(
                    a.shape == b.shape and (a == b).all()
                    for a, b in zip(got, (rows, par, lan))):
                raise AssertionError(f"{name}: stage differs from fused")
            notes.append(
                f"{name}: levels, rows and logs equal; stage "
                f"{r.wall_s:.3f}s ({ck.last_stats['host_syncs']} syncs) "
                f"against fused {wall:.3f}s ({syncs} syncs)")
            del ck
        return "; ".join(notes)

    def spec_tiered():
        spec, consts, max_states, _s = SPEC_SCALED["geo_exact"]
        m = spec_model(spec, consts)
        b = budget_for_table(m, SPEC_TIERED_TCAP, max_states=max_states)
        ck = DeviceChecker(m, max_states=max_states, hbm_budget=b)
        if ck.TCAP_MAX != SPEC_TIERED_TCAP:
            raise AssertionError(f"budget {b}: table ceiling {ck.TCAP_MAX}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        k3_before = kernels.LAUNCHES["sieve_mask"]
        r = ck.run()
        if ck.last_stats["spill_evictions"] < 1 or r.violation:
            raise AssertionError(f"{spill_note(ck)}; {r.violation}")
        same = same_run("geo_exact", spec_runs["geo_exact"][:4], ck, r)
        return (
            f"budget {b} ({budget_fmt(b)}), table ceiling "
            f"{SPEC_TIERED_TCAP}, K={ck.K}: level sizes and merged {same} "
            f"equal to phase 16's; {spill_note(ck)}; K3 launches "
            f"{kernels.LAUNCHES['sieve_mask'] - k3_before}; "
            f"{r.distinct_states} states in {r.wall_s:.2f}s; spill "
            f"transfer {ck.last_stats['spill_transfer_s']}s, lookups "
            f"{ck.tstore.stats.lookup_s:.2f}s; peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
        )

    kernels.reset_launches()
    counted("14 specs: shipped cfgs (cli)", spec_shipped)
    counted("15 specs: seeded bugs (cli + checker)", spec_bugs)
    counted("16 specs: scaled bindings, fused level (cli + checker)",
            spec_scaled)
    if len(spec_runs) == len(SPEC_SCALED):
        counted("16b specs: scaled bindings, -fuse stage, against 16",
                spec_stage)
        counted("17 specs tiered: geo_exact, hot table <= 2^23 slots",
                spec_tiered)
    spec_launches = dict(kernels.LAUNCHES)
    print(f"[17b launches on the spec path] {spec_launches}", flush=True)
    for name in TIERED_PATH_KERNELS:
        if spec_launches[name] <= 0:
            failures.append(f"kernel {name} never launched on the spec path")
    spec_runs.clear()
    torch.cuda.empty_cache()
    # ---- 18: where the time goes in the largest scaled spec binding
    # (after the counts were read)
    _s, consts, _m, _p = SPEC_SCALED["geo_exact"]
    _phase("18 profile of georeplication scaled-exact",
           lambda: profile(phase="18", model=spec_model("georeplication",
                                                        consts),
                           max_states=1 << 26), failures)
    torch.cuda.empty_cache()

    # ---- 19-21: liveness, launch counters zeroed around it
    kernels.reset_launches()
    live = {}

    def live_check(what, lc, pin, fairness):
        """The checker's verdict for ``fairness`` (and, once the sweep
        ran, its edge list) against the JAX engine's pins; returns the
        result."""
        lc.fairness = fairness
        r = lc.run()
        got = (r.holds, r.reason, r.lasso_prefix, r.lasso_cycle)
        if r.distinct_states != pin["distinct"]:
            raise AssertionError(f"{what}: {r.distinct_states} states")
        if got != pin["verdicts"][fairness]:
            raise AssertionError(f"{what} {fairness}: {got} != pin "
                                 f"{pin['verdicts'][fairness]}")
        if fairness == "wf_next":
            src, dst, out_deg = lc._edge_cache
            edges = dict(edges=len(src),
                         out_deg_hist=np.bincount(out_deg).tolist(),
                         edges_sha256=edge_digest(src, dst))
            for k, v in edges.items():
                if v != pin[k]:
                    raise AssertionError(f"{what}: {k} {v} != pin {pin[k]}")
        return r

    def edge_invariants(what, lc, n):
        """Every dst in [0, n), no self-loop, out-degrees summing to the
        edge count."""
        src, dst, out_deg = lc._edge_cache
        if len(dst) and (dst.min() < 0 or dst.max() >= n):
            raise AssertionError(f"{what}: dst out of [0, {n})")
        if (src == dst).any() or int(out_deg.sum()) != len(src):
            raise AssertionError(f"{what}: self-loop or out-degree sum")

    def recount(lc, n_sample=1 << 16):
        """An independent recount of the var-changing successors of
        ``n_sample`` sampled states: ``model.successors`` of each, its
        key (plain ``KeySpec.make``) looked up by ``torch.searchsorted``
        in the sorted int64 keys of all rows, against the sweep's edge
        list (out-degree and dst in lane order).  Returns (states,
        edges) checked."""
        m, rows = lc.model, lc._rows
        n = rows.shape[0]
        if lc.K != 2:
            raise AssertionError(f"recount needs K = 2 keys, not {lc.K}")
        sk, gid = torch.sort(tiles._key64(*lc.keys.make(rows)))
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        samp = torch.unique(torch.randint(0, n, (n_sample,), device=dev,
                                          generator=g))
        succ, valid = m.successors(m.layout.unpack(rows[samp]))
        qk = tiles._key64(*lc.keys.make(
            m.layout.pack(succ).reshape(-1, m.layout.W)))
        pos = torch.searchsorted(sk, qk).clamp(max=n - 1)
        vq = valid.reshape(-1)
        if not bool(((sk[pos] == qk) | ~vq).all()):
            raise AssertionError("recount: a successor missed the table")
        dst = gid[pos]
        keep = vq & (dst != samp.repeat_interleave(m.A))
        want_dst = dst[keep].cpu().numpy()
        want_cnt = keep.reshape(-1, m.A).sum(1).cpu().numpy()
        s_np = samp.cpu().numpy()
        esrc, edst, out_deg = lc._edge_cache
        cnt = out_deg[s_np]
        if not np.array_equal(cnt, want_cnt):
            raise AssertionError("recount: out-degrees differ")
        lo = np.searchsorted(esrc, s_np)
        idx = np.repeat(lo, cnt) + (np.arange(cnt.sum())
                                    - np.repeat(np.cumsum(cnt) - cnt, cnt))
        if not np.array_equal(edst[idx], want_dst):
            raise AssertionError("recount: successor gids differ")
        return len(s_np), int(cnt.sum())

    tier9m = pyeval.Constants(
        message_sent_limit=4, compaction_times_limit=3, num_keys=2,
        num_values=2, retain_null_key=True, max_crash_times=2,
        model_producer=True, model_consumer=False,
    )

    def liveness_9m():
        torch.cuda.reset_peak_memory_stats(dev)
        lc = LivenessChecker(CompactionModel(tier9m), fairness="wf_next",
                             **LIVENESS_9M_KW)
        t = time.time()
        r = lc.run()
        wall = time.time() - t
        n = r.distinct_states
        if n != TIER9M_STATES:
            raise AssertionError(f"{n} states, want {TIER9M_STATES}")
        edge_invariants("9m", lc, n)
        st = dict(lc.last_stats)
        src, dst, out_deg = lc._edge_cache
        pin = LIVENESS_PINS.get("9m")
        if pin is not None:
            live_check("9m", lc, pin, "wf_next")
            pinned = "edges, out-degree histogram, edge digest and " \
                "verdicts equal to the JAX pins"
        else:
            pinned = "no JAX pin for this tier (edge invariants checked)"
        n_s, n_e = recount(lc)
        t = time.time()
        r0 = (live_check("9m", lc, pin, "none") if pin is not None
              else lc.run())
        wall0 = time.time() - t
        live["9m"] = lc
        lasso = (f"lasso prefix {len(r.lasso_prefix)}, cycle "
                 f"{len(r.lasso_cycle)}" if r.lasso_cycle else "no lasso")
        return (
            f"{n} states, diameter {st['diameter']}; wf_next: "
            f"{'holds' if r.holds else 'VIOLATED'} ({r.reason}; {lasso}) "
            f"in {wall:.2f}s = explore {st['explore_s']:.2f}s + goal "
            f"{st['goal_s']:.2f}s + sweep {st['sweep_s']:.2f}s + analysis "
            f"{st['analysis_s']:.2f}s; {st['edges']} edges, out_deg sum "
            f"{int(out_deg.sum())}, histogram "
            f"{np.bincount(out_deg).tolist()}; sweep {st['sweep_chunks']} "
            f"chunks of {lc.SF} states, group {st['sweep_group']}, "
            f"{st['sweep_reads']} host reads, peak device memory "
            f"{st['sweep_peak_bytes'] / 2**30:.2f} GiB; {pinned}; recount "
            f"of {n_s} sampled states ({n_e} edges) equal; none: "
            f"{'holds' if r0.holds else 'VIOLATED'} ({r0.reason}; lasso "
            f"prefix {len(r0.lasso_prefix or ())}, cycle "
            f"{len(r0.lasso_cycle or ())}) in {wall0:.2f}s"
        )

    def liveness_pinned():
        notes = []
        full = dataclasses.replace(
            pyeval.SHIPPED_CFG, model_producer=True, retain_null_key=False
        )
        lc = LivenessChecker(CompactionModel(full), fairness="wf_next",
                             frontier_chunk=4096, visited_cap=1 << 18)
        for fairness in ("wf_next", "none"):
            live_check("253361-state config", lc, LIVENESS_PINS["full"],
                       fairness)
        notes.append(f"253361-state config: {lc.last_stats['edges']} edges "
                     "and both verdicts equal to the pins")
        # the same through the CLI
        with open(os.path.join(SPECS, "compaction.cfg")) as f:
            text = f.read()
        for a, b in (("ModelProducer = FALSE", "ModelProducer = TRUE"),
                     ("RetainNullKey = TRUE", "RetainNullKey = FALSE")):
            if a not in text:
                raise AssertionError(f"compaction.cfg lacks {a!r}")
            text = text.replace(a, b)
        cfg = os.path.join(spec_dir, "compaction_full.cfg")
        os.makedirs(spec_dir, exist_ok=True)
        with open(cfg, "w") as f:
            f.write(text)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                           "-config", cfg, "-property", "Termination",
                           "-fairness", "wf_next"])
        out = buf.getvalue()
        want = ("Temporal property Termination (fairness=wf_next): "
                "satisfied — all fair behaviors reach the goal")
        if rc != 0 or want not in out or "253361 distinct" not in out:
            raise AssertionError(f"cli -property: rc {rc}\n{out}")
        notes.append("cli check -property Termination -fairness wf_next: "
                     "satisfied, rc 0")
        # tiered exploration at a tight budget: the same edges
        probe = LivenessChecker(CompactionModel(full), hbm_budget="1T",
                                frontier_chunk=4096, visited_cap=1 << 18)
        budget = tight_budget(probe._checker)
        lt = LivenessChecker(CompactionModel(full), fairness="wf_next",
                             frontier_chunk=4096, visited_cap=1 << 18,
                             hbm_budget=budget)
        live_check("253361-state config tiered", lt, LIVENESS_PINS["full"],
                   "wf_next")
        ck = lt._checker
        if not ck._row_base or not ck.last_stats["spill_evictions"]:
            raise AssertionError("the tiered run spilled nothing")
        notes.append(
            f"tiered at budget {budget} ({ck.last_stats['spill_evictions']} "
            f"evictions, {ck._row_base} rows spilled): the same edges")
        cons = dataclasses.replace(
            pyeval.SHIPPED_CFG, message_sent_limit=2,
            compaction_times_limit=2, num_keys=1, num_values=1,
            model_producer=True, model_consumer=True,
        )
        lc = LivenessChecker(CompactionModel(cons), fairness="wf_next",
                             frontier_chunk=256, sweep_chunk=256,
                             visited_cap=1 << 13)
        for fairness in ("wf_next", "none"):
            live_check("consumer_on", lc, LIVENESS_PINS["consumer_on"],
                       fairness)
        notes.append("consumer_on: violated, lasso gids "
                     f"{LIVENESS_PINS['consumer_on']['verdicts']['wf_next'][2:]}"
                     " as the JAX engine's")
        for spec in ("subscription", "bookkeeper", "georeplication"):
            model, _c = registry.COMPILED[spec](
                cfgmod.load(os.path.join(SPECS, f"{spec}.cfg")))
            lc = LivenessChecker(model, fairness="wf_next",
                                 frontier_chunk=512, visited_cap=1 << 13)
            for fairness in ("wf_next", "none"):
                live_check(spec, lc, LIVENESS_PINS[spec], fairness)
            notes.append(f"{spec}: {lc.last_stats['edges']} edges, both "
                         "verdicts equal to the pins")
        return "; ".join(notes)

    counted("19 liveness: the 9m tier, Termination under wf_next and none",
            liveness_9m)
    counted("20 liveness: the pinned sizes (253361-state config, cli, "
            "tiered, consumer_on, the other three specs)", liveness_pinned)
    live_launches = dict(kernels.LAUNCHES)
    print(f"[21 launches on the liveness path] {live_launches}", flush=True)
    for name in TIERED_PATH_KERNELS:
        if live_launches[name] <= 0:
            failures.append(f"kernel {name} never launched on the liveness "
                            "path")

    sweep_shape = {}

    def k2_sweep():
        """K2 at the sweep's chunk shape: the 9m tier's first chunk of
        successor lanes, against its plain version and its bound."""
        lc = live.pop("9m")
        m = lc.model
        succ, valid = m.successors(m.layout.unpack(lc._rows[: lc.SF]))
        packed = m.layout.pack(succ).reshape(-1, m.layout.W)
        vq = valid.reshape(-1)
        ks, nc = lc.keys, packed.shape[0]
        got = tiles.key_plane(ks, packed, vq)
        want = tiles.key_plane_plain(ks, packed, vq)
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        if err:
            raise AssertionError(f"K2 at the sweep shape: err {err}")
        out = torch.empty((ks.ncols, nc), dtype=torch.int32, device=dev)
        args = tiles.key_plane_args(ks, packed, vq, out)
        nbytes = nc * (ks.W * 4 + 1 + ks.ncols * 4)
        bound = _bound(nbytes, nc * ks.ncols)  # one select a column
        sweep_shape.update(
            shape=f"exact W={ks.W} K={ks.ncols}: the 9m tier's first "
            f"sweep chunk, {lc.SF} states x A={m.A} = {nc} lanes",
            ms=_time_ms(torch, lambda: tiles.key_plane(ks, packed, vq), 20),
            device_ms=_time_ms(torch, lambda: kernels.launch(*args), 50),
            plain_ms=_time_ms(
                torch, lambda: tiles.key_plane_plain(ks, packed, vq), 5),
            bound_ms=bound[0], bound_by=bound[1], bytes=nbytes,
            max_abs_err=err,
        )
        del lc
        return f"equal; {sweep_shape}"

    _phase("22 K2 at the liveness sweep's chunk shape vs plain", k2_sweep,
           failures)
    torch.cuda.empty_cache()

    # ---- 23-24: simulation
    def sim_width(b):
        """One round of ``b`` walkers at depth 64 on the scaled config,
        its card syncs counted."""
        torch.cuda.reset_peak_memory_stats(dev)
        sim = StreamingSimulator(CompactionModel(scaled_cfg()), n_walkers=b,
                                 depth=64, seed=SEED)
        r, card_syncs = _card_syncs(torch, sim.run)
        st = r.stats
        if (r.violation, r.steps, r.states_visited, r.walks) != (
                None, b * 64, b * 65, b):
            raise AssertionError(
                f"{b} walkers: {r.violation}, {r.steps} steps, "
                f"{r.states_visited} states, {r.walks} walks")
        if card_syncs > r.segments + SIM_SYNC_SLACK:
            raise AssertionError(
                f"{card_syncs} card syncs for {r.segments} segments")
        return (
            f"{b} walkers x depth 64 ({r.segments} segments of {sim.L} "
            f"steps): {r.wall_s:.3f}s, {r.steps_per_sec:.0f} steps/s, "
            f"{r.walks_per_sec:.0f} walks/s, {r.states_per_sec:.0f} "
            f"states/s; {st['sim_stutter_steps']} stutter steps, "
            f"{st['sim_enabled_lanes']} enabled lanes, sampled duplicate "
            f"ratio {r.dup_ratio_est}; {card_syncs} card syncs in sync "
            f"debug mode for {r.segments} segments (host reads "
            f"{st['host_syncs']}); peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
        )

    def sim_widths():
        return "; ".join(sim_width(b) for b in (4096, 65536))

    _phase("23 simulation: scaled config, 4096 and 65536 walkers",
           sim_widths, failures)

    def sim_bugs():
        notes = []
        c = pyeval.SHIPPED_CFG
        for inv in ("CompactedLedgerLeak", "DuplicateNullKeyMessage"):
            runs = {}
            for where in ("cuda", "cpu"):
                runs[where] = StreamingSimulator(
                    CompactionModel(c), invariants=(inv,), n_walkers=1024,
                    depth=64, seed=0, max_rounds=20, device=where,
                ).run()
            r = runs["cuda"]
            if r.violation != inv or r.verified is not True:
                raise AssertionError(f"{inv}: {r.violation}, verified "
                                     f"{r.verified}")
            trace_ok(c, inv, r.trace, r.trace_actions)
            for f in ("trace", "trace_actions", "steps", "states_visited",
                      "violation_walker", "violation_step"):
                if getattr(r, f) != getattr(runs["cpu"], f):
                    raise AssertionError(f"{inv}: {f} differs on the CPU")
            keys = [k for k in r.stats if "per_sec" not in k]
            if [r.stats[k] for k in keys] != [runs["cpu"].stats[k]
                                              for k in keys]:
                raise AssertionError(f"{inv}: counters differ on the CPU")
            notes.append(
                f"{inv}: found at step {r.violation_step} by walker "
                f"{r.violation_walker} after {r.steps} steps, trace of "
                f"{len(r.trace)} states verified and valid, identical on "
                "the CPU (trace and counters)")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["simulate", "compaction", "-invariant",
                           "DuplicateNullKeyMessage", "-sim-steps",
                           "1000000"])
        out = buf.getvalue()
        if rc != 1 or "Error: Invariant DuplicateNullKeyMessage is " \
                "violated." not in out or "WARNING" in out:
            raise AssertionError(f"cli simulate: rc {rc}\n{out}")
        notes.append("cli simulate: DuplicateNullKeyMessage, rc 1")
        return "; ".join(notes)

    _phase("24 simulation: the seeded bugs, card against CPU", sim_bugs,
           failures)
    torch.cuda.empty_cache()

    # ---- 25: where the time goes (after the counts were read)
    def where_time(fn):
        """``fn()`` under ``torch.profiler``: wall, device busy and idle,
        and the PyTorch ops with the most device time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      acc_events=True) as prof:
            t = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t
        allev = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        busy = sum(dev_us(e) for e in allev
                   if e.device_type == DeviceType.CUDA) / 1e6
        if busy <= 0:
            return (f"wall {wall:.2f}s; torch.profiler reported no device "
                    "time on this machine")
        ops = sorted((e for e in allev if e.device_type == DeviceType.CPU
                      and dev_us(e) > 0), key=dev_us, reverse=True)[:10]
        ours = {k: sum(dev_us(e) for e in allev if k in e.key) / 1e3
                for k in ("key_plane_kernel", "member_kernel",
                          "insert_tail_kernel")}
        return (
            f"wall {wall:.2f}s under the profiler; device busy {busy:.3f}s "
            f"(idle {100 * (1 - busy / wall):.1f}%); our kernels (ms) "
            f"{ {k: round(v, 2) for k, v in ours.items()} }; top ops by "
            "device ms: " + ", ".join(
                f"{e.key} {dev_us(e) / 1e3:.1f} (x{e.count})" for e in ops)
        )

    def profile_live():
        """The 9m tier's exploration, then its sweep, each profiled."""
        lc = LivenessChecker(CompactionModel(tier9m), fairness="wf_next",
                             **LIVENESS_9M_KW)
        explore = where_time(lc._explore)
        sweep = where_time(lambda: lc._edges(lc._explored[0]))
        return f"explore: {explore}; sweep: {sweep}"

    def profile_sim():
        sim = StreamingSimulator(CompactionModel(scaled_cfg()),
                                 n_walkers=65536, depth=64, seed=SEED)
        return "65536 walkers x depth 64: " + where_time(sim.run)

    _phase("25a profile of the 9m-tier liveness run", profile_live,
           failures)
    torch.cuda.empty_cache()
    _phase("25b profile of the 65536-walker simulation", profile_sim,
           failures)
    # ---- 26-30, 2f: the spec->kernel compiler's models (the compiled
    # path), launch counters zeroed around phases 26-30
    from pulsar_tlaplus_tpu_torch.frontend import interp as finterp
    from pulsar_tlaplus_tpu_torch.frontend.codegen import CompiledSpec
    from pulsar_tlaplus_tpu_torch.frontend.loader import bind_cfg
    from pulsar_tlaplus_tpu_torch.frontend.parser import parse_file

    compiled_models = []  # the CompiledSpecs of the running phase
    graph_notes = []  # graph statistics of every CompiledSpec built

    def drain_models():
        """Note the graph statistics of the models a phase built and let
        them go: each holds thousands of graph nodes, and many alive at
        once slow every later phase's host (Python's garbage collector
        walks them all)."""
        graph_notes.extend(
            f"{cs.spec.module.name} {cs.layout.total_bits} bits: "
            f"{graph_note(cs)}" for cs in compiled_models)
        compiled_models.clear()
        gc.collect()

    def compile_spec(spec, invariants=None, **overrides):
        """The compiled model of specs/SPEC.tla at its cfg with
        ``overrides`` (and the interpreter's Spec of the same binding)."""
        tlc = cfgmod.load(os.path.join(SPECS, f"{spec}.cfg"))
        ast = parse_file(os.path.join(SPECS, f"{spec}.tla"))
        consts = bind_cfg(ast, tlc)
        consts.pop("__string_interning__")
        consts.update(overrides)
        fspec = finterp.Spec(ast, consts)
        cs = CompiledSpec(fspec, invariants=tuple(
            tlc.invariants if invariants is None else invariants))
        compiled_models.append(cs)
        return cs, fspec

    def bool_cfg(spec, constants, tag):
        """specs/SPEC.cfg with boolean CONSTANTS rebound, written under
        build/spec_cfgs."""
        with open(os.path.join(SPECS, f"{spec}.cfg")) as f:
            text = f.read()
        for name, v in constants.items():
            text, n = re.subn(rf"(\b{name}\s*=\s*)(TRUE|FALSE)",
                              rf"\g<1>{'TRUE' if v else 'FALSE'}", text)
            if n != 1:
                raise AssertionError(f"{spec}.cfg binds {name} {n} times")
        os.makedirs(spec_dir, exist_ok=True)
        out = os.path.join(spec_dir, f"{spec}_{tag}.cfg")
        with open(out, "w") as f:
            f.write(text)
        return out

    def graph_note(cs):
        succ = [g.n_nodes for k, g in cs._graphs.items()
                if k[0] == ("succ",)]
        return (f"{cs.graph_builds} graphs ({len(succ)} of successors, "
                f"{max(succ, default=0)} nodes) recorded in "
                f"{cs.graph_build_s:.2f}s, {cs.graph_calls} replays enqueued "
                f"in {cs.graph_replay_s:.2f}s of host time")

    class HostTimed:
        """A model whose successors and invariants add up the host
        seconds they take to enqueue (the hand model's counterpart of a
        compiled model's ``graph_replay_s``)."""

        def __init__(self, model):
            self.model, self.host_s = model, 0.0

        def __getattr__(self, name):
            return getattr(self.model, name)

        def _timed(self, fn):
            def call(*args):
                t = time.perf_counter()
                out = fn(*args)
                self.host_s += time.perf_counter() - t
                return out
            return call

        def successors(self, states):
            return self._timed(self.model.successors)(states)

        @property
        def invariants(self):
            return {n: self._timed(f)
                    for n, f in self.model.invariants.items()}

    full_over = dict(ModelProducer=True, RetainNullKey=False)
    tier9m_over = dict(MessageSentLimit=4, MaxCrashTimes=2,
                       ModelProducer=True)
    kept = {}  # compiled models phase 2f reuses (graphs recorded)

    def c_shipped():
        notes = []
        want = {"compaction": ({}, (45198, 20)),
                "compaction_full": (full_over, (253361, 23)),
                **{s: ({}, v) for s, v in SPEC_SHIPPED.items()}}
        for name, (over, counts) in want.items():
            spec = name.split("_")[0]
            cfg = (bool_cfg(spec, over, "full") if over
                   else spec_cfg(spec, {}, ""))
            rc, text, _t, got = spec_cli(spec, cfg, "-force-compile")
            head = text.splitlines()[0] if text else ""
            if ((rc, got) != (0, counts) or "Error" in text
                    or "declined" in text
                    or "via the spec->kernel compiler" not in head):
                raise AssertionError(f"{name}: rc {rc}, {got}\n{text}")
            notes.append(f"{name} {got[0]}/{got[1]} ({head[head.index('('):]})")
        return "; ".join(notes)

    def c_bugs():
        """Both seeded compaction bugs on the compiled model: depth, and
        a trace replayed step by step through ``successors`` on the card
        whose every step the interpreter takes and whose last state alone
        violates the invariant."""
        from pulsar_tlaplus_tpu_torch.ops.packing import smap

        notes = []
        for inv, depth in (("CompactedLedgerLeak", 12),
                           ("DuplicateNullKeyMessage", 4)):
            cs, fspec = compile_spec("compaction", invariants=(inv,))
            ck = DeviceChecker(cs)
            r = ck.run()
            if (r.violation, r.diameter, len(r.trace or ())) != (
                    inv, depth, depth):
                raise AssertionError(f"{inv}: {r.violation} depth "
                                     f"{r.diameter}")
            par, lan = ck.merged_logs()
            chain, g = [], r.violation_gid
            while g >= 0:
                chain.append(g)
                g = int(par[g])
            chain.reverse()
            s = cs.gen_initial(torch.tensor([-1 - g], device=dev))
            finterp.install_defs(fspec)
            ok = cs.invariants[inv]
            for i, gid in enumerate(chain):
                if i:
                    lane = int(lan[gid])
                    succ, valid = cs.successors(s)
                    if not bool(valid[0, lane]):
                        raise AssertionError(f"{inv}: lane {lane} off")
                    prev = cs.decode_state(s)
                    s = smap(lambda x: x[:, lane], succ)
                    nxt = cs.decode_state(s)
                    if tuple(nxt[v] for v in fspec.vars) not in {
                        t for _a, t in fspec.successors(
                            tuple(prev[v] for v in fspec.vars))
                    }:
                        raise AssertionError(f"{inv}: step {i} is not a "
                                             "step of the interpreter")
                if cs.to_pystate(s) != r.trace[i]:
                    raise AssertionError(f"{inv}: state {i} differs")
                if bool(ok(s)[0]) == (i == depth - 1):
                    raise AssertionError(f"{inv}: verdict at state {i}")
            notes.append(f"{inv} length {depth} replays (gid "
                         f"{r.violation_gid})")
        return "; ".join(notes)

    def c_full_width():
        """Compiled compaction.tla at the 9m binding: the fused level and
        the stage loop in turns, level sizes equal to the hand model's
        on the same engine, then a profile of the fused run.  The hand
        model's kernel launches are kept out of the compiled path's
        counts (``hand_launches``)."""
        cs, _f = compile_spec("compaction", **tier9m_over)
        kept["9m"] = cs
        hm = HostTimed(CompactionModel(tier9m))
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t = time.time()
        hand = DeviceChecker(hm, sub_batch=1 << 16,
                             max_states=12_000_000).run()
        torch.cuda.synchronize()
        hand_wall = time.time() - t
        for k, v in kernels.LAUNCHES.items():
            hand_launches[k] += v - before[k]
        if hand.level_sizes != TIER9M_LEVELS:
            raise AssertionError(f"hand model: {hand.level_sizes}")
        windows = sum(1 for _ in range(0, TIER9M_STATES, 1 << 16))
        gc_s = [0.0, 0.0, 0]  # seconds in Python's collector, start, runs

        def gc_clock(stage, _info):
            if stage == "start":
                gc_s[1] = time.perf_counter()
            else:
                gc_s[0] += time.perf_counter() - gc_s[1]
                gc_s[2] += 1

        walls = []
        gc.callbacks.append(gc_clock)
        try:
            for fuse in ("level", "stage"):
                ck = DeviceChecker(cs, sub_batch=1 << 16, fuse=fuse,
                                   max_states=12_000_000)
                calls, replay = cs.graph_calls, cs.graph_replay_s
                gc0, gcn = gc_s[0], gc_s[2]
                mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
                torch.cuda.synchronize()
                t = time.time()
                if fuse == "level":
                    r = ck.run()
                else:
                    # the level run recorded the graphs, and constants
                    # were uploaded before any recording: a replayed
                    # window uploads nothing, so the card syncs are the
                    # checker's own (phase 6's slack)
                    r, n_sync = _card_syncs(torch, ck.run)
                    if n_sync > ck.last_stats["host_syncs"] + 3:
                        raise AssertionError(
                            f"{n_sync} card syncs, host_syncs "
                            f"{ck.last_stats['host_syncs']}")
                torch.cuda.synchronize()
                walls.append((fuse, time.time() - t, cs.graph_calls - calls,
                              cs.graph_replay_s - replay,
                              ck.last_stats["host_syncs"], gc_s[0] - gc0,
                              gc_s[2] - gcn,
                              torch.cuda.memory_stats().get(
                                  "num_device_alloc", 0) - mallocs))
                if r.level_sizes != hand.level_sizes or r.violation:
                    raise AssertionError(f"{fuse}: levels {r.level_sizes}")
        finally:
            gc.callbacks.remove(gc_clock)
        # the profile covers levels 1-12 (1,500,000 states): the
        # profiler's tables over the whole run's ~4M events take minutes
        prof = where_time(lambda: DeviceChecker(
            cs, sub_batch=1 << 16, max_states=1_500_000).run())
        return (f"{TIER9M_STATES} states, diameter 24, level sizes equal "
                f"to the hand model's (state width {cs.layout.total_bits} "
                f"bits, {cs.A} lanes; hand model {hand_wall:.2f}s fused, "
                f"{hm.host_s:.2f}s host in its successors and invariants, "
                f"{hm.host_s / windows * 1e3:.1f}ms a window); "
                "walls in turns "
                + ", ".join(f"{f} {w:.2f}s ({n} replays, {h:.2f}s host, "
                            f"{h / windows * 1e3:.1f}ms host a window, "
                            f"{s} syncs, {g:.2f}s in {m} garbage "
                            f"collections, {a} cudaMalloc)"
                            for f, w, n, h, s, g, m, a in walls)
                + f"; the stage run made {n_sync} card syncs; "
                f"{graph_note(cs)}; profile of the fused run to "
                f"1,500,000 states: {prof}")

    def c_scaled():
        notes = []
        for name, (spec, consts, max_states, pins) in SPEC_SCALED.items():
            cs, _f = compile_spec(spec, **consts)
            if name == "geo_hashed":
                kept[name] = cs
            t = time.time()
            r = DeviceChecker(cs, max_states=max_states).run()
            got = r.level_sizes[: len(pins)]
            if got != pins or (name != "geo_hashed" and (
                    r.truncated or len(r.level_sizes) != len(pins))):
                raise AssertionError(f"{name}: levels {r.level_sizes}")
            notes.append(f"{name} {sum(pins)} over {len(pins)} levels in "
                         f"{time.time() - t:.2f}s ({cs.layout.total_bits} "
                         f"bits, W {cs.layout.W}, A {cs.A}; {graph_note(cs)})")
        return "pins held: " + "; ".join(notes)

    def c_tiered():
        """Compiled compaction at 253,361 states under a budget just
        above its initial tiers: equal state for state to the untiered
        run; K3 launches."""
        cs, _f = compile_spec("compaction", **full_over)
        ck = DeviceChecker(cs, invariants=())
        r = ck.run()
        if (r.distinct_states, r.diameter) != (253361, 23):
            raise AssertionError(f"untiered: {r.distinct_states}")
        want = (r.level_sizes, ck.merged_rows(), *ck.merged_logs())
        # windows small enough to evict, as phase 9's
        kw = dict(invariants=(), sub_batch=4096, visited_cap=1 << 12)
        budget = tight_budget(DeviceChecker(cs, hbm_budget="1T", **kw))
        k3 = kernels.LAUNCHES["sieve_mask"]
        tk = DeviceChecker(cs, hbm_budget=budget, **kw)
        tr = tk.run()
        same_run("compiled 253361", want, tk, tr)
        if not (tk.last_stats["spill_evictions"] >= 1
                and tk.last_stats["spill_rows_evicted"] > 0
                and tk.last_stats["spill_misses_resolved"] > 0):
            raise AssertionError(f"the budget forced no spill: "
                                 f"{spill_note(tk)}")
        n_k3 = kernels.LAUNCHES["sieve_mask"] - k3
        if n_k3 <= 0:
            raise AssertionError("K3 did not launch")
        return (f"253361 states, rows and logs equal the untiered run at "
                f"a {budget_fmt(budget)} budget; {spill_note(tk)}; K3 "
                f"launches {n_k3}")

    def c_live_sim():
        cs, _f = compile_spec("compaction", invariants=(), **full_over)
        lc = LivenessChecker(cs, goal="Termination", fairness="wf_next",
                             frontier_chunk=4096)
        pin = LIVENESS_PINS["compiled_full"]
        notes = []
        for fairness in ("wf_next", "none"):
            lc.fairness = fairness
            t = time.time()
            res = lc.run()
            got = (res.holds, res.reason, res.lasso_prefix, res.lasso_cycle)
            if (res.distinct_states, got) != (pin["distinct"],
                                              pin["verdicts"][fairness]):
                raise AssertionError(f"{fairness}: {got}")
            notes.append(f"{fairness} {res.holds} in {time.time() - t:.2f}s")
        src, dst, out_deg = lc._edge_cache
        if (len(src), np.bincount(out_deg).tolist(),
                edge_digest(src, dst)) != (pin["edges"], pin["out_deg_hist"],
                                           pin["edges_sha256"]):
            raise AssertionError("edges differ from the pins")
        for inv in ("CompactedLedgerLeak", "DuplicateNullKeyMessage"):
            cs, _f = compile_spec("compaction", invariants=(inv,))
            for seed in (0, 1, 2):
                s = StreamingSimulator(cs, invariants=(inv,),
                                       n_walkers=1024, depth=64, seed=seed,
                                       max_rounds=20).run()
                if (s.violation, s.verified) != (inv, True):
                    raise AssertionError(f"{inv} seed {seed}: "
                                         f"{s.violation} {s.verified}")
            notes.append(f"{inv} found and verified for seeds 0-2 "
                         f"({len(s.trace)} states at seed 2)")
        return (f"Termination: {pin['distinct']} states, {pin['edges']} "
                "edges, the pins' digest; " + "; ".join(notes))

    hand_launches = collections.Counter()  # phase 27's hand model's
    kernels.reset_launches()
    _phase("26 compiled: shipped cfgs (cli -force-compile), counterexamples",
           lambda: c_shipped() + "; " + c_bugs(), failures)
    drain_models()
    _phase("27 compiled: compaction at the 9m binding, against the hand "
           "model", c_full_width, failures)
    drain_models()
    torch.cuda.empty_cache()
    _phase("28 compiled: the scaled bindings to their pins", c_scaled,
           failures)
    drain_models()
    torch.cuda.empty_cache()
    _phase("29 compiled tiered: 253361 states at a tight budget", c_tiered,
           failures)
    drain_models()
    _phase("30 compiled: liveness and simulation", c_live_sim, failures)
    drain_models()
    compiled_launches = {k: v - hand_launches[k]
                         for k, v in kernels.LAUNCHES.items()}
    print(f"[30b launches on the compiled path] {compiled_launches} "
          f"(phase 27's hand model's left out: {dict(hand_launches)})",
          flush=True)
    for name in TIERED_PATH_KERNELS:
        if compiled_launches[name] <= 0:
            failures.append(f"30b: {name} never launched on the compiled "
                            "path")

    def c_kernels():
        """2f: K2 hashed at W = 5 (compiled compaction at the 9m binding)
        and W = 7 (compiled geo_hashed), K1 and H1 at K = 2, each on a
        flush the compiled model makes (the models of phases 27 and 28,
        their graphs recorded), against its plain version; after the
        compiled path's counts were read."""
        notes = []
        ck, packed, valid, kcols, n = spec_flush(None, None, TIER9M_LEVELS,
                                                 12, model=kept["9m"])
        notes.append(spec_k2(ck, packed, valid, kcols,
                             f"compiled hashed w={ck.W} K=2 ({n} rows x "
                             f"A={ck.A})"))
        notes += spec_k1_h1(ck, valid, kcols, "compiled 9m K=2")
        del ck, packed, valid, kcols
        pins = SPEC_SCALED["geo_hashed"][3]
        ck, packed, valid, kcols, n = spec_flush(None, None, pins, 12,
                                                 model=kept["geo_hashed"])
        notes.append(spec_k2(ck, packed, valid, kcols,
                             f"compiled hashed w={ck.W} K=2 ({n} rows x "
                             f"A={ck.A})"))
        return "equal: " + "; ".join(notes)

    _phase("2f K2/K1/H1 at the compiled models' shapes vs plain", c_kernels,
           failures)
    torch.cuda.empty_cache()

    print("[30c graphs] " + "; ".join(graph_notes), flush=True)
    kept.clear()
    torch.cuda.empty_cache()

    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    replaces = {
        "selftest": "pulsar_tlaplus_tpu/ops/tiles.py:172",
        "member_block": "pulsar_tlaplus_tpu/ops/tiles.py:326",
        "key_plane": "pulsar_tlaplus_tpu/ops/tiles.py:517",
        "sieve_mask": "pulsar_tlaplus_tpu/ops/tiles.py:590",
        "insert_tail": "pulsar_tlaplus_tpu/ops/fpset.py::probe_insert "
        "(XLA, no Pallas)",
    }
    # launches: each kernel's count from the run of the path it belongs
    # to (K3 only runs on the tiered path)
    path_launches = dict(launches, sieve_mask=tiered_launches["sieve_mask"])
    out = []
    for name in TIERED_PATH_KERNELS:
        rec = record[name]
        extra = ({"launch_floor_ms": rec["launch_floor_ms"]}
                 if "launch_floor_ms" in rec else {})
        shapes = [{k: v for k, v in e.items() if k != "kernel"}
                  for e in spec_shapes if e["kernel"] == name]
        out.append(dict(
            name=name,
            route="cuda",
            source="pulsar_tlaplus_tpu_torch/kernels/csrc/"
            + kernels.SOURCES[name],
            replaces=replaces[name],
            launches=path_launches[name],
            max_abs_err=rec["max_abs_err"],
            ms=rec["ms"],
            device_ms=rec["device_ms"],
            plain_ms=rec["plain_ms"],
            bound_ms=rec["bound"][0],
            bound_by=rec["bound"][1],
            library_ms=None,
            spec_launches=spec_launches[name],
            liveness_launches=live_launches[name],
            compiled_launches=compiled_launches[name],
            **({"sweep_shape": sweep_shape}
               if name == "key_plane" and sweep_shape else {}),
            **({"spec_shapes": shapes} if shapes else {}),
            **extra,
        ))
    print(smi, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
