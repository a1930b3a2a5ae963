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
  models make, and phase 18 profiles the K = 3 binding's first 16
  levels.

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
  the CPU identical (trace and counters).  Phase 25 profiles four
  chunks of the 9m tier's liveness sweep and 16 steps of the
  65,536-walker simulation.

- the spec->kernel compiler (phases 26-30, launch counters zeroed
  around them): ``cli check -force-compile`` of the four shipped cfgs
  and the 253,361-state config, both compaction counterexamples
  replayed step by step through the compiled ``successors`` on the card
  and the interpreter; compiled compaction.tla at the 9m binding in the
  fused level and the stage loop in turns, cut after level 11, level
  sizes equal to the hand model's, its first 9 levels profiled, with
  the host seconds per window; the four scaled bindings to their pins
  (geo_exact cut after level 14, geo_hashed after level 11:
  ``COMPILED_*_LEVELS``); a tiered run equal to its untiered run;
  liveness to the ``compiled_full`` pins and the seeded bugs by
  simulation for seeds 0-2 in segments of 16 steps.  Phase 2f holds K2
  (hashed W = 5 and 7), K1 and H1 against their plain versions on
  compiled models' flushes;
  ``[30c graphs]`` prints each compiled model's graph statistics.

Phases 31-35 are runs that survive, at the scaled binding unless said:
31 kills a checkpointed fused run in a process of its own
(``PTT_FAULT=kill@level:6``, frames every 2 levels) and resumes it in a
fresh one to phase 6's level totals (frame bytes, stall, restore, card
syncs); 32 recovers from the ``oom@level:7`` drill with a frame, then
caps the caching allocator after the level-5 frame so that level 6
really fails to allocate (recovered, or ``hbm`` with exact counts), and
the same cap with no frame ends ``hbm``; 33 runs the frontier row
window to phase 6's totals and logs (peak memory beside phase 6's); 34
runs phase 11's budget with a durable spill, preempted by
``sigterm@level:6`` after the fused handoff and resumed equal to phase
6's logs, then ``enospc@spill:1`` ends ``spill_enospc``; 35 kills the
253,361-state config's liveness sweep and the 65,536-walker simulation
in processes of their own and resumes them to the pins and the same
walk digest,
and the seeded bug across a preemption gives the same trace.  Frames go
to a temporary directory that phase 35 removes; ``[35b ...]`` prints
the launch counts of phases 31-35.

Phases 36-39 run the mesh-sharded engine (``engine/sharded_device.py``)
with four shards on the one card, launch counters zeroed around them:
36 the scaled binding to its level totals (card syncs against the host
fetches, peak memory, bytes routed a level), then one shard against the
single-card engine in turns; 37 geo_exact to its pins, the 253,361-state
config on a 2 x 2 mesh, and a route overflow that recovers to the same
totals; 38 ``cli check -sharded`` (shipped cfg, both counterexamples,
``-slices 2``, a compiled spec at ``-sharded 2``, ``-workers 4`` on one
card), each checker run held against the same run on the CPU shard for
shard; 39 a killed sharded run resumed in a fresh process to phase
36's totals and logs, and ``LivenessChecker(n_devices=4)`` at the
253,361-state config to the pins of both verdicts.  The kernels' record carries each
kernel's ``sharded_launches``: the counts of phases 36-39 less the
launches of the single-card engine's runs among them (phase 36's turns,
``-workers 4`` on one card).

Phases 40-43 run the engines of the eleventh slice: 40 builds the
scaled binding's host seed of its first four levels (its host seconds
printed), prestages it and runs it seeded in the frontier row window
with ``metrics_path`` to phase 6's level totals (every record with the
JAX keys), and the seed-frontier guard raises on a five-level seed; 40b holds seeded runs
(both counterexamples, one inside the seed) and a seeded N = 4 sharded
run card against CPU; 41 runs ``visited_impl="sort"`` on both device
engines to 253,361 / 23, gid for gid equal to the fpset runs, the two
flushes in turns, and the scaled binding cut after level 5; 42 runs the
host engine (``-engine host``) in hash and sort modes to the pins and
both counterexamples, a native ``FileLog`` run card against CPU, a
killed and resumed run, and the host engine against the device engine
in turns; 43 the host-staged sharded engine on 4 shards and a 2 x 2 mesh
in both dedup modes, card against CPU, and ``cli check -sharded 4
-sharded-dedup hash``.  ``engines_launches`` counts phases 40-43 less
the comparison runs of earlier paths among them.

Phases 44-47 run this slice's telemetry (``obs/``), launch counters
zeroed around them: 44 the scaled binding with a stream, a 0.5 s
heartbeat and ``metrics_path``, and without them, in turns (the stream
valid, its level records at phase 6's totals, a heartbeat line, host
syncs and card syncs equal in all four runs, the attribution's
expanded rows those of the levels); 45 the 253,361-state config's
stream on the card and the CPU (level records, work units, flushes and
result equal), the fused and stage work units, and a framed CLI run
killed by ``PTT_FAULT=kill@level:8`` in a process of its own, whose
stream has the fault record and whose resumed run's header names its
frame; 46 the streams of a tiered run (cumulative ``spill`` records,
K3 launched), ``-property`` (``sweep`` records), the 65,536-walker
simulation, ``-sharded 4`` and ``-engine host``, ``-xprof`` on the
scaled binding at levels 5:6 (a Chrome trace naming K1, K2 and H1),
and ``trace``/``metrics``/``top``/``ledger`` over phases 44-45's
streams; 47 ``scripts/torch_calibrate.py``'s unit costs on the card and
a fused run's attribution beside the stage-timed seconds.
``obs_launches`` counts phases 44-47 less their comparison runs
without telemetry.

Phases 48-52 run this slice's tuner (``tune/``), launch counters
zeroed around them, with a fresh ``PTT_TUNE_DIR`` for the whole script
(``check`` and the simulator resolve profiles by default, so neither a
profile written here nor one left on the machine reshapes any phase)
and ``PTT_TUNE_ADAPT`` cleared: 48 holds K1 at 16 and 8 membership
rounds and H1 at a probe budget of 32 against their plain versions at
the scaled flush's shapes, and the whole flush at ``dense_rounds`` 16
against the default flush; 49 measures the card's per-read overhead and
device-to-host rate (``tune/predict.py``'s ``"cuda"`` fallbacks), runs
``tune.search.tune_device`` on the scaled binding cut at level 6's
boundary (``max_states`` 17,787,334: every candidate must find those
states; top 3, 2 turns; the search's peak device memory against one
run's), then ``cli tune compaction`` and ``cli check compaction``, whose
header names the profile; 50 runs the scaled binding with and without
``adapt=True`` in turns (level sizes, logs, host and card syncs equal,
every ``tune`` record valid) and forces a pressure raise to dense 16 (a
spy counts K1's launches by rounds); 51 the simulator's search on the
scaled binding (4,096 x 64 steps) and a ``LivenessChecker`` resolving a
``"liveness"`` profile on the 253,361-state config (edges and verdict
as untuned); 52 ``cli tune --hbm-budget`` at a tight budget (the spill
knobs searched, the tiered key, an untiered ``check`` not resolving it,
K3 launched).  ``tune_launches`` counts phases 48-52 less the kernel
comparisons and untuned runs; ``tune_shape`` holds K1's and H1's times
at the tuner's values.

Phases 53-57 run this slice's checker daemon (``service/``, ``warm/``)
in the process, each phase on a daemon of its own (fresh state dir, one
device slot, the engine's default geometry, the service ceiling at phase
6's cut: a scaled job stops in level 7's first window at 19,618,816
states), launch counters zeroed around them: 53 prewarms the four specs,
runs the pooled checker's solo run of the scaled binding (written as a
.cfg, ``SCALED_CFG_TEXT``), then the scaled binding and the shipped cfg
as jobs at a 0.5 s slice with a priority-5 shipped job submitted at the
scaled job's second level boundary: the scaled job suspends (frame,
device memory freed: the allocated memory after the suspend is held
under 1 GiB over the phase's start), the priority job runs first, and
the scaled job's logs (from its harvested artifact frame) equal the solo
run's; a ``metrics`` scrape adds no synchronizing call, at a level
boundary of the running scaled job and on the idle daemon; 54 truncates the
scaled binding at 1,048,576 states and resubmits it (``continue``) to
the solo run's count, level sizes and logs; 55 reseeds the 9m tier
(``NINE_M_CFG_TEXT``, complete at 9,445,152 states) from MaxCrashTimes 2
to 3 (its key set equal to a cold run's) and demotes a third submit
under ``corrupt@warm`` to ``cold``; 56 drives ``serve`` (no ``-cpu``) in
subprocesses: SIGTERM (``PTT_FAULT=sigterm@level:5``) as its first job,
a scaled one, starts level 5, so the job suspends with a frame of
SCALED_PREV_TOTAL states; ``serve --recover`` resumes it at level 5 (its
``job_resume`` and resumed run header checked) to the solo run's counts,
then serves ``submit``/``status``/``watch``/``cancel``/``metrics``; a
second ``serve --tcp 127.0.0.1:0 --tokens`` (admitted, bad
token exit 4, quota exit 5), then ``torch_check_telemetry_schema.py
--tokens``/``--warm`` and every stream.  ``service_launches`` (57)
counts phases 53-55's daemon runs less the solo runs; K3 is 0 there (the
daemon runs no ``hbm_budget``).

Phases 58-62 run the fleet tier (``fleet/``): daemons behind one
dispatcher, every backend's slot on the one card.  58, in process: two
backends and a dispatcher (replication off, TCP with two tenants'
tokens): two scaled jobs placed least-loaded one on each backend, run at
once, level sizes and logs equal to the solo run's (phase 53's run of
phase 6's cut), the shipped cfg placed sticky, each job's wall beside
the solo run's and the card's peak memory; then one timed sieve pass of
a scaled artifact (a frame of about 2 GB, one blob past the protocol's
32 MiB line) to an empty peer: ``unreachable``, with the owner's CPU
seconds and resident growth.  59: replication on; a probe of the
producer-on binding truncated at 100,000 states is shipped to the peer
by the health thread (blobs, wire bytes, each blob's line against
``MAX_LINE``), a second pass answers ``identical`` at 0 bytes, and a
resubmit straight to the peer continues to phase 4's 253,361 / 23.  60,
in subprocesses (``serve`` x 2, ``dispatch``): the dispatcher killed -9
and restarted with ``--recover`` (a retried ``submit_id`` dedups to the
same job); then a backend dies (``PTT_FAULT=kill@level:7``) while its
scaled job runs and a second waits: the queued job is resubmitted to the
survivor and equals the solo run, the running one is ``lost``; ``serve
--recover`` brings the backend back and the lost job reconciles to the
solo run's result (``fleet_failover_ms``, ``fleet_reconcile_ms``, ready
times).  61: ``submit``/``status``/``watch``/``cancel``, ``metrics
--aggregate`` (both backends' families, the six latency histograms, a
scrape error with one backend down), ``top --dispatch``, ``metrics
--stream`` of the dispatcher's stream against its live families, every
stream valid and ``trace`` stitching them.  ``fleet_launches`` (62)
counts the in-process phases 58-59: K0, K1, K2 and H1 launched, K3 not.

Phases 63-65 (``fuzz_path``): 63 builds the native CPU baseline checker
(``native/compaction_bfs.cpp``, g++) and runs the shipped cfg and the
253,361-state config at one thread and at every host CPU, each equal to
the card engine's level sizes of phases 3 and 4, then the scaled binding
with every host CPU for 9 s (a 2^27-slot table): each level it
completes equals phase 6's cumulative total, and its states/s prints
beside phase 6's card rate as a diagnostic (no bound).  64 runs
``scripts/torch_fuzz.py`` on the card: seed 0, one binding a spec (4
records, 0 mismatches against the interpreters, both verdict classes)
and bookkeeper's widen drill at seed 5 (``reseed``, rows replayed and
reused); the device side again on the CPU gives the same summaries.  65
runs ``simulate -seed 1 -max-steps 100000 -rounds 2`` (stopped by the
rounds, as ``StreamingSimulator(max_rounds=2)``), ``check -profile``
(45,198 / 20, a Chrome trace naming K1, K2 and H1) and ``-profile`` with
``-xprof`` (refused).  ``fuzz_launches`` (``[65b ...]``) counts phase
64's card runs: K0, K1, K2 and H1 launched, K3 not.

Phases 66-68 (``chaos_path``) run ``scripts/torch_chaos.py``'s drills
with every daemon's slot on the card, after the two drill workloads'
solo runs on one pool equal ``SOLO_PINS`` (1,654 / 16; bookkeeper's
9-state ``ConfirmedEntryReadable`` trace): 66 ``run_chaos`` at seed 3
with 3 clients x 2 jobs (the seeded ``drop@conn``/``torn@line``/
``enospc@persist`` schedule over TCP, a bad token, a quota burst, a
corrupted warm artifact demoted to ``cold``), 67 ``run_fleet_chaos`` (a
backend killed mid-job: the queued job resubmitted, the running one
``lost``, a warm start on the survivor), 68 ``run_fleet_chaos_v2`` at
seed 0 with 2 x 1 (the ``cli dispatch`` subprocess killed -9 and
recovered, a partition reconciled, a flap held to one failover, torn
replication, the trace chains and ``fleet_trace.json``).  Every job a
drill admits equals the pinned solo run.  ``chaos_launches``
(``[68b ...]``) counts the drills' runs: K0, K1, K2 and H1 launched, K3
not.

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
import importlib.util
import io
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings

# H100 SXM peaks (NVIDIA data sheet) for each kernel's bound: memory
# rate, and the 32-bit non-tensor rate (67 T/s in float32; the kernels'
# integer ALU work is counted against it)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
SCALED_PREV_TOTAL = 636_718  # cumulative states after level 5
SCALED_TOTAL = 17_787_334  # cumulative states after level 6
SEED_LEVELS = 4  # phase 40's host seed: 22,765 states
SEED = 20261017
# the kernels each path runs (the tiered path runs all five)
MAIN_PATH_KERNELS = ("selftest", "member_block", "key_plane", "insert_tail")
TIERED_PATH_KERNELS = MAIN_PATH_KERNELS + ("sieve_mask",)
TIERED_TCAP = 1 << 25  # phase 11's hot-table ceiling
ROOT = os.path.dirname(os.path.abspath(__file__))
SPECS = os.path.join(ROOT, "specs")
T0 = time.time()  # the script's start: each phase's start is logged
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
# the compiled path's runs cut in depth at a level boundary (every
# window size stops there alike), to keep the script inside its time
# limit: the 9m binding after level 11 and its profile after level 9
# (phase 27), geo_exact after level 14 and geo_hashed after level 11
# (phase 28); their level sizes are held to the pins' prefixes
COMPILED_9M_LEVELS = 11
COMPILED_9M_PROFILE_LEVELS = 9
COMPILED_SCALED_LEVELS = {"geo_exact": 14, "geo_hashed": 11}
# phase 30's simulations of the seeded bugs on the compiled model: steps
# a segment (a run stops at the end of the segment that finds its bug)
COMPILED_SIM_SEGMENT = 16
# phase 25's profiled windows (the profiler's post-processing, not the
# run, took most of the phase): sweep chunks of the 9m tier, simulation
# steps of the 65,536 walkers (phase 23 times depth 64 unprofiled)
LIVE_PROFILE_CHUNKS = 4
SIM_PROFILE_DEPTH = 16
# phase 18 profiles geo_exact's first levels (phase 16 runs all 31 of
# them unprofiled): 805,931 of its 9,735,256 states
GEO_PROFILE_LEVELS = 16
LIVENESS_9M_KW = dict(frontier_chunk=1 << 16, visited_cap=1 << 24,
                      max_states=12_000_000, sweep_chunk=1 << 19)
# the 253,361-state config's liveness runs (phase 20; the resume of 35
# and the mesh of 39): windows of 4,096 states, sweep chunks of 2^14
LIVENESS_FULL_KW = dict(frontier_chunk=4096, visited_cap=1 << 18)
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
# phase 33's frontier window: level 6 (17,150,616 states) and level 5's
# frontier while level 6 is built, then level 6 with one append window
FRONTIER_ROWS = 18_000_000
# the processes of phases 31 and 35 (a kill ends the process, so it runs
# in one of its own): the scaled config's checker with frames at argv[1]
# every argv[2] levels (argv[3] == "1": resume), max_states argv[4]; the
# liveness checker of the 253,361-state config (LIVENESS_FULL_KW: 16
# sweep chunks) with sweep frames every 4 chunks; the 65,536-walker
# simulation with frames every segment.  Each prints one JSON line.
SCALED_DRIVER = r"""
import json, sys, warnings, torch
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval
c = pyeval.Constants(message_sent_limit=64, compaction_times_limit=3,
                     num_keys=8, num_values=2, retain_null_key=True,
                     max_crash_times=3, model_producer=True,
                     model_consumer=False)
path, every, resume, cap = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1", int(sys.argv[4])
ck = DeviceChecker(CompactionModel(c), max_states=cap, checkpoint_path=path,
                   checkpoint_every=every)
torch.cuda.set_sync_debug_mode("warn")
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    r = ck.run(resume=resume)
torch.cuda.set_sync_debug_mode("default")
st = ck.last_stats
print(json.dumps(dict(
    level_sizes=r.level_sizes, stop=r.stop_reason, wall=r.wall_s,
    host_syncs=st["host_syncs"],
    card_syncs=sum("synchroniz" in str(w.message) for w in caught),
    **{k: v for k, v in st.items() if k.startswith(("ckpt", "restore"))})))
"""
LIVE_DRIVER = r"""
import dataclasses, sys
from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval
c = dataclasses.replace(pyeval.SHIPPED_CFG, model_producer=True,
                        retain_null_key=False)
LivenessChecker(CompactionModel(c), fairness="wf_next",
                frontier_chunk=%d, visited_cap=%d,
                checkpoint_path=sys.argv[1], checkpoint_every=4).run()
"""
SIM_DRIVER = r"""
import sys
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval
from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
c = pyeval.Constants(message_sent_limit=64, compaction_times_limit=3,
                     num_keys=8, num_values=2, retain_null_key=True,
                     max_crash_times=3, model_producer=True,
                     model_consumer=False)
StreamingSimulator(CompactionModel(c), n_walkers=65536, depth=64,
                   seed=%d, max_rounds=2, checkpoint_path=sys.argv[1],
                   checkpoint_every=1).run()
"""


# the sharded path (phases 36-39): four shards on the card, 2^15 rows a
# shard a round (2^15 x 34 candidate lanes at the scaled binding)
HOST_DRIVER = r"""
import hashlib, json, sys
import numpy as np
from pulsar_tlaplus_tpu_torch.engine.bfs import Checker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval
path, resume = sys.argv[1] or None, sys.argv[2] == "1"
ck = Checker(CompactionModel(pyeval.SHIPPED_CFG), keep_log=True,
             checkpoint_path=path, checkpoint_every=1)
r = ck.run(resume=resume)
lg = ck.last_run_state.log
h = hashlib.sha256()
for a in (lg.packed_matrix(), lg.parents(), lg.actions()):
    h.update(np.ascontiguousarray(a).tobytes())
print(json.dumps(dict(n=r.distinct_states, level_sizes=r.level_sizes,
                      digest=h.hexdigest())))
"""
SHARDS = 4
SHARD_SUB_BATCH = 1 << 15
# card syncs a sharded run may make beyond its host fetches: the K0
# self-test, the layout's constant upload, the result's synchronize
SHARD_SYNC_SLACK = 3
# phase 39's process: the scaled binding on SHARDS shards with frames at
# argv[1] every argv[2] levels (argv[3] == "1": resume); prints its level
# sizes and a digest of every shard's rows and logs through level 6 (where
# level 7's cut falls depends on when a fetch sees the budget)
SHARDED_DRIVER = r"""
import hashlib, json, sys, torch
from pulsar_tlaplus_tpu_torch.engine.sharded_device import ShardedDeviceChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval
c = pyeval.Constants(message_sent_limit=64, compaction_times_limit=3,
                     num_keys=8, num_values=2, retain_null_key=True,
                     max_crash_times=3, model_producer=True,
                     model_consumer=False)
path, every, resume = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
ck = ShardedDeviceChecker(CompactionModel(c), n_devices=%d,
                          sub_batch=%d, max_states=%d,
                          checkpoint_path=path, checkpoint_every=every)
r = ck.run(resume=resume)
h = hashlib.sha256()
for s, n in enumerate(ck.level_shard_totals[6]):
    for k, w in (("rows", ck.W), ("parent", 1), ("lane", 1)):
        h.update(ck.last_bufs[k][s][: n * w].cpu().numpy().tobytes())
print(json.dumps(dict(level_sizes=r.level_sizes, stop=r.stop_reason,
                      wall=r.wall_s, digest=h.hexdigest(),
                      frames=ck.last_stats["ckpt_frames"])))
"""


def _shard_digest(ck, level):
    """SHA-256 of every shard's rows, parent and lane logs through BFS
    level ``level`` (as phase 39's process prints it)."""
    import hashlib

    h = hashlib.sha256()
    for s, n in enumerate(ck.level_shard_totals[level]):
        for k, w in (("rows", ck.W), ("parent", 1), ("lane", 1)):
            h.update(ck.last_bufs[k][s][: n * w].cpu().numpy().tobytes())
    return h.hexdigest()


def _phase(name, fn, failures):
    t = time.time()
    # on stderr as each phase starts: a run stopped at its time limit
    # shows which phase it was in
    print(f"chip_smoke: phase {name.split()[0]} starts at {t - T0:.0f}s",
          file=sys.stderr, flush=True)
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


# ---- the service path (phases 53-57): the checker daemon on the card
#
# The bench's scaled binding (bench.py:66-77) written as a .cfg.  Its full
# space is far beyond a run (bench.py sizes MAX_STATES at 230M), so the
# daemon's service ceiling (its default budget) is phase 6's cut,
# SCALED_TOTAL + 1: a job stops in level 7's first window at
# SERVICE_SCALED_STATES, as phase 6's run does.  Phase 55's reseed runs on
# the 9m tier (scripts/liveness_scale.py:55-62), whose space completes: a
# reseed is exact only against a complete run (two cuts of one space by
# a budget are different prefixes).
SCALED_CFG_TEXT = """CONSTANTS
    MessageSentLimit = 64
    CompactionTimesLimit = 3
    ModelConsumer = FALSE
    ConsumeTimesLimit = 2
    KeySpace = {1, 2, 3, 4, 5, 6, 7, 8}
    ValueSpace = {1, 2}
    RetainNullKey = TRUE
    MaxCrashTimes = 3
    ModelProducer = TRUE
SPECIFICATION Spec
INVARIANTS
    TypeSafe
    CompactionHorizonCorrectness
"""
NINE_M_CFG_TEXT = """CONSTANTS
    MessageSentLimit = 4
    CompactionTimesLimit = 3
    ModelConsumer = FALSE
    ConsumeTimesLimit = 2
    KeySpace = {1, 2}
    ValueSpace = {1, 2}
    RetainNullKey = TRUE
    MaxCrashTimes = %d
    ModelProducer = TRUE
SPECIFICATION Spec
INVARIANTS
    TypeSafe
    CompactionHorizonCorrectness
"""
SERVICE_CAP = SCALED_TOTAL + 1
SERVICE_SCALED_STATES = 19_618_816  # level 7's first window at the cap
SERVICE_FIRST_CAP = 1_048_576  # phase 54's truncated submit (inside level 6)
SERVICE_WARM_BYTES = 8 << 30  # holds one scaled artifact (~2 GB)
SERVICE_WAIT = 300.0  # every wait of phases 53-56 has its own limit
TOKENS_JSON = {"tokens_v": 1, "tenants": [
    {"tenant": "ci-pulsar", "token": "chip-smoke-token-1"}]}


def _logs_digest(rows, parent, lane):
    """SHA-256 of a run's rows (flat uint32), parent and lane logs."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (rows, parent, lane):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _frame_logs(path):
    """(n_visited, level sizes, logs digest, sorted int64 keys) of a
    frame written by the device checker (K = 2 key columns)."""
    import numpy as np

    d = np.load(path)
    nv = int(d["n_visited"])
    W = d["rows"].size // max(nv - int(d["rows_lo"]), 1)
    dig = _logs_digest(d["rows"][: nv * W], d["parent"][:nv],
                       d["lane"][:nv])
    keys = _join_keys(np.asarray(d["fpk0"], np.uint32),
                      np.asarray(d["fpk1"], np.uint32))
    return nv, [int(x) for x in d["level_sizes"]], dig, keys


def _frame_digest(path):
    """(n_visited, logs digest) of a device checker's frame: its rows,
    parent and lane logs only (the key planes are not read)."""
    import numpy as np

    d = np.load(path)
    nv = int(d["n_visited"])
    rows = d["rows"]
    W = rows.size // max(nv - int(d["rows_lo"]), 1)
    return nv, _logs_digest(rows[: nv * W], d["parent"][:nv], d["lane"][:nv])


def _join_keys(k0, k1):
    import numpy as np

    k = (k0.astype(np.uint64) << np.uint64(32)) | k1.astype(np.uint64)
    return np.sort(k)


def _table_keys(ck):
    """The sorted int64-joined keys of a device checker's visited table
    (K = 2), read once to the host."""
    import numpy as np

    cols = ck._tcols
    cap = cols[0].shape[0] - 1
    occ = (cols[0][:cap] != -1) | (cols[1][:cap] != -1)
    k0 = cols[0][:cap][occ].cpu().numpy().view(np.uint32)
    k1 = cols[1][:cap][occ].cpu().numpy().view(np.uint32)
    return _join_keys(k0, k1)


def _read_line(proc, timeout):
    """One stdout line of ``proc`` within ``timeout`` seconds."""
    import threading

    got = []
    t = threading.Thread(target=lambda: got.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    if not got:
        raise TimeoutError(f"no line from {proc.args} in {timeout}s")
    return got[0]


def _events(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def service_path(torch, dev, kernels, failures):
    """Phases 53-57: the checker daemon (``service/``, ``warm/``) driving
    the card.  Returns ``(service_launches, notes)``: the kernels' launch
    counts of the daemon's runs (the solo comparison runs left out) and
    the numbers printed."""
    import numpy as np

    from pulsar_tlaplus_tpu_torch.obs import metrics as obs_metrics
    from pulsar_tlaplus_tpu_torch.obs import schema as obs_schema
    from pulsar_tlaplus_tpu_torch.service import jobs as jobmod
    from pulsar_tlaplus_tpu_torch.service.client import ServiceClient
    from pulsar_tlaplus_tpu_torch.service.scheduler import ServiceConfig
    from pulsar_tlaplus_tpu_torch.service.server import ServiceDaemon
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod
    from pulsar_tlaplus_tpu_torch.utils import faults

    t53 = time.time()
    root = tempfile.mkdtemp(prefix="ptt_svc_")  # short: socket paths
    cfgs = {}
    for name, text in (("scaled", SCALED_CFG_TEXT),
                       ("nine2", NINE_M_CFG_TEXT % 2),
                       ("nine3", NINE_M_CFG_TEXT % 3)):
        cfgs[name] = os.path.join(root, f"{name}.cfg")
        with open(cfgs[name], "w") as f:
            f.write(text)
    shipped = os.path.join(SPECS, "compaction.cfg")
    tokens = os.path.join(root, "tokens.json")
    with open(tokens, "w") as f:
        json.dump(TOKENS_JSON, f)
    kernels.reset_launches()
    off = collections.Counter()  # the solo runs' launches
    notes: dict = {}
    solo: dict = {}
    art = []  # phase 55's artifact, for the validator in phase 56
    # the daemons' geometry is the engine's default (phase 6's); frames
    # only where a suspend or a budget stop needs one
    base = dict(devices=1, slice_s=0.5, max_states=SERVICE_CAP,
                checkpoint_every=1000, warm_max_bytes=SERVICE_WARM_BYTES)

    def off_path(fn, *a):
        before = dict(kernels.LAUNCHES)
        try:
            return fn(*a)
        finally:
            for k, v in kernels.LAUNCHES.items():
                off[k] += v - before[k]

    def daemon(name, **kw):
        """A daemon on a fresh state dir (not started yet)."""
        config = ServiceConfig(state_dir=os.path.join(root, name),
                               **dict(base, **kw))
        return (ServiceDaemon(config),
                ServiceClient(config.socket_path, timeout=SERVICE_WAIT))

    def pooled(d, name):
        tlc = cfgmod.load(cfgs[name])
        invs = d.pool.resolve_invariants("compaction", tlc, None)
        return d.pool.get("compaction", tlc, invs, None)[1]

    def solo_run(d, name, keys=False):
        """The pooled checker's solo run (no frame, no stream): level
        sizes, logs digest, wall (and with ``keys`` the sorted visited
        keys); its buffers freed."""
        ck = pooled(d, name)
        ck.checkpoint_path = None
        ck.rec.checkpoint_path = None
        ck._telemetry_arg = None
        ck.time_budget_s = None
        r = off_path(ck.run)
        nv = r.distinct_states
        out = dict(states=nv, level_sizes=list(r.level_sizes),
                   wall=r.wall_s, stop=r.stop_reason,
                   digest=_logs_digest(ck.merged_rows()[: nv * ck.W],
                                       *ck.merged_logs()),
                   keys=_table_keys(ck) if keys else None)
        ck._free_buffers()
        return out

    def artifact(d, name):
        adir = d.sched.warm_store.lookup(pooled(d, name)._config_sig())
        if adir is None:
            raise AssertionError(f"no warm artifact for {name}")
        return adir, d.sched.warm_store.load_manifest(adir)

    def artifact_logs(d, name):
        adir, _man = artifact(d, name)
        return _frame_logs(os.path.join(adir, "frame.npz"))

    def check_streams(d, js):
        errs = obs_schema.validate_stream(d.config.telemetry_path)
        for j in js:
            errs += obs_schema.validate_stream(j.events_path)
        if errs:
            raise AssertionError(f"stream violations: {errs[:3]}")

    def wait_all(cl, jids):
        return {j: cl.wait(j, timeout=SERVICE_WAIT) for j in jids}

    def warm_event(d, jid, phase):
        return next(e for e in _events(d.config.telemetry_path)
                    if e["event"] == "warm" and e.get("job_id") == jid
                    and e.get("phase") == phase)

    # ---- 53: two jobs time-sliced on the card, a priority preemption
    def time_sliced():
        d, cl = daemon("s53")
        solo["scaled"] = solo_run(d, "scaled")
        if solo["scaled"]["states"] != SERVICE_SCALED_STATES:
            raise AssertionError(f"solo {solo['scaled']['states']} states")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
        d.start()
        t = time.time()
        prewarm_s = d.prewarm()
        prewarm_wall = time.time() - t
        sched = d.sched
        after_suspend = []
        hi = []
        live = []  # (card syncs, the job labelled active) of each scrape
        run_slice = sched._run_slice
        mk_hook = sched._mk_hook

        def slice_(job, device=0):
            run_slice(job, device)
            if job.state == jobmod.SUSPENDED:
                after_suspend.append(torch.cuda.memory_allocated(dev)
                                     - base_mem)

        def hook_(job, deadline, resume=False, ck=None):
            hook = mk_hook(job, deadline, resume=resume, ck=ck)
            n = [0]

            def call():
                n[0] += 1
                if n[0] == 2 and job.cfg_path == cfgs["scaled"]:
                    # a metrics scrape while the job is active (it reads
                    # the running checker's snapshot): the engine thread
                    # waits in this hook, so a sync counted here is the
                    # scrape's own
                    text, syncs = _card_syncs(torch, lambda: obs_metrics
                                              .render_exposition(
                                                  obs_metrics
                                                  .scheduler_metrics(sched)))
                    active = [x for x in text.splitlines()
                              if x.startswith("ptt_active_job{")]
                    live.append((syncs, any(f'job_id="{job.job_id}"' in x
                                            for x in active)))
                # the priority-5 submit lands while the scaled job runs,
                # at its second level boundary
                if n[0] == 2 and not hi and job.cfg_path == cfgs["scaled"]:
                    hi.append(sched.submit("compaction", shipped,
                                           priority=5))
                return hook()

            return _HookView(call, hook)

        sched._run_slice = slice_
        sched._mk_hook = hook_
        try:
            js = cl.submit("compaction", cfgs["scaled"])
            jn = cl.submit("compaction", shipped)
            res = wait_all(cl, [js, jn])
            res[hi[0].job_id] = cl.wait(hi[0].job_id, timeout=SERVICE_WAIT)
            rs = res[js]["result"]
            job_s = sched.get(js)
            if (rs["distinct_states"], rs["level_sizes"], rs["stop_reason"]
                    ) != (SERVICE_SCALED_STATES, solo["scaled"]["level_sizes"],
                          "max_states"):
                raise AssertionError(f"scaled job {rs}")
            if job_s.suspends < 1:
                raise AssertionError("the scaled job was never suspended")
            for jid in (jn, hi[0].job_id):
                r = res[jid]["result"]
                if (r["distinct_states"], r["diameter"]) != (45198, 20):
                    raise AssertionError(f"shipped job {r}")
            if not hi[0].finished_unix < job_s.finished_unix:
                raise AssertionError("the priority job did not run first")
            nv, _ls, dig, _keys = artifact_logs(d, "scaled")
            if (nv, dig) != (SERVICE_SCALED_STATES, solo["scaled"]["digest"]):
                raise AssertionError("the scaled job's logs differ from "
                                     "the solo run's")
            evs = _events(d.config.telemetry_path)
            susp = [(e.get("slice_wall_s"), e.get("frame_stall_s"))
                    for e in evs if e["event"] == "job_suspend"
                    and e["job_id"] == js]
            rest = [e["restore_s"] for e in evs
                    if e["event"] == "job_resume" and e["job_id"] == js]
            peak = torch.cuda.max_memory_allocated(dev)
            if not after_suspend or max(after_suspend) >= 1 << 30:
                raise AssertionError(
                    f"device memory after a suspend {after_suspend}")
            # a metrics scrape adds no synchronizing call: while the
            # scaled job runs (above) and on the idle daemon (the last
            # slice's stats), in the process and through the socket
            text, syncs = _card_syncs(torch, cl.metrics)
            _, syncs2 = _card_syncs(torch, lambda: obs_metrics
                                    .render_exposition(
                                        obs_metrics.scheduler_metrics(
                                            sched)))
            if not any(a for _s, a in live):
                raise AssertionError(f"no scrape saw the job active {live}")
            if syncs or syncs2 or any(s for s, _a in live):
                raise AssertionError(f"card syncs in a metrics scrape: "
                                     f"running {live}, idle {syncs}/{syncs2}")
            if obs_metrics.validate_exposition(text):
                raise AssertionError("bad exposition")
            check_streams(d, [sched.get(j) for j in res])
            notes["53"] = dict(
                suspends=job_s.suspends, slices=job_s.slices,
                suspend=susp, restore_s=rest,
                alloc_after_suspend_gib=[round(x / 2**30, 4)
                                         for x in after_suspend],
                peak_gib=round(peak / 2**30, 2),
                job_wall=rs["wall_s"], solo_wall=solo["scaled"]["wall"],
                prewarm_s=round(prewarm_s, 3),
                prewarm_wall=round(prewarm_wall, 3),
                running_scrapes=len(live))
            return (f"scaled job {rs['distinct_states']} states "
                    f"({job_s.slices} slices, {job_s.suspends} suspends; "
                    f"frame stall s {susp}; restore s {rest}); logs = solo "
                    f"run's; engine wall {rs['wall_s']}s against solo "
                    f"{solo['scaled']['wall']:.3f}s; shipped x2 45198 / 20, "
                    f"priority first; allocated after suspend "
                    f"{notes['53']['alloc_after_suspend_gib']} GiB over the "
                    f"phase's start, peak {notes['53']['peak_gib']} GiB; "
                    f"prewarm {prewarm_s:.3f}s (4 specs); metrics scrape 0 "
                    f"card syncs ({len(live)} while the job ran, 2 idle)")
        finally:
            d.shutdown()

    # ---- 54: warm continue at full width
    def warm_continue():
        d, cl = daemon("s54")
        d.start()
        try:
            t = time.time()
            j1 = cl.submit("compaction", cfgs["scaled"],
                           max_states=SERVICE_FIRST_CAP)
            r1 = cl.wait(j1, timeout=SERVICE_WAIT)["result"]
            w1 = time.time() - t
            if r1["status"] != "truncated":
                raise AssertionError(f"first submit {r1}")
            _adir, man = artifact(d, "scaled")
            t = time.time()
            rep = cl.submit("compaction", cfgs["scaled"], full=True)
            if (rep["warm_mode"], rep["warm_reason"]) != ("continue",
                                                          "sig_match"):
                raise AssertionError(f"plan {rep}")
            r2 = cl.wait(rep["job_id"], timeout=SERVICE_WAIT)["result"]
            w2 = time.time() - t
            if (r2["distinct_states"], r2["level_sizes"], r2["warm"]) != (
                    SERVICE_SCALED_STATES, solo["scaled"]["level_sizes"],
                    "continue"):
                raise AssertionError(f"continue {r2}")
            nv, _ls, dig, _k = artifact_logs(d, "scaled")
            if (nv, dig) != (SERVICE_SCALED_STATES, solo["scaled"]["digest"]):
                raise AssertionError("continue logs differ from the solo "
                                     "run's")
            check_streams(d, [d.sched.get(j1), d.sched.get(rep["job_id"])])
            notes["54"] = dict(artifact_bytes=man["bytes"],
                               truncated_states=r1["distinct_states"],
                               first_wall=round(w1, 3),
                               continue_wall=round(w2, 3),
                               continue_engine_wall=r2["wall_s"])
            return (f"truncated at {r1['distinct_states']} "
                    f"({man['bytes']} artifact bytes), host wall "
                    f"{w1:.2f}s; continue to {r2['distinct_states']}, logs "
                    f"= solo run's, host wall {w2:.2f}s (engine wall "
                    f"{r2['wall_s']}s cumulative)")
        finally:
            d.shutdown()

    # ---- 55: warm reseed (9m tier, MaxCrashTimes 2 -> 3), corrupt@warm
    def warm_reseed():
        d, cl = daemon("s55", max_states=60_000_000)
        solo["nine3"] = solo_run(d, "nine3", keys=True)
        d.start()
        try:
            t = time.time()
            j2 = cl.submit("compaction", cfgs["nine2"])
            r2 = cl.wait(j2, timeout=SERVICE_WAIT)["result"]
            w2 = time.time() - t
            if (r2["distinct_states"], r2["diameter"]) != (
                    sum(TIER9M_LEVELS), len(TIER9M_LEVELS)):
                raise AssertionError(f"MaxCrashTimes 2: {r2}")
            t = time.time()
            rep = cl.submit("compaction", cfgs["nine3"], full=True)
            if (rep["warm_mode"], rep["warm_reason"]) != (
                    "reseed", "widened:MaxCrashTimes"):
                raise AssertionError(f"plan {rep}")
            r3 = cl.wait(rep["job_id"], timeout=SERVICE_WAIT)["result"]
            w3 = time.time() - t
            ev = warm_event(d, rep["job_id"], "install")
            adir, man = artifact(d, "nine3")
            nv, _ls, _dig, keys = artifact_logs(d, "nine3")
            art.append(adir)
            if (r3["warm"], r3["distinct_states"], nv) != (
                    "reseed", solo["nine3"]["states"],
                    solo["nine3"]["states"]):
                raise AssertionError(f"reseed {r3}")
            if not np.array_equal(keys, solo["nine3"]["keys"]):
                raise AssertionError("reseeded key set != the cold run's")
            # a third submit under corrupt@warm: demoted to cold
            store = d.sched.warm_store
            os.environ["PTT_FAULT"] = f"corrupt@warm:{store._verify_n + 1}"
            faults.reset()
            try:
                j4 = cl.submit("compaction", cfgs["nine3"])
                r4 = cl.wait(j4, timeout=SERVICE_WAIT)["result"]
            finally:
                os.environ.pop("PTT_FAULT", None)
                faults.reset()
            job4 = d.sched.get(j4)
            if ((job4.warm_mode, job4.warm_reason) != ("cold",
                                                       "digest_mismatch")
                    or r4["distinct_states"] != solo["nine3"]["states"]
                    or not os.listdir(store.quarantine_dir)):
                raise AssertionError(f"corrupt drill {job4.warm_mode} "
                                     f"{job4.warm_reason} {r4}")
            check_streams(d, [d.sched.get(j) for j in (j2, rep["job_id"],
                                                        j4)])
            notes["55"] = dict(
                states2=r2["distinct_states"], states3=r3["distinct_states"],
                reused_rows=ev["reused_rows"], replay_rows=ev["replay_rows"],
                seed_build_s=ev["seed_build_s"], cold2_wall=round(w2, 3),
                reseed_wall=round(w3, 3), reseed_engine_wall=r3["wall_s"],
                cold3_engine_wall=solo["nine3"]["wall"],
                corrupt_engine_wall=r4["wall_s"],
                artifact_bytes=man["bytes"])
            return (f"MaxCrashTimes 2: {r2['distinct_states']} in {w2:.2f}s "
                    f"(host); 3 by reseed: {r3['distinct_states']} states, "
                    f"key set = cold run's; reused {ev['reused_rows']} rows,"
                    f" replayed {ev['replay_rows']}, seed built in "
                    f"{ev['seed_build_s']}s on the host; engine walls "
                    f"reseed {r3['wall_s']}s / cold {solo['nine3']['wall']:.3f}"
                    f"s (host wall of the reseeded job {w3:.2f}s); "
                    f"corrupt@warm: cold (digest_mismatch), quarantined, "
                    f"{r4['distinct_states']} states")
        finally:
            d.shutdown()

    # ---- 56: the CLI end to end, in subprocesses
    def cli_path():
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("PTT_FAULT", None)
        s1, s2 = os.path.join(root, "c1"), os.path.join(root, "c2")
        common = ["--maxstates", str(SERVICE_CAP), "--warm-max-bytes", "0",
                  "--checkpoint-every", "1000"]
        procs = []

        def spawn(*args, fault=None):
            p = subprocess.Popen(
                [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli",
                 *args], cwd=ROOT,
                env=dict(env, PTT_FAULT=fault) if fault else env,
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            procs.append(p)
            return p

        def ready(p):
            if not _read_line(p, SERVICE_WAIT).startswith("serving on"):
                raise AssertionError(f"no ready line from {p.args}")

        def client(*args, rc=0):
            p = subprocess.run(
                [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli",
                 *args], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=SERVICE_WAIT)
            if p.returncode != rc:
                raise AssertionError(f"{args}: rc {p.returncode} (want {rc})"
                                     f" {p.stdout[-300:]} {p.stderr[-300:]}")
            return p.stdout

        def status_of(jid, d):
            out = client("status", jid, *d)
            return out.split()[2]

        def wait_state(jid, d, want, timeout=SERVICE_WAIT):
            end = time.time() + timeout
            while time.time() < end:
                st = status_of(jid, d)
                if st in want:
                    return st
                time.sleep(0.1)
            raise TimeoutError(f"{jid} never reached {want}")

        def queued(jid, want=None):
            """The job's record in queue.json (with ``want``, once it
            reaches that state: a client hears the end before the
            snapshot persists)."""
            end = time.time() + SERVICE_WAIT
            while True:
                with open(os.path.join(s1, "queue.json")) as f:
                    job = {j["job_id"]: j for j in json.load(f)["jobs"]}[jid]
                if want is None or job["state"] == want \
                        or time.time() > end:
                    return job
                time.sleep(0.05)

        t = time.time()
        try:
            # the first daemon's first job is a scaled job, and the daemon
            # gets SIGTERM as that job starts level 5 (PTT_FAULT sends it,
            # as phase 34 does to the engine): the job suspends at level
            # 5's end, a frame of SCALED_PREV_TOTAL states (level 6's
            # would be a 2 GB frame, which phases 31 and 34 measure)
            srv = spawn("serve", "--state-dir", s1, "--slice", "0.5",
                        *common, fault="sigterm@level:5")
            tcp = spawn("serve", s2, "--tcp", "127.0.0.1:0",
                        "--tokens", tokens, "--tenant-max-states",
                        str(SERVICE_CAP + 1), "--spec", "compaction", *common)
            ready(srv)
            ready(tcp)
            port = int(_read_line(tcp, SERVICE_WAIT).split()[-1])
            ready_s = time.time() - t
            d1 = ["--state-dir", s1]
            jt = client("submit", "compaction", cfgs["scaled"],
                        *d1).split()[0]
            if srv.wait(timeout=SERVICE_WAIT) != 0:
                raise AssertionError("serve exited non-zero on SIGTERM")
            job = queued(jt)
            at_term = (job["state"], (job.get("progress") or {})
                       .get("distinct_states"))
            frame = os.path.join(s1, "jobs", jt, "frame.npz")
            if at_term != ("suspended", SCALED_PREV_TOTAL) or \
                    not os.path.exists(frame):
                raise AssertionError(f"at SIGTERM the job was {at_term}")
            # serve --recover resumes it from that frame, in a new process;
            # the TCP daemon's checks run while it starts
            srv = spawn("serve", s1, "--recover", "--no-prewarm", *common)
            # the TCP listener: admitted, a bad token (4), over quota (5)
            addr = ["--socket", f"tcp://127.0.0.1:{port}"]
            good = addr + ["--token", TOKENS_JSON["tenants"][0]["token"]]
            out = client("submit", "compaction", shipped, "--wait", *good)
            if "45198 distinct states" not in out:
                raise AssertionError(out)
            client("submit", "compaction", shipped, *addr, "--token",
                   "not-a-token", rc=4)
            jq = client("submit", "compaction", cfgs["scaled"],
                        *good).split()[0]
            client("submit", "compaction", cfgs["scaled"], *good, rc=5)
            client("cancel", jq, *good)
            tcp.send_signal(signal.SIGTERM)
            if tcp.wait(timeout=SERVICE_WAIT) != 0:
                raise AssertionError("the TCP daemon exited non-zero")
            # the validator's --tokens and --warm, every stream
            for flag, path in (("--tokens", tokens),
                               ("--warm", art[-1] if art else None)):
                if path is None:
                    continue
                p = subprocess.run(
                    [sys.executable, os.path.join(
                        ROOT, "scripts", "torch_check_telemetry_schema.py"),
                     flag, path], cwd=ROOT, env=env, capture_output=True,
                    text=True, timeout=SERVICE_WAIT)
                if p.returncode:
                    raise AssertionError(f"{flag}: {p.stderr[-300:]}")
            ready(srv)
            out = client("watch", jt, *d1, rc=3)  # 3: truncated at the cap
            job = queued(jt, "done")
            r = job["result"] or {}
            if (job["state"], r.get("distinct_states"),
                    r.get("level_sizes")) != (
                        "done", SERVICE_SCALED_STATES,
                        solo["scaled"]["level_sizes"]) \
                    or f"{SERVICE_SCALED_STATES} distinct states" not in out:
                raise AssertionError(f"recovered job {job['state']} {r}")
            heads = [e for e in _events(os.path.join(s1, "jobs", jt,
                                                     "events.jsonl"))
                     if e["event"] == "run_header" and e.get("resume")]
            resumes = [e for e in _events(os.path.join(s1, "service.jsonl"))
                       if e["event"] == "job_resume" and e["job_id"] == jt]
            if [h.get("resume_level") for h in heads] != [5] or \
                    len(resumes) != 1:
                raise AssertionError(f"resume records {heads} {resumes}")
            restore_s = resumes[0]["restore_s"]
            stall = [e.get("frame_stall_s") for e in _events(
                os.path.join(s1, "service.jsonl"))
                if e["event"] == "job_suspend" and e["job_id"] == jt]
            # the recovered daemon serves on: submit, simulate, status,
            # watch, cancel while running, metrics
            out = client("submit", "compaction", shipped, "--wait", *d1)
            if "45198 distinct states found, search depth (diameter) 20." \
                    not in out:
                raise AssertionError(out)
            jship = out.split()[0]
            out = client("submit", "compaction", cfgs["scaled"], "--mode",
                         "simulate", "--walkers", "4096", "--depth", "64",
                         "--wait", *d1)
            if "Simulation: 262144 steps" not in out:
                raise AssertionError(out)
            if jship not in client("status", *d1):
                raise AssertionError("status lists no shipped job")
            out = client("watch", jship, *d1)
            if "run_header" not in out or "45198 distinct states" not in out:
                raise AssertionError(f"watch: {out[-300:]}")
            jc = client("submit", "compaction", cfgs["scaled"],
                        *d1).split()[0]
            wait_state(jc, d1, ("running",))
            client("cancel", jc, *d1)
            if wait_state(jc, d1, ("cancelled", "done")) != "cancelled":
                raise AssertionError("the cancelled job completed")
            text = client("metrics", *d1)
            if "ptt_daemon_up 1" not in text or \
                    obs_metrics.validate_exposition(text):
                raise AssertionError("metrics scrape")
            srv.send_signal(signal.SIGTERM)
            if srv.wait(timeout=SERVICE_WAIT) != 0:
                raise AssertionError("the recovered daemon exited non-zero")
            errs = []
            for s in (s1, s2):
                errs += obs_schema.validate_stream(
                    os.path.join(s, "service.jsonl"))
                for jid in os.listdir(os.path.join(s, "jobs")):
                    ev = os.path.join(s, "jobs", jid, "events.jsonl")
                    if os.path.exists(ev):
                        errs += obs_schema.validate_stream(ev)
            if errs:
                raise AssertionError(f"stream violations {errs[:3]}")
            notes["56"] = dict(ready_s=round(ready_s, 2),
                               frame_states=at_term[1],
                               frame_stall_s=stall,
                               recover_restore_s=restore_s)
            return (f"two daemons ready in {ready_s:.1f}s; SIGTERM as the "
                    f"scaled job starts level 5 -> suspended, frame of "
                    f"{at_term[1]} states (stall s {stall}); serve "
                    "--recover resumed it at "
                    f"level 5 (restore {restore_s}s) to "
                    f"{r['distinct_states']} states = solo; then shipped "
                    "45198 / 20, simulate 4096 x 64, status, watch, cancel "
                    "while running, metrics; TCP: admitted, bad token 4, "
                    "quota 5; --tokens/--warm and every stream valid")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)

    try:
        _phase("53 daemon: two jobs time-sliced on the card, priority "
               "preemption, logs against the solo run", time_sliced,
               failures)
        _phase("54 daemon: warm continue at full width", warm_continue,
               failures)
        _phase("55 daemon: warm reseed (9m tier, MaxCrashTimes 2 -> 3), "
               "corrupt@warm", warm_reseed, failures)
        _phase("56 the CLI end to end in subprocesses (serve, submit, "
               "status, watch, cancel, metrics, SIGTERM, --recover, TCP)",
               cli_path, failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    service_launches = {k: v - off[k] for k, v in kernels.LAUNCHES.items()}
    print(f"[57 launches on the service path] {service_launches} (solo "
          f"runs left out: {dict(off)}; phases 53-56 "
          f"{time.time() - t53:.1f}s)", flush=True)
    print(f"[57 numbers] {json.dumps(notes, default=str)}", flush=True)
    for name in MAIN_PATH_KERNELS:
        if service_launches[name] <= 0:
            failures.append(f"57: {name} never launched on the service "
                            "path")
    if service_launches["sieve_mask"]:
        failures.append("57: K3 launched on the service path (no "
                        "hbm_budget there)")
    return service_launches, notes, solo


# ---- the fleet path (phases 58-62): the dispatcher fronting daemons on
# the card
#
# Every backend is a ``serve`` daemon with one slot on cuda:0 (the
# machine has one card), so two backends share one card's capacity while
# the registry sees two idle backends.  The dispatcher touches no device.
FLEET_TOKENS_JSON = {"tokens_v": 1, "tenants": [
    {"tenant": "alpha", "token": "chip-smoke-alpha-1"},
    {"tenant": "beta", "token": "chip-smoke-beta-22"},
    {"tenant": "fleet", "token": "chip-smoke-fleet-333"}]}
# the 253,361-state binding (producer on, RetainNullKey = FALSE) as a .cfg
PRODUCER_CFG_TEXT = """CONSTANTS
    MessageSentLimit = 3
    CompactionTimesLimit = 3
    ModelConsumer = FALSE
    ConsumeTimesLimit = 2
    KeySpace = {1, 2}
    ValueSpace = {1, 2}
    RetainNullKey = FALSE
    MaxCrashTimes = 1
    ModelProducer = TRUE
SPECIFICATION Spec
INVARIANTS
    TypeSafe
    CompactionHorizonCorrectness
"""
FLEET_PROBE_CAP = 100_000  # phase 59's truncated probe
FLEET_BACKEND_TIMEOUT = 10.0  # the dispatcher's default backend_timeout_s
# how long after phase 61 the full-width pull's owner may still encode
# (it ends during phase 60 on an H100 host)
FLEET_OWNER_WAIT = 120.0
FLEET_HISTS = ("ptt_fleet_route_seconds", "ptt_fleet_submit_ack_seconds",
               "ptt_fleet_failover_seconds", "ptt_fleet_reconcile_seconds",
               "ptt_fleet_watch_leg_seconds", "ptt_fleet_job_e2e_seconds")


def _vm_rss():
    """This process's resident bytes (``/proc/self/status`` VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _until(pred, what, timeout):
    """Poll ``pred`` until it returns a truthy value (returned), or raise
    TimeoutError naming ``what``."""
    end = time.time() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.time() > end:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.05)


def fleet_path(torch, dev, kernels, failures, solo, ref):
    """Phases 58-62: the fleet dispatcher (``fleet/``) fronting checker
    daemons whose jobs run on the card.  ``solo`` is the service path's
    solo runs (phase 53's run of phase 6's cut: level sizes, logs digest),
    ``ref`` phase 6's wall and peak and phase 4's level sizes.  Returns
    ``(fleet_launches, notes)``: the kernels' launch counts of the
    in-process phases 58-59 and the numbers printed."""
    from pulsar_tlaplus_tpu_torch.fleet import replicate
    from pulsar_tlaplus_tpu_torch.fleet.dispatcher import (
        FleetConfig,
        FleetDispatcher,
    )
    from pulsar_tlaplus_tpu_torch.obs import metrics as obs_metrics
    from pulsar_tlaplus_tpu_torch.obs import schema as obs_schema
    from pulsar_tlaplus_tpu_torch.service import protocol
    from pulsar_tlaplus_tpu_torch.service.client import (
        ServiceClient,
        ServiceError,
    )
    from pulsar_tlaplus_tpu_torch.service.scheduler import ServiceConfig
    from pulsar_tlaplus_tpu_torch.service.server import ServiceDaemon
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

    t58 = time.time()
    root = tempfile.mkdtemp(prefix="ptt_flt_")  # short: socket paths
    cfgs = {}
    for name, text in (("scaled", SCALED_CFG_TEXT),
                       ("producer", PRODUCER_CFG_TEXT)):
        cfgs[name] = os.path.join(root, f"{name}.cfg")
        with open(cfgs[name], "w") as f:
            f.write(text)
    shipped = os.path.join(SPECS, "compaction.cfg")
    tokens = os.path.join(root, "tokens.json")
    with open(tokens, "w") as f:
        json.dump(FLEET_TOKENS_JSON, f)
    tok = {t["tenant"]: t["token"] for t in FLEET_TOKENS_JSON["tenants"]}
    base = dict(devices=1, slice_s=0.5, max_states=SERVICE_CAP,
                checkpoint_every=1000, warm_max_bytes=SERVICE_WARM_BYTES)
    notes: dict = {}
    owner_pull: dict = {}  # phase 58's full-width pull on its owner
    live = []  # every daemon and dispatcher started in the process
    procs = []  # every subprocess

    def backend(name, **kw):
        d = ServiceDaemon(ServiceConfig(state_dir=os.path.join(root, name),
                                        **dict(base, **kw)))
        live.append(d)
        d.start()
        return d

    def dispatcher(name, backends, **kw):
        disp = FleetDispatcher(FleetConfig(
            state_dir=os.path.join(root, name), backends=tuple(backends),
            health_interval_s=0.2, **kw))
        live.append(disp)
        disp.start()
        return disp

    def checker(d, name):
        tlc = cfgmod.load(cfgs[name])
        invs = d.pool.resolve_invariants("compaction", tlc, None)
        return d.pool.get("compaction", tlc, invs, None)[1]

    def artifact(d, name):
        adir = d.sched.warm_store.lookup(checker(d, name)._config_sig())
        if adir is None:
            raise AssertionError(f"no warm artifact for {name} on "
                                 f"{d.config.socket_path}")
        return adir, d.sched.warm_store.load_manifest(adir)

    def events(path, kind):
        return [e for e in _events(path) if e["event"] == kind]

    kernels.reset_launches()

    # ---- 58: routing at full width, in process
    def routing():
        b = [backend("b0"), backend("b1")]
        prewarm = [round(d.prewarm(), 3) for d in b]
        addrs = [d.config.socket_path for d in b]
        disp = dispatcher("d58", addrs, replicate=False, tcp="127.0.0.1:0",
                          tokens_path=tokens,
                          backend_timeout_s=FLEET_BACKEND_TIMEOUT)
        tcp = f"tcp://127.0.0.1:{disp.tcp_port}"
        alpha = ServiceClient(tcp, token=tok["alpha"], timeout=SERVICE_WAIT)
        beta = ServiceClient(tcp, token=tok["beta"], timeout=SERVICE_WAIT)
        # each job's resident device bytes when its checker frees its
        # run (the card's peak below covers both jobs at once), and the
        # unix span of each engine run (a slice) on each backend
        resident, spans = {}, {}
        for d in b:
            ck = checker(d, "scaled")
            free, run = ck._free_buffers, ck.run

            def run_(*a, run=run, addr=d.config.socket_path, **kw):
                t0 = time.time()
                try:
                    return run(*a, **kw)
                finally:
                    spans.setdefault(addr, []).append((t0, time.time()))

            def free_(ck=ck, free=free, addr=d.config.socket_path):
                n = sum(t.numel() * t.element_size()
                        for t in vars(ck).values()
                        if isinstance(t, torch.Tensor) and t.device == dev)
                n += sum(t.numel() * t.element_size()
                         for ts in vars(ck).values()
                         if isinstance(ts, (list, tuple))
                         for t in ts if isinstance(t, torch.Tensor)
                         and t.device == dev)
                resident[addr] = max(resident.get(addr, 0), n)
                free()

            ck._free_buffers = free_
            ck.run = run_
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t = t_sub = time.time()
        r1 = alpha.submit("compaction", cfgs["scaled"], full=True)

        def load(addr):
            s = disp.registry.detail_snapshot()[addr]
            return s["running"] + s["queue_depth"]

        # a health poll straddling the first submit resets its in-flight
        # mark and reads the backend before the job lands: wait for a
        # poll that sees it, so least-loaded places the second beside it
        _until(lambda: load(r1["backend"]) >= 1, "the first job's load",
               SERVICE_WAIT)
        r2 = beta.submit("compaction", cfgs["scaled"], full=True)
        r3 = alpha.submit("compaction", shipped, full=True)
        res = {r["job_id"]: (cl.wait(r["job_id"], timeout=SERVICE_WAIT),
                             time.time() - t)
               for r, cl in ((r1, alpha), (r2, beta), (r3, alpha))}
        card_peak = torch.cuda.max_memory_allocated(dev)
        for r in (r1, r2, r3):
            w, _s = res[r["job_id"]]
            if r["backend"] not in addrs or w["backend"] != r["backend"]:
                raise AssertionError(f"reply backends {r} {w}")
        if r1["backend"] == r2["backend"]:
            raise AssertionError("least-loaded put both scaled jobs on "
                                 f"{r1['backend']}")
        # the two scaled jobs ran on the card at once: the seconds in
        # which an engine run of each backend was in flight together
        overlap = sum(max(0.0, min(e0, e1) - max(s0, s1))
                      for s0, e0 in spans.get(r1["backend"], ())
                      for s1, e1 in spans.get(r2["backend"], ()))
        if overlap <= 0:
            raise AssertionError(f"the scaled jobs never overlapped {spans}")
        want = (SERVICE_SCALED_STATES, solo["scaled"]["level_sizes"],
                "max_states")
        for r in (r1, r2):
            g = res[r["job_id"]][0]["result"]
            if (g["distinct_states"], g["level_sizes"], g["stop_reason"]
                    ) != want:
                raise AssertionError(f"scaled job {g}")
        g = res[r3["job_id"]][0]["result"]
        if (g["distinct_states"], g["diameter"]) != (45198, 20):
            raise AssertionError(f"shipped job {g}")
        digests = {}
        for d in b:
            adir, _man = artifact(d, "scaled")
            digests[d.config.socket_path] = _frame_digest(
                os.path.join(adir, "frame.npz"))
        if set(digests.values()) != {(SERVICE_SCALED_STATES,
                                      solo["scaled"]["digest"])}:
            raise AssertionError(f"scaled logs {digests} against the solo "
                                 "run's")
        routes = disp.metrics_snapshot()["routes"]
        want_routes = {(r1["backend"], "least_loaded"): 1,
                       (r2["backend"], "least_loaded"): 1,
                       (r3["backend"], "sticky"): 1}
        if routes != want_routes or r3["backend"] != r1["backend"]:
            raise AssertionError(f"routes {routes}")
        by_addr = {d.config.socket_path: d for d in b}
        jobs_n = {}
        for r in (r1, r2, r3):
            job = by_addr[r["backend"]].sched.get(r["job_id"])
            jobs_n[r["job_id"]] = dict(
                backend=r["backend"][-12:],
                engine_wall_s=res[r["job_id"]][0]["result"]["wall_s"],
                done_after_s=round(res[r["job_id"]][1], 3),
                slices=res[r["job_id"]][0]["result"]["slices"],
                # seconds after the first submit
                started_s=round(job.started_unix - t_sub, 3),
                finished_s=round(job.finished_unix - t_sub, 3))
        # one timed sieve pass of a scaled artifact to an empty peer: its
        # frame is one blob far past the protocol's line limit
        owner = next(d for d in b if d.config.socket_path == r1["backend"])
        adir, man = artifact(owner, "scaled")
        peer = backend("bx")
        op = ServiceDaemon._op_warm_pull
        rec, ended = {}, threading.Event()

        def timed_pull(self, req, w):
            rss0, peak, stop = _vm_rss(), [0], threading.Event()

            def sample():
                while not stop.wait(0.02):
                    peak[0] = max(peak[0], _vm_rss())

            th = threading.Thread(target=sample, daemon=True)
            th.start()
            c0, w0 = time.thread_time(), time.time()
            try:
                return op(self, req, w)
            except Exception as e:
                rec["error"] = repr(e)[:120]
                raise
            finally:
                stop.set()
                th.join(5)
                rec.update(owner_cpu_s=round(time.thread_time() - c0, 3),
                           owner_wall_s=round(time.time() - w0, 3),
                           owner_ended_unix=time.time(),
                           owner_rss_peak_gib=round(
                               max(peak[0] - rss0, 0) / 2**30, 3))
                ended.set()

        ServiceDaemon._op_warm_pull = timed_pull
        try:
            # the sieve step of replicate_all for this one artifact (the
            # owner also holds the shipped job's), its transport failure
            # recorded as replicate_all records it
            t = time.time()
            try:
                passes = [replicate.replicate_artifact(
                    r1["backend"], peer.config.socket_path, man,
                    timeout=FLEET_BACKEND_TIMEOUT)]
            except (OSError, protocol.ProtocolError) as e:
                passes = [{"status": f"unreachable: {e!r:.80}",
                           "blobs": 0, "wire_bytes": 0}]
            pass_wall = time.time() - t
        finally:
            # the owner's thread resolved its handler when the pull
            # arrived; it goes on encoding while the next phases run
            # (their numbers are taken beside it), and the end of phase
            # 61 collects its numbers and the phase it ended in
            ServiceDaemon._op_warm_pull = op
        owner_pull.update(rec=rec, ended=ended)
        if [p["status"].split(":")[0] for p in passes] != ["unreachable"] \
                or peer.sched.warm_store.manifests():
            raise AssertionError(f"full-width pass {passes}")
        notes["58"] = dict(
            jobs=jobs_n, solo_wall=ref["scaled_wall"],
            engine_spans_s={a[-12:]: [(round(s0 - t_sub, 3),
                                       round(e0 - t_sub, 3))
                                      for s0, e0 in v]
                            for a, v in spans.items()},
            overlap_s=round(overlap, 3),
            card_peak_gib=round(card_peak / 2**30, 2),
            solo_peak_gib=round(ref["scaled_peak"] / 2**30, 2),
            resident_gib={a[-12:]: round(n / 2**30, 2)
                          for a, n in resident.items()},
            prewarm_s=prewarm, artifact_bytes=man["bytes"],
            frame_bytes=man["files"]["frame.npz"]["bytes"],
            max_line=protocol.MAX_LINE,
            full_width_pass=dict(status=passes[0]["status"],
                                 wall_s=round(pass_wall, 3)))
        return (f"scaled x2 on {r1['backend'][-12:]} and "
                f"{r2['backend'][-12:]} (least_loaded), shipped sticky "
                f"beside the first; level sizes and logs = the solo run's; "
                f"engine walls {[j['engine_wall_s'] for j in jobs_n.values()]}"
                f" s against the solo {ref['scaled_wall']:.3f} s, the two "
                f"scaled jobs' engine runs in flight together {overlap:.2f}"
                f" s; card peak "
                f"{notes['58']['card_peak_gib']} GiB (solo "
                f"{notes['58']['solo_peak_gib']}); resident at the end "
                f"{notes['58']['resident_gib']} GiB; full-width sieve of "
                f"{man['files']['frame.npz']['bytes']} frame bytes: "
                f"{passes[0]['status'][:60]} in {pass_wall:.2f}s (the "
                f"owner's numbers at phase 62)")

    # ---- 59: replication and a warm start on the peer
    def replication():
        # a ceiling above the producer-on binding's 253,361 states
        b = [backend("b2", max_states=60_000_000),
             backend("b3", max_states=60_000_000)]
        for d in b:
            d.prewarm()
        addrs = [d.config.socket_path for d in b]
        disp = dispatcher("d59", addrs, replicate=True,
                          backend_timeout_s=FLEET_BACKEND_TIMEOUT)
        cl = ServiceClient(disp.config.socket_path, timeout=SERVICE_WAIT)
        probe = cl.submit("compaction", cfgs["producer"],
                          max_states=FLEET_PROBE_CAP, full=True)
        done = cl.wait(probe["job_id"], timeout=SERVICE_WAIT)["result"]
        if done["status"] != "truncated":
            raise AssertionError(f"probe {done}")
        owner = b[addrs.index(probe["backend"])]
        peer = b[1 - addrs.index(probe["backend"])]
        _adir, man = artifact(owner, "producer")
        # the largest blob's protocol line against the line limit
        lines = {rel: len(json.dumps(replicate.read_blob(
            owner.sched.warm_store, man["config_sig"], rel)))
            for rel in man["files"]}
        if max(lines.values()) >= protocol.MAX_LINE:
            raise AssertionError(f"blob lines {lines} past MAX_LINE")
        _until(lambda: [m for _a, m in peer.sched.warm_store.manifests()
                        if m == man], "the artifact on the peer",
               SERVICE_WAIT)
        rep = _until(lambda: [e for e in events(disp.config.telemetry_path,
                                                "replicate")
                              if e["trace_id"] == probe["trace_id"]],
                     "the replicate record", SERVICE_WAIT)[0]
        again = replicate.replicate_all(owner.config.socket_path,
                                        [peer.config.socket_path])
        if [(p["status"], p["blobs"], p["wire_bytes"]) for p in again] != [
                ("identical", 0, 0)]:
            raise AssertionError(f"second pass {again}")
        pcl = ServiceClient(peer.config.socket_path, timeout=SERVICE_WAIT)
        t = time.time()
        wide = pcl.submit("compaction", cfgs["producer"], full=True)
        if (wide["warm_mode"], wide["warm_reason"]) != ("continue",
                                                        "sig_match"):
            raise AssertionError(f"plan on the peer {wide}")
        r = pcl.wait(wide["job_id"], timeout=SERVICE_WAIT)["result"]
        w = time.time() - t
        full = ref["full_levels"]  # phase 4's run: 253,361 / 23
        if (r["distinct_states"], r["diameter"], r["level_sizes"],
                r["warm"]) != (sum(full), len(full), full, "continue"):
            raise AssertionError(f"warm continue on the peer {r}")
        notes["59"] = dict(blobs=rep["blobs"], wire_bytes=rep["wire_bytes"],
                           raw_bytes=man["bytes"], line_bytes=lines,
                           max_line=protocol.MAX_LINE,
                           repl_wall_ms=rep["wall_ms"],
                           continue_wall=round(w, 3),
                           continue_engine_wall=r["wall_s"])
        return (f"probe truncated at {done['distinct_states']} on "
                f"{owner.config.socket_path[-12:]}; the health thread "
                f"shipped {rep['blobs']} blob(s), {rep['wire_bytes']} wire "
                f"bytes of {man['bytes']} ({rep['wall_ms']} ms); largest "
                f"line {max(lines.values())} of MAX_LINE "
                f"{protocol.MAX_LINE}; second pass identical, 0 bytes; the "
                f"peer continued to {r['distinct_states']} / "
                f"{r['diameter']}, level sizes = phase 4's, in {w:.2f}s")

    # ---- 60-61: the CLI's daemons and dispatcher in subprocesses
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PTT_FAULT", None)
    sk, ss, sd = (os.path.join(root, n) for n in ("f60k", "f60s", "f60d"))
    ksock, ssock = (os.path.join(s, "serve.sock") for s in (sk, ss))
    dsock = os.path.join(sd, "dispatch.sock")
    common = ["--maxstates", str(SERVICE_CAP), "--warm-max-bytes", "0",
              "--checkpoint-every", "1000", "--slice", "600", "--spec",
              "compaction"]
    dargs = ["dispatch", sd, "--backend", ksock, "--backend", ssock,
             "--tcp", "127.0.0.1:0", "--tokens", tokens,
             "--health-interval", "0.2", "--fail-after", "3",
             "--readmit-after", "2", "--no-replicate"]
    sub: dict = {}

    def spawn(*args, fault=None):
        p = subprocess.Popen(
            [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli", *args],
            cwd=ROOT, env=dict(env, PTT_FAULT=fault) if fault else env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        procs.append(p)
        return p

    def ready(p, want):
        t = time.time()
        line = _read_line(p, SERVICE_WAIT)
        if not line.startswith(want):
            raise AssertionError(f"no ready line from {p.args}: {line!r}")
        return time.time() - t, line

    def start_dispatcher(*extra):
        t = time.time()
        p = spawn(*dargs, *extra)
        ready(p, "dispatching on")
        port = int(_read_line(p, SERVICE_WAIT).split()[-1])
        return p, time.time() - t, port

    def failover():
        t = time.time()
        s = spawn("serve", "--state-dir", ss, *common)
        ready_s = {"survivor": round(ready(s, "serving on")[0], 2)}
        d, ready_s["dispatcher"], port = start_dispatcher()
        cl = ServiceClient(dsock, timeout=SERVICE_WAIT, retries=8)
        # a finished job in the table before the crashes below
        j0 = cl.submit("compaction", shipped, submit_id="f60-shipped",
                       full=True)
        r0 = cl.wait(j0["job_id"], timeout=SERVICE_WAIT)["result"]
        if (j0["backend"], r0["distinct_states"]) != (ssock, 45198):
            raise AssertionError(f"shipped job {j0} {r0}")
        # the failover: the first backend dies as its running job starts
        # level 7 (PTT_FAULT's kill, os._exit 137; a second past the
        # job's start, so the dispatcher's sweep has seen it running), a
        # second job queued behind it
        k = spawn("serve", "--state-dir", sk, *common,
                  fault="kill@level:7")
        ready_s["backend"] = round(ready(k, "serving on")[0], 2)
        _until(lambda: cl.ping()["backends"][ksock] == "up",
               "the backend's admission", SERVICE_WAIT)
        alpha = ServiceClient(f"tcp://127.0.0.1:{port}", token=tok["alpha"],
                              timeout=SERVICE_WAIT, retries=8)
        s1 = alpha.submit("compaction", cfgs["scaled"], submit_id="f60-run",
                          full=True)
        s2 = alpha.submit("compaction", cfgs["scaled"],
                          submit_id="f60-queued", full=True)
        if (s1["backend"], s2["backend"]) != (ksock, ksock):
            raise AssertionError(f"placement {s1['backend']} "
                                 f"{s2['backend']}")
        if k.wait(timeout=SERVICE_WAIT) != 137:
            raise AssertionError(f"the backend exited {k.returncode}")
        t_dead = time.time()
        states = _until(lambda: (lambda m: m if m.get(s1["job_id"]) == (
            "lost", ksock) and m.get(s2["job_id"], ("", ""))[1] == ssock
            else None)({j["job_id"]: (j["state"], j["backend"])
                        for j in cl.status()}), "the failover",
            SERVICE_WAIT)
        # the dispatcher's crash, with the running job lost and the
        # queued one resubmitted to the survivor: kill -9, then
        # --recover rebuilds the table from fleet_jobs.json and the
        # survivor's own table
        s2_at_crash = states[s2["job_id"]][0]
        d.kill()
        d.wait(timeout=60)
        d, ready_s["recovered_dispatcher"], port = start_dispatcher(
            "--recover")
        alpha = ServiceClient(f"tcp://127.0.0.1:{port}", token=tok["alpha"],
                              timeout=SERVICE_WAIT, retries=8)
        listing = {j["job_id"]: (j["state"], j["backend"])
                   for j in cl.status()}
        if set(listing) != {j0["job_id"], s1["job_id"], s2["job_id"]} or (
                listing[j0["job_id"]], listing[s1["job_id"]],
                listing[s2["job_id"]][1]) != (("done", ssock),
                                              ("lost", ksock), ssock) or \
                listing[s2["job_id"]][0] == "lost":
            raise AssertionError(f"recovered listing {listing}")
        again = cl.submit("compaction", shipped, submit_id="f60-shipped",
                          full=True)
        if again["job_id"] != j0["job_id"]:
            raise AssertionError(f"the retried submit {again} is not "
                                 f"{j0['job_id']}")
        w2 = alpha.wait(s2["job_id"], timeout=SERVICE_WAIT)
        want = (SERVICE_SCALED_STATES, solo["scaled"]["level_sizes"])
        g2 = w2["result"]
        if (w2["backend"], g2["distinct_states"], g2["level_sizes"]) != (
                ssock, *want):
            raise AssertionError(f"the failed-over job {w2}")
        try:
            alpha.result(s1["job_id"])
            raise AssertionError("result of a lost job answered")
        except ServiceError as e:
            lost_error = str(e)
            if "lost with its backend" not in lost_error:
                raise
        # the reconcile: once the recovered dispatcher has drained the
        # dead backend, it restarts from its queue; after two clean
        # polls the lost job takes its real result
        _until(lambda: cl.ping()["backends"][ksock] != "up",
               "the recovered dispatcher's drain", SERVICE_WAIT)
        k = spawn("serve", sk, "--recover", *common)
        ready_s["recovered_backend"] = round(ready(k, "serving on")[0], 2)
        t_back = time.time()
        _until(lambda: [j for j in cl.status() if j["job_id"] ==
                        s1["job_id"] and j["state"] == "done"
                        and j.get("reconciled")], "the reconciled job",
               SERVICE_WAIT)
        w1 = alpha.wait(s1["job_id"], timeout=SERVICE_WAIT)
        g1 = w1["result"]
        if (w1["backend"], g1["distinct_states"], g1["level_sizes"]) != (
                ksock, *want):
            raise AssertionError(f"the reconciled job {w1}")
        stream = os.path.join(sd, "dispatch.jsonl")
        # (a failover record with no job is a dispatcher's start finding
        # the backend not up yet, or the recovered one draining it)
        fo = [e for e in events(stream, "failover") if e["trace_ids"]]
        part = events(stream, "partition")
        rec = events(stream, "recover")
        if len(fo) != 1 or fo[0]["resubmitted"] != 1 or len(part) != 1 \
                or part[0]["reconciled"] != 1:
            raise AssertionError(f"failover {fo} partition {part}")
        if len(rec) != 1 or rec[0]["lost"]:
            raise AssertionError(f"recover {rec}")
        sub.update(d=d, k=k, s=s, alpha=alpha, cl=cl, jobs=[
            j0["job_id"], s1["job_id"], s2["job_id"]])
        notes["60"] = dict(
            fleet_failover_ms=fo[0]["wall_ms"],
            fleet_reconcile_ms=part[0]["wall_ms"],
            fleet_recover_ms=rec[0]["wall_ms"],
            lost_state=states[s1["job_id"]][0],
            queued_at_crash=s2_at_crash,
            ready_s={k_: round(v, 2) for k_, v in ready_s.items()},
            failover_seen_s=round(t_back - t_dead, 2),
            wall_s=round(time.time() - t, 2))
        return (f"backend killed at level 7 of its running job: queued job "
                f"resubmitted to the survivor, running job lost "
                f"({lost_error[:60]}...); dispatcher kill -9 + --recover "
                f"with the resubmitted job {s2_at_crash} on the survivor: "
                f"all 3 jobs listed with their backends, the retried "
                f"submit deduped to {j0['job_id']}, the resubmitted job "
                f"ended at {g2['distinct_states']} states = solo; the lost "
                f"job reconciled to {g1['distinct_states']} = solo after "
                f"serve --recover; fleet_failover_ms {fo[0]['wall_ms']}, "
                f"fleet_reconcile_ms {part[0]['wall_ms']}; ready s "
                f"{notes['60']['ready_s']}")

    def cli_fleet():
        d, env1 = ["--socket", dsock], env

        def client(*args, rc=0):
            p = subprocess.run(
                [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli",
                 *args], cwd=ROOT, env=env1, capture_output=True,
                text=True, timeout=SERVICE_WAIT)
            if p.returncode != rc:
                raise AssertionError(f"{args}: rc {p.returncode} (want {rc})"
                                     f" {p.stdout[-300:]} {p.stderr[-300:]}")
            return p.stdout

        def state_of(jid):
            return client("status", jid, *d).split()[2]

        out = client("submit", "compaction", shipped, "--wait", *d)
        if "45198 distinct states found, search depth (diameter) 20." \
                not in out:
            raise AssertionError(out)
        jid = out.split()[0]
        listing = client("status", *d)
        if jid not in listing or listing.count(" @") < 4:
            raise AssertionError(f"status {listing}")
        out = client("watch", jid, *d)
        if "run_header" not in out or "45198 distinct states" not in out:
            raise AssertionError(f"watch {out[-300:]}")
        jc = client("submit", "compaction", cfgs["scaled"], *d).split()[0]
        _until(lambda: state_of(jc) == "running", "the job to cancel",
               SERVICE_WAIT)
        client("cancel", jc, *d)
        _until(lambda: state_of(jc) in ("cancelled", "done"),
               "the cancel", SERVICE_WAIT)
        if state_of(jc) != "cancelled":
            raise AssertionError("the cancelled job completed")
        text = client("metrics", "--aggregate", *d)
        fams, types = obs_metrics.parse_exposition(text)
        hists = sorted(n for n, k in types.items() if k == "histogram")
        if hists != sorted(FLEET_HISTS) or \
                obs_metrics.validate_exposition(text):
            raise AssertionError(f"aggregate histograms {hists}")
        for sock in (ksock, ssock):
            if f'ptt_daemon_up{{backend="{sock}"}} 1' not in text:
                raise AssertionError(f"no families of {sock}")
        top = client("top", "--dispatch", "--once", *d)
        if "fleet @" not in top or "BACKEND" not in top:
            raise AssertionError(f"top {top[-300:]}")
        # the dispatcher's stream against its live families
        stream = os.path.join(sd, "dispatch.jsonl")
        _f, live_t = obs_metrics.parse_exposition(client("metrics", *d))
        _f, stream_t = obs_metrics.parse_exposition(
            client("metrics", "--stream", stream))
        fleet_t = [{n: k for n, k in t.items() if n.startswith("ptt_fleet")}
                   for t in (live_t, stream_t)]
        if fleet_t[0] != fleet_t[1]:
            raise AssertionError(f"stream families {fleet_t}")
        # every stream, and the trace that stitches them
        paths = [stream] + [os.path.join(s, "service.jsonl")
                            for s in (sk, ss)]
        for s in (sk, ss):
            jd = os.path.join(s, "jobs")
            paths += [os.path.join(jd, j, "events.jsonl")
                      for j in sorted(os.listdir(jd))
                      if os.path.exists(os.path.join(jd, j, "events.jsonl"))]
        errs = [e for p in paths for e in obs_schema.validate_stream(p)]
        if errs:
            raise AssertionError(f"stream violations {errs[:3]}")
        tpath = os.path.join(root, "fleet_trace.json")
        client("trace", *paths, "-o", tpath)
        with open(tpath) as f:
            tr = json.load(f)["traceEvents"]
        hops = sum(1 for e in tr if e.get("cat") == "ptt.fleet")
        if not hops:
            raise AssertionError("the trace has no fleet hops")
        # one backend down: the aggregate scrape counts it, never fails
        sub["s"].send_signal(signal.SIGTERM)
        if sub["s"].wait(timeout=SERVICE_WAIT) != 0:
            raise AssertionError("the survivor exited non-zero")
        down = _until(lambda: (lambda t: t if f'ptt_fleet_scrape_errors{{'
                               f'backend="{ssock}"}} 1' in t else None)(
            client("metrics", "--aggregate", *d)), "the scrape error",
            SERVICE_WAIT)
        if obs_metrics.validate_exposition(down):
            raise AssertionError("aggregate exposition with a backend down")
        for p in (sub["d"], sub["k"]):
            p.send_signal(signal.SIGTERM)
            if p.wait(timeout=SERVICE_WAIT) != 0:
                raise AssertionError(f"{p.args[3]} exited {p.returncode}")
        notes["61"] = dict(streams=len(paths), trace_events=len(tr),
                           fleet_hops=hops)
        return (f"submit/status/watch/cancel through the dispatcher; "
                f"metrics --aggregate: both backends' families, the six "
                f"histograms, clean, a scrape error with one backend down; "
                f"top --dispatch; {len(paths)} streams valid, trace of "
                f"{len(tr)} events ({hops} fleet hops); the stream's fleet "
                f"families = the live dispatcher's")

    starts = {}  # each phase's start, to place the owner's end

    def phase(n, name, fn):
        starts[n] = time.time()
        _phase(f"{n} fleet: {name}", fn, failures)

    try:
        phase("58", "routing at full width (two backends on the card, in "
              "process), a full-width sieve pass", routing)
        phase("59", "replication and a warm continue on the peer",
              replication)
        fleet_launches = dict(kernels.LAUNCHES)
        phase("60", "failover, reconcile and dispatcher recovery "
              "(subprocesses)", failover)
        if "d" in sub:
            phase("61", "the CLI and the flight deck against the "
                  "dispatcher", cli_fleet)
        if owner_pull and "58" in notes:
            t = time.time()
            if owner_pull["ended"].wait(FLEET_OWNER_WAIT):
                rec = dict(owner_pull["rec"])
                end = rec.pop("owner_ended_unix")
                notes["58"]["full_width_pass"].update(
                    rec, owner_done_after_61_s=round(time.time() - t, 2),
                    owner_ended_in_phase=max(
                        (n for n, t0 in starts.items() if t0 <= end),
                        default="58"))
            else:
                failures.append("58: the owner never finished the "
                                "full-width pull")
    finally:
        for obj in reversed(live):
            obj.shutdown()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    print(f"[62 launches on the fleet path] {fleet_launches} (phases 58-59 "
          f"in process; 58-61 {time.time() - t58:.1f}s)", flush=True)
    print(f"[62 numbers] {json.dumps(notes, default=str)}", flush=True)
    for name in MAIN_PATH_KERNELS:
        if fleet_launches[name] <= 0:
            failures.append(f"62: {name} never launched on the fleet path")
    if fleet_launches["sieve_mask"]:
        failures.append("62: K3 launched on the fleet path (no hbm_budget "
                        "there)")
    return fleet_launches, notes


# ---- the fuzz path (phases 63-65): the native CPU baseline beside the
# card engine, the differential fuzz harness on the card, and the CLI's
# simulate and check -profile flags
#
# phase 63's scaled baseline: seconds of budget and table slots (log2),
# bench.py's settings for its vs_baseline run but the budget
BASELINE_SCALED_BUDGET = 9.0
BASELINE_SCALED_TABLE_LOG2 = 27
# phase 65's simulate: 512 walkers of depth 64 make 32,768 steps a round,
# so -rounds 2 binds before -max-steps
SIM_CLI_WALKERS = 512
SIM_CLI_MAX_STEPS = 100_000


def _load_fuzz():
    """``scripts/torch_fuzz.py`` loaded by path (a fresh module)."""
    spec = importlib.util.spec_from_file_location(
        "torch_fuzz", os.path.join(ROOT, "scripts", "torch_fuzz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cum(sizes):
    return list(itertools.accumulate(int(n) for n in sizes))


def fuzz_path(torch, dev, kernels, failures, ref):
    """Phases 63-65: 63 the native baseline checker
    (``native/compaction_bfs.cpp``) against the card engine's level
    sizes of phases 3-4 and phase 6's cumulative levels, with its rate
    beside the card's as a diagnostic; 64 ``scripts/torch_fuzz.py`` on
    the card (seed 0, one binding a spec, and bookkeeper's widen drill
    at seed 5), each device summary equal to the same run on the CPU;
    65 ``simulate -seed/-max-steps/-rounds`` and ``check -profile`` on the
    card.  ``ref``: phase 3's and 4's level sizes, phase 6's level sizes
    and rate, the card's name and power limit.  Returns
    ``fuzz_launches``: the kernels' launch counts of phase 64's card
    runs (``[65b ...]`` prints them; K0, K1, K2 and H1 must be above 0,
    K3 at 0)."""
    from pulsar_tlaplus_tpu_torch import cli, native
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu_torch.ref import pyeval
    from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator

    ncpu = os.cpu_count() or 1
    notes = {}

    def baseline():
        t = time.time()
        native.build_baseline()
        build_s = time.time() - t
        full_cfg = dataclasses.replace(pyeval.SHIPPED_CFG,
                                       model_producer=True,
                                       retain_null_key=False)
        out = [f"built in {build_s:.1f}s"]
        for name, c, sizes in (("shipped", pyeval.SHIPPED_CFG,
                                ref["shipped_levels"]),
                               ("full", full_cfg, ref["full_levels"])):
            for threads in sorted({1, ncpu}):
                r = native.run_baseline(
                    c.message_sent_limit, c.num_keys, c.num_values,
                    c.compaction_times_limit, c.max_crash_times,
                    c.model_producer, c.retain_null_key, 300.0,
                    threads=threads, table_log2=22, with_levels=True)
                lv = r["level_records"]
                got = (r["distinct_states"], r["levels"], r["truncated"],
                       [x["new"] for x in lv], [x["cum"] for x in lv])
                want = (sum(sizes), len(sizes), False, list(sizes[1:]),
                        _cum(sizes)[1:])
                if got != want:
                    raise AssertionError(
                        f"{name} at {threads} threads: {got[:3]} levels "
                        f"{got[3]} against the card's {want[:3]} {want[3]}")
                out.append(f"{name} {r['distinct_states']}/{r['levels']} "
                           f"at {threads} threads in {r['wall_s']}s")
        c = ref["scaled_cfg"]
        r = native.run_baseline(
            c.message_sent_limit, c.num_keys, c.num_values,
            c.compaction_times_limit, c.max_crash_times, c.model_producer,
            c.retain_null_key, BASELINE_SCALED_BUDGET, threads=ncpu,
            table_log2=BASELINE_SCALED_TABLE_LOG2, with_levels=True)
        card = _cum(ref["scaled_levels"][:ref["scaled_complete"]])
        done = [x for x in r["level_records"] if x["complete"]]
        held = [x for x in done if x["level"] <= len(card)]
        bad = [(x["level"], x["cum"], card[x["level"] - 1]) for x in held
               if x["cum"] != card[x["level"] - 1]]
        if bad or len(held) < 4:
            raise AssertionError(
                f"scaled: completed levels {[x['level'] for x in done]}, "
                f"(level, baseline cum, card cum) off: {bad}; the card "
                f"completed {len(card)}")
        notes["baseline_scaled"] = dict(
            states_per_sec=r["states_per_sec"], distinct=r["distinct_states"],
            wall_s=r["wall_s"], levels_completed=len(done), threads=ncpu,
            card_states_per_sec=ref["scaled_rate"])
        out.append(
            f"scaled binding, {ncpu} threads, {BASELINE_SCALED_BUDGET:.0f}s "
            f"budget: levels 2-{held[-1]['level']} complete and equal to "
            f"phase 6's cumulative totals ({len(done) - len(held)} "
            f"completed past phase 6's cut), {r['distinct_states']} states "
            f"(truncated {r['truncated']})")
        # a diagnostic, not a benchmark: the two rates are of different
        # runs (the baseline's partial level 7 counts, the card's is cut
        # at 17,787,335 states) and no bound is set on either
        out.append(
            f"diagnostic: baseline {r['states_per_sec']:.0f} st/s on "
            f"{ncpu} host CPUs; card phase 6 {ref['scaled_rate']:.0f} st/s "
            f"({ref['smi']})")
        return "; ".join(out)

    fuzz_launches = {}

    def fuzz_on_card():
        fz = _load_fuzz()
        kernels.reset_launches()
        records, bad = fz.run(seed=0, per_spec=1, log=lambda m: None)
        widen, wbad = fz.run_widen(seed=5, per_spec=1,
                                   specs=("bookkeeper",), log=lambda m: None)
        fuzz_launches.update(kernels.LAUNCHES)
        verdicts = {r["device"]["violation"] for r in records}
        if len(records) != 4 or bad or None not in verdicts \
                or len(verdicts) < 2:
            raise AssertionError(f"fuzz: {len(records)} records, verdicts "
                                 f"{verdicts}, failures {bad}")
        w = widen[0]
        if wbad or (w.get("plan") or {}).get("mode") != "reseed" or \
                w["reseed"]["replay_rows"] < 1 or \
                w["reseed"]["reused_rows"] < 1:
            raise AssertionError(f"widen: {w}")
        # the device side alone again, on the CPU: the same summaries
        cpu, _ = fz.run(seed=0, per_spec=1, log=lambda m: None,
                        device="cpu")
        off = [(a["spec"], a["device"], b["device"])
               for a, b in zip(records, cpu) if a["device"] != b["device"]
               or a["binding"] != b["binding"]]
        wcpu, _ = fz.run_widen(seed=5, per_spec=1, specs=("bookkeeper",),
                               log=lambda m: None, device="cpu")
        keys = ("binding", "base", "plan", "reseed", "warm", "cold")
        if off or any(w[k] != wcpu[0][k] for k in keys):
            raise AssertionError(f"card against CPU: {off}; widen {w} vs "
                                 f"{wcpu[0]}")
        notes["fuzz"] = [dict(spec=r["spec"], **r["device"])
                         for r in records]
        return (
            "seed 0: " + ", ".join(
                f"{r['spec']} {r['device']['distinct_states']} "
                f"{r['device']['violation'] or 'clean'}" for r in records)
            + f"; widen bookkeeper seed 5: reseed, replay "
            f"{w['reseed']['replay_rows']} reused {w['reseed']['reused_rows']}"
            f" rows, warm {w['warm']['distinct_states']} cold "
            f"{w['cold']['distinct_states']}; every device summary equal to "
            f"the CPU's; launches {fuzz_launches}")

    def cli_repairs():
        out = []
        tail = ["-walkers", str(SIM_CLI_WALKERS), "-no-profile"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["simulate", "compaction", "-seed", "1",
                           "-max-steps", str(SIM_CLI_MAX_STEPS), "-rounds",
                           "2", *tail])
        sim = StreamingSimulator(
            CompactionModel(pyeval.SHIPPED_CFG), n_walkers=SIM_CLI_WALKERS,
            seed=1, max_steps=SIM_CLI_MAX_STEPS, max_rounds=2,
            profile=None).run()
        line = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("Simulation:")]
        want = (f"{sim.steps} steps, {sim.walks} completed walks")
        if rc != 0 or len(line) != 1 or want not in line[0] or (
                sim.steps, sim.walks) != (2 * SIM_CLI_WALKERS * 64,
                                          2 * SIM_CLI_WALKERS):
            raise AssertionError(f"simulate: rc {rc}, {line} against "
                                 f"{want}\n{buf.getvalue()[-800:]}")
        out.append(f"simulate -seed 1 -max-steps {SIM_CLI_MAX_STEPS} "
                   f"-rounds 2: {want}, as StreamingSimulator(max_rounds=2)")
        pdir = tempfile.mkdtemp(prefix="ptt_profile_")
        try:
            t = time.time()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                               "-config", os.path.join(SPECS,
                                                       "compaction.cfg"),
                               "-no-profile", "-profile", pdir])
            wall = time.time() - t
            text = buf.getvalue()
            if rc != 0 or "45198 distinct states found, search depth " \
                    "(diameter) 20." not in text:
                raise AssertionError(f"check -profile: rc {rc}\n{text}")
            (name,) = os.listdir(pdir)
            size = os.path.getsize(os.path.join(pdir, name))
            with open(os.path.join(pdir, name)) as f:
                names = {e.get("name", "") for e in json.load(f)[
                    "traceEvents"] if e.get("cat") == "kernel"}
            syms = {k: any(k in n for n in names) for k in (
                "member_kernel", "key_plane_kernel", "insert_tail_kernel")}
            if not all(syms.values()):
                raise AssertionError(f"check -profile: kernel symbols {syms}"
                                     f" among {len(names)} kernel names")
            out.append(f"check -profile: 45198/20, {len(names)} kernel "
                       f"names (K1/K2/H1 present), trace {size} bytes, "
                       f"{wall:.1f}s")
        finally:
            shutil.rmtree(pdir, ignore_errors=True)
        both = tempfile.mkdtemp(prefix="ptt_profile_")
        a, b = os.path.join(both, "a"), os.path.join(both, "b")
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                          "-profile", a, "-xprof", b])
            raise AssertionError("-profile with -xprof ran")
        except SystemExit as e:
            msg = str(e.code)
        finally:
            made = os.listdir(both)
            shutil.rmtree(both, ignore_errors=True)
        if "-profile" not in msg or "-xprof" not in msg or made:
            raise AssertionError(f"-profile with -xprof: {msg} ({made})")
        out.append("-profile with -xprof refused")
        return "; ".join(out)

    t63 = time.time()
    _phase("63 the native baseline against the card engine", baseline,
           failures)
    _phase("64 the fuzz harness on the card (seed 0, widen seed 5)",
           fuzz_on_card, failures)
    torch.cuda.empty_cache()
    _phase("65 simulate -seed/-max-steps/-rounds, check -profile",
           cli_repairs, failures)
    print(f"[65b launches on the fuzz path] {fuzz_launches} (phase 64's "
          f"card runs; 63-65 {time.time() - t63:.1f}s)", flush=True)
    print(f"[65b numbers] {json.dumps(notes, default=str)}", flush=True)
    for name in MAIN_PATH_KERNELS:
        if fuzz_launches.get(name, 0) <= 0:
            failures.append(f"65b: {name} never launched on the fuzz path")
    if fuzz_launches.get("sieve_mask"):
        failures.append("65b: K3 launched on the fuzz path (no hbm_budget "
                        "there)")
    return fuzz_launches


# phases 66-68: the drills' sizes (66 at the JAX slow test's 3 clients x 2
# jobs, 68 at its pinned 2 x 1) and every wait's limit
CHAOS_SEED = 3
CHAOS_CLIENTS, CHAOS_JOBS = 3, 2
CHAOS_V2_SEED = 0
CHAOS_V2_CLIENTS, CHAOS_V2_JOBS = 2, 1
CHAOS_WAIT = 300.0


def _load_chaos():
    """``scripts/torch_chaos.py`` loaded by path (a fresh module)."""
    spec = importlib.util.spec_from_file_location(
        "torch_chaos", os.path.join(ROOT, "scripts", "torch_chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chaos_path(torch, dev, kernels, failures):
    """Phases 66-68: ``scripts/torch_chaos.py``'s three drills with their
    daemons' slots on ``dev``.  The solo runs of the two drill workloads
    (the small compaction binding, 1,654 / 16, and bookkeeper at
    MaxBookieCrashes = 2, the 9-state ``ConfirmedEntryReadable``
    counterexample) run first on one pool and equal ``SOLO_PINS``; each
    drill holds every job it admits to them.  66 ``run_chaos`` (seed 3,
    3 clients x 2 jobs: its seeded fault schedule, a bad token, a quota
    burst, the corrupted warm artifact); 67 ``run_fleet_chaos`` (a
    backend killed mid-job, the queued job resubmitted, a warm start on
    the survivor); 68 ``run_fleet_chaos_v2`` (seed 0, 2 x 1: the
    ``cli dispatch`` subprocess killed -9 twice, a partition, a flap,
    torn replication, the trace chains).  Each drill's ``PTT_FAULT`` is
    restored, the fault module re-armed, its observer cleared and its
    state dir removed after it.  Returns ``chaos_launches``: the
    kernels' launch counts of the drills (the solo runs left out;
    ``[68b ...]`` prints them; K0, K1, K2 and H1 must be above 0, K3 at
    0)."""
    from pulsar_tlaplus_tpu_torch.service.scheduler import (
        CheckerPool,
        ServiceConfig,
    )
    from pulsar_tlaplus_tpu_torch.utils import faults

    t66 = time.time()
    ch = _load_chaos()
    root = tempfile.mkdtemp(prefix="ptt_cha_")  # short: socket paths
    kernels.reset_launches()
    off = collections.Counter()  # the solo runs' launches
    notes: dict = {}
    solo_s = 0.0
    on_cpu = torch.device(dev).type == "cpu"  # a rehearsal off the card

    def quiet(_msg):
        pass

    def drill(fn, name, check, **kw):
        """Run one drill on its own state dir, ``check`` its report
        there, then restore what it touched."""
        prev = os.environ.get("PTT_FAULT")
        state = os.path.join(root, name)
        try:
            t = time.time()
            report = fn(state, pool=pool, log=quiet,
                        timeout_s=CHAOS_WAIT, cpu=on_cpu, **kw)
            notes[name] = dict(wall_s=round(time.time() - t, 2))
            return check(report, state)
        finally:
            if prev is None:
                os.environ.pop("PTT_FAULT", None)
            else:
                os.environ["PTT_FAULT"] = prev
            faults.reset()
            faults.set_observer(None)
            shutil.rmtree(state, ignore_errors=True)

    try:
        pool = CheckerPool(ServiceConfig(
            state_dir=os.path.join(root, "pool"), cpu=on_cpu,
            **ch.GEOM_FAST), device=dev)
        cfgs = ch._write_cfgs(os.path.join(root, "solo"), bookkeeper=True)
        before = dict(kernels.LAUNCHES)
        t = time.time()
        solos = ch._solo_results(pool, {n: (n, p) for n, p in cfgs.items()})
        solo_s = time.time() - t
        for k, v in kernels.LAUNCHES.items():
            off[k] += v - before[k]
        for name, pin in ch.SOLO_PINS.items():
            got = ch.solo_summary(solos[name])
            if got != pin:
                failures.append(f"66: the card's solo {name} run {got} is "
                                f"not its pin {pin}")

        def service(r, _state):
            want = dict(completed=len(r["admitted"]), auth=1)
            got = dict(completed=r["completed"], auth=r["rejected"]["auth"])
            if got != want or r["rejected"]["quota"] < 1 \
                    or r["streams_validated"] < 3 \
                    or r["warm_quarantined"] < 1:
                raise AssertionError(f"run_chaos: {r}")
            notes["chaos"].update(schedule=r["schedule"],
                                  fired=r["faults_fired"])
            return (f"schedule {r['schedule']!r}, fired "
                    f"{['%s@%s:%d' % f for f in r['faults_fired']]}; "
                    f"{r['completed']} admitted jobs each equal to the "
                    f"pinned solo run, rejected {r['rejected']}, "
                    f"{r['warm_quarantined']} artifact quarantined, "
                    f"{r['streams_validated']} streams valid")

        def fleet_v1(r, _state):
            if r["resubmitted"] != 1 or r["replicated_wire_bytes"] <= 0 \
                    or r["warm_mode"] not in ("continue", "reseed") \
                    or r["streams_validated"] != 3:
                raise AssertionError(f"run_fleet_chaos: {r}")
            notes["fleet_v1"].update(
                wire_bytes=r["replicated_wire_bytes"],
                warm_mode=r["warm_mode"])
            return (f"owner killed mid-job: 1 queued job resubmitted, the "
                    f"running one lost; {r['replicated_wire_bytes']} wire "
                    f"bytes replicated; warm {r['warm_mode']} on the "
                    f"survivor equal to the pinned solo run")

        def fleet_v2(r, state):
            trace = os.path.join(state, "fleet_trace.json")
            if r["recovered"] != CHAOS_V2_CLIENTS * CHAOS_V2_JOBS \
                    or r["reconciled_jobs"] < 1 or r["partitions"] < 1 \
                    or r["trace_chains"] < 1 \
                    or r["streams_validated"] != 3 \
                    or not os.path.exists(trace):
                raise AssertionError(f"run_fleet_chaos_v2: {r}, fleet_trace"
                                     f".json {os.path.exists(trace)}")
            notes["fleet_v2"].update(
                schedule=r["schedule"], trace_chains=r["trace_chains"],
                wire_bytes=r["replicated_wire_bytes"])
            return (f"schedule {r['schedule']}: {r['recovered']} acked jobs "
                    f"exactly once across kill -9 + --recover, "
                    f"{r['reconciled_jobs']} reconciled after "
                    f"{r['partitions']} partition, the flap held to one "
                    f"failover, {r['replicated_wire_bytes']} wire bytes "
                    f"under a torn line, {r['trace_chains']} trace chains, "
                    f"fleet_trace.json written")

        _phase(f"66 run_chaos on the card (seed {CHAOS_SEED}, "
               f"{CHAOS_CLIENTS} clients x {CHAOS_JOBS} jobs)",
               lambda: drill(ch.run_chaos, "chaos", service,
                             seed=CHAOS_SEED, clients=CHAOS_CLIENTS,
                             jobs_per_client=CHAOS_JOBS, solos=solos),
               failures)
        _phase("67 run_fleet_chaos on the card (failover)",
               lambda: drill(ch.run_fleet_chaos, "fleet_v1", fleet_v1,
                             solo=solos["compaction"]), failures)
        _phase(f"68 run_fleet_chaos_v2 on the card (seed {CHAOS_V2_SEED}, "
               f"{CHAOS_V2_CLIENTS} x {CHAOS_V2_JOBS})",
               lambda: drill(ch.run_fleet_chaos_v2, "fleet_v2", fleet_v2,
                             seed=CHAOS_V2_SEED, clients=CHAOS_V2_CLIENTS,
                             jobs_per_client=CHAOS_V2_JOBS,
                             solo=solos["compaction"]), failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    chaos_launches = {k: v - off[k] for k, v in kernels.LAUNCHES.items()}
    print(f"[68b launches on the chaos path] {chaos_launches} (the solo "
          f"runs left out: {dict(off)}, {solo_s:.2f}s; phases 66-68 "
          f"{time.time() - t66:.1f}s)", flush=True)
    print(f"[68b numbers] {json.dumps(notes, default=str)}", flush=True)
    for name in MAIN_PATH_KERNELS:
        if chaos_launches.get(name, 0) <= 0:
            failures.append(f"68b: {name} never launched on the chaos path")
    if chaos_launches.get("sieve_mask"):
        failures.append("68b: K3 launched on the chaos path (no hbm_budget "
                        "there)")
    return chaos_launches


class _HookView:
    """A wrapped suspend hook that reports its inner hook's
    ``resume_emitted`` (the scheduler reads it after the slice)."""

    def __init__(self, fn, inner):
        self._fn, self._inner = fn, inner

    def __call__(self):
        return self._fn()

    @property
    def resume_emitted(self):
        return self._inner.resume_emitted


def main() -> int:
    # tuned profiles resolve by default (check, the simulator): every
    # phase gets a fresh profile directory, so neither a profile this run
    # writes (phases 49-52) nor one left on the machine reshapes another
    # phase, and no adaptation is switched on from outside
    tune_root = tempfile.mkdtemp(prefix="ptt_profiles_")
    os.environ["PTT_TUNE_DIR"] = tune_root
    os.environ.pop("PTT_TUNE_ADAPT", None)
    try:
        return _main()
    finally:
        shutil.rmtree(tune_root, ignore_errors=True)


def _main() -> int:
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
        from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
            ShardedDeviceChecker,
        )
        from pulsar_tlaplus_tpu_torch.kernels import build as kernels
        from pulsar_tlaplus_tpu_torch.models.compaction import (
            CompactionModel,
        )
        from pulsar_tlaplus_tpu_torch.models import registry
        from pulsar_tlaplus_tpu_torch.obs import attribution as obs_attribution
        from pulsar_tlaplus_tpu_torch.obs import metrics as obs_metrics
        from pulsar_tlaplus_tpu_torch.obs import report as obs_report
        from pulsar_tlaplus_tpu_torch.obs import schema as obs_schema
        from pulsar_tlaplus_tpu_torch.obs import trace as obs_trace
        from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
        from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag
        from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec
        from pulsar_tlaplus_tpu_torch.ref import pyeval
        from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
        from pulsar_tlaplus_tpu_torch.store.budget import (
            fmt_bytes as budget_fmt,
        )
        from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod
        from pulsar_tlaplus_tpu_torch.utils import faults
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
        packed, kcols, _dead = ck._lanes(ck._rows[base: base + n])
        # a lane is valid iff its keys are not the all-SENTINEL marker
        return ck, packed, ~fpset.all_sentinel(kcols), kcols, n

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
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                           "-config", os.path.join(SPECS, "compaction.cfg")])
        sys.stderr.write(err.getvalue())
        # the level sizes of the run's progress lines (phase 63 holds the
        # native baseline to them)
        untiered["shipped_levels"] = [
            int(n) for n in re.findall(r"level \d+: \+?(\d+)",
                                       err.getvalue())]
        out = buf.getvalue()
        m = re.search(r"(\d+) distinct states found, search depth "
                      r"\(diameter\) (\d+)", out)
        got = (rc, m and (int(m.group(1)), int(m.group(2))))
        if got != (0, (45198, 20)) or "Error" in out:
            raise AssertionError(f"cli check: rc/counts {got}\n{out}")
        lv = untiered["shipped_levels"]
        if (len(lv), sum(lv)) != (20, 45198):
            raise AssertionError(f"cli check: level lines {lv}\n"
                                 f"{err.getvalue()[-1500:]}")
        return f"cli check: 45198 states, diameter 20, rc 0 ({out.splitlines()[-1]})"

    # untiered results the tiered runs of phases 9 and 11 must equal (and
    # phase 3's level sizes, for phase 63)
    untiered = {}
    counted("3 shipped cfg (cli)", shipped)

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
        untiered["scaled_rate"] = r.states_per_sec
        nv = r.distinct_states
        untiered["scaled_rows"] = ck.last_bufs["rows"][: nv * ck.W].clone()
        untiered["scaled_peak"] = torch.cuda.max_memory_allocated(dev)
        untiered["scaled_store"] = sum(
            t.numel() * 4 for t in (ck._rows, ck._parent, ck._lane))
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
    _s, consts, _m, geo_levels = SPEC_SCALED["geo_exact"]
    _phase("18 profile of georeplication scaled-exact, levels 1-"
           f"{GEO_PROFILE_LEVELS}",
           lambda: profile(phase="18", model=spec_model("georeplication",
                                                        consts),
                           max_states=sum(
                               geo_levels[:GEO_PROFILE_LEVELS]) + 1),
           failures)
    torch.cuda.empty_cache()

    # ---- 19-21: liveness, launch counters zeroed around it
    kernels.reset_launches()
    live = {}

    def live_check(what, lc, pin, fairness, resume=False):
        """The checker's verdict for ``fairness`` (and, once the sweep
        ran, its edge list) against the JAX engine's pins; returns the
        result."""
        lc.fairness = fairness
        r = lc.run(resume=resume)
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
                             **LIVENESS_FULL_KW)
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
                                **LIVENESS_FULL_KW)
        budget = tight_budget(probe._checker)
        lt = LivenessChecker(CompactionModel(full), fairness="wf_next",
                             hbm_budget=budget, **LIVENESS_FULL_KW)
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
        """The 9m tier's exploration (unprofiled: phase 19 times it and
        phase 8 profiles the engine), then a window of its sweep's chunks,
        profiled: the profiler's post-processing grows with the events."""
        lc = LivenessChecker(CompactionModel(tier9m), fairness="wf_next",
                             **LIVENESS_9M_KW)
        lc._explore()
        n = lc._explored[0]
        tcols, tgid = lc._table(n)
        starts = list(range(0, n, lc.SF))

        def window():
            for s in starts[:LIVE_PROFILE_CHUNKS]:
                lc._sweep_chunk(s, n, tcols, tgid)

        return (f"sweep chunks 1-{LIVE_PROFILE_CHUNKS} of {len(starts)}: "
                + where_time(window))

    def profile_sim():
        sim = StreamingSimulator(CompactionModel(scaled_cfg()),
                                 n_walkers=65536, depth=SIM_PROFILE_DEPTH,
                                 seed=SEED)
        return (f"65536 walkers x depth {SIM_PROFILE_DEPTH}: "
                + where_time(sim.run))

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
        bugs = (("CompactedLedgerLeak", 12), ("DuplicateNullKeyMessage", 4))
        # one compiled model for both runs: its graphs are recorded once
        cs, fspec = compile_spec("compaction",
                                 invariants=tuple(inv for inv, _d in bugs))
        for inv, depth in bugs:
            ck = DeviceChecker(cs, invariants=(inv,))
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
        cut = sum(TIER9M_LEVELS[:COMPILED_9M_LEVELS])
        cwindows = sum(1 for _ in range(0, cut, 1 << 16))
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
                                   max_states=cut)
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
                if (r.level_sizes != hand.level_sizes[:COMPILED_9M_LEVELS]
                        or r.violation):
                    raise AssertionError(f"{fuse}: levels {r.level_sizes}")
        finally:
            gc.callbacks.remove(gc_clock)
        # the profile covers the first COMPILED_9M_PROFILE_LEVELS levels:
        # the profiler's tables grow with the events (a minute past
        # level 12)
        pcut = sum(TIER9M_LEVELS[:COMPILED_9M_PROFILE_LEVELS])
        prof = where_time(lambda: DeviceChecker(
            cs, sub_batch=1 << 16, max_states=pcut).run())
        return (f"{cut} states in the first {COMPILED_9M_LEVELS} levels, "
                f"level sizes equal to the hand model's (its run: "
                f"{TIER9M_STATES} states, diameter 24; state width "
                f"{cs.layout.total_bits} bits, {cs.A} lanes; hand model "
                f"{hand_wall:.2f}s fused, "
                f"{hm.host_s:.2f}s host in its successors and invariants, "
                f"{hm.host_s / windows * 1e3:.1f}ms a window); "
                "walls in turns "
                + ", ".join(f"{f} {w:.2f}s ({n} replays, {h:.2f}s host, "
                            f"{h / cwindows * 1e3:.1f}ms host a window, "
                            f"{s} syncs, {g:.2f}s in {m} garbage "
                            f"collections, {a} cudaMalloc)"
                            for f, w, n, h, s, g, m, a in walls)
                + f"; the stage run made {n_sync} card syncs; "
                f"{graph_note(cs)}; profile of the fused run's first "
                f"{COMPILED_9M_PROFILE_LEVELS} levels ({pcut} states): "
                f"{prof}")

    def c_scaled():
        notes = []
        for name, (spec, consts, max_states, pins) in SPEC_SCALED.items():
            cs, _f = compile_spec(spec, **consts)
            if name == "geo_hashed":
                kept[name] = cs
            t = time.time()
            if name in COMPILED_SCALED_LEVELS:
                pins = pins[: COMPILED_SCALED_LEVELS[name]]
                max_states = sum(pins)
            r = DeviceChecker(cs, max_states=max_states).run()
            got = r.level_sizes[: len(pins)]
            if got != pins or (name not in COMPILED_SCALED_LEVELS and (
                    r.truncated or len(r.level_sizes) != len(pins))) or (
                    name in COMPILED_SCALED_LEVELS
                    and r.level_sizes != pins):
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
            # short segments: a walk is keyed by (seed, step, walker),
            # so each seed finds its bug at the same step whatever the
            # segment, and the run stops at that segment's end (every
            # step past the bug is host-bound replays)
            for seed in (0, 1, 2):
                s = StreamingSimulator(cs, invariants=(inv,),
                                       n_walkers=1024, depth=64,
                                       segment_len=COMPILED_SIM_SEGMENT,
                                       seed=seed, max_rounds=20).run()
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

    # ---- 31-35: runs that survive (frames, resume, recovery, the
    # frontier window, the fused tiered handoff, the durable spill),
    # launch counters zeroed around them; frames go to a temporary
    # directory removed at the end
    kernels.reset_launches()
    surv_dir = tempfile.mkdtemp(prefix="ptt_frames_")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PTT_FAULT", None)

    def frame_note(st):
        return (f"{st.get('ckpt_frames', 0)} frame(s), last "
                f"{st.get('ckpt_bytes', 0)} B in all, last stall "
                f"{st.get('ckpt_last_stall_s')}s (D2H "
                f"{st.get('ckpt_last_d2h_s')}s), restore "
                f"{st.get('restore_s')}s")

    def drive(code, *args, fault=None, timeout=600):
        """``python -c code args`` from the checkout (the card's own
        process), ``PTT_FAULT=fault``: (exit code, its last stdout line
        as JSON or None, stderr's end)."""
        e = dict(env, **({"PTT_FAULT": fault} if fault else {}))
        p = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                           cwd=ROOT, env=e, capture_output=True, text=True,
                           timeout=timeout)
        lines = p.stdout.strip().splitlines()
        out = json.loads(lines[-1]) if p.returncode == 0 and lines else None
        return p.returncode, out, p.stderr[-2000:]

    def set_fault(spec):
        if spec is None:
            os.environ.pop("PTT_FAULT", None)
        else:
            os.environ["PTT_FAULT"] = spec
        faults.reset()

    def totals(sizes):
        return list(itertools.accumulate(sizes))

    def scaled_prefix(r):
        """The run's complete levels are the pinned ones."""
        cum = totals(r.level_sizes)
        pins = totals(untiered["scaled"][0])
        n = len(cum) - (1 if r.truncated else 0)
        if cum[:n] != pins[:n]:
            raise AssertionError(f"level totals {cum} not a prefix of "
                                 f"{pins}")
        return cum

    def kill_resume():
        path = os.path.join(surv_dir, "scaled.npz")
        rc, _out, err = drive(SCALED_DRIVER, path, 2, 0,
                              SCALED_TOTAL + 1, fault="kill@level:6")
        if rc != 137 or not os.path.exists(path):
            raise AssertionError(f"killed run: rc {rc}, frame "
                                 f"{os.path.exists(path)}\n{err}")
        rc, out, err = drive(SCALED_DRIVER, path, 100, 1, SCALED_TOTAL + 1)
        if rc != 0:
            raise AssertionError(f"resumed run: rc {rc}\n{err}")
        cum = totals(out["level_sizes"])
        if cum[4:6] != [SCALED_PREV_TOTAL, SCALED_TOTAL]:
            raise AssertionError(f"resumed level totals {cum}")
        frames = out["ckpt_frames"]
        extra = out["card_syncs"] - out["host_syncs"] - 3
        return (
            f"kill@level:6 with frames every 2 levels: rc 137, frame "
            f"on disk; a fresh process's resume: level totals {cum}, "
            f"{out['stop']}; {frame_note(out)}; {out['card_syncs']} card "
            f"syncs against {out['host_syncs']} host reads + 3: "
            f"{extra} for {frames} frame(s) + the restore; wall "
            f"{out['wall']:.2f}s (cumulative over both processes)"
        )

    def oom_drill():
        set_fault("oom@level:7")
        try:
            ck = DeviceChecker(CompactionModel(scaled_cfg()),
                               max_states=SCALED_TOTAL + 1,
                               checkpoint_path=os.path.join(surv_dir,
                                                            "oom.npz"),
                               checkpoint_every=1)
            r = ck.run()
        finally:
            set_fault(None)
        cum = scaled_prefix(r)
        if (r.hbm_recovered, r.stop_reason) != (1, "max_states") or \
                cum[4:6] != [SCALED_PREV_TOTAL, SCALED_TOTAL]:
            raise AssertionError(f"{r.hbm_recovered} {r.stop_reason} {cum}")
        return (f"(a) oom@level:7, frames every level: hbm_recovered 1, "
                f"level totals {cum}; {frame_note(ck.last_stats)} (the "
                "restore: the level-6 frame at full width)")

    def real_oom(with_frame):
        """A real allocator failure: the caching allocator capped at what
        it holds after level 5 (its frame, when there is one), so level
        6's full-width windows cannot allocate."""
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(dev).total_memory
        base = torch.cuda.memory_reserved(dev)
        kw = dict(max_states=SCALED_TOTAL + 1)
        if with_frame:
            kw.update(checkpoint_path=os.path.join(surv_dir, "real.npz"),
                      checkpoint_every=1)
        ck = DeviceChecker(CompactionModel(scaled_cfg()), **kw)
        if with_frame:
            save = ck._save_frame

            def capped(level_sizes, *a):
                ok = save(level_sizes, *a)
                if ok and len(level_sizes) == 5:
                    held = torch.cuda.memory_reserved(dev)
                    oom_cap["need5"] = held - base
                    torch.cuda.set_per_process_memory_fraction(
                        held / total, dev)
                return ok

            ck._save_frame = capped
        else:
            torch.cuda.set_per_process_memory_fraction(
                (base + oom_cap["need5"]) / total, dev)
        try:
            r = ck.run()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
            torch.cuda.empty_cache()
        if ck.device.type != "cuda":
            raise AssertionError("the run left the card")
        cum = scaled_prefix(r)
        if with_frame:
            ok = (r.hbm_recovered >= 1 and (
                r.stop_reason == "hbm" or cum[4:6] == [SCALED_PREV_TOTAL,
                                                      SCALED_TOTAL]))
        else:
            ok = r.stop_reason == "hbm" and r.hbm_recovered == 0
        if not ok:
            raise AssertionError(f"{r.stop_reason}, hbm_recovered "
                                 f"{r.hbm_recovered}, totals {cum}")
        return (f"cap at {oom_cap['need5'] / 2**30:.2f} GiB over the "
                f"start: {r.stop_reason or 'complete'}, hbm_recovered "
                f"{r.hbm_recovered}, level totals {cum}")

    oom_cap = {}

    def device_memory():
        notes = [oom_drill()]
        notes.append("(b) real, after a frame: " + real_oom(True))
        notes.append("(c) the same cap, no frame: " + real_oom(False))
        return "; ".join(notes)

    def frontier():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        path = os.path.join(surv_dir, "frontier.npz")
        ck = DeviceChecker(CompactionModel(scaled_cfg()),
                           max_states=SCALED_TOTAL + 1,
                           rows_window="frontier",
                           row_cap_states=FRONTIER_ROWS,
                           checkpoint_path=path, checkpoint_every=100)
        r = ck.run()
        peak = torch.cuda.max_memory_allocated(dev)
        cum = scaled_prefix(r)
        if cum[4:6] != [SCALED_PREV_TOTAL, SCALED_TOTAL] or r.violation:
            raise AssertionError(f"level totals {cum}")
        par, lan = ck.merged_logs()
        sizes, want_par, want_lan = untiered["scaled"]
        if not (np.array_equal(par, want_par)
                and np.array_equal(lan, want_lan)):
            raise AssertionError("parent/lane logs differ from phase 6's")
        rows_lo = int(np.load(path)["rows_lo"])
        store = sum(t.numel() * 4 for t in (ck._rows, ck._parent, ck._lane))
        return (
            f"rows_window=frontier, row_cap_states {FRONTIER_ROWS} "
            f"(window {ck.LCAP} rows): level totals {cum} and logs equal "
            f"to phase 6's, {r.stop_reason}, {r.wall_s:.2f}s, host_syncs "
            f"{ck.last_stats['host_syncs']}; peak device memory "
            f"{peak / 2**30:.2f} GiB against the all-rows run's "
            f"{untiered.get('scaled_peak', 0) / 2**30:.2f} GiB (phase 6), "
            f"its row window and logs {store / 2**30:.2f} GiB against "
            f"{untiered.get('scaled_store', 0) / 2**30:.2f} GiB; "
            f"the truncation frame from gid {rows_lo}: "
            f"{frame_note(ck.last_stats)}"
        )

    def tiered_durable():
        m = CompactionModel(scaled_cfg())
        b = budget_for_table(m, TIERED_TCAP, max_states=SCALED_TOTAL + 1)
        path = os.path.join(surv_dir, "tiered.npz")
        k3 = kernels.LAUNCHES["sieve_mask"]
        torch.cuda.empty_cache()
        set_fault("sigterm@level:6")
        try:
            ck = DeviceChecker(m, max_states=SCALED_TOTAL + 1, hbm_budget=b,
                               checkpoint_path=path)
            r1 = ck.run()
        finally:
            set_fault(None)
        st1 = dict(ck.last_stats)
        if r1.stop_reason != "preempted" or "spill_manifest" not in \
                np.load(path).files:
            raise AssertionError(f"{r1.stop_reason}: no frame/manifest")
        scaled_prefix(r1)
        n_files = len(os.listdir(path + ".spill"))
        ck = DeviceChecker(m, max_states=SCALED_TOTAL + 1, hbm_budget=b,
                           checkpoint_path=path)
        r2 = ck.run(resume=True)
        same = same_run("scaled", untiered["scaled"], ck, r2)
        k3 = kernels.LAUNCHES["sieve_mask"] - k3
        if k3 <= 0:
            raise AssertionError("K3 never launched")
        note = (
            f"budget {b}: sigterm@level:6 -> preempted after level "
            f"{len(r1.level_sizes)} in {r1.wall_s:.2f}s (handoff latched "
            f"at level {st1['handoff_level']} after "
            f"{st1['fused_levels_before_handoff']} fused levels; "
            f"{st1['spill_evictions']} evictions, {st1['spill_rows_evicted']}"
            f" rows spilled, {n_files} spill files; "
            f"{frame_note(st1)}); resumed: {r2.stop_reason} at "
            f"{r2.distinct_states} states, wall {r2.wall_s:.2f}s "
            f"cumulative against 7.18 s of the stage-from-start path (PR "
            f"6), {frame_note(ck.last_stats)}; merged {same} equal to "
            f"phase 6's; K3 launches {k3}"
        )
        shutil.rmtree(path + ".spill", ignore_errors=True)
        set_fault("enospc@spill:1")
        try:
            ck = DeviceChecker(m, max_states=SCALED_TOTAL + 1, hbm_budget=b,
                               checkpoint_path=os.path.join(surv_dir,
                                                            "enospc.npz"))
            r3 = ck.run()
        finally:
            set_fault(None)
        cum = scaled_prefix(r3)
        if r3.stop_reason != "spill_enospc" or \
                not ck.last_stats["spill_degraded"]:
            raise AssertionError(f"enospc: {r3.stop_reason}")
        return (note + f"; enospc@spill:1: {r3.stop_reason} at level "
                f"totals {cum}, spill_degraded True")

    def live_sim_resume():
        notes = []
        path = os.path.join(surv_dir, "live.npz")
        rc, _o, err = drive(LIVE_DRIVER % (
            LIVENESS_FULL_KW["frontier_chunk"],
            LIVENESS_FULL_KW["visited_cap"]), path, fault="kill@sweep:10")
        if rc != 137 or not os.path.exists(path):
            raise AssertionError(f"liveness kill: rc {rc}\n{err}")
        lc = LivenessChecker(CompactionModel(full_cfg), checkpoint_path=path,
                             **LIVENESS_FULL_KW)
        t = time.time()
        live_check("253361 resumed", lc, LIVENESS_PINS["full"], "wf_next",
                   resume=True)
        notes.append(
            f"253361-state config wf_next killed at sweep chunk 10 of "
            f"{-(-253361 // lc.SF)} (frames every 4 chunks), resumed in "
            f"{time.time() - t:.2f}s with no re-exploration: verdict, "
            f"lasso and {lc.last_stats['edges']} edges equal to the pins")
        del lc
        torch.cuda.empty_cache()
        path = os.path.join(surv_dir, "sim.npz")
        kw = dict(n_walkers=65536, depth=64, seed=SEED, max_rounds=2)
        full = StreamingSimulator(CompactionModel(scaled_cfg()), **kw).run()
        rc, _o, err = drive(SIM_DRIVER % SEED, path,
                             fault="kill@segment:3")
        if rc != 137 or not os.path.exists(path):
            raise AssertionError(f"simulation kill: rc {rc}\n{err}")
        res = StreamingSimulator(CompactionModel(scaled_cfg()),
                                 checkpoint_path=path, **kw).run(resume=True)
        for f in ("steps", "states_visited", "walks", "violation"):
            if getattr(res, f) != getattr(full, f):
                raise AssertionError(f"simulation resume: {f} differs")
        if res.stats["sim_walk_digest"] != full.stats["sim_walk_digest"]:
            raise AssertionError("simulation resume: walk digest differs")
        notes.append(
            f"65536 walkers x depth 64, 2 rounds ({full.segments} "
            f"segments): killed at segment 3, resumed: walk digest "
            f"{full.stats['sim_walk_digest'][:16]} and counters equal")
        # the seeded bug across a preemption (at 65,536 walkers it shows
        # in the first segment, before any frame: a 64-walker swarm)
        c = pyeval.SHIPPED_CFG
        kw = dict(n_walkers=64, depth=16, segment_len=4, seed=0,
                  max_rounds=8, invariants=("CompactedLedgerLeak",))
        full = StreamingSimulator(CompactionModel(c), **kw).run()
        path = os.path.join(surv_dir, "sim_bug.npz")
        set_fault(f"sigterm@segment:{max(1, full.segments - 3)}")
        try:
            a = StreamingSimulator(CompactionModel(c), checkpoint_path=path,
                                   checkpoint_every=2, **kw).run()
        finally:
            set_fault(None)
        b = StreamingSimulator(CompactionModel(c), checkpoint_path=path,
                               **kw).run(resume=True)
        if a.stop_reason != "preempted" or (b.trace, b.violation_step,
                                            b.verified) != (
                full.trace, full.violation_step, True):
            raise AssertionError("simulation bug across a frame differs")
        trace_ok(c, "CompactedLedgerLeak", b.trace, b.trace_actions)
        notes.append(
            f"CompactedLedgerLeak seed 0 (64 walkers): preempted at "
            f"segment {a.segments}, resumed: the same trace of "
            f"{len(b.trace)} states at step {b.violation_step}, verified")
        return "; ".join(notes)

    _phase("31 kill and resume, fused level, scaled cfg", kill_resume,
           failures)
    _phase("32 device-memory recovery: drill, real cap with and without "
           "a frame", device_memory, failures)
    torch.cuda.empty_cache()
    _phase("33 frontier row window, scaled cfg", frontier, failures)
    torch.cuda.empty_cache()
    _phase("34 tiered: fused handoff, durable spill, preempt, resume, "
           "ENOSPC", tiered_durable, failures)
    torch.cuda.empty_cache()
    _phase("35 liveness and simulation resume", live_sim_resume, failures)
    shutil.rmtree(surv_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    surv_launches = dict(kernels.LAUNCHES)
    print(f"[35b launches on the survivability path] {surv_launches}",
          flush=True)
    for name in TIERED_PATH_KERNELS:
        if surv_launches[name] <= 0:
            failures.append(f"35b: {name} never launched on the "
                            "survivability path")

    # ---- 36-39: the mesh-sharded engine, SHARDS shards on this card,
    # launch counters zeroed around them
    single_launches = collections.Counter()  # the single-card engine's
    kernels.reset_launches()
    sharded = {}
    SKW = dict(n_devices=SHARDS, sub_batch=SHARD_SUB_BATCH)

    def off_path(fn, *a):
        """``fn(*a)``, a run of the single-card engine: its kernel
        launches go to ``single_launches``, not to the sharded path's."""
        before = dict(kernels.LAUNCHES)
        try:
            return fn(*a)
        finally:
            for k, v in kernels.LAUNCHES.items():
                single_launches[k] += v - before[k]

    def same_shards(a, b):
        """Every shard's rows and logs of run ``a`` equal run ``b``'s."""
        if not np.array_equal(a.last_stats_matrix[:, :2],
                              b.last_stats_matrix[:, :2]):
            return False
        for s in range(a.N):
            n = int(a.last_stats_matrix[s, 0])
            for k, w in (("rows", a.W), ("parent", 1), ("lane", 1)):
                if not torch.equal(a.last_bufs[k][s][: n * w].cpu(),
                                   b.last_bufs[k][s][: n * w].cpu()):
                    return False
        return True

    def sharded_scaled():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ck = ShardedDeviceChecker(CompactionModel(scaled_cfg()),
                                  max_states=SCALED_TOTAL + 1, **SKW)
        r, card_syncs = _card_syncs(torch, ck.run)
        cum = totals(r.level_sizes)
        if cum[4:6] != [SCALED_PREV_TOTAL, SCALED_TOTAL] or r.violation:
            raise AssertionError(f"level totals {cum}, {r.violation}")
        st = ck.last_stats
        if card_syncs > st["host_syncs"] + SHARD_SYNC_SLACK:
            raise AssertionError(
                f"{card_syncs} card syncs against {st['host_syncs']} host "
                f"fetches + {SHARD_SYNC_SLACK}")
        peak = torch.cuda.max_memory_allocated(dev)
        sharded["scaled"] = (r.level_sizes[:6], _shard_digest(ck, 6))
        per = ck.last_stats_matrix[:, 0].tolist()
        del ck
        torch.cuda.empty_cache()
        # one shard against the single-card engine, in turns
        walls = []
        for _ in range(2):
            for name in ("sharded N=1", "single-card"):
                m = CompactionModel(scaled_cfg())
                c1 = (ShardedDeviceChecker(m, n_devices=1,
                                           sub_batch=SHARD_SUB_BATCH,
                                           max_states=SCALED_TOTAL + 1)
                      if name.startswith("sharded")
                      else DeviceChecker(m, max_states=SCALED_TOTAL + 1))
                r1 = c1.run() if name.startswith("sharded") \
                    else off_path(c1.run)
                if totals(r1.level_sizes)[4:6] != [SCALED_PREV_TOTAL,
                                                   SCALED_TOTAL]:
                    raise AssertionError(f"{name}: {r1.level_sizes}")
                walls.append(f"{name} {r1.wall_s:.3f}s")
                del c1
                torch.cuda.empty_cache()
        routed = st["level_route_bytes"]
        return (
            f"N={SHARDS} on one card, sub_batch {SHARD_SUB_BATCH}: level "
            f"totals {cum} (stop {r.stop_reason}); {r.distinct_states} "
            f"states in {r.wall_s:.3f}s = {r.states_per_sec:.0f} st/s; "
            f"per shard {per}; host fetches {st['host_syncs']} ({card_syncs}"
            f" card syncs); {st['flushes']} flushes, table "
            f"{st['fpset_table_cap']} slots a shard, max load "
            f"{st['fpset_max_occupancy']}; peak {peak / 2**30:.2f} GiB; "
            f"bytes routed a level {routed} ({st['routed_bytes']} in all, "
            f"route_slack {st['route_slack']}); walls in turns: "
            + ", ".join(walls)
        )

    def sharded_shapes():
        notes = []
        spec, consts, max_states, sizes = SPEC_SCALED["geo_exact"]
        torch.cuda.empty_cache()
        ck = ShardedDeviceChecker(spec_model(spec, consts),
                                  max_states=max_states, **SKW)
        r = ck.run()
        if (r.level_sizes, r.violation, r.deadlock) != (sizes, None, False):
            raise AssertionError(f"geo_exact: {r.level_sizes}")
        notes.append(
            f"geo_exact (K {ck.K}, exact): {r.distinct_states} / "
            f"{r.diameter} equal to the pins in {r.wall_s:.3f}s = "
            f"{r.states_per_sec:.0f} st/s, {ck.last_stats['host_syncs']} "
            f"fetches, per shard {ck.last_stats_matrix[:, 0].tolist()}")
        del ck
        torch.cuda.empty_cache()
        ck = ShardedDeviceChecker(CompactionModel(full_cfg), invariants=(),
                                  n_slices=2, **SKW)
        r = ck.run()
        if (r.distinct_states, r.diameter) != (253361, 23):
            raise AssertionError(f"2x2: {r.distinct_states}/{r.diameter}")
        notes.append(f"253361 / 23 on a 2x2 mesh in {r.wall_s:.3f}s")
        want = r.level_sizes
        ck = ShardedDeviceChecker(CompactionModel(full_cfg), invariants=(),
                                  route_slack=0.05, **SKW)
        r = ck.run()
        if ck.route_slack <= 0.05 or r.level_sizes != want:
            raise AssertionError(f"route overflow: slack {ck.route_slack}, "
                                 f"{r.level_sizes}")
        notes.append(f"route_slack 0.05 overflowed and recovered at "
                     f"{ck.route_slack} to the same level sizes")
        return "; ".join(notes)

    def sharded_cli():
        notes = []
        cfg = os.path.join(SPECS, "compaction.cfg")

        def cli_run(*flags, spec="compaction"):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["check", os.path.join(SPECS, f"{spec}.tla"),
                               "-config", cfg, *flags])
            m = re.search(r"(\d+) distinct states found, search depth "
                          r"\(diameter\) (\d+)", out.getvalue())
            return (rc, m and (int(m.group(1)), int(m.group(2))),
                    out.getvalue(), err.getvalue())

        for flags, want_rc, want_n, depth, tag in (
            (("-sharded", "4"), 0, 45198, 20, "over 4 shards on"),
            (("-sharded", "4", "-slices", "2"), 0, 45198, 20,
             "over 4 shards, 2x2 mesh on"),
            (("-force-compile", "-sharded", "2"), 0, 45198, 20,
             "over 2 shards on"),
            (("-sharded", "4", "-invariant", "CompactedLedgerLeak"), 1,
             None, 12, "over 4 shards on"),
            (("-sharded", "4", "-invariant", "DuplicateNullKeyMessage"), 1,
             None, 4, "over 4 shards on"),
        ):
            rc, got, out, _err = cli_run(*flags)
            if (rc != want_rc or got is None or got[1] != depth
                    or want_n not in (None, got[0]) or tag not in out):
                raise AssertionError(f"{flags}: rc {rc} {got}\n{out}")
            notes.append(f"{' '.join(flags)}: rc {rc}, {got}")
        # -workers 4 is -sharded min(4, cards); on one card it runs the
        # single-card engine, whose launches stay off the sharded path
        cards = max(torch.cuda.device_count(), 1)
        n = min(4, cards)
        capped = (f" (capped from 4: {cards} devices available)"
                  if n != 4 else "")
        if n == 1:
            rc, got, out, err = off_path(cli_run, "-workers", "4")
            ok = (f"runs the single-chip device engine{capped}" in err
                  and "shards" not in out)
        else:
            rc, got, out, err = cli_run("-workers", "4")
            ok = (f"maps to -sharded {n} (mesh-sharded checking){capped}"
                  in out and f"over {n} shards" in out)
        if (rc, got) != (0, (45198, 20)) or not ok:
            raise AssertionError(f"-workers 4: {rc} {got}\n{out}\n{err}")
        notes.append(f"-workers 4 on {cards} card(s): "
                     + ("the single-card engine" if n == 1
                        else f"-sharded {n}") + ", 45198/20")
        # the checker runs behind those lines, card against CPU
        for inv, slices, depth in ((None, 1, 20), (None, 2, 20),
                                   ("CompactedLedgerLeak", 1, 12),
                                   ("DuplicateNullKeyMessage", 1, 4)):
            kw = dict(n_devices=4, n_slices=slices,
                      sub_batch=cli.SHARDED_CHUNK,
                      **({"invariants": (inv,)} if inv else {}))
            m = CompactionModel(pyeval.SHIPPED_CFG)
            a = ShardedDeviceChecker(m, **kw)
            ra = a.run()
            b = ShardedDeviceChecker(m, device="cpu", **kw)
            rb = b.run()
            if (ra.level_sizes, ra.violation_gid, ra.trace) != (
                    rb.level_sizes, rb.violation_gid, rb.trace) \
                    or ra.diameter != depth or not same_shards(a, b):
                raise AssertionError(f"{inv} {slices}: card != CPU")
            if inv:
                check_trace(pyeval.SHIPPED_CFG, inv, depth, ra)
            notes.append(f"{inv or 'shipped'} mesh {a.D}x{a.I}: card equal "
                         f"to CPU shard for shard ({ra.wall_s:.3f}s against "
                         f"{rb.wall_s:.3f}s)")
        return "; ".join(notes)

    def sharded_survive():
        path = os.path.join(surv_dir, "sharded.npz")
        code = SHARDED_DRIVER % (SHARDS, SHARD_SUB_BATCH, SCALED_TOTAL + 1)
        os.makedirs(surv_dir, exist_ok=True)
        rc, _out, err = drive(code, path, 2, 0, fault="kill@level:6")
        if rc != 137 or not os.path.exists(path):
            raise AssertionError(f"killed run: rc {rc}\n{err}")
        rc, out, err = drive(code, path, 100, 1)
        sizes, digest = sharded["scaled"]
        if rc != 0 or (out["level_sizes"][:6], out["digest"]) != (sizes,
                                                                 digest):
            raise AssertionError(f"resumed run: rc {rc} {out}\n{err}")
        notes = [f"kill@level:6, frames every 2 levels: rc 137; resumed in "
                 f"a fresh process to phase 36's level sizes and the "
                 f"digest of every shard's rows and logs through level 6 "
                 f"({out['frames']} frame(s) in the resumed run, wall "
                 f"{out['wall']:.2f}s over both)"]
        pin = LIVENESS_PINS["full"]
        torch.cuda.empty_cache()
        lc = LivenessChecker(CompactionModel(full_cfg), fairness="wf_next",
                             n_devices=SHARDS, **LIVENESS_FULL_KW)
        for fairness in ("wf_next", "none"):
            lc.fairness = fairness
            t = time.time()
            r = lc.run()
            wall = time.time() - t
            got = (r.holds, r.reason, r.lasso_prefix, r.lasso_cycle)
            if (r.distinct_states, got) != (pin["distinct"],
                                            pin["verdicts"][fairness]):
                raise AssertionError(f"253361 {fairness}: "
                                     f"{r.distinct_states} {got}")
            if fairness == "wf_next":
                src, _dst, out_deg = lc._edge_cache
                if (len(src), np.bincount(out_deg).tolist()) != (
                        pin["edges"], pin["out_deg_hist"]):
                    raise AssertionError(f"253361 edges {len(src)}")
                st = lc.last_stats
                notes.append(
                    f"253361-state config liveness on {SHARDS} shards: "
                    f"{r.distinct_states} states, {len(src)} edges, "
                    f"out-degree histogram equal "
                    f"to the pins; wf_next holds in {wall:.2f}s (explore "
                    f"{st['explore_s']:.2f}s, sweep {st['sweep_s']:.2f}s, "
                    f"analysis {st['analysis_s']:.2f}s)")
            else:
                notes.append(f"none: {r.reason[:40]}... in {wall:.2f}s")
        del lc
        torch.cuda.empty_cache()
        return "; ".join(notes)

    _phase("36 sharded: scaled cfg on 4 shards, one card", sharded_scaled,
           failures)
    _phase("37 sharded: geo_exact, 2x2 mesh, route overflow",
           sharded_shapes, failures)
    _phase("38 sharded: cli -sharded/-slices/-workers, card vs CPU",
           sharded_cli, failures)
    _phase("39 sharded: kill and resume, liveness over the mesh",
           sharded_survive, failures)
    shutil.rmtree(surv_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    shard_launches = {k: v - single_launches[k]
                      for k, v in kernels.LAUNCHES.items()}
    print(f"[39b launches on the sharded path] {shard_launches} (the "
          f"single-card engine's left out: {dict(single_launches)})",
          flush=True)
    for name in MAIN_PATH_KERNELS:
        if shard_launches[name] <= 0:
            failures.append(f"39b: {name} never launched on the sharded "
                            "path")

    # ---- 40-43: seeded starts, the sort-merge visited set and the host
    # engines, launch counters zeroed around them (comparison runs of
    # earlier paths go through engines_off)
    engines_single = collections.Counter()
    kernels.reset_launches()
    eng_dir = tempfile.mkdtemp(prefix="ptt_engines_")

    def engines_off(fn, *a):
        """``fn(*a)``, a run of an earlier slice's path: its launches go
        to ``engines_single``, not to phases 40-43's count."""
        before = dict(kernels.LAUNCHES)
        try:
            return fn(*a)
        finally:
            for k, v in kernels.LAUNCHES.items():
                engines_single[k] += v - before[k]

    METRIC_KEYS = {"level", "new_states", "distinct_states", "frontier",
                   "wall_s", "host_wait_s", "states_per_sec", "visited_cap"}

    def seeded_scaled():
        m = CompactionModel(scaled_cfg())
        t = time.time()
        # the first SEED_LEVELS levels (the bench's caps, 800,000 and
        # 1,000,000, take five, and 40 s of the host's oracle)
        seed = m.host_seed(max_level_states=30_000, max_total=32_000)
        host_s = time.time() - t
        n, lsizes = len(seed[0]), list(seed[3])
        if lsizes != untiered["scaled"][0][:SEED_LEVELS]:
            raise AssertionError(f"seed levels {lsizes}")
        mpath = os.path.join(eng_dir, "seeded.jsonl")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ck = DeviceChecker(m, max_states=SCALED_TOTAL + 1,
                           rows_window="frontier",
                           row_cap_states=FRONTIER_ROWS, metrics_path=mpath)
        t = time.time()
        ck.prestage_seed(seed)
        torch.cuda.synchronize(dev)
        stage_s = time.time() - t
        r = ck.run(seed=seed)
        cum = totals(r.level_sizes)
        if cum[4:6] != [SCALED_PREV_TOTAL, SCALED_TOTAL] or r.violation:
            raise AssertionError(f"level totals {cum}, {r.violation}")
        if cum[:6] != totals(untiered["scaled"][0])[:6]:
            raise AssertionError("level totals differ from phase 6's")
        recs = [json.loads(ln) for ln in open(mpath)]
        if not recs or any(not METRIC_KEYS <= set(x) for x in recs):
            raise AssertionError(f"metrics records {recs}")
        peak = torch.cuda.max_memory_allocated(dev)
        st = ck.last_stats
        del ck
        torch.cuda.empty_cache()
        # the second frontier guard alone: the window admits the seed
        # (n + SEED_CHUNK <= LCAP) but not its frontier plus one append
        # window (lsizes[-1] + NQ > LCAP).  Some window isolates it only
        # if the seed's last level passes min(n, 2^15), which the
        # four-level seed's does not: the guard gets levels 1-5, from a
        # card run stopped at their end
        pk = DeviceChecker(m, max_states=SCALED_PREV_TOTAL)
        pr = engines_off(pk.run)
        if pr.level_sizes != untiered["scaled"][0][:5]:
            raise AssertionError(f"five-level prefix {pr.level_sizes}")
        gn = SCALED_PREV_TOTAL
        gseed = (pk.merged_rows().reshape(gn, pk.W), *pk.merged_logs(),
                 pr.level_sizes)
        del pk
        sub = 8192
        nq = sub * m.A
        rc = max(gn + min(1 << 15, nq) - nq, nq)
        if not rc < pr.level_sizes[-1]:
            raise AssertionError(f"no window isolates the guard ({rc})")
        g = DeviceChecker(m, sub_batch=sub, rows_window="frontier",
                          row_cap_states=rc, max_states=SCALED_TOTAL + 1)
        try:
            g.run(seed=gseed)
            raise AssertionError("the seed-frontier guard did not raise")
        except ValueError as e:
            if "seed frontier" not in str(e):
                raise
        return (
            f"host_seed {n} states {lsizes} in {host_s:.2f}s (host), "
            f"prestaged in {stage_s:.3f}s; seeded run from level "
            f"{len(lsizes) + 1}: level totals {cum} (stop "
            f"{r.stop_reason}) in {r.wall_s:.2f}s against phase 6's "
            f"unseeded {untiered['scaled_wall']:.2f}s; {len(recs)} metrics "
            f"records with the JAX keys (last {recs[-1]}); host_syncs "
            f"{st['host_syncs']}; peak {peak / 2**30:.2f} GiB; the "
            f"seed-frontier guard raised on the five-level prefix at "
            f"row_cap_states {rc}"
        )

    def seeded_card_cpu():
        notes = []
        m = CompactionModel(pyeval.SHIPPED_CFG)
        for inv, caps, depth in (("CompactedLedgerLeak", (3000, 5000), 12),
                                 ("DuplicateNullKeyMessage", (12000, 20000),
                                  4)):
            seed = m.host_seed(*caps)
            runs = []
            for d in (None, "cpu"):
                ck = DeviceChecker(m, invariants=(inv,), sub_batch=2048,
                                   device=d)
                r = ck.run(seed=seed)
                runs.append((r, ck.merged_rows(), *ck.merged_logs()))
            (ra, *a), (rb, *b) = runs
            if (ra.level_sizes, ra.violation_gid, ra.trace,
                    ra.trace_actions) != (rb.level_sizes, rb.violation_gid,
                                          rb.trace, rb.trace_actions) \
                    or not all(np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{inv}: card != CPU")
            check_trace(pyeval.SHIPPED_CFG, inv, depth, ra)
            notes.append(f"{inv} seeded at {len(seed[3])} levels: gid "
                         f"{ra.violation_gid}, depth {depth}, rows and logs "
                         "card = CPU")
        seed = m.host_seed(3000, 5000)
        kw = dict(n_devices=SHARDS, sub_batch=2048,
                  invariants=("CompactedLedgerLeak",))
        a = ShardedDeviceChecker(m, **kw)
        ra = a.run(seed=seed)
        b = ShardedDeviceChecker(m, device="cpu", **kw)
        rb = b.run(seed=seed)
        if (ra.level_sizes, ra.violation_gid, ra.trace) != (
                rb.level_sizes, rb.violation_gid, rb.trace) \
                or not same_shards(a, b) or ra.diameter != 12:
            raise AssertionError("seeded sharded: card != CPU")
        notes.append(f"seeded ShardedDeviceChecker N = {SHARDS}: gid "
                     f"{ra.violation_gid}, card = CPU shard for shard")
        return "; ".join(notes)

    def visited_sort():
        notes = []
        sizes, rows, par, lan = untiered["full"]
        ck = DeviceChecker(CompactionModel(full_cfg), invariants=(),
                           visited_impl="sort")
        r = ck.run()
        if (r.distinct_states, r.diameter) != (253361, 23) or not (
                r.level_sizes == sizes
                and np.array_equal(ck.merged_rows(), rows)
                and all(np.array_equal(x, y)
                        for x, y in zip(ck.merged_logs(), (par, lan)))):
            raise AssertionError("sort: differs from phase 4's fpset run")
        notes.append(f"DeviceChecker sort: 253361 / 23, rows and logs gid "
                     f"for gid equal to phase 4's fpset run ({r.wall_s:.3f}s)")
        kw = dict(n_devices=SHARDS, sub_batch=SHARD_SUB_BATCH,
                  invariants=())
        m = CompactionModel(full_cfg)
        a = ShardedDeviceChecker(m, visited_impl="sort", **kw)
        ra = a.run()
        b = ShardedDeviceChecker(m, **kw)
        rb = engines_off(b.run)
        if (ra.distinct_states, ra.diameter) != (253361, 23) \
                or not same_shards(a, b):
            raise AssertionError("sharded sort != sharded fpset")
        notes.append(f"ShardedDeviceChecker N = {SHARDS} sort: 253361 / 23, "
                     f"shard for shard equal to fpset ({ra.wall_s:.3f}s "
                     f"against {rb.wall_s:.3f}s)")
        del a, b
        # the sort-merge flush against the fpset one in turns
        walls = []
        for vi in ("fpset", "sort", "sort", "fpset"):
            c2 = DeviceChecker(CompactionModel(full_cfg), invariants=(),
                               visited_impl=vi, fuse="stage")
            r2 = (engines_off(c2.run) if vi == "fpset" else c2.run())
            walls.append(f"{vi} {r2.wall_s:.3f}s")
        torch.cuda.empty_cache()
        cap = SCALED_PREV_TOTAL + 1
        ck = DeviceChecker(CompactionModel(scaled_cfg()), max_states=cap,
                           visited_impl="sort")
        r = ck.run()
        cum = totals(r.level_sizes)
        if cum[:5] != totals(untiered["scaled"][0])[:5]:
            raise AssertionError(f"scaled sort: level totals {cum}")
        st = ck.last_stats
        del ck
        torch.cuda.empty_cache()
        notes.append(f"stage loop in turns on 253361: {', '.join(walls)}; "
                     f"scaled sort cut at {cap}: level totals {cum} "
                     f"({r.stop_reason}) equal to phase 6's, {r.wall_s:.2f}s, "
                     f"{st['host_syncs']} host syncs")
        return "; ".join(notes)

    def host_engine():
        import hashlib

        from pulsar_tlaplus_tpu_torch.engine.bfs import Checker

        notes = []
        ship = pyeval.SHIPPED_CFG
        for dedup in ("hash", "sort"):
            for c, inv, want in (
                (ship, (), (45198, 20)),
                (full_cfg, (), (253361, 23)),
                (ship, ("CompactedLedgerLeak",), ("CompactedLedgerLeak", 12)),
                (ship, ("DuplicateNullKeyMessage",),
                 ("DuplicateNullKeyMessage", 4)),
            ):
                r = Checker(CompactionModel(c), invariants=inv,
                            dedup=dedup).run()
                got = ((r.violation, r.diameter) if inv
                       else (r.distinct_states, r.diameter))
                if got != want:
                    raise AssertionError(f"{dedup} {inv}: {got}")
                if inv:
                    check_trace(c, inv[0], want[1], r)
                notes.append(f"{dedup} {inv[0] if inv else want[0]}: "
                             f"{got[1]} in {r.wall_s:.2f}s")
        # card against CPU, and a file-backed log (the native store)
        inv = ("CompactedLedgerLeak",)
        logs = []
        for d, path in ((None, os.path.join(eng_dir, "host.log")),
                        ("cpu", None)):
            ck = Checker(CompactionModel(ship), invariants=inv,
                         keep_log=True, state_log_path=path, device=d)
            r = ck.run()
            lg = ck.last_run_state.log
            if path is not None and not lg.native:
                raise AssertionError("the native log store did not load")
            logs.append((r.violation_gid, lg.packed_matrix(),
                         np.asarray([lg.get(g)[1] for g in range(len(lg))]),
                         np.asarray([lg.get(g)[2] for g in range(len(lg))])))
        if logs[0][0] != logs[1][0] or not all(
                np.array_equal(x, y) for x, y in zip(logs[0][1:],
                                                     logs[1][1:])):
            raise AssertionError("host engine: card != CPU")
        notes.append(f"card (native FileLog) = CPU (MemoryLog), gid "
                     f"{logs[0][0]}")
        # kill and resume in processes of their own
        path = os.path.join(eng_dir, "host.npz")
        rc, _o, err = drive(HOST_DRIVER, path, 0, fault="kill@level:8")
        if rc != 137 or not os.path.exists(path):
            raise AssertionError(f"killed host run: rc {rc}\n{err}")
        rc, out, err = drive(HOST_DRIVER, path, 1)
        ck = Checker(CompactionModel(ship), keep_log=True)
        r = ck.run()
        lg = ck.last_run_state.log
        h = hashlib.sha256()
        for a in (lg.packed_matrix(), lg.parents(), lg.actions()):
            h.update(np.ascontiguousarray(a).tobytes())
        full = dict(n=r.distinct_states, level_sizes=r.level_sizes,
                    digest=h.hexdigest())
        if rc or out != full:
            raise AssertionError(f"resumed {rc} {out} vs {full}\n{err}")
        notes.append(f"kill@level:8 then resume in a fresh process: level "
                     f"sizes and log digest equal to the uninterrupted "
                     f"run's ({full['n']} states)")
        # the host engine against the device engine in turns
        walls = []
        for eng in ("device", "host", "host", "device"):
            if eng == "host":
                rr = Checker(CompactionModel(full_cfg), invariants=()).run()
            else:
                rr = engines_off(DeviceChecker(CompactionModel(full_cfg),
                                               invariants=()).run)
            walls.append(f"{eng} {rr.wall_s:.3f}s")
        notes.append(f"253361 in turns: {', '.join(walls)}")
        return "; ".join(notes)

    def sharded_host():
        from pulsar_tlaplus_tpu_torch.engine.sharded import ShardedChecker
        from pulsar_tlaplus_tpu_torch.parallel.mesh import make_mesh2d

        notes = []
        ship = pyeval.SHIPPED_CFG
        for dedup in ("sort", "hash"):
            for slices in (1, 2):
                for c, inv, want in ((ship, (), (45198, 20)),
                                     (ship, ("DuplicateNullKeyMessage",),
                                      ("DuplicateNullKeyMessage", 4))):
                    ck = ShardedChecker(
                        CompactionModel(c), invariants=inv,
                        frontier_chunk=cli.SHARDED_CHUNK, dedup_mode=dedup,
                        mesh=make_mesh2d(slices, SHARDS // slices))
                    r = ck.run()
                    got = ((r.violation, r.diameter) if inv
                           else (r.distinct_states, r.diameter))
                    if got != want:
                        raise AssertionError(f"{dedup} {slices}: {got}")
                    if inv:
                        check_trace(c, inv[0], want[1], r)
                    notes.append(f"{dedup} {slices}x{SHARDS // slices} "
                                 f"{got}: {r.wall_s:.2f}s")
        logs = []
        for d in (None, "cpu"):
            ck = ShardedChecker(CompactionModel(ship), invariants=(),
                                n_devices=SHARDS, dedup_mode="hash",
                                frontier_chunk=cli.SHARDED_CHUNK, device=d)
            r = ck.run()
            lg = ck.last_log
            logs.append((r.level_sizes, lg.packed_matrix(), lg.parents(),
                         lg.actions()))
        if logs[0][0] != logs[1][0] or not all(
                np.array_equal(x, y) for x, y in zip(logs[0][1:],
                                                     logs[1][1:])):
            raise AssertionError("sharded host: card != CPU")
        notes.append(f"hash N = {SHARDS} on the shipped cfg: log card = CPU "
                     f"({sum(logs[0][0])} states)")
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                           "-sharded", "4", "-sharded-dedup", "hash"])
        if rc or "45198 distinct states" not in out.getvalue() \
                or "using -sharded-engine host" not in out.getvalue():
            raise AssertionError(f"cli: rc {rc}\n{out.getvalue()}")
        notes.append("cli -sharded 4 -sharded-dedup hash: 45198, rc 0")
        return "; ".join(notes)

    _phase("40 seeded scaled binding (host_seed, prestage, frontier "
           "window, metrics, guard)", seeded_scaled, failures)
    _phase("40b seeded runs, card against CPU", seeded_card_cpu, failures)
    _phase("41 -visited sort on both device engines", visited_sort,
           failures)
    _phase("42 -engine host: hash and sort, FileLog, kill and resume",
           host_engine, failures)
    _phase("43 -sharded-engine host on 4 shards and 2x2", sharded_host,
           failures)
    shutil.rmtree(eng_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    engines_launches = {k: v - engines_single[k]
                        for k, v in kernels.LAUNCHES.items()}
    print(f"[43b launches on the engines path] {engines_launches} (earlier "
          f"paths' comparison runs left out: {dict(engines_single)})",
          flush=True)
    for name in MAIN_PATH_KERNELS:
        if engines_launches[name] <= 0:
            failures.append(f"43b: {name} never launched on the engines "
                            "path")

    # ---- 44-47: run telemetry (obs/), launch counters zeroed around
    # them; the comparison runs without telemetry stay off the count
    kernels.reset_launches()
    obs_off = collections.Counter()
    obs_dir = tempfile.mkdtemp(prefix="ptt_obs_")
    streams = {}

    def obs_path(fn, *a):
        """``fn(*a)``, a comparison run: its launches leave the count."""
        before = dict(kernels.LAUNCHES)
        try:
            return fn(*a)
        finally:
            for k, v in kernels.LAUNCHES.items():
                obs_off[k] += v - before[k]

    def stream_events(path):
        errs = obs_schema.validate_stream(path)
        if errs:
            raise AssertionError(f"{path}: {errs[:3]}")
        ev, bad = obs_report.load_events(path)
        if bad:
            raise AssertionError(f"{path}: {bad[:3]}")
        return ev

    def boundary_totals(ev):
        return [e["distinct_states"] for e in ev
                if e["event"] == "level" and not e.get("partial")]

    def tel_scaled():
        want = list(itertools.accumulate(untiered["scaled"][0]))
        runs, beats = [], []
        for i, on in enumerate((False, True, True, False)):
            kw = dict(max_states=SCALED_TOTAL + 1)
            if on:
                s = os.path.join(obs_dir, f"scaled{i}.jsonl")
                kw.update(telemetry=s, heartbeat_s=0.5,
                          metrics_path=os.path.join(obs_dir,
                                                    f"scaled{i}.metrics"))
            ck = DeviceChecker(CompactionModel(scaled_cfg()), **kw)
            window = ck.G
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                if on:
                    r, cs = _card_syncs(torch, ck.run)
                else:
                    r, cs = obs_path(_card_syncs, torch, ck.run)
            beats += [ln for ln in err.getvalue().splitlines()
                      if ln.startswith("Progress(")]
            if list(itertools.accumulate(r.level_sizes)) != want:
                raise AssertionError(f"run {i}: level totals differ")
            runs.append((on, r.wall_s, ck.last_stats["host_syncs"], cs,
                         ck.last_stats))
            if on:
                streams.setdefault("scaled", s)
        syncs = {(h, c) for _on, _w, h, c, _st in runs}
        if len(syncs) != 1:
            raise AssertionError(f"syncs differ with telemetry: {runs}")
        ev = stream_events(streams["scaled"])
        # level 1 (the initial states) has no record, as in the JAX
        # engine's stream
        if boundary_totals(ev) != want[1:]:
            raise AssertionError(f"level records {boundary_totals(ev)}")
        with open(os.path.join(obs_dir, "scaled1.metrics")) as f:
            mrecs = [json.loads(ln) for ln in f]
        if [m["distinct_states"] for m in mrecs] != want[1:]:
            raise AssertionError("metrics_path records differ")
        if not beats or not any(e["event"] == "progress" for e in ev):
            raise AssertionError("no heartbeat line")
        att = [e for e in ev if e["event"] == "attribution"][-1]["stages"]
        res = [e for e in ev if e["event"] == "result"][-1]
        sizes = res["level_sizes"]
        # every level's frontier was expanded; a truncated run expanded
        # whole windows of its last full level's frontier
        if res["truncated"]:
            extra = att["expand_rows"] - sum(sizes[:-2])
            ok = 0 < extra <= sizes[-2] and (extra % window == 0
                                             or extra == sizes[-2])
        else:
            ok = att["expand_rows"] == sum(sizes)
        if not ok or att["append_rows"] != res["distinct_states"]:
            raise AssertionError(f"attribution {att} vs level sizes "
                                 f"{sizes}")
        h, c = syncs.pop()
        kinds = collections.Counter(e["event"] for e in ev)
        return (f"stream valid ({dict(kinds)}); level totals = phase 6's; "
                f"host_syncs {h} and card syncs {c} in all four runs; "
                f"walls in turns (telemetry off/on/on/off): "
                + ", ".join(f"{w:.4f}s" for _o, w, *_ in runs)
                + f"; heartbeat: {beats[0]}; attribution {att}")

    def tel_card_cpu():
        notes = []
        det = {}
        for where, fuse in (("cuda", "level"), ("cpu", "level"),
                            ("cuda", "stage")):
            s = os.path.join(obs_dir, f"full_{where}_{fuse}.jsonl")
            ck = DeviceChecker(CompactionModel(full_cfg), invariants=(),
                               device=where, fuse=fuse, telemetry=s)
            r = ck.run()
            if (r.distinct_states, r.diameter) != (253361, 23):
                raise AssertionError(f"{where} {fuse}: {r.distinct_states}")
            ev = stream_events(s)
            res = [e for e in ev if e["event"] == "result"][-1]
            fl = [e for e in ev if e["event"] == "flush"]
            det[where, fuse] = dict(
                levels=[(e["level"], e["new_states"], e["distinct_states"],
                         e["frontier"]) for e in ev if e["event"] == "level"],
                work=[e for e in ev if e["event"] == "attribution"][-1][
                    "stages"],
                flushes=(len(fl), sum(e["flushes"] for e in fl)),
                result={k: res[k] for k in (
                    "distinct_states", "diameter", "level_sizes",
                    "truncated", "violation")})
            streams.setdefault(f"full_{fuse}", s)
        if det["cuda", "level"] != det["cpu", "level"]:
            raise AssertionError("card and CPU streams differ")
        wf, ws = det["cuda", "level"]["work"], det["cuda", "stage"]["work"]
        for k in ("expand_rows", "append_rows", "init_lanes"):
            if wf[k] != ws[k]:
                raise AssertionError(f"fused/stage {k}: {wf[k]} {ws[k]}")
        a = CompactionModel(full_cfg).A
        if (ws["probe_lanes"] != a * ws["expand_rows"] + ws["init_lanes"]
                or wf["probe_lanes"] < ws["probe_lanes"]
                or any(w["compact_elems"] != w["probe_lanes"]
                       for w in (wf, ws))):
            raise AssertionError(f"lane widths: fused {wf}, stage {ws}")
        notes.append(f"253361/23 card = CPU (levels, work {wf}, flushes "
                     f"{det['cpu', 'level']['flushes']}, result); stage work "
                     f"{ws} (its own widths)")
        # a framed run killed in a process of its own, then resumed here
        frame = os.path.join(obs_dir, "kill.ckpt")
        s1 = os.path.join(obs_dir, "killed.jsonl")
        s2 = os.path.join(obs_dir, "resumed.jsonl")
        env = dict(os.environ, PTT_FAULT="kill@level:8")
        p = subprocess.run(
            [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli", "check",
             os.path.join(SPECS, "compaction.tla"), "-checkpoint", frame,
             "-telemetry", s1], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=300)
        if p.returncode != 137:
            raise AssertionError(f"killed run: rc {p.returncode}\n"
                                 f"{p.stderr[-2000:]}")
        ev1, _ = obs_report.load_events(s1)
        fault = [e for e in ev1 if e["event"] == "fault"]
        frames = [e for e in ev1 if e["event"] == "ckpt_frame"]
        if not fault or fault[-1]["kind"] != "kill" or not frames:
            raise AssertionError(f"killed stream: {ev1[-3:]}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                           "-checkpoint", frame, "-recover",
                           "-telemetry", s2])
        ev2 = stream_events(s2)
        hd = [e for e in ev2 if e["event"] == "run_header"][0]
        if (rc, hd.get("resume_of"), hd.get("resume_frame_seq")) != (
                0, ev1[0]["run_id"], frames[-1]["frame_seq"]) \
                or "45198 distinct states" not in out.getvalue():
            raise AssertionError(f"resumed: rc {rc}, header {hd}")
        notes.append(f"kill@level:8 wrote fault {fault[-1]}; the resumed "
                     f"header links resume_of {hd['resume_of']} frame "
                     f"{hd['resume_frame_seq']}; 45198 states")
        return "; ".join(notes)

    def cli_stream(what, want, *argv, rc_ok=0):
        """``cli`` with ``-telemetry``: the stream's events."""
        s = os.path.join(obs_dir, f"{what}.jsonl")
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([*argv, "-telemetry", s])
        if rc != rc_ok or want not in out.getvalue():
            raise AssertionError(f"{what}: rc {rc}\n{out.getvalue()[-1500:]}")
        return stream_events(s)

    def tel_engines():
        notes = []
        spec = os.path.join(SPECS, "compaction.tla")
        # phase 9's tiered 253,361-state run: windows small enough that
        # the hot table evicts (K3)
        kw = dict(invariants=(), sub_batch=4096, visited_cap=1 << 12)
        b = tight_budget(DeviceChecker(CompactionModel(full_cfg),
                                       hbm_budget="1T", **kw))
        k3 = kernels.LAUNCHES["sieve_mask"]
        s = os.path.join(obs_dir, "tiered.jsonl")
        r = DeviceChecker(CompactionModel(full_cfg), hbm_budget=b,
                          telemetry=s, **kw).run()
        if (r.distinct_states, r.diameter) != (253361, 23):
            raise AssertionError(f"tiered: {r.distinct_states}")
        sp = [e for e in stream_events(s) if e["event"] == "spill"]
        keys = ("keys_evicted", "rows_evicted", "bytes_raw",
                "misses_resolved")
        if not sp or kernels.LAUNCHES["sieve_mask"] == k3 or any(
                a[k] > c[k] for a, c in zip(sp, sp[1:]) for k in keys):
            raise AssertionError(f"tiered: {len(sp)} spill records")
        notes.append(f"tiered: {len(sp)} cumulative spill records, K3 "
                     f"{kernels.LAUNCHES['sieve_mask'] - k3} launches")
        full = os.path.join(spec_dir, "compaction_full.cfg")
        os.makedirs(spec_dir, exist_ok=True)
        with open(os.path.join(SPECS, "compaction.cfg")) as f:
            text = f.read()
        with open(full, "w") as f:
            f.write(text.replace("RetainNullKey = TRUE",
                                 "RetainNullKey = FALSE").replace(
                "ModelProducer = FALSE", "ModelProducer = TRUE"))
        ev = cli_stream("property", "satisfied", "check", spec, "-config",
                        full, "-property", "Termination", "-fairness",
                        "wf_next")
        sw = [e for e in ev if e["event"] == "sweep"]
        if not sw or sw[-1]["chunk"] != sw[-1]["chunks"]:
            raise AssertionError("property: no complete sweep")
        notes.append(f"-property: {len(sw)} sweep records, "
                     f"{sw[-1]['edges']} edges")
        ev = cli_stream("sim", "walks", "simulate", "compaction",
                        "-walkers", "65536")
        sims = [e for e in ev if e["event"] == "sim"]
        if not sims or sims[-1]["walkers"] != 65536:
            raise AssertionError("simulate: no sim records")
        notes.append(f"simulate 65536: {len(sims)} sim records, "
                     f"{sims[-1]['steps']} steps")
        ev = cli_stream("sharded", "45198 distinct", "check", spec,
                        "-sharded", "4")
        notes.append(f"-sharded 4: {len(ev)} records")
        ev = cli_stream("host", "45198 distinct", "check", spec, "-engine",
                        "host")
        notes.append(f"-engine host: {len(ev)} records")
        # the profiler window on the scaled binding, levels 5 and 6
        scaled = os.path.join(spec_dir, "compaction_scaled.cfg")
        with open(scaled, "w") as f:
            f.write(text.replace("MessageSentLimit = 3",
                                 "MessageSentLimit = 64")
                    .replace("KeySpace = {1, 2}",
                             "KeySpace = {1, 2, 3, 4, 5, 6, 7, 8}")
                    .replace("MaxCrashTimes = 1", "MaxCrashTimes = 3")
                    .replace("ModelProducer = FALSE", "ModelProducer = TRUE"))
        xdir = os.path.join(obs_dir, "xprof")
        t = time.time()
        ev = cli_stream("xprof", "distinct states", "check", spec,
                        "-config", scaled, "-maxstates",
                        str(SCALED_TOTAL + 1), "-xprof", xdir,
                        "-xprof-levels", "5:6", rc_ok=3)  # max_states
        stop = [e for e in ev if e["event"] == "xprof"
                and e["action"] == "stop"]
        with open(stop[-1]["path"]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        syms = {k: any(k in n for n in names) for k in (
            "member_kernel", "key_plane_kernel", "insert_tail_kernel")}
        if not all(syms.values()):
            raise AssertionError(f"xprof: kernel symbols {syms} among "
                                 f"{len(names)} kernel names")
        notes.append(f"-xprof 5:6: {len(names)} kernel names, K1/K2/H1 "
                     f"present ({time.time() - t:.1f}s)")
        # the readers over phases 44's and 45's streams
        s44, s45 = streams["scaled"], streams["full_level"]
        out = io.StringIO()
        tr = os.path.join(obs_dir, "trace.json")
        with contextlib.redirect_stdout(out):
            rcs = [cli.main(["trace", s44, s45, "-o", tr]),
                   cli.main(["metrics", "--stream", s44]),
                   cli.main(["top", "--stream", s44, "--once"])]
        text = out.getvalue()
        expo = text.split("\n", 1)[1]
        errs = (obs_trace.validate_trace(tr)
                + obs_metrics.validate_exposition(
                    expo[: expo.index("tpu-tlc top")]))
        led = os.path.join(obs_dir, "ledger.jsonl")
        with contextlib.redirect_stdout(out):
            rcs += [cli.main(["ledger", "--ledger", led, "add", s44, s45]),
                    cli.main(["ledger", "--ledger", led, "compare", s44,
                              s45]),
                    cli.main(["ledger", "--ledger", led, "gate",
                              "--baseline", s44, "--current", s44])]
        if rcs != [0] * 6 or errs:
            raise AssertionError(f"readers: rcs {rcs}, {errs[:3]}")
        notes.append("trace/metrics/top/ledger add|compare|gate rc 0 over "
                     "phases 44-45's streams")
        return "; ".join(notes)

    def tel_calibrate():
        spec = importlib.util.spec_from_file_location(
            "torch_calibrate",
            os.path.join(ROOT, "scripts", "torch_calibrate.py"))
        calmod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(calmod)
        cal, stage_ev = calmod.calibrate("full", sweep=True,
                                         stream_dir=obs_dir)
        s = os.path.join(obs_dir, "full_fused_attr.jsonl")
        DeviceChecker(CompactionModel(full_cfg), invariants=(),
                      telemetry=s).run()
        rows = obs_attribution.attribute(stream_events(s), cal)
        split = obs_report.stage_split(stage_ev)
        cmp = []
        for r in rows:
            meas = (split.get(r["stage"]) or {}).get("device_s")
            err = (f"{r['est_s'] / meas - 1:+.1%}" if meas else "n/a")
            cmp.append(f"{r['stage']} est {r['est_s']}s vs stage-timed "
                       f"{meas and round(meas, 4)}s ({err})")
        print(f"[47 cuda unit costs] {smi}: {json.dumps(cal['units'])} "
              f"(rtt_s {cal['rtt_s']})", flush=True)
        return "; ".join(cmp)

    _phase("44 telemetry on the main path (scaled, heartbeat, syncs)",
           tel_scaled, failures)
    _phase("45 the stream card against CPU, fused against stage, kill "
           "and resume", tel_card_cpu, failures)
    _phase("46 every engine's stream, -xprof, the readers", tel_engines,
           failures)
    _phase("47 calibration and attribution on the card", tel_calibrate,
           failures)
    shutil.rmtree(obs_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    obs_launches = {k: v - obs_off[k] for k, v in kernels.LAUNCHES.items()}
    print(f"[47b launches on the telemetry path] {obs_launches} "
          f"(comparison runs left out: {dict(obs_off)})", flush=True)
    for name in TIERED_PATH_KERNELS:
        if obs_launches[name] <= 0:
            failures.append(f"47b: {name} never launched on the telemetry "
                            "path")

    # ---- 48-52: the tuner (tune/), launch counters zeroed around them;
    # the comparison runs (kernel checks, untuned runs) stay off the count
    kernels.reset_launches()
    tune_off = collections.Counter()
    tune_dir = tempfile.mkdtemp(prefix="ptt_tune_")

    def tune_cmp(fn, *a, **kw):
        """``fn(*a, **kw)``, a comparison run: its launches leave the
        count."""
        before = dict(kernels.LAUNCHES)
        try:
            return fn(*a, **kw)
        finally:
            for k, v in kernels.LAUNCHES.items():
                tune_off[k] += v - before[k]

    def tune_kernels():
        # phase 2b's scaled flush: a 2^26-slot table holding 16M keys, a
        # 2,228,224-lane accumulator (60 % present, SENTINEL lanes, a
        # partial n_acc)
        cap, k = 1 << 26, 2
        tcols = fpset.empty_cols(cap, k, dev)
        claims = fpset.new_claims(cap, dev)
        fill = tuple(rand_i32(16 << 20) for _ in range(k))
        for base in range(0, fill[0].shape[0], 1 << 22):
            ks = tuple(c[base: base + (1 << 22)] for c in fill)
            _n, tcols, pending, _r = fpset.probe_insert(
                tcols, ks, ~fpset.all_sentinel(ks), claims=claims)
            if pending.any():
                raise AssertionError("plain insert left lanes pending")
        nq = (1 << 16) * 34
        pick = torch.randint(0, fill[0].shape[0], (nq,), device=dev,
                             generator=gen)
        fresh = torch.rand(nq, device=dev, generator=gen) < 0.4
        kcols = tuple(torch.where(fresh, rand_i32(nq), f[pick])
                      for f in fill)
        sent = torch.arange(nq, device=dev) % 97 == 3
        kcols = tuple(torch.where(sent, -1, c).contiguous() for c in kcols)
        n_acc = nq - 12345
        valid = (torch.arange(nq, device=dev) < n_acc) & \
            ~fpset.all_sentinel(kcols)
        notes = []
        for rounds in (16, 8):
            got = tiles.member_block(tcols, kcols, valid, rounds)
            want = tiles.member_block_plain(tcols, kcols, valid, rounds)
            for g, w, what in zip(got, want, ("member", "resolved")):
                if not torch.equal(g, w):
                    raise AssertionError(f"K1 rounds {rounds} {what}: "
                                         f"{int((g != w).sum())} lanes differ")
            flags = torch.empty((2, nq), dtype=torch.bool, device=dev)
            args = tiles.member_block_args(tcols, kcols, valid, flags[0],
                                           flags[1], rounds)
            # the bytes the data needs: keys, valid, flags, and K words a
            # probed slot (a lane stops at its key or an empty slot)
            h = fpset.slot_hash(kcols)
            live = valid.clone()
            n_probes = 0
            for r in range(rounds):
                s = (h + (r * (r + 1) >> 1)) & (cap - 1)
                sv = tuple(c[s] for c in tcols)
                n_probes += int(live.sum())
                live = live & ~(fpset.all_sentinel(sv) | (
                    (sv[0] == kcols[0]) & (sv[1] == kcols[1])))
            nbytes = nq * (k * 4 + 1 + 2) + n_probes * k * 4
            ops = nq * 10 * k + n_probes * (2 + 5 * k)
            rec = dict(device_ms=_time_ms(torch, lambda: kernels.launch(
                *args), 100), plain_ms=_time_ms(
                torch, lambda: tiles.member_block_plain(
                    tcols, kcols, valid, rounds), 5),
                bound=_bound(nbytes, ops), unresolved=int((~got[1]).sum()))
            record.setdefault("tune_kernels", {})[f"K1@{rounds}"] = rec
            notes.append(f"K1 rounds {rounds} equal: {rec}")
        # H1 at max_probes 32 on K1's survivors (rounds 16)
        member = tiles.member_block(tcols, kcols, valid, 16)[0]
        surv = valid & ~member
        lane = torch.arange(nq, dtype=torch.int32, device=dev)
        ccols, _ = compact_by_flag(~surv, (*kcols, lane))
        npend = int(surv.sum())
        cw = max(nq // 4, min(nq, fpset.MIN_STAGE))
        ta, is_new, st = tail_pair(tcols, ccols[:k], ccols[k], npend, cw,
                                   nq, 32)
        probes, sectors = probe_work(ta, ccols[:k], npend)
        n_new = int(is_new.sum())
        snap, work = fpset.slot_major(tcols), fpset.slot_major(tcols)
        wclaims = fpset.new_claims(cap, dev)
        npd = torch.full((), npend, dtype=torch.int64, device=dev)
        out = (torch.zeros(nq + 1, dtype=torch.bool, device=dev),
               torch.empty((2, k + 2, cw), dtype=torch.int32, device=dev),
               torch.empty(2, dtype=torch.int32, device=dev),
               torch.empty(4, dtype=torch.int64, device=dev))
        args = fpset.insert_tail_args(work, ccols[:k], ccols[k], npd, cw,
                                      wclaims, *out, 32)

        def setup():
            for a, b in zip(work, snap):
                a.copy_(b)
            out[0].zero_()

        nbytes = npend * (4 * k + 4) + probes * 4 * k + n_new * (4 * k + 1)
        ops = npend * 10 * k + probes * (2 + 5 * k)
        rec = dict(device_ms=_time_each(torch, setup, lambda: kernels.launch(
            *args), 10), plain_ms=_time_each(
            torch, setup, lambda: fpset.insert_tail_plain(
                work, ccols[:k], ccols[k], npd, cw, wclaims, nq, 32), 3),
            bound=_bound(nbytes, ops), stats=st)
        record["tune_kernels"]["H1@32"] = rec
        notes.append(f"H1 max_probes 32 equal ({npend} survivors, {n_new} "
                     f"new): {rec}")
        del snap, work, ta
        # the whole flush at dense_rounds 16 against the default flush
        outs = []
        for dense in (None, 16):
            t = fpset.slot_major(tcols)
            fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64, device=dev)
            t, n, flag, fpm = tiles.flush_tiles(t, kcols, n_acc, fpm, None,
                                                dense)
            outs.append((t, int(n), flag, fpm.tolist()))
        (ta, na, fa, ma), (tb, nb, fb, mb) = outs
        if na != nb or not torch.equal(fa, fb) or not all(
                torch.equal(a[:cap], b[:cap]) for a, b in zip(ta, tb)):
            raise AssertionError("flush_tiles at dense 16 differs")
        notes.append(f"flush_tiles dense 16 = default: n_new {na}, "
                     f"is_new, table; fpm {ma} vs {mb}")
        k1, h1_ = record["member_block"], record["insert_tail"]
        notes.append(f"beside phase 2b/2d: K1@8 device_ms "
                     f"{k1['device_ms']:.4f} bound {k1['bound'][0]:.5f}, H1@64 "
                     f"{h1_['device_ms']:.4f} bound {h1_['bound'][0]:.5f}")
        return "; ".join(notes)

    def tune_scaled():
        from pulsar_tlaplus_tpu_torch.obs import telemetry as obs_tel
        from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
        from pulsar_tlaplus_tpu_torch.tune import search as tune_search

        notes = []
        # the card's per-read overhead and device-to-host byte rate, the
        # "cuda" fallbacks of tune/predict.py
        rtt = min(obs_tel.measure_rtt(dev) for _ in range(5))
        big = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        big.fill_(1)
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t = time.perf_counter()
            big.cpu()
            rates.append(big.numel() / (time.perf_counter() - t))
        del big
        print(f"[49 predict.py cuda defaults] {smi}: dispatch_s {rtt:.3e}, "
              f"link_bytes_per_s {max(rates):.4e} (256 MiB .cpu(), best of "
              "3)", flush=True)
        notes.append(f"rtt {rtt * 1e6:.1f} us, D2H {max(rates) / 1e9:.2f} "
                     "GB/s")
        # the bench's scaled binding, cut at level 6's boundary: every
        # candidate finds the same states there (a cut inside a level
        # would stop each window size at another count)
        model = CompactionModel(scaled_cfg())
        lines = []
        t = time.time()
        prof, rows = tune_search.tune_device(
            model, invariants=(), spec_label="compaction_scaled",
            base_kw=dict(max_states=SCALED_TOTAL), top_k=3, repeat=2,
            log=lines.append)
        tn = prof["tuner"]
        if tn["dropped"] or tn["distinct_states"] != SCALED_TOTAL:
            raise AssertionError(f"dropped {tn['dropped']}: {lines}")
        ratio = tn["tune_peak_bytes"] / tn["checker_peak_bytes"]
        if ratio > 1.25:
            raise AssertionError(f"tune peak {ratio:.2f}x one checker's")
        measured = [r for r in rows if r["measured_s"] is not None]
        notes.append(
            f"tune_device scaled ({time.time() - t:.1f}s): predicted "
            f"{tn['candidates_predicted']}, measured "
            + ", ".join(f"{r['candidate']} est {r['est_s']:.4f}s meas "
                        f"{r['measured_s']:.4f}s" for r in measured)
            + f"; reference wall {tn['baseline_s']}s, winner {tn['winner']} "
            f"margin {tn['margin_pct']:+.2f}%; peak {tn['tune_peak_bytes'] / 2**30:.2f}"
            f" GiB against one checker's {tn['checker_peak_bytes'] / 2**30:.2f}"
            f" GiB ({ratio:.3f}x); states {tn['distinct_states']} for all")
        # the CLI: tune the shipped cfg, then check resolves the profile
        spec = os.path.join(SPECS, "compaction.tla")
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["tune", "compaction"])
        path = out.getvalue().strip().splitlines()[-1].split("profile: ")[1]
        errs = obs_schema.validate_profile_file(path)
        with open(path) as f:
            sprof = json.load(f)
        s = os.path.join(tune_dir, "check.jsonl")
        out2 = io.StringIO()
        with contextlib.redirect_stdout(out2), \
                contextlib.redirect_stderr(io.StringIO()):
            rc2 = cli.main(["check", spec, "-telemetry", s])
        hd = obs_report.load_events(s)[0][0]
        if (rc, rc2, errs, hd["profile_sig"]) != (0, 0, [], sprof["sig"]) \
                or "45198 distinct states found, search depth (diameter) " \
                   "20" not in out2.getvalue():
            raise AssertionError(f"cli tune/check: {rc} {rc2} {errs} "
                                 f"{hd.get('profile_sig')}\n"
                                 f"{out2.getvalue()[-800:]}")
        notes.append(f"cli tune compaction: winner {sprof['tuner']['winner']}"
                     f" ({sprof['tuner']['margin_pct']:+.2f}%), profile "
                     f"valid; cli check resolves {hd['profile_sig']}: "
                     "45198 / 20")
        return "; ".join(notes)

    def tune_adapt():
        from pulsar_tlaplus_tpu_torch.tune import online as tune_online

        notes = []
        want = list(itertools.accumulate(untiered["scaled"][0]))
        runs, ref = [], None
        for i, on in enumerate((False, True, True, False)):
            s = os.path.join(tune_dir, f"adapt{i}.jsonl") if on else None
            ck = DeviceChecker(CompactionModel(scaled_cfg()),
                               max_states=SCALED_TOTAL + 1, adapt=on,
                               telemetry=s)
            if on:
                r, cs = _card_syncs(torch, ck.run)
            else:
                r, cs = tune_cmp(_card_syncs, torch, ck.run)
            if list(itertools.accumulate(r.level_sizes)) != want:
                raise AssertionError(f"run {i}: level totals differ")
            nv = r.distinct_states
            logs = [ck.last_bufs[k][: nv * (ck.W if k == "rows" else 1)]
                    for k in ("rows", "parent", "lane")]
            if ref is None:
                ref = logs
            elif not all(torch.equal(a, b) for a, b in zip(ref, logs)):
                raise AssertionError(f"run {i}: logs differ")
            st = ck.last_stats
            tunes = []
            if on:
                ev = obs_report.load_events(s)[0]
                errs = obs_schema.validate_stream(s)
                tunes = [e for e in ev if e["event"] == "tune"]
                if errs or ev[0]["adapt"] is not True or \
                        st["tune_adjustments"] != len(tunes):
                    raise AssertionError(f"adapt stream: {errs[:3]}")
            runs.append((on, r.wall_s, st["host_syncs"], cs,
                         st["fpset_max_probe_rounds"],
                         [(e["knob"], e["prev"], e["value"]) for e in tunes]))
            del ck, logs
        del ref
        syncs = {(h, c) for _o, _w, h, c, _m, _t in runs}
        if len(syncs) != 1:
            raise AssertionError(f"syncs differ with -adapt: {runs}")
        h, c = syncs.pop()
        m = max(x[4] for x in runs)
        notes.append(
            f"level sizes and logs equal; host_syncs {h} and card syncs {c} "
            f"in all four runs; walls off/on/on/off "
            + ", ".join(f"{w:.4f}s" for _o, w, *_ in runs)
            + f"; tune records {runs[1][5]}; max probe rounds {m}")
        # a forced pressure raise: dense 8 and a probe budget of M + 8
        # (the controller raises at M + 8 // 2 <= M) -> dense 16, so K1
        # runs 16 rounds in the flushes after the raise
        seen = collections.Counter()
        orig = tiles.member_block

        def spy(tcols, kcols, valid, rounds=tiles.TILE_R):
            seen[rounds] += 1
            return orig(tcols, kcols, valid, rounds)

        tiles.member_block = spy
        try:
            s = os.path.join(tune_dir, "pressure.jsonl")
            ck = DeviceChecker(CompactionModel(scaled_cfg()),
                               max_states=SCALED_TOTAL + 1, adapt=True,
                               fpset_dense_rounds=8,
                               fpset_stages=((4, 16), (16, m + 8)),
                               telemetry=s)
            r = ck.run()
        finally:
            tiles.member_block = orig
        nv = r.distinct_states
        same = list(itertools.accumulate(r.level_sizes)) == want and all(
            torch.equal(torch.from_numpy(a[:nv]).to(dev),
                        ck.last_bufs[k][:nv])
            for k, a in zip(("parent", "lane"), untiered["scaled"][1:]))
        raised = [e for e in obs_report.load_events(s)[0]
                  if e["event"] == "tune"
                  and e["knob"] == "fpset_dense_rounds"]
        if not same or not raised or raised[-1]["value"] != \
                tune_online.MAX_DENSE or not seen[16]:
            raise AssertionError(f"pressure: same {same}, raised {raised}, "
                                 f"K1 rounds {dict(seen)}")
        notes.append(f"pressure raise {[(e['prev'], e['value']) for e in raised]}"
                     f" ({raised[-1]['reason']}): K1 launches by rounds "
                     f"{dict(seen)}; level sizes and logs = phase 6's; wall "
                     f"{r.wall_s:.4f}s")
        del ck
        return "; ".join(notes)

    def tune_others():
        from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
        from pulsar_tlaplus_tpu_torch.tune import search as tune_search

        notes = []
        lines = []
        sprof, srows = tune_search.tune_sim(
            CompactionModel(scaled_cfg()), invariants=(),
            spec_label="compaction_scaled", depth=64,
            total_steps=4096 * 64, top_k=2, repeat=1, log=lines.append)
        tn = sprof["tuner"]
        notes.append(f"tune_sim scaled 4096 x 64: measured {tn['measured_s']}"
                     f", steps/s {tn['steps_per_sec']}, winner {tn['winner']}")
        # a "liveness" profile on the 253,361-state config
        model = CompactionModel(full_cfg)
        sig = tune_profiles.profile_key(model=model, invariants=(),
                                        engine="liveness", backend="cuda")
        tune_profiles.save(tune_profiles.build(
            sig=sig, engine="liveness", backend="cuda",
            knobs={"sweep_group": 2}, spec="compaction_full"))
        got = {}
        for tuned in (False, True):
            lc = LivenessChecker(CompactionModel(full_cfg),
                                 fairness="wf_next", frontier_chunk=4096,
                                 visited_cap=1 << 18,
                                 profile="auto" if tuned else None)
            if tuned:
                res = lc.run()
            else:
                res = tune_cmp(lc.run)
            got[tuned] = (res.holds, res.reason, lc.last_stats["edges"],
                          lc.profile_sig, lc.sweep_group)
        if got[True][:3] != got[False][:3] or got[True][3:] != (sig, 2) \
                or got[True][2] != LIVENESS_PINS["full"]["edges"]:
            raise AssertionError(f"liveness profile: {got}")
        notes.append(f"LivenessChecker with the liveness profile "
                     f"(sweep_group 2): {got[True][2]} edges, holds "
                     f"{got[True][0]}, as untuned (sweep_group "
                     f"{got[False][4]})")
        return "; ".join(notes)

    def tune_tiered():
        from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
        from pulsar_tlaplus_tpu_torch.tune import space as tune_space

        shape = dict(sub_batch=512, visited_cap=2048, frontier_cap=2048,
                     max_states=1 << 22)
        b = tight_budget(DeviceChecker(CompactionModel(pyeval.SHIPPED_CFG),
                                       hbm_budget="1T", **shape))
        k3 = kernels.LAUNCHES["sieve_mask"]
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["tune", "compaction", "--hbm-budget", str(b),
                           "--sub-batch", "512", "--visited-cap", "2048",
                           "--frontier-cap", "2048", "--top-k", "2",
                           "--repeat", "1"])
        path = out.getvalue().strip().splitlines()[-1].split("profile: ")[1]
        with open(path) as f:
            prof = json.load(f)
        model = CompactionModel(pyeval.SHIPPED_CFG)
        inv = tuple(cfgmod.load(os.path.join(SPECS,
                                             "compaction.cfg")).invariants)
        tiered_sig = tune_profiles.profile_key(
            model=model, invariants=inv, backend="cuda", tiered=True)
        n_space = len(tune_space.candidates(model, 512, spill=True))
        s = os.path.join(tune_dir, "untiered.jsonl")
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc2 = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                            "-telemetry", s])
        hd = obs_report.load_events(s)[0][0]
        n_k3 = kernels.LAUNCHES["sieve_mask"] - k3
        tn = prof["tuner"]
        if (rc, rc2, prof["sig"], tn["candidates_predicted"]) != (
                0, 0, tiered_sig, n_space) or hd["profile_sig"] == \
                tiered_sig or n_k3 <= 0 \
                or obs_schema.validate_profile_file(path):
            raise AssertionError(
                f"tiered tune: rc {rc}/{rc2}, sig {prof['sig']} vs "
                f"{tiered_sig}, {tn['candidates_predicted']} vs {n_space}, "
                f"check header {hd['profile_sig']}, K3 {n_k3}\n"
                f"{err.getvalue()[-1500:]}")
        return (f"cli tune --hbm-budget {b} --sub-batch 512: "
                f"{n_space} candidates with the spill knobs, measured "
                f"{tn['measured_s']}, dropped {tn['dropped']}, winner "
                f"{tn['winner']}; tiered key {tiered_sig}, the untiered check "
                f"resolved {hd['profile_sig']}; K3 {n_k3} launches")

    t48 = time.time()
    _phase("48 K1 at rounds 16 and 8, H1 at max_probes 32, the flush at "
           "dense 16", lambda: tune_cmp(tune_kernels), failures)
    torch.cuda.empty_cache()
    _phase("49 tune at full width, cli tune/check", tune_scaled, failures)
    torch.cuda.empty_cache()
    _phase("50 -adapt on the card (syncs, logs, a pressure raise)",
           tune_adapt, failures)
    torch.cuda.empty_cache()
    _phase("51 the simulator's and the liveness engine's profiles",
           tune_others, failures)
    _phase("52 the tiered search", tune_tiered, failures)
    shutil.rmtree(tune_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    tune_launches = {k: v - tune_off[k] for k, v in kernels.LAUNCHES.items()}
    print(f"[52b launches on the tune path] {tune_launches} (comparison "
          f"runs left out: {dict(tune_off)}; phases 48-52 "
          f"{time.time() - t48:.1f}s)", flush=True)
    for name in TIERED_PATH_KERNELS:
        if tune_launches[name] <= 0:
            failures.append(f"52b: {name} never launched on the tune path")

    # ---- 53-57: the checker daemon (service/, warm/) on the card
    service_launches, _service_notes, service_solo = service_path(
        torch, dev, kernels, failures)

    # ---- 58-62: the fleet dispatcher (fleet/) fronting daemons on the card
    fleet_launches, _fleet_notes = fleet_path(
        torch, dev, kernels, failures, service_solo,
        dict(scaled_wall=untiered["scaled_wall"],
             scaled_peak=untiered["scaled_peak"],
             full_levels=[int(x) for x in untiered["full"][0]]))

    # ---- 63-65: the native baseline, the fuzz harness, the CLI repairs
    fuzz_launches = fuzz_path(torch, dev, kernels, failures, dict(
        shipped_levels=untiered.get("shipped_levels", []),
        full_levels=[int(x) for x in untiered["full"][0]],
        scaled_levels=[int(x) for x in untiered["scaled"][0]],
        scaled_complete=_cum(untiered["scaled"][0]).index(SCALED_TOTAL) + 1,
        scaled_rate=untiered["scaled_rate"], scaled_cfg=scaled_cfg(),
        smi=smi))

    # ---- 66-68: the service and fleet chaos drills (scripts/torch_chaos.py)
    torch.cuda.empty_cache()
    chaos_launches = chaos_path(torch, dev, kernels, failures)

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
            survivability_launches=surv_launches[name],
            sharded_launches=shard_launches[name],
            engines_launches=engines_launches[name],
            obs_launches=obs_launches[name],
            tune_launches=tune_launches[name],
            service_launches=service_launches[name],
            fleet_launches=fleet_launches[name],
            fuzz_launches=fuzz_launches.get(name, 0),
            chaos_launches=chaos_launches.get(name, 0),
            **({"tune_shape": record["tune_kernels"][tk]}
               if (tk := {"member_block": "K1@16",
                          "insert_tail": "H1@32"}.get(name)) else {}),
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
