"""Level-synchronous BFS on one device — the counterpart of
``pulsar_tlaplus_tpu/engine/device_bfs.py``'s ``DeviceChecker``.

One expand window of up to ``sub_batch`` frontier rows runs this chain:

- **init**: ``gen_initial`` over index windows, packed, keyed;
- **expand**: the window's rows are unpacked, ``successors`` gives
  ``[G, A]`` lanes, they are packed and keyed by the key-plane kernel
  (K2); rows with no enabled lane and no stutter are deadlocks;
- **flush**: the tiled flush — the membership-probe kernel (K1), then
  the insert tail (H1) — probes or inserts the window's keys in the
  visited table;
- **compact**: the new rows move to the front in lane order;
- **append**: invariants run on the new states, and rows, parent gids
  and action lanes are written at the next gids.

All discovered rows stay on the device in gid order (the JAX engine's
``rows_window="all"``), so a level is a contiguous gid range.  Gids
follow first occurrence in (frontier row, action lane) order under
min-lane-wins, and roots log parent ``-1 - init_idx``: rows, parents and
lanes equal the JAX engine's state for state, whatever the window size
or the loop.

**The fused level** (``fuse="level"``, the default; the JAX engine's
``_fused_jit`` / ``_fused_level_pass``): the host enqueues a whole
level's windows and reads nothing between them.  The state count, the
deadlock gid, the first violating gid per invariant and the flush
metrics live on the device; a window's flush (``tiles.flush_tiles``)
returns its new-state count as a device scalar, the append writes the
compacted rows, parents and lanes blind at ``nv + j`` for every lane
``j`` of the window (the JAX engine's blind append window: lanes past
the count write rows past ``nv``, which later windows overwrite), and
violations and deadlocks reduce by ``amin`` into device vectors.  The
host keeps ``nv_hi``, an upper bound of ``nv`` (the last count it read
plus the lanes of every window it enqueued since), and reads the device
(one small vector: a *host sync*) only

- at the end of a level, or of a ramp batch;
- before a window whose bound could break the table's load contract
  (load <= 1/2) or overflow the row store — then it grows the table
  (rehash through H1) and the store with headroom for ``max(group + 1,
  fuse_group)`` windows, as the JAX engine grows ``(group + 1)``
  accumulators ahead;
- before a window once the bound has reached ``max_states``: a window
  runs only while the state count is under the budget, the JAX kernel's
  ``fits`` gate, so the run stops at the stage loop's count.

A violation or deadlock ends the run at the next level boundary or
sync, as the JAX kernel's loop condition does.  **The ramp**: a level
whose frontier fits one window runs as one of a batch of up to
``fuse_group`` (default 8) such levels between two syncs; each reads its
window at a device-held level base (``index_select``), masks the rows
past the device-held frontier size, and a device flag turns the rest of
the batch into no-ops once a frontier outgrows the window, reaches 0, or
a violation or deadlock was found.  A ramp window has as many rows as
the host's bound on its frontier (the batch's first frontier, exact,
times ``A`` a level, at most ``sub_batch``), and the batch goes past its
first level only while the windows are narrow
(:data:`RAMP_SPEC_LANES`): on the card a wide padded or no-op window
costs more than the sync it would save.  The batch's level sizes come
back in its one read, so the level accounting and the progress log
replay exactly.  ``last_stats`` counts ``host_syncs``, ``fuse_levels``
(levels closed by the fused loop) and ``syncs_per_level``.

**The stage loop** (``fuse="stage"``) reads the device after every
window: the deadlock position, the flush's new-state count, the probe
overflow and the invariants, and it checks the stop conditions
(violation, deadlock, ``max_states``) after every flush.  The visited
table, row store and logs grow by doubling.

**Tiered mode** (``hbm_budget``; the JAX engine's tiered state store)
keeps a budgeted hot tier on the device and the rest in a
``store/tiers.TieredStore`` on the host.  It starts in the fused level
(or the stage loop, as ``fuse`` says) and hands the level loop to the
stage loop once spilling must begin (the JAX engine's
``_tiered_pressure``): at a level boundary when the hot table plus two
windows would pass its ceiling, or the row/log window would be short,
or mid-level when a fused window no longer fits the capped tiers —
then the host's counters are exact (the sync that found no room read
them) and the stage loop takes the level over from that window, so
discovery order equals the untiered run's.  The latch stays for the
rest of the run (and is restored from a frame's manifest).

- The budget fixes tier ceilings once, by round-robin doubling of the
  table and the row/log window from their initial sizes while
  :meth:`DeviceChecker._device_bytes_est` stays inside ``budget * (1 -
  hbm_headroom)``; a budget below the initial tiers raises.
- An int32 generation column beside the table is tagged with the epoch
  at every level boundary and re-tagged at generation 1 after every
  table growth.  When the hot table is full at its ceiling, the
  oldest generations are evicted (the tiled extract with the sieve-mask
  kernel K3, then a sort), their sorted keys go to the host and the
  survivors are rehashed; only when nothing is evictable does the
  table grow past the budget, once logged as a WARNING.
- After every flush, the lanes the hot table calls new are resolved
  against the cold runs on the host, and the false-new ones are cleared
  before the compaction that assigns gids.
- Rows and trace logs live in a window ``[row_base, ...)``: ranges
  older than the frontier spill to the host at level boundaries once
  eviction has begun, or when the window is full.  Gids stay absolute;
  traces walk the merged cold + window logs.  A checkpointed run's
  store is durable: every spilled run and segment is also written to
  ``spill_dir`` (default ``<checkpoint_path>.spill``), and a frame
  embeds its manifest.

**The frontier row window** (``rows_window="frontier"``): the rows are
a window of ``LCAP = max(row_cap_states, NQ) + NQ`` rows (one blind
append window past the cap) holding the frontier and as much of the
level being built as fits; at each level start the frontier slides to
offset 0 and older rows are dropped.  The parent/lane logs keep every
state (traces need no rows).  When the level being built outgrows the
window, its rows are dropped and the run goes on deduplicating,
counting and checking invariants to the end of the level; it stops
with ``stop_reason="row_window"`` only if that level must be expanded.
A fused pass runs one level (no ramp: the slide is the host's).
Exclusive with ``hbm_budget``.

**Budgets and stops.**  ``time_budget_s`` stops the run at the next
check past it (``time_budget``; a resumed run gets a fresh budget); a
budgeted fused level syncs at least every :data:`TIMED_SYNC_EVERY`
windows so the check is not blunted to whole levels.

**Checkpoints** (``checkpoint_path``, every ``checkpoint_every``
levels; ``utils/ckpt.py``): a frame holds the state count, the level
sizes, the frontier, the visited table's occupied slots, the rows (all
of them; the window from the frontier in frontier mode; the device
window in tiered mode, with the spill manifest) and the parent/lane
logs, and ``run(resume=True)`` continues from it state for state.  A
ramp batch ends on a due frame level.  A truncated run (a budget,
device memory, preemption) leaves a frame at its last level boundary:
a mid-level stop rewinds to it, and the partial level re-derives on
resume by dedup idempotence.  SIGTERM/SIGINT (``utils/ckpt.
PreemptionWatcher``) writes a frame at the next level boundary and
stops with ``preempted``.  When device memory runs out
(``torch.OutOfMemoryError``, or the ``PTT_FAULT`` oom drill) with a
valid frame on disk, the run frees its tensors, rebuilds from the frame
and goes on at degraded capacity (growth headroom one window,
``hbm_recovered``); without one it stops with ``hbm``.  The fault
sites of ``utils/faults.py`` (``level``, ``flush``, ``frame``,
``spill``) are polled on the host.  With no ``checkpoint_path`` the
level loop reads the device no more often than without these features.

**Telemetry** (``telemetry``, ``heartbeat_s``, ``xprof_dir``; the JAX
engine's stream, record for record: ``obs/telemetry.py``).  Every
record rides a read the loop already makes: the fused level's
``_lv_read`` carries the whole flush-metrics vector and the work vector
in its one ``.tolist()``, the stage loop's flush read the flush
metrics; the heartbeat thread reports from ``_snap``, the host's last
snapshot, and never touches a tensor.  One ``fuse`` record is written a
fused pass (``_lv_pass``: a ramp batch or one whole level between two
boundary reads).  The JAX ``fuse`` record is one XLA dispatch of the
level megakernel; a pass here is a host loop of many launches with the
same reads at its ends, so ``dispatches`` is always 1 and counts passes.

**Work units** (``ops/fpset.wkm_update``; the JAX definitions): the
fused level adds a window's units to an int64 device vector, the stage
loop adds them on the host.  ``expand_rows`` (the live frontier rows a
window expands), ``append_rows`` (new states) and ``init_lanes`` are
equal in both loops and equal the JAX engine's.  ``probe_lanes`` and
``compact_elems`` are the lanes a flush presents, which in the JAX
engine is the fixed accumulator width.  Here a window's flush presents
its own lanes: the stage loop exactly the window's frontier rows times
``A`` (or its initial states), the fused level the same except in the
ramp, whose window is padded to the host's bound on the frontier (and
runs as a no-op once the batch ends early).  So the fused level presents
at least the stage loop's lanes, and ``groups`` counts each loop's own
flushes.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.engine.bfs import CheckerResult
from pulsar_tlaplus_tpu_torch.engine.core import build_trace
from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.obs import telemetry as obs
from pulsar_tlaplus_tpu_torch.obs.telemetry import emit_result
from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.compact import compact_rows, validate_impl
from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL, KeySpec, merge_lanes
from pulsar_tlaplus_tpu_torch.store import budget as store_budget
from pulsar_tlaplus_tpu_torch.store import sieve
from pulsar_tlaplus_tpu_torch.store.tiers import TieredStore
from pulsar_tlaplus_tpu_torch.tune import online as tune_online
from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
from pulsar_tlaplus_tpu_torch.utils import ckpt, faults, metrics, recovery
from pulsar_tlaplus_tpu_torch.utils import device as device_mod

BIG = 2**31 - 1
# tiered mode: the share of the budget kept free, and the keys a
# cold-miss lookup moves to the host at a time (the JAX engine's
# defaults of ``hbm_headroom`` and ``miss_batch``)
HBM_HEADROOM = 0.1
MISS_BATCH = 1 << 15
# flushes the fused level grows ahead of (``group``; its growth
# headroom is ``group + 1`` windows, at least ``fuse_group``): the JAX
# engine's default group of 4
GROUP = 4
# the seed loader's merge chunk and the sort-merge seed columns (the
# JAX engine's SEED_CHUNK and SEED_VCAP defaults)
SEED_CHUNK = 1 << 15
SEED_VCAP = 1 << 16
# the widest window (in lanes) of a ramp level after a batch's first,
# whose frontier the host knows only by a bound: about where a window's
# ops stop being launch-bound on an H100 (2^16 lanes x ~80 B ~ 2 us at
# 3.35 TB/s, one launch), so padding it to the bound, or running it as
# a no-op, costs no more than the sync it saves
RAMP_SPEC_LANES = 1 << 16
# a time-budgeted fused level reads the device at least this often (in
# windows): the JAX engine's max(8 * group, 32) flush groups
TIMED_SYNC_EVERY = 32
# the work vector's units, in its order (ops/fpset.py)
WKM_KEYS = ("expand_rows", "probe_lanes", "compact_elems", "append_rows",
            "groups")
# the frame format's engine revision (a frame of another engine, the
# JAX package's included, is refused)
ENGINE_SIG = "device_bfs_torch_r1"


def _pow2_at_least(n: int, floor: int = 1 << 10) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (a copy also on the CPU, where
    ``.cpu()`` would alias the device buffer that is about to slide)."""
    return t.to("cpu", copy=True).numpy()


def _grown(t: torch.Tensor, new_len: int) -> torch.Tensor:
    """``t`` in a zero-filled buffer of ``new_len`` rows (contents
    kept)."""
    out = torch.zeros((new_len, *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[: t.shape[0]] = t
    return out


class DeviceChecker:
    """BFS checker for a batched model on one device (``cuda`` unless
    ``device`` names another; raises when CUDA is wanted and absent).

    ``sub_batch`` frontier rows form one expand window, expanded in
    chunks of ``expand_chunk`` rows (default: the whole window);
    ``flush_factor`` windows form one flush of ``sub_batch *
    flush_factor * A`` candidate lanes.  The visited table starts with
    room for ``visited_cap`` states at load 1/2 (the row store with
    room for ``frontier_cap``); the fused level grows the table and the
    store ``group + 1`` windows ahead.  ``fp_bits`` (64 or 96) is the
    width of a hashed key.  The run stops (truncated) once
    ``max_states`` are found, or past ``time_budget_s`` seconds.
    ``metrics_path`` takes one JSON record a level.

    ``visited_impl="sort"`` replaces the hash table by the sort-merge
    visited set (sorted key columns, ``dedup.merge_new_keys``): it runs
    the stage loop, takes no ``hbm_budget``, and ``seed_cap`` sizes its
    seed merge's columns.  ``compact_impl`` is ``"logshift"`` or
    ``"sort"`` (``ops/compact.py``).  ``run(seed=...)`` starts from a
    host-enumerated BFS prefix (``model.host_seed``).

    ``fuse="level"`` (the default) runs the fused level, ``"stage"``
    the loop that reads the device after every window; ``fuse_group``
    (default 8, at most 64) caps the ramp levels one sync may close.

    ``hbm_budget`` (bytes, or a spec such as ``"7.5G"``; the
    ``PTT_HBM_BUDGET`` environment variable when not given) turns on
    the tiered store; ``spill_compress=False`` sizes the spilled planes
    raw instead of delta + zlib; ``spill_dir`` is the durable store's
    directory (default ``<checkpoint_path>.spill``); ``hbm_headroom``
    is the share of the budget kept free (default 0.1), ``miss_batch``
    the keys a cold-miss lookup moves to the host at a time.
    ``rows_window="frontier"`` keeps only a window of ``row_cap_states``
    rows (plus one append window).  ``checkpoint_path`` writes a frame
    every ``checkpoint_every`` levels; ``run(resume=True)`` continues
    from it.  ``suspend_hook`` (the daemon's time slicing, reassignable
    between runs) is polled at each level boundary after the preemption
    watcher: ``"cancelled"`` stops the run without a frame, any other
    non-empty answer writes a frame and stops with that reason.

    ``telemetry`` (a path, or an ``obs.telemetry.Telemetry`` the caller
    keeps) takes the run's JSONL event stream; ``heartbeat_s`` prints a
    TLC-style progress line that often from the last host snapshot;
    ``xprof_dir`` writes a ``torch.profiler`` Chrome trace of the levels
    ``xprof_levels=(lo, hi)`` (default: the whole run) there.

    ``fpset_dense_rounds`` and ``fpset_stages`` set the tiled flush's
    probe schedule (``fpset.resolve_schedule``).  ``profile`` resolves a
    tuned profile (``tune/profiles.py``: None = off, ``"auto"`` = by
    config signature from ``PTT_TUNE_DIR``, a path, or a profile dict):
    every knob left at None (``sub_batch``, ``flush_factor``, ``group``,
    ``fuse_group``, the schedule, ``compact_impl`` and the tiered
    knobs) takes the profile's value, then the default; ``profile_sig``
    and ``profile_applied`` say what it set.  ``adapt`` runs the online
    controller (``tune/online.py``; ``PTT_TUNE_ADAPT=0`` turns it off
    everywhere) at the fused level's pass boundaries: it moves the
    ramp's cap and the dense rounds from the values the pass's read
    brought back, with no read of its own, and writes a ``tune`` record
    a move (``last_stats["tune_adjustments"]``).  Neither changes the
    states found or their order.
    """

    def __init__(
        self,
        model,
        invariants: Optional[Tuple[str, ...]] = None,
        check_deadlock: bool = True,
        sub_batch: Optional[int] = None,
        visited_cap: int = 1 << 16,
        max_states: int = 1 << 26,
        device=None,
        progress: bool = False,
        hbm_budget=None,
        spill_compress: Optional[bool] = None,
        fuse: str = "level",
        fuse_group: Optional[int] = None,
        time_budget_s: Optional[float] = None,
        rows_window: str = "all",
        row_cap_states: Optional[int] = None,
        spill_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 5,
        expand_chunk: Optional[int] = None,
        flush_factor: Optional[int] = None,
        group: Optional[int] = None,
        fp_bits: Optional[int] = None,
        frontier_cap: Optional[int] = None,
        metrics_path: Optional[str] = None,
        visited_impl: str = "fpset",
        compact_impl: Optional[str] = None,
        seed_cap: Optional[int] = None,
        hbm_headroom: Optional[float] = None,
        miss_batch: Optional[int] = None,
        fpset_dense_rounds: Optional[int] = None,
        fpset_stages=None,
        profile=None,
        adapt: Optional[bool] = None,
        telemetry=None,
        heartbeat_s: Optional[float] = None,
        xprof_dir: Optional[str] = None,
        xprof_levels: Optional[Tuple[int, int]] = None,
        suspend_hook=None,
    ):
        if visited_impl not in ("fpset", "sort"):
            raise ValueError(
                f"visited_impl must be fpset|sort: {visited_impl}")
        self.device = device_mod.resolve(device)
        if invariants is None:
            invariants = model.default_invariants
        # Tuned-profile resolution (tune/profiles.py): explicit ctor knobs
        # win; knobs left at None take the resolved profile's value, then
        # the engine default.  The budget resolves first: the tiered
        # regime is part of the profile key.
        self.hbm_budget = store_budget.resolve_budget(hbm_budget)
        self.tiered = self.hbm_budget is not None
        prof = tune_profiles.resolve(
            profile, model=model, invariants=tuple(invariants),
            engine="device_bfs", tiered=self.tiered,
            backend=tune_profiles.default_backend(self.device),
        )
        self.profile_sig = prof["sig"] if prof else None
        pk = tune_profiles.knobs_for(prof, "device_bfs")
        explicit = dict(
            sub_batch=sub_batch, flush_factor=flush_factor, group=group,
            fuse_group=fuse_group, fpset_dense_rounds=fpset_dense_rounds,
            fpset_stages=fpset_stages, compact_impl=compact_impl,
            hbm_headroom=hbm_headroom, spill_compress=spill_compress,
            miss_batch=miss_batch,
        )
        self.profile_applied = tuple(sorted(
            k for k in pk if k != "adapt" and explicit.get(k) is None))
        default = dict(sub_batch=1 << 16, flush_factor=1, group=GROUP,
                       compact_impl="logshift")
        knob = {k: (pk.get(k, default.get(k)) if v is None else v)
                for k, v in explicit.items()}
        sub_batch, flush_factor = knob["sub_batch"], knob["flush_factor"]
        group, fuse_group = knob["group"], knob["fuse_group"]
        compact_impl = knob["compact_impl"]
        hbm_headroom, miss_batch = knob["hbm_headroom"], knob["miss_batch"]
        spill_compress = knob["spill_compress"]
        # the probe schedule of the tiled flush; the online controller
        # (PTT_TUNE_ADAPT=0 > explicit > the profile's "adapt") moves it
        # from this base within a run
        self._fps_base = fpset.resolve_schedule(knob["fpset_dense_rounds"],
                                                knob["fpset_stages"])
        self.fps_dense, self.fps_stages = self._fps_base
        self.adapt = tune_online.resolve_adapt(adapt,
                                               bool(pk.get("adapt", False)))
        self.visited_impl = visited_impl
        self.sorted = visited_impl == "sort"
        if self.sorted:
            fuse = "stage"  # the fused level chains the fpset flush
        elif seed_cap is not None:
            raise ValueError(
                "seed_cap sizes the sort-merge seed columns "
                "(visited_impl='sort'); the fpset seed goes straight "
                "into the table")
        self.compact_impl = validate_impl(compact_impl)
        if fuse not in ("level", "stage"):
            raise ValueError(f"fuse must be level|stage: {fuse}")
        if fuse_group is not None and fuse_group < 1:
            raise ValueError(f"fuse_group must be >= 1: {fuse_group}")
        if rows_window not in ("all", "frontier"):
            raise ValueError(
                f"rows_window must be all|frontier: {rows_window}")
        self.fuse = fuse
        self.RMAX = min(fuse_group or 8, 64)
        self.model = model
        self.layout = model.layout
        unknown = [n for n in invariants if n not in model.invariants]
        if unknown:
            raise ValueError(f"unknown invariant(s): {unknown}")
        self.invariant_names = tuple(invariants)
        self.check_deadlock = check_deadlock
        if sub_batch < 1:
            raise ValueError(f"sub_batch must be >= 1: {sub_batch}")
        self.Fi = expand_chunk or sub_batch
        if self.Fi < 1 or sub_batch % self.Fi:
            raise ValueError("sub_batch must be a multiple of expand_chunk")
        if flush_factor < 1:
            raise ValueError(f"flush_factor must be >= 1: {flush_factor}")
        if group < 1:
            raise ValueError(f"group must be >= 1: {group}")
        self.FLUSH, self.group = flush_factor, group
        # G: the frontier rows of one flush window
        self.A, self.W = model.A, self.layout.W
        self.G = sub_batch * flush_factor
        self.keys = KeySpec(self.layout.total_bits, self.W, fp_bits)
        self.K = self.keys.ncols
        self.SCAP = max_states
        self.TCAP0 = _pow2_at_least(2 * visited_cap, 1 << 11)
        self.WCAP0 = _pow2_at_least(min(max(self.TCAP0 // 2,
                                            frontier_cap or 0),
                                        max_states + 1))
        self.NQ = self.G * self.A  # lanes of one flush window
        # the seed loader's chunk, and (sort) its merge columns
        self.SEED_CHUNK = min(SEED_CHUNK, self.NQ)
        self.SEED_VCAP = (_pow2_at_least(seed_cap) if seed_cap is not None
                          else SEED_VCAP)
        self._seed_staged = None
        self.metrics_path = metrics_path
        self.hbm_headroom = (HBM_HEADROOM if hbm_headroom is None
                             else float(hbm_headroom))
        if not 0.0 <= self.hbm_headroom < 1.0:
            raise ValueError(
                f"hbm_headroom must be in [0, 1): {self.hbm_headroom}")
        self.miss_batch = int(miss_batch or MISS_BATCH)
        if self.miss_batch < 1:
            raise ValueError(f"miss_batch must be >= 1: {self.miss_batch}")
        self.rows_window = rows_window
        self.frontier = rows_window == "frontier"
        if self.frontier:
            rc = row_cap_states or 2 * self.NQ
            # the frontier and the level being built, plus one blind
            # append window past the cap
            self.LCAP = max(rc, self.NQ) + self.NQ
        self.time_budget_s = time_budget_s
        self.progress = progress
        self.last_stats: Dict[str, object] = {}
        self.last_bufs: Dict[str, torch.Tensor] = {}
        if self.tiered and self.sorted:
            raise ValueError(
                "the tiered store needs the fpset visited set "
                "(hbm_budget with visited_impl='sort' is unsupported)")
        if self.tiered and self.frontier:
            raise ValueError(
                "hbm_budget and rows_window='frontier' are mutually "
                "exclusive — the tiered store IS the row-window story "
                "(aged rows spill instead of dropping)"
            )
        self.spill_compress = spill_compress is not False
        self._spill_dir_arg = spill_dir
        self.tstore: Optional[TieredStore] = None
        self._budget_overridden = False
        self._row_base = self._log_base = 0
        if self.tiered:
            self.TCAP_MAX, self.WCAP_MAX = self._tier_ceilings()
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.rec = recovery.RecoveryState(checkpoint_path)
        self._watcher = None
        # the daemon's hooks (``service/scheduler.py``), reassigned
        # between runs of one pooled checker: ``suspend_hook`` is polled
        # at level boundaries ("suspended" or another reason: a frame,
        # then a resumable stop; "cancelled": stop, no frame);
        # ``final_frame`` writes a frame at a clean completion too (the
        # warm-reseed artifact); ``extra_trace_depth`` widens the trace
        # walk's depth bound for a reseeded run, whose merged seed
        # levels no longer bound the parent chains; ``tenant``,
        # ``trace_id`` and ``warm`` go onto the run header
        self.suspend_hook = suspend_hook
        self.final_frame = False
        self.extra_trace_depth = 0
        self.tenant: Optional[str] = None
        self.trace_id: Optional[str] = None
        self.warm: Optional[str] = None
        # telemetry: the stream opens a run with a fresh run_id; the
        # heartbeat reports from ``_snap``, the last host snapshot, so
        # neither reads the device
        self._telemetry_arg = telemetry
        self.tel = obs.NULL
        self._run_id: Optional[str] = None
        self._snap: Dict[str, object] = {}
        self.heartbeat_s = heartbeat_s
        self.xprof_dir = xprof_dir
        self.xprof_levels = (tuple(int(x) for x in xprof_levels)
                             if xprof_levels else None)
        self._prof = None
        # PTT_STAGE_TIMING=1: synchronize after every stage and charge
        # its wall to ``stage_<name>_s`` (serializes the loop; each
        # drain pays one round trip, which the report subtracts via
        # ``rtt_s``).  The counts ``stage_<name>_n`` ride regardless.
        self._stage_timing = os.environ.get(
            "PTT_STAGE_TIMING", "0") not in ("", "0")
        self._reset_telemetry()

    def _reset_telemetry(self) -> None:
        """A run's telemetry state: work units, stage counters, the
        flush-record baseline, the profiler window."""
        self._work: Dict[str, int] = {}
        self._stages: Dict[str, float] = {}
        self._stage_t = time.perf_counter()
        self._fpm_host = self._fpm_prev = [0] * fpset.FPM_N
        self._wkm_host = [0] * fpset.WKM_N
        self._compact_prev, self._compact_prev_s = 0, 0.0
        self._spill_mark, self._spill_degraded_emitted = 0, False
        self._resume_meta: Dict[str, object] = {}
        self._rtt_s = None
        self._xprof_done = False

    # ------------------------------------------------- tiered-store sizing

    def _device_bytes_est(self, tcap: int, rows_cap: int,
                          logs_cap: int) -> int:
        """Resident bytes at a tier: the table's K key columns and its
        generation column, the row window, the parent/lane log window,
        and one expand window's packed rows and keys.  This is what the
        budget caps."""
        fixed = (self.W + self.K) * self.NQ * 4
        table = (tcap + 1) * (self.K + 1) * 4
        rows = rows_cap * self.W * 4
        logs = 2 * logs_cap * 4
        return fixed + table + rows + logs

    def _tier_ceilings(self) -> Tuple[int, int]:
        """(table slots, window states) ceilings: double the table and
        the window in turn from their initial sizes while the estimate
        stays inside the budget less its headroom.  Rows and logs share
        one window in tiered mode.  The table never goes below the room
        for two flushes at load 1/2."""
        eff = int(self.hbm_budget * (1.0 - self.hbm_headroom))
        tc, wc = self.TCAP0, self.WCAP0
        if self._device_bytes_est(tc, wc, wc) > eff:
            need = self._device_bytes_est(tc, wc, wc)
            raise ValueError(
                "hbm_budget too small: the initial tiers need "
                f"{store_budget.fmt_bytes(need)} "
                f"(+{self.hbm_headroom:.0%} "
                "headroom) but the budget is "
                f"{store_budget.fmt_bytes(self.hbm_budget)} — raise the "
                "budget or shrink sub_batch/visited_cap"
            )
        capv = max(self.SCAP + self.NQ, 2 * self.NQ)
        capw = self.SCAP + self.NQ
        while True:
            grew = False
            if tc // 2 < capv and self._device_bytes_est(
                2 * tc, wc, wc
            ) <= eff:
                tc *= 2
                grew = True
            nw = wc + min(wc, max(capw - wc, 0))
            if nw > wc and self._device_bytes_est(tc, nw, nw) <= eff:
                wc = nw
                grew = True
            if not grew:
                break
        while tc // 2 < 2 * self.NQ:
            tc *= 2
        return tc, wc

    # ------------------------------------------------------------ buffers

    def _log(self, msg: str) -> None:
        if self.progress:
            print(f"  {msg}", file=sys.stderr, flush=True)

    def _alloc(self) -> None:
        """A fresh run's tensors: the empty table, the row store (the
        fixed window in frontier mode) and the logs."""
        dev = self.device
        if self.sorted:
            self._tcols = self._sorted_cols(self.TCAP0 // 2)
            self._claims = None
        else:
            self._tcols = fpset.empty_cols(self.TCAP0, self.K, dev)
            self._claims = fpset.new_claims(self.TCAP0, dev)
        rows = self.LCAP if self.frontier else self.WCAP0
        self._rows = torch.zeros((rows, self.W), dtype=torch.int32,
                                 device=dev)
        self._parent = torch.zeros((self.WCAP0,), dtype=torch.int32,
                                   device=dev)
        self._lane = torch.zeros((self.WCAP0,), dtype=torch.int32,
                                 device=dev)
        self._fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64,
                                device=dev)
        self._wkm = torch.zeros((fpset.WKM_N,), dtype=torch.int64,
                                device=dev)
        self._rehash_failed = torch.zeros((), dtype=torch.int64, device=dev)
        if self.tiered:
            self._gen = torch.zeros((self.TCAP0 + 1,), dtype=torch.int32,
                                    device=dev)

    def _free_buffers(self) -> None:
        """Drop every device tensor of the run (before a rebuild from a
        frame), and PyTorch's cache of the freed blocks."""
        for attr in ("_tcols", "_claims", "_rows", "_parent", "_lane",
                     "_gen", "_fpm", "_wkm", "_rehash_failed", "_nv_t", "_dead_t",
                     "_viol_t"):
            setattr(self, attr, None)
        self.last_bufs = {}
        self._lv_active = False
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _ensure_table(self, need: int, ceiling: Optional[int] = None) -> None:
        """Double the visited table (rehash on the device) until ``need``
        states fit at load <= 1/2, or it reaches ``ceiling`` slots.  In
        tiered mode the per-slot ages die with the old layout: every key
        restarts at generation 1, epoch 2.  The sort-merge visited set
        instead pads its columns to hold ``need`` keys."""
        if self.sorted:
            cap = self._tcols[0].shape[0]
            if need > cap:
                pad = self._sorted_cols(_pow2_at_least(need, cap) - cap)
                self._tcols = tuple(torch.cat([c, p])
                                    for c, p in zip(self._tcols, pad))
            return
        cap = self._tcols[0].shape[0] - 1
        if need <= cap // 2:
            return
        new_cap = _pow2_at_least(2 * need, cap)
        if ceiling is not None:
            new_cap = min(new_cap, ceiling)
        if new_cap <= cap:
            return
        claims = fpset.new_claims(new_cap, self.device)
        new, failed = fpset.rehash_cols(
            self._tcols, fpset.empty_cols(new_cap, self.K, self.device),
            claims=claims,
        )
        # read with the next probe-overflow check (_check_overflow)
        self._rehash_failed = self._rehash_failed + failed
        self._tcols, self._claims = new, claims
        if self.tiered:
            self._gen = sieve.tag_generation(
                new, torch.zeros((new_cap + 1,), dtype=torch.int32,
                                 device=self.device), 1,
            )
            self._epoch = 2
        self._log(f"visited table grown to {new_cap} slots")

    def _sorted_cols(self, n: int) -> Tuple[torch.Tensor, ...]:
        """``n`` empty (SENTINEL) slots of the K sorted key columns."""
        return tuple(torch.full((n,), SENTINEL, dtype=torch.int32,
                                device=self.device) for _ in range(self.K))

    def _visited_cap(self) -> int:
        """States the visited set admits before it grows (the JAX
        ``VCAP``): half the table's slots, or the sorted columns'
        length."""
        if self.sorted:
            return self._tcols[0].shape[0]
        return (self._tcols[0].shape[0] - 1) // 2

    def _grow_store(self, new_cap: int) -> None:
        """Grow the row window and the parent/lane logs to ``new_cap``
        states (contents kept)."""
        self._rows = _grown(self._rows, new_cap)
        self._grow_logs(new_cap)

    def _grow_logs(self, new_cap: int) -> None:
        self._parent = _grown(self._parent, new_cap)
        self._lane = _grown(self._lane, new_cap)

    def _ensure_store(self, need: int) -> None:
        """Room for states up to gid ``need`` (doubling): the logs, and
        the rows unless they are the frontier window (whose size is
        fixed); tiered, within the window ceiling."""
        if self.frontier:
            cap = self._parent.shape[0]
            if need > cap:
                self._grow_logs(_pow2_at_least(need, cap))
            return
        cap = self._rows.shape[0]
        need -= self._row_base
        if need > cap:
            new = _pow2_at_least(need, cap)
            if self.tiered:
                new = min(new, max(self._wcap_max, cap))
            if new > cap:
                self._grow_store(new)

    # ------------------------------------------------------ tiered store

    def _mk_tstore(self) -> None:
        """A fresh TieredStore for this run: durable when the run
        checkpoints (its files beside the frame, so a resume restores
        the whole store through the frame's manifest)."""
        if self.tstore is not None:
            self.tstore.close()
        sdir = self._spill_dir_arg or (
            f"{self.checkpoint_path}.spill" if self.checkpoint_path
            else None
        )
        self.tstore = TieredStore(
            self.K, spill_dir=sdir, compress=self.spill_compress,
            durable=bool(self.checkpoint_path),
        )

    def _override_budget(self, what: str) -> None:
        if not self._budget_overridden:
            self._budget_overridden = True
            self._log(
                f"WARNING: hbm_budget too small for the live {what} — "
                "growing past the budget"
            )

    def _ensure_hot_capacity(self, head: int) -> None:
        """Admit ``head`` more keys in the hot table at load <= 1/2: grow
        within the budget, else evict the cold generations (all but the
        newest tagged one, then all tagged), else grow past the
        budget."""
        def fits():
            return self._hot_n + head <= (self._tcols[0].shape[0] - 1) // 2

        if fits():
            return
        if self._tcols[0].shape[0] - 1 < self._tcap_max:
            self._ensure_table(self._hot_n + head, self._tcap_max)
            if fits():
                return
        for cutoff in (self._epoch - 2, self._epoch - 1):
            if cutoff >= 1 and not fits():
                self._evict_cold_keys(cutoff)
        if fits():
            return
        self._override_budget("frontier")
        self._tcap_max = max(2 * self._tcap_max,
                             _pow2_at_least(2 * (self._hot_n + head)))
        self._ensure_table(self._hot_n + head, self._tcap_max)

    def _evict_cold_keys(self, cutoff: int) -> int:
        """Evict generations <= ``cutoff`` to the cold tier: extract
        (K3 + sort), D2H of the sorted prefix, a rehash of the
        survivors at the same capacity, all survivors at generation 1.
        Returns the evicted count."""
        holed, _gen, ev, n = sieve.extract_cold(
            self._tcols, self._gen, cutoff
        )
        if n == 0:
            return 0
        t0 = time.perf_counter()
        ev_np = [c[:n].cpu().numpy().view(np.uint32) for c in ev]
        self.tstore.note_transfer(time.perf_counter() - t0)
        cap = self._tcols[0].shape[0] - 1
        self._tcols = None  # the holed copy replaces it
        new, failed = fpset.rehash_cols(
            holed, fpset.empty_cols(cap, self.K, self.device),
            claims=self._claims,
        )
        if int(failed):
            raise RuntimeError(
                f"visited-table rehash overflow during eviction ({failed})"
            )
        self._tcols = new
        self._gen = sieve.tag_generation(
            new, torch.zeros_like(self._gen), 1
        )
        self._epoch = 2
        self.tstore.evict_keys(ev_np)
        self._hot_n -= n
        self._spill_active = True
        tier = "ram+disk" if self.tstore.durable else "ram"
        self._log(f"spill: evicted {n} cold keys to the {tier} tier "
                  f"(hot {self._hot_n})")
        return n

    def _resolve_cold_misses(self, kcols, is_new, n_new: int):
        """Resolve the flush's hot-new lanes against the cold runs in
        ``miss_batch``-key batches and clear the false-new lanes.
        Returns the corrected ``(n_new, is_new)``."""
        *kc, lanes, n = sieve.sieve_new(kcols, is_new)
        self._spill_syncs += 1
        false_lanes = []
        for off in range(0, n, self.miss_batch):
            m = min(self.miss_batch, n - off)
            t0 = time.perf_counter()
            kq = [c[off: off + m].cpu().numpy().view(np.uint32) for c in kc]
            lq = lanes[off: off + m].cpu().numpy()
            self.tstore.note_transfer(time.perf_counter() - t0)
            dup = self.tstore.lookup_keys(kq)
            if dup.any():
                false_lanes.append(lq[dup])
        if not false_lanes:
            return n_new, is_new
        fl = np.concatenate(false_lanes)
        is_new = sieve.unflag_lanes(
            is_new, torch.from_numpy(fl).to(self.device), len(fl)
        )
        return n_new - len(fl), is_new

    def _spill_aged(self, upto: int) -> None:
        """Spill rows + trace logs of ``[row_base, upto)`` to the cold
        tier and slide the window down."""
        base = self._row_base
        if upto <= base:
            return
        n, keep = upto - base, self._nv - upto
        t0 = time.perf_counter()
        rows = _host(self._rows[:n]).view(np.uint32).reshape(-1)
        par, lan = _host(self._parent[:n]), _host(self._lane[:n])
        self.tstore.note_transfer(time.perf_counter() - t0)
        self.tstore.spill_rows(base, upto, rows)
        self.tstore.spill_logs(base, upto, par, lan)
        for t in (self._rows, self._parent, self._lane):
            t[:keep] = t[n: n + keep].clone()  # the ranges overlap
        self._row_base = self._log_base = upto
        self._spill_active = True

    def _tiered_ensure_windows(self, level_base: int, need_abs: int,
                               hard: bool = True) -> None:
        """Admit states up to gid ``need_abs`` in the row/log window:
        spill the aged range (everything before the frontier at
        ``level_base``) first, then grow within the budget, and only
        past both — for a ``hard`` need, one a flush is about to
        write — grow past the budget."""
        def short():
            return need_abs - self._row_base > self._rows.shape[0]

        if not short():
            return
        if level_base > self._row_base:
            self._spill_aged(level_base)
            if not short():
                return
        need = need_abs - self._row_base
        cap = self._rows.shape[0]
        if cap < self._wcap_max:
            self._grow_store(min(_pow2_at_least(need, cap), self._wcap_max))
            if not short():
                return
        if hard:
            self._override_budget("windows")
            self._wcap_max = max(2 * self._wcap_max, need)
            self._grow_store(min(_pow2_at_least(need, cap), self._wcap_max))

    def _tiered_pressure(self) -> bool:
        """Must the level loop run the stage loop from here on?  Latches
        ``_spill_active`` when the hot table plus two windows would pass
        its ceiling, or the row/log window could not take the next
        append window."""
        if not self._spill_active:
            hot = self._hot_n + 2 * self.NQ > self._tcap_max // 2
            win = self._nv - self._row_base + self.NQ > self._wcap_max
            if hot or win:
                self._spill_active = True
        return self._spill_active

    def _tiered_boundary(self, level_base: int) -> None:
        """Level-boundary housekeeping: tag the epoch, make room within
        the budget for the next level's first flush, spill aged
        rows/logs once spilling is active, and keep the hot table inside
        the budget.  The room made here is a soft ask: the flush itself
        knows how many states it appends and makes room then."""
        self._gen = sieve.tag_generation(self._tcols, self._gen, self._epoch)
        self._epoch += 1
        self._tiered_ensure_windows(level_base, self._nv + self.NQ,
                                    hard=False)
        if self._spill_active and level_base > self._row_base:
            self._spill_aged(level_base)
        self._ensure_hot_capacity(2 * self.NQ)

    def merged_logs(self) -> Tuple[np.ndarray, np.ndarray]:
        """The parent and lane logs of every state found, int32 numpy
        ``[nv]``: the cold segments, then the device window."""
        nv, base = self._nv, self._log_base
        par = self._parent[: nv - base].cpu().numpy()
        lan = self._lane[: nv - base].cpu().numpy()
        if not base:
            return par, lan
        cp, cl = self.tstore.fetch_logs(0, base)
        return np.concatenate([cp, par]), np.concatenate([cl, lan])

    def merged_rows(self) -> np.ndarray:
        """The packed rows of every state found, flat uint32 numpy
        ``[nv * W]``: the cold segments, then the device window (the
        frontier window keeps no older rows)."""
        nv, base = self._nv, self._row_base
        if self.frontier and base:
            raise ValueError("the frontier row window dropped the rows "
                             f"before gid {base}")
        rows = self._rows[: nv - base].cpu().numpy().view(np.uint32)
        if not base:
            return rows.reshape(-1)
        cold = self.tstore.fetch_rows(0, base, self.W)
        return np.concatenate([cold, rows.reshape(-1)])

    # -------------------------------------------------------- the stages

    def _read(self, *vals: torch.Tensor) -> List[int]:
        """Device values as host ints, in one read (a sync with the
        card), counted in ``host_syncs``."""
        self._host_syncs += 1
        t = time.perf_counter()
        flat = [v.reshape(-1).to(torch.int64) for v in vals]
        out = torch.cat(flat).tolist()
        self._host_wait_s += time.perf_counter() - t
        return out

    # ------------------------------------------------------ telemetry

    def _stage_open(self) -> None:
        """Start the stage clock (PTT_STAGE_TIMING: after a drain)."""
        if self._stage_timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._stage_t = time.perf_counter()

    def _stage_mark(self, name: str) -> None:
        """Count one ``name`` stage (``stage_<name>_n``); under
        PTT_STAGE_TIMING also drain the device and charge the wall since
        the last mark to ``stage_<name>_s``."""
        st = self._stages
        st[f"stage_{name}_n"] = st.get(f"stage_{name}_n", 0) + 1
        if not self._stage_timing:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        st[f"stage_{name}_s"] = (st.get(f"stage_{name}_s", 0.0)
                                 + now - self._stage_t)
        self._stage_t = now

    def _work_add(self, **units) -> None:
        """Host-side work units (the stage loop's, and what the host
        knows in both loops: initial lanes, a seed's states)."""
        for k, v in units.items():
            self._work[k] = self._work.get(k, 0) + int(v)

    def _took_fpm(self, fpm: List[int]) -> None:
        """A read carried the flush metrics: refresh the heartbeat
        snapshot and write one ``flush`` record (deltas since the last)
        and one ``compact`` record — host arithmetic on values already
        read."""
        self._fpm_host = fpm
        nv = self._nv
        self._snap["distinct_states"] = nv
        if self.sorted:
            return
        tcap = max(self._tcols[0].shape[0] - 1, 1)
        self._snap["occupancy"] = nv / tcap
        self._snap["generated"] = fpm[3]
        if not self.tel.enabled:
            return
        d = [a - b for a, b in zip(fpm, self._fpm_prev)]
        if d[0] > 0:
            self._fpm_prev = list(fpm)
            self.tel.emit(
                "flush",
                flushes=d[0],
                probe_rounds=d[1],
                failures=d[2],
                valid_lanes=d[3],
                avg_probe_rounds=round(d[1] / max(d[0], 1), 2),
                max_probe_rounds=fpm[4],
                occupancy=round(nv / tcap, 4),
                distinct_states=nv,
            )
        n = self._stages.get("stage_compact_n", 0)
        if n > self._compact_prev:
            f = dict(dispatches=n - self._compact_prev,
                     impl=self.compact_impl)
            cs = self._stages.get("stage_compact_s")
            if cs is not None:
                f["drain_s"] = round(cs - self._compact_prev_s, 4)
                self._compact_prev_s = cs
            self._compact_prev = n
            self.tel.emit("compact", **f)

    def _emit_header(self, resume: bool) -> None:
        """The run header (``obs.emit_header``)."""
        obs.emit_header(
            self.tel, self.device, resume, self._resume_meta,
            engine="device_bfs",
            visited_impl=self.visited_impl,
            compact_impl=self.compact_impl,
            fuse=self.fuse,
            fuse_group=self.RMAX,
            config_sig=self._config_sig(),
            max_states=self.SCAP,
            sub_batch=self.G // self.FLUSH,
            flush_factor=self.FLUSH,
            key_cols=self.K,
            key_exact=bool(self.keys.exact),
            rows_window=self.rows_window,
            invariants=list(self.invariant_names),
            profile_sig=self.profile_sig,
            adapt=self.adapt,
            hbm_budget=self.hbm_budget,
            mode="check",
            tenant=self.tenant,
            trace_id=self.trace_id,
            warm=self.warm,
        )

    def _emit_spill(self, level: int) -> None:
        """One cumulative ``spill`` record at a level boundary when the
        tiered store moved anything since the last one."""
        ts = self.tstore
        if ts is None or not self.tel.enabled:
            return
        sp = ts.stats
        degraded = bool(ts.degraded)
        mark = (sp.evictions + sp.keys_evicted + sp.rows_evicted
                + sp.misses_resolved)
        if mark == self._spill_mark and not (
                degraded and not self._spill_degraded_emitted):
            return
        ts.flush()  # byte counts final
        self._spill_mark = mark
        if degraded:
            self._spill_degraded_emitted = True
        self.tel.emit(
            "spill",
            tier="ram+disk" if ts.durable else "ram",
            level=level,
            keys_evicted=int(sp.keys_evicted),
            rows_evicted=int(sp.rows_evicted),
            bytes_raw=int(sp.bytes_raw),
            bytes_comp=int(sp.bytes_comp),
            transfer_s=round(sp.transfer_s, 4),
            misses_resolved=int(sp.misses_resolved),
            miss_hits=int(sp.miss_hits),
            evictions=int(sp.evictions),
            hot_keys=int(self._hot_n),
            **({"degraded": True} if degraded else {}),
        )

    def _xprof_tick(self, level_next: int) -> None:
        """Start the ``torch.profiler`` window at the first level of
        ``xprof_levels`` (no window: the whole run) and stop it after
        the last; one window a run."""
        if not self.xprof_dir:
            return
        lo, hi = self.xprof_levels or (0, 1 << 30)
        if self._prof is not None and level_next > hi:
            self._xprof_close()
        if (self._prof is None and not self._xprof_done
                and lo <= level_next <= hi):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self.tel.emit("xprof", action="start", level=level_next,
                          dir=self.xprof_dir)

    def _xprof_close(self) -> None:
        """Stop the profiler window and write its Chrome trace
        (``<xprof_dir>/trace_<run_id>.json``)."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        self._xprof_done = True
        path = os.path.join(self.xprof_dir, f"trace_{self._run_id}.json")
        try:
            prof.stop()
            os.makedirs(self.xprof_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        finally:
            self.tel.emit("xprof", action="stop", dir=self.xprof_dir,
                          path=path)

    def _lanes(self, rows: torch.Tensor, rowvalid=None):
        """The window's successor lanes, expanded in chunks of
        ``expand_chunk`` rows: ``(packed [n*A, W], key cols, dead)``
        with ``dead`` the first deadlocked row (BIG if none; an int64
        0-d tensor, None without the deadlock check); rows outside
        ``rowvalid`` have no lanes."""
        m, n = self.model, rows.shape[0]
        parts, dead = [], None
        for c in range(0, max(n, 1), self.Fi):
            rc = rows[c: c + self.Fi]
            states = self.layout.unpack(rc)
            succ, valid = m.successors(states)
            rv = None if rowvalid is None else rowvalid[c: c + self.Fi]
            if rv is not None:
                valid = valid & rv[:, None]
            packed = self.layout.pack(succ).reshape(-1, self.W)
            kcols = tiles.key_plane(self.keys, packed, valid.reshape(-1))
            parts.append((packed, *kcols))
            if self.check_deadlock:
                dd = ~valid.any(dim=1) & ~m.stutter_enabled(states)
                if rv is not None:
                    dd = dd & rv
                pos = torch.arange(c, c + dd.shape[0], device=self.device)
                d = torch.where(dd, pos, BIG).amin()
                dead = d if dead is None else torch.minimum(dead, d)
        if len(parts) == 1:
            packed, *kcols = parts[0]
        else:
            packed, *kcols = (torch.cat(p) for p in zip(*parts))
        return packed, tuple(kcols), dead

    def _expand(self, f_off: int, n: int):
        """Expand frontier rows ``[f_off, f_off + n)`` (absolute gids):
        ``(packed [n*A, W], key cols)``; records a deadlocked row."""
        off = f_off - self._row_base
        packed, kcols, dead = self._lanes(self._rows[off: off + n])
        if dead is not None:
            (d,) = self._read(dead)
            if d < BIG:
                self._dead = min(self._dead, f_off + d)
        return packed, kcols

    def _flush_fault(self) -> bool:
        """The ``flush`` fault site (host-side, before a flush): raises
        the injected oom; True when an ``fpset_fail`` must be realized
        as a probe overflow after the flush."""
        self._flush_seq += 1
        kinds = faults.poll("flush", self._flush_seq)
        if "oom" in kinds:
            raise faults.oom_error("flush", self._flush_seq)
        return "fpset_fail" in kinds

    def _flush(self, packed, kcols, acc_base: int, is_init: bool) -> None:
        """Flush + compact + append one window's candidate lanes; lane
        ``j`` came from source ``acc_base + j // A`` (expand) or is
        initial state ``acc_base + j`` (init)."""
        nq = packed.shape[0]
        fail = self._flush_fault()
        self._work_add(probe_lanes=nq, compact_elems=nq, groups=1)
        if self.tiered:
            self._ensure_hot_capacity(nq)
        else:
            self._ensure_table(self._nv + nq)
        if self.sorted:
            # equal keys: the lowest lane wins, as in the fpset
            self._tcols, n_new, is_new = merge_lanes(self._tcols, kcols, nq)
            (n_new,) = self._read(n_new)
        else:
            self._tcols, n_new, is_new, self._fpm = tiles.flush_acc_tiles(
                self._tcols, kcols, nq, self._fpm, self._claims,
                self.fps_dense, self.fps_stages,
            )
            self._host_syncs += 1  # flush_acc_tiles read the count
        if fail:
            self._fpm[2] += 1
        *fpm, rehash = self._read(self._fpm, self._rehash_failed)
        self._took_fpm(fpm)
        self._check_overflow(fpm[2], rehash)
        if self.tiered:
            # every hot-new key stays inserted, false-new ones included
            self._hot_n += n_new
            if n_new and self.tstore.has_cold_keys:
                n_new, is_new = self._resolve_cold_misses(
                    kcols, is_new, n_new
                )
        self._stage_mark("flush")
        if not n_new:
            return
        crows, idx = compact_rows(packed, is_new, self.compact_impl)
        crows, idx = crows[:n_new], idx[:n_new]
        self._stage_mark("compact")
        nv = self._nv
        if self.tiered:
            self._tiered_ensure_windows(self._level_base, nv + n_new)
        else:
            self._ensure_store(nv + n_new)
        w = nv - self._row_base
        if self._rows_ok and w + n_new > self._rows.shape[0]:
            self._drop_rows()
        if self._rows_ok:
            self._rows[w: w + n_new] = crows
        w = nv - self._log_base
        if is_init:
            self._parent[w: w + n_new] = (-1 - (acc_base + idx)).to(
                torch.int32
            )
            self._lane[w: w + n_new] = 0
        else:
            self._parent[w: w + n_new] = (acc_base + idx // self.A).to(
                torch.int32
            )
            self._lane[w: w + n_new] = (idx % self.A).to(torch.int32)
        if self.invariant_names:
            states = self.layout.unpack(crows)
            pos = torch.arange(n_new, device=self.device)
            first_bad = self._read(*[
                torch.where(self.model.invariants[name](states), BIG, pos)
                .amin()
                for name in self.invariant_names
            ])
            self._viol = [
                min(v, nv + b) if b < BIG else v
                for v, b in zip(self._viol, first_bad)
            ]
        self._nv = nv + n_new
        self._work_add(append_rows=n_new)
        self._stage_mark("append")

    def _drop_rows(self) -> None:
        """The frontier window is full: the rest of this level's rows are
        dropped (dedup, counts, invariants and logs go on)."""
        self._rows_ok = False
        self._log("rows window full: dropping rows for the rest of this "
                  "level")

    @staticmethod
    def _check_overflow(probe_failed: int, rehash_failed: int) -> None:
        """Raise if a flush or a table growth left keys unplaced."""
        if rehash_failed:
            raise RuntimeError(
                f"visited-table rehash overflow ({rehash_failed})"
            )
        if probe_failed:
            raise RuntimeError(
                f"visited-table probe overflow ({probe_failed} lanes "
                "unresolved): the table broke its load contract"
            )

    # ------------------------------------------------ the fused level

    def _headroom(self) -> int:
        """Growth headroom of the fused level in lanes: ``group + 1``
        (at least ``fuse_group``) windows; one after a device-memory
        recovery, and in tiered mode, where the table grows as the stage
        loop grows it (a growth re-tags every key at generation 1, so a
        table presized to its ceiling would leave a whole level in one
        generation for the first eviction to take)."""
        if self.rec.headroom_frozen or self.tiered:
            return self.NQ
        return max(self.group + 1, self.RMAX) * self.NQ

    def _lv_begin(self) -> None:
        """The fused level's device-held counters, from the host's exact
        ones (at a fresh start, after a restore or a stage level)."""
        dev = self.device
        self._nv_t = torch.full((), self._nv, dtype=torch.int64, device=dev)
        self._dead_t = torch.full((), self._dead, dtype=torch.int64,
                                  device=dev)
        self._viol_t = torch.full((len(self.invariant_names),), BIG,
                                  dtype=torch.int64, device=dev)
        for i, v in enumerate(self._viol):
            if v < BIG:
                self._viol_t[i] = v
        self._nv_hi = self._nv
        self._since_sync = 0
        self._lv_active = True

    def _lv_read(self, *extra: torch.Tensor) -> List[int]:
        """Read the device-held state count, deadlock gid and violation
        gids (and ``extra``) in one sync into the host's counters;
        returns the probe-failure counts and ``extra``."""
        n_inv = len(self.invariant_names)
        vals = self._read(self._nv_t, self._dead_t, self._viol_t,
                          self._fpm, self._rehash_failed, self._wkm,
                          *extra)
        self._nv, self._dead = vals[0], vals[1]
        self._viol = vals[2: 2 + n_inv]
        self._nv_hi = self._nv
        self._since_sync = 0
        o = 2 + n_inv
        fpm = vals[o: o + fpset.FPM_N]
        o += fpset.FPM_N
        rehash = vals[o]
        self._wkm_host = vals[o + 1: o + 1 + fpset.WKM_N]
        self._took_fpm(fpm)
        return [fpm[2], rehash, *vals[o + 1 + fpset.WKM_N:]]

    def _lv_sync(self, *extra: torch.Tensor) -> List[int]:
        """:meth:`_lv_read`, raise on a probe overflow, and grow the table
        and the store (tiered: within the ceilings) for the headroom.
        Returns the ``extra`` values."""
        probe, rehash, *rest = self._lv_read(*extra)
        self._check_overflow(probe, rehash)
        if self.tiered and not self._spill_active:
            self._hot_n = self._nv  # nothing evicted yet: every key hot
        if self._nv < self.SCAP:
            # room for the headroom's windows (never past max_states'
            # last window)
            need = min(self._nv + self._headroom(), self.SCAP + self.NQ)
            self._ensure_table(need, self._tcap_max if self.tiered else None)
            self._ensure_store(need)
        return rest

    def _lv_room(self, nq: int) -> bool:
        """Make room for a window of ``nq`` lanes: True at once when the
        bound ``nv_hi`` is under ``max_states``, ``nv_hi + nq`` fits the
        table's load contract, the logs and the rows (unless they are
        being dropped), and no timed sync is due; else sync (and grow)
        first, and False when the run must stop — or, tiered, when the
        capped tiers cannot take the window and the level loop must hand
        over to the stage loop (``_spill_active`` latched)."""
        def fits(hi):
            return (hi <= (self._tcols[0].shape[0] - 1) // 2
                    and hi - self._log_base <= self._parent.shape[0]
                    and (not self._rows_ok
                         or hi - self._row_base <= self._rows.shape[0]))

        hi = self._nv_hi + nq
        if (self._nv_hi < self.SCAP and fits(hi)
                and (self.time_budget_s is None
                     or self._since_sync < TIMED_SYNC_EVERY)):
            return True
        self._lv_sync()
        if self._stop_reason() is not None:
            return False
        hi = self._nv + nq
        if (self.frontier and self._rows_ok
                and hi - self._row_base > self._rows.shape[0]):
            self._drop_rows()
        if self.tiered and not fits(hi):
            self._spill_active = True
            return False
        return True

    def _lv_flush(self, packed, kcols, acc_base, is_init: bool,
                  rows=0) -> None:
        """The fused level's flush + compact + append of one window, with
        no host read: the compacted rows, parents and lanes of all ``nq``
        lanes go to gids ``nv + j`` (the rows past the new-state count
        are overwritten by later windows).  ``rows``: the live frontier
        rows the window expanded (an int, or a device count), for the
        work vector."""
        nq = packed.shape[0]
        dev = self.device
        fail = self._flush_fault()
        self._tcols, n_new, is_new, self._fpm = tiles.flush_tiles(
            self._tcols, kcols, nq, self._fpm, self._claims,
            self.fps_dense, self.fps_stages,
        )
        if fail:
            self._fpm[2] += 1
        crows, idx = compact_rows(packed, is_new, self.compact_impl)
        nv = self._nv_t
        pos = torch.arange(nq, device=dev)
        dest = nv + pos
        if self._rows_ok:
            self._rows.index_copy_(
                0, dest - self._row_base if self._row_base else dest, crows
            )
        if is_init:
            par, lane = -1 - (acc_base + idx), torch.zeros_like(idx)
        else:
            par, lane = acc_base + idx // self.A, idx % self.A
        if self._log_base:
            dest = dest - self._log_base
        self._parent.index_copy_(0, dest, par.to(torch.int32))
        self._lane.index_copy_(0, dest, lane.to(torch.int32))
        if self.invariant_names:
            states = self.layout.unpack(crows)
            old = pos >= n_new
            bad = torch.stack([
                torch.where(self.model.invariants[name](states) | old, BIG,
                            pos).amin()
                for name in self.invariant_names
            ])
            self._viol_t = torch.minimum(
                self._viol_t, torch.where(bad < BIG, nv + bad, BIG)
            )
        self._nv_t = nv + n_new
        self._wkm = fpset.wkm_update(self._wkm, rows, nq, nq, n_new, 1)
        self._nv_hi += nq
        self._since_sync += 1

    def _lv_window(self, rows, base, rowvalid=None) -> None:
        """Expand, flush and append one window of frontier rows whose
        first gid is ``base`` (an int, or a 0-d tensor in the ramp)."""
        packed, kcols, d = self._lanes(rows, rowvalid)
        if d is not None:
            self._dead_t = torch.minimum(
                self._dead_t, torch.where(d < BIG, base + d, BIG)
            )
        live = rows.shape[0] if rowvalid is None else rowvalid.sum()
        self._lv_flush(packed, kcols, base, False, live)

    def _lv_init(self) -> None:
        """The initial states in fused windows, then one read."""
        dev = self.device
        n_init = self.model.n_initial
        step = self.G * self.A
        for f_off in range(0, n_init, step):
            n = min(step, n_init - f_off)
            if not self._lv_room(n):
                break
            idx = torch.arange(f_off, f_off + n, device=dev)
            packed = self.layout.pack(self.model.gen_initial(idx))
            kcols = tiles.key_plane(
                self.keys, packed,
                torch.ones((n,), dtype=torch.bool, device=dev),
            )
            self._work_add(init_lanes=n)
            self._lv_flush(packed, kcols, f_off, True)
        self._lv_sync()

    def _lv_level(self, level_base: int, nf: int):
        """Enqueue every window of a level (offsets known on the host),
        syncing only for room: ``"done"``, ``"stop"`` (a sync stopped
        the run mid-level), or the frontier offset of the first window
        not run (tiered: the stage loop must take the level over from
        there)."""
        for f_off in range(0, nf, self.G):
            n = min(self.G, nf - f_off)
            if not self._lv_room(n * self.A):
                return "stop" if self._stop_reason() else f_off
            off = level_base + f_off - self._row_base
            self._lv_window(self._rows[off: off + n], level_base + f_off)
        return "done"

    def _levels_cap(self, levels_done: int) -> int:
        """Levels one ramp batch may close: ``fuse_group`` (or the
        online controller's cap, within ``[1, fuse_group]``), cut so
        that a checkpointed run's batch ends on a due frame level (frames
        and the preemption check keep their level-boundary meaning)."""
        lv = (self.RMAX if self._adapt_cap is None
              else max(1, min(self.RMAX, self._adapt_cap)))
        if self.checkpoint_path:
            lv = min(lv, self.checkpoint_every
                     - levels_done % self.checkpoint_every)
        return max(lv, 1)

    def _lv_ramp(self, level_base: int, nf: int,
                 cap: int) -> Tuple[list, int, int]:
        """A ramp batch: up to ``cap`` levels of one window each, the
        level base and frontier size held on the device, and one read at
        the end.  A level's window has as many rows as the host's bound
        on its frontier, ``nf * A^i`` for the batch's ``i``-th level,
        capped at ``G``; after the first level (whose frontier is
        known), the batch goes on only while a window has at most
        :data:`RAMP_SPEC_LANES` lanes.  Returns ``(sizes of the levels
        run, level_base, nf)``."""
        dev = self.device
        lb = torch.full((), level_base, dtype=torch.int64, device=dev)
        nft = torch.full((), nf, dtype=torch.int64, device=dev)
        live = torch.ones((), dtype=torch.bool, device=dev)
        sizes = []
        bound = nf
        for i in range(cap):
            n = min(bound, self.G)
            if i and n * self.A > RAMP_SPEC_LANES:
                break
            if not self._lv_room(n * self.A):
                break
            ar = torch.arange(n, device=dev)
            rows = self._rows.index_select(0, lb + ar)
            self._lv_window(rows, lb, (ar < nft) & live)
            bound *= self.A
            size = self._nv_t - (lb + nft)
            sizes.append(torch.where(live, size, -1))
            lb = torch.where(live, lb + nft, lb)
            nft = torch.where(live, size, nft)
            live = (live & (size > 0) & (size <= self.G)
                    & (self._dead_t == BIG) & (self._viol_t == BIG).all())
        lb_h, nf_h, *got = self._lv_sync(lb, nft, *sizes)
        return [z for z in got if z >= 0], lb_h, nf_h

    def _lv_pass(self, levels_done: int, level_base: int, nf: int):
        """One fused pass from a level boundary: a ramp batch (frontier
        within one window, rows not windowed) or one whole level.
        Returns ``(sizes, level_base, nf, done)`` as
        :meth:`_stage_level`, or, on a tiered handoff, the frontier
        offset where the stage loop takes the level over (the host's
        counters are exact there)."""
        if not self._lv_active:
            self._lv_begin()
        if nf <= self.G and not self.frontier:
            # the ramp reads rows at absolute gids: nothing has slid
            assert self._row_base == 0 and self._log_base == 0
            self._cap_asked = self._levels_cap(levels_done)
            sizes, lb, nf2 = self._lv_ramp(level_base, nf, self._cap_asked)
            if not sizes and self.tiered and self._spill_active:
                return 0
            self._fuse_levels += len(sizes)
            return sizes, lb, nf2, True
        self._cap_asked = 1
        how = self._lv_level(level_base, nf)
        if isinstance(how, int):
            return how
        cum = level_base + nf
        if how == "stop":
            return [self._nv - cum], level_base, nf, False
        self._lv_sync()
        self._fuse_levels += 1
        return [self._nv - cum], cum, self._nv - cum, True

    # ------------------------------------------------ the stage loop

    def _stage_init(self) -> None:
        """The initial states in windows, each flush read back."""
        dev = self.device
        n_init = self.model.n_initial
        step = self.G * self.A
        for f_off in range(0, n_init, step):
            n = min(step, n_init - f_off)
            self._stage_open()
            idx = torch.arange(f_off, f_off + n, device=dev)
            packed = self.layout.pack(self.model.gen_initial(idx))
            kcols = tiles.key_plane(
                self.keys, packed,
                torch.ones((n,), dtype=torch.bool, device=dev),
            )
            self._work_add(init_lanes=n)
            self._stage_mark("init")
            self._flush(packed, kcols, f_off, True)
            if self._stop_reason() is not None:
                break

    def _stage_level(self, level_base: int, nf: int, start: int = 0):
        """Expand one level window by window from frontier offset
        ``start`` (a fused level handed over there), each read back,
        checking the stop conditions after every flush.  Returns
        ``(sizes, level_base, nf, done)``: the level's count (its
        partial count when stopped; none when it added nothing), and the
        next level's frontier — or, when stopped mid-level (``done``
        False), this level's, where a frame rewinds to."""
        self._lv_active = False  # the host's counters are the truth now
        self._level_base = level_base
        stop = False
        for f_off in range(start, nf, self.G):
            n = min(self.G, nf - f_off)
            self._stage_open()
            packed, kcols = self._expand(level_base + f_off, n)
            self._work_add(expand_rows=n)
            self._stage_mark("expand")
            self._flush(packed, kcols, level_base + f_off, False)
            if self._stop_reason() is not None:
                stop = True
                break
        count = self._nv - (level_base + nf)
        sizes = [count] if count or stop else []
        if stop:
            return sizes, level_base, nf, False
        return sizes, level_base + nf, count, True

    # ---------------------------------------------------------- the run

    def _first_viol(self) -> Optional[Tuple[str, int]]:
        """(invariant, gid) of the lowest-gid violation, or None."""
        best = None
        for name, g in zip(self.invariant_names, self._viol):
            if g < BIG and (best is None or g < best[1]):
                best = (name, g)
        return best

    def _over_time(self) -> bool:
        # the budget runs on its own clock: a resumed run's wall is
        # cumulative, but it gets ``time_budget_s`` of fresh runway
        return (self.time_budget_s is not None
                and time.time() - self._budget_t0 > self.time_budget_s)

    def _stop_reason(self) -> Optional[dict]:
        """``_result`` kwargs if the run must stop: a violation, then a
        deadlock, then the state budget, then the time budget."""
        fv = self._first_viol()
        if fv is not None:
            return {"viol": fv}
        if self._dead < BIG:
            return {"dead_gid": self._dead}
        if self._nv >= self.SCAP:
            return {"truncated": True, "stop_reason": "max_states"}
        if self._over_time():
            return {"truncated": True, "stop_reason": "time_budget"}
        return None

    def run(self, seed=None, resume: bool = False) -> CheckerResult:
        """Check the model.  ``seed`` is a host-enumerated BFS prefix
        ``(packed rows uint32 [n, W], parent gids, action lanes, level
        sizes)`` (``model.host_seed``; see :meth:`_load_seed`).
        ``resume=True`` rebuilds the run from the ``checkpoint_path``
        frame and continues it (wall time cumulative across resumes; the
        time budget starts afresh)."""
        t0 = time.time()
        self._budget_t0 = t0
        self._host_wait_s = 0.0
        self.rec.reset()
        self._ckpt_frames = self._ckpt_bytes = self._ckpt_retries = 0
        self._ckpt_write_s = self._ckpt_last_s = self._restore_s = 0.0
        self._ckpt_last_d2h = 0.0
        self._flush_seq = 0
        self._bufs_poisoned = False
        self._handoff = None  # (level, fused levels before it)
        self._reset_telemetry()
        ckpt.cleanup_stale_tmp(self.checkpoint_path)
        # SIGTERM/SIGINT: a frame at the next level boundary, then a
        # resumable stop (only when there is a frame path to write)
        watcher = ckpt.PreemptionWatcher(
            enabled=bool(self.checkpoint_path), log=self._log
        )
        self._watcher = watcher
        with obs.run_scope(self, self._telemetry_arg, self.heartbeat_s,
                           self.SCAP):
            try:
                with watcher:
                    return self._run(t0, seed, resume)
            finally:
                self._watcher = None
                self._xprof_close()

    def _run(self, t0, seed, resume: bool) -> CheckerResult:
        dev = self.device
        if dev.type == "cuda":
            # K0 on this card (builds and loads the kernels on first use)
            kernels.selftest(dev)
        if self._stage_timing:
            # the round trip a stage drain pays (the report subtracts
            # stage_<name>_n x rtt_s)
            self._rtt_s = round(obs.measure_rtt(dev), 6)
        self._host_syncs = self._fuse_levels = self._fused_n = 0
        # online adaptation: a fresh controller a run (fused level and
        # fpset only), from the configured schedule — an earlier run's
        # adjustments never leak into this one
        self.fps_dense, self.fps_stages = self._fps_base
        self._adapt_cap, self._tune_n, self._cap_asked = None, 0, 1
        self._tuner = (
            tune_online.OnlineController(self.RMAX, self.fps_dense,
                                         self.fps_stages)
            if self.adapt and self.fuse == "level" and not self.sorted
            else None)
        self._budget_overridden = False
        self._lv_active = False
        self._rows_ok = True
        self._row_base = self._log_base = self._level_base = 0
        if self.tiered:
            self._tcap_max, self._wcap_max = self.TCAP_MAX, self.WCAP_MAX
            self._epoch, self._hot_n, self._spill_syncs = 1, 0, 0
            self._spill_active = False
        if resume:
            if seed is not None:
                raise ValueError("resume and seed are mutually exclusive")
            if not self.checkpoint_path:
                raise ValueError("resume requires checkpoint_path")
            t = time.perf_counter()
            level_sizes, level_base, nf, wall = self._restore_frame()
            self._restore_s = time.perf_counter() - t
            t0 = time.time() - wall
            self.rec.arm()  # the frame on disk is valid
            metrics.rewind(self.metrics_path, len(level_sizes))
            self._emit_header(resume=True)
        elif seed is not None:
            self._emit_header(resume=False)
            if "oom" in faults.poll("level", 1):
                raise faults.oom_error("level", 1)
            self._alloc()
            self._nv, self._dead = 0, BIG
            self._viol = [BIG] * len(self.invariant_names)
            if self.tiered:
                self._mk_tstore()
                self.tstore.wipe()
            level_sizes = self._load_seed(seed)
            level_base, nf = self._nv - level_sizes[-1], level_sizes[-1]
            # the anchor record: the seed's levels, nothing expanded yet
            self._emit_metrics(t0, len(level_sizes), 0, self._nv, nf,
                               partial=True)
            fv = self._first_viol()
            if fv is not None:
                # a violation inside the seed: the diameter is its level
                cum = 0
                for li, cnt in enumerate(level_sizes):
                    cum += cnt
                    if fv[1] < cum:
                        level_sizes = level_sizes[: li + 1]
                        break
            self._log(f"seed: {self._nv} states in {len(level_sizes)} "
                      "levels")
        else:
            self._emit_header(resume=False)
            # level 1's fault site (the loop's count starts at 2)
            if "oom" in faults.poll("level", 1):
                raise faults.oom_error("level", 1)
            n_init = self.model.n_initial
            if n_init > self.SCAP:
                raise ValueError("initial-state set exceeds max_states")
            if self.frontier and n_init + self.NQ > self.LCAP:
                raise ValueError(
                    f"initial level ({n_init} states) exceeds the "
                    "frontier rows window; raise row_cap_states"
                )
            self._alloc()
            self._nv, self._dead = 0, BIG
            self._viol = [BIG] * len(self.invariant_names)
            if self.tiered:
                self._mk_tstore()
                self.tstore.wipe()  # a fresh run owns its spill dir
            if self.fuse == "level" and not self.tiered:
                self._lv_begin()
                self._lv_init()
            else:
                self._stage_init()
            level_sizes = [self._nv]
            level_base, nf = 0, self._nv
            self._log(f"level 1: {self._nv} initial states")
        self._wall_t0 = t0
        return self._run_recoverable(t0, level_sizes, level_base, nf)

    def _run_recoverable(self, t0, level_sizes, level_base, nf):
        """The level loop under the recovery contract: device memory
        running out with a valid frame on disk frees the run's tensors,
        rebuilds from the frame and goes on at degraded capacity; when
        the rebuild itself runs out, the run stops with ``hbm``."""
        while True:
            try:
                return self._level_loop(t0, level_sizes, level_base, nf)
            except recovery.HbmExhausted as hx:
                last = (hx.nv, hx.level_sizes, hx.msg)
                hx.__context__ = None
            # outside the except block: its traceback pins the loop's
            # tensors
            self.rec.degrade()
            self.tel.emit("hbm_recovery",
                          recovery_n=self.rec.hbm_recovered,
                          group=self.group, distinct_states=last[0],
                          error=last[2][:200])
            self._log(
                "device memory exhausted: recovering from the last "
                f"checkpoint frame (recovery #{self.rec.hbm_recovered}) — "
                f"{last[2][:120]}"
            )
            self._free_buffers()
            t = time.perf_counter()
            try:
                level_sizes, level_base, nf, _w = self._restore_frame()
                self._restore_s = time.perf_counter() - t
            except Exception as e:  # noqa: BLE001
                if not recovery.is_resource_exhausted(e):
                    raise
                self._bufs_poisoned = True
                self._nv = last[0]
                return self._result(t0, last[1], truncated=True,
                                    stop_reason="hbm")

    def _boundary_stop(self, level_sizes, level_base: int,
                       nf: int) -> Optional[str]:
        """The stops checked at a level boundary before the next level:
        a degraded spill tier, a preemption request (after its frame),
        the daemon's suspend hook, and a frontier window that lost rows
        of the level to expand.  The hook runs on the host between
        levels and reads nothing from the device."""
        if self.tstore is not None and self.tstore.durable:
            self.tstore.flush()
        if self.tstore is not None and self.tstore.degraded:
            return "spill_enospc"
        if self._watcher is not None and self._watcher.requested:
            # a refused frame (rows lost) falls through to the honest
            # row_window stop below
            if self._save_frame(level_sizes, level_base, nf) \
                    or self._rows_ok:
                return "preempted"
        elif self.suspend_hook is not None:
            why = self.suspend_hook()
            if why == "cancelled":
                return "cancelled"
            # a suspend without its frame would lose the work: a refused
            # frame keeps the run going
            if why and self._save_frame(level_sizes, level_base, nf):
                return str(why)
        if self.frontier:
            if not self._rows_ok:
                return "row_window"
            self._slide_rows(level_base, nf)
        return None

    def _slide_rows(self, level_base: int, nf: int) -> None:
        """Frontier mode: move the frontier's rows to offset 0 of the
        window, dropping older ones (in chunks no longer than the gap,
        so no copy overlaps itself)."""
        gap = level_base - self._row_base
        if gap <= 0:
            return
        r = self._rows
        if nf > 256 * gap:
            r[:nf] = r[gap: gap + nf].clone()
        else:
            for a in range(0, nf, gap):
                b = min(a + gap, nf)
                r[a:b] = r[a + gap: b + gap]
        self._row_base = level_base

    def _level_loop(self, t0, level_sizes, level_base, nf):
        """BFS levels from a level boundary (after init or a restore)."""
        while True:
            reason = self._stop_reason()
            if reason is not None and not (reason.get("truncated")
                                           and nf == 0):
                if reason.get("truncated"):
                    # a budget stop leaves a resumable frame
                    self._save_frame(level_sizes, level_base, nf)
                return self._result(t0, level_sizes, **reason)
            if nf == 0:
                if self.final_frame:
                    # the search is complete: this frame (empty
                    # frontier) is the warm-reseed artifact
                    self._save_frame(level_sizes, level_base, 0)
                return self._result(t0, level_sizes)
            why = self._boundary_stop(level_sizes, level_base, nf)
            if why is not None:
                return self._result(t0, level_sizes, truncated=True,
                                    stop_reason=why)
            before = list(level_sizes)
            level = len(level_sizes) + 1
            self._xprof_tick(level)
            try:
                # the fault sites: kill/sigterm fire inside poll; an
                # injected oom takes the path of a real allocator failure
                if "oom" in faults.poll("level", level):
                    raise faults.oom_error("level", level)
                out = 0
                if self.fuse == "level" and not (
                    self.tiered and self._tiered_pressure()
                ):
                    fl0, wk0 = self._fpm_host[0], list(self._wkm_host)
                    self._stage_open()
                    out = self._lv_pass(len(level_sizes), level_base, nf)
                    self._emit_fuse(out, nf, fl0, wk0)
                    if self._tuner is not None and not isinstance(out, int):
                        self._observe_tune(out)
                if isinstance(out, int):
                    # the stage loop's level, or the rest of a fused one
                    # from the window the capped tiers could not take
                    if self.tiered and self._handoff is None:
                        self._handoff = (level, self._fuse_levels)
                    out = self._stage_level(level_base, nf, start=out)
                sizes, lb2, nf2, done = out
                prev_nf = nf
                for k, sz in enumerate(sizes):
                    if done and not sz:
                        continue  # a level that adds nothing ends it
                    site = len(level_sizes) + 1
                    # the later levels of a ramp batch: their sites fire
                    # as the batch's sizes are taken in
                    if k and "oom" in faults.poll("level", site):
                        raise faults.oom_error("level", site)
                    level_sizes.append(sz)
                    self._log_level(t0, level_sizes)
                    self._emit_metrics(t0, len(level_sizes), sz,
                                       sum(level_sizes), prev_nf)
                    prev_nf = sz
                if done and self.tiered and nf2:
                    self._tiered_boundary(lb2)
                if done and self.tiered:
                    self._emit_spill(len(level_sizes))
            except Exception as e:  # noqa: BLE001
                if not recovery.is_resource_exhausted(e):
                    raise
                if self.rec.can_recover():
                    raise recovery.HbmExhausted(
                        self._nv, list(level_sizes), repr(e)
                    ) from None
                # no frame to rebuild from: report what was checked
                self._log(f"device memory exhausted mid-level: truncating "
                          f"({e!r:.120})")
                self._bufs_poisoned = True
                self._read_after_oom(level_sizes)
                done, lb2, nf2 = False, level_base, nf
            if not done:
                reason = self._stop_reason() or {
                    "truncated": True, "stop_reason": "hbm"}
                if reason.get("truncated"):
                    # rewind to the level boundary: the partial level
                    # re-derives on resume by dedup idempotence
                    self._save_frame(before, lb2, nf2)
                return self._result(t0, level_sizes, **reason)
            level_base, nf = lb2, nf2
            if (self.checkpoint_path and nf
                    and len(level_sizes) % self.checkpoint_every == 0):
                self._save_frame(level_sizes, level_base, nf)

    def _fold_wkm(self) -> None:
        """Move the work vector's last-read totals into the host's."""
        for k, v in zip(WKM_KEYS, self._wkm_host):
            if v:
                self._work_add(**{k: v})
        self._wkm_host = [0] * fpset.WKM_N

    def _emit_fuse(self, out, nf: int, fl0: int, wk0: List[int]) -> None:
        """One ``fuse`` record a fused pass (``_lv_pass``): the levels it
        closed, its flushes and its work-unit deltas, all from the read
        that ended it."""
        self._fused_n += 1
        self._stage_mark("fused")
        if not self.tel.enabled:
            return
        levels = len(out[0]) if not isinstance(out, int) and out[3] else 0
        wd = [a - b for a, b in zip(self._wkm_host, wk0)]
        self.tel.emit(
            "fuse",
            levels=levels,
            dispatches=1,
            flushes=self._fpm_host[0] - fl0,
            frontier=int(nf),
            work_expand_rows=wd[0],
            work_probe_lanes=wd[1],
            work_compact_elems=wd[2],
            work_append_rows=wd[3],
        )

    def _observe_tune(self, out) -> None:
        """Feed the online controller one fused pass — the levels it
        closed against the cap it was given and the running maximum of
        the probe rounds, all from the read that ended the pass — and
        apply its adjustments before the next pass."""
        for adj in self._tuner.observe(
            levels_closed=len(out[0]),
            cap_asked=self._cap_asked,
            max_probe_rounds=self._fpm_host[4],
        ):
            self._apply_tune(adj)

    def _apply_tune(self, adj: Dict) -> None:
        """Apply one controller adjustment at a pass boundary and write
        its ``tune`` record: ``fuse_cap`` caps the ramp's levels a pass;
        ``fpset_dense_rounds`` sets the next flushes' K1 height
        (``max(TILE_R, dense)``, a runtime argument of the kernel)."""
        knob, new = adj["knob"], adj["to"]
        if knob == "fuse_cap":
            self._adapt_cap = int(new)
        else:
            self.fps_dense = int(new)
        self._tune_n += 1
        self.tel.emit("tune", knob=knob, value=new, prev=adj.get("from"),
                      reason=adj.get("reason"))

    def _read_after_oom(self, level_sizes) -> None:
        """After device memory ran out with no frame: read the fused
        level's exact counters if that still works, and count the
        partial level."""
        if self._lv_active:
            try:
                self._lv_read()
            except Exception:  # noqa: BLE001 — keep the last counts
                pass
        partial = self._nv - sum(level_sizes)
        if partial > 0:
            level_sizes.append(partial)

    def _emit_metrics(self, t0, level: int, new_states: int, nv: int,
                      frontier: int, partial: bool = False) -> None:
        """One ``level`` telemetry record and one ``metrics_path`` record
        (the JAX engine's keys): ``frontier`` is the frontier expanded
        into the level, ``host_wait_s`` the time the host spent blocked
        in reads; ``partial`` marks an anchor that is not a level
        boundary (the seed's)."""
        wall = time.time() - t0
        self._snap.update(level=level, frontier=int(frontier),
                          distinct_states=int(nv), partial=partial)
        self.tel.emit(
            "level",
            **({"partial": True} if partial else {}),
            level=level,
            new_states=int(new_states),
            distinct_states=int(nv),
            frontier=int(frontier),
            wall_s=round(wall, 3),
            states_per_sec=round(nv / max(wall, 1e-9), 1),
            host_wait_s=round(self._host_wait_s, 3),
        )
        metrics.append(self.metrics_path, {
            "level": level,
            "new_states": int(new_states),
            "distinct_states": int(nv),
            "frontier": int(frontier),
            "wall_s": round(wall, 3),
            "host_wait_s": round(self._host_wait_s, 3),
            "states_per_sec": round(nv / max(wall, 1e-9), 1),
            "visited_cap": self._visited_cap(),
        })

    # ------------------------------------------------ host-seeded starts

    def prestage_seed(self, seed) -> None:
        """Copy a seed's rows and logs to the device ahead of
        :meth:`run` (e.g. while the host does other work); ``run(seed=
        ...)`` takes them if the seed is the same one."""
        rows, parents, lanes, lsizes = seed
        rows = np.ascontiguousarray(rows, np.uint32).reshape(-1, self.W)
        dev = self.device
        self._seed_staged = (
            self._seed_token(rows, parents, lsizes),
            torch.from_numpy(rows.view(np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(parents, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(lanes, np.int32)).to(dev),
        )

    @staticmethod
    def _seed_token(rows, parents, lsizes):
        """A cheap identity of a seed (its count, level sizes and sampled
        sums), so a prestaged seed is never taken for another one."""
        n = len(rows)
        step = max(1, n // 64)
        return (
            n,
            tuple(int(x) for x in lsizes),
            int(np.asarray(rows[::step], np.uint64).sum()),
            int(np.asarray(parents[::step], np.int64).sum()),
        )

    def _load_seed(self, seed) -> List[int]:
        """Load a host-enumerated BFS prefix: packed states in gid order
        with parent gids (roots ``-1 - init_idx``) and action lanes, and
        the level sizes; the caller guarantees distinct, level-complete,
        deadlock-free states.  Rows and logs are written at gids ``[0,
        n)``; the keys go into the visited set in chunks (K2, then K1 +
        H1 on the card; the sort-merge set in ``seed_cap``-sized
        columns), and the invariants run on the seed's states.  Returns
        the level sizes."""
        rows, parents, lanes, lsizes = seed
        rows = np.ascontiguousarray(rows, np.uint32).reshape(-1, self.W)
        lsizes = [int(x) for x in lsizes]
        n = rows.shape[0]
        if sum(lsizes) != n:
            raise ValueError("seed level sizes do not sum to the state count")
        if n > self.SCAP or (self.sorted and n > self.SEED_VCAP // 2):
            raise ValueError(f"seed too large ({n} states)")
        if self.frontier and n + self.SEED_CHUNK > self.LCAP:
            raise ValueError(
                f"seed ({n} states) exceeds the frontier rows window "
                f"({self.LCAP}); raise row_cap_states")
        if self.tiered and (n + self.SEED_CHUNK > self._wcap_max
                            or n + self.NQ > self._tcap_max // 2):
            # the seed loads before any spill boundary: honor it past
            # the budget (the table too: every seed key is hot)
            self._wcap_max = max(self._wcap_max, n + self.SEED_CHUNK)
            while self._tcap_max // 2 < n + self.NQ:
                self._tcap_max *= 2
            if not self._budget_overridden:
                self._budget_overridden = True
                self._log("WARNING: hbm_budget too small for the seed — "
                          "growing past the budget")
        if self.frontier and lsizes and lsizes[-1] + self.NQ > self.LCAP:
            # the seeded frontier must leave one append window free, or
            # the first flush's blind append overwrites live frontier rows
            raise ValueError(
                f"seed frontier ({lsizes[-1]} states) exceeds the "
                f"frontier rows window ({self.LCAP} rows, {self.NQ} "
                "reserved for the append); raise row_cap_states")
        dev = self.device
        if self.sorted:
            vk = self._sorted_cols(self.SEED_VCAP)
        else:
            self._ensure_table(n + self.NQ,
                               self._tcap_max if self.tiered else None)
        self._ensure_store(n + self.SEED_CHUNK)
        staged = self._seed_staged
        if staged is None or staged[0] != self._seed_token(rows, parents,
                                                           lsizes):
            self.prestage_seed(seed)
            staged = self._seed_staged
        self._seed_staged = None
        _, rows_d, par_d, lan_d = staged
        self._rows[:n] = rows_d
        self._parent[:n] = par_d
        self._lane[:n] = lan_d
        n_inv = len(self.invariant_names)
        nvis = torch.zeros((), dtype=torch.int64, device=dev)
        viol = torch.full((n_inv,), BIG, dtype=torch.int64, device=dev)
        off = 0
        for count in lsizes:
            for c0 in range(0, count, self.SEED_CHUNK):
                cn = min(self.SEED_CHUNK, count - c0)
                s0 = off + c0
                chunk = rows_d[s0: s0 + cn]
                if chunk.data_ptr() % 16:
                    chunk = chunk.clone()  # K2 bulk-copies aligned tiles
                kc = tiles.key_plane(
                    self.keys, chunk,
                    torch.ones((cn,), dtype=torch.bool, device=dev))
                if self.sorted:
                    vk, nn, _new = merge_lanes(vk, kc, cn)
                else:
                    self._tcols, nn, _new, self._fpm = tiles.flush_tiles(
                        self._tcols, kc, cn, self._fpm, self._claims,
                        self.fps_dense, self.fps_stages)
                nvis = nvis + nn
                if n_inv:
                    states = self.layout.unpack(chunk)
                    pos = torch.arange(cn, device=dev)
                    bad = torch.stack([
                        torch.where(self.model.invariants[name](states),
                                    BIG, pos).amin()
                        for name in self.invariant_names])
                    viol = torch.minimum(
                        viol, torch.where(bad < BIG, s0 + bad, BIG))
            off += count
        vals = self._read(self._fpm, self._rehash_failed, nvis, viol)
        fpm, vs = vals[: fpset.FPM_N], vals[fpset.FPM_N + 2:]
        rehash, got = vals[fpset.FPM_N], vals[fpset.FPM_N + 1]
        probe = fpm[2]
        if probe:
            raise RuntimeError("fpset probe overflow while loading the "
                               "seed — raise visited_cap")
        self._check_overflow(0, rehash)
        if got != n:
            raise ValueError(
                f"seed states are not all distinct ({got} of {n} unique)")
        if self.sorted:
            # the seed's sorted columns, padded to the main set's size
            cap = _pow2_at_least(max(n + self.NQ, self.SEED_VCAP),
                                 self.TCAP0 // 2)
            self._tcols = tuple(
                torch.cat([c, p]) for c, p in zip(
                    vk, self._sorted_cols(cap - self.SEED_VCAP)))
        self._nv = n
        self._viol = vs
        self._took_fpm(fpm)
        self._work_add(append_rows=n)
        if self.tiered:
            self._hot_n = n
        return lsizes

    def _log_level(self, t0, level_sizes) -> None:
        cum = sum(level_sizes)
        wall = time.time() - t0
        self._log(f"level {len(level_sizes)}: +{level_sizes[-1]} (total "
                  f"{cum}, {cum / max(wall, 1e-9):.0f} st/s)")

    # -------------------------------------------------- checkpoint/resume

    def _config_sig(self) -> str:
        """What a frame must agree on to resume here: the model, the
        invariants, the key geometry, the row policy and the engine
        revision.  Capacities live in the frame's arrays: a resumed run
        may raise ``max_states`` or ``row_cap_states``."""
        return ckpt.config_sig(
            model=ckpt.model_sig(self.model),
            invariants=self.invariant_names,
            check_deadlock=self.check_deadlock,
            state_bits=self.layout.total_bits,
            key_cols=self.K,
            key_exact=self.keys.exact,
            rows_window=self.rows_window,
            engine=ENGINE_SIG,
            **({"tiered": True} if self.tiered else {}),
            **({"visited": "sort"} if self.sorted else {}),
        )

    def _save_frame(self, level_sizes, level_base: int, nf: int) -> bool:
        """Write one resumable frame ("``nv`` states found, about to
        expand the frontier ``[level_base, level_base + nf)``"); True if
        written.  The rows saved span ``[lo, nv)``: all of them, the
        window from the frontier in frontier mode, the device window in
        tiered mode (the older ones are in the cold tiers its manifest
        describes)."""
        if not self.checkpoint_path:
            return False
        if self._bufs_poisoned or not self._rows_ok:
            return False  # keep the older, valid frame
        if self.tstore is not None and self.tstore.degraded:
            return False  # its manifest would name unwritten files
        t_stall = time.perf_counter()
        try:
            arrays = self._frame_arrays(level_sizes, level_base, nf)
        except Exception as e:  # noqa: BLE001
            if not recovery.is_resource_exhausted(e):
                raise
            # no room on the device to gather the frame: keep the older
            # one (a recovery would rebuild from it)
            self._log(f"checkpoint skipped: device memory exhausted "
                      f"({e!r:.80})")
            return False
        if arrays is None:
            return False  # the manifest's join just latched ENOSPC
        self._ckpt_last_d2h = time.perf_counter() - t_stall
        nv = self._nv
        nbytes, write_s, retries = ckpt.save_frame(
            self.checkpoint_path, self._config_sig(), arrays,
            wall_s=time.time() - self._wall_t0,
            meta={"frame_seq": self._ckpt_frames + 1,
                  "level": len(level_sizes), "engine": "device_bfs",
                  "run_id": self._run_id},
        )
        stall = time.perf_counter() - t_stall
        self._ckpt_frames += 1
        self._ckpt_bytes += nbytes
        self._ckpt_write_s += stall
        self._ckpt_last_s = stall
        self._ckpt_retries += retries
        self.rec.arm()
        self.tel.emit(
            "ckpt_frame",
            frame_seq=self._ckpt_frames,
            bytes=nbytes,
            write_s=round(write_s, 3),
            stall_s=round(stall, 3),
            retries=retries,
            level=len(level_sizes),
            distinct_states=nv,
        )
        self._log(f"checkpoint: level {len(level_sizes)}, {nv} states "
                  f"({nbytes >> 10} KiB, {stall:.2f}s stall) -> "
                  f"{self.checkpoint_path}")
        return True

    def _frame_arrays(self, level_sizes, level_base: int, nf: int):
        """A frame's arrays gathered from the device; None when the
        durable store turns out degraded at the manifest's join."""
        nv = self._nv
        lo = (self._row_base if self.tiered
              else level_base if self.frontier else 0)
        arrays = {
            "n_visited": np.int64(nv),
            "level_sizes": np.asarray(level_sizes, np.int64),
            "lb": np.int64(level_base),
            "nf": np.int64(nf),
            "rows_lo": np.int64(lo),
            "hbm_recovered": np.int64(self.rec.hbm_recovered),
            "fpm": _host(self._fpm),
            "parent": _host(self._parent[: nv - self._log_base]),
            "lane": _host(self._lane[: nv - self._log_base]),
            "rows": _host(self._rows[lo - self._row_base:
                                     nv - self._row_base]
                          ).view(np.uint32).reshape(-1),
        }
        if self.sorted:
            # the sorted columns' first nv entries are the keys
            for i, c in enumerate(self._tcols):
                arrays[f"vk{i}"] = _host(c[:nv]).view(np.uint32)
        else:
            arrays.update(ckpt.pack_table(self._tcols))
        if self.tiered:
            try:
                man = self.tstore.manifest()
            except ValueError:
                return None
            arrays["spill_manifest"] = np.frombuffer(
                json.dumps(man).encode(), dtype=np.uint8)
            arrays["spill_hot_n"] = np.int64(self._hot_n)
            arrays["spill_epoch"] = np.int64(self._epoch)
        return arrays

    def _restore_frame(self):
        """Rebuild the run's tensors and level frame from the frame;
        returns ``(level_sizes, level_base, nf, wall_s)``."""
        d = ckpt.load_frame(self.checkpoint_path, self._config_sig())
        self._resume_meta = ckpt.frame_meta(d)
        dev, K, W = self.device, self.K, self.W
        nv = int(d["n_visited"])
        level_sizes = [int(x) for x in d["level_sizes"]]
        level_base, nf, lo = int(d["lb"]), int(d["nf"]), int(d["rows_lo"])
        if nv > self.SCAP:
            raise ValueError(
                f"checkpoint holds {nv} states — beyond max_states "
                f"({self.SCAP}); raise max_states to resume it"
            )
        if self.sorted:
            cap = _pow2_at_least(nv + self.NQ, self.TCAP0 // 2)
            self._tcols = self._sorted_cols(cap)
            for i, c in enumerate(self._tcols):
                c[:nv] = torch.from_numpy(
                    np.asarray(d[f"vk{i}"], np.uint32).view(np.int32)
                    .copy()).to(dev)
            self._claims = None
        else:
            cap = int(d["fp_tcap"])
            self._tcols = fpset.empty_cols(cap, K, dev)
            ckpt.restore_table(d, self._tcols)
            self._claims = fpset.new_claims(cap, dev)
        self._rehash_failed = torch.zeros((), dtype=torch.int64, device=dev)
        fpm = np.zeros((fpset.FPM_N,), np.int64)
        old = np.asarray(d["fpm"], np.int64).reshape(-1)
        fpm[: min(len(old), fpset.FPM_N)] = old[: fpset.FPM_N]
        self._fpm = torch.from_numpy(fpm).to(dev)
        self._fpm_host = self._fpm_prev = [int(x) for x in fpm]
        # the work vector restarts from the frame (after a recovery, the
        # work read before it stays counted)
        self._fold_wkm()
        self._wkm = torch.zeros((fpset.WKM_N,), dtype=torch.int64,
                                device=dev)
        self._wkm_host = [0] * fpset.WKM_N
        rows = torch.from_numpy(
            np.asarray(d["rows"], np.uint32).view(np.int32).reshape(-1, W)
        ).to(dev)
        par = torch.from_numpy(np.asarray(d["parent"], np.int32)).to(dev)
        lan = torch.from_numpy(np.asarray(d["lane"], np.int32)).to(dev)
        n_rows = nv - lo
        log_lo = lo if self.tiered else 0
        if self.frontier:
            if n_rows + self.NQ > self.LCAP:
                raise ValueError(
                    f"checkpoint frontier ({n_rows} rows) exceeds the "
                    f"frontier rows window ({self.LCAP}); raise "
                    "row_cap_states"
                )
            rcap = self.LCAP
            lcap = _pow2_at_least(nv + self.NQ, self.WCAP0)
        else:
            rcap = lcap = _pow2_at_least(n_rows + self.NQ, self.WCAP0)
        self._rows = torch.zeros((rcap, W), dtype=torch.int32, device=dev)
        self._rows[:n_rows] = rows
        self._parent = torch.zeros((lcap,), dtype=torch.int32, device=dev)
        self._lane = torch.zeros((lcap,), dtype=torch.int32, device=dev)
        self._parent[: nv - log_lo] = par
        self._lane[: nv - log_lo] = lan
        self._row_base, self._log_base = lo, log_lo
        self._nv, self._dead = nv, BIG
        self._viol = [BIG] * len(self.invariant_names)
        self._rows_ok = True
        self._lv_active = False
        if self.tiered:
            if "spill_manifest" not in d:
                raise ValueError(
                    "tiered resume needs a spill manifest in the frame — "
                    "this frame was written untiered"
                )
            self._mk_tstore()
            self.tstore.restore(
                json.loads(d["spill_manifest"].tobytes().decode()))
            self._hot_n = int(d["spill_hot_n"])
            self._epoch = 2
            self._spill_active = bool(self.tstore.has_cold_keys
                                      or self.tstore.rows_spilled_hi)
            self._gen = sieve.tag_generation(
                self._tcols, torch.zeros((cap + 1,), dtype=torch.int32,
                                         device=dev), 1)
        self.rec.hbm_recovered = max(self.rec.hbm_recovered,
                                     int(d["hbm_recovered"]))
        self._log(f"resumed at level {len(level_sizes)}: {nv} states, "
                  f"frontier {nf}")
        return level_sizes, level_base, nf, float(d["wall_s"])

    # ------------------------------------------------------------ result

    def _result(
        self, t0, level_sizes, viol=None, dead_gid=None, truncated=False,
        stop_reason=None,
    ) -> CheckerResult:
        nv = self._nv
        live = self._tcols is not None
        self.last_bufs = ({
            "rows": self._rows.reshape(-1),
            "parent": self._parent,
            "lane": self._lane,
        } if live else {})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        tcap = (self._tcols[0].shape[0] - (0 if self.sorted else 1)
                if live else 0)
        if live:
            # one read at the end: the flush metrics and the work vector
            got = torch.cat([self._fpm, self._wkm]).tolist()
            fpm, self._wkm_host = got[: fpset.FPM_N], got[fpset.FPM_N:]
        else:
            fpm = [0] * fpset.FPM_N
        fl, rounds, fails, valid_lanes, max_rounds = fpm
        work = dict(self._work)
        for k, v in zip(WKM_KEYS, self._wkm_host):
            work[k] = work.get(k, 0) + v
        self.last_stats = dict(
            host_syncs=self._host_syncs,
            stats_fetches=self._host_syncs,
            fuse=self.fuse,
            fuse_levels=self._fuse_levels,
            stage_fused_n=self._fused_n,
            syncs_per_level=round(
                self._host_syncs / max(len(level_sizes), 1), 2
            ),
            compact_impl=self.compact_impl,
            fpset_flushes=fl,
            fpset_probe_rounds=rounds,
            fpset_failures=fails,
            fpset_valid_lanes=valid_lanes,
            fpset_max_probe_rounds=max_rounds,
            fpset_table_cap=tcap,
            fpset_occupancy=nv / max(tcap, 1),
            hbm_recovered=self.rec.hbm_recovered,
        )
        if self.checkpoint_path:
            self.last_stats.update(
                ckpt_frames=self._ckpt_frames,
                ckpt_bytes=self._ckpt_bytes,
                ckpt_write_s=round(self._ckpt_write_s, 3),
                ckpt_last_stall_s=round(self._ckpt_last_s, 3),
                ckpt_last_d2h_s=round(self._ckpt_last_d2h, 3),
                ckpt_retries=self._ckpt_retries,
                restore_s=round(self._restore_s, 3),
            )
        if self.tiered:
            # the run is over: join the encodes so the byte counts are
            # final, and release the worker (the tiers stay readable)
            self.tstore.close()
            sp = self.tstore.stats
            self.last_stats.update(
                hbm_budget=self.hbm_budget,
                spill_evictions=int(sp.evictions),
                spill_keys_evicted=int(sp.keys_evicted),
                spill_rows_evicted=int(sp.rows_evicted),
                spill_bytes_raw=int(sp.bytes_raw),
                spill_bytes_comp=int(sp.bytes_comp),
                spill_transfer_s=round(sp.transfer_s, 3),
                spill_misses_resolved=int(sp.misses_resolved),
                spill_miss_hits=int(sp.miss_hits),
                spill_syncs=int(self._spill_syncs),
                spill_hot_keys=int(self._hot_n),
                spill_overlap_ratio=sp.overlap_ratio,
                spill_bytes_per_state=round(sp.bytes_comp / max(nv, 1), 2),
                spill_degraded=bool(self.tstore.degraded),
                spill_durable=bool(self.tstore.durable),
                handoff_level=self._handoff and self._handoff[0],
                fused_levels_before_handoff=(
                    self._handoff[1] if self._handoff else self._fuse_levels
                ),
            )
            self._emit_spill(len(level_sizes))
        if self._tuner is not None:
            self.last_stats["tune_adjustments"] = self._tune_n
        self.last_stats.update(self._stages)
        self.last_stats["dispatches_per_level"] = round(
            sum(v for k, v in self._stages.items() if k.endswith("_n"))
            / max(len(level_sizes), 1), 2)
        if self._rtt_s is not None:
            self.last_stats["rtt_s"] = self._rtt_s
        self.last_stats.update(
            {f"work_{k}": int(v) for k, v in work.items() if v})
        res = CheckerResult(
            distinct_states=nv,
            diameter=len(level_sizes),
            deadlock=dead_gid is not None,
            wall_s=wall,
            states_per_sec=nv / max(wall, 1e-9),
            level_sizes=list(level_sizes),
            truncated=truncated,
            stop_reason=stop_reason if truncated else None,
            hbm_recovered=self.rec.hbm_recovered,
            fp_collision_prob=self.keys.collision_prob(nv),
        )
        gid = None
        if viol is not None:
            res.violation, gid = viol
        elif dead_gid is not None:
            res.violation, gid = "Deadlock", dead_gid
        if gid is not None and live:
            res.violation_gid = gid
            res.trace, res.trace_actions = build_trace(
                self.model, *self.merged_logs(), gid,
                len(level_sizes) + 2 + int(self.extra_trace_depth),
            )
        elif gid is not None:
            res.violation_gid = gid
        emit_result(self.tel, res, self.last_stats)
        return res
