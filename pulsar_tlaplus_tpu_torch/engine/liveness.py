"""Liveness checking: ``<>goal`` properties over the reachable state
graph, e.g. ``Termination`` (compaction.tla:303-307) — the counterpart of
``pulsar_tlaplus_tpu/engine/liveness.py`` (``LivenessResult``,
``LivenessChecker``).

The device builds the behavior graph, the host analyses it:

- **explore**: one exhaustive BFS on the port's ``DeviceChecker`` (no
  invariants, no deadlock check); every packed row stays on the device
  in gid order (a tiered run streams its cold rows back and appends the
  device window).  The explorer's table and logs are then freed.
- **table**: the keys of all ``n`` rows (``tiles.key_plane``: K2 on the
  card, from the KeySpec the explorer deduplicated with), sorted in
  unsigned lexicographic order with the gid as payload.
- **sweep**: per chunk of ``SF`` states, unpack -> ``successors`` ->
  pack -> key plane (K2) -> one merged sort of (table, query keys) in
  which table entries order before equal-key queries (the JAX engine's
  TAG payload bit: here stable sorts of the table, then the queries in
  lane order) -> the capped doubling-shift gid propagation through
  equal-key runs -> back to lane order (a scatter through the sort's
  permutation) -> ``dst = -2`` for a valid lane whose key missed -> the
  compaction of the valid non-stutter lanes.  ``G`` chunks share one
  host read of their kept counts and one of their kept prefixes.  Edges
  come out source-major, lanes in order within a source: the JAX order.
- **analysis** (host numpy, the JAX engine's code as it is): the not-
  goal restriction, reachability from the not-goal initial states,
  states with no var-changing successor, and Kahn peeling for cycles.

Semantics (the oracle's, ``ref/pyeval.check_eventually``):
``fairness="none"`` holds iff every initial state satisfies the goal
(otherwise: stutter forever at a violating initial state);
``fairness="wf_next"`` (``Spec /\\ WF_vars(Next)``) is violated iff some
not-goal path from an initial state reaches a not-goal state with no
var-changing successor, or a cycle of var-changing not-goal steps.

**Checkpoints** (``checkpoint_path``, the JAX engine's contract): the
exploration writes the inner checker's frames at that path every
``checkpoint_every`` levels; once the sweep runs, its chunk-boundary
frames (every ``checkpoint_every`` chunks) replace them, holding the
explored rows and the edges so far, so a resume needs no
re-exploration.  ``run(resume=True)`` continues from either kind.
SIGTERM/SIGINT in either phase ends the run resumably (``truncated``,
``stop_reason="preempted"``, no verdict); the ``sweep`` fault site
(``utils/faults.py``) counts chunks.

**Sharded exploration** (``n_devices > 1``; the JAX engine's): the BFS
runs on the port's ``ShardedDeviceChecker`` over a mesh of that many
shards (several may share a device), and the per-shard row prefixes
are concatenated into one dense gid space, every shard's level-1
segment first, then every shard's remainder, so the initial states are
gids ``[0, n_init)``; the sweep and the analysis then run on the first
shard's device.  ``hbm_budget`` needs the single-device explorer.

Telemetry is not ported.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
    ShardedDeviceChecker,
)
from pulsar_tlaplus_tpu_torch.obs import telemetry as obs
from pulsar_tlaplus_tpu_torch.ops import tiles
from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag, validate_impl
from pulsar_tlaplus_tpu_torch.ops.dedup import lex_order
from pulsar_tlaplus_tpu_torch.store import budget as store_budget
from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
from pulsar_tlaplus_tpu_torch.utils import ckpt, faults

# the sweep frame format's engine revision
ENGINE_SIG = "liveness_torch_r1"


@dataclass
class LivenessResult:
    holds: bool
    reason: str
    distinct_states: int
    # a lasso skeleton when violated (state gids)
    lasso_prefix: Optional[List[int]] = None
    lasso_cycle: Optional[List[int]] = None
    # expected key collisions at this state count (0.0 for exact keys):
    # a hashed-key collision could alias two states in the edge join
    fp_collision_prob: float = 0.0
    # an interrupted run carries no verdict (``holds`` means nothing
    # while ``truncated``); ``run(resume=True)`` continues it
    truncated: bool = False
    stop_reason: Optional[str] = None


class _Preempted(Exception):
    """A preemption request ended a phase after its frame."""

    def __init__(self, n: int, phase: str):
        super().__init__(phase)
        self.n = n
        self.phase = phase


def edge_digest(src, dst) -> str:
    """SHA-256 of an edge list: ``src`` then ``dst`` as int32
    little-endian, in the engine's order (``scripts/liveness_pins.py``
    states the JAX engine's the same way)."""
    h = hashlib.sha256()
    h.update(np.asarray(src, "<i4").tobytes())
    h.update(np.asarray(dst, "<i4").tobytes())
    return h.hexdigest()


class LivenessChecker:
    """Checks ``<>goal`` for a batched model's named goal predicate
    (``model.liveness_goals``) on one device (``cuda`` unless ``device``
    names another; raises when CUDA is wanted and absent).

    ``frontier_chunk`` rows form an exploration window (at least 256)
    and a goal-evaluation chunk; ``sweep_chunk`` states (rounded up to a
    multiple of it, default ``max(frontier_chunk, 2^14)``) form a sweep
    chunk of ``sweep_chunk * A`` successor lanes; ``sweep_group`` chunks
    share a host read (default: up to 8, while their lanes stay within
    2^22).  ``max_run`` caps the gid propagation's doubling shifts: a
    key with more than ``2p - 1`` equal-key queries in one chunk (``p``
    the largest power of two <= ``max_run``) fails loudly.
    ``hbm_budget`` runs the exploration tiered; ``n_devices > 1`` runs
    it on the mesh-sharded engine (``device`` names the shards' device or
    devices, as for ``ShardedDeviceChecker``).  ``checkpoint_path``
    and ``checkpoint_every`` (levels in the exploration, chunks in the
    sweep) write resumable frames.  ``compact_impl`` (``"logshift"`` or
    ``"sort"``, ``ops/compact.py``) is the exploration's and the
    sweep's stream compaction.  ``telemetry`` takes the run's JSONL
    stream (the exploration's records, then one cumulative ``sweep``
    record a chunk); ``heartbeat_s`` prints progress lines in both
    phases.  ``profile`` (as ``DeviceChecker``'s) resolves the
    ``"liveness"`` profile, which fills ``sweep_group`` and
    ``compact_impl`` when left at None; the explorer resolves its own
    ``"device_bfs"`` profile.
    """

    def __init__(
        self,
        model,
        goal: str = "Termination",
        fairness: str = "none",
        frontier_chunk: int = 2048,
        visited_cap: int = 1 << 14,
        max_states: int = 50_000_000,
        sweep_chunk: Optional[int] = None,
        sweep_group: Optional[int] = None,
        hbm_budget=None,
        spill_compress: Optional[bool] = None,
        max_run: int = 1 << 14,
        device=None,
        progress: bool = False,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 5,
        n_devices: int = 1,
        compact_impl: Optional[str] = None,
        profile=None,
        telemetry=None,
        heartbeat_s: Optional[float] = None,
    ):
        goals = getattr(model, "liveness_goals", {})
        if goal not in goals:
            raise ValueError(
                f"unknown liveness property: {goal} "
                f"(model defines: {sorted(goals) or 'none'})"
            )
        if fairness not in ("none", "wf_next"):
            raise ValueError(f"unknown fairness: {fairness}")
        if sweep_group is not None and sweep_group < 1:
            raise ValueError(f"sweep_group must be >= 1: {sweep_group}")
        if max_run < 1:
            raise ValueError(f"max_run must be positive: {max_run}")
        # the "liveness" profile (tune/profiles.py) fills the sweep knobs
        # left at None; the single-device explorer resolves its own
        # "device_bfs" profile (the sharded engine takes none).  The key
        # is goal-independent: sweep batching does not depend on the goal
        dev0 = device[0] if isinstance(device, (list, tuple)) else device
        prof = tune_profiles.resolve(
            profile, model=model, invariants=(), engine="liveness",
            backend=tune_profiles.default_backend(dev0))
        self.profile_sig = prof["sig"] if prof else None
        pk = tune_profiles.knobs_for(prof, "liveness")
        if sweep_group is None:
            sweep_group = pk.get("sweep_group")
        compact_impl = compact_impl or pk.get("compact_impl") or "logshift"
        self.model = model
        self.goal_name = goal
        self.goal_fn = goals[goal]
        self.fairness = fairness
        self.F = frontier_chunk
        self.SF = sweep_chunk or max(frontier_chunk, 1 << 14)
        self.SF = -(-self.SF // self.F) * self.F
        self.sweep_group = sweep_group
        self.max_run = max_run
        p = 1
        while p * 2 <= min(max_run, self.SF * model.A):
            p *= 2
        self._run_cover = 2 * p - 1
        self.progress = progress
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.n_devices = n_devices
        self.compact_impl = validate_impl(compact_impl)
        common = dict(
            compact_impl=compact_impl,
            invariants=(),
            check_deadlock=False,
            sub_batch=max(256, frontier_chunk),
            visited_cap=visited_cap,
            max_states=max_states,
            device=device,
            progress=progress,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
        )
        if n_devices > 1:
            if store_budget.resolve_budget(hbm_budget) is not None:
                raise ValueError(
                    "hbm_budget needs the single-device explorer (the "
                    "sharded engine has no tiered store yet)"
                )
            self._checker = ShardedDeviceChecker(
                model, n_devices=n_devices, **common)
        else:
            kw = {} if spill_compress is None else {
                "spill_compress": spill_compress}
            self._checker = DeviceChecker(
                model, hbm_budget=hbm_budget, profile=profile, **common,
                **kw)
        self.device = self._checker.device
        self.keys = self._checker.keys  # the explorer's KeySpec
        self.K = self.keys.ncols
        self._explored = None  # (n, n_init)
        self._rows: Optional[torch.Tensor] = None  # int32 [n, W]
        self._edge_cache = None  # (src, dst, out_deg): goal-independent
        self.last_stats: Dict[str, object] = {}
        self._resume_explore = False
        self._sweep_resume = None  # (src parts, dst parts, next chunk)
        self._watcher = None
        # telemetry: one stream a run; the explorer writes into it too,
        # with its own heartbeat, and the sweep's heartbeat reports from
        # ``_snap``, which the chunk loop updates
        self._telemetry_arg = telemetry
        self.heartbeat_s = heartbeat_s
        self.tel = obs.NULL
        self._run_id: Optional[str] = None
        self._snap: Dict[str, object] = {}
        self._reset_telemetry()

    def _reset_telemetry(self) -> None:
        """A run's telemetry state: the clock, the frame writer's resume
        meta and retries, the sweep's cumulative work units."""
        self._t0 = time.time()
        self._resume_meta: Dict[str, object] = {}
        self._ckpt_retries = 0
        self._work_sweep = {"sort_lanes": 0, "prop_lanes": 0,
                            "prop_passes": 0, "compact_elems": 0}
        self._hb = None

    def _log(self, msg: str) -> None:
        if self.progress:
            import sys

            print(f"  {msg}", file=sys.stderr, flush=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------ exploration

    def _explore(self):
        """One exhaustive BFS, cached so that several properties share
        it."""
        if self._explored is not None:
            return self._explored
        t0 = time.time()
        ck = self._checker
        # the explorer writes into this run's stream (it never closes a
        # Telemetry it was handed) with its own heartbeat
        ck._telemetry_arg = self.tel if self.tel.enabled else None
        if self.heartbeat_s and not ck.heartbeat_s:
            ck.heartbeat_s = self.heartbeat_s
        try:
            res = ck.run(resume=self._resume_explore)
        finally:
            self._resume_explore = False
            # the explorer's run cleared the fault observer on exit
            faults.set_observer(getattr(self, "_fault_observer", None))
        if res.truncated and res.stop_reason == "preempted":
            # the exploration wrote its own frame on the way out
            raise _Preempted(res.distinct_states, "explore")
        if res.truncated:
            why = res.stop_reason or "unknown"
            raise RuntimeError(
                "liveness exploration truncated before the state "
                f"space was exhausted (stop_reason={why}); "
                + (
                    "raise max_states"
                    if why == "max_states"
                    else "the verdict needs the full graph — rerun "
                    "with more memory/time or a smaller model"
                )
            )
        if res.violation is not None:
            raise RuntimeError(
                "exploration stopped early on a violation "
                f"({res.violation}); liveness requires the full state "
                "graph — fix the safety violation first"
            )
        n, W = res.distinct_states, ck.W
        if self.n_devices > 1:
            # the per-shard prefixes in one dense gid space: every
            # shard's level-1 segment, then every shard's remainder
            counts = ck.last_stats_matrix[:, 0]
            c1 = ck.last_level1_counts
            firsts = [ck._rows[s][: int(c1[s])] for s in range(ck.N)]
            rests = [ck._rows[s][int(c1[s]): int(counts[s])]
                     for s in range(ck.N)]
            rows = torch.cat([t.to(self.device) for t in firsts + rests])
        elif ck.tiered and ck._row_base > 0:
            # the aged rows live in the cold tiers: stream them back in
            # gid order, then the device window
            rows = torch.from_numpy(
                ck.merged_rows().view(np.int32).reshape(n, W)
            ).to(self.device)
        else:
            rows = ck._rows[:n]
        # the sweep reads only the rows: free the explorer's table, logs
        # and scratch before its join
        ck._free_buffers()
        self._rows = rows
        self._explored = (n, res.level_sizes[0])
        self._sync()
        self.last_stats.update(explore_s=time.time() - t0,
                               distinct_states=n, diameter=res.diameter)
        return self._explored

    def run_goal(self, goal: str) -> LivenessResult:
        """Check another named goal over the same explored state space."""
        goals = getattr(self.model, "liveness_goals", {})
        if goal not in goals:
            raise ValueError(f"unknown liveness property: {goal}")
        self.goal_name = goal
        self.goal_fn = goals[goal]
        return self.run()

    # ------------------------------------------------------ device work

    def _table(self, n: int):
        """The key->gid table: (K key columns, gid int64), sorted."""
        rows = self._rows
        kc = tiles.key_plane(
            self.keys, rows,
            torch.ones((n,), dtype=torch.bool, device=self.device),
        )
        order = lex_order(kc)
        return tuple(c[order] for c in kc), order

    def _goal(self, n: int) -> np.ndarray:
        """bool[n] goal-predicate values, in chunks of ``SF`` states."""
        unpack = self.model.layout.unpack
        parts = [
            self.goal_fn(unpack(self._rows[a: a + self.SF]))
            for a in range(0, n, self.SF)
        ]
        return torch.cat(parts).cpu().numpy()

    def _sweep_chunk(self, off: int, n: int, tcols, tgid):
        """The compacted ``<Next>_vars`` edges of states ``[off, off +
        SF)``: ``(n_kept 0-d, lane index [NQ], dst [NQ])``, of which
        the first ``n_kept`` entries are meaningful."""
        m, A = self.model, self.model.A
        rows = self._rows[off: off + self.SF]
        sf = rows.shape[0]
        nq = sf * A
        succ, valid = m.successors(m.layout.unpack(rows))
        vq = valid.reshape(nq)
        packed = m.layout.pack(succ).reshape(nq, m.layout.W)
        qcols = tiles.key_plane(self.keys, packed, vq)
        cols = [torch.cat([t, q]) for t, q in zip(tcols, qcols)]
        # table entries (sorted, stable in gid) come first, queries in
        # lane order: a stable sort puts each key's table entry before
        # its queries, and the queries in lane order
        order = lex_order(cols)
        scols = [c[order] for c in cols]
        gid = torch.cat([
            tgid, torch.full((nq,), -1, dtype=torch.int64,
                             device=self.device)
        ])[order]
        # equal-key runs as one int64 key (plus the third column)
        skey = [tiles._key64(scols[0], scols[1]), *scols[2:]]
        cap = min(self.SF * A, self.max_run)
        d = 1
        while d <= cap:
            same = skey[0][d:] == skey[0][:-d]
            for c in skey[1:]:
                same = same & (c[d:] == c[:-d])
            fill = (gid[d:] < 0) & same
            gid = torch.cat([gid[:d], torch.where(fill, gid[:-d], gid[d:])])
            d <<= 1
        back = torch.empty_like(gid)
        back[order] = gid
        dst = back[n:]
        dst = torch.where(vq, torch.where(dst < 0, -2, dst), -1)
        lane = torch.arange(nq, dtype=torch.int64, device=self.device)
        keep = (dst != -1) & (dst != off + lane // A)
        (idxc, dstc), _ = compact_by_flag(~keep, (lane, dst),
                                          self.compact_impl)
        return keep.sum(), idxc, dstc

    def _sweep_group_size(self) -> int:
        """Chunks a host read covers: the ctor's ``sweep_group``, else as
        many as keep ``G * SF * A`` within 2^22 lanes, at most 8."""
        if self.sweep_group is not None:
            return int(self.sweep_group)
        nq = self.SF * self.model.A
        return max(1, min(8, (1 << 22) // max(nq, 1)))

    def _edges(self, n: int):
        """The goal-independent ``<Next>_vars`` edge list as numpy int64
        ``(src, dst)``, and the out-degree of every state."""
        if self._edge_cache is not None:
            return self._edge_cache
        t0 = time.time()
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        A, SF = self.model.A, self.SF
        G = self._sweep_group_size()
        tcols, tgid = self._table(n)
        starts = list(range(0, n, SF))
        src_parts, dst_parts, c0 = [], [], 0
        if self._sweep_resume is not None:
            src_parts, dst_parts, c0 = self._sweep_resume
            self._sweep_resume = None
            self._log(f"resumed the sweep at chunk {c0}/{len(starts)}")
        reads = 0
        tlen = tcols[0].shape[0]
        passes, d = 0, 1
        while d <= min(SF * A, self.max_run):
            passes, d = passes + 1, d << 1
        n_edges = sum(len(p) for p in src_parts)
        for g0 in range(c0, len(starts), G):
            outs = [self._sweep_chunk(starts[i], n, tcols, tgid)
                    for i in range(g0, min(g0 + G, len(starts)))]
            kept = torch.stack([o[0] for o in outs]).tolist()
            reads += 1
            flat = np.zeros((2, 0), np.int64)
            if sum(kept):
                flat = torch.cat([
                    torch.stack([o[1][:k], o[2][:k]])
                    for o, k in zip(outs, kept)
                ], dim=1).cpu().numpy()
                reads += 1
            pos = 0
            for j, k in enumerate(kept):
                i = g0 + j
                # the chunk's fault site (kill/sigterm fire in poll; the
                # sweep has no degraded rebuild, so an oom is raised)
                if "oom" in faults.poll("sweep", i + 1):
                    raise faults.oom_error("sweep", i + 1)
                idx, dst = flat[0, pos: pos + k], flat[1, pos: pos + k]
                pos += k
                if (dst == -2).any():
                    raise RuntimeError(
                        "edge sweep could not resolve a successor gid: "
                        "either BFS exploration was incomplete, or one "
                        "state has more than "
                        f"{self._run_cover} equal-key predecessors inside "
                        "a single sweep chunk — shrink sweep_chunk or "
                        f"raise max_run (currently {self.max_run})"
                    )
                if k:
                    src_parts.append(starts[i] + idx // A)
                    dst_parts.append(dst)
                    n_edges += k
                # the chunk's work units (cumulative) and progress, from
                # values already read
                nq = (min(starts[i] + SF, n) - starts[i]) * A
                ws = self._work_sweep
                ws["sort_lanes"] += 2 * (tlen + nq)
                ws["prop_lanes"] += passes * (tlen + nq)
                ws["prop_passes"] += passes
                ws["compact_elems"] += nq
                self._snap.update(distinct_states=n, level=i + 1,
                                  generated=n_edges)
                self.tel.emit(
                    "sweep",
                    chunk=i + 1,
                    chunks=len(starts),
                    swept=min(starts[i] + SF, n),
                    edges=n_edges,
                    group=G,
                    wall_s=round(time.time() - self._t0, 3),
                    sort_lanes=ws["sort_lanes"],
                    prop_lanes=ws["prop_lanes"],
                    prop_passes=ws["prop_passes"],
                    compact_elems=ws["compact_elems"],
                )
                preempt = (self._watcher is not None
                           and self._watcher.requested)
                if self.checkpoint_path and i + 1 < len(starts) and (
                    preempt or (i + 1 - c0) % self.checkpoint_every == 0
                ):
                    self._save_sweep_frame(n, src_parts, dst_parts, i + 1)
                    if preempt:
                        raise _Preempted(n, "sweep")
        src = (np.concatenate(src_parts) if src_parts
               else np.zeros(0, np.int64))
        dst = (np.concatenate(dst_parts) if dst_parts
               else np.zeros(0, np.int64))
        out_deg = np.bincount(src, minlength=n).astype(np.int64)
        self._edge_cache = (src, dst, out_deg)
        sweep_s = time.time() - t0
        self._log(f"edge sweep: {len(src)} <Next>_vars edges of {n} states "
                  f"in {sweep_s:.2f}s ({len(starts)} chunks, {reads} host "
                  "reads)")
        self.last_stats.update(
            sweep_s=sweep_s,
            edges=len(src),
            sweep_chunks=len(starts),
            sweep_group=G,
            sweep_reads=reads,
            sweep_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        )
        return self._edge_cache

    # -------------------------------------------------------------- run

    def run(self, resume: bool = False) -> LivenessResult:
        """Check the current goal under the current fairness.
        ``resume=True`` continues an interrupted run from
        ``checkpoint_path``: a sweep frame restores the explored rows and
        the edges so far; an exploration frame resumes the BFS."""
        self._reset_telemetry()
        ckpt.cleanup_stale_tmp(self.checkpoint_path)
        watcher = ckpt.PreemptionWatcher(
            enabled=bool(self.checkpoint_path), log=self._log
        )
        self._watcher = watcher
        # the sweep's heartbeat starts after the exploration (which runs
        # its own)
        with obs.run_scope(self, self._telemetry_arg):
            try:
                with watcher:
                    if resume:
                        if not self.checkpoint_path:
                            raise ValueError(
                                "resume requires checkpoint_path")
                        if not self._try_resume_sweep():
                            # an exploration frame: resume the BFS first
                            self._resume_explore = True
                    self._emit_header(resume)
                    lres = self._run_or_preempt()
                    self._emit_result(lres)
                    return lres
            finally:
                if self._hb is not None:
                    self._hb.stop()
                    self._hb = None
                self._watcher = None

    def _run_or_preempt(self) -> LivenessResult:
        """:meth:`_run_check`, or the resumable result of a preemption."""
        try:
            return self._run_check()
        except _Preempted as p:
            has_frame = bool(self.checkpoint_path) and \
                os.path.exists(self.checkpoint_path)
            return LivenessResult(
                False,
                "preempted (SIGTERM/SIGINT) during the "
                f"{p.phase} phase — " + (
                    "a resumable frame is on disk; continue "
                    "with run(resume=True)" if has_frame
                    else "no frame was written yet; the run is "
                    "NOT resumable"
                ),
                p.n,
                truncated=True,
                stop_reason="preempted",
            )

    def _emit_header(self, resume: bool) -> None:
        obs.emit_header(
            self.tel, self.device, resume, self._resume_meta,
            engine="liveness",
            visited_impl=self._checker.visited_impl,
            compact_impl=self.compact_impl,
            config_sig=self._config_sig(),
            profile_sig=self.profile_sig,
            hbm_budget=getattr(self._checker, "hbm_budget", None),
            mode="liveness",
            goal=self.goal_name,
            fairness=self.fairness,
            n_devices=self.n_devices,
            sweep_chunk=self.SF,
            sweep_group=self._sweep_group_size(),
        )

    def _emit_result(self, lres: LivenessResult) -> None:
        """The sweep's ``attribution`` record (when it swept) and the
        ``result`` record."""
        ws = {k: int(v) for k, v in self._work_sweep.items() if v}
        if ws:
            self.tel.emit("attribution",
                          stages={f"sweep_{k}": v for k, v in ws.items()})
        self.tel.emit(
            "result",
            distinct_states=lres.distinct_states,
            diameter=self.last_stats.get("diameter"),
            wall_s=round(time.time() - self._t0, 3),
            truncated=lres.truncated,
            stop_reason=lres.stop_reason,
            holds=None if lres.truncated else lres.holds,
            reason=lres.reason,
            goal=self.goal_name,
            fairness=self.fairness,
            ckpt_frames=getattr(self, "_sweep_frames", 0),
            ckpt_retries=self._ckpt_retries,
            **{f"work_sweep_{k}": v for k, v in ws.items()},
        )

    def _run_check(self) -> LivenessResult:
        n, n_init = self._explore()
        if self.heartbeat_s:
            self._snap["distinct_states"] = n
            self._hb = obs.Heartbeat(self.heartbeat_s, self._snap,
                                     telemetry=self.tel).start()
        t0 = time.time()
        goal = self._goal(n)
        self.last_stats["goal_s"] = time.time() - t0
        if self.fairness == "wf_next":
            self._edges(n)
        t0 = time.time()
        res = self._check(n, n_init, goal)
        self.last_stats["analysis_s"] = time.time() - t0
        return res

    # ------------------------------------------------- checkpoint/resume

    def _config_sig(self) -> str:
        """What a sweep frame must agree on.  Goal and fairness are not
        in it: the edges do not depend on them.  The sweep chunk is: a
        chunk index means something only at the same chunk size."""
        return ckpt.config_sig(
            model=ckpt.model_sig(self.model),
            state_bits=self.model.layout.total_bits,
            key_cols=self.K,
            key_exact=self.keys.exact,
            sweep_chunk=self.SF,
            engine=ENGINE_SIG,
        )

    def _save_sweep_frame(self, n, src_parts, dst_parts, next_chunk):
        """One sweep frame: the explored rows, the edges so far (with
        their out-degrees) and the next chunk."""
        t = time.perf_counter()
        src = (np.concatenate(src_parts) if src_parts
               else np.zeros(0, np.int64))
        arrays = {
            "n": np.int64(n),
            "n_init": np.int64(self._explored[1]),
            "diameter": np.int64(self.last_stats.get("diameter", 0)),
            "next_chunk": np.int64(next_chunk),
            "rows": self._rows[:n].to("cpu", copy=True).numpy()
            .view(np.uint32).reshape(-1),
            "src": src,
            "dst": (np.concatenate(dst_parts) if dst_parts
                    else np.zeros(0, np.int64)),
            "out_deg": np.bincount(src, minlength=n).astype(np.int64),
        }
        self._sweep_frames = getattr(self, "_sweep_frames", 0) + 1
        nbytes, _write_s, retries = ckpt.save_frame(
            self.checkpoint_path, self._config_sig(), arrays,
            wall_s=time.time() - self._t0,
            meta={"frame_seq": self._sweep_frames, "phase": "sweep",
                  "engine": "liveness", "run_id": self._run_id},
        )
        stall = time.perf_counter() - t
        self._ckpt_retries += retries
        self.tel.emit(
            "ckpt_frame",
            frame_seq=self._sweep_frames,
            bytes=nbytes,
            write_s=round(_write_s, 3),
            stall_s=round(stall, 3),
            retries=retries,
            phase="sweep",
            chunk=next_chunk,
            distinct_states=n,
        )
        self.last_stats.update(
            sweep_frames=self._sweep_frames, sweep_frame_bytes=nbytes,
            sweep_frame_s=round(stall, 3), ckpt_retries=retries,
        )
        self._log(f"sweep checkpoint: chunk {next_chunk}, {n} states "
                  f"({nbytes >> 10} KiB, {stall:.2f}s) -> "
                  f"{self.checkpoint_path}")

    def _try_resume_sweep(self) -> bool:
        """Load a sweep frame if that is what ``checkpoint_path`` holds;
        False for an exploration frame (another signature).  A missing
        file raises FileNotFoundError."""
        try:
            d = ckpt.load_frame(self.checkpoint_path, self._config_sig())
        except FileNotFoundError:
            raise
        except ValueError:
            return False
        self._resume_meta = ckpt.frame_meta(d)
        n, W = int(d["n"]), self.model.layout.W
        self._explored = (n, int(d["n_init"]))
        self.last_stats.update(distinct_states=n,
                               diameter=int(d["diameter"]))
        rows = np.asarray(d["rows"], np.uint32).view(np.int32)
        self._rows = torch.from_numpy(rows.reshape(n, W)).to(self.device)
        # the explorer's tensors are not needed: the rows are here
        self._checker._free_buffers()
        src = np.asarray(d["src"], np.int64)
        dst = np.asarray(d["dst"], np.int64)
        self._sweep_resume = ([src] if len(src) else [],
                              [dst] if len(dst) else [],
                              int(d["next_chunk"]))
        self._log(f"resuming the edge sweep from chunk "
                  f"{int(d['next_chunk'])} ({n} explored states restored, "
                  "no re-exploration)")
        return True

    def _check(self, n: int, n_init: int, goal: np.ndarray) -> LivenessResult:
        cprob = self.keys.collision_prob(n)
        if self.fairness == "none":
            bad = np.nonzero(~goal[:n_init])[0]
            if len(bad):
                return LivenessResult(
                    False,
                    "stuttering counterexample: initial state "
                    f"#{int(bad[0])} may stutter forever without reaching "
                    "the goal (no fairness assumed)",
                    n,
                    lasso_prefix=[int(bad[0])],
                    lasso_cycle=[int(bad[0])],
                    fp_collision_prob=cprob,
                )
            return LivenessResult(
                True, "every initial state satisfies the goal", n,
                fp_collision_prob=cprob,
            )

        # ---- wf_next: the edge list (cached across goals) ----
        src, dst, out_deg = self._edges(n)

        # restrict to not-goal -> not-goal edges; CSR over sources
        keep = ~goal[src] & ~goal[dst]
        rsrc, rdst = src[keep], dst[keep]
        order_adj = np.argsort(rsrc, kind="stable")
        rsrc, rdst = rsrc[order_adj], rdst[order_adj]
        starts = np.searchsorted(rsrc, np.arange(n + 1))

        # reach R from not-goal initial states: vectorized BFS sweeps
        in_r = np.zeros((n,), bool)
        parent = np.full((n,), -1, np.int64)
        frontier = np.nonzero(~goal[:n_init])[0]
        in_r[frontier] = True
        while len(frontier):
            # all out-edges of the frontier, via CSR ranges
            cnt = starts[frontier + 1] - starts[frontier]
            total = int(cnt.sum())
            if total == 0:
                break
            base = np.repeat(starts[frontier], cnt)
            offs = np.arange(total) - np.repeat(
                np.cumsum(cnt) - cnt, cnt
            )
            eidx = base + offs
            vs = rdst[eidx]
            us = rsrc[eidx]
            fresh = ~in_r[vs]
            if not fresh.any():
                break
            vf = vs[fresh]
            uf = us[fresh]
            # any parent is a valid predecessor for the lasso prefix
            parent[vf] = uf
            in_r[vf] = True
            frontier = np.unique(vf)
        r_nodes = np.nonzero(in_r)[0]
        if len(r_nodes) == 0:
            return LivenessResult(
                True, "all fair behaviors reach the goal", n,
                fp_collision_prob=cprob,
            )
        dead = r_nodes[out_deg[r_nodes] == 0]
        if len(dead):
            g = int(dead[0])
            return LivenessResult(
                False,
                "fair stuttering at a not-goal state with no var-changing "
                "successor",
                n,
                lasso_prefix=self._path_to(parent, g, n_init),
                lasso_cycle=[g],
                fp_collision_prob=cprob,
            )
        # Kahn peel within R — wave-vectorized
        indeg = np.zeros((n,), np.int64)
        both = in_r[rsrc] & in_r[rdst]
        np.add.at(indeg, rdst[both], 1)
        alive = in_r.copy()
        wave = r_nodes[indeg[r_nodes] == 0]
        while len(wave):
            alive[wave] = False
            cnt = starts[wave + 1] - starts[wave]
            total = int(cnt.sum())
            if total == 0:
                break
            base = np.repeat(starts[wave], cnt)
            offs = np.arange(total) - np.repeat(
                np.cumsum(cnt) - cnt, cnt
            )
            vs = rdst[base + offs]
            am = alive[vs]
            np.subtract.at(indeg, vs[am], 1)
            cand = np.unique(vs[am])
            wave = cand[(indeg[cand] == 0) & alive[cand]]
        cyc_nodes = np.nonzero(alive)[0]
        if len(cyc_nodes):
            # Kahn peeling (in-degree) can leave acyclic tail nodes that
            # dangle off a cycle; one backward Kahn pass on OUT-degree
            # (via the reverse adjacency) removes them so every
            # surviving node has an alive successor and the
            # cycle-recovery walk is total.
            both = alive[rsrc] & alive[rdst]
            odeg = np.zeros((n,), np.int64)
            np.add.at(odeg, rsrc[both], 1)
            rorder = np.argsort(rdst, kind="stable")
            bsrc, bdst = rsrc[rorder], rdst[rorder]
            bstarts = np.searchsorted(bdst, np.arange(n + 1))
            wave = cyc_nodes[odeg[cyc_nodes] == 0]
            while len(wave):
                alive[wave] = False
                cnt = bstarts[wave + 1] - bstarts[wave]
                total = int(cnt.sum())
                if total == 0:
                    break
                base = np.repeat(bstarts[wave], cnt)
                offs = np.arange(total) - np.repeat(
                    np.cumsum(cnt) - cnt, cnt
                )
                ps = bsrc[base + offs]
                am = alive[ps]
                np.subtract.at(odeg, ps[am], 1)
                cand = np.unique(ps[am])
                wave = cand[(odeg[cand] == 0) & alive[cand]]
            cyc_nodes = np.nonzero(alive)[0]
        if len(cyc_nodes):
            # recover one cycle: walk alive-successors until a repeat
            u = int(cyc_nodes[0])
            seen_at = {}
            walk = []
            while u not in seen_at:
                seen_at[u] = len(walk)
                walk.append(u)
                nxt = [
                    int(v)
                    for v in rdst[starts[u]: starts[u + 1]]
                    if alive[v]
                ]
                u = nxt[0]
            cycle = walk[seen_at[u]:]
            return LivenessResult(
                False,
                "cycle of not-goal states is fairly traversable",
                n,
                lasso_prefix=self._path_to(parent, cycle[0], n_init),
                lasso_cycle=cycle,
                fp_collision_prob=cprob,
            )
        return LivenessResult(
            True, "all fair behaviors reach the goal", n,
            fp_collision_prob=cprob,
        )

    @staticmethod
    def _path_to(parent, g, n_init) -> List[int]:
        path = [g]
        while path[-1] >= n_init and parent[path[-1]] >= 0:
            path.append(int(parent[path[-1]]))
        return list(reversed(path))
