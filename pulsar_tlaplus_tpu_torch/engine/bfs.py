"""The checker result record, and the host-driver BFS engine — the
counterpart of ``pulsar_tlaplus_tpu/engine/bfs.py`` (``CheckerResult``,
``Checker``).

:class:`Checker` keeps the frontier, its gids and the state log on the
host and sends the device one chunk of ``frontier_chunk`` rows at a
time: the model expands it, ``engine/core.py`` deduplicates the lanes
against the visited set on the device and checks the invariants on the
new states, and the host copies the new rows into the log.  Two visited
sets, as in the JAX engine (``dedup``):

- ``"hash"`` (the default): the hash table of ``ops/hashtable.py``,
  grown fourfold (a rehash, H1 on the card) to keep its load at most
  1/2; new states come in lane order;
- ``"sort"``: sorted SENTINEL-padded key columns (``ops/dedup.py``),
  new states in key order.

The log is a :class:`~.statelog.MemoryLog`, or with ``state_log_path``
a :class:`~.statelog.FileLog`.  A trace walks the log's parent gids
(roots log -1) and renders the logged rows.  The run stops
(``truncated``) past ``max_states`` or ``time_budget_s``: at once when
no ``checkpoint_path`` is set, else at the level boundary with a frame;
``run(resume=True)`` continues a frame.  ``metrics_path`` takes one
record a level.  The ``level`` fault site (``utils/faults.py``) is
polled before each level is expanded.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.engine import core
from pulsar_tlaplus_tpu_torch.engine.statelog import FileLog, MemoryLog
from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.obs import telemetry as obs
from pulsar_tlaplus_tpu_torch.ops import fpset, hashtable
from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL
from pulsar_tlaplus_tpu_torch.utils import ckpt, faults, metrics
from pulsar_tlaplus_tpu_torch.utils import device as device_mod


@dataclass
class CheckerResult:
    distinct_states: int
    diameter: int  # BFS levels; initial states = level 1 (as the oracle)
    violation: Optional[str] = None  # invariant name, or "Deadlock"
    trace: Optional[list] = None  # states as the model's to_pystate gives them
    trace_actions: Optional[list] = None  # action names along the trace
    deadlock: bool = False
    states_per_sec: float = 0.0
    wall_s: float = 0.0
    level_sizes: List[int] = field(default_factory=list)
    truncated: bool = False  # stopped by a budget or a stop, not exhaustion
    # why a truncated run stopped: "max_states" | "time_budget" | "hbm"
    # (device memory ran out and no frame could rebuild the run) |
    # "row_window" (the frontier row window lost rows of a level that
    # must be expanded) | "preempted" (SIGTERM/SIGINT: a resumable stop)
    # | "spill_enospc" (the durable spill tier hit a full disk); None
    # when not truncated (and from the host engines, as in JAX)
    stop_reason: Optional[str] = None
    # how many times the run rebuilt its device state from the last
    # checkpoint frame after device memory ran out, and went on at
    # degraded capacity
    hbm_recovered: int = 0
    # gid of the violating/deadlocked state (discovery order)
    violation_gid: Optional[int] = None
    # expected fingerprint collisions at this state count (birthday
    # bound); 0.0 when the keys are exact
    fp_collision_prob: float = 0.0


# the frame format's engine revision
ENGINE_SIG = "bfs_host_torch_r1"


class Checker:
    """BFS checker for a batched model with a host-driven level loop, on
    one device (``cuda`` unless ``device`` names another).  ``telemetry``
    takes the run's JSONL stream, ``heartbeat_s`` prints a progress line
    that often."""

    def __init__(
        self,
        model,
        invariants: Optional[Tuple[str, ...]] = None,
        check_deadlock: bool = True,
        frontier_chunk: int = 4096,
        visited_cap: int = 1 << 13,
        max_states: int = 200_000_000,
        time_budget_s: Optional[float] = None,
        progress: bool = False,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 5,
        metrics_path: Optional[str] = None,
        keep_log: bool = False,
        state_log_path: Optional[str] = None,
        dedup: str = "hash",
        device=None,
        telemetry=None,
        heartbeat_s: Optional[float] = None,
    ):
        if dedup not in ("hash", "sort"):
            raise ValueError(f"dedup must be 'hash' or 'sort': {dedup}")
        if dedup == "hash" and visited_cap & (visited_cap - 1):
            raise ValueError(
                f"hash dedup needs a power-of-two visited_cap: {visited_cap}"
            )
        self.dedup_mode = dedup
        self.device = device_mod.resolve(device)
        self.model = model
        self.layout = model.layout
        if invariants is None:
            invariants = model.default_invariants
        unknown = [n for n in invariants if n not in model.invariants]
        if unknown:
            raise ValueError(f"unknown invariant(s): {unknown}")
        self.invariant_names = tuple(invariants)
        self.check_deadlock = check_deadlock
        self.F = frontier_chunk
        self.max_states = max_states
        self.time_budget_s = time_budget_s
        self.progress = progress
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.metrics_path = metrics_path
        self.keep_log = keep_log
        self.state_log_path = state_log_path
        self.last_run_state: Optional[_RunState] = None
        self._cap0 = visited_cap
        self._ckpt_frames = 0
        # telemetry (``obs/telemetry.py``): a stream a run, and the
        # heartbeat from the level snapshot
        self._telemetry_arg = telemetry
        self.heartbeat_s = heartbeat_s
        self.tel = obs.NULL
        self._run_id: Optional[str] = None
        self._snap: Dict[str, object] = {}
        self._resume_meta: Dict[str, object] = {}

    # ------------------------------------------------------------ device

    def _empty_visited(self, cap: int):
        if self.dedup_mode == "hash":
            return hashtable.empty_table(cap, self.device)
        return tuple(torch.full((cap,), SENTINEL, dtype=torch.int32,
                                device=self.device) for _ in range(3))

    def _grow_visited(self, rs, need: int) -> None:
        """Room for ``need`` entries: the sorted columns hold them all,
        the hash table keeps its load <= 1/2 (a rehash into a table
        four times larger)."""
        cap = self._cap
        target = 2 * need if self.dedup_mode == "hash" else need
        while cap < target:
            cap *= 4
        if cap == self._cap:
            return
        if self.dedup_mode == "hash":
            rs.vk = hashtable.rehash_into(rs.vk,
                                          self._empty_visited(cap))
            rs.claims = fpset.new_claims(cap, self.device)
        else:
            rs.vk = tuple(
                torch.cat([c, torch.full((cap - self._cap,), SENTINEL,
                                         dtype=torch.int32,
                                         device=self.device)])
                for c in rs.vk)
        self._cap = cap

    def _dedup(self, rs, packed, valid, parent, action):
        """``engine/core``'s dedup of one chunk's lanes; returns
        ``(packed, parent, action, n_new, viol)`` with the new states
        first."""
        m, inv = self.model, self.invariant_names
        if self.dedup_mode == "hash":
            out = core.dedup_core_hash(m, inv, packed, valid, parent,
                                       action, rs.vk, rs.claims)
            p, par, act, n_new, rs.vk, viol, failed = out
            failed = int(failed)
            if failed:
                raise RuntimeError(
                    "hash-table probe overflow — raise visited_cap "
                    f"({failed} unresolved lanes at capacity {self._cap})"
                )
        else:
            p, par, act, n_new, *vk, viol = core.dedup_core(
                m, inv, packed, valid, parent, action, *rs.vk,
                rs.n_visited)
            rs.vk = tuple(vk)
        return p, par, act, n_new, viol

    def _insert_step(self, rs, idx: torch.Tensor):
        packed = self.layout.pack(self.model.gen_initial(idx))
        n = packed.shape[0]
        none = torch.full((n,), -1, dtype=torch.int32, device=self.device)
        return self._dedup(rs, packed,
                           torch.ones((n,), dtype=torch.bool,
                                      device=self.device), none, none)

    def _expand_step(self, rs, chunk: np.ndarray):
        """Expand ``chunk`` (uint32 rows): ``(dedup out, first
        deadlocked row or the row count)``."""
        m, dev = self.model, self.device
        f = chunk.shape[0]
        rows = torch.from_numpy(chunk.view(np.int32)).to(dev)
        states = self.layout.unpack(rows)
        succ, valid = m.successors(states)
        packed = self.layout.pack(succ).reshape(f * m.A, self.layout.W)
        parent = torch.arange(f, dtype=torch.int32,
                              device=dev).repeat_interleave(m.A)
        action = self._aids.repeat(f)
        out = self._dedup(rs, packed, valid.reshape(-1), parent, action)
        dead_idx = f
        if self.check_deadlock:
            dead = ~valid.any(dim=1) & ~m.stutter_enabled(states)
            dead_idx = int(torch.where(
                dead, torch.arange(f, device=dev), f).amin())
        return out, dead_idx

    # --------------------------------------------------------------- host

    def _log(self, msg: str) -> None:
        if self.progress:
            print(f"  {msg}", file=sys.stderr, flush=True)

    def _flush_chunk(self, rs, out, frontier_gids, base_row):
        """Copy a step's new states into the state log; returns
        ``(n_new, violation, packed rows of the new states)``."""
        packed, parent, action, n_new, viol = out
        n_new = int(n_new)
        np_packed = None
        if n_new:
            np_packed = packed[:n_new].cpu().numpy().view(np.uint32)
            np_parent = parent[:n_new].cpu().numpy()
            if frontier_gids is None:
                gids = np.full((n_new,), -1, np.int64)
            else:
                gids = frontier_gids[base_row + np_parent]
            rs.log.append(np_packed, gids, action[:n_new].cpu().numpy())
        violation = None
        for name, v in zip(self.invariant_names, viol.tolist()):
            if v < n_new:
                violation = (name, rs.n_total + v)
                break
        rs.n_total += n_new
        rs.n_visited += n_new
        return n_new, violation, np_packed

    def _emit_metrics(self, rs, level_count: int) -> None:
        """One record a level: ``frontier`` the states expanded,
        ``new_states`` the states found (the JAX host engine's keys)."""
        wall = time.time() - rs.t0
        self._snap.update(level=len(rs.level_sizes),
                          frontier=int(len(rs.frontier)),
                          distinct_states=rs.n_total)
        self.tel.emit(
            "level",
            level=len(rs.level_sizes),
            new_states=int(level_count),
            distinct_states=rs.n_total,
            frontier=int(len(rs.frontier)),
            wall_s=round(wall, 3),
            states_per_sec=round(rs.n_total / max(wall, 1e-9), 1),
        )
        metrics.append(self.metrics_path, {
            "level": len(rs.level_sizes),
            "new_states": level_count,
            "distinct_states": rs.n_total,
            "frontier": int(len(rs.frontier)),
            "wall_s": round(wall, 3),
            "states_per_sec": round(rs.n_total / max(wall, 1e-9), 1),
            "visited_cap": self._cap,
        })

    def _config_sig(self) -> str:
        return ckpt.config_sig(
            model=ckpt.model_sig(self.model),
            invariants=self.invariant_names,
            check_deadlock=self.check_deadlock,
            state_bits=self.layout.total_bits,
            dedup=self.dedup_mode,
            engine=ENGINE_SIG,
        )

    def _save_checkpoint(self, rs) -> None:
        """A level-boundary frame: the visited set, the frontier and its
        gids, and the log (a file log: its path and length, the file is
        the durable copy)."""
        log = rs.log
        if isinstance(log, FileLog):
            log.sync()
            arrays = dict(
                log_path=np.frombuffer(log.path.encode(), dtype=np.uint8),
                log_len=np.int64(len(log)))
        else:
            arrays = dict(packed=log.packed_matrix(), parent=log.parents(),
                          action=log.actions())
        if self.dedup_mode == "hash":
            arrays.update(ckpt.pack_table(rs.vk))
        else:
            for i, c in enumerate(rs.vk):
                arrays[f"vk{i}"] = c.cpu().numpy().view(np.uint32)
        t = time.perf_counter()
        nbytes, write_s, retries = ckpt.save_frame(
            self.checkpoint_path, self._config_sig(),
            dict(arrays, n_visited=np.int64(rs.n_visited),
                 level_sizes=np.asarray(rs.level_sizes, np.int64),
                 frontier=rs.frontier, frontier_gids=rs.frontier_gids),
            wall_s=time.time() - rs.t0,
            meta={"frame_seq": self._ckpt_frames + 1,
                  "level": len(rs.level_sizes), "engine": "bfs_host",
                  "run_id": self._run_id},
        )
        self._ckpt_frames += 1
        self._ckpt_bytes += nbytes
        self._ckpt_write_s += time.perf_counter() - t
        self._ckpt_retries += retries
        self.tel.emit(
            "ckpt_frame",
            frame_seq=self._ckpt_frames,
            bytes=nbytes,
            write_s=round(write_s, 3),
            stall_s=round(time.perf_counter() - t, 3),
            retries=retries,
            level=len(rs.level_sizes),
            distinct_states=rs.n_total,
        )

    def _restore(self, rs) -> None:
        d = ckpt.load_frame(self.checkpoint_path, self._config_sig(),
                            what="model configuration")
        self._resume_meta = ckpt.frame_meta(d)
        rs.t0 = time.time() - float(d["wall_s"])
        if self.dedup_mode == "hash":
            self._cap = int(d["fp_tcap"])
            rs.vk = self._empty_visited(self._cap)
            ckpt.restore_table(d, rs.vk)
            rs.claims = fpset.new_claims(self._cap, self.device)
        else:
            rs.vk = tuple(
                torch.from_numpy(np.asarray(d[f"vk{i}"], np.uint32)
                                 .view(np.int32).copy()).to(self.device)
                for i in range(3))
            self._cap = rs.vk[0].shape[0]
        rs.n_visited = int(d["n_visited"])
        if "log_path" in d:
            rs.log = FileLog(d["log_path"].tobytes().decode(),
                             self.layout.W)
            if len(rs.log) < int(d["log_len"]):
                raise ValueError("state log shorter than checkpoint records")
            rs.log.truncate(int(d["log_len"]))
        else:
            rs.log = MemoryLog(self.layout.W)
            if len(d["packed"]):
                rs.log.append(d["packed"], d["parent"], d["action"])
        rs.n_total = rs.n_visited
        rs.level_sizes = [int(x) for x in d["level_sizes"]]
        rs.frontier = np.asarray(d["frontier"], np.uint32)
        rs.frontier_gids = np.asarray(d["frontier_gids"], np.int64)

    # ---------------------------------------------------------------- run

    def run(self, resume: bool = False) -> CheckerResult:
        """Check the model; ``resume=True`` continues the
        ``checkpoint_path`` frame (wall time cumulative)."""
        self._resume_meta = {}
        self._ckpt_frames = self._ckpt_bytes = self._ckpt_retries = 0
        self._ckpt_write_s = 0.0
        with obs.run_scope(self, self._telemetry_arg, self.heartbeat_s,
                           self.max_states):
            return self._run(resume)

    def _emit_header(self, resume: bool) -> None:
        obs.emit_header(
            self.tel, self.device, resume, self._resume_meta,
            engine="bfs_host",
            visited_impl=self.dedup_mode,
            config_sig=self._config_sig(),
            mode="check",
            max_states=self.max_states,
            invariants=list(self.invariant_names),
        )

    def _run(self, resume: bool) -> CheckerResult:
        if self.device.type == "cuda":
            kernels.selftest(self.device)  # K0; builds the kernels
        self._aids = torch.from_numpy(
            np.asarray(self.model.action_ids, np.int32)).to(self.device)
        ckpt.cleanup_stale_tmp(self.checkpoint_path)
        rs = _RunState()
        rs.t0 = time.time()
        if resume:
            if not self.checkpoint_path:
                raise ValueError("resume requires checkpoint_path")
            self._restore(rs)
            self._log(f"resumed at level {len(rs.level_sizes)}: "
                      f"{rs.n_total} states, frontier {len(rs.frontier)}")
            metrics.rewind(self.metrics_path, len(rs.level_sizes))
            self._emit_header(resume=True)
            return self._bfs_loop(rs)
        self._emit_header(resume=False)
        self._cap = self._cap0
        rs.vk = self._empty_visited(self._cap)
        if self.dedup_mode == "hash":
            rs.claims = fpset.new_claims(self._cap, self.device)
        rs.log = (FileLog(self.state_log_path, self.layout.W, fresh=True)
                  if self.state_log_path else MemoryLog(self.layout.W))
        res = self._insert_initial(rs)
        if res is not None:
            return res
        return self._bfs_loop(rs)

    def _build_result(self, rs, violation, deadlock_gid=None,
                      deadlock=False, truncated=False) -> CheckerResult:
        if self.keep_log:
            self.last_run_state = rs
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - rs.t0
        res = CheckerResult(
            distinct_states=rs.n_total,
            diameter=len(rs.level_sizes),
            deadlock=deadlock,
            wall_s=wall,
            states_per_sec=rs.n_total / max(wall, 1e-9),
            level_sizes=rs.level_sizes,
            truncated=truncated,
        )
        gid = None
        if violation is not None:
            res.violation, gid = violation
        elif deadlock:
            res.violation, gid = "Deadlock", deadlock_gid
        if gid is not None:
            res.violation_gid = gid
            res.trace, res.trace_actions = core.build_log_trace(
                self.model, gid, rs.log)
        self.tel.emit(
            "result",
            distinct_states=rs.n_total,
            diameter=len(rs.level_sizes),
            wall_s=round(wall, 3),
            states_per_sec=round(rs.n_total / max(wall, 1e-9), 1),
            truncated=truncated,
            stop_reason=res.stop_reason,
            violation=res.violation,
            violation_gid=res.violation_gid,
            deadlock=res.deadlock,
            level_sizes=[int(x) for x in rs.level_sizes],
            stats={
                "ckpt_frames": self._ckpt_frames,
                "ckpt_bytes": self._ckpt_bytes,
                "ckpt_write_s": round(self._ckpt_write_s, 3),
                "ckpt_retries": self._ckpt_retries,
                "visited_cap": self._cap,
            },
        )
        return res

    def _insert_initial(self, rs) -> Optional[CheckerResult]:
        """Level 1: the initial states in chunks; a result only on a
        violation among them."""
        n_init = self.model.n_initial
        for start in range(0, n_init, self.F):
            idx = torch.arange(start, min(start + self.F, n_init),
                               device=self.device)
            self._grow_visited(rs, rs.n_visited + self.F + 1)
            out = self._insert_step(rs, idx)
            _n, violation, _p = self._flush_chunk(rs, out, None, 0)
            if violation is not None:
                rs.level_sizes.append(rs.n_total)
                return self._build_result(rs, violation)
        rs.level_sizes.append(rs.n_total)
        rs.frontier = rs.log.packed_matrix()
        rs.frontier_gids = np.arange(rs.n_total, dtype=np.int64)
        return None

    def _bfs_loop(self, rs) -> CheckerResult:
        A = self.model.A
        while len(rs.frontier):
            # the level fault site (kill/sigterm drills fire inside poll)
            faults.poll("level", len(rs.level_sizes) + 1)
            level_new: List[np.ndarray] = []
            level_base = rs.n_total
            frontier, frontier_gids = rs.frontier, rs.frontier_gids
            for start in range(0, len(frontier), self.F):
                chunk = frontier[start: start + self.F]
                self._grow_visited(rs, rs.n_visited + self.F * A + 1)
                out, dead_idx = self._expand_step(rs, chunk)
                n_new, violation, np_new = self._flush_chunk(
                    rs, out, frontier_gids, start)
                if n_new:
                    level_new.append(np_new)
                if violation is not None:
                    rs.level_sizes.append(rs.n_total - level_base)
                    return self._build_result(rs, violation)
                if dead_idx < len(chunk):
                    rs.level_sizes.append(rs.n_total - level_base)
                    return self._build_result(
                        rs, None, deadlock=True,
                        deadlock_gid=int(frontier_gids[start + dead_idx]))
                if self._over_budget(rs) and self.checkpoint_path is None:
                    # no frame to write: stop at once
                    rs.level_sizes.append(rs.n_total - level_base)
                    return self._build_result(rs, None, truncated=True)
            level_count = rs.n_total - level_base
            if level_count == 0:
                break
            rs.level_sizes.append(level_count)
            wall = time.time() - rs.t0
            self._log(f"level {len(rs.level_sizes)}: +{level_count} (total "
                      f"{rs.n_total}, {rs.n_total / max(wall, 1e-9):.0f} "
                      "st/s)")
            self._emit_metrics(rs, level_count)
            rs.frontier = np.concatenate(level_new)
            rs.frontier_gids = np.arange(level_base, rs.n_total,
                                         dtype=np.int64)
            over = self._over_budget(rs)
            if self.checkpoint_path and (
                    over
                    or len(rs.level_sizes) % self.checkpoint_every == 0):
                # a level boundary: the frontier is exactly the states
                # not yet expanded
                self._save_checkpoint(rs)
            if over:
                return self._build_result(rs, None, truncated=True)
        return self._build_result(rs, None)

    def _over_budget(self, rs) -> bool:
        return rs.n_visited > self.max_states or (
            self.time_budget_s is not None
            and time.time() - rs.t0 > self.time_budget_s)


class _RunState:
    """Mutable per-run state of the checker (checkpointable)."""

    def __init__(self):
        self.t0 = 0.0
        self.vk = None
        self.claims = None
        self.n_visited = 0
        self.log = None  # MemoryLog | FileLog
        self.n_total = 0
        self.level_sizes: List[int] = []
        self.frontier = None
        self.frontier_gids = None

