"""Level-synchronous BFS on one device — the counterpart of
``pulsar_tlaplus_tpu/engine/device_bfs.py``'s ``DeviceChecker``, reduced to
the unfused stage chain:

- **init**: ``gen_initial`` over index windows, packed, keyed;
- **expand**: a window of up to ``sub_batch`` frontier rows is unpacked,
  ``successors`` gives ``[G, A]`` lanes, they are packed and keyed by the
  key-plane kernel (K2); rows with no enabled lane and no stutter are
  deadlocks;
- **flush**: the tiled flush — the membership-probe kernel (K1) then the
  insert tail — probes or inserts the window's keys in the visited table;
- **compact**: the new rows move to the front in lane order;
- **append**: invariants run on the new states only, and rows, parent
  gids and action lanes are written at the next gids.

All discovered rows stay on the device in gid order (the JAX engine's
``rows_window="all"``), so a level is a contiguous gid range.  Gids
follow first occurrence in (frontier row, action lane) order under
min-lane-wins, and roots log parent ``-1 - init_idx``: rows, parents and
lanes equal the JAX engine's state for state, whatever the window size.

The loop is eager: each flush syncs with the host (the insert tail's
chunk count, the new-state count), and the stop conditions (violation,
deadlock, ``max_states``) are checked after every flush.  The visited
table, row store and logs grow by doubling.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from pulsar_tlaplus_tpu_torch.engine.bfs import CheckerResult
from pulsar_tlaplus_tpu_torch.engine.core import build_trace
from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.compact import compact_rows
from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec
from pulsar_tlaplus_tpu_torch.utils import device as device_mod

BIG = 2**31 - 1


def _pow2_at_least(n: int, floor: int = 1 << 10) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


class DeviceChecker:
    """BFS checker for a batched model on one device (``cuda`` unless
    ``device`` names another; raises when CUDA is wanted and absent).

    ``sub_batch`` frontier rows form one expand window of
    ``sub_batch * A`` candidate lanes, the width of every flush.  The
    visited table starts with room for ``visited_cap`` states at load
    1/2.  The run stops (truncated) once ``max_states`` are found.
    """

    def __init__(
        self,
        model,
        invariants: Optional[Tuple[str, ...]] = None,
        check_deadlock: bool = True,
        sub_batch: int = 1 << 16,
        visited_cap: int = 1 << 16,
        max_states: int = 1 << 26,
        device=None,
        progress: bool = False,
    ):
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
        if sub_batch < 1:
            raise ValueError(f"sub_batch must be >= 1: {sub_batch}")
        self.A, self.W, self.G = model.A, self.layout.W, sub_batch
        self.keys = KeySpec(self.layout.total_bits, self.W)
        self.K = self.keys.ncols
        self.SCAP = max_states
        self.TCAP0 = _pow2_at_least(2 * visited_cap, 1 << 11)
        self.progress = progress
        self.last_stats: Dict[str, object] = {}
        self.last_bufs: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------ buffers

    def _log(self, msg: str) -> None:
        if self.progress:
            print(f"  {msg}", file=sys.stderr, flush=True)

    def _ensure_table(self, need: int) -> None:
        """Double the visited table (rehash on the device) until ``need``
        states fit at load <= 1/2."""
        cap = self._tcols[0].shape[0] - 1
        if need <= cap // 2:
            return
        new_cap = _pow2_at_least(2 * need, cap)
        new, failed = fpset.rehash_cols(
            self._tcols, fpset.empty_cols(new_cap, self.K, self.device)
        )
        if failed:
            raise RuntimeError(f"visited-table rehash overflow ({failed})")
        self._tcols = new
        self._log(f"visited table grown to {new_cap} slots")

    def _ensure_store(self, need: int) -> None:
        """Grow the row store and the parent/lane logs to ``need`` states
        (doubling, contents kept)."""
        cap = self._rows.shape[0]
        if need <= cap:
            return
        new_cap = _pow2_at_least(need, cap)
        dev = self.device
        rows = torch.zeros((new_cap, self.W), dtype=torch.int32, device=dev)
        rows[:cap] = self._rows
        logs = []
        for log in (self._parent, self._lane):
            t = torch.zeros((new_cap,), dtype=torch.int32, device=dev)
            t[:cap] = log
            logs.append(t)
        self._rows = rows
        self._parent, self._lane = logs

    # -------------------------------------------------------- the stages

    def _expand(self, f_off: int, n: int):
        """Expand frontier rows ``[f_off, f_off + n)`` (absolute gids):
        ``(packed [n*A, W], key cols)``; records a deadlocked row."""
        m = self.model
        states = self.layout.unpack(self._rows[f_off: f_off + n])
        succ, valid = m.successors(states)
        packed = self.layout.pack(succ).reshape(n * self.A, self.W)
        kcols = tiles.key_plane(self.keys, packed, valid.reshape(-1))
        if self.check_deadlock:
            dead = ~valid.any(dim=1) & ~m.stutter_enabled(states)
            pos = torch.arange(n, device=self.device)
            d = int(torch.where(dead, pos, BIG).amin())
            if d < BIG:
                self._dead = min(self._dead, f_off + d)
        return packed, kcols

    def _flush(self, packed, kcols, acc_base: int, is_init: bool) -> None:
        """Flush + compact + append one window's candidate lanes; lane
        ``j`` came from source ``acc_base + j // A`` (expand) or is
        initial state ``acc_base + j`` (init)."""
        nq = packed.shape[0]
        self._ensure_table(self._nv + nq)
        self._tcols, n_new, is_new, self._fpm = tiles.flush_acc_tiles(
            self._tcols, kcols, nq, self._fpm
        )
        if int(self._fpm[2]):
            raise RuntimeError(
                f"visited-table probe overflow ({int(self._fpm[2])} "
                "lanes unresolved): the table broke its load contract"
            )
        if not n_new:
            return
        crows, idx = compact_rows(packed, is_new)
        crows, idx = crows[:n_new], idx[:n_new]
        nv = self._nv
        self._ensure_store(nv + n_new)
        self._rows[nv: nv + n_new] = crows
        if is_init:
            self._parent[nv: nv + n_new] = (-1 - (acc_base + idx)).to(
                torch.int32
            )
            self._lane[nv: nv + n_new] = 0
        else:
            self._parent[nv: nv + n_new] = (acc_base + idx // self.A).to(
                torch.int32
            )
            self._lane[nv: nv + n_new] = (idx % self.A).to(torch.int32)
        if self.invariant_names:
            states = self.layout.unpack(crows)
            pos = torch.arange(n_new, device=self.device)
            first_bad = torch.stack([
                torch.where(self.model.invariants[name](states), BIG, pos)
                .amin()
                for name in self.invariant_names
            ]).tolist()
            self._viol = [
                min(v, nv + b) if b < BIG else v
                for v, b in zip(self._viol, first_bad)
            ]
        self._nv = nv + n_new

    # ---------------------------------------------------------------- run

    def _first_viol(self) -> Optional[Tuple[str, int]]:
        """(invariant, gid) of the lowest-gid violation, or None."""
        best = None
        for name, g in zip(self.invariant_names, self._viol):
            if g < BIG and (best is None or g < best[1]):
                best = (name, g)
        return best

    def _stop_reason(self) -> Optional[dict]:
        """``_result`` kwargs if the run must stop: a violation, then a
        deadlock, then the state budget."""
        fv = self._first_viol()
        if fv is not None:
            return {"viol": fv}
        if self._dead < BIG:
            return {"dead_gid": self._dead}
        if self._nv >= self.SCAP:
            return {"truncated": True, "stop_reason": "max_states"}
        return None

    def run(self) -> CheckerResult:
        t0 = time.time()
        dev = self.device
        if dev.type == "cuda":
            # K0 on this card (builds and loads the kernels on first use)
            kernels.selftest(dev)
        self._tcols = fpset.empty_cols(self.TCAP0, self.K, dev)
        cap0 = _pow2_at_least(min(self.TCAP0 // 2, self.SCAP + 1))
        self._rows = torch.zeros((cap0, self.W), dtype=torch.int32,
                                 device=dev)
        self._parent = torch.zeros((cap0,), dtype=torch.int32, device=dev)
        self._lane = torch.zeros((cap0,), dtype=torch.int32, device=dev)
        self._fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64)
        self._nv, self._dead = 0, BIG
        self._viol = [BIG] * len(self.invariant_names)

        # ---- level 1: initial states (compaction.tla:188-202)
        n_init = self.model.n_initial
        if n_init > self.SCAP:
            raise ValueError("initial-state set exceeds max_states")
        step = self.G * self.A
        for f_off in range(0, n_init, step):
            n = min(step, n_init - f_off)
            idx = torch.arange(f_off, f_off + n, device=dev)
            packed = self.layout.pack(self.model.gen_initial(idx))
            kcols = tiles.key_plane(
                self.keys, packed,
                torch.ones((n,), dtype=torch.bool, device=dev),
            )
            self._flush(packed, kcols, f_off, True)
            if self._stop_reason() is not None:
                break
        level_sizes: List[int] = [self._nv]
        self._log(f"level 1: {self._nv} initial states")

        level_base, nf = 0, self._nv
        while True:
            reason = self._stop_reason()
            if reason is not None:
                return self._result(t0, level_sizes, **reason)
            if nf == 0:
                return self._result(t0, level_sizes)
            stop = False
            for f_off in range(0, nf, self.G):
                n = min(self.G, nf - f_off)
                packed, kcols = self._expand(level_base + f_off, n)
                self._flush(packed, kcols, level_base + f_off, False)
                if self._stop_reason() is not None:
                    stop = True
                    break
            level_count = self._nv - (level_base + nf)
            if level_count or stop:
                level_sizes.append(level_count)
                wall = time.time() - t0
                self._log(
                    f"level {len(level_sizes)}: +{level_count} (total "
                    f"{self._nv}, {self._nv / max(wall, 1e-9):.0f} st/s)"
                )
            if stop:
                return self._result(t0, level_sizes, **self._stop_reason())
            level_base += nf
            nf = level_count

    def _result(
        self, t0, level_sizes, viol=None, dead_gid=None, truncated=False,
        stop_reason=None,
    ) -> CheckerResult:
        nv = self._nv
        self.last_bufs = {
            "rows": self._rows.reshape(-1),
            "parent": self._parent,
            "lane": self._lane,
        }
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        tcap = self._tcols[0].shape[0] - 1
        fl, rounds, fails, valid_lanes, max_rounds = self._fpm.tolist()
        self.last_stats = dict(
            fpset_flushes=fl,
            fpset_probe_rounds=rounds,
            fpset_failures=fails,
            fpset_valid_lanes=valid_lanes,
            fpset_max_probe_rounds=max_rounds,
            fpset_table_cap=tcap,
            fpset_occupancy=nv / tcap,
        )
        res = CheckerResult(
            distinct_states=nv,
            diameter=len(level_sizes),
            deadlock=dead_gid is not None,
            wall_s=wall,
            states_per_sec=nv / max(wall, 1e-9),
            level_sizes=list(level_sizes),
            truncated=truncated,
            stop_reason=stop_reason if truncated else None,
            fp_collision_prob=self.keys.collision_prob(nv),
        )
        gid = None
        if viol is not None:
            res.violation, gid = viol
        elif dead_gid is not None:
            res.violation, gid = "Deadlock", dead_gid
        if gid is not None:
            res.violation_gid = gid
            res.trace, res.trace_actions = build_trace(
                self.model, self._parent, self._lane, gid,
                len(level_sizes) + 2,
            )
        return res
