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
  (rehash through H1) and the store with headroom for ``max(GROW_AHEAD,
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

**Tiered mode** (``hbm_budget``; the JAX engine's tiered state store,
RAM tier) runs the stage loop whatever ``fuse`` says, as if the JAX
engine's ``_tiered_pressure`` handoff to its stage path had happened at
the start: the device keeps a budgeted hot tier and the host keeps the
rest in a ``store/tiers.TieredStore``.

- The budget fixes tier ceilings once, by round-robin doubling of the
  table and the row/log window from their initial sizes while
  :meth:`DeviceChecker._device_bytes_est` stays inside ``budget * (1 -
  HBM_HEADROOM)``; a budget below the initial tiers raises.
- An int32 generation column beside the table is tagged with the epoch
  at every level boundary and re-tagged at generation 1 after every
  table growth.  When the hot table is full at its ceiling, the
  oldest generations are evicted (the tiled extract with the sieve-mask
  kernel K3, then a sort), their sorted keys go to the host and the
  survivors are rehashed; only when nothing is evictable does the
  table grow past the budget, once logged as a WARNING.
- After every flush, the lanes the hot table calls new are resolved
  against the cold runs on the host, and the false-new ones are cleared
  before the compaction that assigns gids: discovery order equals the
  untiered run's, state for state.
- Rows and trace logs live in a window ``[row_base, ...)``: ranges
  older than the frontier spill to the host at level boundaries once
  eviction has begun, or when the window is full.  Gids stay absolute;
  traces walk the merged cold + window logs.

The durable spill tier and checkpoint frames are not ported.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.engine.bfs import CheckerResult
from pulsar_tlaplus_tpu_torch.engine.core import build_trace
from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.compact import compact_rows
from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec
from pulsar_tlaplus_tpu_torch.store import budget as store_budget
from pulsar_tlaplus_tpu_torch.store import sieve
from pulsar_tlaplus_tpu_torch.store.tiers import TieredStore
from pulsar_tlaplus_tpu_torch.utils import device as device_mod

BIG = 2**31 - 1
# tiered mode: the share of the budget kept free, and the keys a
# cold-miss lookup moves to the host at a time (the JAX engine's
# defaults of ``hbm_headroom`` and ``miss_batch``)
HBM_HEADROOM = 0.1
MISS_BATCH = 1 << 15
# the fused level's growth headroom in windows (at least fuse_group):
# the JAX engine's (group + 1) accumulators at its default group of 4
GROW_AHEAD = 5
# the widest window (in lanes) of a ramp level after a batch's first,
# whose frontier the host knows only by a bound: about where a window's
# ops stop being launch-bound on an H100 (2^16 lanes x ~80 B ~ 2 us at
# 3.35 TB/s, one launch), so padding it to the bound, or running it as
# a no-op, costs no more than the sync it saves
RAMP_SPEC_LANES = 1 << 16


def _pow2_at_least(n: int, floor: int = 1 << 10) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (a copy also on the CPU, where
    ``.cpu()`` would alias the device buffer that is about to slide)."""
    return t.to("cpu", copy=True).numpy()


class DeviceChecker:
    """BFS checker for a batched model on one device (``cuda`` unless
    ``device`` names another; raises when CUDA is wanted and absent).

    ``sub_batch`` frontier rows form one expand window of
    ``sub_batch * A`` candidate lanes, the width of every flush.  The
    visited table starts with room for ``visited_cap`` states at load
    1/2.  The run stops (truncated) once ``max_states`` are found.

    ``fuse="level"`` (the default) runs the fused level, ``"stage"``
    the loop that reads the device after every window; ``fuse_group``
    (default 8, at most 64) caps the ramp levels one sync may close.

    ``hbm_budget`` (bytes, or a spec such as ``"7.5G"``; the
    ``PTT_HBM_BUDGET`` environment variable when not given) turns on
    the tiered store, which runs the stage loop; ``spill_compress=False``
    sizes the spilled planes raw instead of delta + zlib.
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
        hbm_budget=None,
        spill_compress: bool = True,
        fuse: str = "level",
        fuse_group: Optional[int] = None,
    ):
        if fuse not in ("level", "stage"):
            raise ValueError(f"fuse must be level|stage: {fuse}")
        if fuse_group is not None and fuse_group < 1:
            raise ValueError(f"fuse_group must be >= 1: {fuse_group}")
        self.fuse = fuse
        self.RMAX = min(fuse_group or 8, 64)
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
        self.WCAP0 = _pow2_at_least(min(self.TCAP0 // 2, max_states + 1))
        self.NQ = self.G * self.A  # lanes of one expand window's flush
        self.progress = progress
        self.last_stats: Dict[str, object] = {}
        self.last_bufs: Dict[str, torch.Tensor] = {}
        self.hbm_budget = store_budget.resolve_budget(hbm_budget)
        self.tiered = self.hbm_budget is not None
        self.spill_compress = bool(spill_compress)
        self.tstore: Optional[TieredStore] = None
        self._budget_overridden = False
        self._row_base = 0
        if self.tiered:
            self.TCAP_MAX, self.WCAP_MAX = self._tier_ceilings()

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
        one window in the port.  The table never goes below the room for
        two flushes at load 1/2."""
        eff = int(self.hbm_budget * (1.0 - HBM_HEADROOM))
        tc, wc = self.TCAP0, self.WCAP0
        if self._device_bytes_est(tc, wc, wc) > eff:
            need = self._device_bytes_est(tc, wc, wc)
            raise ValueError(
                "hbm_budget too small: the initial tiers need "
                f"{store_budget.fmt_bytes(need)} (+{HBM_HEADROOM:.0%} "
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

    def _ensure_table(self, need: int, ceiling: Optional[int] = None) -> None:
        """Double the visited table (rehash on the device) until ``need``
        states fit at load <= 1/2, or it reaches ``ceiling`` slots.  In
        tiered mode the per-slot ages die with the old layout: every key
        restarts at generation 1, epoch 2."""
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

    def _grow_store(self, new_cap: int) -> None:
        """Grow the row store and the parent/lane logs to ``new_cap``
        states (contents kept)."""
        cap = self._rows.shape[0]
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

    def _ensure_store(self, need: int) -> None:
        """Grow the row store and the parent/lane logs to ``need`` states
        (doubling)."""
        cap = self._rows.shape[0]
        if need > cap:
            self._grow_store(_pow2_at_least(need, cap))

    # ------------------------------------------------------ tiered store

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
        self._log(f"spill: evicted {n} cold keys to the ram tier "
                  f"(hot {self._hot_n})")
        return n

    def _resolve_cold_misses(self, kcols, is_new, n_new: int):
        """Resolve the flush's hot-new lanes against the cold runs in
        ``MISS_BATCH``-key batches and clear the false-new lanes.
        Returns the corrected ``(n_new, is_new)``."""
        *kc, lanes, n = sieve.sieve_new(kcols, is_new)
        self._spill_syncs += 1
        false_lanes = []
        for off in range(0, n, MISS_BATCH):
            m = min(MISS_BATCH, n - off)
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
        self._row_base = upto
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
        nv, base = self._nv, self._row_base
        par = self._parent[: nv - base].cpu().numpy()
        lan = self._lane[: nv - base].cpu().numpy()
        if not base:
            return par, lan
        cp, cl = self.tstore.fetch_logs(0, base)
        return np.concatenate([cp, par]), np.concatenate([cl, lan])

    def merged_rows(self) -> np.ndarray:
        """The packed rows of every state found, flat uint32 numpy
        ``[nv * W]``: the cold segments, then the device window."""
        nv, base = self._nv, self._row_base
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
        flat = [v.reshape(-1).to(torch.int64) for v in vals]
        return torch.cat(flat).tolist()

    def _lanes(self, rows: torch.Tensor, rowvalid=None):
        """The window's successor lanes: ``(states, valid [n, A], packed
        [n*A, W], key cols)``; rows outside ``rowvalid`` have none."""
        m = self.model
        states = self.layout.unpack(rows)
        succ, valid = m.successors(states)
        if rowvalid is not None:
            valid = valid & rowvalid[:, None]
        n = rows.shape[0]
        packed = self.layout.pack(succ).reshape(n * self.A, self.W)
        kcols = tiles.key_plane(self.keys, packed, valid.reshape(-1))
        return states, valid, packed, kcols

    def _dead_pos(self, states, valid, rowvalid=None) -> torch.Tensor:
        """The first deadlocked row of a window (BIG if none), int64 0-d."""
        dead = ~valid.any(dim=1) & ~self.model.stutter_enabled(states)
        if rowvalid is not None:
            dead = dead & rowvalid
        pos = torch.arange(dead.shape[0], device=self.device)
        return torch.where(dead, pos, BIG).amin()

    def _expand(self, f_off: int, n: int):
        """Expand frontier rows ``[f_off, f_off + n)`` (absolute gids):
        ``(packed [n*A, W], key cols)``; records a deadlocked row."""
        off = f_off - self._row_base
        states, valid, packed, kcols = self._lanes(
            self._rows[off: off + n]
        )
        if self.check_deadlock:
            (d,) = self._read(self._dead_pos(states, valid))
            if d < BIG:
                self._dead = min(self._dead, f_off + d)
        return packed, kcols

    def _flush(self, packed, kcols, acc_base: int, is_init: bool) -> None:
        """Flush + compact + append one window's candidate lanes; lane
        ``j`` came from source ``acc_base + j // A`` (expand) or is
        initial state ``acc_base + j`` (init)."""
        nq = packed.shape[0]
        if self.tiered:
            self._ensure_hot_capacity(nq)
        else:
            self._ensure_table(self._nv + nq)
        self._tcols, n_new, is_new, self._fpm = tiles.flush_acc_tiles(
            self._tcols, kcols, nq, self._fpm, self._claims
        )
        self._host_syncs += 1  # flush_acc_tiles read the new-lane count
        self._check_overflow(*self._read(self._fpm[2], self._rehash_failed))
        if self.tiered:
            # every hot-new key stays inserted, false-new ones included
            self._hot_n += n_new
            if n_new and self.tstore.has_cold_keys:
                n_new, is_new = self._resolve_cold_misses(
                    kcols, is_new, n_new
                )
        if not n_new:
            return
        crows, idx = compact_rows(packed, is_new)
        crows, idx = crows[:n_new], idx[:n_new]
        nv = self._nv
        if self.tiered:
            self._tiered_ensure_windows(self._level_base, nv + n_new)
        else:
            self._ensure_store(nv + n_new)
        w = nv - self._row_base
        self._rows[w: w + n_new] = crows
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

    def _lv_sync(self, *extra: torch.Tensor) -> List[int]:
        """Read the device-held state count, deadlock gid, violation
        gids and probe failures (and ``extra``) in one sync; raise on a
        probe overflow.  Returns the ``extra`` values."""
        n_inv = len(self.invariant_names)
        vals = self._read(self._nv_t, self._dead_t, self._viol_t,
                          self._fpm[2], self._rehash_failed, *extra)
        self._nv, self._dead = vals[0], vals[1]
        self._viol = vals[2: 2 + n_inv]
        self._check_overflow(*vals[2 + n_inv: 4 + n_inv])
        self._nv_hi = self._nv
        if self._nv < self.SCAP:
            # room for the headroom's windows (never past max_states'
            # last window)
            need = min(self._nv + self._ahead, self.SCAP + self.NQ)
            self._ensure_table(need)
            self._ensure_store(need)
        return vals[4 + n_inv:]

    def _lv_room(self, nq: int) -> bool:
        """Make room for a window of ``nq`` lanes: True at once when the
        bound ``nv_hi`` is under ``max_states`` and ``nv_hi + nq`` fits
        the table's load contract and the row store; else sync (and
        grow) first, and False when the run must stop."""
        hi = self._nv_hi + nq
        if (self._nv_hi < self.SCAP
                and hi <= (self._tcols[0].shape[0] - 1) // 2
                and hi <= self._rows.shape[0]):
            return True
        self._lv_sync()
        return self._stop_reason() is None

    def _lv_flush(self, packed, kcols, acc_base, is_init: bool) -> None:
        """The fused level's flush + compact + append of one window, with
        no host read: the compacted rows, parents and lanes of all ``nq``
        lanes go to gids ``nv + j`` (the rows past the new-state count
        are overwritten by later windows)."""
        nq = packed.shape[0]
        dev = self.device
        self._tcols, n_new, is_new, self._fpm = tiles.flush_tiles(
            self._tcols, kcols, nq, self._fpm, self._claims
        )
        crows, idx = compact_rows(packed, is_new)
        nv = self._nv_t
        pos = torch.arange(nq, device=dev)
        dest = nv + pos
        self._rows.index_copy_(0, dest, crows)
        if is_init:
            par, lane = -1 - (acc_base + idx), torch.zeros_like(idx)
        else:
            par, lane = acc_base + idx // self.A, idx % self.A
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
        self._nv_hi += nq

    def _lv_window(self, rows, base, rowvalid=None) -> None:
        """Expand, flush and append one window of frontier rows whose
        first gid is ``base`` (an int, or a 0-d tensor in the ramp)."""
        states, valid, packed, kcols = self._lanes(rows, rowvalid)
        if self.check_deadlock:
            d = self._dead_pos(states, valid, rowvalid)
            self._dead_t = torch.minimum(
                self._dead_t, torch.where(d < BIG, base + d, BIG)
            )
        self._lv_flush(packed, kcols, base, False)

    def _lv_level(self, level_base: int, nf: int) -> bool:
        """Enqueue every window of a level (offsets known on the host),
        syncing only for room.  False when a sync stopped the run
        mid-level."""
        for f_off in range(0, nf, self.G):
            n = min(self.G, nf - f_off)
            if not self._lv_room(n * self.A):
                return False
            off = level_base + f_off
            self._lv_window(self._rows[off: off + n], off)
        return True

    def _lv_ramp(self, level_base: int, nf: int) -> Tuple[list, int, int]:
        """A ramp batch: up to ``RMAX`` levels of one window each, the
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
        for i in range(self.RMAX):
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

    def _run_level(self, t0) -> CheckerResult:
        """The fused level loop (see the module docstring)."""
        dev = self.device
        n_inv = len(self.invariant_names)
        self._nv_t = torch.zeros((), dtype=torch.int64, device=dev)
        self._dead_t = torch.full((), BIG, dtype=torch.int64, device=dev)
        self._viol_t = torch.full((n_inv,), BIG, dtype=torch.int64,
                                  device=dev)
        self._nv_hi = 0
        self._ahead = max(GROW_AHEAD, self.RMAX) * self.NQ
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
            self._lv_flush(packed, kcols, f_off, True)
        self._lv_sync()
        level_sizes: List[int] = [self._nv]
        self._log(f"level 1: {self._nv} initial states")

        level_base, nf = 0, self._nv
        while True:
            reason = self._stop_reason()
            if reason is not None:
                return self._result(t0, level_sizes, **reason)
            if nf == 0:
                return self._result(t0, level_sizes)
            cum, done = level_base + nf, True
            if nf <= self.G:
                sizes, level_base, nf = self._lv_ramp(level_base, nf)
                self._fuse_levels += len(sizes)
            else:
                done = self._lv_level(level_base, nf)
                if done:
                    self._lv_sync()
                    self._fuse_levels += 1
                sizes = [self._nv - cum]
                level_base, nf = cum, sizes[0]
            for sz in sizes:
                # a level that adds nothing ends the search; a level cut
                # by a stop keeps its partial count
                if sz or not done:
                    cum += sz
                    level_sizes.append(sz)
                    wall = time.time() - t0
                    self._log(
                        f"level {len(level_sizes)}: +{sz} (total "
                        f"{cum}, {cum / max(wall, 1e-9):.0f} st/s)"
                    )

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
        self._rows = torch.zeros((self.WCAP0, self.W), dtype=torch.int32,
                                 device=dev)
        self._parent = torch.zeros((self.WCAP0,), dtype=torch.int32,
                                   device=dev)
        self._lane = torch.zeros((self.WCAP0,), dtype=torch.int32,
                                 device=dev)
        self._claims = fpset.new_claims(self.TCAP0, dev)
        self._fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64,
                                device=dev)
        self._rehash_failed = torch.zeros((), dtype=torch.int64, device=dev)
        self._host_syncs = self._fuse_levels = 0
        self._nv, self._dead = 0, BIG
        self._viol = [BIG] * len(self.invariant_names)
        self._row_base = self._level_base = 0
        self._budget_overridden = False
        if self.tiered:
            if self.tstore is not None:
                self.tstore.close()
            self.tstore = TieredStore(compress=self.spill_compress)
            self._tcap_max, self._wcap_max = self.TCAP_MAX, self.WCAP_MAX
            self._gen = torch.zeros((self.TCAP0 + 1,), dtype=torch.int32,
                                    device=dev)
            self._epoch, self._hot_n, self._spill_syncs = 1, 0, 0
            self._spill_active = False
        elif self.fuse == "level":
            return self._run_level(t0)

        # ---- level 1: the spec's initial states, in windows
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
            self._level_base = level_base
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
            if self.tiered and nf:
                self._tiered_boundary(level_base)

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
            host_syncs=self._host_syncs,
            fuse_levels=self._fuse_levels,
            syncs_per_level=round(
                self._host_syncs / max(len(level_sizes), 1), 2
            ),
            fpset_flushes=fl,
            fpset_probe_rounds=rounds,
            fpset_failures=fails,
            fpset_valid_lanes=valid_lanes,
            fpset_max_probe_rounds=max_rounds,
            fpset_table_cap=tcap,
            fpset_occupancy=nv / tcap,
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
                self.model, *self.merged_logs(), gid, len(level_sizes) + 2,
            )
        return res
