"""Mesh-sharded BFS with every shard's state on its device — the
counterpart of ``pulsar_tlaplus_tpu/engine/sharded_device.py``'s
``ShardedDeviceChecker``.

One controller drives ``N`` shards over a :class:`~pulsar_tlaplus_tpu_torch.
parallel.mesh.Mesh`: shard ``s`` keeps, on ``mesh.devices[s]``, its
slot-major visited table (the keys it owns), its row store with the
parent and lane logs (the states it produced, in local-gid order), an
owner-side key accumulator and a producer-side candidate accumulator.
Every round is a plain loop over the shards, each issuing its launches
on its own device:

- **expand** (the JAX ``_round_jit``): shard ``s`` expands ``G =
  sub_batch`` rows of its frontier — ``successors``, pack, and the key
  plane (K2) — and keeps the candidate rows, parent gids and action
  lanes in its producer accumulator: they never travel;
- **route** (``_route_keys``): every valid lane's owner is a murmur-style
  mix of its key columns mod ``N`` (:func:`owner_of`, bit for bit the
  JAX ``_owner``); a one-hot running rank buckets the keys by owner
  (:func:`bucket_scatter`), and one :meth:`Mesh.all_to_all` moves the K
  key planes to the owners.  ``q = owner * CAPO + rank`` is saved as the
  lane's return address.  On a ``(dcn, ici)`` mesh the keys go in two
  hops, owner slice first, then owner chip (``_route_keys_2d``);
- **flush** (``_flush_jit``): every owner looks up or inserts its
  accumulated keys in its own table through the tiled flush
  (``tiles.flush_tiles``: K1, then the insert tail H1) — min-lane-wins
  over the owner's lane order (round, producer, rank), bit for bit the
  JAX ``fpset.lookup_or_insert``; with ``visited_impl="sort"`` it
  sort-merges them into its sorted key columns instead
  (``dedup.merge_new_keys``, the same lowest lane winning).  The
  new-key flags return through the inverse exchange (``_flags_back``,
  ``_flags_back_2d``) and each producer gathers its lanes' flags by
  their return addresses;
- **compact + append** (``_compact_jit``, ``_append_jit``): each producer
  compacts its new lanes in order (``compact_impl``) and writes rows, parents and lanes
  blind at its device-held count (one append window past it), checking
  the invariants on the new states.

The deadlock gid, the violation gids, the route-overflow flag and the
flush metrics stay on the devices; the host fetches one ``[N, stats]``
matrix a group of ``group`` flushes, or earlier when a bound says the
table or the store could overflow, or the state budget is near (the JAX
``need_sync`` rule).  Gids are ``shard << SB | local`` with ``SB = 30 -
bitlen(N - 1)``; the reported violation is the lowest *global* gid, and
traces walk the cross-shard parent chain.  Rows, parent and lane logs
equal the JAX engine's shard for shard, state for state.

A route overflow (a destination's bucket fuller than ``CAPO``) sets a
sticky flag: the host doubles ``route_slack``, re-derives the
capacities and retries the level; the states the partial attempt
appended dedup to no-ops, so counts stay exact.

**Survivability** (``utils/ckpt.py``, ``utils/recovery.py``,
``utils/faults.py``): a frame every ``checkpoint_every`` levels holds
every shard's table (``ckpt.pack_table``), rows and logs and the level
frame; ``run(resume=True)`` continues from it (a frame of another
configuration is refused).  ``time_budget_s``, ``max_states``,
SIGTERM/SIGINT (a frame, then ``preempted``) and device-memory recovery
(``torch.OutOfMemoryError``: rebuild from the frame with the growth
headroom frozen and the group halved; ``hbm`` without one) are the JAX
engine's; the ``level``, ``flush`` and ``frame`` fault sites fire as
there.  ``run(seed=...)`` loads a host-enumerated BFS prefix;
``metrics_path`` takes one record a level (a resume drops the records
past its frame's level).

Not ported: telemetry and heartbeats (``obs/``), and
``warmup``/``_prewarm_tiers`` (they compile XLA executables, which have
no counterpart here).  Unlike the JAX engine, several shards may share a
device (see ``parallel/mesh``).
"""

from __future__ import annotations

import gc
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
from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag, validate_impl
from pulsar_tlaplus_tpu_torch.ops.dedup import (
    SENTINEL, KeySpec, merge_lanes, mul32, rotl, u32,
)
from pulsar_tlaplus_tpu_torch.parallel import mesh as mesh_mod
from pulsar_tlaplus_tpu_torch.utils import ckpt, faults, metrics, recovery

BIG = 2**31 - 1
FPM_N = fpset.FPM_N
# the frame format's engine revision (a frame of another engine, the JAX
# package's included, is refused)
ENGINE_SIG = "sharded_device_torch_r1"


class _RouteOverflow(Exception):
    """A routing round overflowed a destination's capacity; the host
    doubles ``route_slack`` and retries the level."""


def owner_of(kcols, n: int) -> torch.Tensor:
    """The owning shard of each key (int64): a murmur-style mix of the
    key columns mod ``n`` — the JAX ``_owner`` bit for bit.  Exact keys
    are raw state words with skewed low bits; the mix keeps the buckets
    near ``lanes / n``."""
    h = u32(kcols[0])
    for c in kcols[1:]:
        h = mul32(h ^ u32(c), 0xCC9E2D51)
        h = rotl(h, 13)
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h % n


def bucket_scatter(dest, ndest: int, cap: int, valid, cols, fills):
    """One-hot running-rank bucketing (the JAX ``_bucket_scatter``):
    valid lane ``l`` goes to slot ``dest * cap + rank`` of ``[ndest *
    cap]`` planes, rank its position among the valid lanes of its
    destination in lane order.  A lane whose rank reaches ``cap`` is
    dropped and sets ``over``.  Returns ``(planes, q, over)``: ``q`` the
    lane's slot (int64, -1 when dropped or invalid), ``over`` a bool
    0-d tensor."""
    dev = dest.device
    dest = dest.to(torch.int64)
    # [ndest, lanes]: the running count scans the contiguous lane axis
    onehot = (torch.arange(ndest, device=dev)[:, None] == dest[None, :]) \
        & valid[None, :]
    ranks = torch.cumsum(onehot.to(torch.int32), dim=1, dtype=torch.int32)
    if dest.shape[0]:
        rank = ranks.gather(0, dest.clamp(0, ndest - 1)[None, :])[0] - 1
        over = (ranks[:, -1] > cap).any()
    else:
        rank = torch.zeros_like(dest)
        over = torch.zeros((), dtype=torch.bool, device=dev)
    fit = valid & (rank < cap)
    q = torch.where(fit, dest * cap + rank, ndest * cap)
    outs = []
    for col, fill in zip(cols, fills):
        o = torch.full((ndest * cap + 1,), fill, dtype=col.dtype,
                       device=dev)
        o.scatter_(0, q, col)  # dropped lanes all land in the trash slot
        outs.append(o[: ndest * cap])
    return outs, torch.where(fit, q, -1), over


def flag_gather(recv, aq, flush: int, cap: int, ncs: int) -> torch.Tensor:
    """A producer's per-lane new flags from the returned flag planes (the
    JAX ``_flag_gather``): lane ``l`` of round ``r = l // ncs`` with
    return address ``q = o * cap + j`` reads ``recv[o * flush * cap + r
    * cap + j]``; ``q < 0`` reads False."""
    aq = aq.to(torch.int64)
    lanei = torch.arange(flush * ncs, device=aq.device)
    r = lanei // ncs
    idx = (aq // cap) * (flush * cap) + r * cap + aq % cap
    ok = aq >= 0
    return torch.where(ok, recv[torch.where(ok, idx, 0)], False)


class _ShardLog:
    """A per-shard log indexed by global gid (``shard << SB | local``),
    for the trace walk."""

    def __init__(self, logs, sb: int):
        self.logs, self.sb, self.mask = logs, sb, (1 << sb) - 1

    def __getitem__(self, g) -> int:
        g = int(g)
        return int(self.logs[g >> self.sb][g & self.mask])


def _grown(t: torch.Tensor, new_len: int) -> torch.Tensor:
    out = torch.zeros((new_len, *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[: t.shape[0]] = t
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.to("cpu", copy=True).numpy()


class ShardedDeviceChecker:
    """Level-synchronous BFS over a 1-D or ``(dcn, ici)`` mesh of
    ``n_devices`` shards (default: one a card present), ``n_slices``
    slices.  The shards sit on ``device`` (a device or a list, cycled;
    default every card present, ``"cpu"`` for the CPU); several may
    share a device.  Capacities are per shard: ``visited_cap`` keys
    before the table grows, ``sub_batch`` frontier rows expanded a shard
    a round (in chunks of ``expand_chunk``), ``fp_bits`` the width of a
    hashed key (64 or 96), ``flush_factor`` rounds a flush, ``group`` flushes between
    two host fetches.  ``route_slack`` scales the per-destination route
    capacity over the mean.  ``visited_impl`` is ``"fpset"`` (the hash
    table) or ``"sort"`` (sorted key columns), ``compact_impl``
    ``"logshift"`` or ``"sort"``.  ``max_states`` and ``time_budget_s``
    stop the run (truncated); ``checkpoint_path`` writes a frame every
    ``checkpoint_every`` levels; ``metrics_path`` takes one record a
    level.  ``telemetry`` takes the run's JSONL stream (its ``flush``
    records sum the shards' flush metrics, the deepest probe's max, as
    the JAX engine's); ``heartbeat_s`` prints a progress line that
    often."""

    SEED_CHUNK = 1 << 15

    def __init__(
        self,
        model,
        n_devices: Optional[int] = None,
        invariants: Optional[Tuple[str, ...]] = None,
        check_deadlock: bool = True,
        sub_batch: int = 1024,
        expand_chunk: Optional[int] = None,
        visited_cap: int = 1 << 14,
        max_states: int = 1 << 26,
        time_budget_s: Optional[float] = None,
        progress: bool = False,
        metrics_path: Optional[str] = None,
        group: int = 4,
        flush_factor: int = 1,
        fp_bits: Optional[int] = None,
        route_slack: float = 1.5,
        append_chunk: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 5,
        n_slices: int = 1,
        device=None,
        visited_impl: str = "fpset",
        compact_impl: str = "logshift",
        telemetry=None,
        heartbeat_s: Optional[float] = None,
    ):
        if visited_impl not in ("fpset", "sort"):
            raise ValueError(
                f"visited_impl must be fpset|sort: {visited_impl}")
        self.visited_impl = visited_impl
        self.sorted = visited_impl == "sort"
        self.compact_impl = validate_impl(compact_impl)
        self.model = model
        self.layout = model.layout
        if invariants is None:
            invariants = model.default_invariants
        self.invariant_names = tuple(invariants)
        model_invs = getattr(model, "invariants", {})
        if ("__EvalError__" in model_invs
                and "__EvalError__" not in self.invariant_names):
            self.invariant_names += ("__EvalError__",)
        unknown = [n for n in self.invariant_names if n not in model_invs]
        if unknown:
            raise ValueError(f"unknown invariant(s): {unknown}")
        self.check_deadlock = check_deadlock
        if n_devices is None:
            n_devices = (len(device) if isinstance(device, (list, tuple))
                         else 1 if device is not None
                         else max(torch.cuda.device_count(), 1))
        if n_slices < 1 or n_devices % n_slices:
            raise ValueError("n_devices must be divisible by n_slices")
        self.mesh = mesh_mod.make_mesh2d(n_slices, n_devices // n_slices,
                                         device)
        self.device = self.mesh.devices[0]
        self.N, self.D, self.I = self.mesh.N, self.mesh.D, self.mesh.I
        self._axes = self.mesh.axes
        # gid = shard << SB | local stays a positive int32
        self.SB = 30 - max(0, (self.N - 1).bit_length())
        if self.SB < 16:
            raise ValueError("too many shards for the global-gid encoding")
        self.A = model.A
        self.W = self.layout.W
        self.G = sub_batch
        self.Fi = expand_chunk or min(sub_batch, 8192)
        if self.G % self.Fi:
            raise ValueError("sub_batch must be a multiple of expand_chunk")
        self.NCs = self.G * self.A  # candidate lanes a shard a round
        self.route_slack = route_slack
        self.FLUSH = flush_factor
        self.SL = append_chunk or (1 << 14)
        self._calc_route()
        self.keys = KeySpec(self.layout.total_bits, self.W, fp_bits)
        self.K = self.keys.ncols
        self.VCAP = self._round_cap(visited_cap)
        self.TCAP = 2 * self.VCAP
        self.SCAP = max_states
        self.LCAP = max(
            min(
                self._round_cap(max(visited_cap, self.NCs)),
                max(max_states // self.N, self.NCs) + self.APAD,
            ),
            self.APAD,
        )
        if self.LCAP > 1 << self.SB:
            raise ValueError("per-shard store exceeds local-gid bits")
        if self.ACAP * self.W >= 1 << 31 or self.LCAP * self.W >= 1 << 31:
            raise ValueError("flat buffers exceed int32 addressing")
        self.time_budget_s = time_budget_s
        self.progress = progress
        self.metrics_path = metrics_path
        self.group0 = group
        self.group = group
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.rec = recovery.RecoveryState(checkpoint_path)
        self._watcher = None
        self.last_stats: Dict[str, object] = {}
        self.last_bufs: Dict[str, list] = {}
        self.last_stats_matrix = None
        self.last_level1_counts = None
        # level number -> every shard's state count when it ended
        self.level_shard_totals: Dict[int, List[int]] = {}
        self._last_fpm = None
        # telemetry (``obs/telemetry.py``): the stream a run, and the
        # heartbeat from the last fetch's snapshot
        self._telemetry_arg = telemetry
        self.heartbeat_s = heartbeat_s
        self.tel = obs.NULL
        self._run_id: Optional[str] = None
        self._snap: Dict[str, object] = {}

    # -------------------------------------------------------- capacities

    @property
    def _hbm_recovered(self) -> int:
        return self.rec.hbm_recovered

    @property
    def _headroom_frozen(self) -> bool:
        return self.rec.headroom_frozen

    def _calc_route(self) -> None:
        """Every size that depends on ``route_slack`` (re-derived after a
        route overflow): the owner-side accumulator ``ACAP`` of ``FLUSH``
        received windows of ``RCV`` lanes, the producer-side one
        ``PACAP``, and the append window ``APAD``."""
        if self.N == 1:
            # one shard: no routing, no slack (the lanes go straight to
            # the accumulator)
            self.CAPO = self.NCs
            self.RCV = self.NCs
        elif len(self._axes) == 1:
            self.CAPO = int(-(-self.NCs * self.route_slack // self.N))
            self.RCV = self.N * self.CAPO
        else:
            # expected fills NCs / D (to the owner slice) and NCs / I
            # (to the owner chip within it)
            self.CAPD = int(-(-self.NCs * self.route_slack // self.D))
            self.CAPO2 = int(-(-self.NCs * self.route_slack // self.I))
            self.RCV = self.I * self.CAPO2
        self.ACAP = self.RCV * self.FLUSH
        self.PACAP = self.NCs * self.FLUSH
        self.SLc = min(self.SL, self.PACAP)
        self.C = -(-self.PACAP // self.SLc)
        self.APAD = self.C * self.SLc

    @staticmethod
    def _round_cap(c: int) -> int:
        n = 1 << 10
        while n < c:
            n <<= 1
        return n

    def _log(self, msg: str) -> None:
        if self.progress:
            print(f"  {msg}", file=sys.stderr, flush=True)

    # ----------------------------------------------------------- buffers

    def _alloc_acc(self) -> None:
        """(Re)allocate every shard's accumulators: the owner-side keys
        ``[K, ACAP]`` and the producer-side rows, parents, lanes and
        return addresses at ``PACAP`` (and the 2-D stage-2 slot map)."""
        K, W = self.K, self.W
        self._ak, self._arows, self._apar, self._alane = [], [], [], []
        self._aq, self._aq2 = [], []
        # the end of the lanes each producer wrote since its last flush
        # (a prefix: rounds are full up to a shard's last one)
        self._acc_hi = [0] * self.N
        self._empty = {}
        for dev in self.mesh.devices:
            self._ak.append(torch.full((K, self.ACAP), SENTINEL,
                                       dtype=torch.int32, device=dev))
            self._arows.append(torch.zeros((self.PACAP, W),
                                           dtype=torch.int32, device=dev))
            self._apar.append(torch.zeros((self.PACAP,), dtype=torch.int32,
                                          device=dev))
            self._alane.append(torch.zeros_like(self._apar[-1]))
            self._aq.append(torch.full((self.PACAP,), -1,
                                       dtype=torch.int32, device=dev))
            n2 = (self.FLUSH * self.D * self.CAPD
                  if len(self._axes) == 2 else 1)
            self._aq2.append(torch.full((n2,), -1, dtype=torch.int32,
                                        device=dev))

    def _zero_state(self) -> None:
        """Fresh per-shard device counters: the state and key counts, the
        deadlock and violation gids, the route-overflow flag, the flush
        metrics and the rehash-failure count."""
        n_inv = len(self.invariant_names)
        self._nvis, self._nkeys, self._dead, self._viol = [], [], [], []
        self._ovf, self._fpm, self._rfail = [], [], []
        for dev in self.mesh.devices:
            z = torch.zeros((), dtype=torch.int64, device=dev)
            self._nvis.append(z)
            self._nkeys.append(z.clone())
            self._dead.append(torch.full((), BIG, dtype=torch.int64,
                                         device=dev))
            self._viol.append(torch.full((n_inv,), BIG, dtype=torch.int64,
                                         device=dev))
            self._ovf.append(torch.zeros((), dtype=torch.bool, device=dev))
            self._fpm.append(torch.zeros((FPM_N,), dtype=torch.int64,
                                         device=dev))
            self._rfail.append(z.clone())

    def _alloc(self) -> None:
        """A fresh run's tensors on every shard."""
        self._vk, self._claims = [], []
        self._rows, self._parent, self._lane = [], [], []
        for dev in self.mesh.devices:
            self._vk.append(self._empty_visited(dev))
            self._claims.append(None if self.sorted
                                else fpset.new_claims(self.TCAP, dev))
            self._rows.append(torch.zeros((self.LCAP, self.W),
                                          dtype=torch.int32, device=dev))
            self._parent.append(torch.zeros((self.LCAP,), dtype=torch.int32,
                                            device=dev))
            self._lane.append(torch.zeros((self.LCAP,), dtype=torch.int32,
                                          device=dev))
        self._alloc_acc()
        self._zero_state()

    def _free_buffers(self) -> None:
        """Drop every shard's tensors (before a rebuild from a frame)."""
        for attr in ("_vk", "_claims", "_rows", "_parent", "_lane", "_ak",
                     "_arows", "_apar", "_alane", "_aq", "_aq2", "_nvis",
                     "_nkeys", "_dead", "_viol", "_ovf", "_fpm", "_rfail"):
            setattr(self, attr, None)
        self.last_bufs = {}
        gc.collect()
        for dev in self.mesh.distinct_devices():
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    torch.cuda.empty_cache()

    # ------------------------------------------------------------ growth

    def _empty_visited(self, dev, n: Optional[int] = None):
        """A shard's empty visited set: the table of ``TCAP`` slots, or
        ``n`` (default ``VCAP``) SENTINEL slots of sorted columns."""
        if not self.sorted:
            return fpset.empty_cols(self.TCAP, self.K, dev)
        return tuple(torch.full((self.VCAP if n is None else n,), SENTINEL,
                                dtype=torch.int32, device=dev)
                     for _ in range(self.K))

    def _grow_visited(self, need: int) -> None:
        """Double every shard's table (a rehash through H1 on the card)
        until ``need`` keys fit at load <= 1/2; the failure counts are
        read with the next fetch.  Sorted columns are padded instead."""
        if self.sorted:
            cap = self._round_cap(max(need, self.VCAP))
            if cap > self.VCAP:
                for s, dev in enumerate(self.mesh.devices):
                    pad = self._empty_visited(dev, cap - self.VCAP)
                    self._vk[s] = tuple(torch.cat([c, p]) for c, p in
                                        zip(self._vk[s], pad))
                self.VCAP, self.TCAP = cap, 2 * cap
            return
        while self.VCAP < need:
            cap = 2 * self.TCAP
            for s, dev in enumerate(self.mesh.devices):
                claims = fpset.new_claims(cap, dev)
                new, failed = fpset.rehash_cols(
                    self._vk[s], fpset.empty_cols(cap, self.K, dev),
                    claims=claims,
                )
                self._vk[s], self._claims[s] = new, claims
                self._rfail[s] = self._rfail[s] + failed
            self.TCAP = cap
            self.VCAP = cap // 2
            self._log(f"visited tables grown to {cap} slots a shard")

    def _grow_store(self, need: int) -> None:
        """Grow every shard's row store and logs to hold ``need`` states
        (doubling toward ``max_states / N`` plus a window; after a
        device-memory recovery, to exactly ``need``)."""
        cap = max(self.SCAP // self.N + self.APAD, self.NCs + self.APAD)
        while self.LCAP < need:
            pad = min(self.LCAP, max(cap - self.LCAP, need - self.LCAP))
            if self.rec.headroom_frozen:
                pad = need - self.LCAP
            new = self.LCAP + pad
            if new > 1 << self.SB:
                raise ValueError("per-shard store exceeds local-gid bits")
            for s in range(self.N):
                self._rows[s] = _grown(self._rows[s], new)
                self._parent[s] = _grown(self._parent[s], new)
                self._lane[s] = _grown(self._lane[s], new)
            self.LCAP = new

    def _grow_route(self) -> None:
        """Recover from a route overflow: double ``route_slack``, re-derive
        the capacities, reallocate the accumulators and clear the flags;
        the caller retries the level (its appended states dedup to
        no-ops)."""
        self.route_slack *= 2.0
        self._calc_route()
        if self.ACAP * self.W >= 1 << 31:
            raise RuntimeError(
                "routing overflow recovery exceeded int32 flat "
                "addressing; reduce sub_batch"
            )
        self._alloc_acc()
        for s, dev in enumerate(self.mesh.devices):
            self._ovf[s] = torch.zeros((), dtype=torch.bool, device=dev)
        self._log(f"routing overflow: retrying with route_slack="
                  f"{self.route_slack} (ACAP={self.ACAP})")

    # --------------------------------------------------- one round's work

    def _pad_keys(self, kc, n: int, dev) -> Optional[torch.Tensor]:
        """``n`` lanes of K key columns in a SENTINEL-padded ``[K, NCs]``
        block (the JAX round's full window: padding lanes are invalid and
        never routed); None for a shard with no lanes this round."""
        if not n:
            return None
        out = torch.full((self.K, self.NCs), SENTINEL, dtype=torch.int32,
                         device=dev)
        out[:, :n] = torch.stack(kc)
        return out

    def _empty_block(self, s: int, shape, owner_col: bool = False):
        """A shard's all-SENTINEL routing block (an idle producer's; with
        the 2-D stage-1 owner column at 0), made once a shape."""
        key = (s, shape, owner_col)
        if key not in self._empty:
            t = torch.full(shape, SENTINEL, dtype=torch.int32,
                           device=self.mesh.devices[s])
            if owner_col:
                t[:, -1] = 0
            self._empty[key] = t
        return self._empty[key]

    def _store_producer(self, s: int, w: int, packed, par, lane) -> None:
        p_off = w * self.NCs
        n = packed.shape[0]
        if n:
            self._arows[s][p_off: p_off + n] = packed
            self._apar[s][p_off: p_off + n] = par.to(torch.int32)
            self._alane[s][p_off: p_off + n] = lane.to(torch.int32)
            self._acc_hi[s] = max(self._acc_hi[s], p_off + n)

    def _expand_shard(self, s: int, r: int, w: int, lb: int, nf: int):
        """Shard ``s``'s part of expand round ``r`` into accumulator window
        ``w``: rows ``[lb + r*G, ...)`` of its frontier of ``nf`` (host
        ints), their lanes keyed by K2; returns the padded key block."""
        dev = self.mesh.devices[s]
        A, W, m = self.A, self.W, self.model
        f_off = r * self.G
        n = max(0, min(self.G, nf - f_off))
        kparts, pparts, parparts, laneparts = [], [], [], []
        for c in range(0, n, self.Fi):
            nc = min(self.Fi, n - c)
            base = lb + f_off + c
            states = self.layout.unpack(self._rows[s][base: base + nc])
            succ, valid = m.successors(states)
            packed = self.layout.pack(succ).reshape(nc * A, W)
            kparts.append(tiles.key_plane(self.keys, packed,
                                          valid.reshape(-1)))
            pos = (s << self.SB) | (base + torch.arange(nc, device=dev))
            pparts.append(packed)
            parparts.append(pos[:, None].expand(nc, A).reshape(-1))
            laneparts.append(torch.arange(A, device=dev).repeat(nc))
            if self.check_deadlock:
                dead = ~valid.any(dim=1) & ~m.stutter_enabled(states)
                d = torch.where(dead, pos, BIG).amin()
                self._dead[s] = torch.minimum(self._dead[s], d)
        if not n:
            return None
        kc = tuple(torch.cat(p) for p in zip(*kparts))
        self._store_producer(s, w, torch.cat(pparts), torch.cat(parparts),
                             torch.cat(laneparts))
        return self._pad_keys(kc, n * A, dev)

    def _init_shard(self, s: int, base: int, w: int):
        """Shard ``s``'s part of an initial-state round: init indices
        ``base + s + i*N`` (striped, so the roots spread over the
        shards), logged with parent ``-1 - idx``."""
        dev = self.mesh.devices[s]
        N, n_init = self.N, self.model.n_initial
        start = base + s
        n = 0 if start >= n_init else min(self.NCs,
                                          -(-(n_init - start) // N))
        if not n:
            return None
        idx = start + torch.arange(n, device=dev) * N
        packed = self.layout.pack(self.model.gen_initial(idx))
        kc = tiles.key_plane(self.keys, packed,
                             torch.ones((n,), dtype=torch.bool, device=dev))
        self._store_producer(s, w, packed, -1 - idx, torch.zeros_like(idx))
        return self._pad_keys(kc, n, dev)

    def _route(self, kblocks, w: int) -> None:
        """Route every shard's ``[K, NCs]`` key block of window ``w`` to
        the owners' accumulators (one exchange on a 1-D mesh, two on a
        2-D one) and save each lane's return address.  A None block (a
        shard with no lanes this round) sends SENTINEL blocks."""
        K, N, NCs = self.K, self.N, self.NCs
        o_off, p_off = w * self.RCV, w * NCs
        self._routed_bytes += self._route_round_bytes()
        if N == 1:
            # every lane is home: the flags are consumed in place
            win = self._ak[0][:, o_off: o_off + NCs]
            if kblocks[0] is None:
                win.fill_(SENTINEL)
            else:
                win.copy_(kblocks[0])
            return
        mesh = self.mesh
        if len(self._axes) == 1:
            send = []
            for s, kb in enumerate(kblocks):
                if kb is None:
                    send.append(self._empty_block(s, (N, K, self.CAPO)))
                    continue
                kc = tuple(kb.unbind(0))
                valid = ~fpset.all_sentinel(kc)
                outs, q, over = bucket_scatter(
                    owner_of(kc, N), N, self.CAPO, valid, kc, [SENTINEL] * K)
                send.append(torch.stack(outs).reshape(K, N, self.CAPO)
                            .transpose(0, 1))
                self._aq[s][p_off: p_off + NCs] = q.to(torch.int32)
                self._ovf[s] = self._ovf[s] | over
            recv = mesh.all_to_all(send)
            for d in range(N):
                self._ak[d][:, o_off: o_off + self.RCV] = (
                    recv[d].transpose(0, 1).reshape(K, self.RCV))
            return
        D, I, CAPD, CAPO2 = self.D, self.I, self.CAPD, self.CAPO2
        send1 = []
        for s, kb in enumerate(kblocks):
            if kb is None:
                send1.append(self._empty_block(s, (D, K + 1, CAPD), True))
                continue
            kc = tuple(kb.unbind(0))
            valid = ~fpset.all_sentinel(kc)
            owner = owner_of(kc, D * I)
            outs, q1, over = bucket_scatter(
                owner // I, D, CAPD, valid,
                list(kc) + [owner.to(torch.int32)], [SENTINEL] * K + [0])
            send1.append(torch.stack(outs).reshape(K + 1, D, CAPD)
                         .transpose(0, 1))
            self._aq[s][p_off: p_off + NCs] = q1.to(torch.int32)
            self._ovf[s] = self._ovf[s] | over
        r1 = mesh.all_to_all(send1, mesh_mod.DCN_AXIS)
        send2 = []
        for s in range(N):
            got = r1[s].transpose(0, 1).reshape(K + 1, D * CAPD)
            k1 = tuple(got[:K].unbind(0))
            v1 = ~fpset.all_sentinel(k1)
            outs, q2, over = bucket_scatter(
                got[K].to(torch.int64) % I, I, CAPO2, v1, k1, [SENTINEL] * K)
            send2.append(torch.stack(outs).reshape(K, I, CAPO2)
                         .transpose(0, 1))
            dc = D * CAPD
            self._aq2[s][w * dc: (w + 1) * dc] = q2.to(torch.int32)
            self._ovf[s] = self._ovf[s] | over
        r2 = mesh.all_to_all(send2, mesh_mod.ICI_AXIS)
        for d in range(N):
            self._ak[d][:, o_off: o_off + self.RCV] = (
                r2[d].transpose(0, 1).reshape(K, self.RCV))

    def _route_round_bytes(self) -> int:
        """Key-plane bytes one routing round moves between shards (each
        shard's block to itself excluded)."""
        if self.N == 1:
            return 0
        if len(self._axes) == 1:
            return self.N * (self.N - 1) * self.K * self.CAPO * 4
        return (self.N * (self.D - 1) * (self.K + 1) * self.CAPD * 4
                + self.N * (self.I - 1) * self.K * self.CAPO2 * 4)

    def _flags_back_bytes(self) -> int:
        if self.N == 1:
            return 0
        if len(self._axes) == 1:
            return self.N * (self.N - 1) * self.FLUSH * self.CAPO
        return (self.N * (self.I - 1) * self.FLUSH * self.CAPO2
                + self.N * (self.D - 1) * self.FLUSH * self.CAPD)

    # ------------------------------------------------------------ flush

    def _flush_keys(self, n_acc: int, need=None) -> List[torch.Tensor]:
        """Every owner's flush of its first ``n_acc`` accumulated lanes
        into its table (K1 + H1 on the card), then the flags' way back:
        returns each producer's new flags in its accumulator order (None
        for a producer ``need`` leaves out)."""
        N, FLUSH = self.N, self.FLUSH
        if need is None:
            need = [True] * N
        own = []
        for s in range(N):
            kc = tuple(self._ak[s].unbind(0))
            if self.sorted:
                self._vk[s], n_new, is_new = merge_lanes(self._vk[s], kc,
                                                         n_acc)
            else:
                self._vk[s], n_new, is_new, self._fpm[s] = \
                    tiles.flush_tiles(self._vk[s], kc, n_acc, self._fpm[s],
                                      self._claims[s])
            self._nkeys[s] = self._nkeys[s] + n_new
            own.append(is_new)
        if N == 1:
            return own  # PACAP == ACAP, the same order
        mesh = self.mesh
        self._routed_bytes += self._flags_back_bytes()
        if len(self._axes) == 1:
            recv = mesh.all_to_all(
                [f.reshape(FLUSH, N, self.CAPO).transpose(0, 1) for f in own])
            return [flag_gather(recv[p].reshape(-1), self._aq[p], FLUSH,
                                self.CAPO, self.NCs) if need[p] else None
                    for p in range(N)]
        D, I, CAPD, CAPO2 = self.D, self.I, self.CAPD, self.CAPO2
        recv_i = mesh.all_to_all(
            [f.reshape(FLUSH, I, CAPO2).transpose(0, 1) for f in own],
            mesh_mod.ICI_AXIS)
        dc = D * CAPD
        send = []
        for s in range(N):
            aq2 = self._aq2[s].to(torch.int64)
            r = torch.arange(FLUSH * dc, device=aq2.device) // dc
            ok = aq2 >= 0
            idx = (aq2 // CAPO2) * (FLUSH * CAPO2) + r * CAPO2 + aq2 % CAPO2
            fl1 = torch.where(ok, recv_i[s].reshape(-1)[torch.where(ok, idx,
                                                                    0)],
                              False)
            send.append(fl1.reshape(FLUSH, D, CAPD).transpose(0, 1))
        recv = mesh.all_to_all(send, mesh_mod.DCN_AXIS)
        return [flag_gather(recv[p].reshape(-1), self._aq[p], FLUSH, CAPD,
                            self.NCs) if need[p] else None
                for p in range(N)]

    def _flush(self, n_acc: int) -> None:
        """Flush, compact and append: every producer's new states go to
        its store blind at its device-held count, invariants checked on
        them.  Only a producer's written prefix of the accumulator (the
        host knows it) can hold new lanes, so the compaction, the append
        window and the invariants span that prefix; an idle producer
        does nothing."""
        self._flush_seq += 1
        kinds = faults.poll("flush", self._flush_seq)
        if "oom" in kinds:
            raise faults.oom_error("flush", self._flush_seq)
        if "fpset_fail" in kinds:
            # one synthetic dropped lane on one shard: the next fetch
            # fail-stops as on a real probe overflow
            self._fpm[0] = self._fpm[0] + torch.tensor(
                [0, 0, 1, 0, 0], dtype=torch.int64, device=self.device)
        hi = self._acc_hi
        self._acc_hi = [0] * self.N
        flags = self._flush_keys(n_acc, [h > 0 for h in hi])
        m = self.model
        for p, flag in enumerate(flags):
            if flag is None:
                continue
            dev, h = self.mesh.devices[p], hi[p]
            flag = flag[:h]
            (crows, cpar, clane), _ = compact_by_flag(
                ~flag, (self._arows[p][:h], self._apar[p][:h],
                        self._alane[p][:h]), self.compact_impl)
            self._compact_n += 1
            n_new = flag.sum()
            nv = self._nvis[p]
            pos = torch.arange(h, device=dev)
            dest = nv + pos
            self._rows[p].index_copy_(0, dest, crows)
            self._parent[p].index_copy_(0, dest, cpar)
            self._lane[p].index_copy_(0, dest, clane)
            if self.invariant_names:
                states = self.layout.unpack(crows)
                old = pos >= n_new
                bad = torch.stack([
                    torch.where(m.invariants[name](states) | old, BIG,
                                pos).amin()
                    for name in self.invariant_names
                ])
                self._viol[p] = torch.minimum(
                    self._viol[p],
                    torch.where(bad < BIG, (p << self.SB) | (nv + bad), BIG))
            self._nvis[p] = nv + n_new
        self._flushes += 1

    # ------------------------------------------------------------ fetch

    def _fetch(self) -> np.ndarray:
        """One host read of every shard's counters: the ``[N, 4 + n_inv +
        FPM_N]`` stats matrix (state count, owned keys, deadlock gid,
        violation gids, route-overflow flag, flush metrics).  Raises
        :class:`_RouteOverflow` on a route overflow and RuntimeError on a
        probe or rehash overflow."""
        t = time.time()
        dev0 = self.device
        rows = [
            torch.cat([
                self._nvis[s].view(1), self._nkeys[s].view(1),
                self._dead[s].view(1), self._viol[s],
                self._ovf[s].view(1).to(torch.int64), self._fpm[s],
                self._rfail[s].view(1),
            ]).to(dev0, non_blocking=True)
            for s in range(self.N)
        ]
        out = torch.stack(rows).cpu().numpy()
        self._host_wait_s += time.time() - t
        self._fetch_n += 1
        rfail, out = out[:, -1], out[:, :-1]
        n_inv = len(self.invariant_names)
        if rfail.any():
            raise RuntimeError(
                f"visited-table rehash overflow ({int(rfail.sum())})")
        if out[:, 3 + n_inv].any():
            raise _RouteOverflow
        self._last_fpm = out[:, 4 + n_inv:]
        self._took_stats(out)
        if self._last_fpm[:, 2].any():
            raise RuntimeError(
                "fpset probe overflow on "
                f"{int((self._last_fpm[:, 2] > 0).sum())} shard(s) — a "
                "table broke its load contract"
            )
        return out

    def _took_stats(self, out: np.ndarray) -> None:
        """A fetch's host matrix: refresh the heartbeat snapshot and
        write one ``flush`` record (the shards' flush metrics summed, the
        deepest probe's max; deltas since the last) and one ``compact``
        record — host arithmetic on the values just read."""
        nv = int(out[:, 0].sum())
        occ = float(out[:, 1].max()) / max(self.TCAP, 1)
        self._snap["distinct_states"] = nv
        self._snap["occupancy"] = occ
        if not self.tel.enabled:
            return
        fpm = self._last_fpm
        cur = [int(fpm[:, i].sum()) for i in range(4)] + [
            int(fpm[:, 4].max())]
        d = [a - b for a, b in zip(cur, self._fpm_prev)]
        if d[0] > 0:
            self._fpm_prev = cur
            self.tel.emit(
                "flush",
                flushes=d[0],
                probe_rounds=d[1],
                failures=d[2],
                valid_lanes=d[3],
                avg_probe_rounds=round(d[1] / max(d[0], 1), 2),
                max_probe_rounds=cur[4],
                occupancy=round(occ, 4),
                distinct_states=nv,
            )
        if self._compact_n > self._compact_prev:
            self.tel.emit("compact",
                          dispatches=self._compact_n - self._compact_prev,
                          impl=self.compact_impl)
            self._compact_prev = self._compact_n

    def _emit_header(self, resume: bool) -> None:
        obs.emit_header(
            self.tel, self.device, resume, self._resume_meta,
            engine="sharded_device",
            n_devices=self.N,
            n_slices=self.D,
            visited_impl=self.visited_impl,
            compact_impl=self.compact_impl,
            config_sig=self._config_sig(),
            mode="check",
            max_states=self.SCAP,
            sub_batch=self.G,
            flush_factor=self.FLUSH,
            key_cols=self.K,
            key_exact=bool(self.keys.exact),
            invariants=list(self.invariant_names),
        )

    # --------------------------------------------------------------- run

    def run(self, resume: bool = False, seed=None) -> CheckerResult:
        """Check the model.  ``resume=True`` continues the
        ``checkpoint_path`` frame; ``seed`` is a host-enumerated BFS
        prefix ``(packed rows uint32 [n, W], parent gids, action lanes,
        level sizes)`` loaded before the first level."""
        self.rec.reset()
        self.group = self.group0
        self._ckpt_frames = self._ckpt_bytes = self._ckpt_retries = 0
        self._ckpt_write_s = 0.0
        self._bufs_poisoned = False
        self._flush_seq = 0
        self._fpm_prev = [0] * FPM_N
        self._compact_n = self._compact_prev = 0
        self._resume_meta: Dict[str, object] = {}
        ckpt.cleanup_stale_tmp(self.checkpoint_path)
        watcher = ckpt.PreemptionWatcher(
            enabled=bool(self.checkpoint_path), log=self._log)
        self._watcher = watcher
        with obs.run_scope(self, self._telemetry_arg, self.heartbeat_s,
                           self.SCAP):
            try:
                with watcher:
                    return self._run(resume, seed)
            finally:
                self._watcher = None

    def _run(self, resume: bool, seed) -> CheckerResult:
        t0 = time.time()
        self._budget_t0 = t0
        self._host_wait_s = 0.0
        self._fetch_n = self._flushes = self._routed_bytes = 0
        self.level_route_bytes: List[int] = []
        self.level_shard_totals = {}
        for dev in self.mesh.distinct_devices():
            if dev.type == "cuda":
                # K0 on each card (builds and loads the kernels once)
                kernels.selftest(dev)
        if resume:
            if not self.checkpoint_path:
                raise ValueError("resume requires checkpoint_path")
            level_sizes, lb, nf, wall = self._restore()
            t0 = time.time() - wall
            self.rec.arm()  # the frame on disk is valid
            metrics.rewind(self.metrics_path, len(level_sizes))
            self._emit_header(resume=True)
            return self._run_levels(t0, level_sizes, lb, nf)
        self._emit_header(resume=False)
        self._alloc()
        if seed is not None:
            level_sizes, lb, nf = self._load_seed(seed)
            stats = self._fetch()
            fv = self._first_viol(stats)
            if fv is not None:
                # a violation inside the seed: the diameter is its level
                gid = fv[1]
                i = ((gid & ((1 << self.SB) - 1)) * self.N
                     + (gid >> self.SB))
                cum = 0
                for li, cnt in enumerate(level_sizes):
                    cum += cnt
                    if i < cum:
                        level_sizes = level_sizes[: li + 1]
                        break
            return self._run_levels(t0, level_sizes, lb, nf, stats=stats)
        # level 1's fault site (the loop's count starts at 2)
        if "oom" in faults.poll("level", 1):
            raise faults.oom_error("level", 1)
        n_init = self.model.n_initial
        if n_init > self.SCAP:
            raise ValueError("initial-state set exceeds max_states")
        while True:
            try:
                stats = self._init_level(n_init)
                break
            except _RouteOverflow:
                # the whole init set again at doubled capacity: the
                # states inserted already dedup to no-ops
                self._grow_route()
        nv = stats[:, 0].copy()
        level_sizes = [int(nv.sum())]
        self.last_level1_counts = nv.copy()
        self.level_shard_totals[1] = nv.tolist()
        self._log(f"level 1: {level_sizes[0]} initial states on "
                  f"{self.N} shards")
        return self._run_levels(t0, level_sizes, np.zeros((self.N,),
                                                          np.int64),
                                nv.copy(), stats=stats)

    def _init_level(self, n_init: int) -> np.ndarray:
        per_round = self.N * self.NCs
        w, nk_hi, nv_hi = 0, 0, 0
        # host bounds of the owned keys and produced states (no reads)
        for base in range(0, n_init, per_round):
            self._route([self._init_shard(s, base, w)
                         for s in range(self.N)], w)
            w += 1
            if w == self.FLUSH or base + per_round >= n_init:
                nk_hi += self.ACAP
                nv_hi += self.PACAP
                self._grow_visited(nk_hi)
                self._grow_store(nv_hi + self.APAD)
                self._flush(w * self.RCV)
                w = 0
        return self._fetch()

    # ------------------------------------------------------- the levels

    def _run_levels(self, t0, level_sizes, lb, nf, stats=None):
        """The level loop under the recovery contract: device memory
        running out with a valid frame on disk frees every shard's
        tensors, rebuilds from the frame at degraded capacity (headroom
        frozen, group halved) and goes on; without one, or when the
        rebuild runs out too, the run stops with ``hbm``."""
        while True:
            try:
                return self._level_loop(t0, level_sizes, lb, nf, stats)
            except recovery.HbmExhausted as hx:
                last = (hx.nv, hx.level_sizes, hx.msg)
                hx.__context__ = None
            # outside the except block: its traceback pins the tensors
            self.rec.degrade()
            self.group = max(1, self.group // 2)
            self.tel.emit("hbm_recovery", recovery_n=self._hbm_recovered,
                          group=self.group, distinct_states=last[0],
                          error=last[2][:200])
            self._log(
                "device memory exhausted on the mesh: recovering from the "
                f"last checkpoint frame (recovery #{self._hbm_recovered}, "
                f"group={self.group}) — {last[2][:120]}"
            )
            self._free_buffers()
            try:
                level_sizes, lb, nf, _w = self._restore()
                stats = self._fetch()
            except Exception as e:  # noqa: BLE001
                if not recovery.is_resource_exhausted(e):
                    raise
                self._bufs_poisoned = True
                return self._hbm_result(t0, last[0], last[1])

    def _hbm_result(self, t0, nv: int, level_sizes) -> CheckerResult:
        n_inv = len(self.invariant_names)
        stats = np.zeros((self.N, 4 + n_inv + FPM_N), np.int64)
        stats[:, 2] = BIG
        stats[:, 3: 3 + n_inv] = BIG
        stats[0, 0] = nv
        return self._result(t0, stats, level_sizes, truncated=True,
                            stop_reason="hbm")

    def _level_loop(self, t0, level_sizes, lb, nf, stats=None):
        if stats is None:
            try:
                stats = self._fetch()
            except Exception as e:  # noqa: BLE001
                if not recovery.is_resource_exhausted(e):
                    raise
                if self.rec.can_recover():
                    raise recovery.HbmExhausted(
                        0, list(level_sizes), repr(e)) from None
                self._bufs_poisoned = True
                return self._hbm_result(t0, 0, list(level_sizes))
        nv = stats[:, 0].copy()
        while True:
            reason = self._stop_reason(stats, t0)
            if reason is not None and not (reason.get("truncated")
                                           and nf.sum() == 0):
                if reason.get("truncated"):
                    self._save_checkpoint(level_sizes, lb, nf, t0)
                return self._result(t0, stats, level_sizes, **reason)
            if nf.sum() == 0:
                return self._result(t0, stats, level_sizes)
            if self._watcher is not None and self._watcher.requested:
                self._save_checkpoint(level_sizes, lb, nf, t0)
                return self._result(t0, stats, level_sizes, truncated=True,
                                    stop_reason="preempted")
            routed0 = self._routed_bytes
            try:
                level = len(level_sizes) + 1
                if "oom" in faults.poll("level", level):
                    raise faults.oom_error("level", level)
                stats, nv2, stop = self._run_one_level(t0, stats, nv, lb, nf)
            except _RouteOverflow:
                self._grow_route()
                stats = self._fetch()
                nv = stats[:, 0].copy()
                continue  # the same level at doubled capacity
            except Exception as e:  # noqa: BLE001
                if not recovery.is_resource_exhausted(e):
                    raise
                if self.rec.can_recover():
                    raise recovery.HbmExhausted(
                        int(nv.sum()), list(level_sizes), repr(e)
                    ) from None
                self._log(f"device memory exhausted mid-level: truncating "
                          f"({e!r:.120})")
                self._bufs_poisoned = True
                return self._hbm_result(t0, int(nv.sum()), list(level_sizes))
            level_count = int((nv2 - (lb + nf)).sum())
            if level_count or stop:
                level_sizes.append(max(level_count, 0))
                self.level_route_bytes.append(self._routed_bytes - routed0)
                self._level_done(t0, level_sizes, int(nv2.sum()),
                                 int(nf.sum()))
            if stop:
                reason = self._stop_reason(stats, t0) or {"truncated": True}
                if reason.get("truncated"):
                    # rewind to the level boundary: the partial level
                    # re-derives on resume by dedup idempotence
                    self._save_checkpoint(level_sizes[:-1], lb, nf, t0)
                return self._result(t0, stats, level_sizes, **reason)
            self.level_shard_totals[len(level_sizes)] = nv2.tolist()
            lb = lb + nf
            nf = nv2 - lb
            nv = nv2
            if nf.sum() == 0 and level_count == 0:
                return self._result(t0, stats, level_sizes)
            if (self.checkpoint_path
                    and len(level_sizes) % self.checkpoint_every == 0):
                self._save_checkpoint(level_sizes, lb, nf, t0)

    def _run_one_level(self, t0, stats, nv, lb, nf):
        """Expand one level over every shard: rounds with no host read,
        a fetch every ``group`` flushes or when a bound needs one.
        Returns ``(stats, nv', stop)``."""
        self._grow_store(int((lb + nf).max()) + self.G)
        rounds = int(-(-int(nf.max()) // self.G))
        stop = False
        pending = w = 0
        # per-shard upper bounds under the flushes in flight: a flush
        # adds <= PACAP states to a producer, <= ACAP keys to an owner
        nv_bound = int(nv.max())
        nk_bound = int(stats[:, 1].max())
        for r in range(rounds):
            last = r + 1 >= rounds
            self._route([self._expand_shard(s, r, w, int(lb[s]), int(nf[s]))
                         for s in range(self.N)], w)
            w += 1
            if w < self.FLUSH and not last:
                continue
            nv_bound += self.PACAP
            nk_bound += self.ACAP
            need_sync = (
                nk_bound + self.ACAP > self.VCAP
                or nv_bound + self.APAD > self.LCAP
                # near the state cap, sync on the optimistic bound
                or nv_bound * self.N >= self.SCAP
                or pending >= self.group
            )
            if need_sync:
                stats = self._fetch()
                nv = stats[:, 0].copy()
                nv_bound = int(nv.max())
                nk_bound = int(stats[:, 1].max())
                pending = 0
                if self._stop_reason(stats, t0) is not None:
                    stop = True
                    break
                # headroom for a group of flushes in flight (one after a
                # device-memory recovery)
                frozen = self.rec.headroom_frozen
                head_k = self.ACAP * (1 if frozen else self.group + 1)
                head_p = self.PACAP * (1 if frozen else self.group + 1)
                if nk_bound + head_k > self.VCAP:
                    self._grow_visited(nk_bound + head_k)
                if nv_bound + head_p + self.APAD > self.LCAP:
                    # never past what the state cap (plus one flush) can
                    # use: the global cap, since producers can be skewed
                    self._grow_store(
                        min(nv_bound + head_p, self.SCAP + self.PACAP)
                        + self.APAD)
            self._flush(w * self.RCV)
            pending += 1
            w = 0
        stats = self._fetch()
        return stats, stats[:, 0].copy(), stop

    def _level_done(self, t0, level_sizes, total: int,
                    frontier: int) -> None:
        """The level's log line, ``level`` record and ``metrics_path``
        record (``frontier``: the frontier expanded into it)."""
        wall = time.time() - t0
        self._snap.update(level=len(level_sizes), distinct_states=total,
                          frontier=frontier)
        self.tel.emit(
            "level",
            level=len(level_sizes),
            new_states=int(level_sizes[-1]),
            distinct_states=total,
            frontier=frontier,
            wall_s=round(wall, 3),
            states_per_sec=round(total / max(wall, 1e-9), 1),
            host_wait_s=round(self._host_wait_s, 3),
        )
        self._log(f"level {len(level_sizes)}: +{level_sizes[-1]} (total "
                  f"{total}, {total / max(wall, 1e-9):.0f} st/s)")
        metrics.append(self.metrics_path, {
            "level": len(level_sizes),
            "new_states": int(level_sizes[-1]),
            "distinct_states": total,
            "wall_s": round(wall, 3),
            "host_wait_s": round(self._host_wait_s, 3),
            "states_per_sec": round(total / max(wall, 1e-9), 1),
            "n_shards": self.N,
        })

    # ---------------------------------------------------------- control

    def _over_time(self) -> bool:
        return (self.time_budget_s is not None
                and time.time() - self._budget_t0 > self.time_budget_s)

    def _stop_reason(self, stats, t0) -> Optional[dict]:
        fv = self._first_viol(stats)
        if fv is not None:
            return {"viol": fv}
        dead = stats[:, 2]
        if (dead < BIG).any():
            return {"dead_gid": int(dead.min())}
        if stats[:, 0].sum() >= self.SCAP:
            return {"truncated": True, "stop_reason": "max_states"}
        if self._over_time():
            return {"truncated": True, "stop_reason": "time_budget"}
        return None

    def _first_viol(self, stats) -> Optional[Tuple[str, int]]:
        """The lowest-global-gid violation across shards (``shard << SB |
        local``: within a level, low shards first — a different, equally
        short trace than the single-device engine may pick)."""
        best = None
        for i, name in enumerate(self.invariant_names):
            g = int(stats[:, 3 + i].min())
            if g < BIG and (best is None or g < best[1]):
                best = (name, g)
        return best

    # ------------------------------------------------------ seeded start

    def _load_seed(self, seed):
        """Load a host-enumerated BFS prefix: state ``i`` goes to shard
        ``i % N`` at local ``i // N`` (levels stay contiguous in every
        store), parent gids are remapped to ``shard << SB | local``, the
        invariants run on the seed, and its keys go to their owners
        through the routed flush (no append).  Returns ``(level_sizes,
        lb, nf)``."""
        rows, parents, lanes, lsizes = seed
        rows = np.ascontiguousarray(rows, np.uint32).reshape(-1, self.W)
        n, N = rows.shape[0], self.N
        if sum(lsizes) != n:
            raise ValueError("seed level sizes do not sum to the count")
        if n > self.SCAP:
            raise ValueError(f"seed too large ({n} states)")
        par = np.asarray(parents, np.int64)
        mask = par >= 0
        par_new = par.copy()
        par_new[mask] = ((par[mask] % N) << self.SB) | (par[mask] // N)
        lanes = np.asarray(lanes, np.int64)
        counts = np.array([(n + N - 1 - s) // N for s in range(N)], np.int64)
        pre = n - lsizes[-1]
        lb = np.array([(pre + N - 1 - s) // N for s in range(N)], np.int64)
        nf = counts - lb
        self._grow_visited(n + self.ACAP)
        self._grow_store(int(counts.max()) + self.APAD)
        m = self.model
        src = []
        for s, dev in enumerate(self.mesh.devices):
            c = int(counts[s])
            r = torch.from_numpy(rows[s::N].view(np.int32).copy()).to(dev)
            src.append(r)
            self._rows[s][:c] = r
            self._parent[s][:c] = torch.from_numpy(
                par_new[s::N].astype(np.int32)).to(dev)
            self._lane[s][:c] = torch.from_numpy(
                lanes[s::N].astype(np.int32)).to(dev)
            self._nvis[s] = torch.full((), c, dtype=torch.int64, device=dev)
            if self.invariant_names and c:
                states = self.layout.unpack(r)
                pos = torch.arange(c, device=dev)
                bad = torch.stack([
                    torch.where(m.invariants[nm](states), BIG, pos).amin()
                    for nm in self.invariant_names
                ])
                self._viol[s] = torch.minimum(
                    self._viol[s],
                    torch.where(bad < BIG, (s << self.SB) | bad, BIG))
        # the keys through the routed flush, in windows of at most NCs
        # local states; retried whole on a route overflow (dedup no-ops)
        src_n = min(self.NCs, self.SEED_CHUNK)
        mx = int(counts.max())
        while True:
            try:
                w = 0
                for off in range(0, mx, src_n):
                    blocks = []
                    for s, dev in enumerate(self.mesh.devices):
                        k = max(0, min(src_n, int(counts[s]) - off))
                        kc = (tiles.key_plane(
                            self.keys, src[s][off: off + k],
                            torch.ones((k,), dtype=torch.bool, device=dev))
                            if k else ())
                        blocks.append(self._pad_keys(kc, k, dev))
                    self._route(blocks, w)
                    w += 1
                    if w == self.FLUSH or off + src_n >= mx:
                        # keys only: the rows are in place already
                        self._flush_keys(w * self.RCV, [False] * N)
                        w = 0
                nk = int(self._fetch()[:, 1].sum())
                break
            except _RouteOverflow:
                self._grow_route()
        if nk != n:
            raise ValueError(
                f"seed states are not all distinct ({nk} of {n} unique)")
        return [int(x) for x in lsizes], lb, nf

    # -------------------------------------------------- checkpoint/resume

    def _config_sig(self) -> str:
        return ckpt.config_sig(
            model=ckpt.model_sig(self.model),
            invariants=self.invariant_names,
            check_deadlock=self.check_deadlock,
            state_bits=self.layout.total_bits,
            key_cols=self.K,
            key_exact=self.keys.exact,
            n_shards=self.N,
            axes=self._axes,
            mesh=(self.D, self.I),
            # the gid encoding shard << SB | local
            sb=self.SB,
            engine=ENGINE_SIG,
            **({"visited": "sort"} if self.sorted else {}),
        )

    def load_checkpoint(self):
        return ckpt.load_frame(self.checkpoint_path, self._config_sig())

    def _save_checkpoint(self, level_sizes, lb, nf, t0) -> bool:
        """A level-boundary frame of every shard ("about to expand the
        frontier ``[lb, lb + nf)`` of each shard"): the tables' occupied
        slots, rows and logs, counts and flush metrics."""
        if not self.checkpoint_path or self._bufs_poisoned:
            return False
        t_stall = time.perf_counter()
        n_inv = len(self.invariant_names)
        try:
            stats = self._fetch()
            nvis = stats[:, 0].astype(np.int64)
            arrays = {
                "n_visited": nvis,
                "n_keys": stats[:, 1].astype(np.int64),
                "level_sizes": np.asarray(level_sizes, np.int64),
                "lb": np.asarray(lb, np.int64),
                "nf": np.asarray(nf, np.int64),
                "fpm": stats[:, 4 + n_inv:].astype(np.int64),
                "hbm_recovered": np.int64(self._hbm_recovered),
            }
            if self.last_level1_counts is not None:
                arrays["level1_counts"] = np.asarray(
                    self.last_level1_counts, np.int64)
            for s in range(self.N):
                c = int(nvis[s])
                if self.sorted:
                    nk = int(stats[s, 1])
                    for i, col in enumerate(self._vk[s]):
                        arrays[f"vk{s}_{i}"] = _host(col[:nk]).view(
                            np.uint32)
                else:
                    arrays.update(ckpt.pack_table(self._vk[s],
                                                  prefix=f"fp{s}"))
                arrays[f"rows{s}"] = _host(self._rows[s][:c]).view(
                    np.uint32).reshape(-1)
                arrays[f"parent{s}"] = _host(self._parent[s][:c])
                arrays[f"lane{s}"] = _host(self._lane[s][:c])
        except Exception as e:  # noqa: BLE001
            if not recovery.is_resource_exhausted(e):
                raise
            self._log(f"checkpoint skipped: device memory exhausted "
                      f"({e!r:.80})")
            return False
        nbytes, _write_s, retries = ckpt.save_frame(
            self.checkpoint_path, self._config_sig(), arrays,
            wall_s=time.time() - t0,
            meta={"frame_seq": self._ckpt_frames + 1,
                  "level": len(level_sizes), "engine": "sharded_device",
                  "run_id": self._run_id},
        )
        stall = time.perf_counter() - t_stall
        self._ckpt_frames += 1
        self._ckpt_bytes += nbytes
        self._ckpt_write_s += stall
        self._ckpt_retries += retries
        self.rec.arm()  # a fresh frame re-arms the recovery
        self.tel.emit(
            "ckpt_frame",
            frame_seq=self._ckpt_frames,
            bytes=nbytes,
            write_s=round(_write_s, 3),
            stall_s=round(stall, 3),
            retries=retries,
            level=len(level_sizes),
            distinct_states=int(nvis.sum()),
        )
        self._log(f"checkpoint: level {len(level_sizes)}, "
                  f"{int(nvis.sum())} states ({nbytes >> 10} KiB, "
                  f"{stall:.2f}s stall) -> {self.checkpoint_path}")
        return True

    def _restore(self):
        """Rebuild every shard from the frame; returns ``(level_sizes,
        lb, nf, wall_s)``."""
        d = self.load_checkpoint()
        self._resume_meta = ckpt.frame_meta(d)
        W, K = self.W, self.K
        nvis = np.asarray(d["n_visited"], np.int64)
        nkeys = np.asarray(d["n_keys"], np.int64)
        if int(nvis.sum()) > self.SCAP:
            raise ValueError(
                f"checkpoint holds {int(nvis.sum())} states — beyond "
                f"max_states ({self.SCAP}); raise max_states to resume it"
            )
        mx, mk = int(nvis.max()), int(nkeys.max())
        if self.sorted:
            self.VCAP = self._round_cap(mk + self.ACAP)
            self.TCAP = 2 * self.VCAP
        else:
            self.TCAP = int(d["fp0_tcap"])
            self.VCAP = self.TCAP // 2
        need_l = max(mx + self.APAD, self.NCs + self.APAD)
        while self.LCAP < need_l:
            self.LCAP = min(self.LCAP * 2, need_l)
        if self.LCAP > 1 << self.SB:
            raise ValueError("per-shard store exceeds local-gid bits")
        self._vk, self._claims = [], []
        self._rows, self._parent, self._lane = [], [], []
        for s, dev in enumerate(self.mesh.devices):
            c = int(nvis[s])
            t = self._empty_visited(dev)
            if self.sorted:
                nk = int(nkeys[s])
                for i, col in enumerate(t):
                    col[:nk] = torch.from_numpy(
                        np.asarray(d[f"vk{s}_{i}"], np.uint32)
                        .view(np.int32).copy()).to(dev)
                self._claims.append(None)
            else:
                ckpt.restore_table(d, t, prefix=f"fp{s}")
                self._claims.append(fpset.new_claims(self.TCAP, dev))
            self._vk.append(t)
            rows = torch.zeros((self.LCAP, W), dtype=torch.int32, device=dev)
            rows[:c] = torch.from_numpy(np.asarray(d[f"rows{s}"], np.uint32)
                                        .view(np.int32).reshape(c, W)).to(dev)
            self._rows.append(rows)
            for name, lst in (("parent", self._parent),
                              ("lane", self._lane)):
                t = torch.zeros((self.LCAP,), dtype=torch.int32, device=dev)
                t[:c] = torch.from_numpy(np.asarray(d[f"{name}{s}"],
                                                    np.int32)).to(dev)
                lst.append(t)
        self._alloc_acc()
        self._zero_state()
        fpm = np.asarray(d["fpm"], np.int64)
        for s, dev in enumerate(self.mesh.devices):
            self._nvis[s] = torch.full((), int(nvis[s]), dtype=torch.int64,
                                       device=dev)
            self._nkeys[s] = torch.full((), int(nkeys[s]), dtype=torch.int64,
                                        device=dev)
            self._fpm[s] = torch.from_numpy(fpm[s].copy()).to(dev)
        self._grow_visited(mk + self.ACAP)
        if "level1_counts" in d:
            self.last_level1_counts = np.asarray(d["level1_counts"],
                                                 np.int64)
        self.rec.hbm_recovered = max(self.rec.hbm_recovered,
                                     int(d["hbm_recovered"]))
        level_sizes = [int(x) for x in d["level_sizes"]]
        self._log(f"resumed at level {len(level_sizes)}: "
                  f"{int(nvis.sum())} states on {self.N} shards")
        return (level_sizes, np.asarray(d["lb"], np.int64),
                np.asarray(d["nf"], np.int64), float(d["wall_s"]))

    # ------------------------------------------------------------ result

    def _result(self, t0, stats, level_sizes, viol=None, dead_gid=None,
                truncated: bool = False,
                stop_reason: Optional[str] = None) -> CheckerResult:
        live = getattr(self, "_vk", None) is not None
        self.last_bufs = ({
            "rows": [r.reshape(-1) for r in self._rows],
            "parent": list(self._parent),
            "lane": list(self._lane),
        } if live else {})
        self.last_stats_matrix = stats
        for dev in self.mesh.distinct_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall = time.time() - t0
        nv = int(stats[:, 0].sum())
        if self._last_fpm is not None:
            fpm = self._last_fpm
            fl, rd = int(fpm[:, 0].sum()), int(fpm[:, 1].sum())
            vl = int(fpm[:, 3].sum())
            self.last_stats.update(
                fpset_flushes=fl,
                fpset_probe_rounds=rd,
                fpset_avg_probe_rounds=round(rd / max(fl, 1), 2),
                fpset_failures=int(fpm[:, 2].sum()),
                fpset_valid_lanes=vl,
                fpset_max_probe_rounds=int(fpm[:, 4].max()),
                fpset_table_cap=self.TCAP,
                fpset_max_occupancy=round(
                    float(stats[:, 1].max()) / max(self.TCAP, 1), 4),
                fpset_duplicate_ratio=(round(max(1.0 - nv / vl, 0.0), 4)
                                       if vl else None),
            )
        self.last_stats.update(
            hbm_recovered=self._hbm_recovered,
            ckpt_frames=self._ckpt_frames,
            ckpt_bytes=self._ckpt_bytes,
            ckpt_write_s=round(self._ckpt_write_s, 3),
            ckpt_retries=self._ckpt_retries,
            host_wait_s=round(self._host_wait_s, 3),
            stats_fetches=self._fetch_n,
            host_syncs=self._fetch_n,
            flushes=self._flushes,
            route_slack=self.route_slack,
            routed_bytes=self._routed_bytes,
            level_route_bytes=list(self.level_route_bytes),
            n_shards=self.N,
            mesh=(self.D, self.I),
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
            hbm_recovered=self._hbm_recovered,
            fp_collision_prob=self.keys.collision_prob(nv),
        )
        gid = None
        if viol is not None:
            res.violation, gid = viol
        elif dead_gid is not None:
            res.violation, gid = "Deadlock", dead_gid
        if gid is not None:
            res.violation_gid = gid
            if self._bufs_poisoned or not live:
                # the logs may be gone: the verdict without a trace
                res.truncated = True
            else:
                res.trace, res.trace_actions = build_trace(
                    self.model, _ShardLog(self._parent, self.SB),
                    _ShardLog(self._lane, self.SB), gid,
                    len(level_sizes) + 2,
                )
        emit_result(self.tel, res, self.last_stats)
        return res
