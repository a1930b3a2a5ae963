"""The visited set as an open-addressing hash table on the device — the
counterpart of ``pulsar_tlaplus_tpu/ops/fpset.py`` (``slot_hash``,
``empty_cols``, ``all_sentinel``, ``probe_insert``, ``rehash_cols``,
``fpm_update``).

The table is ``K`` int32 key columns of ``cap + 1`` slots (``cap`` a power
of two), laid out slot-major: one ``[cap + 1, K]`` buffer whose K column
views (stride K) are what every op here takes, so a slot's key words
sit together and the membership kernel reads a slot in one sector.
Plain ops gather and ``index_put_`` through the views, which writes
through to the buffer; nothing may ``.contiguous()`` or ``.clone()`` a
column, which would fork the table.  The all-SENTINEL tuple marks an
empty slot and slot ``cap`` is a write-only trash row that parked lanes
scatter into, so every scatter is dense.  Probe round ``r`` looks at
``(h + r(r+1)/2) & (cap - 1)``, which visits every slot.  Equal keys
resolve to the lowest lane id by an ``amin`` scatter of lane ids
(order-independent), which is what fixes the discovery order.  Engines
keep the load at or under 1/2.

Unlike the JAX package, the table columns are updated in place: the
batched loop owns them between flushes, and a copy per round would double
the table's memory traffic.  So is the ``claims`` buffer of bids: a caller
that probes many batches into one table makes it once with ``new_claims``
and passes it in; each round resets the slots it bid on.

**Work units** (:func:`wkm_update`, the JAX package's ``wkm``): one
int64 ``[WKM_N]`` device vector in the logical order ``[expand_rows,
probe_lanes, compact_elems, append_rows, groups]``.  The JAX package
keeps int32 words with hi/lo carries (the TPU has no int64); here the
vector is int64 and its logical view is itself.  The definitions are
the JAX ones: ``expand_rows`` are the live frontier rows a window
expands (they sum to the frontier a level), ``probe_lanes`` and
``compact_elems`` the full width of the lanes a flush presents to the
probe and the compaction, ``append_rows`` the new states appended, and
``groups`` the flushes.

:class:`FPSet` is the host-side wrapper (tests, probes, host loops):
it owns the columns, the entry count, growth and the probe metrics,
and writes one ``fpset_insert`` telemetry record an insert.

``probe_insert`` is the plain lookup-or-insert; its ``while any(pending)``
is a host sync per round in eager PyTorch.  The flush's insert tail and
the rehash run it in chunks (:func:`insert_tail_plain`) only for CPU
tensors: on the card :func:`insert_tail` launches the H1 kernel
(``kernels/csrc/insert_tail.cu``), which runs every chunk and round in
one cooperative launch (grid rounds over a shrinking list of active
lanes, then a block-local tail), reads the survivor count from device
memory and leaves the same table slot for slot, with no host read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag
from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL, U32, fmix, u32

MAX_PROBES = 64
# the JAX package's default probe schedule (``resolve_schedule()`` with
# no override): dense rounds, then (shrink divisor, round limit) per
# stage; the tiled flush takes its prefilter height and its total probe
# budget from it
DENSE_ROUNDS = 4
STAGES = ((4, 16), (16, MAX_PROBES))


def resolve_schedule(dense_rounds: Optional[int] = None, stages=None
                     ) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """The effective probe schedule: the values given (a tuned profile's
    or the online controller's), else the defaults above.  (The JAX
    package's ``PTT_FPSET_SCHEDULE`` override is not read: a schedule
    reaches the port's engines through their ctor or a profile.)"""
    dense = DENSE_ROUNDS if dense_rounds is None else int(dense_rounds)
    st = STAGES if stages is None else stages
    st = tuple((int(d), int(lim)) for d, lim in st)
    if dense < 1 or any(d < 2 or lim < 1 for d, lim in st):
        raise ValueError(f"bad probe schedule: dense {dense}, stages {st}")
    return dense, st


def schedule_budget(dense_rounds: int, stages) -> int:
    """The insert tail's probe budget under a schedule: the largest of
    the dense rounds and the stage limits."""
    return max([int(dense_rounds)] + [int(lim) for _, lim in stages])
# width floor of an insert-tail chunk
MIN_STAGE = 1 << 10

_NO_LANE = 2**31 - 1  # claims fill: above every real lane id
# H1's block-local tail width (``kTail`` of kernels/csrc/insert_tail.cu):
# a chunk's rounds leave the grid once at most this many lanes are active
H1_TAIL = 2048

# flush metrics, int64: [flushes, probe_rounds, failures, valid_lanes,
# max_probe_rounds] — the JAX package's ``fpm_logical`` view
FPM_N = 5


def fpm_update(fpm: torch.Tensor, rounds: torch.Tensor,
               n_failed: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """One flush's metrics update of the int64 ``[FPM_N]`` vector; the
    counts are int64 0-d tensors on its device, so nothing is read on
    the host."""
    one = torch.ones_like(rounds)
    out = fpm + torch.stack(
        (one, rounds, n_failed, n_valid, torch.zeros_like(rounds))
    )
    out[4] = torch.maximum(fpm[4], rounds)
    return out


# work units, int64: [expand_rows, probe_lanes, compact_elems,
# append_rows, groups] — the JAX package's ``wkm_logical`` view
WKM_N = 5
WKM_LOGICAL_N = WKM_N


def wkm_update(wkm: torch.Tensor, rows, lanes, elems, appended,
               groups) -> torch.Tensor:
    """One flush's work units added to the int64 ``[WKM_N]`` vector.
    Each unit is an int or an int64 0-d tensor on the vector's device;
    ints become device fills (never a host-to-device copy), so nothing
    synchronizes with the host."""
    dev = wkm.device
    parts = [
        x if torch.is_tensor(x)
        else torch.full((), int(x), dtype=torch.int64, device=dev)
        for x in (rows, lanes, elems, appended, groups)
    ]
    return wkm + torch.stack(parts)


def wkm_logical(vec) -> np.ndarray:
    """int64 ``[WKM_LOGICAL_N]`` host view of a read work vector
    (a list, an array or a tensor; shorter vectors read zero-padded)."""
    if torch.is_tensor(vec):
        vec = vec.tolist()
    a = np.asarray(vec, np.int64).reshape(-1)
    v = np.zeros((WKM_N,), np.int64)
    v[: min(len(a), WKM_N)] = a[:WKM_N]
    return v


def slot_hash(kcols) -> torch.Tensor:
    """Mix K key columns into a table-index basis (u32 values, int64):
    an fmix chain, since exact keys are raw state words with skewed low
    bits."""
    h = fmix(u32(kcols[0]) ^ 0x9E3779B9)
    for c in kcols[1:]:
        h = fmix(h ^ u32(c))
    return h


def empty_cols(cap: int, ncols: int, device) -> Tuple[torch.Tensor, ...]:
    """A SENTINEL-filled slot-major table: the K column views of one
    int32 ``[cap + 1, K]`` buffer."""
    if cap & (cap - 1):
        raise ValueError(f"table capacity must be a power of two: {cap}")
    buf = torch.full((cap + 1, ncols), SENTINEL, dtype=torch.int32,
                     device=device)
    return tuple(buf.unbind(1))


def slot_major(cols, device=None) -> Tuple[torch.Tensor, ...]:
    """A fresh slot-major copy of any K equal-length columns (on
    ``device``, default theirs) — how a table moves between devices."""
    return tuple(torch.stack(cols, dim=1).to(device).unbind(1))


def slot_major_base(tcols) -> torch.Tensor:
    """The first column view of a slot-major table, whose data pointer
    is the ``[cap + 1, K]`` buffer a kernel reads: raises ValueError
    unless ``tcols`` are K int32 views of one storage with stride
    ``(K,)`` at consecutive offsets (what ``empty_cols`` makes), 8-byte
    aligned for K = 2 (one ``uint2`` load a slot)."""
    k, t0 = len(tcols), tcols[0]
    stor = t0.untyped_storage().data_ptr()
    for c, t in enumerate(tcols):
        if (t.dtype != torch.int32 or t.dim() != 1 or t.shape != t0.shape
                or t.stride() != (k,)
                or t.untyped_storage().data_ptr() != stor
                or t.storage_offset() != t0.storage_offset() + c):
            raise ValueError(
                "visited table is not slot-major: want the K column views "
                "of one int32 [cap + 1, K] buffer (fpset.empty_cols / "
                "fpset.slot_major)"
            )
    if k == 2 and t0.data_ptr() % 8:
        raise ValueError("slot-major K = 2 table is not 8-byte aligned")
    return t0


def all_sentinel(cols) -> torch.Tensor:
    e = cols[0] == SENTINEL
    for c in cols[1:]:
        e = e & (c == SENTINEL)
    return e


def new_claims(cap: int, device) -> torch.Tensor:
    """The bid buffer for a table of ``cap + 1`` slots, all unclaimed."""
    return torch.full((cap + 1,), _NO_LANE, dtype=torch.int32,
                      device=device)


def _tri(r: int) -> int:
    return (r * (r + 1) >> 1) & U32


def probe_insert(
    tcols: Tuple[torch.Tensor, ...],
    kcols: Tuple[torch.Tensor, ...],
    valid: torch.Tensor,
    max_probes: int = MAX_PROBES,
    lane_ids: Optional[torch.Tensor] = None,
    claims: Optional[torch.Tensor] = None,
):
    """Batched triangular-probing lookup-or-insert, in place on
    ``tcols``: lanes seeing their key resolve as duplicates; lanes
    seeing an empty slot bid for it with their lane id, the minimum
    wins and writes its key, and same-key losers resolve against the
    fresh slot.  ``lane_ids`` lets a caller probe a compacted buffer
    while bidding with original lane ids (min-lane-wins); ``claims``
    (from ``new_claims``, left unclaimed on return) saves its allocation.

    Returns ``(is_new, tcols, pending, rounds)``; ``pending`` lanes are
    unresolved after ``max_probes`` rounds (hard failures)."""
    cap = tcols[0].shape[0] - 1
    nq = kcols[0].shape[0]
    dev = kcols[0].device
    if lane_ids is None:
        lane_ids = torch.arange(nq, dtype=torch.int32, device=dev)
    lane_ids = lane_ids.to(torch.int32)
    h = slot_hash(kcols)
    if claims is None:
        claims = new_claims(cap, dev)
    pending = valid.clone()
    is_new = torch.zeros((nq,), dtype=torch.bool, device=dev)
    r = 0
    while r < max_probes and bool(pending.any()):
        slot = (h + _tri(r)) & (cap - 1)
        s = torch.where(pending, slot, cap)  # parked lanes hit the trash
        sv = tuple(c[s] for c in tcols)
        occ_s = ~all_sentinel(sv)
        eq = sv[0] == kcols[0]
        for cv, ck in zip(sv[1:], kcols[1:]):
            eq = eq & (cv == ck)
        pending = pending & ~(occ_s & eq)
        bid = pending & ~occ_s
        bid_slot = torch.where(bid, s, cap)
        claims.scatter_reduce_(0, bid_slot, lane_ids, "amin")
        win = bid & (claims[s] == lane_ids)
        claims.index_fill_(0, bid_slot, _NO_LANE)
        ws = torch.where(win, s, cap)  # one winner per slot; losers trash
        for c, k in zip(tcols, kcols):
            c.index_put_((ws,), k)
        is_new = is_new | win
        pending = pending & ~win
        sv2 = tuple(c[s] for c in tcols)
        eq2 = sv2[0] == kcols[0]
        for cv, ck in zip(sv2[1:], kcols[1:]):
            eq2 = eq2 & (cv == ck)
        pending = pending & ~(~all_sentinel(sv2) & eq2)
        r += 1
    return is_new, tcols, pending, r


# ------------------------------- kernel launches: argument checks


def on_card(name: str, tensors, table=()) -> torch.device:
    """The CUDA device all ``tensors`` (and the visited-table columns
    ``table``) share, for a kernel launch; a CPU tensor in the mix, or
    any other device, raises, as does a non-contiguous tensor or a
    table that is not slot-major (:func:`slot_major_base`)."""
    dev = tensors[0].device
    for t in (*tensors, *table):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if table:
        slot_major_base(table)
    return dev


def expect(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )


# --------------------------------------------- H1: the insert tail


def insert_tail_plain(tcols, ckeys, cids, npend, cw: int, claims,
                      n_ids: int, max_probes: int = MAX_PROBES):
    """H1's plain version: ``probe_insert`` over the first ``npend``
    (an int64 0-d tensor) lanes of ``ckeys``/``cids`` in chunks of
    ``cw``, in order, bidding with the lane ids ``cids``.  Returns
    ``(is_new bool [n_ids + 1], stats int64 [2])``: ``is_new[id]`` for
    each inserted lane id (index ``n_ids`` is a trash slot), and
    (probe rounds, failed lanes) over all chunks."""
    dev = ckeys[0].device
    n = int(npend)
    is_new = torch.zeros((n_ids + 1,), dtype=torch.bool, device=dev)
    rounds = failed = 0
    for base in range(0, n, cw):
        end = min(base + cw, n)
        lid = cids[base:end]
        new2, tcols, pending, r = probe_insert(
            tcols, tuple(c[base:end] for c in ckeys),
            torch.ones((end - base,), dtype=torch.bool, device=dev),
            max_probes=max_probes, lane_ids=lid, claims=claims,
        )
        is_new[torch.where(new2, lid, n_ids).long()] = True
        failed += int(pending.sum())
        rounds += r
    return is_new, torch.tensor([rounds, failed], dtype=torch.int64,
                                device=dev)


def insert_tail_args(tcols, ckeys, cids, npend, cw: int, claims, is_new,
                     lists, cnt, stats, max_probes: int = MAX_PROBES) -> tuple:
    """Check the card inputs of H1 and return the arguments of its
    ``kernels.launch``: a slot-major table, contiguous int32 keys and
    lane ids of one length, an int64 0-d ``npend``, the table's int32
    ``claims``, a bool ``is_new`` (zeroed, longer than every id), and
    the scratch: int32 ``lists[2, K + 2, cw]`` (the active lanes of a
    round, by its parity: K key rows, a lane-id row, a state row), int32
    ``cnt[2]`` (their lengths); int64 ``stats[4]`` receives (probe
    rounds, failed lanes, grid rounds, grid barriers).  Types and
    shapes are checked before the device; any mismatch raises
    ValueError."""
    k, n, cap1 = len(ckeys), cids.shape[0], tcols[0].shape[0]
    if k not in (2, 3) or len(tcols) != k:
        raise ValueError(f"insert_tail: K must be 2 or 3 (got {k})")
    if cw < 1:
        raise ValueError(f"insert_tail: want cw >= 1 (got {cw})")
    for c in (*ckeys, cids):
        expect("insert_tail", c, torch.int32, (n,))
    for t, dtype, shape in ((npend, torch.int64, ()),
                            (claims, torch.int32, (cap1,)),
                            (lists, torch.int32, (2, k + 2, cw)),
                            (cnt, torch.int32, (2,)),
                            (stats, torch.int64, (4,))):
        expect("insert_tail", t, dtype, shape)
    if is_new.dtype != torch.bool or is_new.dim() != 1:
        raise ValueError("insert_tail: want a 1-d bool is_new")
    dev = on_card("insert_tail",
                  (*ckeys, cids, npend, claims, is_new, lists, cnt, stats),
                  table=tcols)
    p = kernels.ptr
    return ("insert_tail", "ptt_insert_tail", p(tcols[0]), p(ckeys[0]),
            p(ckeys[1]), p(ckeys[2]) if k == 3 else None, p(cids), p(npend),
            p(claims), p(is_new), p(lists), p(cnt), p(stats), cw,
            cap1 - 2, k, max_probes, min(cw, n), kernels.stream(dev))


def insert_tail(tcols, ckeys, cids, npend, cw: int, claims, n_ids: int,
                max_probes: int = MAX_PROBES):
    """The insert tail of a flush (or a rehash), in place on ``tcols``:
    the first ``npend`` lanes (an int64 0-d tensor, read on the device)
    of the compacted keys ``ckeys`` with their original lane ids
    ``cids`` (all ``< n_ids``) are looked up or inserted in chunks of
    ``cw``, min-lane-wins.  Returns ``(is_new bool [n_ids + 1], stats
    int64 [2] = (probe rounds, failed lanes))`` on the table's device;
    ``claims`` (``new_claims``) comes back unclaimed.  CPU tensors take
    :func:`insert_tail_plain`; CUDA tensors launch H1 or raise."""
    if all(t.device.type == "cpu"
           for t in (*tcols, *ckeys, cids, npend, claims)):
        return insert_tail_plain(tcols, ckeys, cids, npend, cw, claims,
                                 n_ids, max_probes)
    dev = cids.device
    is_new = torch.zeros((n_ids + 1,), dtype=torch.bool, device=dev)
    stats = torch.zeros((4,), dtype=torch.int64, device=dev)
    lists = torch.empty((2, len(ckeys) + 2, cw), dtype=torch.int32,
                        device=dev)
    cnt = torch.empty((2,), dtype=torch.int32, device=dev)
    args = insert_tail_args(tcols, ckeys, cids, npend, cw, claims, is_new,
                            lists, cnt, stats, max_probes)
    if cids.shape[0]:
        with torch.cuda.device(dev):
            kernels.launch(*args)
    return is_new, stats[:2]


def rehash_cols(
    old_cols: Tuple[torch.Tensor, ...],
    new_cols: Tuple[torch.Tensor, ...],
    chunk: int = 1 << 20,
    max_probes: int = MAX_PROBES,
    claims: Optional[torch.Tensor] = None,
):
    """Re-insert every occupied slot of ``old_cols`` into the larger
    ``new_cols`` in chunks of ``chunk`` slots, each one insert tail of
    its occupied keys bidding with their slot offsets in the chunk (H1
    on the card).  ``claims`` is the new table's bid buffer (made when
    not given).  Returns ``(new_cols, n_failed)``, the count an int64 0-d
    tensor on the table's device (nothing is read on the host); a
    nonzero count means the caller broke the load contract."""
    ocap = old_cols[0].shape[0] - 1
    dev = new_cols[0].device
    if claims is None:
        claims = new_claims(new_cols[0].shape[0] - 1, dev)
    k = len(old_cols)
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    for base in range(0, ocap, chunk):
        ks = tuple(c[base: min(base + chunk, ocap)] for c in old_cols)
        m = ks[0].shape[0]
        occ = ~all_sentinel(ks)
        ccols, _ = compact_by_flag(
            ~occ, (*ks, torch.arange(m, dtype=torch.int32, device=dev))
        )
        _new, st = insert_tail(new_cols, ccols[:k], ccols[k], occ.sum(),
                               m, claims, m, max_probes)
        failed = failed + st[1]
    return new_cols, failed


class FPSet:
    """Host-side convenience wrapper over the visited table (tests,
    probes, host loops): owns the column tuple, the entry count, growth
    and cumulative probe/failure metrics — the JAX package's
    ``ops/fpset.FPSet``.  The device engines keep their own tables.

    On the card an insert is the tiled flush (K1, then the insert tail
    H1, ``tiles.flush_tiles``) and growth rehashes through H1; on the
    CPU an insert is :func:`probe_insert`.  ``telemetry`` (a path or an
    ``obs.telemetry.Telemetry``) takes one ``fpset_insert`` record an
    insert."""

    def __init__(self, ncols: int, cap: int = 1 << 10, telemetry=None,
                 device=None):
        from pulsar_tlaplus_tpu_torch.obs import telemetry as obs
        from pulsar_tlaplus_tpu_torch.utils import device as device_mod

        self.device = device_mod.resolve(device)
        self.cols = empty_cols(cap, ncols, self.device)
        self.ncols = ncols
        self.n = 0
        self.claims = new_claims(cap, self.device)
        self.fpm = torch.zeros((FPM_N,), dtype=torch.int64,
                               device=self.device)
        self.stats = {"inserts": 0, "probe_rounds": 0, "failures": 0}
        self.tel = obs.as_telemetry(telemetry)
        self._tel_owned = obs.owns_stream(telemetry)

    def close(self) -> None:
        """Close a telemetry stream this FPSet opened (a caller-passed
        Telemetry stays the caller's to close)."""
        if self._tel_owned:
            self.tel.close()

    @property
    def cap(self) -> int:
        return self.cols[0].shape[0] - 1

    @property
    def occupancy(self) -> float:
        return self.n / self.cap

    def reserve(self, n_entries: int) -> "FPSet":
        """Grow (double + rehash) until ``n_entries`` fit at load factor
        <= 1/2."""
        while 2 * n_entries > self.cap:
            new = empty_cols(self.cap * 2, self.ncols, self.device)
            self.claims = new_claims(self.cap * 2, self.device)
            self.cols, failed = rehash_cols(self.cols, new,
                                            claims=self.claims)
            if int(failed):
                raise RuntimeError("fpset rehash overflow")
        return self

    def _keys(self, kcols, valid):
        kc = tuple(torch.as_tensor(c).to(self.device, torch.int32)
                   for c in kcols)
        if valid is not None:
            valid = torch.as_tensor(valid).to(self.device, torch.bool)
            kc = tuple(torch.where(valid, c, SENTINEL) for c in kc)
        return kc

    def insert(self, kcols, valid=None) -> torch.Tensor:
        """Batched insert; returns the is_new bool vector (lane order).
        Grows first so the load-factor contract always holds; raises on
        a probe overflow (or the ``fpset_fail@flush`` drill)."""
        from pulsar_tlaplus_tpu_torch.ops import tiles
        from pulsar_tlaplus_tpu_torch.utils import faults

        kc = self._keys(kcols, valid)
        nq = kc[0].shape[0]
        self.reserve(self.n + nq)
        if self.device.type == "cuda":
            fl0 = self.fpm.clone()
            self.cols, n_new, is_new, self.fpm = tiles.flush_tiles(
                self.cols, kc, nq, self.fpm, self.claims)
            d = (self.fpm - fl0).tolist()
            rounds, nf, n_new = d[1], d[2], int(n_new)
        else:
            ok = ~all_sentinel(kc)
            is_new, self.cols, pending, rounds = probe_insert(
                self.cols, kc, ok, claims=self.claims)
            nf, n_new = int(pending.sum()), int(is_new.sum())
        if "fpset_fail" in faults.poll("flush", self.stats["inserts"] + 1):
            # the injected stage overflow (PTT_FAULT=fpset_fail@flush:N)
            # takes the fail-stop path below
            nf += 1
        self.n += n_new
        self.stats["inserts"] += 1
        self.stats["probe_rounds"] += int(rounds)
        self.stats["failures"] += nf
        self.tel.emit(
            "fpset_insert",
            inserts=self.stats["inserts"],
            probe_rounds=int(rounds),
            failures=nf,
            n=self.n,
            occupancy=round(self.occupancy, 4),
        )
        if nf:
            raise RuntimeError(
                f"fpset probe overflow ({nf} lanes unresolved) — "
                "grow the table before exceeding load factor 1/2"
            )
        return is_new

    def contains(self, kcols, valid=None) -> torch.Tensor:
        """Membership of each lane (invalid lanes read False)."""
        from pulsar_tlaplus_tpu_torch.ops import tiles

        kc = self._keys(kcols, valid)
        ok = ~all_sentinel(kc)
        member, resolved = tiles.member_block(self.cols, kc, ok,
                                              MAX_PROBES)
        if not bool(resolved.all()):
            raise RuntimeError("fpset lookup unresolved within "
                               f"{MAX_PROBES} probes")
        return member
