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
``probe_insert``'s ``while any(pending)`` is a host sync per round in
eager PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL, U32, fmix, u32

MAX_PROBES = 64
# the JAX package's default probe schedule (``resolve_schedule()`` with
# no override): dense rounds, then (shrink divisor, round limit) per
# stage; the tiled flush takes its prefilter height and its total probe
# budget from it
DENSE_ROUNDS = 4
STAGES = ((4, 16), (16, MAX_PROBES))
# width floor of an insert-tail chunk
MIN_STAGE = 1 << 10

_NO_LANE = 2**31 - 1  # claims fill: above every real lane id

# host-side flush metrics: [flushes, probe_rounds, failures, valid_lanes,
# max_probe_rounds] — the JAX package's ``fpm_logical`` view
FPM_N = 5


def fpm_update(fpm: torch.Tensor, rounds: int, n_failed: int,
               n_valid: int) -> torch.Tensor:
    """One flush's metrics update of the int64 ``[FPM_N]`` vector."""
    out = fpm.clone()
    out[0] += 1
    out[1] += rounds
    out[2] += n_failed
    out[3] += n_valid
    out[4] = max(int(fpm[4]), rounds)
    return out


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


def rehash_cols(
    old_cols: Tuple[torch.Tensor, ...],
    new_cols: Tuple[torch.Tensor, ...],
    chunk: int = 1 << 20,
    max_probes: int = MAX_PROBES,
):
    """Re-insert every occupied slot of ``old_cols`` into the larger
    ``new_cols`` in chunks.  Returns ``(new_cols, n_failed)``; a nonzero
    count means the caller broke the load contract."""
    ocap = old_cols[0].shape[0] - 1
    claims = new_claims(new_cols[0].shape[0] - 1, new_cols[0].device)
    n_failed = 0
    for base in range(0, ocap, chunk):
        ks = tuple(c[base: min(base + chunk, ocap)] for c in old_cols)
        _new, new_cols, pending, _r = probe_insert(
            new_cols, ks, ~all_sentinel(ks), max_probes=max_probes,
            claims=claims,
        )
        n_failed += int(pending.sum())
    return new_cols, n_failed
