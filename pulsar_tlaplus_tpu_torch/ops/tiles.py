"""The key-plane, membership-probe and sieve-mask kernels, the tiled
flush and the tiled cold extract — the counterpart of
``pulsar_tlaplus_tpu/ops/tiles.py`` (``key_plane``, ``member_block``,
``flush_acc_tiles``, ``sieve_mask_planes``, ``extract_cold_tiles``).

Each kernel has a wrapper and a plain PyTorch version beside it.  The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the hand-written kernel (``kernels/csrc``) or
raises.  The kernels are built on first use by ``kernels/build.py``.
K1 and K3 read the visited table through one pointer, so on the card it
must be slot-major (``fpset.empty_cols``); the ``*_args`` helpers check
a kernel's inputs and return its launch arguments, which also lets a
caller time raw launches on preallocated outputs.

In the port the tiled flush IS the flush: the membership prefilter (K1)
settles every lane whose key is already in the table or whose probe
sequence meets an empty slot within :data:`TILE_R` rounds; the survivors
compact order-preservingly, original lane ids riding along, and run the
insert tail (``fpset.insert_tail``: the H1 kernel on the card, the plain
``probe_insert`` chunk loop on the CPU) in chunks of ``max(nq/4,
MIN_STAGE)`` lanes.  Chunk order is lane order and bids use original
lane ids, so equal keys resolve min-lane-wins and ``is_new`` equals the
JAX package's flush bit for bit.  :func:`flush_tiles` reads nothing on
the host (the fused level's flush); :func:`flush_acc_tiles` reads the
new-lane count (the stage loop's).

The tiered store's cold extract is the tiled one too: the sieve-mask
kernel (K3) masks the table planes in place and the masked planes are
sorted directly in unsigned lexicographic column order, with no
compaction before the sort.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.ops import fpset
from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag
from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL, u32
from pulsar_tlaplus_tpu_torch.ops.dedup import key64 as _key64

# probe rounds one membership pass resolves at least (>= the default
# schedule's dense rounds, so steady-state flushes resolve in one pass;
# a schedule with more dense rounds raises K1's height to them)
TILE_R = 8


# ------------------------------------------------------- K2: key plane


def key_plane_plain(keyspec, packedf: torch.Tensor,
                    vflat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``KeySpec.make`` plus the validity mask, in plain PyTorch."""
    return tuple(
        torch.where(vflat, c, SENTINEL) for c in keyspec.make(packedf)
    )


def key_plane_args(keyspec, packedf: torch.Tensor, vflat: torch.Tensor,
                   out: torch.Tensor) -> tuple:
    """Check the card inputs of K2 and return the arguments of its
    ``kernels.launch`` into ``out`` (int32 ``[K, nc]``)."""
    dev = fpset.on_card("key_plane", (packedf, vflat, out))
    nc, w = packedf.shape
    k = keyspec.ncols
    fpset.expect("key_plane", packedf, torch.int32, (nc, keyspec.W))
    fpset.expect("key_plane", vflat, torch.bool, (nc,))
    fpset.expect("key_plane", out, torch.int32, (k, nc))
    if packedf.data_ptr() % 16:
        raise ValueError("key_plane: packed rows must be 16-byte aligned "
                         "(the tiles are bulk-copied)")
    return ("key_plane", "ptt_key_plane", kernels.ptr(packedf),
            kernels.ptr(vflat), kernels.ptr(out), nc, w, k,
            int(keyspec.exact), kernels.stream(dev))


def key_plane(keyspec, packedf: torch.Tensor,
              vflat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Key columns of one expand window's flattened successor matrix:
    packed int32 ``[nc, W]`` and ``vflat`` bool ``[nc]`` -> ``K`` int32
    ``[nc]`` columns, SENTINEL where invalid."""
    if packedf.device.type == "cpu" and vflat.device.type == "cpu":
        return key_plane_plain(keyspec, packedf, vflat)
    out = torch.empty((keyspec.ncols, packedf.shape[0]), dtype=torch.int32,
                      device=packedf.device)
    args = key_plane_args(keyspec, packedf, vflat, out)
    if packedf.shape[0]:
        with torch.cuda.device(out.device):
            kernels.launch(*args)
    return tuple(out.unbind(0))


# ------------------------------------------------ K1: membership probe


def member_block_plain(tcols, kcols, valid: torch.Tensor,
                       rounds: int = TILE_R):
    """The blocked membership plane in plain PyTorch: gather the first
    ``rounds`` slots of every lane's probe sequence at once and compare
    the first match with the first empty slot."""
    cap = tcols[0].shape[0] - 1
    h = fpset.slot_hash(kcols)
    r = torch.arange(rounds, dtype=torch.int64, device=h.device)
    slots = (h[None, :] + ((r * (r + 1)) >> 1)[:, None]) & (cap - 1)
    sv = tuple(c[slots] for c in tcols)
    empty = fpset.all_sentinel(sv)
    eq = sv[0] == kcols[0][None, :]
    for cv, ck in zip(sv[1:], kcols[1:]):
        eq = eq & (cv == ck[None, :])
    match = eq & ~empty
    ri = r[:, None]
    first_match = torch.where(match, ri, rounds).amin(dim=0)
    first_empty = torch.where(empty, ri, rounds).amin(dim=0)
    member = first_match < first_empty
    resolved = member | (first_empty < rounds)
    return member & valid, resolved | ~valid


def member_block_args(tcols, kcols, valid: torch.Tensor, member, resolved,
                      rounds: int = TILE_R) -> tuple:
    """Check the card inputs of K1 (a slot-major table) and return the
    arguments of its ``kernels.launch`` into the bool ``[nq]`` flags
    ``member`` and ``resolved``."""
    dev = fpset.on_card("member_block", (*kcols, valid, member, resolved),
                        table=tcols)
    k, nq, cap1 = len(kcols), kcols[0].shape[0], tcols[0].shape[0]
    cap = cap1 - 1
    if k not in (2, 3) or len(tcols) != k:
        raise ValueError(f"member_block: K must be 2 or 3 (got {k})")
    if cap < 1 or cap & (cap - 1) or cap > 1 << 31:
        raise ValueError(f"member_block: bad table capacity {cap}")
    for t in tcols:
        fpset.expect("member_block", t, torch.int32, (cap1,))
    for t in kcols:
        fpset.expect("member_block", t, torch.int32, (nq,))
    for t in (valid, member, resolved):
        fpset.expect("member_block", t, torch.bool, (nq,))
        if t.data_ptr() % 4:  # four lanes' flags a uchar4
            raise ValueError("member_block: flags must be 4-byte aligned")
    q2 = kernels.ptr(kcols[2]) if k == 3 else None
    return ("member_block", "ptt_member_block", kernels.ptr(tcols[0]),
            kernels.ptr(kcols[0]), kernels.ptr(kcols[1]), q2,
            kernels.ptr(valid), kernels.ptr(member), kernels.ptr(resolved),
            nq, cap - 1, k, rounds, kernels.stream(dev))


def member_block(tcols, kcols, valid: torch.Tensor, rounds: int = TILE_R):
    """Membership prefilter over a batch: ``(member, resolved)`` bool
    ``[nq]`` — member = the key sits in the table before the first empty
    slot of its probe sequence; resolved = member, or an empty slot came
    first, within ``rounds`` probes.  Invalid lanes read as resolved
    non-members.  On the card the table must be slot-major."""
    if all(t.device.type == "cpu" for t in (*tcols, *kcols, valid)):
        return member_block_plain(tcols, kcols, valid, rounds)
    nq = kcols[0].shape[0]
    member = torch.empty((nq,), dtype=torch.bool, device=valid.device)
    resolved = torch.empty_like(member)
    args = member_block_args(tcols, kcols, valid, member, resolved, rounds)
    if nq:
        with torch.cuda.device(member.device):
            kernels.launch(*args)
    return member, resolved


# ------------------------------------------------------ the tiled flush


def flush_tiles(tcols, kcols, n_acc, fpm: torch.Tensor, claims=None,
                dense_rounds=None, stages=None):
    """One flush of ``nq`` candidate lanes into the table (in place),
    with no host read: lanes past ``n_acc`` (an int or a 0-d tensor)
    and all-SENTINEL lanes are invalid.  K1, the order-preserving
    compaction of the survivors with their lane ids, then the insert
    tail (H1 on the card) on the table's ``claims`` buffer (made when
    not given).  The probe schedule (``dense_rounds``, ``stages``;
    ``fpset.resolve_schedule`` defaults) sets K1's height, ``max(TILE_R,
    dense_rounds)``, and the tail's probe budget, the largest of
    ``dense_rounds`` and the stage limits, as in the JAX tiled flush.
    Returns ``(tcols, n_new, is_new bool[nq], fpm')``: ``n_new`` an
    int64 0-d tensor and ``fpm'`` on the lanes' device; ``is_new`` is in
    lane order, exactly one True per distinct new key (its lowest lane),
    whatever the schedule."""
    nq = kcols[0].shape[0]
    k = len(kcols)
    dev = kcols[0].device
    dense_rounds, stages = fpset.resolve_schedule(dense_rounds, stages)
    rounds_blk = max(TILE_R, dense_rounds)
    max_probes = fpset.schedule_budget(dense_rounds, stages)
    lanei = torch.arange(nq, dtype=torch.int32, device=dev)
    valid = (lanei < n_acc) & ~fpset.all_sentinel(kcols)
    member, _resolved = member_block(tcols, kcols, valid, rounds_blk)
    survivors = valid & ~member
    ccols, _ = compact_by_flag(~survivors, (*kcols, lanei))
    cw = max(nq // 4, min(nq, fpset.MIN_STAGE))
    if claims is None:
        claims = fpset.new_claims(tcols[0].shape[0] - 1, dev)
    is_new, st = fpset.insert_tail(
        tcols, ccols[:k], ccols[k], survivors.sum(), cw, claims, nq,
        max_probes,
    )
    is_new = is_new[:nq]
    fpm = fpset.fpm_update(fpm.to(dev), rounds_blk + st[0], st[1],
                           valid.sum())
    return tcols, is_new.sum(), is_new, fpm


def flush_acc_tiles(tcols, kcols, n_acc, fpm: torch.Tensor, claims=None,
                    dense_rounds=None, stages=None):
    """:func:`flush_tiles` with the new-lane count read on the host (one
    sync): ``(tcols, n_new int, is_new bool[nq], fpm')``."""
    tcols, n_new, is_new, fpm = flush_tiles(tcols, kcols, n_acc, fpm,
                                            claims, dense_rounds, stages)
    return tcols, int(n_new), is_new, fpm


# ------------------------------------------------------ K3: sieve mask


def sieve_mask_planes_plain(tcols, gen: torch.Tensor, cold: torch.Tensor):
    """The sieve's masking plane in plain PyTorch."""
    masked = tuple(torch.where(cold, c, SENTINEL) for c in tcols)
    holed = tuple(torch.where(cold, SENTINEL, c) for c in tcols)
    gen2 = torch.where(cold, 0, gen)
    return masked, holed, gen2


def sieve_mask_args(tcols, gen: torch.Tensor, cold: torch.Tensor,
                    out: torch.Tensor) -> tuple:
    """Check the card inputs of K3 (a slot-major table) and return the
    arguments of its ``kernels.launch`` into ``out`` (int32
    ``[2K + 1, n]``)."""
    dev = fpset.on_card("sieve_mask_planes", (gen, cold, out), table=tcols)
    k, n = len(tcols), gen.shape[0]
    if k not in (2, 3):
        raise ValueError(f"sieve_mask_planes: K must be 2 or 3 (got {k})")
    for t in tcols:
        fpset.expect("sieve_mask_planes", t, torch.int32, (n,))
    fpset.expect("sieve_mask_planes", gen, torch.int32, (n,))
    fpset.expect("sieve_mask_planes", cold, torch.bool, (n,))
    fpset.expect("sieve_mask_planes", out, torch.int32, (2 * k + 1, n))
    return ("sieve_mask", "ptt_sieve_mask", kernels.ptr(tcols[0]),
            kernels.ptr(gen), kernels.ptr(cold), kernels.ptr(out), n, k,
            kernels.stream(dev))


def sieve_mask_planes(tcols, gen: torch.Tensor, cold: torch.Tensor):
    """The sieve's masking plane over the ``cap + 1`` table slots:
    ``(masked cols, holed cols, gen')`` with ``masked = cold ? key :
    SENTINEL``, ``holed = cold ? SENTINEL : key`` and ``gen' = cold ? 0
    : gen`` (K int32 columns, int32 ``gen``, bool ``cold``).  On the
    card the table must be slot-major; the outputs are planes of one
    buffer."""
    if all(t.device.type == "cpu" for t in (*tcols, gen, cold)):
        return sieve_mask_planes_plain(tcols, gen, cold)
    k, n = len(tcols), gen.shape[0]
    # planes 0..K-1 masked, K..2K-1 holed, 2K the cleared generations
    out = torch.empty((2 * k + 1, n), dtype=torch.int32, device=gen.device)
    args = sieve_mask_args(tcols, gen, cold, out)
    if n:
        with torch.cuda.device(out.device):
            kernels.launch(*args)
    return (tuple(out[:k].unbind(0)), tuple(out[k: 2 * k].unbind(0)),
            out[2 * k])


def sort_cols(cols):
    """Sort K = 2 or 3 int32 key columns together in unsigned
    lexicographic column order (SENTINEL = 0xFFFFFFFF sorts last):
    one int64 sort of the first two columns for K = 2; for K = 3 a
    sort of columns 1-2, then a stable sort of column 0."""
    if len(cols) == 2:
        order = torch.sort(_key64(cols[0], cols[1])).indices
    else:
        order = torch.sort(_key64(cols[1], cols[2])).indices
        order = order[torch.sort(u32(cols[0][order]), stable=True).indices]
    return tuple(c[order] for c in cols)


def extract_cold_tiles(tcols, gen: torch.Tensor, cutoff: int):
    """Select the occupied slots with ``1 <= gen <= cutoff``, mask them
    out of the table, and sort their keys.  Returns ``(holed cols,
    gen', sorted cols, n_evicted)``: the first ``n_evicted`` lanes of
    the full-width sorted columns are the evicted keys in unsigned
    lexicographic order, SENTINEL padding after.  The holed table must
    be rehashed before it serves lookups again (probe chains break
    across holes)."""
    cap = tcols[0].shape[0] - 1
    lane = torch.arange(cap + 1, device=gen.device)
    occ = ~fpset.all_sentinel(tcols) & (lane < cap)
    cold = occ & (gen >= 1) & (gen <= cutoff)
    n_ev = int(cold.sum())
    masked, holed, gen2 = sieve_mask_planes(tcols, gen, cold)
    return holed, gen2, sort_cols(masked), n_ev
