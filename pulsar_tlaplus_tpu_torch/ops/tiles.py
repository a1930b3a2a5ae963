"""The key-plane and membership-probe kernels and the tiled flush — the
counterpart of ``pulsar_tlaplus_tpu/ops/tiles.py`` (``key_plane``,
``member_block``, ``flush_acc_tiles``).

Each kernel has a wrapper and a plain PyTorch version beside it.  The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the hand-written kernel (``kernels/csrc``) or
raises.  The kernels are built on first use by ``kernels/build.py``.

In the port the tiled flush IS the flush: the membership prefilter (K1)
settles every lane whose key is already in the table or whose probe
sequence meets an empty slot within :data:`TILE_R` rounds; the survivors
compact order-preservingly, original lane ids riding along, and run the
plain ``probe_insert`` in chunks of ``max(nq/4, MIN_STAGE)`` lanes.
Chunk order is lane order and bids use original lane ids, so equal keys
resolve min-lane-wins and ``is_new`` equals the JAX package's flush bit
for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.ops import fpset
from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag
from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL

# probe rounds one membership pass resolves (>= the dense schedule, so
# steady-state flushes resolve in one pass)
TILE_R = 8


def _on_card(name: str, tensors) -> torch.device:
    """The CUDA device all ``tensors`` share, for a kernel launch; a
    CPU tensor in the mix, or any other device, raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _expect(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )


# ------------------------------------------------------- K2: key plane


def key_plane_plain(keyspec, packedf: torch.Tensor,
                    vflat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``KeySpec.make`` plus the validity mask, in plain PyTorch."""
    return tuple(
        torch.where(vflat, c, SENTINEL) for c in keyspec.make(packedf)
    )


def key_plane(keyspec, packedf: torch.Tensor,
              vflat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Key columns of one expand window's flattened successor matrix:
    packed int32 ``[nc, W]`` and ``vflat`` bool ``[nc]`` -> ``K`` int32
    ``[nc]`` columns, SENTINEL where invalid."""
    if packedf.device.type == "cpu" and vflat.device.type == "cpu":
        return key_plane_plain(keyspec, packedf, vflat)
    dev = _on_card("key_plane", (packedf, vflat))
    nc, w = packedf.shape
    _expect("key_plane", packedf, torch.int32, (nc, keyspec.W))
    _expect("key_plane", vflat, torch.bool, (nc,))
    k = keyspec.ncols
    out = torch.empty((k, nc), dtype=torch.int32, device=dev)
    if nc:
        with torch.cuda.device(dev):
            kernels.launch(
                "key_plane", "ptt_key_plane", kernels.ptr(packedf),
                kernels.ptr(vflat), kernels.ptr(out), nc, w, k,
                int(keyspec.exact), kernels.stream(dev),
            )
    return tuple(out[c] for c in range(k))


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


def member_block(tcols, kcols, valid: torch.Tensor, rounds: int = TILE_R):
    """Membership prefilter over a batch: ``(member, resolved)`` bool
    ``[nq]`` — member = the key sits in the table before the first empty
    slot of its probe sequence; resolved = member, or an empty slot came
    first, within ``rounds`` probes.  Invalid lanes read as resolved
    non-members."""
    if all(t.device.type == "cpu" for t in (*tcols, *kcols, valid)):
        return member_block_plain(tcols, kcols, valid, rounds)
    dev = _on_card("member_block", (*tcols, *kcols, valid))
    k, nq, cap1 = len(kcols), kcols[0].shape[0], tcols[0].shape[0]
    cap = cap1 - 1
    if k not in (2, 3) or len(tcols) != k:
        raise ValueError(f"member_block: K must be 2 or 3 (got {k})")
    if cap < 1 or cap & (cap - 1) or cap > 1 << 31:
        raise ValueError(f"member_block: bad table capacity {cap}")
    for t in tcols:
        _expect("member_block", t, torch.int32, (cap1,))
    for t in kcols:
        _expect("member_block", t, torch.int32, (nq,))
    _expect("member_block", valid, torch.bool, (nq,))
    member = torch.empty((nq,), dtype=torch.bool, device=dev)
    resolved = torch.empty((nq,), dtype=torch.bool, device=dev)
    if nq:
        t2 = kernels.ptr(tcols[2]) if k == 3 else None
        q2 = kernels.ptr(kcols[2]) if k == 3 else None
        with torch.cuda.device(dev):
            kernels.launch(
                "member_block", "ptt_member_block",
                kernels.ptr(tcols[0]), kernels.ptr(tcols[1]), t2,
                kernels.ptr(kcols[0]), kernels.ptr(kcols[1]), q2,
                kernels.ptr(valid), kernels.ptr(member),
                kernels.ptr(resolved), nq, cap - 1, k, rounds,
                kernels.stream(dev),
            )
    return member, resolved


# ------------------------------------------------------ the tiled flush


def flush_acc_tiles(tcols, kcols, n_acc: int, fpm: torch.Tensor):
    """One flush of ``nq`` candidate lanes into the table (in place):
    lanes past ``n_acc`` and all-SENTINEL lanes are invalid.  Returns
    ``(tcols, n_new, is_new bool[nq], fpm')`` with ``is_new`` in lane
    order, exactly one True per distinct new key (its lowest lane)."""
    nq = kcols[0].shape[0]
    k = len(kcols)
    dev = kcols[0].device
    rounds_blk = max(TILE_R, fpset.DENSE_ROUNDS)
    # the insert tail keeps the schedule's total probe budget
    max_probes = max([fpset.DENSE_ROUNDS]
                     + [lim for _, lim in fpset.STAGES])
    lanei = torch.arange(nq, dtype=torch.int32, device=dev)
    valid = (lanei < n_acc) & ~fpset.all_sentinel(kcols)
    member, _resolved = member_block(tcols, kcols, valid, rounds_blk)
    survivors = valid & ~member
    ccols, _ = compact_by_flag(~survivors, (*kcols, lanei))
    ckeys, cids = ccols[:k], ccols[k]
    npend = int(survivors.sum())
    cw = max(nq // 4, min(nq, fpset.MIN_STAGE))
    is_new = torch.zeros((nq + 1,), dtype=torch.bool, device=dev)
    n_failed, rounds = 0, rounds_blk
    claims = fpset.new_claims(tcols[0].shape[0] - 1, dev) if npend else None
    for base in range(0, npend, cw):
        end = min(base + cw, npend)
        lid = cids[base:end]
        new2, tcols, pending, r = fpset.probe_insert(
            tcols, tuple(c[base:end] for c in ckeys),
            torch.ones((end - base,), dtype=torch.bool, device=dev),
            max_probes=max_probes, lane_ids=lid, claims=claims,
        )
        is_new[torch.where(new2, lid, nq).long()] = True
        n_failed += int(pending.sum())
        rounds += r
    is_new = is_new[:nq]
    n_new = int(is_new.sum())
    fpm = fpset.fpm_update(fpm, rounds, n_failed, int(valid.sum()))
    return tcols, n_new, is_new, fpm
