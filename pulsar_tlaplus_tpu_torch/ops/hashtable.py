"""The host engines' visited hash table — the counterpart of
``pulsar_tlaplus_tpu/ops/hashtable.py`` (``empty_table``,
``lookup_insert``, ``rehash_into``).

The table is the engines' slot-major fpset (``ops/fpset.py``) with three
key columns and the all-SENTINEL tuple as the empty marker.  The JAX
table carries a fourth, occupancy column; it is not needed here, since
``dedup.make_keys`` never yields the all-SENTINEL triple (exact keys
have a zero pad bit, hashed ones remap it).  ``lookup_insert`` is the
tiled flush on the card (``tiles.flush_tiles``: K1, then the insert
tail H1) and ``fpset.probe_insert`` on the CPU; either way exactly one
lane per distinct new key comes back new, its lowest (min-lane-wins),
and a lane still unresolved after the probe budget is counted in
``n_failed``, which callers treat as a hard error, never a silent
drop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.dedup import SENTINEL

NCOLS = 3


def empty_table(cap: int, device) -> Tuple[torch.Tensor, ...]:
    """The three key columns of an empty table of a power-of-two
    ``cap`` slots (plus the trash slot)."""
    if cap & (cap - 1):
        raise ValueError(f"table capacity must be a power of two: {cap}")
    return fpset.empty_cols(cap, NCOLS, device)


def lookup_insert(tcols, kcols, valid: torch.Tensor,
                  claims: Optional[torch.Tensor] = None):
    """Batched lookup-or-insert of ``valid`` lanes' keys, in place.
    Returns ``(is_new bool[n], tcols, n_failed)`` with ``n_failed`` an
    int64 0-d tensor on the table's device."""
    if tcols[0].is_cuda:
        kc = tuple(torch.where(valid, k, SENTINEL) for k in kcols)
        fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64,
                          device=tcols[0].device)
        tcols, _n_new, is_new, fpm = tiles.flush_tiles(
            tcols, kc, kc[0].shape[0], fpm, claims)
        return is_new, tcols, fpm[2]
    is_new, tcols, pending, _rounds = fpset.probe_insert(
        tcols, tuple(kcols), valid, claims=claims)
    return is_new, tcols, pending.sum()


def rehash_into(old, new):
    """Move every occupied entry of ``old`` into the larger empty table
    ``new`` (H1 on the card); raises on a probe overflow."""
    new, failed = fpset.rehash_cols(old, new)
    if int(failed):
        raise RuntimeError(
            "hash table rehash overflow — raise visited capacity")
    return new
