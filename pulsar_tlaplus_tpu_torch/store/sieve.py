"""Device-side sieve ops for the tiered store — the counterpart of
``pulsar_tlaplus_tpu/store/sieve.py`` (``tag_generation``,
``extract_cold``, ``sieve_new``, ``unflag_lanes``).

The sieve principle (arXiv:1208.5542): keys already confirmed visited
must never cross the slow link.

- :func:`tag_generation` stamps newly inserted table slots with the
  current eviction epoch at level boundaries, so age is a per-slot
  observable without touching the insert path.
- :func:`extract_cold` selects the slots at or below a cutoff epoch,
  masks them out of the table with the sieve-mask kernel (K3) and
  SORTS their keys (so the host-side cold run is searchable and
  delta-compressible without a host sort).  This is the tiled extract
  of ``ops/tiles.extract_cold_tiles``; its arrays equal the JAX
  package's compact + mask + sort.  The caller must rehash the
  survivors afterwards (probe chains break across holes).
- :func:`sieve_new` packs exactly the lanes the hot filter flagged new
  — the only keys that cross to the host for cold-tier miss resolution
  — and :func:`unflag_lanes` clears the false-new lanes BEFORE the
  compaction that assigns gids, which keeps tiered discovery order
  state for state identical to the untiered run.
"""

from __future__ import annotations

import torch

from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag


def tag_generation(tcols, gen: torch.Tensor, epoch: int) -> torch.Tensor:
    """Stamp occupied-but-untagged slots with ``epoch`` (int32).  The
    generation column is 0 for empty/untagged slots, so calling this
    once per level boundary gives every key the epoch of the first
    boundary after its insertion.  The trash slot ``cap`` stays 0."""
    cap = tcols[0].shape[0] - 1
    lane = torch.arange(cap + 1, device=gen.device)
    fresh = ~fpset.all_sentinel(tcols) & (lane < cap) & (gen == 0)
    return torch.where(fresh, epoch, gen)


def extract_cold(tcols, gen: torch.Tensor, cutoff: int):
    """Select slots with ``1 <= gen <= cutoff``, mask them out and sort
    their keys.  Returns ``(tcols_holed, gen_cleared, ev_cols_sorted,
    n_evicted)`` — see ``ops/tiles.extract_cold_tiles``."""
    return tiles.extract_cold_tiles(tcols, gen, cutoff)


def sieve_new(kcols, is_new: torch.Tensor):
    """Pack the hot-filter survivors: the lanes flagged new, as dense
    key columns plus their ORIGINAL lane ids (int32).  Returns
    ``(kcols..., lane_ids, n_new)``; only the ``n_new`` prefix is
    meaningful."""
    nq = kcols[0].shape[0]
    lane = torch.arange(nq, dtype=torch.int32, device=is_new.device)
    packed, _ = compact_by_flag(~is_new, (*kcols, lane))
    return (*packed, int(is_new.sum()))


def unflag_lanes(is_new: torch.Tensor, lanes: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Clear ``lanes[:n]`` in the bool new-state flags — the miss
    verdict merge."""
    out = is_new.clone()
    out[lanes[:n].long()] = False
    return out
