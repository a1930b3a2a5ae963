"""The declared knob space the offline tuner searches — the counterpart
of ``pulsar_tlaplus_tpu/tune/space.py``.

Each knob names an engine constructor parameter, its candidate values,
and the validity constraints that prune impossible combinations.  The
space is small and discrete: the cost model ranks the whole cartesian
product in microseconds, and only the top-K survivors ever run
(``tune/search.py``).

Knob semantics (all scheduling or batching — none may change the
states found or their order; pinned by ``tests/test_torch_tune.py``):

- ``sub_batch``       frontier rows a window expands (x the base)
- ``flush_factor``    windows merged into one flush
- ``group``           fused-level growth headroom: ``group + 1``
                      windows ahead
- ``fuse_group``      max ramp levels one fused pass may close
- ``fpset_dense_rounds`` / ``fpset_stages``  the probe schedule: the
                      tiled flush's membership height is ``max(TILE_R,
                      dense)`` and its insert tail's budget the largest
                      of ``dense`` and the stage limits
- ``compact_impl``    stream compaction (``logshift`` | ``sort``)

Tiered-store knobs (searched only for budgeted workloads,
``candidates(spill=True)``): ``hbm_headroom``, ``spill_compress``,
``miss_batch``.

What the port leaves out of the JAX space, and why:

- ``probe_impl`` (legacy | tile | pallas), ``expand_impl`` (legacy |
  tile | pallas) and ``sieve_impl`` (legacy | tile | pallas): the port
  has one route a device — the hand kernels K1/H1, K2 and K3 on the
  card, their plain versions on the CPU — so there is nothing to
  choose.  A profile carrying them is refused as naming unknown knobs.
- ``fpset_dense_rounds`` is not searched (it stays a profile knob):
  the JAX values 2 and 8 both give the tiled flush's membership pass
  ``max(TILE_R, d) = 8`` rounds, the default's height, so they would
  spend measure slots on the default schedule.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple


@dataclass(frozen=True)
class Knob:
    name: str
    values: Tuple
    doc: str


# the device-engine search space.  ``sub_batch`` values are multipliers
# of the base window; the others are absolute; ``None`` = engine default
DEVICE_KNOBS: Tuple[Knob, ...] = (
    Knob("sub_batch", (None, 0.25, 0.5, 2.0), "expand window G (x default)"),
    Knob("flush_factor", (None, 2, 3), "windows per flush"),
    Knob("group", (None, 2, 8), "growth headroom in windows"),
    Knob("fuse_group", (None, 1, 4, 16), "ramp levels per fused pass"),
)

# tiered-store knobs: searched only when the workload is budgeted
SPILL_KNOBS: Tuple[Knob, ...] = (
    Knob("hbm_headroom", (None, 0.05, 0.2), "budget headroom fraction"),
    Knob("spill_compress", (None, False),
         "delta+zlib cold planes (None = on)"),
    Knob("miss_batch", (None, 1 << 14, 1 << 16),
         "sieved keys per cold-lookup batch"),
)

# simulation knobs (``cli tune --mode simulate``): the swarm width and
# the steps a segment (clamped to a divisor of ``depth``)
SIM_KNOBS: Tuple[Knob, ...] = (
    Knob("n_walkers", (None, 1024, 4096, 16384),
         "walker swarm width (walks per segment)"),
    Knob("segment_len", (None, 8, 32, 128),
         "steps per segment (clamped to a depth divisor)"),
)

# liveness-engine knobs carried by profiles (loaded by LivenessChecker;
# no offline search over them)
LIVENESS_KNOBS: Tuple[Knob, ...] = (
    Knob("sweep_group", (None, 2, 8, 32), "sweep chunks per host read"),
)

# every knob name a profile may carry, per engine — the profile
# validator and the engines' resolvers both consult this table
PROFILE_KNOBS: Dict[str, Tuple[str, ...]] = {
    "device_bfs": (
        "sub_batch", "flush_factor", "group", "fuse_group",
        "fpset_dense_rounds", "fpset_stages", "compact_impl", "adapt",
        "hbm_headroom", "spill_compress", "miss_batch",
    ),
    "liveness": ("sweep_group", "compact_impl", "adapt"),
    "sim": ("n_walkers", "segment_len"),
}


def sim_candidates(limit: Optional[int] = None) -> List[Dict]:
    """The simulation knob space as sparse dicts (defaults first)."""
    out: List[Dict] = []
    for combo in itertools.product(*(k.values for k in SIM_KNOBS)):
        out.append({k.name: v for k, v in zip(SIM_KNOBS, combo)
                    if v is not None})
        if limit is not None and len(out) >= limit:
            break
    return out


def _valid(model, cand: Dict, base_sub_batch: int) -> bool:
    """The JAX space's constraints: at least 64 rows a window, and a
    flush's candidate rows (``sub_batch * A * flush_factor * W`` words)
    under 2^31."""
    g = cand.get("sub_batch") or base_sub_batch
    ff = cand.get("flush_factor") or 1
    if g < 64:
        return False
    return g * int(model.A) * ff * int(model.layout.W) < 1 << 31


def candidates(
    model,
    base_sub_batch: int = 1 << 16,
    knobs: Iterable[Knob] = DEVICE_KNOBS,
    limit: Optional[int] = None,
    spill: bool = False,
) -> List[Dict]:
    """The cartesian product of the knob space, validity-pruned, as
    sparse knob dicts (``None`` entries dropped; the all-default
    candidate comes first and is the baseline).  ``sub_batch``
    multipliers resolve against ``base_sub_batch`` rounded down to a
    power of two (at least 64); ``spill=True`` adds the tiered-store
    knobs."""
    knobs = tuple(knobs)
    if spill:
        knobs = knobs + SPILL_KNOBS
    out: List[Dict] = []
    for combo in itertools.product(*(k.values for k in knobs)):
        cand: Dict = {}
        for k, v in zip(knobs, combo):
            if v is None:
                continue
            if k.name == "sub_batch":
                g = int(base_sub_batch * v)
                p = 1
                while p * 2 <= g:
                    p *= 2
                cand[k.name] = max(p, 64)
            else:
                cand[k.name] = v
        if not _valid(model, cand, base_sub_batch):
            continue
        out.append(cand)
        if limit is not None and len(out) >= limit:
            break
    return out


def describe(cand: Dict) -> str:
    """One-line render of a sparse candidate ("defaults" when empty)."""
    if not cand:
        return "defaults"
    return ",".join(f"{k}={v}" for k, v in sorted(cand.items()))
