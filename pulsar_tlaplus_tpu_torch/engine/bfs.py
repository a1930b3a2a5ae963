"""The checker result record — the counterpart of
``pulsar_tlaplus_tpu/engine/bfs.py``'s ``CheckerResult``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class CheckerResult:
    distinct_states: int
    diameter: int  # BFS levels; initial states = level 1 (as the oracle)
    violation: Optional[str] = None  # invariant name, or "Deadlock"
    trace: Optional[list] = None  # list[pyeval.State]
    trace_actions: Optional[list] = None  # action names along the trace
    deadlock: bool = False
    states_per_sec: float = 0.0
    wall_s: float = 0.0
    level_sizes: List[int] = field(default_factory=list)
    truncated: bool = False  # stopped by the state budget, not exhaustion
    stop_reason: Optional[str] = None  # "max_states" when truncated
    # gid of the violating/deadlocked state (discovery order)
    violation_gid: Optional[int] = None
    # expected fingerprint collisions at this state count (birthday
    # bound); 0.0 when the keys are exact
    fp_collision_prob: float = 0.0
