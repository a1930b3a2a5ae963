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
    trace: Optional[list] = None  # states as the model's to_pystate gives them
    trace_actions: Optional[list] = None  # action names along the trace
    deadlock: bool = False
    states_per_sec: float = 0.0
    wall_s: float = 0.0
    level_sizes: List[int] = field(default_factory=list)
    truncated: bool = False  # stopped by a budget or a stop, not exhaustion
    # why a truncated run stopped: "max_states" | "time_budget" | "hbm"
    # (device memory ran out and no frame could rebuild the run) |
    # "row_window" (the frontier row window lost rows of a level that
    # must be expanded) | "preempted" (SIGTERM/SIGINT: a resumable stop)
    # | "spill_enospc" (the durable spill tier hit a full disk); None
    # when not truncated
    stop_reason: Optional[str] = None
    # how many times the run rebuilt its device state from the last
    # checkpoint frame after device memory ran out, and went on at
    # degraded capacity
    hbm_recovered: int = 0
    # gid of the violating/deadlocked state (discovery order)
    violation_gid: Optional[int] = None
    # expected fingerprint collisions at this state count (birthday
    # bound); 0.0 when the keys are exact
    fp_collision_prob: float = 0.0
