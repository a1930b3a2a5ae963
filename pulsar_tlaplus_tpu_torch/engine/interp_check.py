"""Interpreter-backed exhaustive checker for arbitrary TLA+ specs.

The compiled-model registry (``models/``) covers the specs with hand-tuned
device kernels; this module closes the generality gap (SURVEY.md §2.2-E1):
any ``.tla``/``.cfg`` pair in the front end's supported operator subset
(SURVEY.md §1-L2) can be checked end to end — parse (frontend/parser),
bind constants (frontend/loader), then host BFS over the generic
interpreter's ``initial_states``/``successors`` with invariant evaluation,
deadlock detection, and shortest-counterexample reconstruction.

This is the TLC-parity fallback path, not the device hot path: throughput is
interpreter-bound.  Use it to validate new specs before (or instead of)
writing a compiled model; the differential tests pin the two paths to each
other on every shipped spec.

Relationship to ``frontend.interp.bfs_check``: that one is the *minimal
reference BFS* (raw state tuples, oracle duty in the front-end tests);
this one is the engine-facing checker — time/state budgets with truncation
reporting, per-level sizes, TLC-style rendered traces — mirroring
``engine.bfs.CheckerResult`` so the CLI treats both paths uniformly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from pulsar_tlaplus_tpu_torch.frontend.interp import FDict, MV, Spec, install_defs


def format_value(v) -> str:
    """Render an interpreter value in TLA+ syntax (TLC error-trace style)."""
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, MV):
        return v.name
    if isinstance(v, tuple):
        return "<<" + ", ".join(format_value(x) for x in v) + ">>"
    if isinstance(v, FDict):
        items = v.items
        if items and all(isinstance(k, str) for k, _ in items):
            return (
                "["
                + ", ".join(f"{k} |-> {format_value(x)}" for k, x in items)
                + "]"
            )
        return (
            "("
            + " @@ ".join(
                f"{format_value(k)} :> {format_value(x)}" for k, x in items
            )
            + ")"
        )
    if isinstance(v, frozenset):
        # numeric order within int runs; other types sort by rendering
        key = lambda x: (
            (0, x, "") if isinstance(x, int) and not isinstance(x, bool)
            else (1, 0, str(type(x)) + format_value(x))
        )
        return "{" + ", ".join(format_value(x) for x in sorted(v, key=key)) + "}"
    return repr(v)


def state_dict(spec: Spec, state: Tuple) -> Dict[str, str]:
    """State tuple -> ordered {var: rendered value} (render.py protocol)."""
    return {v: format_value(x) for v, x in zip(spec.vars, state)}


@dataclass
class InterpCheckResult:
    distinct_states: int
    diameter: int
    violation: Optional[str] = None
    trace: Optional[List[Dict[str, str]]] = None
    trace_actions: Optional[List[str]] = None
    deadlock: bool = False
    states_per_sec: float = 0.0
    wall_s: float = 0.0
    level_sizes: List[int] = field(default_factory=list)
    truncated: bool = False


class InterpChecker:
    """Host BFS over the generic interpreter (any spec, any cfg)."""

    def __init__(
        self,
        spec: Spec,
        invariants: Tuple[str, ...] = (),
        check_deadlock: bool = True,
        max_states: int = 10_000_000,
        time_budget_s: Optional[float] = None,
    ):
        self.spec = spec
        unknown = [i for i in invariants if i not in spec.defs]
        if unknown:
            raise ValueError(f"spec defines no invariant(s): {unknown}")
        self.invariant_names = tuple(invariants)
        self.check_deadlock = check_deadlock
        self.max_states = max_states
        self.time_budget_s = time_budget_s

    def _violation(self, state) -> Optional[str]:
        for name in self.invariant_names:
            if not self.spec.eval_predicate(name, state):
                return name
        return None

    def _trace(self, gid: int, log) -> Tuple[list, list]:
        chain = []
        g = gid
        while g >= 0:
            chain.append(g)
            g = log[g][1]
        chain.reverse()
        states = [state_dict(self.spec, log[g][0]) for g in chain]
        actions = [log[g][2] for g in chain[1:]]
        return states, actions

    def run(self) -> InterpCheckResult:
        spec = self.spec
        install_defs(spec)
        t0 = time.time()
        seen: Dict[Tuple, int] = {}
        log: List[Tuple[Tuple, int, Optional[str]]] = []
        level_sizes: List[int] = []

        def result(violation=None, gid=None, deadlock=False, truncated=False):
            wall = time.time() - t0
            r = InterpCheckResult(
                distinct_states=len(seen),
                diameter=len(level_sizes),
                deadlock=deadlock,
                wall_s=wall,
                states_per_sec=len(seen) / max(wall, 1e-9),
                level_sizes=level_sizes,
                truncated=truncated,
            )
            if violation is not None:
                r.violation = violation
            elif deadlock:
                r.violation = "Deadlock"
            if gid is not None:
                r.trace, r.trace_actions = self._trace(gid, log)
            return r

        frontier: List[int] = []
        for s in spec.initial_states():
            if s in seen:
                continue
            gid = len(log)
            seen[s] = gid
            log.append((s, -1, None))
            frontier.append(gid)
            bad = self._violation(s)
            if bad is not None:
                level_sizes.append(len(seen))
                return result(violation=bad, gid=gid)
        level_sizes.append(len(seen))

        while frontier:
            nxt: List[int] = []
            base = len(seen)
            for gid in frontier:
                state = log[gid][0]
                succ = spec.successors(state)
                if self.check_deadlock and not succ:
                    level_sizes.append(len(seen) - base)
                    return result(gid=gid, deadlock=True)
                for label, t in succ:
                    if t in seen:
                        continue
                    tg = len(log)
                    seen[t] = tg
                    log.append((t, gid, label))
                    nxt.append(tg)
                    bad = self._violation(t)
                    if bad is not None:
                        level_sizes.append(len(seen) - base)
                        return result(violation=bad, gid=tg)
                if len(seen) > self.max_states or (
                    self.time_budget_s is not None
                    and time.time() - t0 > self.time_budget_s
                ):
                    level_sizes.append(len(seen) - base)
                    return result(truncated=True)
            if len(seen) == base:
                break
            level_sizes.append(len(seen) - base)
            frontier = nxt
        return result()
