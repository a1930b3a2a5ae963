"""Job model for the checker daemon — the port's copy of
``pulsar_tlaplus_tpu/service/jobs.py`` (pure Python, no device).

A job is one queued check: a registry spec, a ``.cfg`` constant
binding, an optional invariant selection, and a state/time budget.
Each job owns a directory under ``<state_dir>/jobs/<job_id>/`` holding
its checkpoint frame (per-job isolation — two jobs time-slicing the
mesh can never clobber each other's resumable state), its telemetry
stream (one engine run_id per scheduling slice, chained by the
frames' resume linking), and its final result record.

Jobs serialize to plain JSON dicts so the daemon's ``queue.json``
(written atomically on every transition) survives restarts —
``serve --recover`` rebuilds the scheduler from it.
"""

from __future__ import annotations

import os
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

# job lifecycle: queued -> running -> (suspended -> running)* ->
# done | failed | cancelled.  A suspended job holds a resumable
# checkpoint frame; a crashed daemon's "running" jobs re-enter as
# suspended (frame on disk) or queued (no frame yet) on recovery.
QUEUED = "queued"
RUNNING = "running"
SUSPENDED = "suspended"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"

STATES = (QUEUED, RUNNING, SUSPENDED, DONE, FAILED, CANCELLED)
TERMINAL = frozenset((DONE, FAILED, CANCELLED))


def new_job_id() -> str:
    # 80 CSPRNG bits: job ids double as capability-ish handles on the
    # TCP transport, so they
    # must be unguessable, not merely unique (uuid4().hex prefixes
    # carry fixed version/variant nibbles; token_hex is all random)
    import secrets

    return secrets.token_hex(10)


@dataclass
class Job:
    job_id: str
    spec: str  # registry module name ("compaction", "bookkeeper", ...)
    cfg_path: str  # .cfg constant bindings (server-local path)
    dir: str  # <state_dir>/jobs/<job_id>
    invariants: Optional[List[str]] = None  # None = the cfg INVARIANTS
    max_states: Optional[int] = None  # None = the service default
    time_budget_s: Optional[float] = None  # cumulative across slices
    # open-network identity + scheduling class: the tenant is
    # DERIVED from the presented bearer token (never client-claimed
    # over TCP; "local" on the trusted unix socket); priority orders
    # the claim (higher first, FIFO within a class, and a waiting
    # higher-priority job preempts a running lower one at its next
    # level boundary); deadline_unix is the absolute wall instant
    # past which the job is cancelled with stop_reason="deadline";
    # submit_id is the client-supplied idempotency key — a retried
    # submit with the same (tenant, submit_id) returns the SAME job
    tenant: str = "local"
    priority: int = 0
    deadline_unix: Optional[float] = None
    submit_id: Optional[str] = None
    # distributed tracing: the fleet dispatcher mints one
    # trace_id per accepted submit and forwards it on the wire; a
    # standalone daemon mints its own at submit.  It is echoed into
    # every job_* telemetry event and the engine run_header, so the
    # trace stitcher (obs/trace.py --fleet) joins dispatcher hops to
    # backend slices across machines
    trace_id: Optional[str] = None
    # workload mode: "check" = exhaustive BFS (the default),
    # "simulate" = the streaming walker swarm (sim/engine.py) — a
    # simulation job time-slices at SEGMENT boundaries through the
    # same suspend/resume primitive, and ``sim`` carries its knobs
    # (n_walkers, depth, segment_len, seed, max_steps)
    mode: str = "check"
    sim: Optional[dict] = None
    # incremental checking (warm/): ``warm`` is the submit-time
    # opt-in (False = --no-warm: never reuse, never harvest);
    # ``warm_mode`` is what the planner chose (continue/reseed/cold,
    # demoted at install if the artifact fails its digest verify),
    # ``warm_reason`` the machine-readable cause, ``warm_artifact``
    # the planned artifact dir, ``warm_widened`` the axis -> [old,
    # new] widening map a reseed replays over
    warm: bool = True
    warm_mode: Optional[str] = None
    warm_reason: Optional[str] = None
    warm_artifact: Optional[str] = None
    warm_widened: Optional[dict] = None
    # a reseeded job's trace-depth allowance: the artifact's original
    # level count (its merged seed levels no longer bound chain depth)
    warm_seed_levels: Optional[int] = None
    state: str = QUEUED
    submitted_unix: float = field(default_factory=lambda: time.time())
    started_unix: Optional[float] = None
    finished_unix: Optional[float] = None
    slices: int = 0  # scheduling quanta consumed
    suspends: int = 0  # times preempted at a frame boundary
    run_ids: List[str] = field(default_factory=list)  # one per slice
    wall_s: float = 0.0  # cumulative engine wall (budget accounting)
    progress: Optional[dict] = None  # last suspended slice's headline
    #   counts, so a budget-exhausted completion still reports them
    error: Optional[str] = None
    cancel_requested: bool = False
    result: Optional[dict] = None

    # ------------------------------------------------------- paths

    @property
    def frame_path(self) -> str:
        return os.path.join(self.dir, "frame.npz")

    @property
    def events_path(self) -> str:
        return os.path.join(self.dir, "events.jsonl")

    @property
    def result_path(self) -> str:
        return os.path.join(self.dir, "result.json")

    @property
    def record_path(self) -> str:
        """The per-job submit record (``job.json``): the static
        submit-time fields, written once at submit so a corrupt
        ``queue.json`` can be REBUILT from the job dirs alone
        (``serve --recover`` torn-queue recovery)."""
        return os.path.join(self.dir, "job.json")

    # ------------------------------------------------ (de)serialize

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Job":
        known = {k: d[k] for k in cls.__dataclass_fields__ if k in d}
        job = cls(**known)
        if job.state not in STATES:
            raise ValueError(f"unknown job state {job.state!r}")
        return job

    def summary(self) -> Dict[str, object]:
        """The status-wire view: everything but the (possibly large)
        result payload, plus the headline result fields when done."""
        s = {
            "job_id": self.job_id,
            "spec": self.spec,
            "cfg_path": self.cfg_path,
            "state": self.state,
            "tenant": self.tenant,
            "mode": self.mode,
            "priority": self.priority,
            "submitted_unix": round(self.submitted_unix, 3),
            "slices": self.slices,
            "suspends": self.suspends,
            "run_ids": list(self.run_ids),
            "wall_s": round(self.wall_s, 3),
        }
        if self.submit_id:
            # the idempotency key joins this backend-side record to
            # the dispatcher's routing table: `dispatch --recover`
            # reconciles against the listing by submit_id
            s["submit_id"] = self.submit_id
        if self.trace_id:
            s["trace_id"] = self.trace_id
        if self.warm_mode is not None:
            s["warm_mode"] = self.warm_mode
            s["warm_reason"] = self.warm_reason
        if self.deadline_unix is not None:
            s["deadline_unix"] = round(self.deadline_unix, 3)
        if self.error:
            s["error"] = self.error
        if self.result:
            for k in (
                "distinct_states", "diameter", "violation",
                "truncated", "stop_reason", "status",
                # simulation headline counters
                "steps", "states_visited", "walks",
            ):
                if k in self.result:
                    s[k] = self.result[k]
        return s

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL
