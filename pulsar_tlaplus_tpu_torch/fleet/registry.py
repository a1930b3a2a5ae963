"""Backend registry + health loop + routing policy — the port's copy of
``pulsar_tlaplus_tpu/fleet/registry.py``.

The dispatcher's view of its fleet: one :class:`Backend` per ``serve``
daemon address, refreshed by polling the daemon's own ``ping`` and
``metrics`` verbs — the routing signal IS the public ``ptt_*``
exposition (queue depth, active-job load, admission sheds), so what
the dashboards see is exactly what routing acts on, and a backend
needs no fleet-specific instrumentation to join.

Routing policy:

- only ``up`` backends are eligible; a backend is drained (``down``)
  after ``fail_after`` consecutive poll failures and readmitted only
  after ``readmit_after`` CONSECUTIVE clean polls (hysteresis —
  a flapping backend must not thrash failover: one lucky poll in the
  middle of a die/return cycle is not health).
- a failed or timed-out poll worsens the backend's routing score
  IMMEDIATELY: a hung backend must not coast on its last-known
  -good signal for ``fail_after`` intervals while new work piles
  onto it.
- per-tenant stickiness ONLY while warm locality pays: a tenant's
  last backend is reused while its load is within ``sticky_slack`` of
  the best backend — a hot backend forfeits stickiness, because a
  warm start saved is worth less than a queue stall paid.
- otherwise least-loaded wins: ``queue_depth + running`` weighted
  with a shed penalty (a backend actively shedding is overloaded by
  its OWN admission's judgement, the strongest signal there is).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from pulsar_tlaplus_tpu_torch.obs import metrics as obs_metrics
from pulsar_tlaplus_tpu_torch.service import protocol
from pulsar_tlaplus_tpu_torch.utils import faults

UP = "up"
DOWN = "down"


@dataclass
class Backend:
    """One ``serve`` daemon as the dispatcher sees it."""

    addr: str
    state: str = UP  # optimistic until the first poll says otherwise
    failures: int = 0  # consecutive poll failures
    last_ok_unix: float = 0.0
    pid: Optional[int] = None
    # routing signal, refreshed from ping + metrics each poll
    queue_depth: int = 0
    running: int = 0
    sheds: float = 0.0
    warmed: int = 0
    # submits routed here since the last clean poll: the polled queue
    # depth is up to one health interval stale, so a burst of submits
    # between polls would all see the same score and pile onto one
    # backend — the optimistic bump spreads the burst, and the next
    # poll (whose queue_depth then counts the routed jobs) resets it
    inflight: int = 0
    # consecutive clean polls while DOWN (readmission hysteresis)
    ok_streak: int = 0
    # pending injected poll outcomes ("fail" entries), armed by the
    # partition/flap fault kinds and consumed one per poll
    fault_script: List[str] = field(default_factory=list)

    def score(self) -> float:
        """Lower routes sooner.  Sheds dominate: a backend whose own
        admission control is refusing work must not be handed more.
        A backend with ANY consecutive poll failures scores behind
        every clean backend: a timeout and a refused connect
        degrade routing weight identically and immediately, without
        waiting for the drain threshold."""
        return (
            float(self.queue_depth)
            + float(self.running)
            + float(self.inflight)
            + 4.0 * min(float(self.sheds), 8.0)
            + 1000.0 * float(self.failures)
        )


class BackendRegistry:
    """Thread-safe registry; the dispatcher's health thread calls
    :meth:`poll_once`, its handler threads call :meth:`choose` /
    :meth:`healthy` / :meth:`snapshot`."""

    def __init__(
        self,
        addrs: List[str],
        token: Optional[str] = None,
        fail_after: int = 3,
        timeout: float = 5.0,
        sticky_s: float = 300.0,
        sticky_slack: float = 2.0,
        readmit_after: int = 2,
        log=None,
    ):
        if not addrs:
            raise ValueError("a fleet needs at least one backend")
        self.backends: Dict[str, Backend] = {
            a: Backend(addr=a) for a in addrs
        }
        self.token = token
        self.fail_after = max(1, int(fail_after))
        self.readmit_after = max(1, int(readmit_after))
        # injected-fault sequence counters (PTT_FAULT sites "backend"
        # and "conn"): every individual backend poll advances both
        self._poll_n = 0
        self._conn_n = 0
        self.timeout = timeout
        self.sticky_s = sticky_s
        self.sticky_slack = sticky_slack
        self._log = log or (lambda msg: None)
        self._lock = threading.Lock()
        # tenant -> (addr, unix time of last placement)
        self._sticky: Dict[str, Tuple[str, float]] = {}

    # ------------------------------------------------------- polling

    def _poll_backend(self, b: Backend) -> None:
        auth = {"auth": self.token} if self.token else {}
        ping = protocol.request(
            b.addr, "ping", timeout=self.timeout, **auth
        )
        if not ping.get("ok"):
            raise protocol.ProtocolError(
                f"ping refused: {ping.get('error')}"
            )
        met = protocol.request(
            b.addr, "metrics", timeout=self.timeout, **auth
        )
        if not met.get("ok"):
            raise protocol.ProtocolError(
                f"metrics refused: {met.get('error')}"
            )
        samples, _types = obs_metrics.parse_exposition(
            met.get("metrics", "")
        )

        def total(name: str, want: Optional[Dict[str, str]] = None):
            out = 0.0
            for labels, value in samples.get(name, []):
                if want and any(
                    labels.get(k) != v for k, v in want.items()
                ):
                    continue
                out += value
            return out

        b.pid = ping.get("pid")
        b.queue_depth = int(total("ptt_queue_depth"))
        b.running = int(total("ptt_jobs", {"state": "running"}))
        b.sheds = total("ptt_admission_shed_total")
        b.warmed = len(ping.get("warmed") or [])

    def poll_once(self) -> Tuple[List[Backend], List[Backend]]:
        """One health pass over every backend.  Returns
        ``(newly_down, newly_up)``: the backends that transitioned
        up -> down this pass (the dispatcher's failover trigger
        fires exactly once per outage) and the ones readmitted this
        pass after ``readmit_after`` consecutive clean polls (the
        dispatcher's lost-job reconciliation trigger).

        Injected network faults (PTT_FAULT) are realized here:
        ``partition@backend:N`` arms ``fail_after`` consecutive
        injected poll failures on the N-th polled backend (enough to
        drain it — the backend stays alive); ``flap@backend:N`` arms
        a die/return cycle (drain, one clean poll, drain again, one
        clean poll) that only hysteresis survives without a second
        failover; ``slow@conn:N`` stalls the N-th outbound poll past
        the timeout — a hung backend, exercising the same failure
        path as a refused connect."""
        newly_down: List[Backend] = []
        newly_up: List[Backend] = []
        for b in list(self.backends.values()):
            self._poll_n += 1
            hits = faults.poll("backend", self._poll_n)
            if "partition" in hits:
                b.fault_script.extend(["fail"] * self.fail_after)
            if "flap" in hits:
                b.fault_script.extend(
                    ["fail"] * self.fail_after + ["ok"]
                    + ["fail"] * self.fail_after + ["ok"]
                )
            try:
                if b.fault_script and b.fault_script.pop(0) == "fail":
                    raise OSError(
                        f"injected partition: {b.addr} unreachable "
                        "(PTT_FAULT)"
                    )
                self._conn_n += 1
                if "slow" in faults.poll("conn", self._conn_n):
                    time.sleep(self.timeout)
                    raise TimeoutError(
                        f"injected slow poll: {b.addr} exceeded "
                        f"{self.timeout:.1f}s (PTT_FAULT)"
                    )
                self._poll_backend(b)
            except (OSError, protocol.ProtocolError, ValueError) as e:
                with self._lock:
                    b.failures += 1
                    b.ok_streak = 0
                    if b.failures >= self.fail_after and b.state == UP:
                        b.state = DOWN
                        newly_down.append(b)
                        self._log(
                            f"fleet: backend {b.addr} drained after "
                            f"{b.failures} failed polls ({e!r:.80})"
                        )
                continue
            with self._lock:
                if b.state == DOWN:
                    # readmission hysteresis: one clean poll in the
                    # middle of a flap cycle is not health
                    b.ok_streak += 1
                    if b.ok_streak < self.readmit_after:
                        b.failures = 0
                        continue
                    self._log(
                        f"fleet: backend {b.addr} rejoined after "
                        f"{b.ok_streak} consecutive clean polls"
                    )
                    b.state = UP
                    newly_up.append(b)
                b.failures = 0
                b.ok_streak = 0
                b.last_ok_unix = time.time()
                b.inflight = 0  # the fresh queue_depth counts them
        return newly_down, newly_up

    # ------------------------------------------------------- routing

    def healthy(self) -> List[Backend]:
        with self._lock:
            return [b for b in self.backends.values() if b.state == UP]

    def choose(self, tenant: str) -> Tuple[Optional[Backend], str]:
        """The backend for one submit + the routing reason
        (``sticky`` / ``least_loaded`` / ``only_backend``), or
        ``(None, "no_backend")`` when the whole fleet is down — the
        caller turns that into the typed ``backend_unavailable``
        rejection."""
        up = self.healthy()
        if not up:
            return None, "no_backend"
        with self._lock:
            if len(up) == 1:
                b = up[0]
                self._sticky[tenant] = (b.addr, time.time())
                b.inflight += 1
                return b, "only_backend"
            best = min(up, key=lambda b: b.score())
            prev = self._sticky.get(tenant)
            if prev is not None:
                addr, placed = prev
                cand = self.backends.get(addr)
                if (
                    cand is not None
                    and cand.state == UP
                    and time.time() - placed <= self.sticky_s
                    and cand.score()
                    <= best.score() + self.sticky_slack
                ):
                    self._sticky[tenant] = (cand.addr, time.time())
                    cand.inflight += 1
                    return cand, "sticky"
            self._sticky[tenant] = (best.addr, time.time())
            best.inflight += 1
            return best, "least_loaded"

    def snapshot(self) -> Dict[str, str]:
        """addr -> state, for the ``ptt_fleet_backends`` gauge."""
        with self._lock:
            return {a: b.state for a, b in self.backends.items()}

    def detail_snapshot(self) -> Dict[str, dict]:
        """addr -> full routing view, for the fleet flight deck
        (``cli.py top --dispatch``): everything :meth:`choose`
        weighs — score, load signal, shed pressure, warm artifacts,
        failure streaks — plus how many tenants are currently sticky
        to each backend, so the deck shows WHY routing goes where it
        goes, not just where."""
        now = time.time()
        with self._lock:
            sticky_n: Dict[str, int] = {}
            for addr, placed in self._sticky.values():
                if now - placed <= self.sticky_s:
                    sticky_n[addr] = sticky_n.get(addr, 0) + 1
            return {
                a: {
                    "state": b.state,
                    "score": round(b.score(), 3),
                    "queue_depth": b.queue_depth,
                    "running": b.running,
                    "inflight": b.inflight,
                    "sheds": b.sheds,
                    "warmed": b.warmed,
                    "failures": b.failures,
                    "ok_streak": b.ok_streak,
                    "pid": b.pid,
                    "last_ok_unix": b.last_ok_unix,
                    "sticky_tenants": sticky_n.get(a, 0),
                }
                for a, b in self.backends.items()
            }

    # ------------------------------------------- sticky persistence

    def sticky_snapshot(self) -> Dict[str, List]:
        """JSON-friendly copy of the per-tenant stickiness table —
        persisted with the job table so a restarted dispatcher
        (``--recover``) keeps warm locality instead of re-spreading
        every tenant cold."""
        with self._lock:
            return {
                t: [addr, placed]
                for t, (addr, placed) in self._sticky.items()
            }

    def restore_sticky(self, snap) -> None:
        """Reload a :meth:`sticky_snapshot`; entries naming unknown
        backends are dropped (the fleet may have been reconfigured
        across the restart)."""
        if not isinstance(snap, dict):
            return
        with self._lock:
            for tenant, pair in snap.items():
                try:
                    addr, placed = pair
                except (TypeError, ValueError):
                    continue
                if addr in self.backends:
                    self._sticky[str(tenant)] = (addr, float(placed))
