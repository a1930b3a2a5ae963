"""The fleet dispatcher daemon (``cli.py dispatch``) — the port's copy
of ``pulsar_tlaplus_tpu/fleet/dispatcher.py``.

One authenticated endpoint fronting N ``serve`` backends, speaking
the SAME wire protocol — a client pointed at the dispatcher needs
zero changes.  The dispatcher holds no checker, no device, no queue
of its own: it is a routing table (fleet/registry.py), a job->backend
map persisted to ``fleet_jobs.json``, and a health thread.

Per request:

- ``submit`` is placed by :meth:`BackendRegistry.choose` (live
  ``ptt_*`` signal + warm stickiness) and forwarded verbatim — with a
  dispatcher-pinned ``submit_id`` so a failover resubmit later rides
  the backend's idempotent dedup path.  A whole-fleet outage answers
  the typed ``backend_unavailable`` rejection (client exit 2 — a
  routing failure must never read as a spec verdict).
- ``status``/``result``/``cancel`` are proxied to the owning backend;
  ``watch`` relays the backend's stream line-for-line.
- ``metrics`` renders the dispatcher's OWN ``ptt_fleet_*`` families
  (obs/metrics.py ``fleet_metrics``) from host-side counters — a
  scrape never costs a backend round-trip.  With ``aggregate`` set
  (``cli.py metrics --aggregate``) every LIVE backend is scraped too
  and its families re-emitted under a ``backend`` label beside fleet
  rollups (obs/metrics.py ``aggregate_exposition``) — one poll, the
  whole fleet.

Observability: every accepted submit is minted a ``trace_id`` that
rides the wire to the chosen backend (echoed into its ``job_*`` events
and the engine ``run_header``) and stamps every dispatcher-side hop —
route, replicate, failover, reconcile, hold/shed, watch-relay leg,
terminal ``complete`` — so ``cli.py trace`` stitches one causal chain
per job across the dispatcher's and the backends' streams.
Route/ack/failover/reconcile/relay/e2e latencies are observed into
fixed-bucket histograms (obs/metrics.py ``LATENCY_BUCKETS_S``) rendered
as Prometheus ``ptt_fleet_*_seconds`` families.

The health thread drives everything asynchronous: registry polls
(drain after ``fail_after`` consecutive failures), failover (a
drained backend's queued — not running — jobs resubmitted elsewhere
through ``submit_id`` dedup), and warm-artifact replication (a job
reaching a terminal state triggers a sieve pass from its owner to
every peer, fleet/replicate.py, so the NEXT submit warm-starts
anywhere).

Auth model: clients authenticate to the dispatcher exactly as to a
single daemon (bearer token over TCP, trusted unix socket locally).
The dispatcher forwards the client's own token to TCP backends —
per-tenant quotas and telemetry attribution hold end-to-end — and
authenticates AS ``auth.FLEET_TENANT`` for its own polling and
replication traffic.

Survivability:

- **Crash-safe**: every routing decision, stickiness entry, and
  failover transition is persisted through the atomic tmp+replace
  discipline BEFORE the client is acked; a persist failure retries
  once (the scheduler's ENOSPC semantics) and is counted in
  ``persist_failures`` instead of silently running memory-only.
  ``dispatch --recover`` quarantines a torn ``fleet_jobs.json`` and
  rebuilds the job table by re-polling every backend's authoritative
  job table — an acked submit resolves exactly-once after a kill -9.
- **Partition-tolerant**: the registry drains on timeouts as fast as
  on refused connects, readmits only after ``readmit_after``
  consecutive clean polls (flap hysteresis), and an all-backends-down
  window degrades to a bounded queue-and-hold (``hold_max`` held
  submits for up to ``hold_s`` each; past the buffer, a typed
  ``capacity`` shed) — never a crash, never a hang.
- **Lost-job reconciliation**: a drained backend that rejoins is
  re-polled for the jobs the dispatcher typed ``lost`` — finished
  ones deliver their real result (``lost`` -> terminal with a
  ``reconciled`` marker), still-running ones resume watch relay;
  exactly-once is the existing ``submit_id`` dedup.
"""

from __future__ import annotations

import fcntl
import json
import os
import signal
import socket
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from pulsar_tlaplus_tpu_torch.fleet import replicate as replmod
from pulsar_tlaplus_tpu_torch.fleet.registry import BackendRegistry
from pulsar_tlaplus_tpu_torch.obs import metrics as metrics_mod
from pulsar_tlaplus_tpu_torch.obs import telemetry as obs
from pulsar_tlaplus_tpu_torch.service import auth as authmod
from pulsar_tlaplus_tpu_torch.service import jobs as jobmod
from pulsar_tlaplus_tpu_torch.service import protocol
from pulsar_tlaplus_tpu_torch.utils import faults

# job-table states the dispatcher itself assigns (beyond jobs.STATES):
# a job that was RUNNING on a backend that died is not silently
# resubmitted (its partial warm artifact may not have replicated yet
# — the operator or client resubmits through the dispatcher and lands
# warm wherever replication reached)
LOST = "lost"

# watch relays run in legs of this many seconds: the owner is
# re-resolved between legs so a failover reroutes the relay even when
# the old backend keeps its established stream open (a gracefully
# draining daemon never severs connections — only the leg boundary
# lets the relay notice the job will never run there again)
_WATCH_RELAY_LEG_S = 2.0

# submit fields forwarded verbatim to the chosen backend
_SUBMIT_FIELDS = (
    "spec", "cfg", "invariants", "max_states", "time_budget_s",
    "priority", "deadline_s", "mode", "sim", "warm",
)


def _write_json_atomic(path: str, obj, _inject=None):
    """Write ``obj`` as JSON through a per-process tmp +
    ``os.replace``, removing the half-written tmp on failure.
    Returns None on success, the ``OSError`` on failure — the same
    contract as the scheduler's helper, so the dispatcher's persist
    path gets the same retry-or-log discipline (``_inject`` is the
    PTT_FAULT hook)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            if _inject is not None:
                raise _inject
            json.dump(obj, f)
        os.replace(tmp, path)
        return None
    except OSError as e:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return e


@dataclass
class FleetConfig:
    state_dir: str
    backends: Tuple[str, ...] = ()
    socket_path: str = ""  # default <state_dir>/dispatch.sock
    tcp: str = ""  # HOST:PORT for the authenticated client listener
    tokens_path: str = ""
    health_interval_s: float = 0.5
    fail_after: int = 3
    backend_timeout_s: float = 10.0
    sticky_s: float = 300.0
    replicate: bool = True
    telemetry_path: str = ""  # default <state_dir>/dispatch.jsonl
    # survivability knobs
    readmit_after: int = 2  # consecutive clean polls to rejoin
    recover: bool = False  # rebuild the job table from backends
    hold_max: int = 16  # all-backends-down: held submits before shed
    hold_s: float = 10.0  # ... and how long each waits for a backend

    def __post_init__(self):
        if not self.socket_path:
            self.socket_path = os.path.join(
                self.state_dir, "dispatch.sock"
            )
        if not self.telemetry_path:
            self.telemetry_path = os.path.join(
                self.state_dir, "dispatch.jsonl"
            )

    @property
    def jobs_path(self) -> str:
        return os.path.join(self.state_dir, "fleet_jobs.json")


class FleetDispatcher:
    def __init__(self, config: FleetConfig, log=None):
        if not config.backends:
            raise ValueError(
                "dispatch needs at least one --backend ADDR"
            )
        self.config = config
        os.makedirs(config.state_dir, exist_ok=True)
        self._log = log or (lambda m: None)
        self._lock_fd: Optional[int] = None
        self._acquire_state_lock()
        self.tel = obs.Telemetry(config.telemetry_path)
        self.tokens: dict = {}
        if config.tokens_path:
            self.tokens = authmod.load_tokens(config.tokens_path)
        if config.tcp and not self.tokens:
            raise ValueError(
                "dispatch --tcp requires --tokens TOKENS.json: the "
                "TCP transport is authenticated"
            )
        # tenant -> token (first wins), for forwarding on behalf of a
        # tenant during failover resubmit; the FLEET_TENANT entry is
        # the dispatcher's own identity toward TCP backends
        self._tenant_tokens: Dict[str, str] = {}
        for token, tenant in self.tokens.items():
            self._tenant_tokens.setdefault(tenant, token)
        self.fleet_token = self._tenant_tokens.get(
            authmod.FLEET_TENANT
        )
        if any(protocol.is_tcp(a) for a in config.backends) and (
            self.fleet_token is None
        ):
            raise ValueError(
                "TCP backends need a tokens.json entry for tenant "
                f"{authmod.FLEET_TENANT!r} (the dispatcher's own "
                "identity for health polls and replication)"
            )
        self.registry = BackendRegistry(
            list(config.backends),
            token=self.fleet_token,
            fail_after=config.fail_after,
            timeout=config.backend_timeout_s,
            sticky_s=config.sticky_s,
            readmit_after=config.readmit_after,
            log=self._log,
        )
        self._tcp_addr = None
        if config.tcp:
            self._tcp_addr = protocol.parse_tcp(
                protocol.TCP_PREFIX + config.tcp
            )
        # job_id -> {backend, tenant, state, submit_id, submit{...},
        #            done_handled}
        self._jobs: Dict[str, dict] = {}
        self._jobs_lock = threading.Lock()
        # persist bookkeeping: sequence counter for the
        # PTT_FAULT "persist" site + the public failure counter
        self._persist_n = 0
        self.persist_failures = 0
        self._quarantined_path: Optional[str] = None
        self._load_jobs()
        # all-backends-down queue-and-hold: submits held while
        # the fleet recovers, bounded so the buffer can't grow
        # without limit — past it, a typed `capacity` shed
        self._held = 0
        self._held_lock = threading.Lock()
        # host-side counters behind metrics_snapshot()
        self._ctr_lock = threading.Lock()
        self._routes: Dict[Tuple[str, str], float] = {}
        self._route_s = 0.0
        self._repl_blobs: Dict[str, float] = {}
        self._repl_bytes: Dict[str, float] = {}
        self._failovers: Dict[str, float] = {}
        self._resub: Dict[str, float] = {}
        self._reconciled: Dict[str, float] = {}
        self._partitions: Dict[str, float] = {}
        self._recoveries = 0.0
        self._held_sheds = 0.0
        self._holds = 0.0
        # fixed-bucket latency histograms: observed live at
        # each hop, rendered by fleet_metrics, re-derivable from the
        # telemetry stream (stream_metrics parity)
        self._hists = metrics_mod.new_fleet_hists()
        # failover/reconcile latency accumulators (bench_schema 11)
        self._failover_s = 0.0
        self._failover_n = 0
        self._reconcile_s = 0.0
        self._reconcile_n = 0
        self._sock: Optional[socket.socket] = None
        self._tcp_sock: Optional[socket.socket] = None
        self.tcp_port: Optional[int] = None
        self._accept_threads: list = []
        self._health_thread: Optional[threading.Thread] = None
        self._shutdown_evt = threading.Event()
        self._shutdown_done = threading.Event()
        self._t0 = time.time()
        self._auth_seen: set = set()
        self._auth_seen_lock = threading.Lock()

    def _acquire_state_lock(self) -> None:
        """One dispatcher per state dir (same flock discipline as
        server.py: kernel-released on any process death)."""
        path = os.path.join(self.config.state_dir, "dispatch.lock")
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            pid = b"?"
            try:
                pid = os.pread(fd, 32, 0).strip() or b"?"
            except OSError:
                pass
            os.close(fd)
            raise RuntimeError(
                f"another dispatcher (pid {pid.decode()}) already "
                f"serves {self.config.state_dir}"
            ) from None
        os.ftruncate(fd, 0)
        os.pwrite(fd, str(os.getpid()).encode(), 0)
        self._lock_fd = fd

    # --------------------------------------------------- job table

    def _load_jobs(self) -> None:
        """Load ``fleet_jobs.json``; a torn or corrupt file is
        QUARANTINED (renamed aside, like the scheduler's torn-queue
        recovery) instead of silently ignored — ``--recover`` then
        rebuilds the table from the backends' authoritative job
        tables, so quarantine never strands an acked job."""
        try:
            with open(self.config.jobs_path) as f:
                snap = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, json.JSONDecodeError, ValueError) as e:
            self._quarantine_jobs_file(e)
            return
        if isinstance(snap, dict) and isinstance(
            snap.get("jobs"), dict
        ):
            self._jobs = {
                str(k): v
                for k, v in snap["jobs"].items()
                if isinstance(v, dict)
            }
            self.registry.restore_sticky(snap.get("sticky"))
        else:
            self._quarantine_jobs_file(
                ValueError("unrecognized fleet_jobs.json shape")
            )

    def _quarantine_jobs_file(self, err: BaseException) -> None:
        dst = f"{self.config.jobs_path}.corrupt.{int(time.time())}"
        try:
            os.replace(self.config.jobs_path, dst)
        except OSError:
            return
        self._quarantined_path = dst
        self._log(
            f"fleet: fleet_jobs.json unreadable ({err!r:.120}); "
            f"quarantined to {dst} — run dispatch --recover to "
            "rebuild from the backends"
        )

    def _save_jobs_locked(self) -> None:
        """Atomic tmp+replace persist with the scheduler's
        retry-once semantics: the first failure frees the tmp and
        retries immediately (a transient ENOSPC often clears);
        the second is counted in ``persist_failures`` and surfaced
        in ``ptt_fleet_*`` + the status listing — the dispatcher
        keeps serving, the NEXT transition retries."""
        snap = {
            "fleet_jobs_v": 2,
            "jobs": self._jobs,
            "sticky": self.registry.sticky_snapshot(),
        }
        self._persist_n += 1
        inject = "enospc" in faults.poll("persist", self._persist_n)
        for attempt in (0, 1):
            err = _write_json_atomic(
                self.config.jobs_path, snap,
                _inject=(
                    faults.enospc_error("persist", self._persist_n)
                    if inject and attempt == 0
                    else None
                ),
            )
            if err is None:
                return
            if attempt == 1:
                self.persist_failures += 1
                # the event carries the CUMULATIVE counter (not a
                # delta) so a stream replay reconstructs the same
                # ptt_fleet_persist_failures_total value without
                # double-counting (newest wins)
                self.tel.emit(
                    "persist_fail", n=self.persist_failures
                )
                self._log(
                    f"fleet: fleet_jobs.json persist FAILED "
                    f"({err!r:.120}); continuing — next transition "
                    "retries"
                )

    def _record_job(self, job_id: str, rec: dict) -> None:
        with self._jobs_lock:
            self._jobs[job_id] = rec
            self._save_jobs_locked()

    def _update_job(self, job_id: str, **fields) -> None:
        with self._jobs_lock:
            rec = self._jobs.get(job_id)
            if rec is None:
                return
            rec.update(fields)
            self._save_jobs_locked()

    # ----------------------------------------------------- metrics

    def metrics_snapshot(self) -> dict:
        """Host-side counter copies for ``obs.metrics.fleet_metrics``
        — never a backend round-trip."""
        with self._ctr_lock:
            return {
                "backends": self.registry.snapshot(),
                "routes": dict(self._routes),
                "route_s": self._route_s,
                "repl_blobs": dict(self._repl_blobs),
                "repl_bytes": dict(self._repl_bytes),
                "failovers": dict(self._failovers),
                "resubmitted": dict(self._resub),
                "reconciled": dict(self._reconciled),
                "partitions": dict(self._partitions),
                "recoveries": self._recoveries,
                "persist_failures": float(self.persist_failures),
                "held_sheds": self._held_sheds,
                "holds": self._holds,
                "hists": {
                    k: h.copy() for k, h in self._hists.items()
                },
                "failover_s": self._failover_s,
                "failover_n": self._failover_n,
                "reconcile_s": self._reconcile_s,
                "reconcile_n": self._reconcile_n,
            }

    def _observe(self, family: str, ms: Optional[float]) -> None:
        """Fold one latency sample (milliseconds) into the live
        ``ptt_fleet_*_seconds`` histogram for ``family``.  The sample
        is rounded exactly like the emitted ``*_ms`` field so stream
        replay re-bins IDENTICALLY to the live scrape — an unrounded
        live sample could land one bucket off at a boundary."""
        if ms is None:
            return
        with self._ctr_lock:
            hist = self._hists.get(family)
            if hist is not None:
                hist.observe(round(ms, 3) / 1000.0)

    # ---------------------------------------------------- recovery

    def recover(self) -> None:
        """Rebuild the routing table and in-flight map after a crash
        (``dispatch --recover``).  ``fleet_jobs.json`` is the acked
        intent; each backend's own job table is the authority on what
        actually landed.  Re-polling every backend reconciles the
        two: tracked jobs take the backend's current state, jobs the
        dispatcher routed but cannot find anywhere are typed
        ``lost`` (their backend is down or forgot them), and jobs a
        backend holds under a known ``submit_id`` that the (possibly
        quarantined) table lost are re-adopted — an acked submit
        resolves exactly-once either way."""
        t0 = time.monotonic()
        with self._jobs_lock:
            known = {jid: dict(rec) for jid, rec in self._jobs.items()}
        by_submit_id = {
            rec.get("submit_id"): jid
            for jid, rec in known.items()
            if rec.get("submit_id") and not rec.get("alias_of")
        }
        confirmed: set = set()
        adopted = 0
        unreachable: List[str] = []
        for addr in self.config.backends:
            auth = self.fleet_token if protocol.is_tcp(addr) else None
            try:
                resp = protocol.request(
                    addr, "status",
                    timeout=self.config.backend_timeout_s,
                    **({"auth": auth} if auth else {}),
                )
            except (OSError, protocol.ProtocolError) as e:
                unreachable.append(addr)
                self._log(
                    f"fleet: recover could not reach {addr} "
                    f"({e!r:.120}) — its jobs stay as persisted"
                )
                continue
            if not resp.get("ok"):
                unreachable.append(addr)
                continue
            for summ in resp.get("jobs") or []:
                bjid = summ.get("job_id")
                state = summ.get("state")
                if not bjid or not state:
                    continue
                jid = None
                if bjid in known:
                    jid = bjid
                elif summ.get("submit_id") in by_submit_id:
                    # the backend knows this submit under a fresh id
                    # (a failover resubmit the old dispatcher never
                    # recorded): re-alias instead of re-adopting
                    jid = by_submit_id[summ.get("submit_id")]
                    self._update_job(jid, backend_job_id=bjid)
                if jid is not None:
                    confirmed.add(jid)
                    rec = known.get(jid) or {}
                    if rec.get("alias_of"):
                        # a failed-over job answers under the id its new
                        # backend minted: the job it aliases lives here
                        # (left unconfirmed, a running one would be
                        # typed lost while it runs)
                        jid = rec["alias_of"]
                        confirmed.add(jid)
                    terminal = state in (
                        jobmod.DONE, jobmod.FAILED, jobmod.CANCELLED,
                    )
                    self._update_job(
                        jid, backend=addr, state=state,
                        **(
                            {"done_handled": True} if terminal else {}
                        ),
                    )
                    continue
                if summ.get("submit_id"):
                    # routed by a previous life of this dispatcher
                    # (or quarantined out of the table): adopt it so
                    # status/result/watch resolve again
                    adopted += 1
                    self._record_job(
                        bjid,
                        {
                            "backend": addr,
                            "tenant": summ.get(
                                "tenant", authmod.LOCAL_TENANT
                            ),
                            "state": state,
                            "submit_id": summ.get("submit_id"),
                            "submit": {},
                            "done_handled": False,
                            "recovered": True,
                        },
                    )
        lost = 0
        unreachable_set = set(unreachable)
        for jid, rec in known.items():
            if jid in confirmed or rec.get("alias_of"):
                continue
            if rec.get("state") in (
                jobmod.DONE, jobmod.FAILED, jobmod.CANCELLED, LOST,
            ):
                continue
            if rec.get("backend") in unreachable_set:
                continue  # the health loop will drain + fail it over
            # the backend answered and does not know the job: the
            # acked record is the only trace left — type it lost so
            # the client gets the truth, never a silent drop
            lost += 1
            self._update_job(jid, state=LOST)
        with self._ctr_lock:
            self._recoveries += 1
        self.tel.emit(
            "recover",
            jobs=len(known),
            confirmed=len(confirmed),
            adopted=adopted,
            lost=lost,
            quarantined=bool(self._quarantined_path),
            wall_ms=round((time.monotonic() - t0) * 1000.0, 3),
        )
        self._log(
            f"fleet: recover reconciled {len(known)} persisted "
            f"job(s) against {len(self.config.backends)} backend(s): "
            f"{len(confirmed)} confirmed, {adopted} adopted, "
            f"{lost} lost, {len(unreachable)} backend(s) unreachable"
        )

    # --------------------------------------------------- lifecycle

    def start(self) -> None:
        if self.config.recover:
            self.recover()
        try:
            os.remove(self.config.socket_path)
        except OSError:
            pass
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(self.config.socket_path)
        s.listen(16)
        s.settimeout(0.5)
        self._sock = s
        if self._tcp_addr is not None:
            host, port = self._tcp_addr
            ts = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ts.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ts.bind((host, port))
            ts.listen(16)
            ts.settimeout(0.5)
            self._tcp_sock = ts
            self.tcp_port = ts.getsockname()[1]
            self._log(
                f"fleet TCP listener on {host}:{self.tcp_port} "
                f"({len(self.tokens)} tenant token(s) loaded)"
            )
        self.tel.emit(
            "serve",
            action="start",
            socket=self.config.socket_path,
            tcp_port=self.tcp_port,
            pid=os.getpid(),
            warmed=[],
            wall_unix=round(time.time(), 3),
        )
        # one synchronous poll before accepting: first submits route
        # on real signal, not the optimistic all-up default
        self.registry.poll_once()
        listeners = [(s, True)]
        if self._tcp_sock is not None:
            listeners.append((self._tcp_sock, False))
        for sock, trusted in listeners:
            t = threading.Thread(
                target=self._accept_loop, args=(sock, trusted),
                name="ptt-dispatch-accept", daemon=True,
            )
            t.start()
            self._accept_threads.append(t)
        self._health_thread = threading.Thread(
            target=self._health_loop, name="ptt-fleet-health",
            daemon=True,
        )
        self._health_thread.start()
        self._log(
            f"dispatching {len(self.config.backends)} backend(s) on "
            f"{self.config.socket_path}"
        )

    def install_signal_handlers(self) -> None:
        def _handle(signum, frame):
            self._log(
                f"{signal.Signals(signum).name} received: stopping "
                "the dispatcher (backends keep running)"
            )
            self.request_shutdown()

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _handle)

    def request_shutdown(self) -> None:
        self._shutdown_evt.set()

    def wait_shutdown(self, timeout: Optional[float] = None) -> None:
        self._shutdown_evt.wait(timeout)
        if self._shutdown_evt.is_set():
            self.shutdown()

    def serve_forever(self) -> None:
        while not self._shutdown_evt.is_set():
            self._shutdown_evt.wait(0.2)
        self.shutdown()

    def shutdown(self) -> None:
        if self._shutdown_done.is_set():
            return
        self._shutdown_done.set()
        self._shutdown_evt.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=30.0)
        for attr in ("_sock", "_tcp_sock"):
            sock = getattr(self, attr)
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
                setattr(self, attr, None)
        try:
            os.remove(self.config.socket_path)
        except OSError:
            pass
        with self._jobs_lock:
            self._save_jobs_locked()
        self.tel.emit("serve", action="stop", pid=os.getpid())
        self.tel.close()
        if self._lock_fd is not None:
            try:
                os.close(self._lock_fd)
            except OSError:
                pass
            self._lock_fd = None
        self._log("dispatcher shutdown complete (backends untouched)")

    # ------------------------------------------------ health thread

    def _health_loop(self) -> None:
        while not self._shutdown_evt.is_set():
            try:
                newly_down, newly_up = self.registry.poll_once()
                for b in newly_down:
                    t0 = time.monotonic()
                    self._failover(b)
                    with self._ctr_lock:
                        self._failover_s += time.monotonic() - t0
                        self._failover_n += 1
                for b in newly_up:
                    t0 = time.monotonic()
                    self._reconcile(b)
                    with self._ctr_lock:
                        self._reconcile_s += time.monotonic() - t0
                        self._reconcile_n += 1
                self._sweep_jobs()
            except Exception as e:  # noqa: BLE001 — the health loop
                #                      must survive any single pass
                self._log(f"fleet: health pass failed ({e!r:.200})")
            self._shutdown_evt.wait(self.config.health_interval_s)

    def _token_for(self, tenant: str, addr: str) -> Optional[str]:
        """The bearer token to present at ``addr`` on behalf of
        ``tenant`` (None over unix).  Falls back to the fleet token
        when the tenant has none — attribution degrades, routing
        does not."""
        if not protocol.is_tcp(addr):
            return None
        return self._tenant_tokens.get(tenant) or self.fleet_token

    def _failover(self, backend) -> None:
        """A backend was drained THIS health pass: resubmit its
        QUEUED jobs elsewhere through the idempotent ``submit_id``
        dedup path; mark its running/suspended jobs ``lost`` (their
        client resubmits through the dispatcher and warm-starts
        wherever replication reached)."""
        t_fo = time.monotonic()
        trace_ids: List[str] = []
        with self._jobs_lock:
            owned = [
                (jid, dict(rec))
                for jid, rec in self._jobs.items()
                if rec.get("backend") == backend.addr
                and rec.get("state")
                not in (
                    jobmod.DONE, jobmod.FAILED, jobmod.CANCELLED, LOST,
                )
            ]
        resubmitted = 0
        for jid, rec in owned:
            if rec.get("trace_id"):
                trace_ids.append(rec["trace_id"])
            if rec.get("state") != jobmod.QUEUED:
                self._update_job(jid, state=LOST)
                continue
            target, reason = self.registry.choose(
                rec.get("tenant", authmod.LOCAL_TENANT)
            )
            if target is None or target.addr == backend.addr:
                self._update_job(jid, state=LOST)
                continue
            fwd = dict(rec.get("submit") or {})
            fwd["submit_id"] = rec.get("submit_id")
            auth = self._token_for(
                rec.get("tenant", authmod.LOCAL_TENANT), target.addr
            )
            try:
                resp = protocol.request(
                    target.addr, "submit",
                    timeout=self.config.backend_timeout_s,
                    **({"auth": auth} if auth else {}), **fwd,
                )
            except (OSError, protocol.ProtocolError) as e:
                self._log(
                    f"fleet: failover resubmit of {jid} to "
                    f"{target.addr} failed ({e!r:.120})"
                )
                self._update_job(jid, state=LOST)
                continue
            if not resp.get("ok"):
                self._log(
                    f"fleet: failover resubmit of {jid} refused "
                    f"({resp.get('error')})"
                )
                self._update_job(jid, state=LOST)
                continue
            new_id = resp.get("job_id")
            self._update_job(
                jid,
                backend=target.addr,
                state=resp.get("state", jobmod.QUEUED),
                backend_job_id=new_id,
                # a watch reconnect's byte offset was minted against
                # the OLD backend's event log: _op_watch restarts a
                # failed-over stream from 0 and lets the client's
                # (run_id, seq) dedup drop the replay
                failed_over=True,
            )
            if new_id and new_id != jid:
                # the new backend minted a fresh id: alias it so
                # status/result/watch against either id resolve
                self._record_job(
                    new_id,
                    {
                        **rec,
                        "backend": target.addr,
                        "state": resp.get("state", jobmod.QUEUED),
                        "alias_of": jid,
                        "failed_over": True,
                    },
                )
            resubmitted += 1
        with self._ctr_lock:
            self._failovers[backend.addr] = (
                self._failovers.get(backend.addr, 0) + 1
            )
            self._resub[backend.addr] = (
                self._resub.get(backend.addr, 0) + resubmitted
            )
        fo_ms = (time.monotonic() - t_fo) * 1000.0
        self._observe("ptt_fleet_failover_seconds", fo_ms)
        self.tel.emit(
            "failover",
            backend=backend.addr,
            resubmitted=resubmitted,
            # every affected job's chain (resubmitted AND lost): the
            # trace stitcher joins the old backend's slices to the
            # new backend's through this one record
            trace_ids=trace_ids,
            wall_ms=round(fo_ms, 3),
        )
        self._log(
            f"fleet: failover from {backend.addr} "
            f"({resubmitted} queued job(s) resubmitted)"
        )

    def _reconcile(self, backend) -> None:
        """A drained backend survived readmission hysteresis and
        rejoined: re-poll it for the jobs the dispatcher typed
        ``lost`` when it went dark.  A backend that still holds its
        jobs was PARTITIONED, not dead — finished jobs deliver their
        real result (``lost`` -> terminal with a ``reconciled``
        marker), still-running ones resume status/result/watch relay.
        Exactly-once is the existing ``submit_id`` dedup: the job
        only ever ran on this backend."""
        t_rc = time.monotonic()
        with self._jobs_lock:
            lost_jobs = [
                (jid, dict(rec))
                for jid, rec in self._jobs.items()
                if rec.get("state") == LOST
                and rec.get("backend") == backend.addr
                and not rec.get("alias_of")
            ]
        auth = (
            self.fleet_token
            if protocol.is_tcp(backend.addr)
            else None
        )
        reconciled = 0
        for jid, rec in lost_jobs:
            try:
                resp = protocol.request(
                    backend.addr, "status",
                    timeout=self.config.backend_timeout_s,
                    job_id=rec.get("backend_job_id") or jid,
                    **({"auth": auth} if auth else {}),
                )
            except (OSError, protocol.ProtocolError):
                return  # went dark again; the next rejoin retries
            if not resp.get("ok"):
                continue  # the backend forgot it: stays lost
            state = (resp.get("job") or {}).get("state")
            if state is None or state == LOST:
                continue
            terminal = state in (
                jobmod.DONE, jobmod.FAILED, jobmod.CANCELLED,
            )
            self._update_job(
                jid, state=state, reconciled=True,
                **({"done_handled": True} if terminal else {}),
            )
            reconciled += 1
            with self._ctr_lock:
                self._reconciled[backend.addr] = (
                    self._reconciled.get(backend.addr, 0) + 1
                )
            self.tel.emit(
                "reconcile",
                backend=backend.addr,
                job_id=jid,
                state=state,
                trace_id=rec.get("trace_id"),
            )
            if terminal:
                self._emit_complete(jid, backend.addr, rec, state)
                if self.config.replicate:
                    self._replicate_from(
                        backend.addr, trace_id=rec.get("trace_id")
                    )
        if lost_jobs:
            # it held jobs through the outage: that was a partition
            # window closing, not a restart
            with self._ctr_lock:
                self._partitions[backend.addr] = (
                    self._partitions.get(backend.addr, 0) + 1
                )
            rc_ms = (time.monotonic() - t_rc) * 1000.0
            self._observe("ptt_fleet_reconcile_seconds", rc_ms)
            self.tel.emit(
                "partition",
                backend=backend.addr,
                lost_jobs=len(lost_jobs),
                reconciled=reconciled,
                wall_ms=round(rc_ms, 3),
            )
            self._log(
                f"fleet: backend {backend.addr} rejoined holding "
                f"{reconciled}/{len(lost_jobs)} lost job(s) — "
                "reconciled"
            )

    def _sweep_jobs(self) -> None:
        """Track every routed job to its terminal state; a terminal
        transition triggers one replication pass from the owner so
        its warm artifact lands on every peer."""
        with self._jobs_lock:
            open_jobs = [
                (
                    jid,
                    rec.get("backend"),
                    rec.get("backend_job_id"),
                    dict(rec),
                )
                for jid, rec in self._jobs.items()
                if not rec.get("done_handled")
                and rec.get("state") != LOST
                and not rec.get("alias_of")
            ]
        up = {b.addr for b in self.registry.healthy()}
        for jid, addr, backend_jid, rec in open_jobs:
            if addr not in up:
                continue
            auth = self.fleet_token if protocol.is_tcp(addr) else None
            try:
                resp = protocol.request(
                    addr, "status",
                    timeout=self.config.backend_timeout_s,
                    job_id=backend_jid or jid,
                    **({"auth": auth} if auth else {}),
                )
            except (OSError, protocol.ProtocolError):
                continue  # the registry poll will judge the backend
            if not resp.get("ok"):
                continue
            state = (resp.get("job") or {}).get("state")
            if state is None:
                continue
            terminal = state in (
                jobmod.DONE, jobmod.FAILED, jobmod.CANCELLED,
            )
            self._update_job(
                jid, state=state,
                **({"done_handled": True} if terminal else {}),
            )
            if terminal:
                self._emit_complete(jid, addr, rec, state)
                if self.config.replicate:
                    self._replicate_from(
                        addr, trace_id=rec.get("trace_id")
                    )

    def _emit_complete(
        self, jid: str, addr: str, rec: dict, state: str
    ) -> None:
        """One ``complete`` event per job at its terminal flip: the
        end-to-end latency (submit accept -> terminal observed) is
        wall-clock from the persisted ``accepted_unix`` stamp, so it
        survives a dispatcher restart mid-job.  A job adopted by
        ``--recover`` has no accept stamp and reports ``e2e_ms``
        null (present — the v15 envelope requires the key)."""
        e2e_ms = None
        accepted = rec.get("accepted_unix")
        if isinstance(accepted, (int, float)):
            e2e_ms = round(
                max(0.0, time.time() - accepted) * 1000.0, 3
            )
        self._observe("ptt_fleet_job_e2e_seconds", e2e_ms)
        self.tel.emit(
            "complete",
            job_id=jid,
            backend=addr,
            state=state,
            e2e_ms=e2e_ms,
            trace_id=rec.get("trace_id"),
        )

    def _replicate_from(
        self, src_addr: str, trace_id: Optional[str] = None
    ) -> None:
        """One sieve pass: every artifact on ``src_addr`` offered to
        every healthy peer (fleet/replicate.py).  Repeats are cheap —
        a current peer answers ``identical`` and no data moves."""
        peers = [
            b.addr for b in self.registry.healthy()
            if b.addr != src_addr
        ]
        if not peers:
            return
        t_prev = [time.monotonic()]

        def on_pass(r: dict) -> None:
            now = time.monotonic()
            wall_ms = (now - t_prev[0]) * 1000.0
            t_prev[0] = now
            if r.get("status") not in ("ok",):
                return
            dst = r.get("dst") or "?"
            with self._ctr_lock:
                self._repl_blobs[dst] = self._repl_blobs.get(
                    dst, 0
                ) + int(r.get("blobs") or 0)
                self._repl_bytes[dst] = self._repl_bytes.get(
                    dst, 0
                ) + int(r.get("wire_bytes") or 0)
            self.tel.emit(
                "replicate",
                src=r.get("src"),
                dst=dst,
                blobs=int(r.get("blobs") or 0),
                wire_bytes=int(r.get("wire_bytes") or 0),
                config_sig=r.get("config_sig"),
                # the terminal job whose artifact this pass carries
                trace_id=trace_id,
                wall_ms=round(wall_ms, 3),
            )

        try:
            replmod.replicate_all(
                src_addr, peers, token=self.fleet_token,
                timeout=self.config.backend_timeout_s,
                on_pass=on_pass,
            )
        except (OSError, protocol.ProtocolError) as e:
            self._log(
                f"fleet: replication from {src_addr} failed "
                f"({e!r:.120})"
            )

    # ---------------------------------------------------- connection

    def _accept_loop(self, sock: socket.socket, trusted: bool) -> None:
        while not self._shutdown_evt.is_set():
            try:
                conn, _addr = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._handle_conn, args=(conn, trusted),
                daemon=True,
            )
            t.start()

    def _handle_conn(
        self, conn: socket.socket, trusted: bool = True
    ) -> None:
        conn.settimeout(600.0)
        r = w = None
        try:
            r = conn.makefile("r", encoding="utf-8")
            w = conn.makefile("w", encoding="utf-8")
            try:
                req = protocol.recv_json(r)
            except protocol.ProtocolError as e:
                protocol.send_json(
                    w, protocol.error_response(str(e), code="protocol")
                )
                return
            if req is None:
                return
            if not trusted:
                tenant = authmod.authenticate(
                    self.tokens, req.get("auth")
                )
                if tenant is None:
                    self.tel.emit(
                        "auth", action="reject", op=req.get("op"),
                    )
                    protocol.send_json(
                        w,
                        protocol.error_response(
                            "bad or missing bearer token "
                            "(submit with --token)",
                            code="auth",
                        ),
                    )
                    return
                with self._auth_seen_lock:
                    first = tenant not in self._auth_seen
                    self._auth_seen.add(tenant)
                if first:
                    self.tel.emit(
                        "auth", action="accept", tenant=tenant
                    )
                req["_tenant"] = tenant
            else:
                req["_tenant"] = authmod.LOCAL_TENANT
            op = req.get("op")
            handler = getattr(self, f"_op_{op}", None)
            if op not in protocol.OPS or handler is None:
                protocol.send_json(
                    w,
                    protocol.error_response(
                        f"unknown op {op!r} (dispatcher ops: ping/"
                        "submit/status/result/cancel/watch/metrics/"
                        "shutdown)"
                    ),
                )
                return
            try:
                handler(req, w)
            except (BrokenPipeError, ConnectionResetError):
                raise
            except (OSError, protocol.ProtocolError) as e:
                # a backend died mid-proxy: transport-class, so the
                # client retries / exits 2 — never a spec verdict
                protocol.send_json(
                    w,
                    protocol.error_response(
                        f"backend unreachable ({e!r:.120})",
                        code="backend_unavailable",
                    ),
                )
            except (KeyError, ValueError, TypeError) as e:
                protocol.send_json(w, protocol.error_response(str(e)))
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            for obj in (w, r):
                try:
                    if obj is not None:
                        obj.close()
                except OSError:
                    pass
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------ handlers

    def _op_ping(self, req, w) -> None:
        with self._jobs_lock:
            counts: dict = {}
            for rec in self._jobs.values():
                if rec.get("alias_of"):
                    continue
                st = rec.get("state", "?")
                counts[st] = counts.get(st, 0) + 1
        protocol.send_json(
            w,
            {
                "ok": True,
                "pid": os.getpid(),
                "uptime_s": round(time.time() - self._t0, 1),
                "fleet": True,
                "backends": self.registry.snapshot(),
                # full routing view for the flight deck:
                # score/load/stickiness per backend from one ping
                "backends_detail": self.registry.detail_snapshot(),
                "jobs": counts,
                "held": self._held,
                "persist_failures": self.persist_failures,
                "warmed": [],
            },
        )

    def _op_submit(self, req, w) -> None:
        t0 = time.monotonic()
        tenant = req["_tenant"]
        submit_id = req.get("submit_id") or uuid.uuid4().hex
        # a resubmit of a known submit_id routes BACK to its owner:
        # the backend's dedup can only answer the same job if the
        # retry lands on the same daemon
        sticky_owner = None
        trace_id = None
        with self._jobs_lock:
            for rec in self._jobs.values():
                if rec.get("submit_id") == submit_id and not rec.get(
                    "alias_of"
                ):
                    sticky_owner = rec.get("backend")
                    # a dedup-keyed retry is the SAME logical submit:
                    # it keeps the chain it already started
                    trace_id = rec.get("trace_id")
                    break
        if not trace_id:
            trace_id = uuid.uuid4().hex
        fwd = {k: req[k] for k in _SUBMIT_FIELDS if k in req}
        fwd["submit_id"] = submit_id
        # forwarded on the wire so the backend echoes it into its
        # job_* events and the engine run_header — and persisted in
        # the job record's submit dict so a failover resubmit
        # re-forwards the SAME id (one chain across backends)
        fwd["trace_id"] = trace_id
        tried: set = set()
        last_err = "no healthy backend"

        def _candidates() -> List:
            healthy = sorted(
                self.registry.healthy(), key=lambda b: b.score()
            )
            out: List = []
            if sticky_owner is not None:
                # a dedup-keyed retry must land on the SAME backend
                # to get the same job back
                for b in healthy:
                    if b.addr == sticky_owner:
                        out.append((b, "sticky"))
                        break
            if healthy and not out:
                chosen, why = self.registry.choose(tenant)
                if chosen is not None:
                    out.append((chosen, why))
            # every other healthy backend is a fallback: a connect
            # failure on the first pick must not bounce the submit
            # while the fleet still has capacity
            placed = {c.addr for c, _ in out}
            for b in healthy:
                if b.addr not in placed:
                    out.append((b, "least_loaded"))
                    placed.add(b.addr)
            return out

        candidates = _candidates()
        if not candidates:
            # all-backends-down window: degrade to a bounded
            # queue-and-hold instead of bouncing instantly — a fleet
            # mid-failover usually recovers within one health
            # interval, and the hold absorbs it invisibly
            candidates = self._hold_for_fleet(
                _candidates, tenant, trace_id
            )
            if candidates is None:
                protocol.send_json(
                    w,
                    protocol.error_response(
                        f"fleet hold buffer full "
                        f"({self.config.hold_max} submit(s) already "
                        "waiting for a backend); retry later",
                        code="capacity",
                    ),
                )
                return
        if not candidates:
            protocol.send_json(
                w,
                protocol.error_response(
                    "no healthy backend in the fleet (all drained); "
                    "retry later",
                    code="backend_unavailable",
                ),
            )
            return
        for backend, why in candidates:
            if backend.addr in tried:
                continue
            tried.add(backend.addr)
            auth = req.get("auth") or self._token_for(
                tenant, backend.addr
            )
            if not protocol.is_tcp(backend.addr):
                auth = None
            # route_ms = the routing DECISION (arrival -> backend
            # picked, hold window included); ack_ms = the full path
            # (arrival -> backend's ack in hand) — the two histogram
            # families the flight deck splits dispatch overhead by
            t_fwd = time.monotonic()
            try:
                resp = protocol.request(
                    backend.addr, "submit",
                    timeout=self.config.backend_timeout_s,
                    **({"auth": auth} if auth else {}), **fwd,
                )
            except (OSError, protocol.ProtocolError) as e:
                last_err = f"{backend.addr}: {e!r:.120}"
                continue
            if not resp.get("ok"):
                # typed backend rejection (quota/capacity/auth/...)
                # relays verbatim: the client's exit-code mapping
                # must see the backend's own code
                protocol.send_json(w, resp)
                return
            route_ms = (t_fwd - t0) * 1000.0
            ack_ms = (time.monotonic() - t0) * 1000.0
            jid = resp["job_id"]
            self._record_job(
                jid,
                {
                    "backend": backend.addr,
                    "tenant": tenant,
                    "state": resp.get("state", jobmod.QUEUED),
                    "submit_id": submit_id,
                    "submit": fwd,
                    "done_handled": False,
                    "trace_id": trace_id,
                    # wall-clock accept stamp: e2e_ms on the terminal
                    # `complete` event survives a dispatcher restart
                    "accepted_unix": round(time.time(), 3),
                },
            )
            with self._ctr_lock:
                key = (backend.addr, why)
                self._routes[key] = self._routes.get(key, 0) + 1
                self._route_s += route_ms / 1000.0
            self._observe("ptt_fleet_route_seconds", route_ms)
            self._observe("ptt_fleet_submit_ack_seconds", ack_ms)
            self.tel.emit(
                "route",
                backend=backend.addr,
                tenant=tenant,
                reason=why,
                route_ms=round(route_ms, 3),
                ack_ms=round(ack_ms, 3),
                job_id=jid,
                trace_id=trace_id,
            )
            protocol.send_json(
                w,
                {
                    **resp,
                    "backend": backend.addr,
                    "trace_id": trace_id,
                },
            )
            return
        protocol.send_json(
            w,
            protocol.error_response(
                f"every healthy backend refused the connection "
                f"(last: {last_err})",
                code="backend_unavailable",
            ),
        )

    def _hold_for_fleet(
        self, rebuild, tenant: str, trace_id: str
    ) -> Optional[List]:
        """Bounded queue-and-hold for an all-backends-down window:
        the submit waits up to ``hold_s`` for any backend to come
        back, with at most ``hold_max`` submits held at once.
        Returns the fresh candidate list when a backend appears, an
        empty list when the hold expired (caller answers the typed
        ``backend_unavailable``), or None when the buffer was full
        (caller answers the typed ``capacity`` shed — never a crash,
        never an unbounded pile-up)."""
        with self._held_lock:
            if self._held >= self.config.hold_max:
                with self._ctr_lock:
                    self._held_sheds += 1
                self.tel.emit(
                    "shed",
                    tenant=tenant,
                    held=self._held,
                    trace_id=trace_id,
                )
                return None
            self._held += 1
            held_now = self._held
        with self._ctr_lock:
            self._holds += 1
        self.tel.emit(
            "hold", tenant=tenant, held=held_now, trace_id=trace_id
        )
        try:
            deadline = time.monotonic() + self.config.hold_s
            while (
                time.monotonic() < deadline
                and not self._shutdown_evt.is_set()
            ):
                self._shutdown_evt.wait(
                    min(0.1, self.config.health_interval_s)
                )
                out = rebuild()
                if out:
                    return out
            return []
        finally:
            with self._held_lock:
                self._held -= 1

    def _owner_of(self, req) -> Tuple[str, str, Optional[str]]:
        """(backend addr, backend-side job id, forward token) for the
        request's ``job_id``; raises ValueError when untracked."""
        jid = req["job_id"]
        with self._jobs_lock:
            rec = self._jobs.get(jid)
        if rec is None:
            raise ValueError(
                f"unknown job {jid!r} (not routed through this "
                "dispatcher)"
            )
        if rec.get("state") == LOST:
            raise ValueError(
                f"job {jid!r} was lost with its backend "
                f"({rec.get('backend')}); resubmit through the "
                "dispatcher to warm-start on a live one"
            )
        addr = rec["backend"]
        auth = req.get("auth") or self._token_for(
            rec.get("tenant", authmod.LOCAL_TENANT), addr
        )
        if not protocol.is_tcp(addr):
            auth = None
        return addr, rec.get("backend_job_id") or jid, auth

    def _proxy(self, req, w, op: str, **extra) -> None:
        addr, backend_jid, auth = self._owner_of(req)
        resp = protocol.request(
            addr, op, timeout=self.config.backend_timeout_s,
            job_id=backend_jid,
            **({"auth": auth} if auth else {}), **extra,
        )
        if op == "result" and resp.get("ok") and not resp.get(
            "pending"
        ):
            self._update_job(
                req["job_id"], state=resp.get("state"),
            )
        protocol.send_json(w, {**resp, "backend": addr})

    def _op_status(self, req, w) -> None:
        if req.get("job_id"):
            self._proxy(req, w, "status")
            return
        # fleet-level listing: the dispatcher's own routing table,
        # tenant-scoped over TCP exactly like a single daemon's
        tenant = req.get("_tenant")
        with self._jobs_lock:
            jobs = [
                {
                    "job_id": jid,
                    # spec/mode from the forwarded submit, so `ptt
                    # status` renders a fleet listing with the same
                    # columns as a single daemon's
                    "spec": (rec.get("submit") or {}).get("spec"),
                    "mode": (rec.get("submit") or {}).get(
                        "mode", "check"
                    ),
                    "state": rec.get("state"),
                    "tenant": rec.get("tenant"),
                    "backend": rec.get("backend"),
                    **(
                        {"reconciled": True}
                        if rec.get("reconciled")
                        else {}
                    ),
                }
                for jid, rec in sorted(self._jobs.items())
                if not rec.get("alias_of")
                and (
                    tenant == authmod.LOCAL_TENANT
                    or rec.get("tenant") == tenant
                )
            ]
        protocol.send_json(
            w,
            {
                "ok": True,
                "jobs": jobs,
                # surfaced so a memory-only dispatcher is visible in
                # `ptt status`, not just in metrics
                "persist_failures": self.persist_failures,
            },
        )

    def _op_result(self, req, w) -> None:
        self._proxy(req, w, "result")

    def _op_cancel(self, req, w) -> None:
        self._proxy(req, w, "cancel")

    def _op_watch(self, req, w) -> None:
        """Relay the owning backend's watch stream line-for-line;
        the client's (run_id, seq) dedup and ``pos`` resume work
        unchanged because the dispatcher forwards both verbatim —
        EXCEPT across a failover: a reconnect offset was
        minted against the dead backend's event log, so a
        failed-over job restarts its relay from 0 and the client's
        (run_id, seq) join drops the replayed prefix (duplicates are
        survivable, silently skipped bytes are not).

        The relay runs in short LEGS (the backend is asked to watch
        for ``_WATCH_RELAY_LEG_S`` at a time, resuming by ``pos``):
        the owner is re-resolved between legs, so a failover is
        picked up even when the old connection never breaks — a
        gracefully-draining backend keeps its established streams
        open and would otherwise hold the relay on a job table that
        will never run the job again.  A mid-leg transport failure
        after the ack rides through the same loop (the record flips
        ``failed_over`` within one health interval and the next leg
        attaches to the new owner from 0)."""
        timeout_s = float(req.get("timeout_s", 3600.0))
        deadline = time.monotonic() + timeout_s
        addr, _bjid, _auth = self._owner_of(req)
        with self._jobs_lock:
            rec = self._jobs.get(req["job_id"]) or {}
            failed_over = bool(rec.get("failed_over"))
        last_pos = (
            0 if failed_over else max(0, int(req.get("offset") or 0))
        )
        cur_addr = addr
        sent_ack = False
        while True:
            # re-resolve the owner EVERY leg: _owner_of raises the
            # typed lost/unknown refusal if the job died with its
            # backend, and a failed-over record points at the new
            # owner whose event log starts over at offset 0
            addr, backend_jid, auth = self._owner_of(req)
            if addr != cur_addr:
                cur_addr, last_pos = addr, 0
            leg = min(
                _WATCH_RELAY_LEG_S,
                max(0.1, deadline - time.monotonic()),
            )
            leg_t0 = time.monotonic()
            try:
                # raw relay (not protocol.stream, which EATS the
                # ack): the backend's acknowledgment, every event,
                # and the done summary pass through byte-equivalent,
                # so the client's dedup and pos-resume machinery
                # cannot tell a dispatcher from a daemon — the ack is
                # forwarded exactly once across all legs
                with protocol.connect(addr, leg + 30.0) as s:
                    br = s.makefile("r", encoding="utf-8")
                    bw = s.makefile("w", encoding="utf-8")
                    protocol.send_json(
                        bw,
                        {
                            "op": "watch",
                            "job_id": backend_jid,
                            "timeout_s": leg,
                            "offset": last_pos,
                            **({"auth": auth} if auth else {}),
                        },
                    )
                    while True:
                        msg = protocol.recv_json(br)
                        if msg is None:
                            raise protocol.ProtocolError(
                                "backend closed the watch stream "
                                "mid-relay"
                            )
                        if msg.get("streaming"):
                            if not sent_ack:
                                sent_ack = True
                                protocol.send_json(w, msg)
                            continue
                        if (
                            "error" in msg
                            and str(msg.get("error", "")).startswith(
                                "watch timed out"
                            )
                        ):
                            # the LEG expired, not the client's
                            # watch: reattach (re-resolving the
                            # owner) unless the real deadline passed
                            if time.monotonic() < deadline:
                                break
                            protocol.send_json(
                                w,
                                protocol.error_response(
                                    f"watch timed out after "
                                    f"{timeout_s}s (job "
                                    f"{req['job_id']} still "
                                    f"{rec.get('state', '?')})"
                                ),
                            )
                            return
                        if "event" in msg and isinstance(
                            msg.get("pos"), int
                        ):
                            last_pos = msg["pos"]
                        protocol.send_json(w, msg)
                        if "done" in msg or "error" in msg:
                            return
                        if not msg.get("ok", True):
                            return
            except (OSError, protocol.ProtocolError):
                if not sent_ack:
                    # nothing forwarded yet: surface the refusal so
                    # the client's own (transient) retry drives
                    raise
                if time.monotonic() >= deadline:
                    raise
                # mid-stream break: the owner died for real — wait
                # out the failover and reattach on the next leg
                time.sleep(
                    min(0.3, self.config.health_interval_s)
                )
            finally:
                # one relay event per leg — broken legs included
                # (the flight deck's watch-leg histogram must see
                # failover gaps, not just the happy path)
                leg_ms = (time.monotonic() - leg_t0) * 1000.0
                self._observe("ptt_fleet_watch_leg_seconds", leg_ms)
                self.tel.emit(
                    "relay",
                    job_id=req["job_id"],
                    leg_ms=round(leg_ms, 3),
                    trace_id=rec.get("trace_id"),
                )
            with self._jobs_lock:
                rec = self._jobs.get(req["job_id"]) or {}

    def _op_metrics(self, req, w) -> None:
        own = metrics_mod.render_exposition(
            metrics_mod.fleet_metrics(
                self, uptime_s=time.time() - self._t0
            )
        )
        if not req.get("aggregate"):
            protocol.send_json(w, {"ok": True, "metrics": own})
            return
        # fleet-wide scrape: every LIVE backend polled once,
        # its families re-emitted under a `backend` label; a down or
        # mid-scrape-failing backend becomes a ptt_fleet_scrape_
        # errors sample instead of failing the whole exposition
        up = {b.addr for b in self.registry.healthy()}
        scraped: Dict[str, Optional[str]] = {}
        for addr in self.config.backends:
            if addr not in up:
                scraped[addr] = None
                continue
            auth = (
                self.fleet_token if protocol.is_tcp(addr) else None
            )
            try:
                resp = protocol.request(
                    addr, "metrics",
                    timeout=self.config.backend_timeout_s,
                    **({"auth": auth} if auth else {}),
                )
                scraped[addr] = (
                    resp.get("metrics") if resp.get("ok") else None
                )
            except (OSError, protocol.ProtocolError):
                scraped[addr] = None
        text = metrics_mod.aggregate_exposition(own, scraped)
        protocol.send_json(
            w, {"ok": True, "metrics": text, "aggregate": True}
        )

    def _op_shutdown(self, req, w) -> None:
        if req.get("_tenant") != authmod.LOCAL_TENANT:
            protocol.send_json(
                w,
                protocol.error_response(
                    "shutdown is localhost-only (connect via the "
                    "unix socket)",
                    code="auth",
                ),
            )
            return
        protocol.send_json(w, {"ok": True, "stopping": True})
        self.request_shutdown()
