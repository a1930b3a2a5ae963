"""Resilient client for the checker daemon (``cli.py submit/status/
watch/cancel/metrics/top``) — the port's copy of
``pulsar_tlaplus_tpu/service/client.py``.

Every method is one request over the unix socket or the authenticated
TCP transport (``tcp://HOST:PORT`` + ``token=``); ``watch`` streams.
The client never blocks the daemon: ``wait`` polls status client-side
(the daemon's handlers all return promptly), so a slow consumer can
never wedge a handler thread.

Resilience:

- **Bounded retry with backoff + jitter.**  Connect failures and
  transient socket errors (a daemon restarting, a dropped reply, a
  torn protocol line) retry up to ``retries`` times with exponential
  backoff and full jitter; exhausted retries raise
  :class:`TransportError` — which the CLI maps to exit 2, never 1
  (exit 1 is reserved for a confirmed violation).
- **Idempotent resubmit.**  Every submit carries a ``submit_id``
  dedup key (client-generated unless supplied): a retried submit
  whose original reply was lost returns the SAME job instead of
  enqueueing twice.
- **Backoff polls.**  ``wait`` (and ``watch`` reconnects) use the
  same backoff helper as the retry path instead of a fixed-interval
  spin.
- **Typed rejections.**  ``ok: false`` replies carry a ``code``; the
  client raises :class:`AuthError` (bad token — CLI exit 4) or
  :class:`AdmissionRejected` (over quota / load shed — CLI exit 5)
  so rejected-at-the-door is never confused with daemon-down.
- **Fleet-aware.**  A dispatcher with no healthy backend
  answers ``code: backend_unavailable``; the client retries it
  within the same budget as connect failures (a fleet mid-failover
  recovers within a health-poll interval) and, exhausted, raises
  :class:`BackendUnavailable` — transport-class, CLI exit 2, never 1.
"""

from __future__ import annotations

import random
import time
import uuid
from typing import Iterator, List, Optional

from pulsar_tlaplus_tpu_torch.service import protocol


class ServiceError(RuntimeError):
    """The daemon answered ``ok: false``.  ``code`` is the typed
    rejection class from the wire (``auth``/``quota``/``capacity``/
    ``bad_request``/``protocol``)."""

    def __init__(self, msg: str, code: str = "bad_request"):
        super().__init__(msg)
        self.code = code


class AuthError(ServiceError):
    """Bearer token rejected (CLI exit 4)."""


class AdmissionRejected(ServiceError):
    """Over-quota or load-shed submit (CLI exit 5).  ``code`` keeps
    the wire distinction: ``quota`` vs ``capacity``."""


class TransportError(ServiceError):
    """Transport-level failure that survived every retry (CLI exit 2
    — no verdict, never a spec result)."""

    def __init__(self, msg: str, code: str = "transport"):
        super().__init__(msg, code=code)


class BackendUnavailable(TransportError):
    """The fleet dispatcher had no healthy backend to place the
    request on.  Transport-class, NOT a verdict: the CLI exits 2,
    never 1.  Unlike the other typed rejections this one is RETRIED
    within the normal budget first — a fleet mid-failover usually
    recovers within one health-poll interval, and bouncing a CI
    pipeline for that window would make every drill a flake."""

    def __init__(self, msg: str):
        super().__init__(msg, code="backend_unavailable")


# transient errors worth retrying: the daemon restarting
# (FileNotFoundError/ConnectionRefusedError), a dropped or torn reply
# (ProtocolError, ConnectionResetError, BrokenPipeError), a stalled
# socket (timeout is an OSError subclass)
_TRANSIENT = (
    OSError,
    protocol.ProtocolError,
)


def backoff_delays(
    attempts: int,
    base: float = 0.05,
    cap: float = 2.0,
    rng: Optional[random.Random] = None,
) -> Iterator[float]:
    """Exponential backoff with full jitter: attempt ``i`` sleeps
    uniform(0, min(cap, base * 2**i)) — the shared pacing helper for
    the retry path AND the wait/watch poll loops (jitter decorrelates
    a thundering herd of CI clients hitting one daemon)."""
    r = rng or random
    delay = base
    for _ in range(attempts):
        yield min(cap, delay) * r.random()
        delay = min(cap, delay * 2.0)


def poll_delays(
    base: float = 0.05,
    cap: float = 0.5,
    rng: Optional[random.Random] = None,
) -> Iterator[float]:
    """Unbounded poll pacing (``wait``): same exponential+jitter
    shape, ramping from ``base`` and holding at ``cap`` — never a
    fixed-interval spin."""
    r = rng or random
    delay = base
    while True:
        yield min(cap, delay) * (0.5 + 0.5 * r.random())
        delay = min(cap, delay * 2.0)


def _typed_error(resp: dict, op: str) -> ServiceError:
    msg = resp.get("error", f"daemon refused {op!r}")
    code = resp.get("code", "bad_request")
    if code == "auth":
        return AuthError(msg, code=code)
    if code in ("quota", "capacity"):
        return AdmissionRejected(msg, code=code)
    if code == "backend_unavailable":
        return BackendUnavailable(msg)
    return ServiceError(msg, code=code)


class ServiceClient:
    def __init__(
        self,
        socket_path: str,
        timeout: float = 30.0,
        token: Optional[str] = None,
        retries: int = 4,
        retry_base: float = 0.05,
        retry_cap: float = 2.0,
        rng: Optional[random.Random] = None,
    ):
        self.socket_path = socket_path  # unix path or tcp://HOST:PORT
        self.timeout = timeout
        self.token = token
        self.retries = max(0, int(retries))
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self._rng = rng

    def _auth_fields(self) -> dict:
        return {"auth": self.token} if self.token else {}

    def _request(self, op: str, **fields) -> dict:
        last: Optional[BaseException] = None
        delays = list(
            backoff_delays(
                self.retries, self.retry_base, self.retry_cap,
                rng=self._rng,
            )
        ) + [None]  # final attempt, no sleep after
        for delay in delays:
            try:
                resp = protocol.request(
                    self.socket_path, op, timeout=self.timeout,
                    **self._auth_fields(), **fields,
                )
            except _TRANSIENT as e:
                last = e
                if delay is None:
                    break
                time.sleep(delay)
                continue
            if not resp.get("ok"):
                err = _typed_error(resp, op)
                if isinstance(err, BackendUnavailable):
                    # a whole-fleet outage is usually one failover
                    # window wide: spend the retry budget before
                    # surfacing it
                    last = err
                    if delay is None:
                        break
                    time.sleep(delay)
                    continue
                raise err
            return resp
        if isinstance(last, BackendUnavailable):
            raise BackendUnavailable(
                f"{op!r}: {last} (after {self.retries + 1} attempt(s))"
            )
        raise TransportError(
            f"{op!r} failed after {self.retries + 1} attempt(s): "
            f"{last!r}"
        )

    # ------------------------------------------------------------ ops

    def ping(self) -> dict:
        return self._request("ping")

    def submit(
        self,
        spec: str,
        cfg_path: str,
        invariants: Optional[List[str]] = None,
        max_states: Optional[int] = None,
        time_budget_s: Optional[float] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        submit_id: Optional[str] = None,
        mode: str = "check",
        sim: Optional[dict] = None,
        warm: bool = True,
        full: bool = False,
    ) -> str:
        """Queue a job.  ``submit_id`` (auto-generated when omitted)
        makes the submit idempotent: the retry a dropped reply forces
        returns the SAME job_id instead of enqueueing twice.
        ``mode="simulate"`` queues a streaming walker-swarm job;
        ``sim`` carries its knobs (n_walkers, depth, segment_len,
        seed, max_steps).  ``warm=False``
        (``--no-warm``) opts the job out of warm-start reuse AND
        artifact harvesting; ``full=True`` returns the whole reply —
        including the daemon's ``warm_mode``/``warm_reason`` reuse
        plan — instead of just the job id."""
        r = self._request(
            "submit",
            spec=spec,
            cfg=cfg_path,
            invariants=invariants,
            max_states=max_states,
            time_budget_s=time_budget_s,
            priority=priority,
            deadline_s=deadline_s,
            submit_id=submit_id or uuid.uuid4().hex,
            mode=mode,
            warm=bool(warm),
            **({"sim": sim} if sim else {}),
        )
        return r if full else r["job_id"]

    def status(self, job_id: Optional[str] = None):
        r = self._request(
            "status", **({"job_id": job_id} if job_id else {})
        )
        return r["job"] if job_id else r["jobs"]

    def result(self, job_id: str) -> dict:
        """Raw result response — ``{"pending": True, ...}`` while the
        job is not terminal."""
        return self._request("result", job_id=job_id)

    def cancel(self, job_id: str) -> str:
        return self._request("cancel", job_id=job_id)["state"]

    def metrics(self, aggregate: bool = False) -> str:
        """Prometheus text exposition of live daemon state (the
        ``metrics`` verb; zero device syncs server-side).  Against a
        fleet dispatcher, ``aggregate=True`` scrapes every live
        backend too and re-emits its families under a ``backend``
        label beside the fleet rollups; a single daemon
        ignores the flag."""
        return self._request(
            "metrics", **({"aggregate": True} if aggregate else {})
        )["metrics"]

    def shutdown(self) -> dict:
        return self._request("shutdown")

    def wait(self, job_id: str, timeout: float = 600.0) -> dict:
        """Poll until the job is terminal; returns the result response
        (``state`` + ``result``/``error``).  Polls back off (the same
        jittered-exponential helper the retry path uses) instead of
        spinning at a fixed interval; transport failures inside the
        loop retry through ``_request`` and, exhausted, raise
        :class:`TransportError` (CLI exit 2 — never 1).  Raises
        TimeoutError when the deadline passes first."""
        deadline = time.monotonic() + timeout
        pacing = poll_delays(rng=self._rng)
        while True:
            r = self.result(job_id)
            if not r.get("pending"):
                return r
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {r.get('state')} after "
                    f"{timeout}s"
                )
            time.sleep(
                min(next(pacing), max(deadline - time.monotonic(), 0))
            )

    def watch(
        self, job_id: str, timeout_s: float = 3600.0
    ) -> Iterator[dict]:
        """Stream the job's telemetry events (``{"event": rec}``
        messages) ending with the ``{"done": {...}}`` summary.

        A transport failure mid-stream (dropped connection, torn
        line) RECONNECTS with backoff and resumes the stream; already-
        yielded events are de-duplicated by (run_id, seq), so a caller
        sees every record exactly once.  The retry budget covers
        CONSECUTIVE failures — a reconnect that streams fresh events
        replenishes it, so a long watch on a flaky link survives as
        long as it keeps making progress.  Retries exhausted raise
        :class:`TransportError`.

        A mid-stream ``backend_unavailable`` is transient too:
        a fleet dispatcher whose backend died mid-relay fails the job
        over within one health interval, and the reconnect resumes
        the relay from the NEW owner (the dispatcher restarts a
        failed-over stream from offset 0; the (run_id, seq) join here
        drops the replayed prefix, so failover costs duplicates on
        the wire but never a dropped or double-yielded event)."""
        seen: dict = {}  # run_id -> highest seq yielded
        last_pos = 0  # server file offset: reconnects RESUME there

        def fresh_pacing():
            return backoff_delays(
                max(1, self.retries), self.retry_base, self.retry_cap,
                rng=self._rng,
            )

        attempts_left = self.retries
        pacing = fresh_pacing()
        while True:
            progressed = False
            try:
                for msg in protocol.stream(
                    self.socket_path,
                    "watch",
                    timeout=timeout_s + 30.0,
                    job_id=job_id,
                    timeout_s=timeout_s,
                    offset=last_pos,
                    **self._auth_fields(),
                ):
                    if not msg.get("ok", True):
                        raise _typed_error(msg, "watch")
                    if "event" in msg:
                        rec = msg["event"]
                        if isinstance(msg.get("pos"), int):
                            last_pos = msg["pos"]
                        rid = rec.get("run_id")
                        seq = rec.get("seq")
                        if rid is not None and isinstance(seq, int):
                            if seq <= seen.get(rid, -1):
                                continue  # replayed on reconnect
                            seen[rid] = seq
                    progressed = True
                    yield msg
                    if "done" in msg or "error" in msg:
                        return
                # stream ended without done: daemon closed mid-watch
                raise protocol.ProtocolError(
                    "watch stream ended without a done record"
                )
            except _TRANSIENT + (BackendUnavailable,) as e:
                if progressed:
                    # fresh events flowed since the last failure:
                    # this is a new incident, not attempt N+1 of the
                    # same one
                    attempts_left = self.retries
                    pacing = fresh_pacing()
                if attempts_left <= 0:
                    raise TransportError(
                        f"watch {job_id!r} failed after retries: {e!r}"
                    ) from e
                attempts_left -= 1
                time.sleep(next(pacing, self.retry_cap))
