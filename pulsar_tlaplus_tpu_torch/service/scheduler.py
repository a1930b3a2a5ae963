"""Checker pool + FIFO/budget-slice scheduler — the port's counterpart of
``pulsar_tlaplus_tpu/service/scheduler.py``.

**Pool.**  The daemon holds one :class:`DeviceChecker` per ``(spec,
constant bindings, invariant set, max_states)`` key and device slot.
The port compiles nothing ahead of a run (its kernels are CUDA C++
libraries built once per checkout, its model a batched PyTorch program),
so warming a key builds the checker, makes sure every kernel library is
built (``kernels/build.py``) and launches K0 on the slot's card; a submit
to a warmed key builds no kernel and constructs no checker.  The
invariant set is part of the key: the engine evaluates it in its append.

**Scheduler.**  FIFO with budget-slice preemption: the head job runs on
the device until its slice budget expires *and* another job is waiting,
at which point the engine's cooperative ``suspend_hook`` fires at the
next level boundary — the engine writes a resumable frame into the
job's own directory and returns ``stop_reason="suspended"``; the
scheduler frees the checker's device memory (a suspended job's whole
state is its frame on disk) and the job re-enters the FIFO tail.  A
resumed run is the same run (the frames' resume contract), so a job's
result equals a solo run however often it was suspended.

The queue (jobs + FIFO order) persists to ``queue.json`` atomically on
every transition, so a SIGTERM — or a crash — loses nothing: ``serve
--recover`` reloads it, re-queues interrupted jobs (suspended when their
frame exists, queued otherwise), and completes the queue with the same
results.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from pulsar_tlaplus_tpu_torch.obs import telemetry as obs
from pulsar_tlaplus_tpu_torch.service import admission as admmod
from pulsar_tlaplus_tpu_torch.service import jobs as jobmod
from pulsar_tlaplus_tpu_torch.service.jobs import Job
from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
from pulsar_tlaplus_tpu_torch.utils import faults
from pulsar_tlaplus_tpu_torch.warm import plan as warm_plan
from pulsar_tlaplus_tpu_torch.warm import store as warm_store


def _write_json_atomic(path: str, obj, _inject=None):
    """Write ``obj`` as JSON to ``path`` through a per-process tmp +
    ``os.replace``, removing the half-written tmp on failure.  Returns
    None on success, the ``OSError`` on failure — the caller decides
    whether to retry or log-and-continue (``_inject`` is the
    PTT_FAULT hook: an exception raised before any byte is written)."""
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
class ServiceConfig:
    """Daemon-wide knobs (one engine geometry for the whole registry)."""

    state_dir: str
    socket_path: str = ""  # default: <state_dir>/serve.sock
    slice_s: float = 2.0  # scheduling quantum (suspend granularity
    #                       is the level boundary ABOVE this)
    # frontier rows a window expands; None = the tuned profile's, else
    # the engine's default (65,536)
    sub_batch: Optional[int] = None
    visited_cap: int = 1 << 16
    frontier_cap: int = 1 << 14
    max_states: int = 50_000_000  # service ceiling + default budget
    checkpoint_every: int = 2
    visited_impl: str = "fpset"
    compact_impl: Optional[str] = None  # None = the profile's, else logshift
    # tuned-profile policy (tune/profiles.py): "auto" resolves a profile
    # per (spec, constants, invariants, backend) at checker construction,
    # so prewarm builds the tuned checker; "none" disables lookups
    # (serve --no-profiles).  The knobs above are the fallback for knobs
    # the profile does not pin.
    profiles: str = "auto"
    # open-network hardening: `tcp` = "HOST:PORT" adds an authenticated TCP
    # listener beside the unix socket (port 0 = ephemeral, the bound
    # port lands in daemon.tcp_port); it REQUIRES `tokens_path` (a
    # tokens.json mapping bearer tokens to tenants — service/auth.py).
    # Quotas: 0 = unlimited; rejections are typed wire errors + the
    # ptt_admission_* counters, never silent queueing.
    tcp: str = ""
    tokens_path: str = ""
    queue_cap: int = 64  # global alive-job cap (load shedding)
    tenant_max_queued: int = 16
    tenant_max_running: int = 0
    tenant_max_states: int = 0
    specs: Tuple[str, ...] = ()  # modules to prewarm at startup
    spec_dir: str = ""  # where default <spec>.cfg files live
    keep_terminal: int = 512  # finished-job records retained for
    #   status/result queries; oldest beyond this are pruned (table,
    #   queue.json, AND their jobs/<id>/ dirs) — a resident daemon
    #   must not grow per-submit forever.  0 disables pruning.
    # incremental checking (warm/): the warm artifact store's LRU byte
    # cap (`serve --warm-max-bytes`).  0 disables the warm layer
    # entirely — no artifacts harvested, every submit plans cold.
    warm_max_bytes: int = warm_store.DEFAULT_MAX_BYTES
    # N local device slots: the scheduler runs up to `devices` jobs at
    # once, one worker thread + checker pool per slot; slot i builds
    # its checkers on cuda:i (`cpu`: all on the CPU).  More slots than
    # cards is refused, never served from the CPU.
    devices: int = 1
    cpu: bool = False
    telemetry_path: str = ""  # default: <state_dir>/service.jsonl

    def __post_init__(self):
        if not self.socket_path:
            self.socket_path = os.path.join(self.state_dir, "serve.sock")
        if not self.telemetry_path:
            self.telemetry_path = os.path.join(
                self.state_dir, "service.jsonl"
            )
        if not self.spec_dir:
            self.spec_dir = os.path.normpath(
                os.path.join(
                    os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__))
                    ),
                    "..",
                    "specs",
                )
            )

    def slot_devices(self) -> List[torch.device]:
        """The device of each slot: ``cuda:i``, or the CPU under
        ``cpu``.  Raises when more slots than cards are asked for (or
        no card is present): the daemon never falls back to the CPU."""
        n = max(1, int(self.devices or 1))
        if self.cpu:
            return [torch.device("cpu")] * n
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(
                f"--devices {n} needs {n} CUDA device(s), {have} present "
                "(serve -cpu runs the daemon on the CPU)")
        return [torch.device("cuda", i) for i in range(n)]

    @property
    def jobs_dir(self) -> str:
        return os.path.join(self.state_dir, "jobs")

    @property
    def queue_path(self) -> str:
        return os.path.join(self.state_dir, "queue.json")

    @property
    def warm_dir(self) -> str:
        return os.path.join(self.state_dir, "warm")


class CheckerPool:
    """DeviceChecker instances keyed by the job configuration, on one
    device slot.

    Checkers are reused across jobs of the same key: per-job state
    (checkpoint path, telemetry stream, budgets, the suspend hook) is
    (re)assigned per scheduling slice, and ``run()`` rebuilds device
    buffers from scratch (or from the job's frame on resume) — the
    pooled object carries only its configuration between runs (the
    scheduler frees its device memory after every slice).
    """

    def __init__(self, config: ServiceConfig, device=None):
        self.config = config
        if device is None:
            device = config.slot_devices()[0]
        self.device = torch.device(device)
        self._checkers: Dict[tuple, object] = {}
        # streaming simulators: keyed like checkers but by the sim knob
        # tuple
        self._sims: Dict[tuple, object] = {}
        self._warm: set = set()
        self._lock = threading.Lock()

    # ---------------------------------------------------------- keys

    @staticmethod
    def _constants_sig(tlc_cfg) -> str:
        return repr(
            sorted((k, repr(v)) for k, v in tlc_cfg.constants.items())
        )

    def key_for(
        self, spec: str, tlc_cfg, invariants: Tuple[str, ...],
        max_states: Optional[int],
    ) -> tuple:
        return (
            spec,
            self._constants_sig(tlc_cfg),
            tuple(invariants),
            int(max_states or self.config.max_states),
        )

    # --------------------------------------------------------- build

    @staticmethod
    def build_model(spec: str, tlc_cfg):
        from pulsar_tlaplus_tpu_torch.models import registry

        if spec not in registry.COMPILED:
            raise ValueError(
                f"spec {spec!r} is not in the compiled registry "
                f"(known: {sorted(registry.COMPILED)}); the daemon "
                "serves registry specs only"
            )
        model, _constants = registry.COMPILED[spec](tlc_cfg)
        return model

    def resolve_invariants(
        self, spec: str, tlc_cfg, invariants: Optional[List[str]]
    ) -> Tuple[str, ...]:
        """Submitted invariant list (validated) or the cfg INVARIANTS."""
        model = self.build_model(spec, tlc_cfg)
        invs = tuple(
            invariants if invariants is not None else tlc_cfg.invariants
        )
        unknown = [i for i in invs if i not in model.invariants]
        if unknown:
            raise ValueError(
                f"unknown invariant(s) for {spec!r}: {unknown}"
            )
        return invs

    def get(
        self, spec: str, tlc_cfg, invariants: Tuple[str, ...],
        max_states: Optional[int] = None,
    ):
        """(key, checker) — built on this slot's device if the key was
        never seen."""
        from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker

        key = self.key_for(spec, tlc_cfg, invariants, max_states)
        with self._lock:
            ck = self._checkers.get(key)
            if ck is None:
                cfg = self.config
                model = self.build_model(spec, tlc_cfg)
                ck = DeviceChecker(
                    model,
                    invariants=invariants,
                    sub_batch=cfg.sub_batch,
                    visited_cap=cfg.visited_cap,
                    frontier_cap=cfg.frontier_cap,
                    max_states=key[3],
                    visited_impl=cfg.visited_impl,
                    compact_impl=cfg.compact_impl,
                    device=self.device,
                    # the tuned profile's knobs fill what the config
                    # leaves at None; the engine records profile_sig on
                    # every slice's run header
                    profile=None if cfg.profiles == "none" else "auto",
                    # online adaptation moves knobs within a run: the
                    # daemon pins it off whatever the profile says, so a
                    # job's run equals a solo run of the pooled checker
                    adapt=False,
                )
                self._checkers[key] = ck
            return key, ck

    def get_sim(
        self, spec: str, tlc_cfg, invariants: Tuple[str, ...],
        sim: dict,
    ):
        """A cached StreamingSimulator for a simulation job's exact knob
        set (per-slice state — checkpoint path, telemetry, budgets, the
        suspend hook — is (re)assigned per slice, like the checkers)."""
        from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator

        key = (
            "sim", spec, self._constants_sig(tlc_cfg),
            tuple(invariants),
            tuple(sorted((k, v) for k, v in sim.items())),
        )
        with self._lock:
            eng = self._sims.get(key)
            if eng is None:
                model = self.build_model(spec, tlc_cfg)
                eng = StreamingSimulator(
                    model,
                    invariants=invariants,
                    n_walkers=sim.get("n_walkers"),
                    depth=int(sim.get("depth") or 64),
                    segment_len=sim.get("segment_len"),
                    seed=int(sim.get("seed") or 0),
                    max_steps=sim.get("max_steps"),
                    device=self.device,
                    profile=(
                        "auto"
                        if self.config.profiles != "none"
                        else None
                    ),
                )
                self._sims[key] = eng
            return key, eng

    def warm(
        self, spec: str, cfg_path: Optional[str] = None,
    ) -> Tuple[tuple, float]:
        """Build the checker for a spec's default (or given) cfg, make
        sure every kernel library is built and launch K0 on this slot's
        card; returns (key, seconds).  Idempotent per key (0.0 again)."""
        from pulsar_tlaplus_tpu_torch.kernels import build as kbuild
        from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

        if cfg_path is None:
            cfg_path = os.path.join(
                self.config.spec_dir, f"{spec}.cfg"
            )
        tlc_cfg = cfgmod.load(cfg_path)
        invs = self.resolve_invariants(spec, tlc_cfg, None)
        t0 = time.perf_counter()
        key, _ck = self.get(spec, tlc_cfg, invs)
        with self._lock:
            if key in self._warm:
                return key, 0.0
        if self.device.type == "cuda":
            kbuild.build()
            kbuild.selftest(self.device)
        with self._lock:
            self._warm.add(key)
        return key, time.perf_counter() - t0

    def warmed(self) -> List[tuple]:
        with self._lock:
            return [k for k in self._checkers if k in self._warm]


class Scheduler:
    """FIFO + budget-slice preemption over the checker pool(s).

    Thread model: one worker thread per local device slot
    (``config.devices``, default 1) runs jobs — each slot runs one job
    at a time, because a device is time-sliced, not shared; server
    handler threads call :meth:`submit`/:meth:`cancel`/
    :meth:`wait`/:meth:`snapshot` under the internal condition
    variable.  ``stop()`` suspends every running job at its next level
    boundary (resumable frame on disk), persists the queue, and joins.
    """

    def __init__(
        self,
        config: ServiceConfig,
        pool: Optional[CheckerPool] = None,
        telemetry=None,
        log=None,
    ):
        self.config = config
        # one checker pool per local device slot: slot 0 is `self.pool`
        # (a caller may inject a shared one); the others build on their
        # own cards, since a checker's buffers are single-run state
        devs = config.slot_devices()
        self.pool = pool or CheckerPool(config, devs[0])
        self.pools: List[CheckerPool] = [self.pool] + [
            CheckerPool(config, d) for d in devs[1:]
        ]
        self.tel = obs.as_telemetry(telemetry)
        self._log = log or (lambda msg: None)
        self.jobs: Dict[str, Job] = {}
        self.fifo: deque = deque()
        self.cv = threading.Condition()
        self._persist_lock = threading.Lock()
        # admission control: quota checks + the counters the
        # `metrics` verb exports as ptt_admission_*
        self.admission = admmod.AdmissionControl(
            queue_cap=config.queue_cap,
            tenant_max_queued=config.tenant_max_queued,
            tenant_max_running=config.tenant_max_running,
            tenant_max_states=config.tenant_max_states,
            default_max_states=config.max_states,
        )
        # warm reuse layer (warm/): digest-verified artifacts under <state_dir>/warm, swept at startup so a torn
        # artifact from a crashed harvest can never be reused; the
        # (mode, reason) counters back ptt_warm_{hit,reseed,cold}_total
        self.warm_store = None
        self.warm_counts: Dict[Tuple[str, str], int] = {}
        self._mod_digests: Dict[str, str] = {}
        self._warm_lock = threading.Lock()
        if config.warm_max_bytes > 0:
            self.warm_store = warm_store.WarmStore(
                config.warm_dir,
                max_bytes=config.warm_max_bytes,
                log=self._log,
            )
            for reason in self.warm_store.sweep():
                self.tel.emit(
                    "warm", phase="sweep", mode="cold",
                    reason="quarantined", detail=reason[:200],
                )
        # idempotent resubmit: (tenant, submit_id) -> job_id, rebuilt
        # on recover, pruned with the retention cap
        self._submit_index: Dict[Tuple[str, str], str] = {}
        self._persist_n = 0  # queue.json snapshot sequence (fault site)
        self.persist_failures = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # device slot -> running job_id: one entry per busy local
        # device (`_running_id` below reads the first)
        self._running: Dict[int, str] = {}
        # flight-deck state: the most recent slice's engine stats
        # + heartbeat snapshot, and the checkers actively holding the
        # devices — the `metrics` verb renders from exactly these
        # host-side dicts, never a device fetch
        self.last_engine: Optional[dict] = None
        self._active_cks: Dict[int, object] = {}
        os.makedirs(config.jobs_dir, exist_ok=True)

    # the single-device view: the first busy slot's running job and
    # active checker (obs/metrics.py reads these)
    @property
    def _running_id(self) -> Optional[str]:
        for jid in self._running.values():
            return jid
        return None

    @_running_id.setter
    def _running_id(self, jid: Optional[str]) -> None:
        if jid is None:
            self._running.pop(0, None)
        else:
            self._running[0] = jid

    @property
    def _active_ck(self):
        for ck in self._active_cks.values():
            return ck
        return None

    # ---------------------------------------------------- persistence

    def persist(self) -> None:
        """Atomic queue snapshot — called on every transition, so even
        a kill -9 loses at most the in-flight transition (the frames
        and result files are their own durable artifacts).  The
        snapshot AND the replace happen under one lock: the scheduler
        thread and the server's handler threads both persist, and the
        last snapshot written must be the newest one taken (a shared
        tmp name without the lock let one thread replace away
        another's tmp mid-write)."""
        self._prune_terminal()
        with self._persist_lock:
            with self.cv:
                snap = {
                    "version": 1,
                    "jobs": [j.to_dict() for j in self.jobs.values()],
                    "fifo": list(self.fifo),
                    # slot 0's running job, and every busy slot's job
                    # in slot order (recover() prefers the list)
                    "running": self._running.get(0),
                    "running_devices": [
                        self._running[d]
                        for d in sorted(self._running)
                    ],
                }
            self._persist_n += 1
            inject = "enospc" in faults.poll(
                "persist", self._persist_n
            )
            # a full/flaky disk must not take the daemon down: one
            # retry after removing the half-written tmp (freeing it
            # is what lets an ENOSPC retry succeed), then log and
            # carry on — the very next transition persists again, and
            # the torn-queue recovery path (`serve --recover`)
            # rebuilds from the per-job dirs if the worst happens
            for attempt in (0, 1):
                err = _write_json_atomic(
                    self.config.queue_path, snap,
                    _inject=(
                        faults.enospc_error("persist", self._persist_n)
                        if inject and attempt == 0
                        else None
                    ),
                )
                if err is None:
                    break
                if attempt == 1:
                    self.persist_failures += 1
                    self._log(
                        f"queue.json persist FAILED ({err!r:.120}); "
                        "continuing — next transition retries"
                    )

    def _prune_terminal(self) -> None:
        """Retention cap: the oldest terminal jobs beyond
        ``keep_terminal`` leave the table and their dirs leave disk.
        Queued/running/suspended jobs are never touched."""
        cap = self.config.keep_terminal
        if cap <= 0:
            return
        with self.cv:
            term = sorted(
                (j for j in self.jobs.values() if j.terminal),
                key=lambda j: j.finished_unix or 0.0,
            )
            drop = term[: max(0, len(term) - cap)]
            for j in drop:
                del self.jobs[j.job_id]
                if j.submit_id:
                    self._submit_index.pop(
                        (j.tenant, j.submit_id), None
                    )
        for j in drop:
            shutil.rmtree(j.dir, ignore_errors=True)

    def recover(self) -> int:
        """Reload ``queue.json``: terminal jobs keep their records for
        status/result queries; interrupted jobs re-enter the queue —
        at the FRONT when they were running (their work is the
        oldest), as suspended runs when their frame survived, as fresh
        queued runs otherwise.  A CORRUPT/TRUNCATED ``queue.json``
        (torn by a crash mid-write on a broken disk) is quarantined to
        ``queue.json.corrupt.<ts>`` and the queue is REBUILT from the
        per-job ``jobs/<id>/`` dirs — never a crash.  Returns the number of runnable jobs."""
        try:
            with open(self.config.queue_path) as f:
                snap = json.load(f)
        except FileNotFoundError:
            return 0
        except (OSError, json.JSONDecodeError, ValueError) as e:
            quarantine = (
                f"{self.config.queue_path}.corrupt.{int(time.time())}"
            )
            try:
                os.replace(self.config.queue_path, quarantine)
            except OSError:
                quarantine = "<unmovable>"
            self._log(
                f"queue.json is corrupt ({e!r:.120}); quarantined to "
                f"{quarantine} and rebuilding from the job dirs"
            )
            return self._rebuild_from_dirs()
        with self.cv:
            for d in snap.get("jobs", []):
                job = Job.from_dict(d)
                self.jobs[job.job_id] = job
            order = [
                jid for jid in snap.get("fifo", []) if jid in self.jobs
            ]
            interrupted = snap.get("running_devices")
            if interrupted is None:
                # a snapshot with one job id (or null)
                interrupted = snap.get("running")
            if isinstance(interrupted, str):
                interrupted = [interrupted]
            for jid in reversed(interrupted or []):
                if jid in self.jobs and jid not in order:
                    order.insert(0, jid)
            n = 0
            for jid in order:
                job = self.jobs[jid]
                if job.terminal:
                    continue
                if job.state == jobmod.RUNNING:
                    # the daemon died mid-run: resumable iff the frame
                    # reached disk
                    job.state = (
                        jobmod.SUSPENDED
                        if os.path.exists(job.frame_path)
                        else jobmod.QUEUED
                    )
                self.fifo.append(jid)
                n += 1
            self._running.clear()
            self._reindex_submit_ids()
        self.persist()
        self._log(f"recovered {n} runnable job(s) from queue.json")
        return n

    def _reindex_submit_ids(self) -> None:
        """Rebuild the idempotency index from the job table (caller
        holds the cv) — a retried submit keeps deduplicating across a
        daemon restart."""
        self._submit_index = {
            (j.tenant, j.submit_id): j.job_id
            for j in self.jobs.values()
            if j.submit_id
        }

    def _rebuild_from_dirs(self) -> int:
        """Torn-queue recovery: reconstruct the job table from the
        per-job ``jobs/<id>/job.json`` submit records, inferring each
        job's state from its durable artifacts — ``result.json``
        present = done, ``frame.npz`` present = suspended (resumable),
        otherwise queued (conservative: a cancel that only ever lived
        in the torn queue.json re-runs, which is safe).  Runnable jobs
        re-enter the FIFO in submit order."""
        try:
            jids = sorted(os.listdir(self.config.jobs_dir))
        except OSError:
            jids = []
        rebuilt: List[Job] = []
        for jid in jids:
            jdir = os.path.join(self.config.jobs_dir, jid)
            rec_path = os.path.join(jdir, "job.json")
            try:
                with open(rec_path) as f:
                    job = Job.from_dict(json.load(f))
            except (OSError, json.JSONDecodeError, ValueError) as e:
                self._log(
                    f"rebuild: skipping job dir {jid!r} "
                    f"(unreadable job.json: {e!r:.80})"
                )
                continue
            job.dir = jdir  # the state dir may have moved
            if os.path.exists(job.result_path):
                try:
                    with open(job.result_path) as f:
                        job.result = json.load(f)
                    job.state = jobmod.DONE
                    if job.finished_unix is None:
                        job.finished_unix = os.path.getmtime(
                            job.result_path
                        )
                except (OSError, json.JSONDecodeError):
                    job.state = jobmod.QUEUED
                    job.result = None
            elif os.path.exists(job.frame_path):
                job.state = jobmod.SUSPENDED
            else:
                job.state = jobmod.QUEUED
            rebuilt.append(job)
        rebuilt.sort(key=lambda j: j.submitted_unix)
        n = 0
        with self.cv:
            for job in rebuilt:
                self.jobs[job.job_id] = job
                if not job.terminal:
                    self.fifo.append(job.job_id)
                    n += 1
            self._running.clear()
            self._reindex_submit_ids()
        self.persist()
        self._log(
            f"rebuilt {len(rebuilt)} job(s) ({n} runnable) from the "
            "job dirs"
        )
        return n

    # -------------------------------------------------------- control

    def start(self) -> None:
        """One worker thread per local device slot ("ptt-scheduler",
        "ptt-scheduler-1", ...)."""
        if self._threads:
            return
        for d in range(len(self.pools)):
            t = threading.Thread(
                target=self._loop,
                args=(d,),
                name=(
                    "ptt-scheduler" if d == 0
                    else f"ptt-scheduler-{d}"
                ),
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Graceful: every running job suspends at its next level
        boundary (frame on disk), the queue persists, the worker
        threads join."""
        self._stop.set()
        with self.cv:
            self.cv.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._threads = []
        self.persist()

    def run_until_idle(self) -> None:
        """Synchronous drain (in-process harnesses/tests): run slices
        until no runnable job remains.  Single-threaded on slot 0 —
        the drain IS the device."""
        while not self._stop.is_set():
            self._sweep_deadlines()
            job = self._claim(0)
            if job is None:
                return
            self._run_slice(job, 0)

    # --------------------------------------------------------- submit

    def submit(
        self,
        spec: str,
        cfg_path: str,
        invariants: Optional[List[str]] = None,
        max_states: Optional[int] = None,
        time_budget_s: Optional[float] = None,
        tenant: str = "local",
        priority: int = 0,
        deadline_s: Optional[float] = None,
        submit_id: Optional[str] = None,
        mode: str = "check",
        sim: Optional[dict] = None,
        warm: bool = True,
        trace_id: Optional[str] = None,
    ) -> Job:
        """Validate eagerly (bad specs/cfgs/invariants fail the submit,
        not the queue), deduplicate on the client's ``submit_id``
        (a retried submit never enqueues twice), run admission control
        (over-quota/over-capacity submits are REJECTED at the door —
        :class:`admission.AdmissionError`), plan warm reuse
        (``warm=False`` = the --no-warm opt-out: never reuse, never
        harvest), and enqueue."""
        from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

        cfg_path = os.path.abspath(cfg_path)
        tlc_cfg = cfgmod.load(cfg_path)  # raises on missing/bad cfg
        invs = self.pool.resolve_invariants(spec, tlc_cfg, invariants)
        if max_states is not None and max_states > self.config.max_states:
            raise ValueError(
                f"max_states {max_states} exceeds the service ceiling "
                f"{self.config.max_states} (serve --maxstates)"
            )
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0: {deadline_s}"
            )
        if mode not in ("check", "simulate"):
            raise ValueError(
                f"unknown job mode {mode!r} (want check|simulate)"
            )
        sim_norm: Optional[dict] = None
        if mode == "simulate":
            # normalize + eagerly validate the sim knobs (bad submits
            # fail the submit, not the queue) — only known keys, all
            # positive ints, so the pool's cache key is stable
            sim = dict(sim or {})
            sim_norm = {}
            for k in (
                "n_walkers", "depth", "segment_len", "seed",
                "max_steps",
            ):
                v = sim.pop(k, None)
                if v is None:
                    continue
                if not isinstance(v, int) or isinstance(v, bool) or (
                    v < 0 or (v < 1 and k != "seed")
                ):
                    raise ValueError(
                        f"sim.{k} must be a positive integer: {v!r}"
                    )
                sim_norm[k] = v
            if sim:
                raise ValueError(
                    f"unknown sim knob(s): {sorted(sim)}"
                )
        # sim jobs price at their ACTUAL swarm budget, check jobs at
        # max_states (admission.state_price)
        asking = admmod.state_price(
            max_states, mode, sim_norm, self.config.max_states
        )
        # admission gates BEFORE warm planning: planning builds (and
        # permanently pools) a checker, and an over-quota tenant's
        # submit spam must be shed at the door without paying — or
        # caching — any of that.  The check re-runs under the enqueue
        # cv below (the authoritative, race-free decision).
        with self.cv:
            if submit_id:
                prev = self._submit_index.get((tenant, str(submit_id)))
                if prev is not None and prev in self.jobs:
                    self.admission.count_dedup(tenant)
                    self.tel.emit(
                        "admission", action="dedup", tenant=tenant,
                        job_id=prev, submit_id=str(submit_id),
                    )
                    return self.jobs[prev]
            self._admission_gate(tenant, asking, spec)
        # warm reuse plan: decided at submit so status/telemetry
        # show the intention up front; the artifact is digest-VERIFIED
        # at install (the first slice), where a failure demotes to
        # cold with the verify's reason.  A planner error must never
        # fail a submit — it falls back to an honest cold plan.
        wplan = None
        if mode == "check" and self.warm_store is not None and warm:
            try:
                _k, ck = self.pool.get(
                    spec, tlc_cfg, invs, max_states
                )
                wplan = warm_plan.plan(
                    self.warm_store,
                    spec=spec,
                    constants=dict(tlc_cfg.constants),
                    invariants=invs,
                    config_sig=ck._config_sig(),
                    module_digest=self._module_digest(spec),
                    lsig=warm_plan.layout_sig(ck.model),
                    n_initial=int(ck.model.n_initial),
                    max_states=int(
                        max_states or self.config.max_states
                    ),
                    check_deadlock=bool(ck.check_deadlock),
                )
            except Exception as e:  # noqa: BLE001 — plan must not
                #                      fail an otherwise valid submit
                self._log(f"warm: plan failed ({e!r:.160}) — cold")
                wplan = warm_plan.WarmPlan(
                    "cold", warm_plan.REASON_PLAN_ERROR
                )
        elif mode == "check" and self.warm_store is not None:
            wplan = warm_plan.WarmPlan("cold", warm_plan.REASON_OPT_OUT)
        jid = jobmod.new_job_id()
        # the fleet dispatcher forwards its minted trace_id on the
        # wire; a standalone daemon mints its own, so every job_*
        # event carries one either way
        trace_id = str(trace_id) if trace_id else uuid.uuid4().hex
        now = time.time()
        with self.cv:
            if submit_id:
                prev = self._submit_index.get((tenant, str(submit_id)))
                if prev is not None and prev in self.jobs:
                    # idempotent resubmit: the SAME job, no new enqueue
                    # (the reply a dropped connection lost is re-earned
                    # by the retry)
                    self.admission.count_dedup(tenant)
                    self.tel.emit(
                        "admission", action="dedup", tenant=tenant,
                        job_id=prev, submit_id=str(submit_id),
                    )
                    return self.jobs[prev]
            self._admission_gate(tenant, asking, spec)
            jdir = os.path.join(self.config.jobs_dir, jid)
            os.makedirs(jdir, exist_ok=True)
            job = Job(
                job_id=jid,
                spec=spec,
                cfg_path=cfg_path,
                dir=jdir,
                # the RESOLVED set (submitted list or cfg INVARIANTS) so
                # scheduling slices never rebuild the model to re-validate
                invariants=list(invs),
                max_states=max_states,
                time_budget_s=time_budget_s,
                tenant=tenant,
                priority=int(priority),
                deadline_unix=(
                    now + float(deadline_s)
                    if deadline_s is not None
                    else None
                ),
                submit_id=str(submit_id) if submit_id else None,
                trace_id=trace_id,
                mode=mode,
                sim=sim_norm,
                warm=bool(warm),
                warm_mode=wplan.mode if wplan else None,
                warm_reason=wplan.reason if wplan else None,
                warm_artifact=wplan.artifact if wplan else None,
                warm_widened=(
                    {k: list(v) for k, v in wplan.widened.items()}
                    if wplan and wplan.widened
                    else None
                ),
            )
            self.admission.count_admit(tenant)
            self.jobs[jid] = job
            self.fifo.append(jid)
            if job.submit_id:
                self._submit_index[(tenant, job.submit_id)] = jid
            self.cv.notify_all()
        # the per-job submit record: the static fields a torn-queue
        # rebuild needs (written before the queue snapshot so the dir
        # is never behind the snapshot describing it).  Best-effort:
        # the job is already ADMITTED — a record-write failure must
        # degrade the torn-queue rebuild for this one job, not fail a
        # submit the client would then retry into a ghost duplicate
        err = _write_json_atomic(job.record_path, job.to_dict())
        if err is not None:
            self._log(
                f"job {jid}: job.json write FAILED ({err!r:.120}); "
                "torn-queue rebuild would skip this job"
            )
        self.persist()
        # wall_unix anchors this stream's clock for obs/trace.py (the
        # daemon stream has no run_header; the first anchored record
        # fixes the run_id's offset on the shared wall timeline)
        self.tel.emit(
            "job_submit", job_id=jid, spec=spec, tenant=tenant,
            priority=int(priority), mode=mode,
            wall_unix=round(now, 3),
            trace_id=trace_id,
        )
        self.tel.emit(
            "admission", action="admit", tenant=tenant, job_id=jid,
        )
        if wplan is not None:
            # the plan decision, machine-readable (the `warm` event);
            # cold plans COUNT here — they will never reach install
            self.tel.emit(
                "warm", phase="plan", job_id=jid, spec=spec,
                mode=wplan.mode, reason=wplan.reason,
                **(
                    {"artifact": os.path.basename(wplan.artifact)}
                    if wplan.artifact
                    else {}
                ),
            )
            if wplan.mode == "cold":
                self._count_warm("cold", wplan.reason)
        self._log(
            f"job {jid}: submitted ({spec} @ {cfg_path}, "
            f"tenant={tenant}, prio={priority}"
            + (
                f", warm={wplan.mode}:{wplan.reason}"
                if wplan is not None
                else ""
            )
            + ")"
        )
        return job

    def _admission_gate(
        self, tenant: str, asking: int, spec: str
    ) -> None:
        """Quota check + the typed telemetry record on rejection
        (caller holds the cv).  Runs twice per submit — once before
        warm planning (the cheap door) and once under the enqueue cv
        (the authoritative decision); a submit rejects at most once,
        so the counters/events never double."""
        try:
            self.admission.check(
                tenant, asking, list(self.jobs.values())
            )
        except admmod.AdmissionError as e:
            self.tel.emit(
                "admission",
                action="shed" if e.code == "capacity" else "reject",
                tenant=tenant, reason=e.reason, spec=spec,
            )
            raise

    def cancel(self, job_id: str) -> Job:
        with self.cv:
            job = self._get(job_id)
            if job.terminal:
                return job
            job.cancel_requested = True
            if job.state in (jobmod.QUEUED, jobmod.SUSPENDED):
                # not on the device: cancel immediately
                try:
                    self.fifo.remove(job_id)
                except ValueError:
                    pass
                self._finish(job, jobmod.CANCELLED)
            # a RUNNING job exits at its next level boundary via the
            # suspend hook ("cancelled" stop reason)
            self.cv.notify_all()
        self.persist()
        return job

    # ---------------------------------------------------------- query

    def _get(self, job_id: str) -> Job:
        job = self.jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return job

    def get(self, job_id: str) -> Job:
        with self.cv:
            return self._get(job_id)

    def snapshot(self, tenant: Optional[str] = None) -> List[dict]:
        """Job-table summaries, oldest first.  ``tenant`` scopes the
        listing to that tenant's own jobs — the TCP path passes the
        authenticated tenant so a listing never hands one tenant the
        (unguessable-by-design) job ids of another."""
        with self.cv:
            return [
                j.summary()
                for j in sorted(
                    self.jobs.values(), key=lambda j: j.submitted_unix
                )
                if tenant is None or j.tenant == tenant
            ]

    def wait(
        self, job_id: str, timeout: Optional[float] = None
    ) -> Job:
        """Block until the job is terminal (or timeout); returns it."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        with self.cv:
            job = self._get(job_id)
            while not job.terminal:
                left = (
                    None
                    if deadline is None
                    else deadline - time.monotonic()
                )
                if left is not None and left <= 0:
                    break
                self.cv.wait(0.25 if left is None else min(left, 0.25))
            return job

    def idle(self) -> bool:
        with self.cv:
            return not self.fifo and not self._running

    # ------------------------------------------------------- the loop

    def _runnable(self) -> bool:
        return bool(self.fifo)

    def _claim(self, device: int = 0) -> Optional[Job]:
        """Claim order: highest priority first, FIFO within a
        priority class (the scan is stable — the leftmost of the max
        class wins, and a suspended job re-queued at the tail keeps
        round-robin fairness within its class).  ``device`` is the
        local slot doing the claiming: the job runs on that
        slot's pool until it finishes or suspends."""
        with self.cv:
            if self._stop.is_set() or not self.fifo:
                return None
            best = max(self.jobs[j].priority for j in self.fifo)
            jid = next(
                j for j in self.fifo
                if self.jobs[j].priority == best
            )
            self.fifo.remove(jid)
            job = self.jobs[jid]
            self._running[device] = jid
            job.state = jobmod.RUNNING
            if job.started_unix is None:
                job.started_unix = time.time()
        self.persist()
        return job

    def _loop(self, device: int = 0) -> None:
        while not self._stop.is_set():
            self._sweep_deadlines()
            job = self._claim(device)
            if job is None:
                with self.cv:
                    if not self._stop.is_set() and not self.fifo:
                        self.cv.wait(0.25)
                continue
            self._run_slice(job, device)

    def _other_waiting(self) -> bool:
        with self.cv:
            return bool(self.fifo)

    def _higher_waiting(self, priority: int) -> bool:
        """A queued job outranking ``priority`` — the preemption
        signal the suspend hook polls at level boundaries."""
        with self.cv:
            return any(
                self.jobs[jid].priority > priority
                for jid in self.fifo
            )

    # ------------------------------------------------------ deadlines

    def _sweep_deadlines(self) -> int:
        """Cancel queued/suspended jobs whose deadline passed (the
        running job cancels itself through the hook's deadline check).
        Returns the number of jobs expired this sweep."""
        now = time.time()
        expired: List[Job] = []
        with self.cv:
            for job in self.jobs.values():
                if (
                    job.terminal
                    or job.deadline_unix is None
                    or now < job.deadline_unix
                    or job.job_id in self._running.values()
                ):
                    continue
                try:
                    self.fifo.remove(job.job_id)
                except ValueError:
                    pass
                expired.append(job)
        for job in expired:
            self._expire(job)
        return len(expired)

    def _expire(self, job: Job, r=None) -> None:
        """Deadline-exceeded completion: an honest truncation record
        (``stop_reason="deadline"``, never a verification verdict)
        carrying whatever progress the job banked, plus the
        ``deadline`` telemetry event."""
        progress = dict(job.progress or {})
        if r is not None:
            progress = {
                "distinct_states": int(r.distinct_states),
                "diameter": int(r.diameter),
                "level_sizes": [int(x) for x in r.level_sizes],
            }
            job.wall_s = float(r.wall_s)
        result = {
            "status": "deadline",
            "truncated": True,
            "stop_reason": "deadline",
            **progress,
            "wall_s": round(float(job.wall_s), 3),
            "slices": job.slices,
            "suspends": job.suspends,
            "run_ids": list(job.run_ids),
        }
        with self.cv:
            # a concurrent cancel() may have won since the sweep
            # released the cv — the FIRST terminal transition stands
            # (re-finishing would flip a state the cancelling client
            # was already told and double the job_result event)
            if job.terminal:
                return
            job.result = result
            self._finish(job, jobmod.DONE)
        self.tel.emit(
            "deadline", job_id=job.job_id, tenant=job.tenant,
            deadline_unix=round(job.deadline_unix or 0.0, 3),
        )
        err = _write_json_atomic(job.result_path, job.result)
        if err is not None:
            # a full disk must not kill the sweep (and with it the
            # scheduler thread): the result stays queryable in the
            # table and in the job_result event
            self._log(
                f"job {job.job_id}: deadline result.json write "
                f"FAILED ({err!r:.120}); table record stands"
            )
        self.persist()
        self._log(
            f"job {job.job_id}: deadline exceeded — cancelled "
            f"(stop_reason=deadline, {progress.get('distinct_states', 0)}"
            " states banked)"
        )

    # ------------------------------------------------------ warm layer

    def _module_digest(self, spec: str) -> str:
        d = self._mod_digests.get(spec)
        if d is None:
            from pulsar_tlaplus_tpu_torch.models import registry

            d = registry.module_digest(spec)
            self._mod_digests[spec] = d
        return d

    def _count_warm(self, mode: str, reason: str) -> None:
        with self._warm_lock:
            key = (mode, reason)
            self.warm_counts[key] = self.warm_counts.get(key, 0) + 1

    def _warm_install(self, job: Job, ck):
        """Verify + install the planned artifact at the job's first
        slice.  ``continue``: the artifact frame (and spill dir)
        becomes the job's own frame — the slice resumes it.
        ``reseed``: returns the engine seed built from the verified
        artifact.  ANY failure — digest mismatch (``corrupt@warm``),
        torn manifest, signature disagreement, a build error —
        demotes the job to a cold run with a typed reason: *never a
        wrong verdict*, and the unverifiable artifact is
        quarantined."""
        store = self.warm_store
        mode = job.warm_mode
        adir = job.warm_artifact

        def demote(reason: str):
            job.warm_mode = "cold"
            job.warm_reason = reason
            job.warm_artifact = None
            self._count_warm("cold", reason)
            self.tel.emit(
                "warm", phase="install", job_id=job.job_id,
                mode="cold", reason=reason,
            )
            self._log(
                f"job {job.job_id}: warm {mode} demoted to cold "
                f"({reason}) — full recheck"
            )
            return None

        if store is None or not adir or not os.path.isdir(adir):
            return demote(warm_plan.REASON_NO_ARTIFACT)
        ok, why = store.verify(adir)
        if not ok:
            store.quarantine(adir, why)
            return demote(why.split(":", 1)[0])
        seed = None
        try:
            man = store.load_manifest(adir)
            # the producing run's own trace-depth allowance: an
            # artifact harvested from a RESEEDED run carries merged
            # level_sizes, so the deficit compounds across
            # generations and must ride the manifest
            extra = int(man.get("extra_trace_depth") or 0)
            if not warm_plan.is_port_artifact(man):
                # not written by this package (a JAX-package artifact)
                return demote(warm_plan.REASON_ENGINE_CONFIG)
            if mode == "continue":
                # authoritative gates: the engine's OWN frame
                # signature must agree byte-for-byte, and the model
                # SOURCE digest must be current (the sig identifies
                # the model by name + bindings, not by source — a
                # re-guarded action keeps the sig)
                if man.get("config_sig") != ck._config_sig():
                    return demote(warm_plan.REASON_ENGINE_CONFIG)
                if man.get("module_digest") != self._module_digest(
                    job.spec
                ):
                    return demote(warm_plan.REASON_MODULE_EDIT)
                # the plan read the manifest at submit: a later harvest
                # for the same sig (another job's run) may have replaced
                # the artifact with one past this job's budget, which
                # the engine refuses to resume
                if int(man.get("distinct_states") or 0) > ck.SCAP:
                    return demote(warm_plan.REASON_BUDGET)
                shutil.copyfile(
                    os.path.join(adir, warm_store.FRAME),
                    job.frame_path,
                )
                spill_src = os.path.join(
                    adir, f"{warm_store.FRAME}.spill"
                )
                if os.path.isdir(spill_src):
                    dst = f"{job.frame_path}.spill"
                    shutil.rmtree(dst, ignore_errors=True)
                    shutil.copytree(spill_src, dst)
                job.warm_seed_levels = extra
                info = {
                    "states": int(man.get("distinct_states") or 0),
                }
            else:
                widened = {
                    k: (int(v[0]), int(v[1]))
                    for k, v in (job.warm_widened or {}).items()
                }
                t_seed = time.perf_counter()
                seed, info = warm_plan.build_reseed_seed(
                    adir, man, ck.model, widened
                )
                # the host's share of a reseed: load + saturation scan
                info["seed_build_s"] = round(
                    time.perf_counter() - t_seed, 4)
                # the merged seed levels no longer bound chain depth:
                # allow trace walks the artifact's original levels
                # (plus ITS producer's allowance) on top
                job.warm_seed_levels = (
                    int(man.get("levels") or 0) + extra
                )
        except Exception as e:  # noqa: BLE001 — a broken artifact
            #                      must never fail the job
            self._log(f"warm: install error ({e!r:.200})")
            return demote(warm_plan.REASON_INSTALL)
        self._count_warm(mode, job.warm_reason or "ok")
        self.tel.emit(
            "warm", phase="install", job_id=job.job_id, mode=mode,
            reason=job.warm_reason or "ok",
            artifact=os.path.basename(adir), **info,
        )
        self._log(
            f"job {job.job_id}: warm {mode} installed "
            f"({job.warm_reason}; {info})"
        )
        return seed

    def _warm_harvest(self, job: Job, ck) -> None:
        """Persist the finished run's frame as the warm artifact for
        its config signature.  Completed clean runs frame via the
        engine's ``final_frame``; truncated runs already left their
        budget-stop frame.  Harvest failures are logged and ignored —
        the job's result is already safe."""
        if (
            self.warm_store is None
            or ck is None
            or not job.warm
            or job.mode != "check"
            or not job.result
        ):
            return
        if job.result.get("status") not in ("ok", "truncated"):
            return
        if job.result.get("stop_reason") in ("deadline", "cancelled"):
            return
        if not os.path.exists(job.frame_path):
            return
        try:
            from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

            tlc_cfg = cfgmod.load(job.cfg_path)
            man = warm_plan.manifest_for(
                job.spec,
                dict(tlc_cfg.constants),
                tuple(job.invariants or ()),
                ck,
                {
                    "distinct_states": int(
                        job.result.get("distinct_states") or 0
                    ),
                    "levels": len(
                        job.result.get("level_sizes") or []
                    ),
                    "truncated": bool(job.result.get("truncated")),
                    "stop_reason": job.result.get("stop_reason"),
                    "job_id": job.job_id,
                    "warm": job.warm_mode,
                    # a reseeded run's frame has MERGED level_sizes:
                    # consumers of this artifact need the same
                    # parent-chain depth allowance this run ran with
                    "extra_trace_depth": int(
                        job.warm_seed_levels or 0
                    ),
                },
            )
            adir = self.warm_store.save(job.frame_path, man)
        except Exception as e:  # noqa: BLE001
            self._log(f"warm: harvest failed ({e!r:.200})")
            return
        if adir:
            self.tel.emit(
                "warm", phase="harvest", job_id=job.job_id,
                mode=job.warm_mode or "cold", reason="harvested",
                artifact=os.path.basename(adir),
                states=int(job.result.get("distinct_states") or 0),
            )
            self._log(
                f"job {job.job_id}: warm artifact saved "
                f"({os.path.basename(adir)})"
            )

    def _mk_hook(
        self, job: Job, deadline: Optional[float],
        resume: bool = False, ck=None,
    ):
        """The engine's cooperative suspend hook, polled at level
        boundaries: daemon shutdown and slice expiry suspend (frame +
        requeue); a cancel request discards the run.

        On a RESUMED slice the first poll additionally emits the
        ``job_resume`` event: it fires right after the engine finished
        rebuilding from the frame (the poll precedes any expansion), so
        the record can carry the measured ``restore_s``, the context
        switch's restore cost."""
        polls = [0]
        t_slice = time.monotonic()

        def hook() -> Optional[str]:
            polls[0] += 1
            if polls[0] == 1 and resume:
                # the device checker times its frame restore before the
                # first boundary (its last_stats are the previous run's)
                restore_s = getattr(ck, "_restore_s", None)
                if restore_s is None:
                    # engine didn't report: the wall from run() start
                    # to this first boundary IS the restore+setup cost
                    restore_s = round(time.monotonic() - t_slice, 3)
                hook.resume_emitted = True
                self.tel.emit(
                    "job_resume",
                    job_id=job.job_id, spec=job.spec,
                    slice=job.slices, restore_s=float(restore_s),
                    trace_id=job.trace_id,
                )
            if job.cancel_requested:
                return "cancelled"
            if (
                job.deadline_unix is not None
                and time.time() >= job.deadline_unix
            ):
                # deadline exceeded mid-run: discard the run (the
                # scheduler converts the "cancelled" stop into the
                # deadline completion record)
                return "cancelled"
            if self._stop.is_set():
                return "suspended"
            # the engine polls BEFORE expanding each level, so the
            # first poll of a slice precedes any progress: a timed
            # suspend there (slice budget < frame-restore cost) would
            # ping-pong two jobs forever at zero states/slice.  Every
            # slice therefore advances >= one level before yielding.
            if polls[0] == 1:
                return None
            if self._higher_waiting(job.priority):
                # priority preemption: a waiting higher-priority job
                # takes the device at this level boundary — no need to
                # wait out the slice quantum
                return "suspended"
            if (
                deadline is not None
                and time.monotonic() >= deadline
                and self._other_waiting()
            ):
                return "suspended"
            return None

        hook.resume_emitted = False
        return hook

    def _run_slice(self, job: Job, device: int = 0) -> None:
        from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

        if job.mode == "simulate":
            return self._run_sim_slice(job, device)
        pool = self.pools[device]
        job.slices += 1
        # resume iff a frame reached disk — even on slice 1: a crashed
        # daemon's mid-first-slice frame (recover() marked the job
        # suspended) must not be thrown away by a slice-count guard
        resume = os.path.exists(job.frame_path)
        try:
            tlc_cfg = cfgmod.load(job.cfg_path)
            invs = (
                tuple(job.invariants)
                if job.invariants is not None
                # pre-resolved-era queue.json: resolve the cfg default
                else pool.resolve_invariants(
                    job.spec, tlc_cfg, None
                )
            )
            _key, ck = pool.get(
                job.spec, tlc_cfg, invs, job.max_states
            )
        except Exception as e:  # noqa: BLE001 — a bad job must not
            #                      take the scheduler thread down
            self._fail(job, e)
            return
        # warm install: on the job's FIRST slice (no frame yet),
        # a planned continue copies the verified artifact frame into
        # the job dir (the resume below picks it up) and a planned
        # reseed builds the engine seed; any verification failure
        # demotes to a cold run
        warm_seed = None
        if (
            job.warm_mode in ("continue", "reseed")
            and not os.path.exists(job.frame_path)
        ):
            warm_seed = self._warm_install(job, ck)
        resume = os.path.exists(job.frame_path)
        remaining = None
        if job.time_budget_s is not None:
            remaining = job.time_budget_s - job.wall_s
            if remaining <= 0:
                self._complete(job, None, budget_exhausted=True, ck=ck)
                return
        if not resume:
            # fresh slices announce up front; RESUMED slices announce
            # from the hook's first level-boundary poll instead, where
            # the measured restore_s is known (_mk_hook)
            self.tel.emit(
                "job_start",
                job_id=job.job_id, spec=job.spec, slice=job.slices,
                trace_id=job.trace_id,
            )
        self._log(
            f"job {job.job_id}: slice {job.slices} "
            f"({'resume' if resume else 'start'})"
        )
        # per-slice assignment of the job's survivability + telemetry
        # identity onto the pooled checker (engine state is otherwise
        # rebuilt per run())
        ck.checkpoint_path = job.frame_path
        ck.rec.checkpoint_path = job.frame_path
        ck.checkpoint_every = self.config.checkpoint_every
        ck._telemetry_arg = job.events_path
        ck.time_budget_s = remaining
        # the job's identity on every slice's run header (tenant,
        # trace_id, warm), and the final frame a clean completion
        # leaves as its reseed artifact
        ck.tenant = job.tenant
        ck.trace_id = job.trace_id
        ck.warm = (
            job.warm_mode
            if job.warm_mode in ("continue", "reseed")
            else None
        )
        ck.final_frame = bool(
            self.warm_store is not None and job.warm
        )
        ck.extra_trace_depth = int(job.warm_seed_levels or 0)
        prev_wall = float(job.wall_s)
        hook = self._mk_hook(
            job, time.monotonic() + self.config.slice_s,
            resume=resume, ck=ck,
        )
        ck.suspend_hook = hook
        self._active_cks[device] = ck
        try:
            r = ck.run(seed=warm_seed, resume=resume)
        except Exception as e:  # noqa: BLE001
            self._fail(job, e)
            return
        finally:
            ck.suspend_hook = None
            # the pooled checker is shared: per-slice state must not
            # leak into another job's (or a solo) run on it
            ck.warm = ck.tenant = ck.trace_id = None
            ck.final_frame = False
            ck.extra_trace_depth = 0
            self._active_cks.pop(device, None)
            # the metrics verb answers from this after the slice ends —
            # plain host dict copies, no device access
            self.last_engine = {
                "job_id": job.job_id,
                "spec": job.spec,
                "stats": dict(getattr(ck, "last_stats", {}) or {}),
                "snap": dict(getattr(ck, "_snap", {}) or {}),
            }
            # drop the run's device buffers: a suspended job's state
            # is its frame on disk, and the next job needs the memory
            ck._free_buffers()
        if ck._run_id:
            job.run_ids.append(ck._run_id)
        if resume and not hook.resume_emitted:
            # the slice ended before its first level-boundary poll
            # (e.g. a time budget smaller than the restore cost): the
            # restore was still PAID, and losing its record would hide
            # exactly the pathological context switch worth seeing —
            # emit the resume now, before the suspend/result record,
            # so stream order stays resume < terminal
            self.tel.emit(
                "job_resume",
                job_id=job.job_id, spec=job.spec, slice=job.slices,
                restore_s=float(
                    (ck.last_stats or {}).get("restore_s") or 0.0
                ),
                trace_id=job.trace_id,
            )
        job.wall_s = float(r.wall_s)
        if r.stop_reason == "suspended":
            job.suspends += 1
            job.progress = {
                "distinct_states": int(r.distinct_states),
                "diameter": int(r.diameter),
                "level_sizes": [int(x) for x in r.level_sizes],
            }
            with self.cv:
                job.state = jobmod.SUSPENDED
                self._running.pop(device, None)
                self.fifo.append(job.job_id)
                self.cv.notify_all()
            self.persist()
            # the engine wall this slice actually delivered, plus
            # the suspend frame's write/stall cost (the LAST frame of
            # the slice IS the suspend frame) — with job_resume's
            # restore_s these price the whole context switch
            suspend_extra = {
                "slice_wall_s": round(
                    max(float(r.wall_s) - prev_wall, 0.0), 3
                ),
            }
            ls = getattr(ck, "last_stats", {}) or {}
            if "ckpt_last_write_s" in ls:
                suspend_extra["frame_write_s"] = ls["ckpt_last_write_s"]
            if "ckpt_last_stall_s" in ls:
                suspend_extra["frame_stall_s"] = ls["ckpt_last_stall_s"]
            if ck._run_id:
                # the slice's ENGINE run id (the envelope run_id is
                # the daemon's): lets consumers join this event to the
                # per-job stream's level records — top's sparklines
                suspend_extra["engine_run_id"] = ck._run_id
            self.tel.emit(
                "job_suspend", job_id=job.job_id, slice=job.slices,
                trace_id=job.trace_id,
                **suspend_extra,
            )
            self._log(
                f"job {job.job_id}: suspended at a frame boundary "
                f"({r.distinct_states} states so far)"
            )
            return
        if r.stop_reason == "cancelled":
            if not job.cancel_requested and (
                job.deadline_unix is not None
                and time.time() >= job.deadline_unix
            ):
                # the hook discarded the run because the DEADLINE
                # passed, not because a client asked: complete with
                # the honest deadline record instead of "cancelled"
                self._expire(job, r)
                return
            with self.cv:
                self._finish(job, jobmod.CANCELLED)
            self.persist()
            return
        self._complete(job, r, ck=ck)

    def _run_sim_slice(self, job: Job, device: int = 0) -> None:
        """One scheduling slice of a SIMULATION job: the walker
        swarm runs until the slice budget expires and another job
        waits, suspending at a SEGMENT boundary through the same
        cooperative hook as BFS jobs — the frame anchors the PRNG
        position, so the resumed slice continues the identical walk
        stream."""
        from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

        pool = self.pools[device]
        job.slices += 1
        resume = os.path.exists(job.frame_path)
        try:
            tlc_cfg = cfgmod.load(job.cfg_path)
            invs = (
                tuple(job.invariants)
                if job.invariants is not None
                else pool.resolve_invariants(
                    job.spec, tlc_cfg, None
                )
            )
            _key, eng = pool.get_sim(
                job.spec, tlc_cfg, invs, job.sim or {}
            )
        except Exception as e:  # noqa: BLE001 — a bad job must not
            #                      take the scheduler thread down
            self._fail(job, e)
            return
        remaining = None
        if job.time_budget_s is not None:
            remaining = job.time_budget_s - job.wall_s
            if remaining <= 0:
                self._complete_sim(job, None, budget_exhausted=True)
                return
        if not resume:
            self.tel.emit(
                "job_start",
                job_id=job.job_id, spec=job.spec, slice=job.slices,
                trace_id=job.trace_id,
            )
        self._log(
            f"job {job.job_id}: sim slice {job.slices} "
            f"({'resume' if resume else 'start'})"
        )
        eng.checkpoint_path = job.frame_path
        eng.time_budget_s = remaining
        eng.tenant = job.tenant
        eng.trace_id = job.trace_id
        eng._telemetry_arg = job.events_path
        prev_wall = float(job.wall_s)
        hook = self._mk_hook(
            job, time.monotonic() + self.config.slice_s,
            resume=resume, ck=eng,
        )
        eng.suspend_hook = hook
        self._active_cks[device] = eng
        try:
            r = eng.run(resume=resume)
        except Exception as e:  # noqa: BLE001
            self._fail(job, e)
            return
        finally:
            eng.suspend_hook = None
            eng.tenant = eng.trace_id = None
            self._active_cks.pop(device, None)
            self.last_engine = {
                "job_id": job.job_id,
                "spec": job.spec,
                "stats": dict(getattr(eng, "last_stats", {}) or {}),
                "snap": dict(getattr(eng, "_snap", {}) or {}),
            }
            eng._free_buffers()
        if eng._run_id:
            job.run_ids.append(eng._run_id)
        if resume and not hook.resume_emitted:
            self.tel.emit(
                "job_resume",
                job_id=job.job_id, spec=job.spec, slice=job.slices,
                restore_s=0.0,
                trace_id=job.trace_id,
            )
        job.wall_s = float(r.wall_s)
        if r.stop_reason == "suspended":
            job.suspends += 1
            job.progress = {
                "steps": int(r.steps),
                "states_visited": int(r.states_visited),
                "walks": int(r.walks),
            }
            with self.cv:
                job.state = jobmod.SUSPENDED
                self._running.pop(device, None)
                self.fifo.append(job.job_id)
                self.cv.notify_all()
            self.persist()
            suspend_extra = {
                "slice_wall_s": round(
                    max(float(r.wall_s) - prev_wall, 0.0), 3
                ),
            }
            if eng._run_id:
                suspend_extra["engine_run_id"] = eng._run_id
            self.tel.emit(
                "job_suspend", job_id=job.job_id, slice=job.slices,
                trace_id=job.trace_id,
                **suspend_extra,
            )
            self._log(
                f"job {job.job_id}: sim suspended at a segment "
                f"boundary ({r.steps} steps so far)"
            )
            return
        if r.stop_reason == "cancelled":
            if not job.cancel_requested and (
                job.deadline_unix is not None
                and time.time() >= job.deadline_unix
            ):
                self._expire(job)
                return
            with self.cv:
                self._finish(job, jobmod.CANCELLED)
            self.persist()
            return
        self._complete_sim(job, r)

    @staticmethod
    def sim_result_record(job: Job, r) -> dict:
        """The simulation result payload (`mode: "simulate"`): walk-
        stream counters + throughput instead of the BFS state/diameter
        story; status mirrors `check` semantics (a violation is a
        verdict, an exhausted budget is a clean non-exhaustive end)."""
        if r.violation:
            status = "violation"
        elif r.truncated:
            status = "truncated"
        else:
            status = "ok"
        return {
            "status": status,
            "mode": "simulate",
            "violation": r.violation,
            "verified": r.verified,
            "steps": int(r.steps),
            "states_visited": int(r.states_visited),
            "walks": int(r.walks),
            "segments": int(r.segments),
            "n_walkers": int(r.n_walkers),
            "depth": int(r.depth),
            "dup_ratio_est": r.dup_ratio_est,
            "truncated": bool(r.truncated),
            "stop_reason": r.stop_reason,
            "trace": (
                [repr(s) for s in r.trace]
                if r.trace is not None
                else None
            ),
            "trace_actions": (
                list(r.trace_actions)
                if r.trace_actions is not None
                else None
            ),
            "wall_s": round(float(r.wall_s), 3),
            "steps_per_sec": float(r.steps_per_sec),
            "walks_per_sec": float(r.walks_per_sec),
            "slices": job.slices,
            "suspends": job.suspends,
            "run_ids": list(job.run_ids),
        }

    def _complete_sim(
        self, job: Job, r, budget_exhausted: bool = False
    ) -> None:
        if budget_exhausted:
            # a time-budget end is a CLEAN (non-exhaustive) simulation
            # result — the same status the engine reports when the
            # budget expires mid-slice (stop_reason="time_budget",
            # truncated=False), so slice timing never changes a sim
            # job's status
            job.result = {
                "status": "ok",
                "mode": "simulate",
                "truncated": False,
                "stop_reason": "time_budget",
                "violation": None,
                **(job.progress or {}),
                "wall_s": round(float(job.wall_s), 3),
                "slices": job.slices,
                "suspends": job.suspends,
                "run_ids": list(job.run_ids),
            }
        else:
            job.result = self.sim_result_record(job, r)
        err = _write_json_atomic(job.result_path, job.result)
        if err is not None:
            self._log(
                f"job {job.job_id}: result.json write FAILED "
                f"({err!r:.120}); table record stands"
            )
        with self.cv:
            self._finish(job, jobmod.DONE)
        self.persist()
        self._log(
            f"job {job.job_id}: done ({job.result.get('status')}, "
            f"{job.result.get('steps')} sim steps)"
        )

    # ----------------------------------------------------- completion

    @staticmethod
    def result_record(job: Job, r) -> dict:
        if r.violation and r.violation != "Deadlock":
            status = "violation"
        elif r.deadlock:
            status = "deadlock"
        elif r.truncated:
            status = "truncated"
        else:
            status = "ok"
        return {
            "status": status,
            "distinct_states": r.distinct_states,
            "diameter": r.diameter,
            "level_sizes": [int(x) for x in r.level_sizes],
            "truncated": bool(r.truncated),
            "stop_reason": r.stop_reason,
            "violation": r.violation,
            "violation_gid": r.violation_gid,
            "deadlock": bool(r.deadlock),
            "trace": (
                [repr(s) for s in r.trace]
                if r.trace is not None
                else None
            ),
            "trace_actions": (
                list(r.trace_actions)
                if r.trace_actions is not None
                else None
            ),
            "wall_s": round(float(r.wall_s), 3),
            "states_per_sec": round(float(r.states_per_sec), 1),
            "hbm_recovered": int(r.hbm_recovered),
            "fp_collision_prob": float(r.fp_collision_prob),
            "slices": job.slices,
            "suspends": job.suspends,
            "run_ids": list(job.run_ids),
        }

    def _complete(
        self, job: Job, r, budget_exhausted: bool = False, ck=None
    ):
        if budget_exhausted:
            # no fresh CheckerResult — the budget died between slices;
            # report the last suspended slice's progress, not nothing
            job.result = {
                "status": "truncated",
                "truncated": True,
                "stop_reason": "time_budget",
                **(job.progress or {}),
                "wall_s": round(float(job.wall_s), 3),
                "slices": job.slices,
                "suspends": job.suspends,
                "run_ids": list(job.run_ids),
            }
        else:
            job.result = self.result_record(job, r)
        if job.warm_mode is not None:
            # the reuse decision rides the durable result record too
            # (mode + reason on the job record)
            job.result.setdefault("warm", job.warm_mode)
            job.result.setdefault("warm_reason", job.warm_reason)
        err = _write_json_atomic(job.result_path, job.result)
        if err is not None:
            # disk-full on the result artifact: the completion stands
            # (table + job_result event); only the durable copy is lost
            self._log(
                f"job {job.job_id}: result.json write FAILED "
                f"({err!r:.120}); table record stands"
            )
        # harvest BEFORE _finish removes the terminal job's frame —
        # this frame (budget-stop or final_frame) IS the artifact
        self._warm_harvest(job, ck)
        with self.cv:
            self._finish(job, jobmod.DONE)
        self.persist()
        self._log(
            f"job {job.job_id}: done ({job.result.get('status')}, "
            f"{job.result.get('distinct_states')} states)"
        )

    def _fail(self, job: Job, e: BaseException) -> None:
        job.error = repr(e)[:500]
        with self.cv:
            self._finish(job, jobmod.FAILED)
        self.persist()
        self._log(f"job {job.job_id}: FAILED ({job.error[:120]})")

    def _finish(self, job: Job, state: str) -> None:
        """Terminal transition; caller holds the cv.  Idempotence
        guard: the first terminal transition wins — a deadline sweep
        and a client cancel racing to finish the same job must not
        emit two job_result events or flip the state twice."""
        if job.terminal:
            return
        job.state = state
        job.finished_unix = time.time()
        for d, jid in list(self._running.items()):
            if jid == job.job_id:
                del self._running[d]
        # the frame is dead weight once the job is terminal
        if state != jobmod.SUSPENDED:
            try:
                os.remove(job.frame_path)
            except OSError:
                pass
        self.cv.notify_all()
        self.tel.emit(
            "job_result",
            job_id=job.job_id,
            tenant=job.tenant,
            status=(
                job.result.get("status", state)
                if job.result
                else state
            ),
            # cumulative engine wall across ALL slices (the final,
            # never-suspended slice included) — the --jobs overhead
            # table's denominator; slice_wall_s sums only cover the
            # suspended slices
            wall_s=round(float(job.wall_s), 3),
            trace_id=job.trace_id,
            # the final slice's engine run id (join key into the
            # per-job stream, like job_suspend.engine_run_id)
            **(
                {"engine_run_id": job.run_ids[-1]}
                if job.run_ids
                else {}
            ),
        )
        if state == jobmod.CANCELLED:
            self.tel.emit(
                "job_cancel", job_id=job.job_id,
                trace_id=job.trace_id,
            )
