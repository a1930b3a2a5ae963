#!/usr/bin/env python
"""Service and fleet chaos drills of the PyTorch port: a daemon under a
seeded fault schedule, concurrent retrying clients, and a solo-parity
verdict (the JAX package's ``scripts/chaos.py``, over
``pulsar_tlaplus_tpu_torch``).

The default drill (:func:`run_chaos`) runs a real ``ServiceDaemon``
(unix socket + authenticated TCP) with a seeded, reproducible schedule
of service faults —

    drop@conn:N      the daemon closes connection N before replying
                     (the request still processed: the ack-lost shape)
    torn@line:N      the daemon's N-th sent protocol line is torn
    enospc@persist:N queue.json snapshot N hits a synthetic disk-full

    corrupt@warm:N   the N-th warm-artifact digest verification
                     computes a corrupted digest (the warm layer's
                     fallback drill)

— while concurrent clients submit jobs over TCP with bearer tokens,
retrying through the chaos with backoff + jitter and idempotent
``submit_id`` dedup.  A warm phase then submits a TRUNCATED job and
resubmits it at a widened budget with the warm store's next
verification corrupted: the job must fall back COLD with a typed reason
(``digest_mismatch``), quarantine the artifact, and still land the
solo-exact result.  The drill PASSES iff:

- every ADMITTED job completes with state-for-state solo parity
  (distinct states, diameter, level sizes, verdict, violation gid,
  full trace);
- rejected submits (bad token, over quota) were rejected AT THE DOOR
  — typed errors, no silently queued job — and show up in the
  ``ptt_admission_*`` metric families;
- a retried submit never created a second job (admitted == table);
- the daemon's stream and every per-job stream validate
  (``obs/schema.validate_stream``).

``--fleet-v1`` runs the failover drill (:func:`run_fleet_chaos`) and
``--fleet`` the fleet survivability drill (:func:`run_fleet_chaos_v2`,
whose dispatcher is a real ``cli dispatch`` subprocess killed with -9).

Every random choice (fault schedule, client jitter) derives from
``--seed``; the same seed gives the JAX script's schedule.  The daemons'
slots run on the card unless ``--cpu`` (``cpu=True``) is given; without
a card the script exits 2 ("no CUDA device").

    python scripts/torch_chaos.py --cpu --seed 7
    python scripts/torch_chaos.py --cpu --seed 7 --schedule \\
        "drop@conn:2,torn@line:4,enospc@persist:2"   # pinned faults
    python scripts/torch_chaos.py --cpu --fleet       # survivability
    python scripts/torch_chaos.py --cpu --fleet-v1    # failover
    python scripts/torch_chaos.py --seed 7            # on the card

Exit status: 0 = the drill passed, 1 = a drill invariant broke
(``chaos: FAIL: ...`` on stderr), 2 = usage or no card.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pulsar_tlaplus_tpu_torch.service.client import (  # noqa: E402
    AdmissionRejected,
    AuthError,
    ServiceClient,
)

# small, CPU-cheap engine geometry (the service tests' shape)
GEOM_FAST = dict(
    sub_batch=64,
    visited_cap=1 << 10,
    frontier_cap=1 << 8,
    max_states=1 << 20,
    checkpoint_every=1,
)

# the two drill workloads: one clean pass (compaction producer_on,
# 1,654 states / diameter 16) and one pinned invariant violation
# (bookkeeper crash2, 9-state ConfirmedEntryReadable counterexample)
SMALL_COMPACTION_CFG = """
CONSTANTS
    MessageSentLimit = 2
    CompactionTimesLimit = 2
    ModelConsumer = FALSE
    ConsumeTimesLimit = 2
    KeySpace = {1}
    ValueSpace = {1}
    RetainNullKey = TRUE
    MaxCrashTimes = 1
    ModelProducer = TRUE
SPECIFICATION Spec
INVARIANTS
"""

BK_CRASH2_CFG = """
CONSTANTS
    NumBookies = 3
    WriteQuorum = 2
    AckQuorum = 2
    EntryLimit = 2
    MaxBookieCrashes = 2
SPECIFICATION Spec
INVARIANTS
    ConfirmedEntryReadable
"""

# the solo runs of the two workloads at GEOM_FAST, as the JAX engine
# gives them (tests/test_torch_chaos.py holds both engines to these;
# ``trace_sha256`` is of the trace's state reprs joined by newlines)
SOLO_PINS = {
    "compaction": dict(
        distinct_states=1654, diameter=16,
        level_sizes=[1, 5, 24, 56, 76, 108, 124, 128, 156, 156, 160, 192,
                     212, 56, 88, 112],
        violation=None, violation_gid=None, trace_len=None,
        trace_sha256=None),
    "bookkeeper": dict(
        distinct_states=308, diameter=9,
        level_sizes=[1, 4, 9, 17, 32, 50, 64, 67, 64],
        violation="ConfirmedEntryReadable", violation_gid=305, trace_len=9,
        trace_sha256="073b6a1c26f07e409f071cc16629d4707ffb4ee4796df2ae3f22"
        "764f5f7b7fe8"),
}

TOKENS = {
    "tokens_v": 1,
    "tenants": [
        {"tenant": "alpha", "token": "chaos-alpha-token-1"},
        {"tenant": "beta", "token": "chaos-beta-token-22"},
    ],
}


class ChaosFailure(AssertionError):
    """A drill invariant broken — the report rides the message."""


def build_schedule(
    seed: int, n: int = 4, lo: int = 1, hi: int = 10
) -> str:
    """Seeded random service-fault schedule (reproducible: the same
    seed always yields the same PTT_FAULT string)."""
    rng = random.Random(seed)
    kinds = [
        ("drop", "conn"), ("torn", "line"), ("enospc", "persist"),
    ]
    specs = []
    for _ in range(n):
        kind, site = rng.choice(kinds)
        specs.append(f"{kind}@{site}:{rng.randint(lo, hi)}")
    return ",".join(specs)


def _validate_streams(paths: List[str]) -> List[str]:
    from pulsar_tlaplus_tpu_torch.obs.schema import validate_stream

    errors: List[str] = []
    for p in paths:
        errors += validate_stream(p)
    return errors


def _solo_results(pool, workloads) -> Dict[str, object]:
    """Solo baselines with the pool's exact engine geometry (run
    BEFORE the daemon starts — the pooled checkers are the same
    objects the scheduler will use)."""
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

    solos = {}
    for name, (spec, cfg_path) in workloads.items():
        tlc_cfg = cfgmod.load(cfg_path)
        invs = pool.resolve_invariants(spec, tlc_cfg, None)
        _key, ck = pool.get(spec, tlc_cfg, invs)
        solos[name] = ck.run()
    return solos


def solo_summary(r) -> dict:
    """The fields of :data:`SOLO_PINS` of a checker result."""
    import hashlib

    trace = None if r.trace is None else [repr(x) for x in r.trace]
    return dict(
        distinct_states=r.distinct_states, diameter=r.diameter,
        level_sizes=[int(x) for x in r.level_sizes],
        violation=r.violation, violation_gid=r.violation_gid,
        trace_len=None if trace is None else len(trace),
        trace_sha256=None if trace is None else hashlib.sha256(
            "\n".join(trace).encode()).hexdigest())


def _assert_parity(job_result: dict, solo, label: str) -> None:
    checks = [
        ("distinct_states", solo.distinct_states),
        ("diameter", solo.diameter),
        ("level_sizes", [int(x) for x in solo.level_sizes]),
        ("violation", solo.violation),
        ("violation_gid", solo.violation_gid),
        (
            "trace",
            [repr(s) for s in solo.trace]
            if solo.trace is not None
            else None,
        ),
    ]
    for key, want in checks:
        got = job_result.get(key)
        if got != want:
            raise ChaosFailure(
                f"{label}: {key} diverged from solo "
                f"(got {got!r}, want {want!r})"
            )


def _write_cfgs(state_dir: str, bookkeeper: bool = False) -> dict:
    """The drill's cfg files under ``state_dir/cfgs``: name -> path."""
    cfg_dir = os.path.join(state_dir, "cfgs")
    os.makedirs(cfg_dir, exist_ok=True)
    out = {"compaction": os.path.join(cfg_dir, "small_compaction.cfg")}
    texts = [(out["compaction"], SMALL_COMPACTION_CFG)]
    if bookkeeper:
        out["bookkeeper"] = os.path.join(cfg_dir, "bk_crash2.cfg")
        texts.append((out["bookkeeper"], BK_CRASH2_CFG))
    for path, text in texts:
        with open(path, "w") as f:
            f.write(text)
    return out


def run_chaos(
    state_dir: str,
    seed: int = 0,
    schedule: Optional[str] = None,
    pool=None,
    geom: Optional[dict] = None,
    clients: int = 2,
    jobs_per_client: int = 2,
    solos: Optional[dict] = None,
    quota_burst: int = 4,
    tenant_max_queued: int = 2,
    slice_s: float = 0.2,
    timeout_s: float = 600.0,
    log=lambda m: print(f"chaos: {m}", file=sys.stderr, flush=True),
    cpu: bool = False,
) -> dict:
    """One full drill; returns the report dict, raises
    :class:`ChaosFailure` on any broken invariant.  ``cpu`` puts the
    daemon's slot on the CPU (else cuda:0; a given ``pool`` keeps its
    own device)."""
    from pulsar_tlaplus_tpu_torch.service.scheduler import (
        CheckerPool,
        ServiceConfig,
    )
    from pulsar_tlaplus_tpu_torch.service.server import ServiceDaemon
    from pulsar_tlaplus_tpu_torch.utils import faults

    geom = dict(geom or GEOM_FAST)
    os.makedirs(state_dir, exist_ok=True)
    cfgs = _write_cfgs(state_dir, bookkeeper=True)
    comp_cfg, bk_cfg = cfgs["compaction"], cfgs["bookkeeper"]
    tokens_path = os.path.join(state_dir, "tokens.json")
    with open(tokens_path, "w") as f:
        json.dump(TOKENS, f)

    workloads = {
        "compaction": ("compaction", comp_cfg),
        "bookkeeper": ("bookkeeper", bk_cfg),
    }
    config = ServiceConfig(
        state_dir=os.path.join(state_dir, "state"),
        slice_s=slice_s,
        tcp="127.0.0.1:0",
        tokens_path=tokens_path,
        queue_cap=64,
        tenant_max_queued=tenant_max_queued,
        cpu=cpu,
        **geom,
    )
    pool = pool or CheckerPool(config)
    if solos is None:
        log("computing solo baselines (pre-daemon, same checkers)")
        solos = _solo_results(pool, workloads)

    schedule = (
        schedule if schedule is not None else build_schedule(seed)
    )
    log(f"fault schedule: {schedule!r} (seed {seed})")
    prev_fault = os.environ.get("PTT_FAULT")
    os.environ["PTT_FAULT"] = schedule
    faults.reset()
    # the fired specs, read from the fault module (an observer would
    # miss every fire while a job's engine run holds its own)
    fired: List[tuple] = []

    report: dict = {
        "seed": seed,
        "schedule": schedule,
        "admitted": [],
        "rejected": {"auth": 0, "quota": 0, "capacity": 0},
        "completed": 0,
        "faults_fired": fired,
    }
    daemon = None
    try:
        daemon = ServiceDaemon(config, pool=pool, log=log)
        daemon.start()
        addr = f"tcp://127.0.0.1:{daemon.tcp_port}"

        # --- rejection probes (at the door, typed) -----------------
        bad = ServiceClient(
            addr, timeout=timeout_s, token="not-a-real-token",
            retries=2, rng=random.Random(seed ^ 0x5EC),
        )
        try:
            bad.submit("bookkeeper", bk_cfg)
            raise ChaosFailure("bad token was NOT rejected")
        except AuthError:
            report["rejected"]["auth"] += 1

        # quota burst: tenant beta floods past tenant_max_queued — the
        # overflow must reject, not silently queue.  Admission races
        # the scheduler in a live daemon (a claim or completion between
        # two submits frees a queued slot), so the burst keeps
        # submitting until a rejection lands: submits (~ms each once
        # the single-shot faults have fired) outpace job completions (a
        # full slice), so the queue grows past the quota within a
        # bounded number of rounds.
        beta = ServiceClient(
            addr, timeout=timeout_s,
            token="chaos-beta-token-22", retries=6,
            rng=random.Random(seed ^ 0xBE7A),
        )
        beta_admitted: List[str] = []
        max_burst = max(quota_burst, 8 * (tenant_max_queued + 1))
        for k in range(max_burst):
            try:
                # warm=False: a warm-continue instant completion would
                # drain the queue under the burst (the warm phase below
                # is the warm layer's own drill)
                beta_admitted.append(
                    beta.submit(
                        "compaction", comp_cfg,
                        submit_id=f"beta-burst-{k}", warm=False,
                    )
                )
            except AdmissionRejected as e:
                report["rejected"][e.code] = (
                    report["rejected"].get(e.code, 0) + 1
                )
            rejections = (
                report["rejected"]["quota"]
                + report["rejected"]["capacity"]
            )
            if rejections and k + 1 >= quota_burst:
                break
        if (
            report["rejected"]["quota"]
            + report["rejected"]["capacity"]
            == 0
        ):
            raise ChaosFailure(
                f"quota burst of {max_burst} vs quota "
                f"{tenant_max_queued} produced no rejection"
            )
        report["admitted"] += [("compaction", j) for j in beta_admitted]

        # --- concurrent clients through the fault schedule ---------
        errors: List[str] = []
        lock = threading.Lock()

        def client_body(ci: int) -> None:
            cl = ServiceClient(
                addr, timeout=timeout_s,
                token="chaos-alpha-token-1", retries=8,
                rng=random.Random(seed * 1000 + ci),
            )
            names = list(workloads)
            for k in range(jobs_per_client):
                name = names[(ci + k) % len(names)]
                spec, cfg_path = workloads[name]
                try:
                    jid = cl.submit(
                        spec, cfg_path,
                        submit_id=f"c{ci}-j{k}",
                        priority=(ci + k) % 3,
                        warm=False,
                    )
                    # the dedup pin: an immediate retried submit with
                    # the SAME submit_id must return the SAME job
                    again = cl.submit(
                        spec, cfg_path, submit_id=f"c{ci}-j{k}",
                        warm=False,
                    )
                    if again != jid:
                        raise ChaosFailure(
                            f"submit_id c{ci}-j{k} enqueued twice "
                            f"({jid} then {again})"
                        )
                    with lock:
                        report["admitted"].append((name, jid))
                except AdmissionRejected as e:
                    with lock:
                        report["rejected"][e.code] = (
                            report["rejected"].get(e.code, 0) + 1
                        )
                except Exception as e:  # noqa: BLE001 — collected
                    with lock:
                        errors.append(f"client {ci} job {k}: {e!r}")

        threads = [
            threading.Thread(target=client_body, args=(ci,))
            for ci in range(clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
        if errors:
            raise ChaosFailure(f"client errors: {errors}")

        # --- every admitted job completes with solo parity ---------
        waiter = ServiceClient(
            addr, timeout=timeout_s, token="chaos-alpha-token-1",
            retries=8, rng=random.Random(seed ^ 0x3A17),
        )
        for name, jid in report["admitted"]:
            r = waiter.wait(jid, timeout=timeout_s)
            if r.get("state") != "done" or not r.get("result"):
                raise ChaosFailure(
                    f"admitted job {jid} ({name}) ended "
                    f"{r.get('state')}: {r.get('error')}"
                )
            _assert_parity(r["result"], solos[name], f"{name}/{jid}")
            report["completed"] += 1

        # --- warm reuse under corruption ----------------------------
        # a truncated job's resubmit at a widened budget is the warm
        # layer's headline path; with the artifact verification
        # corrupted it must fall back COLD (typed reason, quarantined
        # artifact) and still land the solo-exact result
        operator = ServiceClient(config.socket_path, timeout=timeout_s)
        jt = operator.submit(
            "compaction", comp_cfg, max_states=600,
            submit_id="warm-trunc",
        )
        rt = operator.wait(jt, timeout=timeout_s)
        if (rt.get("result") or {}).get("status") != "truncated":
            raise ChaosFailure(
                f"truncation probe ended {rt.get('result')!r} "
                "(wanted status=truncated)"
            )
        report["completed"] += 1  # completed as designed (truncated)
        wstore = daemon.sched.warm_store
        if wstore is None:
            raise ChaosFailure("daemon has no warm store")
        # arm the NEXT artifact verification to compute a corrupted
        # digest (all other jobs are terminal here, so the next verify
        # IS this resubmit's install); re-arming clears the fault
        # module's record, so take the fires so far first
        fired += faults.fired()
        os.environ["PTT_FAULT"] = (
            os.environ.get("PTT_FAULT", "")
            + f",corrupt@warm:{wstore._verify_n + 1}"
        ).lstrip(",")
        jw = operator.submit(
            "compaction", comp_cfg, submit_id="warm-widened",
        )
        rw = operator.wait(jw, timeout=timeout_s)
        if rw.get("state") != "done" or not rw.get("result"):
            raise ChaosFailure(
                f"widened resubmit ended {rw.get('state')}: "
                f"{rw.get('error')}"
            )
        if rw["result"].get("warm") != "cold" or (
            rw["result"].get("warm_reason") != "digest_mismatch"
        ):
            raise ChaosFailure(
                "corrupted warm artifact was not demoted to a typed "
                f"cold fallback (got warm={rw['result'].get('warm')!r}"
                f" reason={rw['result'].get('warm_reason')!r})"
            )
        _assert_parity(
            rw["result"], solos["compaction"], f"warm-cold/{jw}"
        )
        report["completed"] += 1
        report["admitted"] += [("compaction", jt), ("compaction", jw)]
        qdir = wstore.quarantine_dir
        if not os.path.isdir(qdir) or not os.listdir(qdir):
            raise ChaosFailure(
                "corrupted artifact was not quarantined"
            )
        report["warm_quarantined"] = len(os.listdir(qdir))

        # --- rejections visible in ptt_admission_*, table honest ---
        metrics_text = waiter.metrics()
        for needle in (
            "ptt_admission_admitted_total",
            "ptt_admission_rejected_total",
        ):
            if needle not in metrics_text:
                raise ChaosFailure(f"{needle} missing from metrics")
        # the full table is the OPERATOR's view (unix socket): a TCP
        # tenant's listing is scoped to its own jobs
        table = operator.status()
        if len(table) != len(report["admitted"]):
            raise ChaosFailure(
                f"job table has {len(table)} entries but "
                f"{len(report['admitted'])} submits were admitted — "
                "a rejected submit was silently queued"
            )
        alpha_view = waiter.status()
        if any(j.get("tenant") != "alpha" for j in alpha_view):
            raise ChaosFailure(
                "tenant-scoped listing leaked another tenant's jobs: "
                f"{alpha_view}"
            )
    finally:
        if daemon is not None:
            daemon.shutdown()
        fired += [f for f in faults.fired() if f not in fired]
        if prev_fault is None:
            os.environ.pop("PTT_FAULT", None)
        else:
            os.environ["PTT_FAULT"] = prev_fault
        faults.reset()

    # --- every stream validator-clean ------------------------------
    streams = [config.telemetry_path]
    jobs_dir = config.jobs_dir
    if os.path.isdir(jobs_dir):
        for jid in os.listdir(jobs_dir):
            p = os.path.join(jobs_dir, jid, "events.jsonl")
            if os.path.exists(p):
                streams.append(p)
    stream_errors = _validate_streams(streams)
    if stream_errors:
        raise ChaosFailure(f"stream violations: {stream_errors}")
    report["streams_validated"] = len(streams)
    log(
        f"PASS: {report['completed']} admitted job(s) solo-exact, "
        f"rejected {report['rejected']}, "
        f"{len(fired)} fault(s) fired, "
        f"{len(streams)} stream(s) validator-clean"
    )
    return report


def _backend_configs(state_dir, slice_s, geom, cpu):
    from pulsar_tlaplus_tpu_torch.service.scheduler import ServiceConfig

    return [
        ServiceConfig(
            state_dir=os.path.join(state_dir, f"backend{i}"),
            slice_s=slice_s,
            cpu=cpu,
            **geom,
        )
        for i in range(2)
    ]


def _backend_daemon(configs, i, pool0, log):
    """Backend ``i``: backend 0 on ``pool0``, backend 1 on a pool of
    its own (both slots on the same device when there is one card)."""
    from pulsar_tlaplus_tpu_torch.service.server import ServiceDaemon

    return ServiceDaemon(
        configs[i], pool=pool0 if i == 0 else None,
        log=lambda m: log(f"[backend{i}] {m}"),
    )


def run_fleet_chaos(
    state_dir: str,
    seed: int = 0,
    slice_s: float = 2.0,
    timeout_s: float = 600.0,
    geom: Optional[dict] = None,
    solo=None,
    pool=None,
    log=lambda m: print(f"chaos: {m}", file=sys.stderr, flush=True),
    cpu: bool = False,
) -> dict:
    """The failover drill (``--fleet-v1``): two backends behind a
    dispatcher; a truncated job's warm artifact replicates to the peer;
    the owning backend is killed mid-job; the widened resubmit lands on
    the SURVIVOR, warm-starts from the REPLICATED artifact, and
    finishes state-for-state equal to an uninterrupted solo run.  A job
    queued (not running) on the dead backend is resubmitted by the
    dispatcher itself through ``submit_id`` dedup and must also land
    the solo-exact result; the job RUNNING at the kill is marked
    ``lost`` (never silently resubmitted).  Raises
    :class:`ChaosFailure` on any broken invariant."""
    from pulsar_tlaplus_tpu_torch.fleet.dispatcher import (
        FleetConfig,
        FleetDispatcher,
    )
    from pulsar_tlaplus_tpu_torch.service.client import ServiceError
    from pulsar_tlaplus_tpu_torch.service.scheduler import CheckerPool

    geom = dict(geom or GEOM_FAST)
    os.makedirs(state_dir, exist_ok=True)
    comp_cfg = _write_cfgs(state_dir)["compaction"]

    report: dict = {"seed": seed}
    configs = _backend_configs(state_dir, slice_s, geom, cpu)
    pool0 = pool or CheckerPool(configs[0])
    if solo is None:
        log("computing the solo baseline (pre-fleet, same geometry)")
        solo = _solo_results(
            pool0, {"compaction": ("compaction", comp_cfg)}
        )["compaction"]

    daemons = []
    disp = None
    try:
        for i in range(2):
            daemons.append(_backend_daemon(configs, i, pool0, log))
            daemons[i].start()
        addrs = tuple(c.socket_path for c in configs)
        disp = FleetDispatcher(
            FleetConfig(
                state_dir=os.path.join(state_dir, "dispatch"),
                backends=addrs,
                health_interval_s=0.2,
                fail_after=2,
                backend_timeout_s=5.0,
            ),
            log=lambda m: log(f"[dispatch] {m}"),
        )
        disp.start()
        cl = ServiceClient(
            disp.config.socket_path, timeout=timeout_s, retries=8,
            rng=random.Random(seed ^ 0xF1EE7),
        )

        # --- 1. truncated probe through the dispatcher -------------
        rt_sub = cl.submit(
            "compaction", comp_cfg, max_states=600,
            submit_id="fleet-trunc", full=True,
        )
        owner = rt_sub["backend"]
        survivor = next(a for a in addrs if a != owner)
        jt = rt_sub["job_id"]
        rt = cl.wait(jt, timeout=timeout_s)
        if (rt.get("result") or {}).get("status") != "truncated":
            raise ChaosFailure(
                f"truncation probe ended {rt.get('result')!r} "
                "(wanted status=truncated)"
            )
        report["owner"] = owner
        log(f"truncated probe done on {owner}")

        # --- 2. the artifact replicates to the peer ----------------
        peer_daemon = daemons[addrs.index(survivor)]
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            ws = peer_daemon.sched.warm_store
            if ws is not None and ws.manifests():
                break
            time.sleep(0.2)
        else:
            raise ChaosFailure(
                f"warm artifact never replicated {owner} -> {survivor}"
            )
        repl = disp.metrics_snapshot()
        report["replicated_wire_bytes"] = sum(
            repl["repl_bytes"].values()
        )
        log(
            f"artifact replicated to {survivor} "
            f"({report['replicated_wire_bytes']} wire bytes)"
        )

        # --- 3. pin the owner busy + queue one more behind ---------
        # a long simulation job occupies the owner's only device slot
        # (sticky routing keeps the tenant there), so the next check
        # job is deterministically QUEUED when the kill lands
        js = cl.submit(
            "compaction", comp_cfg, mode="simulate",
            sim=dict(
                n_walkers=64, depth=32, segment_len=8,
                max_steps=1 << 22, seed=seed,
            ),
            warm=False, submit_id="fleet-sim",
        )
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if cl.status(js).get("state") == "running":
                break
            time.sleep(0.1)
        else:
            raise ChaosFailure("sim job never started on the owner")
        jq_sub = cl.submit(
            "compaction", comp_cfg, warm=False,
            submit_id="fleet-queued", full=True,
        )
        jq = jq_sub["job_id"]
        if jq_sub["backend"] != owner:
            raise ChaosFailure(
                f"queued probe routed to {jq_sub['backend']}, not the "
                f"sticky owner {owner} (stickiness broken)"
            )
        if cl.status(jq).get("state") != "queued":
            raise ChaosFailure("queued probe was not queued")

        # --- 4. kill the owner mid-job -----------------------------
        log(f"killing {owner} (sim running, one job queued)")
        daemons[addrs.index(owner)].shutdown()

        # --- 5. the dispatcher drains it and fails over ------------
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            snap = disp.metrics_snapshot()
            if snap["failovers"].get(owner):
                break
            time.sleep(0.2)
        else:
            raise ChaosFailure(f"{owner} was never drained/failed over")
        report["resubmitted"] = int(
            disp.metrics_snapshot()["resubmitted"].get(owner, 0)
        )
        if report["resubmitted"] != 1:
            raise ChaosFailure(
                f"expected exactly the queued job resubmitted, got "
                f"{report['resubmitted']}"
            )

        # --- 6. widened resubmit lands warm on the survivor --------
        rw_sub = cl.submit(
            "compaction", comp_cfg, submit_id="fleet-widened",
            full=True,
        )
        if rw_sub["backend"] != survivor:
            raise ChaosFailure(
                f"widened resubmit routed to {rw_sub['backend']}, "
                f"not the survivor {survivor}"
            )
        rw = cl.wait(rw_sub["job_id"], timeout=timeout_s)
        if rw.get("state") != "done" or not rw.get("result"):
            raise ChaosFailure(
                f"widened resubmit ended {rw.get('state')}: "
                f"{rw.get('error')}"
            )
        if rw["result"].get("warm") not in ("continue", "reseed"):
            raise ChaosFailure(
                "widened resubmit did not warm-start from the "
                "replicated artifact "
                f"(warm={rw['result'].get('warm')!r} "
                f"reason={rw['result'].get('warm_reason')!r})"
            )
        _assert_parity(
            rw["result"], solo, f"fleet-widened/{rw_sub['job_id']}"
        )
        report["warm_mode"] = rw["result"]["warm"]
        log(
            f"widened resubmit warm-started on the survivor "
            f"(warm={report['warm_mode']}) and matched solo exactly"
        )

        # --- 7. the failed-over queued job is solo-exact too -------
        rq = cl.wait(jq, timeout=timeout_s)
        if rq.get("state") != "done" or not rq.get("result"):
            raise ChaosFailure(
                f"failed-over job ended {rq.get('state')}: "
                f"{rq.get('error')}"
            )
        _assert_parity(rq["result"], solo, f"fleet-queued/{jq}")

        # --- 8. the running job is LOST, loudly --------------------
        table = {j["job_id"]: j for j in cl.status()}
        if table.get(js, {}).get("state") != "lost":
            raise ChaosFailure(
                f"the job running at the kill should be 'lost', got "
                f"{table.get(js)!r}"
            )
        try:
            cl.result(js)
            raise ChaosFailure("result on a lost job did not fail")
        except ServiceError as e:
            if "lost" not in str(e):
                raise ChaosFailure(
                    f"lost-job result error is untyped: {e}"
                ) from e

        # --- 9. fleet metrics families present ---------------------
        metrics_text = cl.metrics()
        for needle in (
            "ptt_fleet_backends",
            "ptt_fleet_routes_total",
            "ptt_fleet_replicated_wire_bytes_total",
            "ptt_fleet_failovers_total",
        ):
            if needle not in metrics_text:
                raise ChaosFailure(f"{needle} missing from metrics")
    finally:
        if disp is not None:
            disp.shutdown()
        for d in daemons:
            d.shutdown()

    stream_errors = _validate_streams(
        [disp.config.telemetry_path]
        + [c.telemetry_path for c in configs]
    )
    if stream_errors:
        raise ChaosFailure(f"stream violations: {stream_errors}")
    report["streams_validated"] = 3
    log(
        "PASS: replication + failover + warm resubmit all solo-exact "
        f"({report['replicated_wire_bytes']} wire bytes replicated, "
        f"{report['resubmitted']} job(s) failed over)"
    )
    return report


def build_fleet_schedule(seed: int) -> dict:
    """Seeded fleet-survivability schedule for the v2 drill: the
    per-backend poll indices where the partition window and the flap
    cycle arm (realized by the restarted dispatcher's registry via
    PTT_FAULT ``partition@backend`` / ``flap@backend``), the
    fleet_jobs.json snapshot that hits a synthetic ENOSPC, and the
    server-sent protocol line torn mid-replication.  Same contract as
    :func:`build_schedule`: one seed, one schedule, forever."""
    rng = random.Random(seed)
    return {
        "partition_poll": rng.randint(4, 8),
        "flap_poll": rng.randint(14, 18),
        "enospc_n": rng.randint(1, 3),
        "torn_line": rng.randint(40, 120),
    }


def _global_poll_n(backend_idx: int, per_backend_poll: int,
                   n_backends: int = 2) -> int:
    """The registry's global ``_poll_n`` value for backend
    ``backend_idx``'s ``per_backend_poll``-th poll (backends are
    polled in config order, every backend once per pass) — how a
    seeded per-backend schedule becomes a ``PTT_FAULT`` count."""
    return n_backends * (per_backend_poll - 1) + backend_idx + 1


def _spawn_dispatcher(
    state_dir: str, backends, recover: bool = False,
    fault: Optional[str] = None, log=lambda m: None,
):
    """A REAL ``cli dispatch`` process of the port (the kill -9
    target; it touches no device).  The injected fleet faults ride
    PTT_FAULT in its environment; the ready line on stdout gates return
    (by then ``--recover`` has already rebuilt the job table)."""
    import subprocess

    env = dict(os.environ, OMP_NUM_THREADS="1")
    if fault:
        env["PTT_FAULT"] = fault
    else:
        env.pop("PTT_FAULT", None)
    cmd = [
        sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli", "dispatch",
        state_dir,
    ]
    for a in backends:
        cmd += ["--backend", a]
    cmd += [
        "--health-interval", "0.2", "--fail-after", "2",
        "--backend-timeout", "5.0", "--readmit-after", "2",
        "--hold-s", "15.0",
    ]
    if recover:
        cmd.append("--recover")
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=ROOT, env=env,
    )
    line = proc.stdout.readline()
    if "dispatching on" not in line:
        proc.kill()
        proc.wait()
        proc.stdout.close()
        raise ChaosFailure(
            f"dispatcher never came up (first line {line!r})"
        )
    log(
        f"dispatcher pid {proc.pid} up"
        + (" (recovered)" if recover else "")
        + (f" [PTT_FAULT={fault}]" if fault else "")
    )
    return proc


def _kill9(proc) -> None:
    import signal as signalmod

    proc.send_signal(signalmod.SIGKILL)
    proc.wait(30.0)
    proc.stdout.close()


def run_fleet_chaos_v2(
    state_dir: str,
    seed: int = 0,
    schedule: Optional[dict] = None,
    slice_s: float = 0.5,
    timeout_s: float = 600.0,
    geom: Optional[dict] = None,
    solo=None,
    pool=None,
    clients: int = 2,
    jobs_per_client: int = 1,
    log=lambda m: print(f"chaos: {m}", file=sys.stderr, flush=True),
    cpu: bool = False,
) -> dict:
    """The fleet SURVIVABILITY drill (``--fleet``).

    Two in-process backends; the dispatcher is a real ``cli dispatch``
    subprocess so it can genuinely be killed with -9.  The seeded
    schedule (:func:`build_fleet_schedule`) drives:

    1. **kill -9 + --recover**: concurrent retrying clients submit
       through the dispatcher; once every submit is acked the
       dispatcher is killed -9 and restarted with ``--recover`` (plus
       an injected ``enospc@persist``) — every acked job must appear
       exactly once in the rebuilt table, a retried ``submit_id``
       must dedup to the SAME job across the crash, and every job
       must finish state-for-state solo-exact.
    2. **partition + lost-job reconciliation**: a long sim job plus a
       check job land on one backend; the dispatcher is killed -9
       again and restarted with a partition window armed against that
       backend (and a flap cycle against the other).  The drain types
       the running jobs ``lost``; the rejoin reconciles them —
       ``ptt_fleet_partitions_total`` counts the closed window, at
       least one job carries the ``reconciled`` marker, the check job
       still delivers the backend's real (solo-exact) result, and the
       flapping backend fails over exactly ONCE (hysteresis held).
    3. **torn replication**: a truncated probe replicates with a
       seeded torn server line armed — afterwards every artifact on
       every backend verifies digest-clean and a sweep finds nothing.

    Afterwards: no acked job lost or double-run; the dispatcher's
    appended multi-incarnation stream plus both backend streams
    validate; every acked submit's ``trace_id`` chains from its
    dispatcher ``route`` event into backend ``job_*`` echoes, at least
    one chain closes with a ``complete`` event, and the three streams
    export as one valid Perfetto trace (``fleet_trace.json`` in the
    state dir).  Raises :class:`ChaosFailure` on any broken
    invariant."""
    import signal as signalmod

    from pulsar_tlaplus_tpu_torch.obs import metrics as obs_metrics
    from pulsar_tlaplus_tpu_torch.service.scheduler import CheckerPool
    from pulsar_tlaplus_tpu_torch.utils import faults

    geom = dict(geom or GEOM_FAST)
    sched = dict(schedule or build_fleet_schedule(seed))
    os.makedirs(state_dir, exist_ok=True)
    comp_cfg = _write_cfgs(state_dir)["compaction"]

    report: dict = {"seed": seed, "schedule": sched}
    configs = _backend_configs(state_dir, slice_s, geom, cpu)
    pool0 = pool or CheckerPool(configs[0])
    if solo is None:
        log("computing the solo baseline (pre-fleet, same geometry)")
        solo = _solo_results(
            pool0, {"compaction": ("compaction", comp_cfg)}
        )["compaction"]
    addrs = tuple(c.socket_path for c in configs)
    disp_dir = os.path.join(state_dir, "dispatch")
    disp_sock = os.path.join(disp_dir, "dispatch.sock")
    daemons = []
    proc = None
    prev_fault = os.environ.get("PTT_FAULT")

    def metrics_samples(cl):
        samples, _ = obs_metrics.parse_exposition(cl.metrics())
        return samples

    def counter(samples, family, addr=None):
        out = 0.0
        for labels, value in samples.get(family, []):
            if addr is not None and labels.get("backend") != addr:
                continue
            out += value
        return out

    try:
        for i in range(2):
            daemons.append(_backend_daemon(configs, i, pool0, log))
            daemons[i].start()

        # ---- phase 1: acked submits survive kill -9 + --recover ----
        proc = _spawn_dispatcher(disp_dir, addrs, log=log)
        cl = ServiceClient(
            disp_sock, timeout=timeout_s, retries=8,
            rng=random.Random(seed ^ 0xF1EE7),
        )
        acked: List[tuple] = []  # (submit_id, job_id)
        errors: List[str] = []
        lock = threading.Lock()

        def client_body(ci: int) -> None:
            ccl = ServiceClient(
                disp_sock, timeout=timeout_s, retries=8,
                rng=random.Random(seed * 1000 + ci),
            )
            for k in range(jobs_per_client):
                sid = f"v2-c{ci}-j{k}"
                try:
                    jid = ccl.submit(
                        "compaction", comp_cfg, invariants=[],
                        submit_id=sid, warm=False,
                    )
                    with lock:
                        acked.append((sid, jid))
                except Exception as e:  # noqa: BLE001 — collected
                    with lock:
                        errors.append(f"client {ci} job {k}: {e!r}")

        threads = [
            threading.Thread(target=client_body, args=(ci,))
            for ci in range(clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
        if errors:
            raise ChaosFailure(f"client errors: {errors}")
        log(f"{len(acked)} submit(s) acked; killing the dispatcher -9")
        _kill9(proc)
        proc = None

        proc = _spawn_dispatcher(
            disp_dir, addrs, recover=True,
            fault=f"enospc@persist:{sched['enospc_n']}", log=log,
        )
        table = {j["job_id"]: j for j in cl.status()}
        for sid, jid in acked:
            if jid not in table:
                raise ChaosFailure(
                    f"acked job {jid} ({sid}) missing after "
                    "kill -9 + --recover"
                )
        if len(table) != len(acked):
            raise ChaosFailure(
                f"recovered table has {len(table)} job(s) for "
                f"{len(acked)} acked submit(s) — a job was "
                "double-recorded"
            )
        # exactly-once across the crash: a client retry with the same
        # submit_id must dedup to the SAME job, not enqueue a second
        for sid, jid in acked:
            again = cl.submit(
                "compaction", comp_cfg, invariants=[],
                submit_id=sid, warm=False,
            )
            if again != jid:
                raise ChaosFailure(
                    f"submit_id {sid} resolved to {again} after the "
                    f"crash (acked as {jid}) — dedup broke"
                )
        for sid, jid in acked:
            r = cl.wait(jid, timeout=timeout_s)
            if r.get("state") != "done" or not r.get("result"):
                raise ChaosFailure(
                    f"recovered job {jid} ended {r.get('state')}: "
                    f"{r.get('error')}"
                )
            _assert_parity(r["result"], solo, f"recovered/{jid}")
        # the injected ENOSPC was absorbed by the retry-once path
        pong = cl.ping()
        if pong.get("persist_failures", 0) != 0:
            raise ChaosFailure(
                "the single injected enospc@persist leaked into "
                f"persist_failures={pong.get('persist_failures')} "
                "(the retry-once path should have absorbed it)"
            )
        report["recovered"] = len(acked)
        log(f"phase 1 PASS: {len(acked)} acked job(s) exactly-once")

        # ---- phase 2: partition window + lost-job reconciliation ---
        js_sub = cl.submit(
            "compaction", comp_cfg, mode="simulate",
            sim=dict(
                n_walkers=64, depth=32, segment_len=8,
                max_steps=1 << 22, seed=seed,
            ),
            warm=False, submit_id="v2-sim", full=True,
        )
        js, target = js_sub["job_id"], js_sub["backend"]
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if cl.status(js).get("state") == "running":
                break
            time.sleep(0.1)
        else:
            raise ChaosFailure("sim job never started")
        jl_sub = cl.submit(
            "compaction", comp_cfg, invariants=[], warm=False,
            submit_id="v2-lost", full=True,
        )
        jl = jl_sub["job_id"]
        if jl_sub["backend"] != target:
            raise ChaosFailure(
                f"check job routed to {jl_sub['backend']}, not the "
                f"sticky sim owner {target} (stickiness broken)"
            )
        # both jobs claimed (time-slicing) so the drain types them
        # LOST, not queued-resubmittable
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if cl.status(jl).get("state") in ("running", "suspended"):
                break
            time.sleep(0.1)
        else:
            raise ChaosFailure("check job never claimed a slice")
        log(f"sim + check job running on {target}; killing -9 again")
        _kill9(proc)
        proc = None

        ti = addrs.index(target)
        fault = ",".join([
            # partition the job-holding backend...
            "partition@backend:"
            f"{_global_poll_n(ti, sched['partition_poll'])}",
            # ...and flap the other one (hysteresis must hold it to
            # exactly one failover for the whole die/return cycle)
            "flap@backend:"
            f"{_global_poll_n(1 - ti, sched['flap_poll'])}",
        ])
        proc = _spawn_dispatcher(
            disp_dir, addrs, recover=True, fault=fault, log=log,
        )
        # wait for the partition window to close: the rejoined
        # backend held its jobs, so the partition counter ticks
        other = addrs[1 - ti]
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            samples = metrics_samples(cl)
            if (
                counter(
                    samples, "ptt_fleet_partitions_total", target
                ) >= 1
                and counter(
                    samples, "ptt_fleet_failovers_total", other
                ) >= 1
                and all(
                    s == "up" for s in cl.ping()["backends"].values()
                )
            ):
                break
            time.sleep(0.2)
        else:
            raise ChaosFailure(
                "partition window never closed (no partition count "
                f"for {target} / no flap failover for {other}): "
                f"{metrics_samples(cl)}"
            )
        samples = metrics_samples(cl)
        if counter(samples, "ptt_fleet_reconciled_total", target) < 1:
            raise ChaosFailure(
                f"rejoined backend {target} reconciled no lost jobs"
            )
        if counter(samples, "ptt_fleet_partitions_total", other) != 0:
            raise ChaosFailure(
                f"flapping backend {other} (no jobs held) was "
                "counted as a partition"
            )
        if counter(samples, "ptt_fleet_failovers_total", other) != 1:
            raise ChaosFailure(
                f"flap cycle on {other} caused "
                f"{counter(samples, 'ptt_fleet_failovers_total', other):.0f} "
                "failovers — readmission hysteresis thrashed"
            )
        if counter(samples, "ptt_fleet_recoveries_total") < 1:
            raise ChaosFailure("recover() never counted a recovery")
        # the reconciled lost job delivers the backend's REAL result:
        # same backend run, solo-exact — never a silent re-run
        rl = cl.wait(jl, timeout=timeout_s)
        if rl.get("state") != "done" or not rl.get("result"):
            raise ChaosFailure(
                f"reconciled check job ended {rl.get('state')}: "
                f"{rl.get('error')}"
            )
        _assert_parity(rl["result"], solo, f"reconciled/{jl}")
        listing = {j["job_id"]: j for j in cl.status()}
        reconciled_jobs = [
            jid for jid, j in listing.items() if j.get("reconciled")
        ]
        if not reconciled_jobs:
            raise ChaosFailure(
                "no job carries the reconciled marker after the "
                "partition window closed"
            )
        report["reconciled_jobs"] = len(reconciled_jobs)
        report["partitions"] = int(
            counter(samples, "ptt_fleet_partitions_total", target)
        )
        cl.cancel(js)
        log(
            f"phase 2 PASS: partition on {target} reconciled "
            f"{len(reconciled_jobs)} job(s), flap on {other} held to "
            "one failover"
        )

        # ---- phase 3: torn replication leaves only verified state --
        os.environ["PTT_FAULT"] = f"torn@line:{sched['torn_line']}"
        faults.reset()
        # warm stays ON: the truncated probe must SAVE its artifact,
        # or there is nothing for the torn window to replicate
        jt_sub = cl.submit(
            "compaction", comp_cfg, invariants=[], max_states=600,
            submit_id="v2-trunc", full=True,
        )
        jt = jt_sub["job_id"]
        rt = cl.wait(jt, timeout=timeout_s)
        if (rt.get("result") or {}).get("status") != "truncated":
            raise ChaosFailure(
                f"truncation probe ended {rt.get('result')!r}"
            )
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if counter(
                metrics_samples(cl),
                "ptt_fleet_replicated_wire_bytes_total",
            ) > 0:
                break
            time.sleep(0.2)
        else:
            raise ChaosFailure("replication never shipped bytes")
        report["replicated_wire_bytes"] = int(counter(
            metrics_samples(cl),
            "ptt_fleet_replicated_wire_bytes_total",
        ))
        # every artifact on every backend is digest-verified or gone
        for i, d in enumerate(daemons):
            ws = d.sched.warm_store
            if ws is None:
                continue
            swept = ws.sweep()
            if swept:
                raise ChaosFailure(
                    f"backend{i} store held unverifiable artifacts "
                    f"after the torn-replication window: {swept}"
                )
            for adir, _man in ws.manifests():
                ok, reason = ws.verify(adir)
                if not ok:
                    raise ChaosFailure(
                        f"backend{i} artifact {adir} corrupt after "
                        f"torn replication: {reason}"
                    )
        log(
            "phase 3 PASS: torn-replication window left only "
            f"verified artifacts "
            f"({report['replicated_wire_bytes']} wire bytes)"
        )

        # ---- final: no acked job lost or double-run ----------------
        listing = {j["job_id"]: j for j in cl.status()}
        if any(
            j.get("state") == "lost" for j in listing.values()
        ):
            raise ChaosFailure(
                f"a job is still typed lost at drill end: {listing}"
            )
        want = len(acked) + 3  # + sim + v2-lost + v2-trunc
        if len(listing) != want:
            raise ChaosFailure(
                f"job table has {len(listing)} entries, expected "
                f"{want} — an acked submit was dropped or double-run"
            )
    finally:
        if proc is not None:
            try:
                proc.send_signal(signalmod.SIGTERM)
                proc.wait(30.0)
            except Exception:  # noqa: BLE001 — best-effort teardown
                proc.kill()
                proc.wait()
            proc.stdout.close()
        for d in daemons:
            d.shutdown()
        if prev_fault is None:
            os.environ.pop("PTT_FAULT", None)
        else:
            os.environ["PTT_FAULT"] = prev_fault
        faults.reset()

    # ---- every stream validates (the dispatcher's file holds all
    # three incarnations, appended — distinct run_ids) ---------------
    stream_errors = _validate_streams(
        [os.path.join(disp_dir, "dispatch.jsonl")]
        + [c.telemetry_path for c in configs]
    )
    if stream_errors:
        raise ChaosFailure(f"stream violations: {stream_errors}")
    report["streams_validated"] = 3

    # ---- the surviving streams STITCH: every acked submit's trace_id
    # chains from its dispatcher route event into backend job_*
    # events, and the three streams export as ONE valid Perfetto
    # trace ----------------------------------------------------------
    from pulsar_tlaplus_tpu_torch.obs import report as report_mod
    from pulsar_tlaplus_tpu_torch.obs import trace as trace_mod

    stitched = []
    for lbl, p in [
        ("dispatch", os.path.join(disp_dir, "dispatch.jsonl"))
    ] + [(f"backend{i}", c.telemetry_path)
         for i, c in enumerate(configs)]:
        evs, errs = report_mod.load_events(p)
        if errs:
            raise ChaosFailure(f"{p}: unreadable lines: {errs}")
        stitched.append((lbl, evs))
    chains = trace_mod.trace_chains(stitched)
    routed = [
        e["trace_id"] for e in stitched[0][1]
        if e.get("event") == "route"
        and isinstance(e.get("trace_id"), str)
    ]
    if len(set(routed)) < len(acked):
        raise ChaosFailure(
            f"dispatcher stream routed {len(set(routed))} distinct "
            f"trace_id(s) for {len(acked)} acked submit(s)"
        )
    for tid in routed:
        ch = chains.get(tid)
        if ch is None or ch["routes"] < 1:
            raise ChaosFailure(
                f"trace {tid} routed but absent from trace_chains"
            )
        echoed = [s for s in ch["streams"] if s != "dispatch"]
        if not echoed or ch["job_events"] < 1:
            raise ChaosFailure(
                f"trace {tid} never echoed by a backend — chain "
                f"broken at the dispatcher hop ({ch})"
            )
    if not any(
        ch["complete"] for ch in chains.values()
    ):
        raise ChaosFailure(
            "no trace chain closed with a complete event — the "
            "job sweep never emitted e2e latencies"
        )
    trace_path = os.path.join(state_dir, "fleet_trace.json")
    trace_mod.write_trace(stitched, trace_path)
    trace_errors = trace_mod.validate_trace(trace_path)
    if trace_errors:
        raise ChaosFailure(
            f"stitched Perfetto trace invalid: {trace_errors}"
        )
    report["trace_chains"] = len(chains)
    log(
        f"{len(set(routed))} routed trace chain(s) stitch "
        "dispatcher->backend; Perfetto export valid "
        f"({trace_path})"
    )

    log(
        "PASS: kill -9 recovery exactly-once, partition reconciled, "
        "flap hysteresis held, torn replication verified, "
        f"{report['streams_validated']} stream(s) validator-clean"
    )
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="service-layer chaos drill of the PyTorch port "
        "(seeded, reproducible)"
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--schedule", default=None,
        help="pin the PTT_FAULT schedule (default: derived from "
        "--seed)",
    )
    ap.add_argument(
        "--state-dir", default=None,
        help="drill scratch dir (default: a fresh temp dir)",
    )
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--jobs-per-client", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument(
        "--fleet", action="store_true",
        help="run the fleet SURVIVABILITY drill instead: two backends "
        "behind a real `cli dispatch` subprocess — kill -9 + --recover "
        "exactly-once, a seeded partition window with lost-job "
        "reconciliation, a flap held to one failover by readmission "
        "hysteresis, and torn replication leaving only verified "
        "artifacts",
    )
    ap.add_argument(
        "--fleet-v1", action="store_true",
        help="run the failover drill: warm replication, a mid-job "
        "backend kill, failover resubmit, and a solo-exact warm "
        "restart on the survivor",
    )
    ap.add_argument(
        "--cpu", action="store_true",
        help="put the daemons' slots on the CPU instead of the card",
    )
    args = ap.parse_args(argv)
    from pulsar_tlaplus_tpu_torch.utils.device import resolve

    try:
        resolve("cpu" if args.cpu else None)
    except RuntimeError as e:
        ap.error(f"{e} (this script: --cpu)")
    state_dir = args.state_dir
    if state_dir is None:
        import tempfile

        state_dir = tempfile.mkdtemp(prefix="ptt_chaos_")
    try:
        if args.fleet:
            run_fleet_chaos_v2(
                state_dir,
                seed=args.seed,
                clients=args.clients,
                jobs_per_client=args.jobs_per_client,
                timeout_s=args.timeout,
                cpu=args.cpu,
            )
        elif args.fleet_v1:
            run_fleet_chaos(
                state_dir, seed=args.seed, timeout_s=args.timeout,
                cpu=args.cpu,
            )
        else:
            run_chaos(
                state_dir,
                seed=args.seed,
                schedule=args.schedule,
                clients=args.clients,
                jobs_per_client=args.jobs_per_client,
                timeout_s=args.timeout,
                cpu=args.cpu,
            )
    except ChaosFailure as e:
        print(f"chaos: FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
