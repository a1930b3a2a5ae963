"""The port's checker daemon (``pulsar_tlaplus_tpu_torch/service/``) on
the CPU, against the JAX package (``pulsar_tlaplus_tpu/service/`` and the
JAX engine's solo runs):

- the pure modules (``protocol``, ``auth``, ``admission``, ``jobs``) give
  the JAX modules' answers on the same inputs;
- jobs time-sliced at a zero slice, recovered after a ``stop()``
  mid-job, and recovered from a first-slice frame each give the result
  record of the JAX engine's solo run of the same cfg (counts, level
  sizes, verdict, violation gid, both counterexamples' traces);
- cancel (queued and running), deadlines, priority preemption, a
  ``continue`` resubmit, ``--no-warm``, the warm store's byte cap, and
  the ``torn@warmwrite``, ``corrupt@warm``, ``drop@conn``, ``torn@line``
  and ``enospc@persist`` drills;
- the socket protocol (unix and authenticated TCP), a submit to a warmed
  key that builds nothing, the ``metrics`` scrape's families against the
  JAX ``scheduler_metrics``, and the CLI in subprocesses (``serve -cpu``,
  ``submit``/``status``/``watch``/``cancel``, SIGTERM, ``--recover``).

Tolerance: exact equality."""

import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models import registry as jregistry
from pulsar_tlaplus_tpu.obs import metrics as jmetrics
from pulsar_tlaplus_tpu.service import admission as jadmission
from pulsar_tlaplus_tpu.service import auth as jauth
from pulsar_tlaplus_tpu.service import jobs as jjobs
from pulsar_tlaplus_tpu.service import protocol as jprotocol
from pulsar_tlaplus_tpu.service import scheduler as jscheduler
from pulsar_tlaplus_tpu.utils import cfg as jcfgmod
from pulsar_tlaplus_tpu.utils import faults as jfaults
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.obs import metrics as metrics_mod
from pulsar_tlaplus_tpu_torch.obs import schema
from pulsar_tlaplus_tpu_torch.service import admission, auth, jobs, protocol
from pulsar_tlaplus_tpu_torch.service.client import (
    AdmissionRejected,
    AuthError,
    ServiceClient,
    ServiceError,
    TransportError,
)
from pulsar_tlaplus_tpu_torch.service.scheduler import (
    CheckerPool,
    Scheduler,
    ServiceConfig,
)
from pulsar_tlaplus_tpu_torch.service.server import ServiceDaemon
from pulsar_tlaplus_tpu_torch.utils import faults

# one intra-op thread a process: the suite runs a process a core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "specs", "compaction.cfg")
# the JAX service tests' geometry
GEOM = dict(sub_batch=64, visited_cap=1 << 10, frontier_cap=1 << 8,
            max_states=1 << 20, checkpoint_every=1)
SMALL = """
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
# the small binding with its DuplicateNullKeyMessage counterexample
SMALL_DNK = SMALL + "    DuplicateNullKeyMessage\n"
BK_CRASH2 = """
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
TOKENS = {
    "tokens_v": 1,
    "tenants": [
        {"tenant": "alpha", "token": "test-alpha-token-1"},
        {"tenant": "beta", "token": "test-beta-token-22"},
    ],
}
WAIT = 120.0  # every wait in this file has its own timeout


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    """No stray tuned profile reshapes a run, and no fault is armed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PTT_TUNE_DIR", str(tmp_path_factory.mktemp("profiles")))
        mp.delenv("PTT_TUNE_ADAPT", raising=False)
        mp.delenv("PTT_FAULT", raising=False)
        yield


@pytest.fixture
def fault_env(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("PTT_FAULT", spec)
        faults.reset()
        jfaults.reset()

    yield arm
    monkeypatch.delenv("PTT_FAULT", raising=False)
    faults.reset()


@pytest.fixture(scope="module")
def cfg_dir():
    # unix socket paths are capped at 107 bytes: a short directory
    d = tempfile.mkdtemp(prefix="ptts")
    for name, text in (("small", SMALL), ("dnk", SMALL_DNK),
                       ("bk", BK_CRASH2)):
        with open(os.path.join(d, f"{name}.cfg"), "w") as f:
            f.write(text)
    with open(os.path.join(d, "tokens.json"), "w") as f:
        json.dump(TOKENS, f)
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def sdir():
    d = tempfile.mkdtemp(prefix="ptts")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _config(state_dir, **kw):
    base = dict(GEOM, cpu=True)
    base.update(kw)
    return ServiceConfig(state_dir=os.path.join(state_dir, "s"), **base)


@pytest.fixture(scope="module")
def pool(cfg_dir):
    return CheckerPool(_config(cfg_dir))


@pytest.fixture(scope="module")
def jax_solo(cfg_dir):
    """The JAX engine's solo runs at the daemon's geometry."""
    out = {}
    for name in ("small", "dnk", "bk"):
        spec = "bookkeeper" if name == "bk" else "compaction"
        tlc = jcfgmod.load(os.path.join(cfg_dir, f"{name}.cfg"))
        model, _ = jregistry.COMPILED[spec](tlc)
        out[name] = JChecker(
            model, invariants=tuple(tlc.invariants),
            sub_batch=GEOM["sub_batch"], visited_cap=GEOM["visited_cap"],
            frontier_cap=GEOM["frontier_cap"],
            max_states=GEOM["max_states"]).run()
    assert out["small"].distinct_states == 1654
    assert out["dnk"].violation == "DuplicateNullKeyMessage"
    assert out["bk"].violation == "ConfirmedEntryReadable"
    return out


def assert_matches_solo(job, solo):
    r = job.result
    assert r is not None, (job.state, job.error)
    assert r["distinct_states"] == solo.distinct_states
    assert r["diameter"] == solo.diameter
    assert r["level_sizes"] == [int(x) for x in solo.level_sizes]
    assert r["violation"] == solo.violation
    assert r["violation_gid"] == solo.violation_gid
    assert r["deadlock"] == bool(solo.deadlock)
    if solo.trace is None:
        assert r["trace"] is None
    else:
        assert r["trace"] == [repr(s) for s in solo.trace]
        assert r["trace_actions"] == list(solo.trace_actions)


def _submit_all(sched, cfg_dir):
    return [
        sched.submit("compaction", os.path.join(cfg_dir, "small.cfg")),
        sched.submit("compaction", os.path.join(cfg_dir, "dnk.cfg")),
        sched.submit("bookkeeper", os.path.join(cfg_dir, "bk.cfg")),
    ]


def _trip(sched, at, action):
    """Wrap the scheduler's hooks: at poll ``at`` of each slice,
    ``action(job)`` runs before the hook answers (a deterministic stand-in
    for a signal, a cancel or a submit landing mid-run)."""
    mk = sched._mk_hook

    def mk_hook(job, deadline, resume=False, ck=None):
        hook = mk(job, deadline, resume=resume, ck=ck)
        n = [0]

        def call():
            n[0] += 1
            if n[0] == at:
                action(job)
            return hook()

        return _Hook(call, hook)

    sched._mk_hook = mk_hook


class _Hook:
    """A callable that forwards ``resume_emitted`` of the real hook."""

    def __init__(self, fn, inner):
        self._fn, self._inner = fn, inner

    def __call__(self):
        return self._fn()

    @property
    def resume_emitted(self):
        return self._inner.resume_emitted


# ---- the pure modules ---------------------------------------------------


@pytest.mark.parametrize("addr", [
    "tcp://127.0.0.1:0", "tcp://h:65535", "tcp://:80", "tcp://h:x",
    "tcp://h:70000", "tcp://host",
])
def test_protocol_parse_tcp_equals_jax(addr):
    def ans(mod):
        try:
            return mod.parse_tcp(addr)
        except ValueError as e:
            return str(e)

    assert ans(protocol) == ans(jprotocol)


def test_protocol_frames_equal_jax():
    assert protocol.OPS == jprotocol.OPS
    assert (protocol.MAX_LINE, protocol.PRIORITY_MIN,
            protocol.PRIORITY_MAX) == (jprotocol.MAX_LINE,
                                       jprotocol.PRIORITY_MIN,
                                       jprotocol.PRIORITY_MAX)
    for op in protocol.OPS:
        msg = {"op": op, "job_id": "x", "auth": "t", "n": [1, 2]}
        a, b = io.StringIO(), io.StringIO()
        protocol.send_json(a, msg)
        jprotocol.send_json(b, msg)
        assert a.getvalue() == b.getvalue()
        assert protocol.recv_json(io.StringIO(a.getvalue())) == msg
    for line in ("not json\n", "[1, 2]\n", "\n", "", '{"op": 1}\n'):
        got = []
        for mod in (protocol, jprotocol):
            try:
                got.append(("ok", mod.recv_json(io.StringIO(line))))
            except mod.ProtocolError as e:
                got.append(("err", str(e)[:20]))
        assert got[0] == got[1], line
    assert protocol.error_response("m", "auth") == \
        jprotocol.error_response("m", "auth")


TOKEN_CASES = {
    "good": TOKENS,
    "not-object": [1],
    "no-version": {"tenants": TOKENS["tenants"]},
    "newer": {"tokens_v": 99, "tenants": TOKENS["tenants"]},
    "empty": {"tokens_v": 1, "tenants": []},
    "short-token": {"tokens_v": 1,
                    "tenants": [{"tenant": "a", "token": "short"}]},
    "dup-token": {"tokens_v": 1, "tenants": [
        {"tenant": "a", "token": "same-token-12345"},
        {"tenant": "b", "token": "same-token-12345"}]},
    "dup-tenant": {"tokens_v": 1, "tenants": [
        {"tenant": "a", "token": "token-number-one"},
        {"tenant": "a", "token": "token-number-two"}]},
    "reserved": {"tokens_v": 1, "tenants": [
        {"tenant": "local", "token": "whatever-token-1"}]},
    "bad-name": {"tokens_v": 1, "tenants": [
        {"tenant": "a b", "token": "whatever-token-1"}]},
    "not-entry": {"tokens_v": 1, "tenants": ["x"]},
}


@pytest.mark.parametrize("case", sorted(TOKEN_CASES))
def test_auth_tokens_equal_jax(case, tmp_path):
    obj = TOKEN_CASES[case]
    got = auth.validate_tokens_obj(obj, label=case)
    assert got == jauth.validate_tokens_obj(obj, label=case)
    assert bool(got) == (case != "good")
    path = tmp_path / "t.json"
    path.write_text(json.dumps(obj))
    assert auth.validate_tokens_file(str(path)) == \
        jauth.validate_tokens_file(str(path))
    if case == "good":
        tokens = auth.load_tokens(str(path))
        assert tokens == jauth.load_tokens(str(path))
        for presented in ("test-alpha-token-1", "wrong", None, "é" * 9):
            assert auth.authenticate(tokens, presented) == \
                jauth.authenticate(tokens, presented)
        assert auth.authenticate({}, "test-alpha-token-1") is None
    else:
        with pytest.raises(ValueError):
            auth.load_tokens(str(path))


def test_admission_equals_jax():
    for args in [(None, "check", None, 50), (7, "check", None, 50),
                 (None, "simulate", {"n_walkers": 16, "depth": 4}, 50),
                 (None, "simulate", {"max_steps": 99}, 50),
                 (None, "simulate", None, 50)]:
        assert admission.state_price(*args) == jadmission.state_price(*args)
    ctl = [m.AdmissionControl(queue_cap=4, tenant_max_queued=2,
                              tenant_max_running=1, tenant_max_states=100,
                              default_max_states=30)
           for m in (admission, jadmission)]
    job_sets = [[], [], []]
    for pkg, (mod, jm) in enumerate(((admission, jobs), (jadmission, jjobs))):
        table = []
        answers = []
        for i, (tenant, asking, state) in enumerate([
                ("alpha", 30, "queued"), ("alpha", 30, "queued"),
                ("alpha", 30, "queued"), ("beta", 60, "running"),
                ("beta", 60, "queued"), ("local", 5, "queued"),
                ("gamma", 200, "queued"), ("beta", 1, "queued")]):
            try:
                ctl[pkg].check(tenant, asking, table)
                ctl[pkg].count_admit(tenant)
                answers.append("admit")
                table.append(jm.Job(job_id=str(i), spec="s", cfg_path="c",
                                    dir="d", tenant=tenant, state=state,
                                    max_states=asking))
            except mod.AdmissionError as e:
                answers.append((e.code, e.reason, e.tenant, str(e)))
        ctl[pkg].count_dedup("alpha")
        job_sets[pkg] = answers
    assert job_sets[0] == job_sets[1]
    assert ctl[0].snapshot() == ctl[1].snapshot()


def test_jobs_equal_jax():
    kw = dict(job_id=jobs.new_job_id(), spec="compaction", cfg_path="/c",
              dir="/d", invariants=["I"], max_states=9, tenant="alpha",
              priority=3, submit_id="s", trace_id="t", mode="simulate",
              sim={"depth": 4}, warm_mode="reseed", warm_reason="r",
              warm_widened={"A": [1, 2]}, submitted_unix=5.0)
    assert len(kw["job_id"]) == 20
    a, b = jobs.Job(**kw), jjobs.Job(**kw)
    a.result = b.result = {"status": "ok", "steps": 3, "other": 1}
    assert a.to_dict() == b.to_dict()
    assert a.summary() == b.summary()
    assert jobs.Job.from_dict(b.to_dict()).to_dict() == a.to_dict()
    assert (a.frame_path, a.events_path, a.result_path, a.record_path) == (
        b.frame_path, b.events_path, b.result_path, b.record_path)
    assert jobs.STATES == jjobs.STATES and jobs.TERMINAL == jjobs.TERMINAL
    with pytest.raises(ValueError):
        jobs.Job.from_dict(dict(kw, state="weird"))


# ---- the daemon against solo runs -----------------------------------------


def test_jax_solo_pins(jax_solo):
    """The references: 1,654 states clean; the DuplicateNullKeyMessage
    and ConfirmedEntryReadable counterexamples (9 bookkeeper states)."""
    assert jax_solo["small"].diameter == 16
    assert len(jax_solo["dnk"].trace) == jax_solo["dnk"].diameter
    assert len(jax_solo["bk"].trace) == 9


@pytest.fixture(scope="module")
def two_job_run(pool, cfg_dir):
    """Three jobs queued before the loop starts, time-sliced at a zero
    slice: every boundary after a slice's first suspends the running job
    while another waits."""
    from pulsar_tlaplus_tpu_torch.obs.telemetry import Telemetry

    state = tempfile.mkdtemp(prefix="ptts")
    config = _config(state, slice_s=0.0)
    tel = Telemetry(os.path.join(state, "service.jsonl"))
    sched = Scheduler(config, pool=pool, telemetry=tel)
    js = _submit_all(sched, cfg_dir)
    sched.run_until_idle()
    tel.close()
    yield config, js, tel.path
    shutil.rmtree(state, ignore_errors=True)


def test_time_sliced_jobs_equal_jax_solo(two_job_run, jax_solo):
    config, js, _stream = two_job_run
    for job, name in zip(js, ("small", "dnk", "bk")):
        assert job.state == jobs.DONE
        assert job.suspends >= 1 and job.slices == job.suspends + 1
        assert len(job.run_ids) == job.slices
        assert_matches_solo(job, jax_solo[name])
        assert json.load(open(job.result_path)) == job.result
        assert not os.path.exists(job.frame_path)
    assert js[0].result["status"] == "ok"
    assert js[1].result["status"] == js[2].result["status"] == "violation"
    snap = json.load(open(config.queue_path))
    assert {d["state"] for d in snap["jobs"]} == {jobs.DONE}


def test_streams_validate_and_headers_carry_the_job(two_job_run):
    _config_, js, stream = two_job_run
    for job in js:
        assert schema.validate_stream(job.events_path) == []
        evs = [json.loads(x) for x in open(job.events_path)]
        heads = [e for e in evs if e["event"] == "run_header"]
        assert [h["run_id"] for h in heads] == job.run_ids
        assert sum(1 for h in heads if h["resume"]) == job.suspends
        for h in heads:
            assert (h["tenant"], h["trace_id"]) == ("local", job.trace_id)
            assert h["warm"] is None
    assert schema.validate_stream(stream) == []
    kinds = [json.loads(x)["event"] for x in open(stream)]
    for k in ("job_submit", "job_start", "job_suspend", "job_resume",
              "job_result", "warm", "admission"):
        assert k in kinds


def test_stop_mid_job_then_recover_equals_jax_solo(
        pool, cfg_dir, sdir, jax_solo):
    """``stop()`` (what SIGTERM arms) lands at the third boundary of the
    first job: it suspends with a frame, the queue persists, and a new
    scheduler over the same state dir completes every job as solo."""
    config = _config(sdir, slice_s=30.0)
    sched = Scheduler(config, pool=pool)
    _trip(sched, 3, lambda job: sched._stop.set())
    js = _submit_all(sched, cfg_dir)
    sched.start()
    deadline = time.monotonic() + WAIT
    while js[0].state != jobs.SUSPENDED:
        assert time.monotonic() < deadline, js[0].state
        time.sleep(0.01)
    sched.stop(timeout=WAIT)
    assert js[0].state == jobs.SUSPENDED and os.path.exists(js[0].frame_path)
    assert js[1].state == js[2].state == jobs.QUEUED
    sched2 = Scheduler(config, pool=pool)
    assert sched2.recover() == 3
    sched2.run_until_idle()
    for job, name in zip(js, ("small", "dnk", "bk")):
        rec = sched2.get(job.job_id)
        assert rec.state == jobs.DONE
        assert_matches_solo(rec, jax_solo[name])
    heads = [json.loads(x) for x in open(js[0].events_path)]
    assert any(h.get("event") == "run_header" and h.get("resume")
               for h in heads)


def test_recover_resumes_first_slice_frame(pool, cfg_dir, sdir, jax_solo):
    """A daemon killed in a job's first slice last persisted the job as
    claimed (slices 0, running) while its frame was on disk: recovery
    resumes that frame."""
    config = _config(sdir, slice_s=0.0)
    sched = Scheduler(config, pool=pool)
    j1 = sched.submit("compaction", os.path.join(cfg_dir, "small.cfg"))
    sched.submit("bookkeeper", os.path.join(cfg_dir, "bk.cfg"))
    job = sched._claim()
    assert job is j1
    sched._run_slice(job)
    assert j1.state == jobs.SUSPENDED and os.path.exists(j1.frame_path)
    assert j1.progress["distinct_states"] > 0
    with sched.cv:
        j1.state = jobs.RUNNING
        j1.slices = 0
        sched.fifo.remove(j1.job_id)
        sched._running_id = j1.job_id
    sched.persist()
    sched2 = Scheduler(config, pool=pool)
    assert sched2.recover() == 2
    r1 = sched2.get(j1.job_id)
    assert r1.state == jobs.SUSPENDED
    sched2.run_until_idle()
    assert r1.state == jobs.DONE
    assert_matches_solo(r1, jax_solo["small"])
    # corrupt queue.json: quarantined, rebuilt from the job dirs
    open(config.queue_path, "w").write("{torn")
    sched3 = Scheduler(config, pool=pool)
    assert sched3.recover() == 0
    assert {j["state"] for j in sched3.snapshot()} == {jobs.DONE}
    assert [f for f in os.listdir(config.state_dir)
            if f.startswith("queue.json.corrupt.")]


def test_cancel_deadline_and_priority(pool, cfg_dir, sdir, jax_solo):
    config = _config(sdir, slice_s=30.0)
    sched = Scheduler(config, pool=pool)
    small = os.path.join(cfg_dir, "small.cfg")
    # queued: cancelled at once, idempotently
    jq = sched.submit("bookkeeper", os.path.join(cfg_dir, "bk.cfg"))
    assert sched.cancel(jq.job_id).state == jobs.CANCELLED
    assert sched.cancel(jq.job_id).state == jobs.CANCELLED
    # a deadline passed while queued: expired by the sweep
    jd = sched.submit("compaction", small, deadline_s=1e-3)
    time.sleep(0.01)
    sched.run_until_idle()
    assert jd.result["status"] == "deadline" and jd.slices == 0
    # running: a cancel at the second boundary discards the run
    _trip(sched, 2, lambda job: sched.cancel(job.job_id))
    jr = sched.submit("compaction", small)
    sched.run_until_idle()
    assert jr.state == jobs.CANCELLED and not os.path.exists(jr.frame_path)
    # running past its deadline: the deadline record, progress banked
    sched2 = Scheduler(config, pool=pool)
    _trip(sched2, 3, lambda job: setattr(job, "deadline_unix", 1.0))
    jdr = sched2.submit("compaction", small)
    sched2.run_until_idle()
    assert jdr.result["stop_reason"] == "deadline"
    assert 0 < jdr.result["distinct_states"] < 1654
    # priority: a priority-5 submit at the second boundary preempts the
    # running job at the third, and runs first
    sched3 = Scheduler(config, pool=pool)
    hi = []
    _trip(sched3, 2, lambda job: hi.append(sched3.submit(
        "bookkeeper", os.path.join(cfg_dir, "bk.cfg"), priority=5))
        if not hi else None)
    lo = sched3.submit("compaction", small)
    sched3.run_until_idle()
    assert lo.suspends == 1 and hi[0].suspends == 0
    assert hi[0].finished_unix < lo.finished_unix
    assert_matches_solo(lo, jax_solo["small"])
    assert_matches_solo(hi[0], jax_solo["bk"])
    # bad submits fail eagerly
    with pytest.raises(ValueError, match="not in the compiled registry"):
        sched.submit("no_such_spec", small)
    with pytest.raises(ValueError, match="unknown invariant"):
        sched.submit("compaction", small, invariants=["Nope"])
    with pytest.raises(ValueError, match="service ceiling"):
        sched.submit("compaction", small, max_states=1 << 40)


def test_continue_resubmit_no_warm_and_byte_cap(
        pool, cfg_dir, sdir, jax_solo):
    config = _config(sdir)
    sched = Scheduler(config, pool=pool)
    small = os.path.join(cfg_dir, "small.cfg")
    j1 = sched.submit("compaction", small, max_states=600)
    assert (j1.warm_mode, j1.warm_reason) == ("cold", "no_artifact")
    sched.run_until_idle()
    assert j1.result["status"] == "truncated"
    j2 = sched.submit("compaction", small)
    assert (j2.warm_mode, j2.warm_reason) == ("continue", "sig_match")
    sched.run_until_idle()
    assert j2.result["warm"] == "continue"
    assert_matches_solo(j2, jax_solo["small"])
    heads = [json.loads(x) for x in open(j2.events_path)]
    heads = [h for h in heads if h["event"] == "run_header"]
    assert heads[0]["resume"] is True and heads[0]["warm"] == "continue"
    # --no-warm: planned cold (opt_out), never harvested
    mans = sched.warm_store.manifests()
    j3 = sched.submit("compaction", small, warm=False)
    assert (j3.warm_mode, j3.warm_reason) == ("cold", "opt_out")
    sched.run_until_idle()
    assert_matches_solo(j3, jax_solo["small"])
    assert sched.warm_store.manifests() == mans
    assert sched.warm_counts == {("cold", "no_artifact"): 1,
                                 ("continue", "sig_match"): 1,
                                 ("cold", "opt_out"): 1}
    # the byte cap: a second config's artifact evicts the first
    one = sched.warm_store.total_bytes()
    config2 = _config(sdir + "/cap", warm_max_bytes=int(one * 1.5))
    sched2 = Scheduler(config2, pool=pool)
    a = sched2.submit("compaction", small)
    sched2.run_until_idle()
    first = [d for d, _m in sched2.warm_store.manifests()]
    b = sched2.submit("compaction", os.path.join(cfg_dir, "small.cfg"),
                      invariants=["DuplicateNullKeyMessage"])
    sched2.run_until_idle()
    assert a.result["status"] == "ok" and b.result["status"] == "violation"
    # a violation is never harvested: the first artifact stays
    assert [d for d, _m in sched2.warm_store.manifests()] == first
    c = sched2.submit("subscription", os.path.join(ROOT, "specs",
                                                    "subscription.cfg"))
    sched2.run_until_idle()
    left = [m["spec"] for _d, m in sched2.warm_store.manifests()]
    assert c.result["status"] == "ok" and left == ["subscription"]


def test_warm_drills_torn_write_and_corrupt(
        pool, cfg_dir, sdir, jax_solo, fault_env):
    config = _config(sdir)
    small = os.path.join(cfg_dir, "small.cfg")
    fault_env("torn@warmwrite:1")
    sched = Scheduler(config, pool=pool)
    j1 = sched.submit("compaction", small, max_states=600)
    sched.run_until_idle()
    assert j1.result["status"] == "truncated"  # the result is unaffected
    # the next start's sweep quarantines the torn artifact; nothing plans
    # a reuse from it
    sched = Scheduler(config, pool=pool)
    assert len(os.listdir(sched.warm_store.quarantine_dir)) == 1
    j2 = sched.submit("compaction", small)
    assert (j2.warm_mode, j2.warm_reason) == ("cold", "no_artifact")
    sched.run_until_idle()
    assert_matches_solo(j2, jax_solo["small"])
    # corrupt@warm: the install-time verification of j2's final frame
    # fails; the job runs cold with the typed reason
    fault_env(f"corrupt@warm:{sched.warm_store._verify_n + 1}")
    j3 = sched.submit("compaction", small)
    assert j3.warm_mode == "continue"
    sched.run_until_idle()
    assert (j3.warm_mode, j3.warm_reason) == ("cold", "digest_mismatch")
    assert j3.result["warm"] == "cold"
    assert_matches_solo(j3, jax_solo["small"])
    assert len(os.listdir(sched.warm_store.quarantine_dir)) == 2


def test_warm_submit_builds_nothing(cfg_dir, sdir):
    config = _config(sdir, specs=("bookkeeper",))
    own = CheckerPool(config)
    bk = os.path.join(ROOT, "specs", "bookkeeper.cfg")
    key, _s = own.warm("bookkeeper", bk)
    assert own.warmed() == [key]
    ck = own._checkers[key]
    assert own.warm("bookkeeper", bk) == (key, 0.0)
    sched = Scheduler(config, pool=own)
    job = sched.submit("bookkeeper", bk)
    sched.run_until_idle()
    assert job.result["distinct_states"] == 297
    assert list(own._checkers.values()) == [ck] and not own._sims


def test_persist_enospc_and_connection_drills(
        pool, cfg_dir, sdir, fault_env):
    config = _config(sdir)
    small = os.path.join(cfg_dir, "small.cfg")
    fault_env("enospc@persist:1")
    sched = Scheduler(config, pool=pool)
    job = sched.submit("compaction", small)
    sched.run_until_idle()
    assert job.result["distinct_states"] == 1654
    assert sched.persist_failures == 0
    assert {d["state"] for d in json.load(
        open(config.queue_path))["jobs"]} == {jobs.DONE}
    assert not [f for f in os.listdir(config.state_dir) if ".tmp." in f]
    # drop@conn: the submit is processed, its reply dropped; the retry
    # with the same submit_id returns the same job
    fault_env("drop@conn:1")
    config2 = _config(sdir + "/d")
    daemon = ServiceDaemon(config2, pool=pool)
    daemon.start()
    try:
        cl = ServiceClient(config2.socket_path, timeout=WAIT, retries=5)
        jid = cl.submit("compaction", small, submit_id="pinned")
        assert cl.submit("compaction", small, submit_id="pinned") == jid
        assert len(cl.status()) == 1
        assert cl.wait(jid, timeout=WAIT)["result"]["distinct_states"] \
            == 1654
        snap = daemon.sched.admission.snapshot()
        assert snap["admitted"] == {"local": 1}
        assert snap["deduped"]["local"] >= 2
        # torn@line: a torn reply is retried; past the budget, exit 2's
        # TransportError (never a verdict)
        n = daemon._line_n
        fault_env(f"torn@line:{n + 1}")
        assert ServiceClient(config2.socket_path, retries=5).ping()["ok"]
        assert daemon._line_n == n + 2  # the torn line, then the retry
        n = daemon._line_n
        fault_env(",".join(f"torn@line:{n + i}" for i in range(1, 9)))
        with pytest.raises(TransportError):
            ServiceClient(config2.socket_path, retries=2).ping()
    finally:
        daemon.shutdown()


# ---- the socket protocol ---------------------------------------------------


def test_daemon_protocol_roundtrip(pool, cfg_dir, sdir, jax_solo):
    config = _config(sdir, slice_s=0.0)
    daemon = ServiceDaemon(config, pool=pool)
    daemon.start()
    try:
        cl = ServiceClient(config.socket_path, timeout=WAIT)
        pong = cl.ping()
        assert pong["pid"] == os.getpid() and pong["jobs"] == {}
        with pytest.raises(ServiceError, match="not in the compiled"):
            cl.submit("no_such_spec", SHIPPED)
        with pytest.raises(ServiceError, match="unknown job"):
            cl.status("nope")
        jid1 = cl.submit("compaction", os.path.join(cfg_dir, "small.cfg"))
        jid2 = cl.submit("bookkeeper", os.path.join(cfg_dir, "bk.cfg"))
        seen, done = [], None
        for msg in cl.watch(jid2, timeout_s=WAIT):
            if "event" in msg:
                seen.append(msg["event"])
            elif "done" in msg:
                done = msg["done"]
        assert done["state"] == jobs.DONE
        assert done["result"]["violation_gid"] == jax_solo["bk"].violation_gid
        assert {e["run_id"] for e in seen} == set(done["run_ids"])
        r1 = cl.wait(jid1, timeout=WAIT)
        assert r1["result"]["distinct_states"] == 1654
        assert {j["job_id"] for j in cl.status()} == {jid1, jid2}
        assert cl.status(jid1)["distinct_states"] == 1654
        assert cl.cancel(jid1) == jobs.DONE
        text = cl.metrics()
        assert 'ptt_jobs{state="done"} 2' in text
        assert metrics_mod.validate_exposition(text) == []
        # the fleet's replication ops answer the unix socket: the list,
        # and a typed bad_request for a malformed offer, pull or push
        resp = protocol.request(config.socket_path, "warm_list")
        assert resp["ok"] and isinstance(resp["artifacts"], list)
        for op, kw in (("warm_offer", {}),
                       ("warm_offer", {"manifest": {"files": {}}}),
                       ("warm_pull", {"config_sig": "nope", "rel": "x"}),
                       ("warm_push", {"manifest": "x", "blobs": {}})):
            resp = protocol.request(config.socket_path, op, **kw)
            assert not resp["ok"] and resp["code"] == "bad_request", (op, resp)
        resp = protocol.request(config.socket_path, "frobnicate")
        assert not resp["ok"] and "unknown op" in resp["error"]
        with protocol.connect(config.socket_path) as s:
            s.sendall(b"this is not json\n")
            assert json.loads(s.makefile("r").readline())["code"] == \
                "protocol"
        assert cl.shutdown()["stopping"] is True
    finally:
        daemon.shutdown()
    assert not os.path.exists(config.socket_path)
    evs = [json.loads(x) for x in open(config.telemetry_path)]
    assert [e["action"] for e in evs if e["event"] == "serve"] == [
        "start", "stop"]
    assert schema.validate_stream(config.telemetry_path) == []


def test_tcp_auth_quota_and_cli_exit_codes(pool, cfg_dir, sdir):
    tokens = os.path.join(cfg_dir, "tokens.json")
    with pytest.raises(ValueError, match="requires --tokens"):
        ServiceDaemon(_config(sdir + "/x", tcp="127.0.0.1:0"), pool=pool)
    config = _config(sdir, tcp="127.0.0.1:0", tokens_path=tokens,
                     tenant_max_queued=1)
    daemon = ServiceDaemon(config, pool=pool)
    daemon.start()
    daemon.sched._stop.set()  # nothing is claimed: the quota holds still
    small = os.path.join(cfg_dir, "small.cfg")
    try:
        addr = f"tcp://127.0.0.1:{daemon.tcp_port}"
        with pytest.raises(AuthError):
            ServiceClient(addr, token="wrong-token").ping()
        cl = ServiceClient(addr, token="test-beta-token-22")
        jid = cl.submit("compaction", small)
        job = daemon.sched.get(jid)
        assert job.tenant == "beta"
        with pytest.raises(AdmissionRejected):
            cl.submit("compaction", small)
        for argv, code in (
                (["submit", "compaction", small, "--socket", addr,
                  "--token", "wrong-token"], 4),
                (["submit", "compaction", small, "--socket", addr,
                  "--token", "test-beta-token-22"], 5),
                (["status", "--socket", addr, "--token", "wrong"], 4),
                (["status", "--socket", sdir + "/none.sock"], 2)):
            with pytest.raises(SystemExit) as ei:
                cli.main(argv)
            assert ei.value.code == code, argv
        # the replication ops are the fleet's: a tenant token other than
        # the fleet tenant's is refused
        for op in ("warm_list", "warm_offer", "warm_pull", "warm_push"):
            resp = protocol.request(addr, op, auth="test-beta-token-22")
            assert not resp["ok"] and resp["code"] == "auth", (op, resp)
        # the listing is tenant-scoped over TCP
        assert ServiceClient(addr, token="test-alpha-token-1").status() == []
        assert [j["job_id"] for j in cl.status()] == [jid]
    finally:
        daemon.shutdown()
    auth_evs = [json.loads(x) for x in open(config.telemetry_path)]
    assert {e.get("action") for e in auth_evs if e["event"] == "auth"} == {
        "reject", "accept"}


def test_metrics_families_equal_jax(two_job_run, pool, cfg_dir, sdir):
    config, _js, _stream = two_job_run
    sched = Scheduler(_config(sdir), pool=pool)
    jconf = jscheduler.ServiceConfig(state_dir=os.path.join(sdir, "j"))
    jsched = jscheduler.Scheduler(jconf)

    def names(fams):
        return [f.name for f in fams]

    assert names(metrics_mod.scheduler_metrics(sched)) == names(
        jmetrics.scheduler_metrics(jsched))
    sched.submit("compaction", os.path.join(cfg_dir, "small.cfg"))
    sched.run_until_idle()
    for s in (sched, jsched):
        s.warm_counts.update({("cold", "no_artifact"): 1})
        s.admission.count_admit("local")
    jsched.last_engine = dict(sched.last_engine)
    got = metrics_mod.scheduler_metrics(sched, uptime_s=1.0, warmed=["a"])
    want = jmetrics.scheduler_metrics(jsched, uptime_s=1.0, warmed=["a"])
    assert names(got) == names(want)
    assert [f.kind for f in got] == [f.kind for f in want]


# ---- the CLI in subprocesses ----------------------------------------------


def _spawn(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _ready(proc):
    line = proc.stdout.readline()
    assert line.startswith("serving on"), (line, proc.stderr.read())


def _client(args, env, rc):
    p = subprocess.run(
        [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=WAIT)
    assert p.returncode == rc, (args, p.stdout, p.stderr)
    return p.stdout


def test_cli_serve_submit_status_watch_cancel(cfg_dir, sdir):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "PTT_TUNE_DIR": os.path.join(sdir, "profiles")}
    env.pop("PTT_FAULT", None)
    state = os.path.join(sdir, "s")
    d = ["--state-dir", state]
    srv = _spawn(["serve", "-cpu", "--state-dir", state, "--slice", "0",
                  "-chunk", "256", "--spec", "compaction"], env)
    try:
        _ready(srv)
        out = _client(["submit", "compaction", SHIPPED, "--wait", *d], env, 0)
        assert "45198 distinct states found, search depth (diameter) 20." \
            in out
        jid = out.splitlines()[0]
        out = _client(["submit", "bookkeeper", os.path.join(cfg_dir, "bk.cfg"),
                       "--wait", *d], env, 1)
        assert "ConfirmedEntryReadable" in out
        assert jid in _client(["status", *d], env, 0)
        assert "level" in _client(["watch", jid, *d], env, 0)
        # cancel a job that waits behind a running one
        big = _client(["submit", "compaction", SHIPPED, *d], env, 0)
        big = big.splitlines()[0]
        queued = _client(["submit", "bookkeeper", os.path.join(
            ROOT, "specs", "bookkeeper.cfg"), *d], env, 0).splitlines()[0]
        assert _client(["cancel", queued, *d], env, 0).strip() in (
            f"{queued}: cancelled", f"{queued}: running",
            f"{queued}: done")
        assert "daemon_up 1" in _client(["metrics", *d], env, 0)
        assert "compaction" in _client(["top", "--once", *d], env, 0)
        # --aggregate against a daemon (not a dispatcher): the daemon's
        # own families, as the JAX CLI answers
        assert "daemon_up 1" in _client(["metrics", "--aggregate", *d],
                                        env, 0)
        # SIGTERM while the big job runs: the queue persists, exit 0
        srv.send_signal(signal.SIGTERM)
        assert srv.wait(timeout=WAIT) == 0
        snap = json.load(open(os.path.join(state, "queue.json")))
        assert {j["job_id"]: j["state"] for j in snap["jobs"]}[queued] in (
            "cancelled", "done")
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait(timeout=WAIT)
    rec = _spawn(["serve", "-cpu", state, "--recover",
                  "--drain", "-chunk", "256", "--no-prewarm"], env)
    try:
        _ready(rec)
        assert rec.wait(timeout=WAIT) == 0
    finally:
        if rec.poll() is None:
            rec.kill()
            rec.wait(timeout=WAIT)
    snap = json.load(open(os.path.join(state, "queue.json")))
    states = {j["job_id"]: j for j in snap["jobs"]}
    assert states[big]["state"] == "done"
    assert states[big]["result"]["distinct_states"] == 45198
    assert schema.validate_stream(os.path.join(state, "service.jsonl")) == []
