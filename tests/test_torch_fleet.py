"""The port's fleet tier (``pulsar_tlaplus_tpu_torch/fleet/``) on the CPU,
against the JAX package (``pulsar_tlaplus_tpu/fleet/`` and the JAX
engine's solo runs):

- the blob codec gives the JAX codec's base64 text and byte counts;
- the JAX ``replicate_all`` and the port's, run against the same port
  daemons, give equal pass records (``ok``, then ``identical`` at 0
  bytes), ``unreachable`` for a blob past ``MAX_LINE`` with the peer's
  store untouched, a torn push that never installs, and a pull that
  fails its digest twice quarantined;
- the registries give the same routing decisions, drains and
  readmissions on one seeded script of poll outcomes, tenants and
  ``partition``/``slow``/``flap`` faults;
- ``fleet_metrics`` and ``render_fleet_frame`` render the JAX text;
- a two-backend CPU fleet: routing, replication with a warm continue on
  the peer, the failover drill (queued job resubmitted, running job
  ``lost``, reconciled on rejoin, a watch relayed across the failover),
  ``--recover`` after a torn ``fleet_jobs.json`` and while a failed-over
  job runs on its new backend, hold-then-shed with
  every backend down, each result equal to the JAX solo run's;
- the CLI in subprocesses (``serve -cpu`` x 2 and ``dispatch``): the
  ready line, ``submit``/``status``/``metrics --aggregate``/``top
  --dispatch`` through the dispatcher, and the JAX CLI's client commands
  against the same dispatcher with the same exit codes and families.

Tolerance: exact equality."""

import base64
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.fleet import registry as jregistry
from pulsar_tlaplus_tpu.fleet import replicate as jreplicate
from pulsar_tlaplus_tpu.models import registry as jmodels
from pulsar_tlaplus_tpu.obs import metrics as jmetrics
from pulsar_tlaplus_tpu.obs import top as jtop
from pulsar_tlaplus_tpu.service import protocol as jprotocol
from pulsar_tlaplus_tpu.utils import cfg as jcfgmod
from pulsar_tlaplus_tpu.utils import faults as jfaults
from pulsar_tlaplus_tpu.warm import store as jwarmstore
from pulsar_tlaplus_tpu_torch.fleet import registry, replicate
from pulsar_tlaplus_tpu_torch.fleet.dispatcher import (
    FleetConfig,
    FleetDispatcher,
)
from pulsar_tlaplus_tpu_torch.obs import metrics as metrics_mod
from pulsar_tlaplus_tpu_torch.obs import schema
from pulsar_tlaplus_tpu_torch.obs import top as top_mod
from pulsar_tlaplus_tpu_torch.service import jobs, protocol
from pulsar_tlaplus_tpu_torch.service.client import (
    AdmissionRejected,
    BackendUnavailable,
    ServiceClient,
    ServiceError,
)
from pulsar_tlaplus_tpu_torch.service.scheduler import (
    CheckerPool,
    ServiceConfig,
)
from pulsar_tlaplus_tpu_torch.service.server import ServiceDaemon
from pulsar_tlaplus_tpu_torch.utils import faults

# one intra-op thread a process: the suite runs a process a core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the daemon tests' geometry (tests/test_torch_service.py)
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
        {"tenant": "alpha", "token": "fleet-alpha-token-1"},
        {"tenant": "beta", "token": "fleet-beta-token-22"},
        {"tenant": "fleet", "token": "fleet-own-token-333"},
    ],
}
WAIT = 120.0  # every wait in this file has its own limit
PROBE_CAP = 600  # the truncated probe's budget (an artifact to replicate)


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    """No stray tuned profile reshapes a run, and no fault is armed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PTT_TUNE_DIR", str(tmp_path_factory.mktemp("profiles")))
        mp.delenv("PTT_TUNE_ADAPT", raising=False)
        mp.delenv("PTT_FAULT", raising=False)
        faults.reset()
        jfaults.reset()
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
    jfaults.reset()


@pytest.fixture(scope="module")
def cfg_dir():
    # unix socket paths are capped at 107 bytes: a short directory
    d = tempfile.mkdtemp(prefix="pttf")
    for name, text in (("small", SMALL), ("bk", BK_CRASH2)):
        with open(os.path.join(d, f"{name}.cfg"), "w") as f:
            f.write(text)
    with open(os.path.join(d, "tokens.json"), "w") as f:
        json.dump(TOKENS, f)
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def sdir():
    d = tempfile.mkdtemp(prefix="pttf")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _config(state_dir, **kw):
    base = dict(GEOM, cpu=True)
    base.update(kw)
    return ServiceConfig(state_dir=state_dir, **base)


@pytest.fixture(scope="module")
def jax_solo(cfg_dir):
    """The JAX engine's solo runs at the daemons' geometry."""
    out = {}
    for name, spec in (("small", "compaction"), ("bk", "bookkeeper")):
        tlc = jcfgmod.load(os.path.join(cfg_dir, f"{name}.cfg"))
        model, _ = jmodels.COMPILED[spec](tlc)
        out[name] = JChecker(
            model, invariants=tuple(tlc.invariants),
            sub_batch=GEOM["sub_batch"], visited_cap=GEOM["visited_cap"],
            frontier_cap=GEOM["frontier_cap"],
            max_states=GEOM["max_states"]).run()
    assert out["small"].distinct_states == 1654
    assert out["bk"].violation == "ConfirmedEntryReadable"
    return out


def assert_matches_solo(result, solo):
    assert result is not None
    assert result["distinct_states"] == solo.distinct_states
    assert result["diameter"] == solo.diameter
    assert result["level_sizes"] == [int(x) for x in solo.level_sizes]
    assert result["violation"] == solo.violation
    assert result["violation_gid"] == solo.violation_gid


def _until(pred, what, timeout=WAIT):
    """Poll ``pred`` until it returns a truthy value (returned) or the
    deadline passes (AssertionError naming ``what``)."""
    end = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.05)


# ---- the blob codec ------------------------------------------------------


def _blob(kind):
    rng = np.random.default_rng(7)
    if kind == "structured":
        # a sorted key plane with small gaps: what delta+zlib is for
        return np.cumsum(rng.integers(0, 9, 1 << 18, dtype=np.uint32),
                         dtype=np.uint32).tobytes()
    if kind == "random":
        return rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    return rng.integers(0, 256, kind, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("kind", [0, 1, 3, 4, 4097, "random", "structured"])
def test_blob_codec_equals_jax(kind):
    data = _blob(kind)
    got = replicate.encode_blob(data)
    assert got == jreplicate.encode_blob(data)
    b64, raw, wire = got
    assert raw == len(data) and wire == len(base64.b64decode(b64))
    assert replicate.decode_blob(b64, raw) == data
    assert jreplicate.decode_blob(b64, raw) == data


# ---- the registries ------------------------------------------------------


def _script(seed, addrs, steps):
    """A seeded script: each step, each backend's poll outcome (None = a
    failed poll, else (pid, queue_depth, running, sheds, warmed)) and
    the tenants that submit after the pass."""
    rng = random.Random(seed)
    out = []
    for _ in range(steps):
        polls = {}
        for i, a in enumerate(addrs):
            if rng.random() < 0.3:
                polls[a] = None
            else:
                polls[a] = (100 + i, rng.randint(0, 4), rng.randint(0, 1),
                            float(rng.choice([0, 0, 0, 1, 3])),
                            rng.randint(0, 2))
        tenants = [rng.choice(["alpha", "beta", "gamma", "local"])
                   for _ in range(rng.randint(0, 3))]
        out.append((polls, tenants))
    return out


def _run_registry(mod, addrs, script, clock):
    reg = mod.BackendRegistry(list(addrs), fail_after=2, timeout=0.0,
                              sticky_s=50.0, sticky_slack=2.0,
                              readmit_after=2)
    step = {}

    def poll(b):
        o = step["polls"][b.addr]
        if o is None:
            raise OSError(f"{b.addr} refused")
        b.pid, b.queue_depth, b.running, b.sheds, warmed = o
        b.warmed = warmed

    reg._poll_backend = poll
    trail = []
    for i, (polls, tenants) in enumerate(script):
        clock[0] = 1_000.0 + 7.0 * i
        step["polls"] = polls
        down, up = reg.poll_once()
        trail.append(("pass", [b.addr for b in down],
                      [b.addr for b in up]))
        for t in tenants:
            b, why = reg.choose(t)
            trail.append(("route", t, b.addr if b else None, why))
        trail.append(("detail", reg.detail_snapshot()))
    trail.append(("sticky", reg.sticky_snapshot()))
    return trail


def test_registry_routing_equals_jax(monkeypatch, fault_env):
    clock = [0.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    addrs = ["/b/zero.sock", "/b/one.sock", "tcp://127.0.0.1:9"]
    script = _script(11, addrs, 60)
    # the fleet's network faults, realized by both registries
    fault_env("partition@backend:4,flap@backend:50,slow@conn:90")
    got = _run_registry(registry, addrs, script, clock)
    fault_env("partition@backend:4,flap@backend:50,slow@conn:90")
    want = _run_registry(jregistry, addrs, script, clock)
    assert got == want
    reasons = {e[3] for e in got if e[0] == "route"}
    assert reasons == {"sticky", "least_loaded", "only_backend",
                       "no_backend"}
    assert any(e[1] for e in got if e[0] == "pass")  # drains
    assert any(e[2] for e in got if e[0] == "pass")  # readmissions


def test_registry_rejects_an_empty_fleet():
    with pytest.raises(ValueError, match="at least one backend"):
        registry.BackendRegistry([])


# ---- fleet_metrics and the fleet flight deck -----------------------------


class _Snap:
    def __init__(self, hists):
        self.hists = hists

    def metrics_snapshot(self):
        return {
            "backends": {"/b/0.sock": "up", "/b/1.sock": "down"},
            "routes": {("/b/0.sock", "least_loaded"): 3.0,
                       ("/b/1.sock", "sticky"): 1.0},
            "route_s": 0.0125,
            "repl_blobs": {"/b/1.sock": 2.0},
            "repl_bytes": {"/b/1.sock": 40_961.0},
            "failovers": {"/b/1.sock": 1.0},
            "resubmitted": {"/b/1.sock": 1.0},
            "reconciled": {"/b/1.sock": 1.0},
            "partitions": {"/b/1.sock": 1.0},
            "recoveries": 1.0,
            "persist_failures": 0.0,
            "held_sheds": 2.0,
            "holds": 3.0,
            "hists": self.hists,
            "failover_s": 0.5, "failover_n": 1,
            "reconcile_s": 0.25, "reconcile_n": 1,
        }


def _hists(mod):
    hists = mod.new_fleet_hists()
    rng = random.Random(3)
    for name in sorted(hists):
        for _ in range(17):
            hists[name].observe(round(rng.expovariate(40.0), 6))
    return hists


def test_fleet_metrics_equal_jax():
    got = metrics_mod.render_exposition(metrics_mod.fleet_metrics(
        _Snap(_hists(metrics_mod)), uptime_s=12.5))
    want = jmetrics.render_exposition(jmetrics.fleet_metrics(
        _Snap(_hists(jmetrics)), uptime_s=12.5))
    assert got == want
    assert metrics_mod.validate_exposition(got) == []
    fams, types = metrics_mod.parse_exposition(got)
    assert top_mod.hist_quantiles(fams, types) == jtop.hist_quantiles(
        *jmetrics.parse_exposition(want))
    assert len([t for t in types.values() if t == "histogram"]) == 6


def _fleet_model(mod, fams, types):
    m = mod.FleetTopModel("/tmp/d/dispatch.sock")
    m.daemon = {"pid": 4242, "uptime_s": 93.4, "warmed": []}
    m.backends = {
        "/tmp/b0/serve.sock": {"state": "up", "score": 2.0,
                               "queue_depth": 1, "running": 1,
                               "inflight": 0, "sheds": 0.0, "warmed": 4,
                               "sticky_tenants": 2},
        "tcp://10.0.0.2:7000": {"state": "down", "score": 1000.0,
                                "queue_depth": 0, "running": 0,
                                "inflight": 0, "sheds": 1234.0,
                                "warmed": 0, "sticky_tenants": 0},
    }
    m.job_counts = {"done": 3, "lost": 1, "running": 1}
    m.held, m.persist_failures = 1, 0
    m.quantiles = mod.hist_quantiles(fams, types)
    for v in (0.0, 1.5, 3.0, 0.25):
        m.note_rate("routes", v)
        m.note_rate("completes", v / 2)
    return m


def test_render_fleet_frame_equals_jax():
    text = metrics_mod.render_exposition(metrics_mod.fleet_metrics(
        _Snap(_hists(metrics_mod)), uptime_s=1.0))
    fams, types = metrics_mod.parse_exposition(text)
    now = 1_700_000_000.0
    got = top_mod.render_fleet_frame(_fleet_model(top_mod, fams, types),
                                     now=now)
    want = jtop.render_fleet_frame(_fleet_model(jtop, fams, types),
                                   now=now)
    assert got == want
    assert "BACKEND" in got and "LATENCY" in got
    for v in (None, 0.0123, 4.5):
        assert top_mod._fmt_lat(v) == jtop._fmt_lat(v)


# ---- replication: the JAX sieve and the port's against port daemons ------


@pytest.fixture(scope="module")
def repl(cfg_dir):
    """An owner daemon holding the truncated probe's artifact, and a
    factory of empty peer daemons (one shared CPU pool: only the owner
    runs a job)."""
    root = tempfile.mkdtemp(prefix="pttr")
    pool = CheckerPool(_config(os.path.join(root, "pool")))
    daemons = []

    def peer(name):
        d = ServiceDaemon(_config(os.path.join(root, name)), pool=pool)
        d.start()
        daemons.append(d)
        return d

    owner = peer("own")
    cl = ServiceClient(owner.config.socket_path, timeout=WAIT)
    jid = cl.submit("compaction", os.path.join(cfg_dir, "small.cfg"),
                    max_states=PROBE_CAP)
    assert cl.wait(jid, timeout=WAIT)["result"]["status"] == "truncated"
    (adir, man), = owner.sched.warm_store.manifests()
    try:
        yield dict(owner=owner, peer=peer, man=man, adir=adir)
    finally:
        for d in daemons:
            d.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def _rec(r):
    return (r["status"], r["blobs"], r["wire_bytes"], r.get("config_sig"))


def test_replicate_all_equals_jax(repl):
    src = repl["owner"].config.socket_path
    bp, bj = repl["peer"]("p1"), repl["peer"]("p2")
    seen = []
    got = replicate.replicate_all(src, [bp.config.socket_path, src],
                                  on_pass=seen.append)
    want = jreplicate.replicate_all(src, [bj.config.socket_path])
    assert [_rec(r) for r in got] == [_rec(r) for r in want]
    assert seen == got
    status, blobs, wire, sig = _rec(got[0])
    assert (status, sig) == ("ok", repl["man"]["config_sig"])
    assert blobs == len(repl["man"]["files"]) and wire > 0
    # the peers now hold the owner's manifest verbatim, digest-clean
    for d in (bp, bj):
        (_a, m), = d.sched.warm_store.manifests()
        assert m == repl["man"]
    # a second pass is the zero-byte identical answer
    again = [replicate.replicate_all(src, [bp.config.socket_path]),
             jreplicate.replicate_all(src, [bj.config.socket_path])]
    for rs in again:
        assert [_rec(r)[:3] for r in rs] == [("identical", 0, 0)]


def test_replicate_past_max_line_is_unreachable(repl, monkeypatch):
    src = repl["owner"].config.socket_path
    dst = repl["peer"]("p3")
    listing = json.dumps(protocol.request(src, "warm_list"))
    blob = json.dumps(replicate.read_blob(
        repl["owner"].sched.warm_store, repl["man"]["config_sig"],
        "frame.npz"))
    assert 2 * len(listing) < len(blob)
    # the line limit between the listing's line and the blob's: the
    # owner encodes the blob, the dispatcher side refuses the line
    cut = (len(listing) + len(blob)) // 2
    monkeypatch.setattr(protocol, "MAX_LINE", cut)
    monkeypatch.setattr(jprotocol, "MAX_LINE", cut)
    peer = dst.config.socket_path
    for mod in (replicate, jreplicate):
        rs = mod.replicate_all(src, [peer])
        assert [_rec(r)[1:3] for r in rs] == [(0, 0)]
        assert rs[0]["status"].startswith("unreachable: ProtocolError(")
        assert "exceeds" in rs[0]["status"]
        assert dst.sched.warm_store.manifests() == []


def test_torn_push_never_installs(repl, sdir):
    dst = repl["peer"]("p4")
    man = repl["man"]
    pulled = replicate.read_blob(repl["owner"].sched.warm_store,
                                 man["config_sig"], "frame.npz")
    data = replicate.decode_blob(pulled["data"], pulled["raw_bytes"])
    b64, raw, _w = replicate.encode_blob(data[: len(data) // 2])
    blobs = {"frame.npz": {"data": b64, "raw_bytes": raw}}
    resp = protocol.request(dst.config.socket_path, "warm_push",
                            manifest=man, blobs=blobs)
    assert resp["ok"] and not resp["installed"]
    # the JAX store's install gives the same reason for the same push
    jstore = jwarmstore.WarmStore(os.path.join(sdir, "jstore"))
    assert jreplicate.install_push(jstore, man, blobs) == (
        None, resp["reason"])
    assert resp["reason"] == "digest_mismatch: frame.npz"
    assert dst.sched.warm_store.manifests() == []
    # a push of the whole blob set installs; a JAX-tagged manifest never
    whole = {rel: {k: v for k, v in replicate.read_blob(
        repl["owner"].sched.warm_store, man["config_sig"], rel).items()
        if k in ("data", "raw_bytes")} for rel in man["files"]}
    jax_man = {k: v for k, v in man.items() if k != "port"}
    resp = protocol.request(dst.config.socket_path, "warm_push",
                            manifest=jax_man, blobs=whole)
    assert (resp["installed"], resp["reason"]) == (
        False, "bad_manifest: not an artifact of this package")
    resp = protocol.request(dst.config.socket_path, "warm_push",
                            manifest=man, blobs=whole)
    assert (resp["installed"], resp["reason"]) == (True, "ok")


def test_corrupt_pull_is_quarantined(repl, monkeypatch):
    src = repl["owner"].config.socket_path
    dst = repl["peer"]("p5")
    read = replicate.read_blob
    pulls = []

    def corrupt(store, sig, rel):
        out = read(store, sig, rel)
        pulls.append(rel)
        raw = bytearray(base64.b64decode(out["data"]))
        raw[len(raw) // 2] ^= 0xFF
        return dict(out, data=base64.b64encode(bytes(raw)).decode())

    monkeypatch.setattr(replicate, "read_blob", corrupt)
    man = repl["man"]
    got = replicate.replicate_artifact(src, dst.config.socket_path, man)
    want = jreplicate.replicate_artifact(src, dst.config.socket_path, man)
    assert got == want
    assert got["status"].startswith("pull_corrupt: 'frame.npz' digest "
                                    "mismatch twice")
    assert got["blobs"] == 0 and got["wire_bytes"] > 0
    assert len(pulls) == 4  # twice for each sieve
    assert dst.sched.warm_store.manifests() == []


# ---- a two-backend CPU fleet -----------------------------------------------


def _dispatcher(root, backends, **kw):
    base = dict(health_interval_s=0.2, fail_after=2, backend_timeout_s=5.0)
    base.update(kw)
    disp = FleetDispatcher(FleetConfig(state_dir=os.path.join(root, "d"),
                                       backends=tuple(backends), **base))
    disp.start()
    return disp


@pytest.fixture(scope="module")
def fleet(cfg_dir):
    """Two CPU backends (a pool each: their jobs run at once) behind one
    dispatcher with a unix socket and an authenticated TCP listener."""
    root = tempfile.mkdtemp(prefix="pttq")
    daemons = []
    for name in ("b0", "b1"):
        config = _config(os.path.join(root, name), slice_s=0.3)
        daemons.append(ServiceDaemon(config, pool=CheckerPool(config)))
        daemons[-1].start()
    addrs = [d.config.socket_path for d in daemons]
    disp = _dispatcher(root, addrs, tcp="127.0.0.1:0",
                       tokens_path=os.path.join(cfg_dir, "tokens.json"))
    state = dict(root=root, daemons=daemons, addrs=addrs, disp=disp)
    try:
        yield state
    finally:
        state["disp"].shutdown()
        for d in daemons:
            d.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def _clients(fleet):
    disp = fleet["disp"]
    tcp = f"tcp://127.0.0.1:{disp.tcp_port}"
    return (ServiceClient(disp.config.socket_path, timeout=WAIT),
            ServiceClient(tcp, token="fleet-alpha-token-1", timeout=WAIT),
            ServiceClient(tcp, token="fleet-beta-token-22", timeout=WAIT))


def test_fleet_routing_equals_solo(fleet, cfg_dir, jax_solo):
    cl, alpha, beta = _clients(fleet)
    pong = cl.ping()
    assert pong["fleet"] is True
    assert pong["backends"] == {a: "up" for a in fleet["addrs"]}
    # two tenants over TCP, each placed least-loaded (which backend
    # depends on whether a health poll lands between the submits)
    r1 = alpha.submit("compaction", os.path.join(cfg_dir, "small.cfg"),
                      full=True)
    r2 = beta.submit("bookkeeper", os.path.join(cfg_dir, "bk.cfg"),
                     full=True)
    assert {r1["backend"], r2["backend"]} <= set(fleet["addrs"])
    assert r1["trace_id"] and r2["trace_id"] != r1["trace_id"]
    w1 = alpha.wait(r1["job_id"], timeout=WAIT)
    w2 = beta.wait(r2["job_id"], timeout=WAIT)
    assert (w1["state"], w2["state"]) == (jobs.DONE, jobs.DONE)
    assert_matches_solo(w1["result"], jax_solo["small"])
    assert_matches_solo(w2["result"], jax_solo["bk"])
    assert (w1["backend"], w2["backend"]) == (r1["backend"], r2["backend"])
    # the listing is the dispatcher's table, tenant-scoped over TCP
    listing = {j["job_id"]: j for j in cl.status()}
    assert listing[r1["job_id"]]["backend"] == r1["backend"]
    assert [j["job_id"] for j in alpha.status()] == [r1["job_id"]]
    snap = fleet["disp"].metrics_snapshot()
    assert sum(snap["routes"].values()) == 2
    assert {why for _a, why in snap["routes"]} == {"least_loaded"}
    text = cl.metrics()
    assert "ptt_fleet_routes_total" in text
    agg = cl.metrics(aggregate=True)
    assert metrics_mod.validate_exposition(agg) == []
    for a in fleet["addrs"]:
        assert f'ptt_daemon_up{{backend="{a}"}} 1' in agg
    with pytest.raises(ServiceError, match="not in the compiled"):
        cl.submit("no_such_spec", os.path.join(cfg_dir, "bk.cfg"))
    with pytest.raises(ServiceError, match="not routed through"):
        cl.status("nope")


def test_fleet_replicates_and_warm_continues_on_peer(fleet, cfg_dir,
                                                     jax_solo):
    cl = _clients(fleet)[0]
    small = os.path.join(cfg_dir, "small.cfg")
    probe = cl.submit("compaction", small, max_states=PROBE_CAP,
                      submit_id="fleet-probe", full=True)
    done = cl.wait(probe["job_id"], timeout=WAIT)
    assert done["result"]["status"] == "truncated"
    peer = fleet["daemons"][1 - fleet["addrs"].index(probe["backend"])]
    # the health thread sees the terminal job and sieves its artifact
    man = _until(lambda: next((m for _a, m in
                               peer.sched.warm_store.manifests()
                               if m.get("truncated")), None),
                 "the artifact on the peer")
    snap = fleet["disp"].metrics_snapshot()
    assert sum(snap["repl_bytes"].values()) > 0
    # a widened submit sent straight to the peer continues from it
    pcl = ServiceClient(peer.config.socket_path, timeout=WAIT)
    wide = pcl.submit("compaction", small, full=True)
    assert (wide["warm_mode"], wide["warm_reason"]) == ("continue",
                                                        "sig_match")
    w = pcl.wait(wide["job_id"], timeout=WAIT)
    assert w["result"]["warm"] == "continue"
    assert_matches_solo(w["result"], jax_solo["small"])
    evs = [json.loads(x) for x in open(fleet["disp"].config.telemetry_path)]
    rep = [e for e in evs if e["event"] == "replicate"
           and e["trace_id"] == probe["trace_id"]]
    assert [(e["dst"], e["config_sig"]) for e in rep] == [
        (peer.config.socket_path, man["config_sig"])]


def test_fleet_recover_after_torn_jobs_file(fleet, cfg_dir):
    cl, alpha, beta = _clients(fleet)
    small = os.path.join(cfg_dir, "small.cfg")
    # this test's own jobs: one for each tenant, and a probe with a
    # submit_id to retry after the recovery
    routed = [(alpha, alpha.submit("compaction", small, full=True)),
              (beta, beta.submit("bookkeeper",
                                 os.path.join(cfg_dir, "bk.cfg"), full=True)),
              (cl, cl.submit("compaction", small, max_states=PROBE_CAP,
                             submit_id="torn-probe", full=True))]
    for c, r in routed:
        assert c.wait(r["job_id"], timeout=WAIT)["state"] == jobs.DONE
    before = {j["job_id"]: j for j in cl.status()}
    assert {r["job_id"] for _c, r in routed} <= set(before)
    fleet["disp"].shutdown()
    jobs_path = fleet["disp"].config.jobs_path
    with open(jobs_path, "w") as f:
        f.write('{"fleet_jobs_v": 2, "jobs": {"torn')
    disp = _dispatcher(fleet["root"], fleet["addrs"], recover=True)
    fleet["disp"] = disp
    quarantined = [n for n in os.listdir(os.path.dirname(jobs_path))
                   if n.startswith("fleet_jobs.json.corrupt.")]
    assert len(quarantined) == 1
    after = {j["job_id"]: j for j in cl.status()}
    for k, v in before.items():
        assert (after[k]["backend"], after[k]["state"]) == (
            v["backend"], v["state"])
    # every job a backend holds under a submit_id is adopted back (a job
    # sent straight to a backend too: its client minted a submit_id)
    held = {j.job_id for d in fleet["daemons"] for j in d.sched.jobs.values()
            if j.submit_id}
    assert set(after) == held
    # a retried submit with a known submit_id dedups to the same job
    again = cl.submit("compaction", small, max_states=PROBE_CAP,
                      submit_id="torn-probe", full=True)
    assert again["job_id"] == routed[2][1]["job_id"]
    assert schema.validate_stream(disp.config.telemetry_path) == []
    evs = [json.loads(x) for x in open(disp.config.telemetry_path)]
    rec = [e for e in evs if e["event"] == "recover"]
    assert rec[-1]["quarantined"] is True
    assert rec[-1]["adopted"] == len(after)


class _Hook:
    """A callable that forwards ``resume_emitted`` of the real hook."""

    def __init__(self, fn, inner):
        self._fn, self._inner = fn, inner

    def __call__(self):
        return self._fn()

    @property
    def resume_emitted(self):
        return self._inner.resume_emitted


def _gate(sched, release=None):
    """Hold the scheduler's first job at its second level boundary until
    the scheduler stops (its daemon's shutdown) or ``release`` is set: a
    job deterministically running while another waits behind it.
    Returns the event set once the job is held."""
    mk = sched._mk_hook
    held = threading.Event()

    def mk_hook(job, deadline, resume=False, ck=None):
        hook = mk(job, deadline, resume=resume, ck=ck)
        n = [0]

        def call():
            n[0] += 1
            if n[0] == 2 and not held.is_set():
                held.set()
                end = time.monotonic() + WAIT
                while not sched._stop.is_set() and time.monotonic() < end \
                        and not (release and release.is_set()):
                    time.sleep(0.01)
            return hook()

        return _Hook(call, hook)

    sched._mk_hook = mk_hook
    return held


def test_fleet_failover_drill(cfg_dir, jax_solo, sdir):
    """Stickiness puts a running and a queued job on backend 0; backend 0
    goes down: the queued job is resubmitted to backend 1 through its
    submit_id (a watch relayed across the failover sees it end there),
    the running job is typed ``lost``; backend 0 rejoins with ``serve
    --recover``'s path and the lost job reconciles to its real result."""
    small = os.path.join(cfg_dir, "small.cfg")
    # a long quantum: the queued job never time-slices in
    configs = [_config(os.path.join(sdir, n), slice_s=600.0)
               for n in ("b0", "b1")]
    pools = [CheckerPool(c) for c in configs]
    daemons = [ServiceDaemon(c, pool=p) for c, p in zip(configs, pools)]
    for d in daemons:
        d.start()
    held = _gate(daemons[0].sched)
    b0, b1 = (c.socket_path for c in configs)
    disp = _dispatcher(sdir, [b0, b1], readmit_after=2)
    relay = {}
    try:
        cl = ServiceClient(disp.config.socket_path, timeout=WAIT, retries=8)
        r1 = cl.submit("compaction", small, submit_id="drill-run", full=True)
        assert held.wait(WAIT)
        r2 = cl.submit("compaction", small, submit_id="drill-queued",
                       full=True)
        assert (r1["backend"], r2["backend"]) == (b0, b0)
        j1, j2 = r1["job_id"], r2["job_id"]

        def states():
            return {j["job_id"]: j["state"] for j in cl.status()}

        _until(lambda: states() == {j1: "running", j2: "queued"},
               "the dispatcher's sweep to see both jobs")

        def watch():
            msgs = list(ServiceClient(disp.config.socket_path, timeout=WAIT)
                        .watch(j2, timeout_s=WAIT))
            relay["done"] = [m["done"] for m in msgs if "done" in m]

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        daemons[0].shutdown()  # the running job suspends with a frame
        _until(lambda: disp.metrics_snapshot()["failovers"].get(b0),
               "the failover")
        snap = disp.metrics_snapshot()
        assert snap["resubmitted"] == {b0: 1}
        w2 = cl.wait(j2, timeout=WAIT)
        assert w2["backend"] == b1
        assert_matches_solo(w2["result"], jax_solo["small"])
        watcher.join(WAIT)
        assert not watcher.is_alive()
        assert [d["state"] for d in relay["done"]] == [jobs.DONE]
        assert_matches_solo(relay["done"][0]["result"], jax_solo["small"])
        assert states()[j1] == "lost"
        with pytest.raises(ServiceError, match="lost with its backend"):
            cl.result(j1)
        # backend 0 rejoins (recovering its queue): after two clean polls
        # the lost job reconciles to what backend 0 really ran
        daemons[0] = ServiceDaemon(configs[0], pool=pools[0], recover=True)
        daemons[0].start()
        _until(lambda: [j for j in cl.status() if j["job_id"] == j1
                        and j["state"] == jobs.DONE and j.get("reconciled")],
               "the reconciled job")
        w1 = cl.wait(j1, timeout=WAIT)
        assert w1["backend"] == b0
        assert_matches_solo(w1["result"], jax_solo["small"])
        snap = disp.metrics_snapshot()
        assert (snap["reconciled"], snap["partitions"]) == ({b0: 1}, {b0: 1})
        assert snap["failover_n"] == 1 and snap["reconcile_n"] == 1
    finally:
        disp.shutdown()
        for d in daemons:
            d.shutdown()
    evs = [json.loads(x) for x in open(disp.config.telemetry_path)]
    kinds = [e["event"] for e in evs]
    for k in ("route", "failover", "reconcile", "partition", "relay",
              "complete"):
        assert k in kinds, k
    fo = next(e for e in evs if e["event"] == "failover")
    assert set(fo["trace_ids"]) == {r1["trace_id"], r2["trace_id"]}
    for path in [disp.config.telemetry_path] + [
            c.telemetry_path for c in configs]:
        assert schema.validate_stream(path) == [], path


def test_fleet_recover_keeps_a_failed_over_job(cfg_dir, jax_solo, sdir):
    """The dispatcher restarts with ``--recover`` while the job that a
    failover resubmitted runs on its new backend, under the id that
    backend minted: the rebuilt table keeps it there, running (the JAX
    dispatcher's ``recover`` confirms only the alias and types the job
    ``lost``), the running job of the dead backend stays ``lost``, and
    the failed-over job ends equal to the solo run."""
    small = os.path.join(cfg_dir, "small.cfg")
    configs = [_config(os.path.join(sdir, n), slice_s=600.0)
               for n in ("b0", "b1")]
    daemons = [ServiceDaemon(c, pool=CheckerPool(c)) for c in configs]
    for d in daemons:
        d.start()
    release = threading.Event()
    held0 = _gate(daemons[0].sched)
    held1 = _gate(daemons[1].sched, release)
    b0, b1 = (c.socket_path for c in configs)
    disp = _dispatcher(sdir, [b0, b1])
    try:
        cl = ServiceClient(disp.config.socket_path, timeout=WAIT, retries=8)
        r1 = cl.submit("compaction", small, submit_id="rc-run", full=True)
        assert held0.wait(WAIT)
        r2 = cl.submit("compaction", small, submit_id="rc-queued",
                       full=True)
        j1, j2 = r1["job_id"], r2["job_id"]

        def listing():
            return {j["job_id"]: (j["state"], j["backend"])
                    for j in cl.status()}

        _until(lambda: listing() == {j1: ("running", b0),
                                     j2: ("queued", b0)},
               "the dispatcher's sweep to see both jobs")
        daemons[0].shutdown()
        assert held1.wait(WAIT)  # the resubmitted job runs on backend 1
        _until(lambda: listing() == {j1: ("lost", b0),
                                     j2: ("running", b1)},
               "the failover")
        disp.shutdown()
        disp = _dispatcher(sdir, [b0, b1], recover=True)
        assert listing() == {j1: ("lost", b0), j2: ("running", b1)}
        release.set()
        w2 = cl.wait(j2, timeout=WAIT)
        assert (w2["state"], w2["backend"]) == (jobs.DONE, b1)
        assert_matches_solo(w2["result"], jax_solo["small"])
    finally:
        release.set()
        disp.shutdown()
        for d in daemons:
            d.shutdown()
    rec = [json.loads(x) for x in open(disp.config.telemetry_path)]
    rec = [e for e in rec if e["event"] == "recover"]
    assert [(e["confirmed"], e["lost"]) for e in rec] == [(2, 0)]


def test_fleet_hold_then_shed_with_every_backend_down(cfg_dir, jax_solo,
                                                      sdir):
    small = os.path.join(cfg_dir, "small.cfg")
    addrs = [os.path.join(sdir, n, "serve.sock") for n in ("b0", "b1")]
    disp = _dispatcher(sdir, addrs, fail_after=1, readmit_after=1,
                       hold_max=1, hold_s=WAIT)
    daemon = None
    out = {}
    try:
        assert disp.registry.healthy() == []  # start()'s first poll
        cl = ServiceClient(disp.config.socket_path, timeout=WAIT, retries=0)
        held = threading.Thread(target=lambda: out.update(
            r=cl.submit("compaction", small, full=True)), daemon=True)
        held.start()
        _until(lambda: disp._held == 1, "the held submit")
        # past the hold buffer: the typed capacity shed
        with pytest.raises(AdmissionRejected) as ei:
            cl.submit("compaction", small)
        assert ei.value.code == "capacity"
        # a backend comes up: the held submit is placed on it
        config = _config(os.path.join(sdir, "b0"))
        daemon = ServiceDaemon(config, pool=CheckerPool(config))
        daemon.start()
        held.join(WAIT)
        assert not held.is_alive() and out["r"]["backend"] == addrs[0]
        w = cl.wait(out["r"]["job_id"], timeout=WAIT)
        assert_matches_solo(w["result"], jax_solo["small"])
        snap = disp.metrics_snapshot()
        assert (snap["holds"], snap["held_sheds"]) == (1.0, 1.0)
    finally:
        disp.shutdown()
        if daemon is not None:
            daemon.shutdown()
    kinds = [json.loads(x)["event"] for x in open(disp.config.telemetry_path)]
    assert "hold" in kinds and "shed" in kinds
    # a hold that expires: the typed backend_unavailable (client exit 2)
    disp = _dispatcher(os.path.join(sdir, "x"), addrs[1:], fail_after=1,
                       hold_s=0.3)
    try:
        with pytest.raises(BackendUnavailable):
            ServiceClient(disp.config.socket_path, timeout=WAIT,
                          retries=0).submit("compaction", small)
    finally:
        disp.shutdown()


# ---- the CLI in subprocesses -----------------------------------------------


def _spawn(module, args, env):
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _cli(module, args, env, rc):
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=WAIT)
    assert p.returncode == rc, (module, args, p.stdout, p.stderr[-2000:])
    return p.stdout


PORT_CLI, JAX_CLI = "pulsar_tlaplus_tpu_torch.cli", "pulsar_tlaplus_tpu.cli"


@pytest.fixture(scope="module")
def cli_fleet():
    """Two ``serve -cpu`` processes behind one ``dispatch`` process."""
    root = tempfile.mkdtemp(prefix="pttc")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu",
           "PTT_TUNE_DIR": os.path.join(root, "profiles")}
    env.pop("PTT_FAULT", None)
    procs = []
    try:
        for name in ("b0", "b1"):
            procs.append(_spawn(PORT_CLI, [
                "serve", "-cpu", "--state-dir", os.path.join(root, name),
                "-chunk", "64", "--no-prewarm"], env))
        for p in procs:
            line = p.stdout.readline()
            assert line.startswith("serving on"), line
        disp = _spawn(PORT_CLI, [
            "dispatch", os.path.join(root, "d"),
            "--backend", os.path.join(root, "b0", "serve.sock"),
            "--backend", os.path.join(root, "b1", "serve.sock"),
            "--health-interval", "0.2", "--fail-after", "2"], env)
        procs.append(disp)
        sock = os.path.join(root, "d", "dispatch.sock")
        assert disp.stdout.readline() == f"dispatching on {sock}\n"
        yield dict(root=root, env=env, procs=procs,
                   d=["--socket", sock, "--retries", "8"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=WAIT)
        shutil.rmtree(root, ignore_errors=True)


def test_cli_submit_and_status_through_the_dispatcher(cli_fleet, cfg_dir):
    env, d = cli_fleet["env"], cli_fleet["d"]
    small = os.path.join(cfg_dir, "small.cfg")
    bk = os.path.join(cfg_dir, "bk.cfg")
    ids = []
    for module in (PORT_CLI, JAX_CLI):
        out = _cli(module, ["submit", "compaction", small, "--wait", *d],
                   env, 0)
        assert "1654 distinct states found" in out
        ids.append(out.split()[0])
        out = _cli(module, ["submit", "bookkeeper", bk, "--wait", *d],
                   env, 1)
        assert "ConfirmedEntryReadable" in out
        ids.append(out.split()[0])
    port = _cli(PORT_CLI, ["status", *d], env, 0)
    jax = _cli(JAX_CLI, ["status", *d], env, 0)
    for jid in ids:
        assert jid in port and jid in jax
    # each listing row names its backend
    assert port.count(" @") == jax.count(" @") == len(ids)
    _cli(PORT_CLI, ["status", "nope", *d], env, 2)
    _cli(JAX_CLI, ["status", "nope", *d], env, 2)


def test_cli_aggregate_metrics_and_top_dispatch(cli_fleet):
    env, d = cli_fleet["env"], cli_fleet["d"]
    texts = [_cli(m, ["metrics", "--aggregate", *d], env, 0)
             for m in (PORT_CLI, JAX_CLI)]
    fams = [metrics_mod.parse_exposition(t)[1] for t in texts]
    assert fams[0] == fams[1]
    assert metrics_mod.validate_exposition(texts[0]) == []
    # a latency family renders once observed: the submits' hops and ends
    hists = {k for k, v in fams[0].items() if v == "histogram"}
    assert {"ptt_fleet_route_seconds", "ptt_fleet_submit_ack_seconds",
            "ptt_fleet_job_e2e_seconds"} <= hists <= set(
                metrics_mod.new_fleet_hists())
    for name in ("b0", "b1"):
        sock = os.path.join(cli_fleet["root"], name, "serve.sock")
        assert f'ptt_daemon_up{{backend="{sock}"}} 1' in texts[0]
    for m in (PORT_CLI, JAX_CLI):
        out = _cli(m, ["top", "--dispatch", "--once", *d], env, 0)
        assert "fleet @" in out and "BACKEND" in out
    # one backend down: the aggregate scrape counts it, never fails
    b1 = cli_fleet["procs"][1]
    b1.send_signal(signal.SIGTERM)
    assert b1.wait(timeout=WAIT) == 0
    text = _until(lambda: (lambda t: t if 'ptt_fleet_scrape_errors' in t
                           and 'state="down"' in t else None)(
        _cli(PORT_CLI, ["metrics", "--aggregate", *d], env, 0)),
        "the scrape error of the stopped backend")
    assert metrics_mod.validate_exposition(text) == []
    disp = cli_fleet["procs"][2]
    disp.send_signal(signal.SIGTERM)
    assert disp.wait(timeout=WAIT) == 0
    stream = os.path.join(cli_fleet["root"], "d", "dispatch.jsonl")
    assert schema.validate_stream(stream) == []
