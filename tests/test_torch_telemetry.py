"""Run telemetry of the PyTorch port (``pulsar_tlaplus_tpu_torch/obs/``)
against the JAX package: the stream of every engine validates under the
port's validator and the JAX ``scripts/check_telemetry_schema.py``, its
deterministic fields (level records' counts, the result, the work units
whose definitions the two packages share) equal the JAX engine's on the
same binding, the heartbeat and the header helpers print as the JAX
ones, resumed runs link to their frame, and telemetry adds no host
sync.  Tolerance: exact equality (integer counts, strings)."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.obs import report as jreport
from pulsar_tlaplus_tpu.obs import telemetry as jtel
from pulsar_tlaplus_tpu.ops import fpset as jfpset
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu.utils import faults as jfaults
from pulsar_tlaplus_tpu_torch.engine.bfs import Checker
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker
from pulsar_tlaplus_tpu_torch.engine.sharded import ShardedChecker
from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
    ShardedDeviceChecker,
)
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.obs import report, schema
from pulsar_tlaplus_tpu_torch.obs import telemetry as tel
from pulsar_tlaplus_tpu_torch.ops import fpset
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
from pulsar_tlaplus_tpu_torch.utils import ckpt, faults

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(sub_batch=2048, visited_cap=1 << 16)


def _events(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def _levels(events):
    """The deterministic fields of the boundary level records."""
    return [(e["level"], e["new_states"], e["distinct_states"],
             e["frontier"]) for e in events
            if e["event"] == "level" and not e.get("partial")]


def _result(events):
    r = [e for e in events if e["event"] == "result"][-1]
    return {k: r.get(k) for k in ("distinct_states", "diameter",
                                  "level_sizes", "truncated", "violation")}


@pytest.fixture(scope="module")
def jax_validator():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema",
        os.path.join(ROOT, "scripts", "check_telemetry_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _valid(path, jax_validator):
    assert schema.validate_stream(path) == []
    assert jax_validator.validate_stream(path) == []


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's fused run of the shipped cfg with a stream and frames
    every 5 levels, on the CPU."""
    tmp = tmp_path_factory.mktemp("ptel")
    stream, frame = str(tmp / "run.jsonl"), str(tmp / "run.ckpt")
    ck = DeviceChecker(CompactionModel(tpe.SHIPPED_CFG), device="cpu",
                       telemetry=stream, checkpoint_path=frame,
                       checkpoint_every=5, **KW)
    r = ck.run()
    return stream, frame, ck, r, _events(stream)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's run of the same binding with a stream."""
    stream = str(tmp_path_factory.mktemp("jtel") / "run.jsonl")
    ck = JChecker(JModel(pe.SHIPPED_CFG), telemetry=stream,
                  frontier_cap=1 << 15, **KW)
    r = ck.run()
    return stream, ck, r, _events(stream)


# ---- the device engine's stream against the JAX engine's -------------


def test_stream_validates_under_both_validators(port_run, jax_validator):
    stream, _frame, _ck, r, events = port_run
    assert r.distinct_states == 45198
    _valid(stream, jax_validator)
    kinds = {e["event"] for e in events}
    assert {"run_header", "level", "flush", "fuse", "ckpt_frame",
            "attribution", "result"} <= kinds
    seqs = [e["seq"] for e in events]
    assert seqs == list(range(len(seqs)))
    assert all(e["v"] == jtel.SCHEMA_VERSION for e in events)


def test_header_names_the_route_and_the_null_tiers(port_run):
    hd = port_run[4][0]
    assert hd["event"] == "run_header"
    assert (hd["engine"], hd["device"], hd["mode"]) == (
        "device_bfs", "cpu", "check")
    assert hd["probe_impl"] == hd["expand_impl"] == hd["sieve_impl"] \
        == "plain"
    for k in ("profile_sig", "tenant", "warm", "trace_id", "hbm_budget"):
        assert hd[k] is None
    assert hd["fuse"] == "level" and hd["sub_batch"] == 2048


def test_level_records_and_result_equal_the_jax_stream(port_run, jax_run):
    events, jevents = port_run[4], jax_run[3]
    assert _levels(events) == _levels(jevents)
    assert _result(events) == _result(jevents)


def test_work_units_equal_the_jax_engine(port_run, jax_run):
    """Expanded rows, appended rows and initial lanes share their
    definitions with the JAX engine; the probed lanes are the port's
    own windows' widths."""
    att = [e for e in port_run[4] if e["event"] == "attribution"][-1]
    jst = jax_run[1].last_stats
    for k in ("expand_rows", "append_rows", "init_lanes"):
        assert att["stages"][k] == jst[f"work_{k}"]
    st = port_run[2].last_stats
    assert att["stages"]["probe_lanes"] == st["work_probe_lanes"]
    assert st["work_groups"] == st["fpset_flushes"]


def test_flush_records_sum_to_the_result_stats(port_run):
    events = port_run[4]
    stats = [e for e in events if e["event"] == "result"][-1]["stats"]
    fl = [e for e in events if e["event"] == "flush"]
    assert sum(e["flushes"] for e in fl) == stats["fpset_flushes"]
    assert sum(e["probe_rounds"] for e in fl) == stats["fpset_probe_rounds"]
    assert sum(e["valid_lanes"] for e in fl) == stats["fpset_valid_lanes"]
    assert len(fl) <= stats["host_syncs"]
    fuse = [e for e in events if e["event"] == "fuse"]
    assert len(fuse) == stats["stage_fused_n"]
    assert sum(e["work_expand_rows"] for e in fuse) == \
        stats["work_expand_rows"]


def test_frame_records_and_frame_meta(port_run):
    _stream, frame, ck, _r, events = port_run
    frames = [e for e in events if e["event"] == "ckpt_frame"]
    assert [e["frame_seq"] for e in frames] == list(
        range(1, len(frames) + 1))
    assert len(frames) == ck.last_stats["ckpt_frames"] and frames
    meta = ckpt.frame_meta(np.load(frame))
    assert meta["run_id"] == events[0]["run_id"]
    assert meta["frame_seq"] == frames[-1]["frame_seq"]
    assert ckpt.frame_meta({}) == {}  # frames with no meta still load


def test_resumed_run_links_its_frame(port_run, tmp_path):
    _stream, frame, _ck, _r, events = port_run
    frames = [e for e in events if e["event"] == "ckpt_frame"]
    s2 = str(tmp_path / "resumed.jsonl")
    ck = DeviceChecker(CompactionModel(tpe.SHIPPED_CFG), device="cpu",
                       telemetry=s2, checkpoint_path=frame,
                       checkpoint_every=5, **KW)
    r = ck.run(resume=True)
    assert r.distinct_states == 45198
    hd = _events(s2)[0]
    assert hd["resume"] is True
    assert hd["resume_of"] == events[0]["run_id"]
    assert hd["resume_frame_seq"] == frames[-1]["frame_seq"]
    assert hd["resume_level"] == frames[-1]["level"]
    assert schema.validate_stream(s2) == []


def test_fault_record_lands_before_the_fault(tmp_path, monkeypatch):
    """``fpset_fail@flush:3`` ends the run with a probe overflow: the
    stream has the fault record, then the error record."""
    monkeypatch.setenv("PTT_FAULT", "fpset_fail@flush:3")
    faults.reset()
    s = str(tmp_path / "f.jsonl")
    ck = DeviceChecker(CompactionModel(tpe.SHIPPED_CFG), device="cpu",
                       fuse="stage", telemetry=s, **KW)
    with pytest.raises(RuntimeError, match="probe overflow"):
        ck.run()
    faults.reset()
    ev = _events(s)
    kinds = [e["event"] for e in ev]
    assert ("fault", "error") == tuple(k for k in kinds
                                       if k in ("fault", "error"))
    f = [e for e in ev if e["event"] == "fault"][0]
    assert (f["kind"], f["site"], f["count"]) == ("fpset_fail", "flush", 3)
    assert faults._observer is None


def test_observer_failures_never_mask_a_fault(monkeypatch):
    monkeypatch.setenv("PTT_FAULT", "oom@level:4")
    faults.reset()
    seen = []

    def boom(*a):
        seen.append(a)
        raise ValueError("observer bug")

    faults.set_observer(boom)
    try:
        assert faults.poll("level", 4) == ("oom",)
    finally:
        faults.set_observer(None)
        faults.reset()
    assert seen == [("oom", "level", 4)]


# ---- zero added syncs -------------------------------------------------


@pytest.mark.parametrize("fuse", ["level", "stage"])
def test_telemetry_and_heartbeat_add_no_host_sync(fuse, tmp_path):
    """``host_syncs`` with a stream and a 10 ms heartbeat equals the run
    without them (producer_on at sub_batch 256, as the JAX tests pin)."""
    from tests.helpers import SMALL_CONFIGS

    c = SMALL_CONFIGS["producer_on"]
    got = []
    for on in (False, True):
        kw = (dict(telemetry=str(tmp_path / f"{fuse}.jsonl"),
                   heartbeat_s=0.01) if on else {})
        ck = DeviceChecker(CompactionModel(c), device="cpu", fuse=fuse,
                           sub_batch=256, visited_cap=1 << 12, **kw)
        r = ck.run()
        got.append((r.distinct_states, ck.last_stats["host_syncs"]))
    assert got[0] == got[1]


# ---- every other engine ------------------------------------------------


def test_sharded_device_stream(tmp_path, jax_validator, port_run):
    s = str(tmp_path / "sh.jsonl")
    r = ShardedDeviceChecker(CompactionModel(tpe.SHIPPED_CFG), n_devices=4,
                             device="cpu", telemetry=s).run()
    assert r.distinct_states == 45198
    _valid(s, jax_validator)
    ev = _events(s)
    assert ev[0]["engine"] == "sharded_device" and ev[0]["n_devices"] == 4
    assert [x[:3] for x in _levels(ev)] == [
        x[:3] for x in _levels(port_run[4])]
    st = [e for e in ev if e["event"] == "result"][-1]["stats"]
    assert sum(e["flushes"] for e in ev if e["event"] == "flush") == \
        st["fpset_flushes"]


@pytest.mark.parametrize("engine", ["host", "sharded_host"])
def test_host_engine_streams(engine, tmp_path, jax_validator, port_run):
    s = str(tmp_path / f"{engine}.jsonl")
    m = CompactionModel(tpe.SHIPPED_CFG)
    ck = (Checker(m, device="cpu", telemetry=s,
                  checkpoint_path=str(tmp_path / "h.ckpt"))
          if engine == "host" else
          ShardedChecker(m, n_devices=2, device="cpu", telemetry=s))
    r = ck.run()
    assert r.distinct_states == 45198
    _valid(s, jax_validator)
    ev = _events(s)
    assert ev[0]["engine"] == ("bfs_host" if engine == "host"
                               else "sharded_host")
    assert [x[:3] for x in _levels(ev)] == [
        x[:3] for x in _levels(port_run[4])]
    assert _result(ev)["level_sizes"] == r.level_sizes


def test_liveness_stream_is_two_phase(tmp_path, jax_validator):
    s = str(tmp_path / "live.jsonl")
    lc = LivenessChecker(CompactionModel(tpe.SHIPPED_CFG),
                         fairness="wf_next", device="cpu", telemetry=s)
    res = lc.run()
    assert res.holds and res.distinct_states == 45198
    _valid(s, jax_validator)
    ev = _events(s)
    heads = [e["engine"] for e in ev if e["event"] == "run_header"]
    assert heads == ["liveness", "device_bfs"]
    sw = [e for e in ev if e["event"] == "sweep"]
    assert sw and sw[-1]["chunk"] == sw[-1]["chunks"]
    for a, b in zip(sw, sw[1:]):
        for k in ("sort_lanes", "prop_lanes", "compact_elems", "edges"):
            assert a[k] <= b[k]
    res_rec = [e for e in ev if e["event"] == "result"][-1]
    assert res_rec["holds"] is True and res_rec["goal"] == "Termination"
    assert res_rec["work_sweep_compact_elems"] == sw[-1]["compact_elems"]


def test_simulation_stream(tmp_path, jax_validator):
    s = str(tmp_path / "sim.jsonl")
    sim = StreamingSimulator(CompactionModel(tpe.SHIPPED_CFG),
                             invariants=("CompactedLedgerLeak",),
                             n_walkers=256, depth=32, max_rounds=20,
                             device="cpu", telemetry=s, heartbeat_s=0.01)
    r = sim.run()
    assert r.violation == "CompactedLedgerLeak"
    _valid(s, jax_validator)
    ev = _events(s)
    assert ev[0]["engine"] == "sim" and ev[0]["mode"] == "simulate"
    sims = [e for e in ev if e["event"] == "sim"]
    assert len(sims) == r.segments
    assert sims[-1]["steps"] == r.steps
    v = [e for e in ev if e["event"] == "sim_violation"]
    assert v and v[0]["verified"] is True


def test_owned_and_borrowed_streams(tmp_path):
    """A path opens a stream the engine closes; a Telemetry the caller
    passes collects several runs under one run_id and stays open."""
    with tel.Telemetry(str(tmp_path / "two.jsonl")) as t:
        for _ in range(2):
            DeviceChecker(CompactionModel(tpe.SHIPPED_CFG), device="cpu",
                          telemetry=t, **KW).run()
        assert not t._f.closed
    ev = _events(str(tmp_path / "two.jsonl"))
    assert [e["event"] for e in ev].count("result") == 2
    assert {e["run_id"] for e in ev} == {t.run_id}
    assert tel.owns_stream("x") and not tel.owns_stream(t)
    assert tel.as_telemetry(None) is tel.NULL


# ---- the heartbeat, the probes, the validators ------------------------


def _beat_lines(mod, snaps, monkeypatch, every=1.0):
    lines = []
    clock = iter([100.0 + i for i in range(100)])
    monkeypatch.setattr(mod.time, "monotonic", lambda: next(clock))
    hb = mod.Heartbeat(every, {}, capacity=10_000, log=lines.append)
    prev = (100.0, 0)
    for snap in snaps:
        hb.snap.clear()
        hb.snap.update(snap)
        prev = hb._beat(100.0, prev)
    return lines


def test_heartbeat_lines_equal_the_jax_heartbeat(monkeypatch):
    snaps = [
        dict(distinct_states=1000, level=3, frontier=200, occupancy=0.1,
             generated=1500),
        dict(distinct_states=4000, level=5, frontier=900, partial=True),
        dict(distinct_states=9000, walks=512, generated=20000),
    ]
    assert _beat_lines(tel, snaps, monkeypatch) == _beat_lines(
        jtel, snaps, monkeypatch)


@pytest.mark.parametrize("spec", ["5:6", "7:7", "6:5", "x", "3"])
def test_parse_level_window_equals_jax(spec):
    def run(f):
        try:
            return f(spec)
        except ValueError as e:
            return str(e)

    assert run(tel.parse_level_window) == run(jtel.parse_level_window)


def test_measure_rtt_and_labels():
    assert 0.0 <= tel.measure_rtt("cpu") < 1.0
    assert tel.device_label("cpu") == "cpu"
    assert tel.impl_route(torch.device("cpu")) == "plain"
    assert tel.SCHEMA_VERSION == jtel.SCHEMA_VERSION
    assert tel.EVENTS == jtel.EVENTS and tel.FIELD_SINCE == jtel.FIELD_SINCE


def test_torn_last_line_is_reported_not_raised(port_run, tmp_path):
    p = tmp_path / "torn.jsonl"
    with open(port_run[0]) as f:
        text = f.read()
    p.write_text(text + '{"v": 16, "event": "lev')
    got, jgot = report.load_events(str(p)), jreport.load_events(str(p))
    assert got == jgot
    assert len(got[1]) == 1 and "unparseable" in got[1][0]


def _bad_streams(base):
    """Streams that break each rule of the validator."""
    hd, lv = base[0], [e for e in base if e["event"] == "level"][:3]
    out = {"ok": [hd] + lv}
    out["seq_dup"] = [hd, dict(lv[0], seq=hd["seq"])]
    out["t_back"] = [dict(hd, t=5.0), dict(lv[0], t=1.0)]
    out["missing"] = [{k: v for k, v in hd.items() if k != "config_sig"}]
    out["future"] = [dict(hd, v=99)]
    sp = dict(v=16, event="spill", t=1.0, run_id=hd["run_id"], tier="ram",
              keys_evicted=5, rows_evicted=5, bytes_raw=10, bytes_comp=5,
              transfer_s=0.1, misses_resolved=1)
    out["spill_back"] = [hd, dict(sp, seq=90), dict(sp, seq=91, t=2.0,
                                                    keys_evicted=4)]
    out["not_obj"] = None
    out["empty"] = []
    return out


def test_validator_equals_the_jax_validator(port_run, jax_validator,
                                            tmp_path):
    for name, recs in _bad_streams(port_run[4]).items():
        p = tmp_path / f"{name}.jsonl"
        if recs is None:
            p.write_text("[1, 2]\n")
        else:
            p.write_text("".join(json.dumps(r) + "\n" for r in recs))
        assert schema.validate_stream(str(p)) == \
            jax_validator.validate_stream(str(p)), name
    import glob

    for path in sorted(glob.glob(os.path.join(ROOT, "BENCH_*.json"))):
        assert schema.validate_bench_artifact(path) == \
            jax_validator.validate_bench_artifact(path)


# ---- work vector and FPSet --------------------------------------------


def test_work_vector_is_int64_logical():
    w = torch.zeros((fpset.WKM_N,), dtype=torch.int64)
    big = (1 << 31) - 7
    for _ in range(3):
        w = fpset.wkm_update(w, 5, big, big, torch.tensor(2), 1)
    assert list(fpset.wkm_logical(w)) == [15, 3 * big, 3 * big, 6, 3]
    assert list(fpset.wkm_logical([1, 2])) == [1, 2, 0, 0, 0]
    # the JAX vector's logical view has the same order
    j = jfpset.wkm_logical(np.zeros((jfpset.WKM_N,), np.int32))
    assert len(j) == fpset.WKM_LOGICAL_N


def test_fpset_wrapper_equals_the_jax_fpset(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    fs = fpset.FPSet(2, device="cpu", telemetry=str(tmp_path / "f.jsonl"))
    jfs = jfpset.FPSet(2)
    for n in (100, 900, 3000):
        k = rng.integers(0, 2000, size=(2, n), dtype=np.int64).astype(
            np.uint32)
        valid = rng.random(n) < 0.9
        got = fs.insert(tuple(torch.from_numpy(c.view(np.int32))
                              for c in k), torch.from_numpy(valid))
        want = jfs.insert(tuple(k), valid)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert fs.n == jfs.n
        probe = rng.integers(0, 4000, size=(2, 500), dtype=np.int64).astype(
            np.uint32)
        assert np.array_equal(
            fs.contains(tuple(torch.from_numpy(c.view(np.int32))
                              for c in probe)).numpy(),
            np.asarray(jfs.contains(tuple(probe))))
    fs.close()
    ev = _events(str(tmp_path / "f.jsonl"))
    assert [e["inserts"] for e in ev] == [1, 2, 3]
    assert ev[-1]["n"] == jfs.n
    monkeypatch.setenv("PTT_FAULT", "fpset_fail@flush:4")
    faults.reset()
    with pytest.raises(RuntimeError, match="probe overflow"):
        fs.insert((torch.tensor([7], dtype=torch.int32),) * 2)
    faults.reset()
    jfaults.reset()


def test_stage_timing_records_and_rtt(tmp_path, monkeypatch):
    monkeypatch.setenv("PTT_STAGE_TIMING", "1")
    s = str(tmp_path / "st.jsonl")
    ck = DeviceChecker(CompactionModel(tpe.SHIPPED_CFG), device="cpu",
                       fuse="stage", telemetry=s, **KW)
    ck.run()
    st = ck.last_stats
    for name in ("init", "expand", "flush", "compact", "append"):
        assert st[f"stage_{name}_n"] > 0 and st[f"stage_{name}_s"] >= 0
    assert "rtt_s" in st
    ev = _events(s)
    timing = [e for e in ev if e["event"] == "stage_timing"]
    assert timing and set(timing[0]["stages"]) == {
        "init", "expand", "flush", "compact", "append"}
    split = report.stage_split(ev)
    res = [e for e in ev if e["event"] == "result"][-1]["stats"]
    assert split["flush"]["device_s"] == pytest.approx(
        max(res["stage_flush_s"] - res["stage_flush_n"] * res["rtt_s"],
            0.0))
    assert split == jreport.stage_split(ev)
