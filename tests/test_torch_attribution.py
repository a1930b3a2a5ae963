"""Work units and cost attribution of the PyTorch port against the JAX
package: the fused level and the stage loop count the same expanded
rows, appended rows and initial lanes, equal to the JAX engine's, at the
JAX tests' configs and both bug oracles; each loop's probed lanes are
its own flush widths (the fused ramp pads a window to the host's bound
on its frontier, so it presents at least the stage loop's lanes).  The
readers — ``obs/report.py`` and ``obs/attribution.py`` given one
calibration, and ``scripts/torch_telemetry_report.py`` — give output
equal to the JAX functions' and script's on the same streams.
Tolerance: exact equality."""

import contextlib
import importlib.util
import io
import json
import os

import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.obs import attribution as jattr
from pulsar_tlaplus_tpu.obs import report as jreport
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.obs import attribution, report
from tests.helpers import SMALL_CONFIGS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("expand_rows", "append_rows", "init_lanes")


def _mk(c, fuse="level", sub_batch=256, **kw):
    kw.setdefault("visited_cap", 1 << 12)
    return DeviceChecker(CompactionModel(c), invariants=kw.pop(
        "invariants", ()), sub_batch=sub_batch, fuse=fuse, device="cpu",
        **kw)


def _work(ck):
    return {k[len("work_"):]: v for k, v in ck.last_stats.items()
            if k.startswith("work_")}


def _widths(ck, w):
    """Each loop's own identities: compaction sees the probe's lanes,
    every flush is one group."""
    assert w["compact_elems"] == w["probe_lanes"]
    assert w["groups"] == ck.last_stats["fpset_flushes"]


def _pair(c, **kw):
    f, s = _mk(c, **kw), _mk(c, fuse="stage", **kw)
    rf, rs = f.run(), s.run()
    assert (rf.distinct_states, rf.violation) == (
        rs.distinct_states, rs.violation)
    wf, ws = _work(f), _work(s)
    for k in SHARED:
        assert wf[k] == ws[k], k
    _loops(f, wf, s, ws)
    return f, rf, wf


def _loops(f, wf, s, ws):
    _widths(f, wf)
    _widths(s, ws)
    # the stage loop flushes exactly the frontier's lanes and the
    # initial windows; the fused ramp pads to its bound
    assert ws["probe_lanes"] == f.A * ws["expand_rows"] + ws["init_lanes"]
    assert wf["probe_lanes"] >= ws["probe_lanes"]


@pytest.mark.parametrize("name", ["producer_on", "two_crashes"])
def test_work_parity_small_configs_and_jax(name):
    c = SMALL_CONFIGS[name]
    _f, rf, wf = _pair(c)
    assert wf["append_rows"] == rf.distinct_states
    assert wf["expand_rows"] == sum(rf.level_sizes)
    j = JChecker(JModel(c), invariants=(), sub_batch=256,
                 visited_cap=1 << 12, frontier_cap=1 << 12)
    j.run()
    for k in SHARED:
        assert wf[k] == j.last_stats[f"work_{k}"], k


@pytest.mark.parametrize("kw", [
    dict(sub_batch=64, visited_cap=1 << 6, group=2),
    dict(sub_batch=128, visited_cap=1 << 10, flush_factor=4),
])
def test_work_parity_under_growth_and_flush_factor(kw):
    _pair(SMALL_CONFIGS["producer_on"], **kw)


@pytest.mark.parametrize(
    "invariant", ["CompactedLedgerLeak", "DuplicateNullKeyMessage"])
def test_work_parity_bug_oracles(invariant):
    """The fused level's totals equal the JAX engine's (both loops); the
    port's stage loop stops at the flush that finds the violation (the
    JAX stage loop at its next sync: a deviation by design), so its
    totals are those of the prefix it ran — equal to the fused level's
    where both stop at the same flush (DuplicateNullKeyMessage)."""
    kw = dict(sub_batch=2048, visited_cap=1 << 16, invariants=(invariant,))
    f = _mk(pe.SHIPPED_CFG, **kw)
    s = _mk(pe.SHIPPED_CFG, fuse="stage", **kw)
    rf, rs = f.run(), s.run()
    assert rf.violation == rs.violation == invariant
    wf, ws = _work(f), _work(s)
    for fuse in ("level", "stage"):
        j = JChecker(JModel(pe.SHIPPED_CFG), frontier_cap=1 << 15,
                     fuse=fuse, **kw)
        j.run()
        for k in SHARED:
            assert wf[k] == j.last_stats[f"work_{k}"], (fuse, k)
    _widths(f, wf)
    _widths(s, ws)
    assert ws["append_rows"] == rs.distinct_states
    assert ws["probe_lanes"] == f.A * ws["expand_rows"] + ws["init_lanes"]
    if rs.distinct_states == rf.distinct_states:
        _loops(f, wf, s, ws)
    else:
        assert invariant == "CompactedLedgerLeak"
        assert ws["expand_rows"] < wf["expand_rows"]


# ---- the readers against the JAX functions -----------------------------


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """A fused port stream, a stage-timed port stream and a JAX stream
    of the same binding (producer_on)."""
    tmp = tmp_path_factory.mktemp("attr")
    c = SMALL_CONFIGS["producer_on"]
    out = {}
    p = str(tmp / "port.jsonl")
    _mk(c, telemetry=p).run()
    out["port"] = p
    os.environ["PTT_STAGE_TIMING"] = "1"
    try:
        p = str(tmp / "stage.jsonl")
        _mk(c, fuse="stage", telemetry=p).run()
        out["stage"] = p
    finally:
        del os.environ["PTT_STAGE_TIMING"]
    p = str(tmp / "jax.jsonl")
    JChecker(JModel(c), invariants=(), sub_batch=256, visited_cap=1 << 12,
             frontier_cap=1 << 12, telemetry=p).run()
    out["jax"] = p
    return out


def _ev(path):
    return report.load_events(path)[0]


def test_report_functions_equal_jax(streams):
    for name, path in streams.items():
        ev = _ev(path)
        assert report.load_events(path) == jreport.load_events(path)
        assert report.header(ev) == jreport.header(ev)
        assert report.result(ev) == jreport.result(ev)
        assert report.stage_split(ev) == jreport.stage_split(ev)
        assert report.bench_keys(ev) == jreport.bench_keys(ev), name
    pairs = [(n, _ev(p)) for n, p in streams.items()]
    assert report.render_stage_table(pairs) == \
        jreport.render_stage_table(pairs)


def test_calibration_and_attribution_equal_jax(streams, tmp_path):
    stage = _ev(streams["stage"])
    cal = attribution.calibrate_from_events(stage, label="t")
    jcal = jattr.calibrate_from_events(stage, label="t")
    for k in ("calibrated_unix",):
        cal.pop(k), jcal.pop(k)
    assert cal == jcal
    assert cal["backend"] == "cpu" and cal["measured_stages"]
    attribution.save_calibration(str(tmp_path / "c.json"), cal)
    assert attribution.load_calibration(str(tmp_path / "c.json")) == cal
    for name, path in streams.items():
        ev = _ev(path)
        assert attribution.work_units(ev) == jattr.work_units(ev)
        assert attribution.attribute(ev, cal) == jattr.attribute(ev, cal)
        assert attribution.sweep_attribute(ev, cal) == \
            jattr.sweep_attribute(ev, cal)
    pairs = [(n, _ev(p)) for n, p in streams.items()]
    assert attribution.render_attribution(pairs, cal) == \
        jattr.render_attribution(pairs, cal)
    # the stage-timed run prices itself exactly
    rows = attribution.attribute(stage, cal)
    for r in rows:
        assert r["est_s"] == pytest.approx(r["measured_s"], abs=2e-4)


def test_sweep_calibration_equals_jax(tmp_path):
    from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker

    s = str(tmp_path / "live.jsonl")
    LivenessChecker(CompactionModel(SMALL_CONFIGS["producer_on"]),
                    fairness="wf_next", device="cpu", telemetry=s).run()
    ev = _ev(s)
    cal = attribution.default_calibration("cpu")
    assert attribution.sweep_calibrate_from_events(ev, cal) == \
        jattr.sweep_calibrate_from_events(ev, cal)
    assert attribution.sweep_attribute(ev, cal) == \
        jattr.sweep_attribute(ev, cal)


def test_backends_are_cpu_and_cuda():
    for dev, want in (("cpu", "cpu"), ("cuda:0 NVIDIA H100 80GB HBM3",
                                       "cuda"), ("", "cuda")):
        ev = [{"event": "run_header", "device": dev}]
        assert attribution.backend_of(ev) == want
    assert set(attribution.DEFAULT_UNIT_COSTS) == {"cpu", "cuda"}
    for b in ("cpu", "cuda"):
        cal = attribution.default_calibration(b)
        assert set(cal["units"]) == {u for _s, _w, u, _l in
                                     attribution.STAGE_WORK} | {
            "sweep_lane_ns"}
    assert attribution.DEFAULT_UNIT_COSTS["cpu"] == \
        jattr.DEFAULT_UNIT_COSTS["cpu"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [[], ["--bench-keys"],
                                   ["--attribution", "--calibration"],
                                   ["--compare"]])
def test_report_script_equals_jax_script(streams, flags, tmp_path):
    port, jax = _load("torch_telemetry_report"), _load("telemetry_report")
    argv = [streams["port"]]
    for f in flags:
        if f == "--calibration":
            cal = str(tmp_path / "cal.json")
            attribution.save_calibration(
                cal, attribution.calibrate_from_events(
                    _ev(streams["stage"])))
            argv += [f, cal]
        elif f == "--compare":
            argv += [f, streams["jax"]]
        else:
            argv.append(f)
    outs = []
    for mod in (port, jax):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]


def test_calibrate_script_on_the_cpu(tmp_path):
    mod = _load("torch_calibrate")
    out = str(tmp_path / "cal.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(["--out", out, "--cpu", "--config", "small"]) == 0
    cal = json.loads(buf.getvalue())
    assert cal == attribution.load_calibration(out)
    assert cal["backend"] == "cpu" and cal["distinct_states"] == 1654
    assert sorted(cal["measured_stages"]) == sorted(
        s for s, *_ in attribution.STAGE_WORK)
    assert "PTT_STAGE_TIMING" not in os.environ
