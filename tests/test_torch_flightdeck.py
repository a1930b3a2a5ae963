"""The stream readers of the PyTorch port (``obs/trace.py``, the stream
side of ``obs/metrics.py`` and ``obs/top.py``, the job tables of
``obs/report.py``) and the CLI's ``trace``, ``metrics --stream`` and
``top --stream`` against the JAX package on the same event lists: a
port stream, a JAX stream, and synthetic daemon and fleet lists.  The
daemon and fleet modes of ``metrics``/``top`` are refused with exit 2.
Tolerance: exact equality (the trace's ``otherData.source`` names the
producing package and is left out)."""

import contextlib
import io
import json
import time

import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.obs import metrics as jmetrics
from pulsar_tlaplus_tpu.obs import report as jreport
from pulsar_tlaplus_tpu.obs import top as jtop
from pulsar_tlaplus_tpu.obs import trace as jtrace
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.obs import metrics, report, top, trace
from tests.helpers import SMALL_CONFIGS

torch.set_num_threads(1)


def _rec(rid, seq, t, event, v=16, **kw):
    return {"v": v, "event": event, "t": t, "run_id": rid, "seq": seq,
            **kw}


def _daemon_events():
    """A daemon stream across a restart (two run_ids, each its own
    clock): job slices, suspends and resumes, results."""
    return [
        _rec("d1", 0, 0.5, "job_submit", 5, job_id="A", spec="s",
             wall_unix=1000.5),
        _rec("d1", 1, 1.0, "job_start", 5, job_id="A", spec="s", slice=1),
        _rec("d1", 2, 5.0, "job_suspend", 5, job_id="A", slice=1,
             slice_wall_s=4.0),
        _rec("d1", 3, 6.0, "job_start", 5, job_id="B", spec="s", slice=1),
        _rec("d2", 0, 0.2, "job_submit", 5, job_id="C", spec="s",
             wall_unix=2000.2),
        _rec("d2", 1, 1.0, "job_resume", 5, job_id="A", spec="s", slice=2,
             restore_s=0.1),
        _rec("d2", 2, 3.0, "job_result", 5, job_id="A", status="ok",
             wall_s=6.0),
        _rec("d2", 3, 4.0, "job_start", 5, job_id="C", spec="s", slice=1),
        _rec("d2", 4, 5.0, "job_result", 5, job_id="C", status="ok",
             wall_s=1.0),
        _rec("d2", 5, 5.5, "job_cancel", 5, job_id="B"),
    ]


def _fleet_events():
    """A dispatcher stream: routes, a replication, a failover, a
    reconcile, completions, relay legs, a hold and a shed, a persist
    failure."""
    tid, tid2 = "a" * 32, "b" * 32
    return [
        _rec("f", 0, 0.1, "route", backend="sock-A", tenant="local",
             trace_id=tid, route_ms=1.5, ack_ms=12.0, reason="sticky",
             job_id="j1", wall_unix=3000.0),
        _rec("f", 1, 0.2, "route", backend="sock-B", tenant="t2",
             trace_id=tid2, route_ms=0.7, ack_ms=4.0, job_id="j2"),
        _rec("f", 2, 0.5, "replicate", src="sock-A", dst="sock-B",
             blobs=3, wire_bytes=4096, trace_id=tid, wall_ms=22.0),
        _rec("f", 3, 1.0, "failover", backend="sock-A", resubmitted=1,
             trace_ids=[tid], wall_ms=40.0),
        _rec("f", 4, 1.2, "reconcile", backend="sock-B", job_id="j1",
             state="done", trace_id=tid),
        _rec("f", 5, 1.3, "relay", job_id="j1", leg_ms=3.0, trace_id=tid),
        _rec("f", 6, 2.0, "complete", job_id="j1", backend="sock-B",
             e2e_ms=2500.0, trace_id=tid),
        _rec("f", 7, 2.1, "complete", job_id="j2", backend="sock-B",
             e2e_ms=900.0, trace_id=tid2),
        _rec("f", 8, 2.2, "hold", tenant="local", held=1, trace_id=None),
        _rec("f", 9, 2.3, "shed", tenant="local", held=1, trace_id=None),
        _rec("f", 10, 2.4, "partition", backend="sock-A", wall_ms=11.0),
        _rec("f", 11, 2.5, "persist_fail", n=1),
    ]


def _progress_events():
    def prog(seq, n, rate):
        return _rec("r", seq, float(seq), "progress", 5,
                    distinct_states=n, states_per_sec=rate,
                    level=seq + 1)

    return [prog(0, 1_000, 10.0), prog(1, 9_000_000, 500_000.0)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Stream files: a port run, a JAX run, and the synthetic lists."""
    tmp = tmp_path_factory.mktemp("deck")
    c = SMALL_CONFIGS["producer_on"]
    out = {}
    p = str(tmp / "port.jsonl")
    DeviceChecker(CompactionModel(c), invariants=(), sub_batch=256,
                  visited_cap=1 << 12, device="cpu", telemetry=p,
                  heartbeat_s=0.01).run()
    out["port"] = p
    p = str(tmp / "jax.jsonl")
    JChecker(JModel(c), invariants=(), sub_batch=256, visited_cap=1 << 12,
             frontier_cap=1 << 12, telemetry=p).run()
    out["jax"] = p
    for name, evs in (("daemon", _daemon_events()),
                      ("fleet", _fleet_events()),
                      ("progress", _progress_events())):
        p = str(tmp / f"{name}.jsonl")
        with open(p, "w") as f:
            f.write("".join(json.dumps(e) + "\n" for e in evs))
        out[name] = p
    return out


def _ev(path):
    return report.load_events(path)[0]


def _strip(tr):
    tr = json.loads(json.dumps(tr))
    tr["otherData"].pop("source")
    return tr


@pytest.mark.parametrize("combo", [
    ("port",), ("jax",), ("daemon",), ("fleet",), ("port", "jax"),
    ("fleet", "daemon", "port"),
])
def test_trace_equals_jax(files, combo):
    streams = [(n, _ev(files[n])) for n in combo]
    got, want = trace.build_trace(streams), jtrace.build_trace(streams)
    assert got["otherData"]["source"] == \
        "pulsar_tlaplus_tpu_torch obs/trace.py"
    assert _strip(got) == _strip(want)
    assert trace.validate_trace(got) == jtrace.validate_trace(got) == []
    assert trace.job_slices(streams[0][1]) == \
        jtrace.job_slices(streams[0][1])
    assert trace.trace_chains(streams) == jtrace.trace_chains(streams)


def test_trace_validator_equals_jax(tmp_path):
    bad = [{"traceEvents": [{"ph": "X", "name": "x"}]}, {"nope": 1}, [],
           {"traceEvents": [{"ph": "X", "ts": 1, "dur": -2, "pid": 1,
                             "tid": 1, "name": "n"}]}]
    for i, tr in enumerate(bad):
        p = tmp_path / f"b{i}.json"
        p.write_text(json.dumps(tr))
        assert trace.validate_trace(str(p), "x") == \
            jtrace.validate_trace(str(p), "x")


@pytest.mark.parametrize("name", ["port", "jax", "daemon", "fleet",
                                  "progress"])
def test_stream_metrics_equal_jax(files, name):
    ev = _ev(files[name])
    text = metrics.render_stream_metrics(ev)
    assert text == jmetrics.render_stream_metrics(ev)
    assert metrics.parse_exposition(text) == jmetrics.parse_exposition(text)
    assert metrics.validate_exposition(text) == \
        jmetrics.validate_exposition(text) == []
    h, jh = (metrics.fleet_hists_from_events(ev),
             jmetrics.fleet_hists_from_events(ev))
    assert {k: v.cumulative() for k, v in h.items()} == \
        {k: v.cumulative() for k, v in jh.items()}


def test_metric_helpers_equal_jax(files):
    for q in (0.5, 0.99):
        hs = metrics.Histogram()
        jhs = jmetrics.Histogram()
        for x in (0.0004, 0.003, 0.2, 7.0, 500.0):
            hs.observe(x)
            jhs.observe(x)
        assert hs.cumulative() == jhs.cumulative()
        pairs = [(float(le), float(n)) for le, n in hs.cumulative()]
        assert metrics.histogram_quantile(q, pairs) == \
            jmetrics.histogram_quantile(q, pairs)
    scrapes = {"b0": metrics.render_stream_metrics(_ev(files["port"])),
               "b1": metrics.render_stream_metrics(_ev(files["jax"]))}
    fleet = metrics.render_stream_metrics(_ev(files["fleet"]))
    assert metrics.aggregate_exposition(fleet, scrapes) == \
        jmetrics.aggregate_exposition(fleet, scrapes)
    assert metrics.LATENCY_BUCKETS_S == jmetrics.LATENCY_BUCKETS_S
    assert metrics.STATES == jreport_states()


def jreport_states():
    from pulsar_tlaplus_tpu.service import jobs

    return jobs.STATES


@pytest.mark.parametrize("paths", [["port"], ["daemon"], ["daemon", "port"],
                                   ["progress"], ["jax"]])
def test_top_frame_equals_jax(files, paths, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ps = [files[p] for p in paths]
    m, jm = top.TopModel(", ".join(ps)), jtop.TopModel(", ".join(ps))
    for _ in range(2):  # a second tick extends the rate history
        assert top.tail_stream_frame(ps, m) == \
            jtop.tail_stream_frame(ps, jm)
    vals = [0, 1, 5, 3, 1e6, 2.5]
    assert top.sparkline(vals, 8) == jtop.sparkline(vals, 8)
    for n in (0, 999, 1234, 5_600_000, 7.2e9, None):
        assert top.fmt_si(n) == jtop.fmt_si(n)


def test_job_tables_equal_jax():
    d, f = _daemon_events(), _fleet_events()
    assert report.job_table(d) == jreport.job_table(d)
    assert report.fleet_job_index(f) == jreport.fleet_job_index(f)
    assert report.render_job_table(d) == jreport.render_job_table(d)
    assert report.render_job_table(d, fleet_events=f) == \
        jreport.render_job_table(d, fleet_events=f)


# ---- the CLI against the JAX CLI ----------------------------------------


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("names", [["port"], ["port", "jax", "daemon"],
                                   ["fleet", "daemon"]])
def test_cli_trace_equals_jax(files, names, tmp_path):
    ins = [files[n] for n in names]
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    got = _run(cli.main, ["trace", *ins, "-o", a])
    want = _run(jcli.main, ["trace", *ins, "-o", b])
    assert got[0] == want[0] == 0
    assert got[1].replace(a, "OUT") == want[1].replace(b, "OUT")
    with open(a) as fa, open(b) as fb:
        assert _strip(json.load(fa)) == _strip(json.load(fb))


def test_cli_trace_refuses_an_empty_stream(tmp_path):
    p = tmp_path / "empty.jsonl"
    p.write_text("")
    assert _run(cli.main, ["trace", str(p)])[:2] == \
        _run(jcli.main, ["trace", str(p)])[:2]


@pytest.mark.parametrize("name", ["port", "jax", "daemon", "fleet"])
def test_cli_metrics_and_top_equal_jax(files, name, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    for argv in (["metrics", "--stream", files[name]],
                 ["top", "--stream", files[name], "--once"]):
        assert _run(cli.main, argv) == _run(jcli.main, argv)


@pytest.mark.parametrize("argv", [
    ["metrics"], ["metrics", "--aggregate"], ["top", "--once"],
    ["top", "--dispatch", "--once"],
])
def test_daemon_and_fleet_modes_are_refused(argv, tmp_path):
    """The daemon and fleet modes with no daemon or dispatcher listening
    exit 2 (transport, never a verdict), as the JAX CLI does."""
    rc, out, err = _run(cli.main, argv + ["--retries", "0", "--socket",
                                          str(tmp_path / "none.sock")])
    assert rc == 2 and not out
    assert "no daemon socket" in err
    assert _run(jcli.main, argv + ["--retries", "0", "--socket", str(
        tmp_path / "none.sock")])[0] == 2


def test_cli_check_flags_reach_the_engine(tmp_path):
    """``check -telemetry -progress -xprof`` on the CPU: a valid stream,
    a heartbeat line, a profiler trace of the level window; the
    interpreter path refuses the flags as the JAX CLI does."""
    s = str(tmp_path / "c.jsonl")
    xdir = str(tmp_path / "xprof")
    rc, out, err = _run(cli.main, [
        "check", "specs/compaction.tla", "-cpu", "-telemetry", s,
        "-progress", "0.01", "-xprof", xdir, "-xprof-levels", "3:4"])
    assert rc == 0 and "45198 distinct states" in out
    ev = _ev(s)
    xp = [e for e in ev if e["event"] == "xprof"]
    assert [e["action"] for e in xp] == ["start", "stop"]
    # the window opens at the first level boundary inside it (a ramp
    # batch may carry level 3 with level 2)
    assert 3 <= xp[0]["level"] <= 4
    with open(xp[1]["path"]) as f:
        assert json.load(f)["traceEvents"]
    assert "Progress(" in err
    rc, _o, err2 = _run(cli.main, ["check", "specs/compaction.tla", "-cpu",
                                   "-engine", "host", "-xprof", xdir])
    assert rc == 0 and "-xprof is only supported" in err2
    refuse = ["check", "specs/compaction.tla", "-interp", "-telemetry", s]
    got, want = _run(cli.main, refuse), _run(jcli.main, refuse)
    assert got[0] == want[0] and got[0] not in (0, None)
    assert str(got[0]) == str(want[0])
    bad = _run(cli.main, ["check", "specs/compaction.tla", "-cpu",
                          "-xprof-levels", "6:5"])
    assert "-xprof-levels" in str(bad[0])
