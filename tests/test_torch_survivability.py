"""Runs that survive, on the CPU: the port's checkpoint frames, resume,
device-memory recovery, preemption, the frontier row window, the time
budget, the fused tiered handoff and the durable spill, for the device
checker, liveness and the simulator, against the JAX package on the
same inputs (``tests/test_checkpoint.py``, ``test_survivability.py``
and ``test_survivability_r9.py`` are the JAX side's versions):

- a preempted run's frame equals the JAX engine's frame at the same
  level (counts, level sizes, frontier, rows, parent/lane logs, the
  visited keys as sorted sets), and its resume equals the uninterrupted
  run state for state, in the fused level and the stage loop;
- the depth-12 ``CompactedLedgerLeak`` trace across a frame is the JAX
  engine's (gid too);
- frontier window runs (both loops) equal the JAX ``rows_window=
  "frontier"`` run, and both stop ``row_window`` at tiny caps;
- every stop reason is reached with counts a prefix of the full run's;
- the tiered run hands over from the fused level and equals the JAX
  untiered run; its durable spill resumes equal and refuses a torn file;
- liveness (sweep and exploration frames) and simulation resume;
- a compiled model's frames (its identity the JAX ``_model_sig``);
- two subprocess kill drills through the CLI, whose lines equal the JAX
  CLI's.

Tolerance: exact equality."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.engine.liveness import LivenessChecker as JLive
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu.utils import faults as jfaults
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.engine.device_bfs import (
    HBM_HEADROOM,
    DeviceChecker,
)
from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
from pulsar_tlaplus_tpu_torch.utils import faults
from tests.helpers import SMALL_CONFIGS, assert_valid_counterexample

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "compaction.tla")
JKW = dict(sub_batch=2048, visited_cap=1 << 16, frontier_cap=1 << 15)
LEAK = "CompactedLedgerLeak"


def _port(c=pe.SHIPPED_CFG):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


def _ck(c=pe.SHIPPED_CFG, **kw):
    kw.setdefault("device", "cpu")
    return DeviceChecker(_port(c), **kw)


@pytest.fixture
def fault(monkeypatch):
    """Set ``PTT_FAULT`` for both packages' parsers (re-armed), and clear
    it afterwards."""
    def arm(spec):
        if spec is None:
            monkeypatch.delenv("PTT_FAULT", raising=False)
        else:
            monkeypatch.setenv("PTT_FAULT", spec)
        faults.reset()
        jfaults.reset()

    yield arm
    monkeypatch.delenv("PTT_FAULT", raising=False)
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def jax_full():
    """The JAX engine's uninterrupted shipped-cfg run: level sizes, rows,
    parent and lane logs."""
    ck = JChecker(JModel(pe.SHIPPED_CFG), **JKW)
    r = ck.run()
    nv = r.distinct_states
    return (r.level_sizes,
            np.asarray(ck.last_bufs["rows"][: nv * 2]),
            np.asarray(ck.last_bufs["parent"][:nv]),
            np.asarray(ck.last_bufs["lane"][:nv]))


def _same_as_full(ck, r, full, rows=True):
    sizes, jrows, jpar, jlane = full
    assert r.level_sizes == sizes and not r.truncated
    par, lane = ck.merged_logs()
    assert np.array_equal(par, jpar) and np.array_equal(lane, jlane)
    if rows:
        assert np.array_equal(ck.merged_rows(), jrows)


def _keys(d):
    """A frame's visited keys as a sorted set of tuples."""
    k = sum(1 for f in d.files if re.fullmatch(r"fpk\d+", f))
    cols = [np.asarray(d[f"fpk{i}"], np.uint32) for i in range(k)]
    return sorted(zip(*(c.tolist() for c in cols)))


# ---- frames and resume on the device checker --------------------------


@pytest.fixture(scope="module")
def jax_frame7(tmp_path_factory):
    """The JAX engine's frame of a run preempted at level 7."""
    path = str(tmp_path_factory.mktemp("j") / "j.npz")
    os.environ["PTT_FAULT"] = "sigterm@level:7"
    jfaults.reset()
    try:
        r = JChecker(JModel(pe.SHIPPED_CFG), checkpoint_path=path,
                     checkpoint_every=1, **JKW).run()
    finally:
        del os.environ["PTT_FAULT"]
        jfaults.reset()
    assert r.stop_reason == "preempted"
    return np.load(path)


@pytest.mark.parametrize("fuse", ["level", "stage"])
def test_preempt_frame_equals_jax_and_resume_equals_full(
        fuse, fault, tmp_path, jax_full, jax_frame7):
    """SIGTERM at level 7 (the ``sigterm`` drill): the run stops
    ``preempted`` after level 7 with a frame equal to the JAX engine's;
    resumed from it, the run equals the uninterrupted JAX run."""
    path = str(tmp_path / "f.npz")
    fault("sigterm@level:7")
    r1 = _ck(checkpoint_path=path, checkpoint_every=1, fuse=fuse,
             sub_batch=700).run()
    assert r1.truncated and r1.stop_reason == "preempted"
    assert r1.level_sizes == jax_full[0][:7]
    d, j = np.load(path), jax_frame7
    for name in ("n_visited", "level_sizes", "lb", "nf", "rows_lo",
                 "rows", "parent", "lane", "hbm_recovered"):
        assert np.array_equal(np.asarray(d[name]), np.asarray(j[name])), name
    assert _keys(d) == _keys(j)
    fault(None)
    ck = _ck(checkpoint_path=path, fuse=fuse, sub_batch=700)
    r2 = ck.run(resume=True)
    assert (r2.distinct_states, r2.diameter) == (45198, 20)
    _same_as_full(ck, r2, jax_full)
    assert ck.last_stats["restore_s"] >= 0


def test_budget_truncation_resumes_exact(tmp_path, jax_full):
    """A ``max_states`` stop mid-level leaves a frame rewound to its level
    boundary; the resume equals the full run (the JAX
    ``test_device_checkpoint_resume_exact_count``)."""
    path = str(tmp_path / "f.npz")
    r1 = _ck(checkpoint_path=path, checkpoint_every=3, max_states=10_000,
             sub_batch=300).run()
    assert r1.truncated and r1.stop_reason == "max_states"
    assert r1.distinct_states < 45198
    ck = _ck(checkpoint_path=path, sub_batch=300)
    _same_as_full(ck, ck.run(resume=True), jax_full)


def test_leak_trace_across_frame_equals_jax(tmp_path):
    jr = JChecker(JModel(pe.SHIPPED_CFG), invariants=(LEAK,), **JKW).run()
    path = str(tmp_path / "f.npz")
    r1 = _ck(invariants=(LEAK,), checkpoint_path=path, checkpoint_every=2,
             max_states=6_000, sub_batch=512).run()
    assert r1.truncated and r1.violation is None
    r2 = _ck(invariants=(LEAK,), checkpoint_path=path,
             sub_batch=512).run(resume=True)
    assert (r2.violation, r2.diameter) == (LEAK, 12)
    assert r2.violation_gid == jr.violation_gid == 23329
    assert [tuple(s) for s in r2.trace] == [tuple(s) for s in jr.trace]
    assert r2.trace_actions == jr.trace_actions
    assert_valid_counterexample(
        pe.SHIPPED_CFG, [pe.State(*s) for s in r2.trace],
        r2.trace_actions, LEAK)


def test_frame_signatures_refuse(tmp_path, jax_frame7):
    """Another model, another invariant set, a JAX-written frame and a
    file that is no frame are all refused."""
    path = str(tmp_path / "f.npz")
    _ck(checkpoint_path=path, checkpoint_every=2, max_states=5_000).run()
    other = dataclasses.replace(pe.SHIPPED_CFG, max_crash_times=2)
    for ck in (_ck(other, checkpoint_path=path),
               _ck(invariants=(LEAK,), checkpoint_path=path)):
        with pytest.raises(ValueError, match="different configuration"):
            ck.run(resume=True)
    jpath = str(tmp_path / "j.npz")
    np.savez(jpath, **dict(jax_frame7))
    with pytest.raises(ValueError, match="different configuration"):
        _ck(checkpoint_path=jpath).run(resume=True)
    bad = str(tmp_path / "bad.npz")
    with open(bad, "wb") as f:
        f.write(b"not a frame")
    with pytest.raises(ValueError, match="unrecognized checkpoint"):
        _ck(checkpoint_path=bad).run(resume=True)
    with pytest.raises(ValueError, match="resume requires"):
        _ck().run(resume=True)


# ---- device memory, probe overflow, time budget ------------------------


def test_oom_drill_recovers_from_frame(fault, tmp_path, jax_full):
    fault("oom@level:7")
    ck = _ck(checkpoint_path=str(tmp_path / "f.npz"), checkpoint_every=1,
             sub_batch=1024)
    r = ck.run()
    assert r.hbm_recovered == 1 and ck.rec.headroom_frozen
    assert not r.truncated and r.stop_reason is None
    _same_as_full(ck, r, jax_full)


@pytest.mark.parametrize("fuse", ["level", "stage"])
def test_oom_without_frame_truncates_hbm(fuse, fault, jax_full):
    fault("oom@level:3")
    r = _ck(fuse=fuse).run()
    assert r.truncated and r.stop_reason == "hbm" and r.hbm_recovered == 0
    assert 0 < r.distinct_states < 45198
    assert r.level_sizes == jax_full[0][: len(r.level_sizes)]


@pytest.mark.parametrize("spec", ["fpset_fail@flush:2", "oom@flush:2"])
def test_flush_site_faults(spec, fault):
    """``fpset_fail`` fail-stops as a probe overflow; ``oom`` at the flush
    site with no frame truncates ``hbm``."""
    fault(spec)
    ck = _ck(sub_batch=512)
    if spec.startswith("fpset_fail"):
        with pytest.raises(RuntimeError, match="probe overflow"):
            ck.run()
    else:
        r = ck.run()
        assert r.truncated and r.stop_reason == "hbm"


@pytest.mark.parametrize("budget", [0.0, 1e-6])
@pytest.mark.parametrize("fuse", ["level", "stage"])
def test_time_budget_truncates(budget, fuse, tmp_path, jax_full):
    r = _ck(time_budget_s=budget, fuse=fuse,
            checkpoint_path=str(tmp_path / "f.npz")).run()
    assert r.truncated and r.stop_reason == "time_budget"
    assert 0 < r.distinct_states < 45198
    sizes = r.level_sizes
    assert sizes[:-1] == jax_full[0][: len(sizes) - 1]
    assert sizes[-1] <= jax_full[0][len(sizes) - 1]
    assert os.path.exists(tmp_path / "f.npz")  # a budget stop frames


# ---- the frontier row window -------------------------------------------


FW = dict(sub_batch=256, visited_cap=1 << 16, rows_window="frontier",
          row_cap_states=1 << 13)


@pytest.fixture(scope="module")
def jax_frontier():
    ck = JChecker(JModel(pe.SHIPPED_CFG), **FW)
    r = ck.run()
    nv = r.distinct_states
    return (r.level_sizes, np.asarray(ck.last_bufs["parent"][:nv]),
            np.asarray(ck.last_bufs["lane"][:nv]))


@pytest.mark.parametrize("fuse", ["level", "stage"])
def test_frontier_window_equals_jax(fuse, jax_frontier, tmp_path):
    ck = _ck(fuse=fuse, **FW)
    r = ck.run()
    assert (r.distinct_states, r.diameter) == (45198, 20)
    assert r.level_sizes == jax_frontier[0]
    par, lane = ck.merged_logs()
    assert np.array_equal(par, jax_frontier[1])
    assert np.array_equal(lane, jax_frontier[2])
    assert ck._row_base > 0  # the window slid
    # a frame of the window only, and its resume
    path = str(tmp_path / "f.npz")
    _ck(fuse=fuse, checkpoint_path=path, checkpoint_every=4,
        max_states=9_000, **FW).run()
    assert int(np.load(path)["rows_lo"]) > 0
    ck = _ck(fuse=fuse, checkpoint_path=path, **FW)
    r = ck.run(resume=True)
    assert r.level_sizes == jax_frontier[0]
    assert np.array_equal(ck.merged_logs()[0], jax_frontier[1])


@pytest.mark.parametrize("fuse", ["level", "stage"])
def test_frontier_window_row_window_stop(fuse, jax_full):
    """A window too small for a mid-BFS level: both engines count that
    level to its end, then stop ``row_window``; the counts are a prefix
    of the full run's."""
    kw = dict(sub_batch=64, visited_cap=1 << 16, rows_window="frontier",
              row_cap_states=1 << 10)
    jr = JChecker(JModel(pe.SHIPPED_CFG), **kw).run()
    r = _ck(fuse=fuse, **kw).run()
    for res in (jr, r):
        assert res.truncated and res.stop_reason == "row_window"
        assert res.level_sizes == jax_full[0][: len(res.level_sizes)]
    with pytest.raises(ValueError, match="mutually exclusive"):
        _ck(hbm_budget="1G", **kw)


# ---- the tiered store: fused handoff, durable spill, ENOSPC ---------------


TKW = dict(sub_batch=64, visited_cap=1 << 10, invariants=())


def _handoff_budget():
    """A budget whose hot table tops out at 2^14 slots: a few fused
    levels, then the handoff."""
    p = _ck(hbm_budget="1T", **TKW)
    return int(p._device_bytes_est(1 << 14, 1 << 13, 1 << 13)
               / (1 - HBM_HEADROOM)) + 64


def test_tiered_fused_handoff_equals_jax_untiered(jax_full):
    ck = _ck(hbm_budget=_handoff_budget(), **TKW)
    r = ck.run()
    st = ck.last_stats
    assert st["fused_levels_before_handoff"] >= 1
    assert st["handoff_level"] is not None
    assert st["spill_evictions"] >= 1 and st["spill_rows_evicted"] > 0
    _same_as_full(ck, r, jax_full)


def test_durable_spill_preempt_resume_and_torn_file(fault, tmp_path,
                                                    jax_full):
    """A checkpointed tiered run spills durably; preempted, its frame
    embeds the manifest, and the resume equals the untiered run.  A torn
    spill file is refused."""
    path = str(tmp_path / "f.npz")
    b = _handoff_budget()
    fault("sigterm@level:12")
    ck = _ck(hbm_budget=b, checkpoint_path=path, **TKW)
    r1 = ck.run()
    assert r1.truncated and r1.stop_reason == "preempted"
    assert ck.last_stats["spill_durable"]
    d = np.load(path)
    assert "spill_manifest" in d and int(d["rows_lo"]) > 0
    spill = path + ".spill"
    files = sorted(os.listdir(spill))
    assert any(f.endswith(".ptsk") for f in files)
    fault(None)
    ck = _ck(hbm_budget=b, checkpoint_path=path, **TKW)
    _same_as_full(ck, ck.run(resume=True), jax_full)
    victim = os.path.join(spill, [f for f in files
                                  if f.endswith(".ptsk")][0])
    with open(victim, "r+b") as f:
        f.write(b"\x00\x00\x00")
    with pytest.raises(ValueError, match="digest mismatch"):
        _ck(hbm_budget=b, checkpoint_path=path, **TKW).run(resume=True)


def test_spill_enospc_truncates_honestly(fault, tmp_path, jax_full):
    fault("enospc@spill:1")
    ck = _ck(hbm_budget=_handoff_budget(),
             checkpoint_path=str(tmp_path / "f.npz"), **TKW)
    r = ck.run()
    assert r.truncated and r.stop_reason == "spill_enospc"
    assert ck.last_stats["spill_degraded"] is True
    assert 0 < r.distinct_states < 45198
    assert r.level_sizes == jax_full[0][: len(r.level_sizes)]


# ---- liveness and simulation ---------------------------------------------


LIVE = dataclasses.replace(SMALL_CONFIGS["producer_on"], model_consumer=True)
LKW = dict(frontier_chunk=256, visited_cap=1 << 12, sweep_chunk=256)


@pytest.fixture(scope="module")
def jax_live():
    r = JLive(JModel(LIVE), fairness="wf_next", **LKW).run()
    return r.holds, r.reason, r.lasso_prefix, r.lasso_cycle


@pytest.mark.parametrize("spec", ["sigterm@sweep:3", "sigterm@level:4"])
def test_liveness_preempt_and_resume(spec, fault, tmp_path, jax_live):
    """Preempted in the sweep (a sweep frame: rows and edges so far) or
    in the exploration (the checker's frame), the resume gives the JAX
    engine's verdict and lasso."""
    path = str(tmp_path / "l.npz")
    fault(spec)
    lr = LivenessChecker(_port(LIVE), fairness="wf_next", device="cpu",
                         checkpoint_path=path, checkpoint_every=2,
                         **LKW).run()
    assert lr.truncated and lr.stop_reason == "preempted"
    assert "resumable frame is on disk" in lr.reason
    fault(None)
    lck = LivenessChecker(_port(LIVE), fairness="wf_next", device="cpu",
                          checkpoint_path=path, **LKW)
    r = lck.run(resume=True)
    assert not r.truncated
    assert (r.holds, r.reason, r.lasso_prefix, r.lasso_cycle) == jax_live
    if "sweep" in spec:
        assert lck.last_stats["edges"] > 0


SIM = dict(n_walkers=64, depth=16, segment_len=4, seed=0, device="cpu")


@pytest.mark.parametrize("inv", [(), (LEAK,)])
def test_simulation_resume_is_the_same_walk(inv, fault, tmp_path):
    """Preempted at a segment and resumed, the walk is the uninterrupted
    one: the same walk digest and counters, the same bug trace."""
    kw = dict(SIM, invariants=inv, max_rounds=8)
    full = StreamingSimulator(_port(), **kw).run()
    cut = max(1, full.segments - 3)
    path = str(tmp_path / "s.npz")
    fault(f"sigterm@segment:{cut}")
    a = StreamingSimulator(_port(), checkpoint_path=path,
                           checkpoint_every=2, **kw).run()
    assert a.truncated and a.stop_reason == "preempted"
    fault(None)
    b = StreamingSimulator(_port(), checkpoint_path=path,
                           **dict(kw, max_rounds=None)).run(resume=True)
    assert b.stats["sim_walk_digest"] == full.stats["sim_walk_digest"]
    for f in ("violation", "trace", "trace_actions", "steps",
              "states_visited", "violation_walker", "violation_step",
              "verified"):
        assert getattr(b, f) == getattr(full, f), f
    if inv:
        assert b.violation == LEAK and b.verified


def test_simulation_frame_digest_refused(tmp_path):
    path = str(tmp_path / "s.npz")
    StreamingSimulator(_port(), checkpoint_path=path, checkpoint_every=1,
                       invariants=(), max_steps=64 * 8, **SIM).run()
    d = dict(np.load(path))
    d["epoch"] = np.int64(int(d["epoch"]) + 1)
    np.savez(path, **d)
    with pytest.raises(ValueError, match="keys-digest mismatch"):
        StreamingSimulator(_port(), checkpoint_path=path, invariants=(),
                           **SIM).run(resume=True)


# ---- the CLI: two kill drills, lines equal the JAX CLI's ------------------


def _lines(out, *prefixes):
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


def _kill(tmp_path, *extra):
    """``check ... -cpu -checkpoint F`` killed at level 8 in a
    subprocess: exit 137 with a frame on disk."""
    path = str(tmp_path / "k.npz")
    env = dict(os.environ, PTT_FAULT="kill@level:8",
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli", "check",
         SPEC, "-cpu", "-checkpoint", path, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 137, (p.stdout, p.stderr)
    assert "kill@level:8" in p.stderr and os.path.exists(path)
    return path


@pytest.mark.parametrize("extra,keep", [
    ((), ("45198 distinct", "WARNING", "Error")),
    (("-invariant", LEAK),
     ("Error:", "The behavior", "State ", "/\\ ", "WARNING")),
])
def test_cli_kill_then_recover_equals_jax(extra, keep, tmp_path, capsys):
    path = _kill(tmp_path, *extra)
    rc = cli.main(["check", SPEC, "-cpu", "-checkpoint", path, "-recover",
                   *extra])
    out = capsys.readouterr().out
    jpath = str(tmp_path / "j.npz")
    jrc = jcli.main(["check", SPEC, "-checkpoint", jpath, *extra])
    jout = capsys.readouterr().out
    assert rc == jrc == (1 if extra else 0)
    want = _lines(jout, *keep)
    assert want and _lines(out, *keep) == want


def test_cli_recover_without_frame_refused(tmp_path, capsys):
    missing = str(tmp_path / "none.npz")
    argv = ["check", SPEC, "-checkpoint", missing, "-recover"]
    with pytest.raises(SystemExit) as e:
        cli.main(argv[:2] + ["-cpu"] + argv[2:])
    with pytest.raises(SystemExit) as je:
        jcli.main(argv)
    assert str(e.value) == str(je.value) == (
        "tpu-tlc: -recover needs an existing -checkpoint file "
        f"(got: {missing})")
    capsys.readouterr()


def test_cli_truncation_lines_equal_jax(tmp_path, capsys):
    argv = ["check", SPEC, "-maxstates", "10000", "-checkpoint"]
    rc = cli.main(argv + [str(tmp_path / "a.npz"), "-cpu"])
    out = capsys.readouterr().out
    jrc = jcli.main(argv + [str(tmp_path / "b.npz")])
    jout = capsys.readouterr().out
    assert rc == jrc == 3
    assert _lines(out, "WARNING") == _lines(jout, "WARNING") != []


def test_compiled_model_frames_and_resume(tmp_path):
    """A compiled model (``frontend/codegen.py``) checkpoints through the
    same engine: its frame's model identity is the JAX ``_model_sig`` of
    the JAX ``CompiledSpec`` of the same spec, and a truncated run
    resumes to the uninterrupted run state for state."""
    from pulsar_tlaplus_tpu.frontend import codegen as jcg
    from pulsar_tlaplus_tpu.tune.profiles import model_sig as jsig
    from pulsar_tlaplus_tpu_torch.frontend import codegen as tcg
    from pulsar_tlaplus_tpu_torch.utils import ckpt
    from tests.test_torch_codegen import _bind, _invariants

    js, ts = _bind("bookkeeper", {})
    inv = _invariants("bookkeeper")
    cs = tcg.CompiledSpec(ts, invariants=inv, device="cpu")
    assert ckpt.model_sig(cs) == jsig(jcg.CompiledSpec(js, invariants=inv))
    kw = dict(device="cpu", sub_batch=64)
    full = DeviceChecker(cs, **kw)
    rf = full.run()
    path = str(tmp_path / "c.npz")
    r1 = DeviceChecker(cs, checkpoint_path=path, checkpoint_every=2,
                       max_states=200, **kw).run()
    assert r1.truncated and r1.stop_reason == "max_states"
    ck = DeviceChecker(cs, checkpoint_path=path, **kw)
    r2 = ck.run(resume=True)
    assert (r2.distinct_states, r2.level_sizes) == (297, rf.level_sizes)
    for a, b in zip(ck.merged_logs(), full.merged_logs()):
        assert np.array_equal(a, b)
    assert np.array_equal(ck.merged_rows(), full.merged_rows())
