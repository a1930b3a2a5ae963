"""The port's tuner (``pulsar_tlaplus_tpu_torch/tune/``) on the CPU,
against the JAX package's ``tune/`` on the same inputs:

- the knob space equals the JAX space less the knobs the port drops
  (the three ``*_impl`` kernel routes and the searched
  ``fpset_dense_rounds``), in order, untiered and tiered;
- the predictions equal the JAX ones (relative 1e-9) for every candidate
  that moves no dense rounds, and the port's own dense rule is pinned;
- the online controller gives the JAX controller's adjustments on 200
  seeded observation sequences;
- profiles round-trip; corrupt, stale, wrong-engine, mismatched and
  foreign-knob files are warned about and ignored; a profile is never
  applied to another config, and a JAX-written profile never resolves in
  the port, nor the reverse, in one shared ``PTT_TUNE_DIR``;
- explicit knobs win over a profile in ``DeviceChecker``,
  ``LivenessChecker`` and the simulator;
- tuned and adapted runs find the default run's states in its order:
  both counterexamples, and the producer-on config against the JAX
  engine log for log, its stream valid under both validators;
- the tiled flush at ``dense_rounds`` 16 and a two-stage schedule equals
  the JAX tiled flush;
- ``cli tune`` end to end, then ``check`` resolving its profile, and the
  ``-no-profile`` / ``-adapt`` / ``-no-adapt`` flags reaching the engine.

Tolerance: exact equality, except the predictions (relative 1e-9)."""

import dataclasses
import importlib.util
import io
import json
import os
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.bookkeeper import (
    BookkeeperConstants as JBkConstants,
)
from pulsar_tlaplus_tpu.models.bookkeeper import BookkeeperModel as JBkModel
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ops import fpset as jfpset
from pulsar_tlaplus_tpu.ops import tiles as jtiles
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu.tune import online as jonline
from pulsar_tlaplus_tpu.tune import predict as jpredict
from pulsar_tlaplus_tpu.tune import profiles as jprofiles
from pulsar_tlaplus_tpu.tune import space as jspace
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.models.registry import COMPILED
from pulsar_tlaplus_tpu_torch.obs import schema
from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.dedup import from_jax_arrays
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
from pulsar_tlaplus_tpu_torch.tune import online, predict, profiles, space
from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod
from tests.helpers import SMALL_CONFIGS, assert_valid_counterexample

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
# the bench's scaled binding (bench.py:66-77): W = 20, A = 34
SCALED = dict(message_sent_limit=64, num_keys=8, max_crash_times=3,
              model_producer=True)
DROPPED = ("probe_impl", "expand_impl", "sieve_impl", "fpset_dense_rounds")
# a reference measurement shared by both predictors
REF = {
    "backend": "cpu",
    "work": {"expand_rows": 50_000, "probe_lanes": 800_000,
             "compact_elems": 800_000, "append_rows": 45_000,
             "init_lanes": 1},
    "level_sizes": [1, 4, 30, 200, 1500, 9000, 20000, 14000, 500],
    "sub_batch": 8192, "fuse_group": 8, "flush_factor": 1, "group": 4,
    "A": 16, "dense_rounds": 4, "stages": ((4, 16), (16, 64)),
    "avg_probe_rounds": 1.7,
    "spill_bytes_raw": 40_000_000, "spill_bytes_comp": 15_000_000,
    "spill_misses_resolved": 300_000, "spill_compress": True,
    "miss_batch": 1 << 15,
}
CAL = {"units": {"expand_row_ns": 900.0, "probe_lane_ns": 30.0,
                 "compact_elem_ns": 9.0, "append_row_ns": 60.0,
                 "init_lane_ns": 200.0},
       "source": "test"}


@pytest.fixture(autouse=True)
def _isolated_profiles(tmp_path, monkeypatch):
    """Each test its own empty profile store (one for both packages):
    a stray ~/.ptt_profiles never shapes a run here."""
    monkeypatch.setenv(profiles.TUNE_DIR_ENV, str(tmp_path / "profiles"))
    monkeypatch.delenv(online.ADAPT_ENV, raising=False)


@pytest.fixture(scope="module")
def jax_validator():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema",
        os.path.join(ROOT, "scripts", "check_telemetry_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_cfg(c):
    return tpe.Constants(**dataclasses.asdict(c))


def _bk():
    m, _ = COMPILED["bookkeeper"](cfgmod.load(os.path.join(
        SPECS, "bookkeeper.cfg")))
    return m


def _save(model, knobs, engine="device_bfs", invariants=None, **kw):
    invs = (tuple(model.default_invariants) if invariants is None
            else invariants)
    sig = profiles.profile_key(model=model, invariants=invs, engine=engine,
                               backend="cpu", **kw)
    profiles.save(profiles.build(sig=sig, engine=engine, backend="cpu",
                                 knobs=knobs, spec="test"))
    return sig


def _events(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


# ---- the knob space and the predictions --------------------------------


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("base", [8192, 1 << 16])
def test_space_equals_jax_less_the_dropped_knobs(spill, base):
    c = dataclasses.replace(pe.SHIPPED_CFG, **SCALED)
    got = space.candidates(CompactionModel(_port_cfg(c)), base, spill=spill)
    want = [x for x in jspace.candidates(JModel(c), base, spill=spill)
            if not set(x) & set(DROPPED)]
    assert got == want and got[0] == {}
    assert space.describe({}) == "defaults"
    assert space.sim_candidates() == jspace.sim_candidates()
    assert len(space.candidates(CompactionModel(_port_cfg(c)), base,
                                limit=7)) == 7


def test_predictions_equal_jax():
    cands = space.candidates(CompactionModel(tpe.SHIPPED_CFG), 8192,
                             spill=True)
    cands += [dict(x, compact_impl="sort") for x in cands[:20]]
    for cal in (CAL, dict(CAL, rtt_s=0.003, link_bytes_per_s=5e8)):
        for cand in cands:
            g = predict.predict_candidate(cand, REF, cal)
            w = jpredict.predict_candidate(cand, REF, cal)
            assert g["est_s"] == pytest.approx(w["est_s"], rel=1e-9)
            for k in ("dispatches", "overhead_s", "spill_s", "est_work"):
                assert g[k] == w[k], k
        order = [space.describe(c) for c, _ in predict.rank(cands, REF, cal)]
        assert order == [space.describe(c) for c, _
                         in jpredict.rank(cands, REF, cal)]
    sref = {"backend": "cpu", "A": 7, "n_inv": 3, "depth": 64,
            "total_steps": 1 << 20, "n_walkers": 1024, "segment_len": 32}
    for cand in space.sim_candidates():
        g = predict.predict_sim_candidate(cand, sref, CAL)
        w = jpredict.predict_sim_candidate(cand, sref, CAL)
        assert g["est_s"] == pytest.approx(w["est_s"], rel=1e-9)
        assert g["dispatches"] == w["dispatches"]


def test_dense_rule_prices_the_tiled_flush():
    """K1 runs max(TILE_R, dense) rounds: no change up to TILE_R, the
    flush's lanes scale with K1's rounds above it; stages cost nothing."""
    assert predict.TILE_R == tiles.TILE_R
    base = predict.predict_candidate({}, REF, CAL)
    for d in (2, 4, 8):
        p = predict.predict_candidate({"fpset_dense_rounds": d}, REF, CAL)
        assert p["est_work"]["probe_lanes"] == REF["work"]["probe_lanes"]
        assert p["est_s"] == base["est_s"]
    p16 = predict.predict_candidate({"fpset_dense_rounds": 16}, REF, CAL)
    assert p16["est_work"]["probe_lanes"] == 2 * REF["work"]["probe_lanes"]
    assert p16["est_s"] > base["est_s"]
    back = predict.predict_candidate({"fpset_dense_rounds": 4},
                                     dict(REF, dense_rounds=16), CAL)
    assert back["est_work"]["probe_lanes"] == REF["work"]["probe_lanes"] // 2
    staged = predict.predict_candidate(
        {"fpset_stages": ((4, 8), (8, 32))}, REF, CAL)
    assert staged["est_s"] == base["est_s"]
    # the JAX pricing moves with dense 2, the port's does not
    deep = dict(REF, avg_probe_rounds=3.0)
    j2 = jpredict.predict_candidate({"fpset_dense_rounds": 2}, deep, CAL)
    assert j2["est_s"] != jpredict.predict_candidate({}, deep, CAL)["est_s"]
    assert predict.predict_candidate({"fpset_dense_rounds": 2}, deep,
                                     CAL) == predict.predict_candidate(
                                         {}, deep, CAL)
    # and the port's "cuda" fallbacks name the card, with no "tpu" entry
    assert "tpu" not in predict.DEFAULT_DISPATCH_S
    assert "tpu" not in predict.DEFAULT_LINK_BYTES_S
    assert "H100" in predict.CUDA_LINK_SOURCE


def test_online_controller_equals_jax():
    rng = np.random.default_rng(13)
    moved = 0
    for _ in range(200):
        rmax = int(rng.integers(1, 17))
        dense = int(rng.choice([2, 4, 8, 16]))
        lim = int(rng.integers(8, 80))
        stages = ((4, lim // 2 + 1), (16, lim))
        a = online.OnlineController(rmax, dense, stages)
        b = jonline.OnlineController(rmax, dense, stages)
        mx = int(rng.integers(1, 6))
        for _step in range(int(rng.integers(5, 40))):
            asked = int(rng.integers(1, rmax + 1))
            closed = int(rng.integers(0, asked + 1))
            mx += int(rng.integers(0, 4)) * int(rng.random() < 0.3)
            kw = dict(levels_closed=closed, cap_asked=asked,
                      max_probe_rounds=mx)
            assert a.observe(**kw) == b.observe(**kw)
        assert (a.fuse_cap, a.dense, a.adjustments) == (
            b.fuse_cap, b.dense, b.adjustments)
        moved += bool(a.adjustments)
    assert moved > 100
    for env, want in (("0", False), ("1", True), ("x", None)):
        os.environ[online.ADAPT_ENV] = env
        try:
            assert online.env_override() is want
            for explicit in (None, True, False):
                for prof in (True, False):
                    assert online.resolve_adapt(explicit, prof) == \
                        jonline.resolve_adapt(explicit, prof)
        finally:
            del os.environ[online.ADAPT_ENV]


# ---- profiles ------------------------------------------------------------


def test_profile_round_trip_and_validation(tmp_path):
    m = _bk()
    sig = _save(m, {"fuse_group": 4, "fpset_stages": [[4, 8], [8, 32]],
                    "adapt": True})
    path = profiles.path_for(sig)
    assert schema.validate_profile_file(path) == []
    prof = profiles.load(sig, engine="device_bfs")
    assert profiles.knobs_for(prof, "device_bfs") == {
        "fuse_group": 4, "fpset_stages": ((4, 8), (8, 32)), "adapt": True}
    assert profiles.resolve(path, model=m,
                            invariants=tuple(m.default_invariants),
                            backend="cpu")["sig"] == sig
    # keys: engine, invariants, backend and the tiered regime all split
    inv = tuple(m.default_invariants)
    keys = {profiles.profile_key(model=m, invariants=inv, backend="cpu"),
            profiles.profile_key(model=m, invariants=inv, backend="cuda"),
            profiles.profile_key(model=m, invariants=inv[:1],
                                 backend="cpu"),
            profiles.profile_key(model=m, invariants=inv, backend="cpu",
                                 tiered=True),
            profiles.profile_key(model=m, invariants=inv, backend="cpu",
                                 engine="liveness")}
    assert len(keys) == 5
    bad = {"profile_v": 1, "sig": "x", "engine": "device_bfs",
           "backend": "cpu",
           "knobs": {"probe_impl": "tile", "sub_batch": 0,
                     "compact_impl": "zip", "hbm_headroom": 1.5,
                     "fpset_stages": [[1, 4]], "adapt": "yes"}}
    errs = profiles.validate(bad)
    for frag in ("unknown knob 'probe_impl'", "'sub_batch' must be",
                 "compact_impl must", "hbm_headroom must", "fpset_stages",
                 "adapt must"):
        assert any(frag in e for e in errs), frag
    with pytest.raises(ValueError):
        profiles.save(bad)
    # the schema script's --profile front end
    spec = importlib.util.spec_from_file_location(
        "tcs", os.path.join(ROOT, "scripts",
                            "torch_check_telemetry_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--profile", path]) == 0
    other = tmp_path / "renamed.json"
    other.write_text(open(path).read())
    assert mod.main(["--profile", str(other)]) == 1


@pytest.mark.parametrize("how", ["corrupt", "stale", "engine", "sig",
                                 "foreign_knob"])
def test_bad_profiles_warned_and_ignored(how, capsys):
    m = _bk()
    inv = tuple(m.default_invariants)
    sig = profiles.profile_key(model=m, invariants=inv, backend="cpu")
    os.makedirs(profiles.profiles_dir(), exist_ok=True)
    good = profiles.build(sig=sig, engine="device_bfs", backend="cpu",
                          knobs={"fuse_group": 2})
    if how == "corrupt":
        text = "{not json"
    else:
        p = dict(good)
        if how == "stale":
            p["profile_v"] = 0
        elif how == "engine":
            p["engine"] = "sim"
            p["knobs"] = {"n_walkers": 64}
        elif how == "sig":
            p["sig"] = "0" * 16
        else:
            p["knobs"] = {"fuse_group": 2, "expand_impl": "tile"}
        text = json.dumps(p)
    with open(profiles.path_for(sig), "w") as f:
        f.write(text)
    ck = DeviceChecker(m, profile="auto", device="cpu")
    assert ck.profile_sig is None and ck.RMAX == 8
    assert "tuned profile ignored" in capsys.readouterr().err


def test_profiles_never_cross_configs_or_packages(capsys):
    m = _bk()
    inv = tuple(m.default_invariants)
    _save(m, {"fuse_group": 2})
    # another binding of the same spec: another key, nothing applied
    c1 = CompactionModel(tpe.SHIPPED_CFG)
    c2 = CompactionModel(_port_cfg(SMALL_CONFIGS["no_retain"]))
    _save(c1, {"fuse_group": 2}, invariants=())
    assert DeviceChecker(c1, invariants=(), profile="auto",
                         device="cpu").RMAX == 2
    ck = DeviceChecker(c2, invariants=(), profile="auto", device="cpu")
    assert ck.profile_sig is None and ck.RMAX == 8
    m2 = c2
    # a caller-passed profile of another config: warned, ignored
    prof = profiles.load(profiles.profile_key(model=m, invariants=inv,
                                              backend="cpu"))
    assert profiles.resolve(prof, model=m2, invariants=inv,
                            backend="cpu") is None
    assert "do not match" in capsys.readouterr().err
    # the JAX package's profile of the same model, in the same directory
    jm = JBkModel(JBkConstants())
    jsig = jprofiles.profile_key(model=jm, invariants=inv,
                                 engine="device_bfs", backend="cpu")
    jprofiles.save(jprofiles.build(sig=jsig, engine="device_bfs",
                                   backend="cpu", knobs={"fuse_group": 4}))
    psig = profiles.profile_key(model=m, invariants=inv, backend="cpu")
    assert jsig != psig
    os.remove(profiles.path_for(psig))
    assert profiles.resolve("auto", model=m, invariants=inv,
                            backend="cpu") is None
    # renamed under the port's key: the embedded sig refuses it
    with open(jprofiles.path_for(jsig)) as f:
        jtext = f.read()
    with open(profiles.path_for(psig), "w") as f:
        f.write(jtext)
    assert profiles.resolve("auto", model=m, invariants=inv,
                            backend="cpu") is None
    os.remove(profiles.path_for(psig))
    os.remove(jprofiles.path_for(jsig))
    # the reverse: the port's profile never resolves in the JAX package
    _save(m, {"fuse_group": 2})
    assert jprofiles.resolve("auto", model=jm, invariants=inv) is None
    with open(profiles.path_for(psig)) as f:
        ptext = f.read()
    with open(jprofiles.path_for(jsig), "w") as f:
        f.write(ptext)
    assert jprofiles.resolve("auto", model=jm, invariants=inv) is None
    assert "tuned profile ignored" in capsys.readouterr().err


# ---- the engines resolve profiles; explicit knobs win -----------------


def test_device_checker_resolves_profile_explicit_wins(tmp_path):
    m = _bk()
    sig = _save(m, {"fuse_group": 2, "sub_batch": 512,
                    "fpset_dense_rounds": 16,
                    "fpset_stages": [[4, 8], [8, 32]], "adapt": True})
    stream = str(tmp_path / "run.jsonl")
    ck = DeviceChecker(m, profile="auto", device="cpu", telemetry=stream)
    assert ck.profile_sig == sig
    assert (ck.G, ck.RMAX, ck.fps_dense, ck.fps_stages, ck.adapt) == (
        512, 2, 16, ((4, 8), (8, 32)), True)
    assert set(ck.profile_applied) == {
        "fuse_group", "sub_batch", "fpset_dense_rounds", "fpset_stages"}
    r = ck.run()
    assert (r.distinct_states, r.diameter) == (297, 14)
    hd = _events(stream)[0]
    assert (hd["event"], hd["profile_sig"], hd["adapt"]) == (
        "run_header", sig, True)
    ck2 = DeviceChecker(m, profile="auto", device="cpu", fuse_group=8,
                        sub_batch=256, adapt=False)
    assert ck2.profile_sig == sig
    assert (ck2.RMAX, ck2.G, ck2.adapt, ck2.fps_dense) == (8, 256, False, 16)
    assert "fuse_group" not in ck2.profile_applied
    assert "sub_batch" not in ck2.profile_applied
    # no profile resolution unless asked (direct constructions)
    assert DeviceChecker(m, device="cpu").profile_sig is None


def test_liveness_and_simulator_resolve_their_profiles(tmp_path):
    m = _bk()
    lsig = _save(m, {"sweep_group": 2}, engine="liveness", invariants=())
    # the explorer's own device_bfs profile (it checks no invariant)
    _save(m, {"fuse_group": 3}, invariants=())
    stream = str(tmp_path / "live.jsonl")
    lck = LivenessChecker(m, goal="Termination", fairness="wf_next",
                          profile="auto", device="cpu", telemetry=stream)
    assert lck.profile_sig == lsig and lck.sweep_group == 2
    assert lck._checker.RMAX == 3
    r = lck.run()
    assert r.holds, r.reason
    hds = [e for e in _events(stream) if e["event"] == "run_header"]
    assert [h["profile_sig"] for h in hds
            if h["engine"] == "liveness"] == [lsig]
    lck2 = LivenessChecker(m, goal="Termination", profile="auto",
                           sweep_group=5, device="cpu")
    assert lck2.sweep_group == 5
    ssig = _save(m, {"n_walkers": 64, "segment_len": 8}, engine="sim")
    sim = StreamingSimulator(m, depth=32, device="cpu")  # "auto" default
    assert (sim.profile_sig, sim.B, sim.L) == (ssig, 64, 8)
    sim2 = StreamingSimulator(m, n_walkers=32, segment_len=16, depth=32,
                              device="cpu")
    assert (sim2.B, sim2.L) == (32, 16)
    sim3 = StreamingSimulator(m, depth=32, device="cpu", profile=None)
    assert (sim3.profile_sig, sim3.B) == (None, 1024)


# ---- tuning never changes the states found or their order ------------


@pytest.mark.parametrize("invariant,depth", [("CompactedLedgerLeak", 12),
                                             ("DuplicateNullKeyMessage", 4)])
def test_tuned_and_adapted_counterexamples_state_for_state(invariant,
                                                           depth):
    kw = dict(invariants=(invariant,), visited_cap=1 << 16, device="cpu")
    r_def = DeviceChecker(CompactionModel(tpe.SHIPPED_CFG), sub_batch=2048,
                          **kw).run()
    m = CompactionModel(tpe.SHIPPED_CFG)
    sig = _save(m, {"fuse_group": 2, "flush_factor": 2, "group": 2,
                    "sub_batch": 1024, "fpset_dense_rounds": 16,
                    "fpset_stages": [[4, 8], [8, 32]]},
                invariants=(invariant,))
    ck_t = DeviceChecker(m, profile="auto", **kw)
    assert ck_t.profile_sig == sig and ck_t.G == 2048
    r_tun = ck_t.run()
    ck_a = DeviceChecker(CompactionModel(tpe.SHIPPED_CFG), sub_batch=2048,
                         adapt=True, **kw)
    r_ada = ck_a.run()
    assert "tune_adjustments" in ck_a.last_stats
    for r in (r_tun, r_ada):
        assert r.violation == r_def.violation == invariant
        assert r.violation_gid == r_def.violation_gid
        assert r.diameter == r_def.diameter == depth
        assert r.trace == r_def.trace
        assert r.trace_actions == r_def.trace_actions
    assert_valid_counterexample(
        pe.SHIPPED_CFG, [pe.State(*s) for s in r_def.trace],
        r_def.trace_actions, invariant)


def _logs(ck, nv):
    return [np.asarray(ck.last_bufs[k][: nv * (ck.W if k == "rows" else 1)])
            .view(np.int32) for k in ("rows", "parent", "lane")]


def test_adapted_producer_on_equals_default_and_jax(tmp_path,
                                                    jax_validator):
    """The JAX test's producer-on binding (1,654 states): the adapted run
    equals the port's default run and the JAX engine log for log, moves
    a knob, writes a valid ``tune`` record a move and adds no read."""
    c = SMALL_CONFIGS["producer_on"]
    # windows of 64 rows: the ramp exits early twice in a row, so the
    # controller shrinks the cap
    kw = dict(sub_batch=64, visited_cap=1 << 13, device="cpu")
    ck_a = DeviceChecker(CompactionModel(_port_cfg(c)), **kw)
    r_a = ck_a.run()
    stream = str(tmp_path / "adapt.jsonl")
    ck_b = DeviceChecker(CompactionModel(_port_cfg(c)), adapt=True,
                         telemetry=stream, **kw)
    calls = []
    orig = ck_b._observe_tune

    def spy(out):
        calls.append(ck_b._host_syncs)
        orig(out)

    ck_b._observe_tune = spy
    r_b = ck_b.run()
    # the JAX logs do not depend on the window: its fastest one here
    jck = JChecker(JModel(c), sub_batch=512, visited_cap=1 << 13,
                   frontier_cap=1 << 12)
    jr = jck.run()
    nv = r_a.distinct_states
    assert nv == r_b.distinct_states == jr.distinct_states == 1654
    assert r_a.level_sizes == r_b.level_sizes == list(jr.level_sizes)
    jl = [np.asarray(jck.last_bufs[k][: nv * (jck.W if k == "rows"
                                              else 1)]).view(np.int32)
          for k in ("rows", "parent", "lane")]
    for name, a, b, j in zip(("rows", "parent", "lane"), _logs(ck_a, nv),
                             _logs(ck_b, nv), jl):
        assert np.array_equal(a, b) and np.array_equal(a, j), name
    evs = _events(stream)
    assert evs[0]["adapt"] is True
    tunes = [e for e in evs if e["event"] == "tune"]
    assert tunes and ck_b.last_stats["tune_adjustments"] == len(tunes)
    for e in tunes:
        assert e["knob"] in ("fuse_cap", "fpset_dense_rounds")
        if e["knob"] == "fuse_cap":
            assert 2 <= e["value"] <= ck_b.RMAX
        else:
            assert online.MIN_DENSE <= e["value"] <= online.MAX_DENSE
    assert schema.validate_stream(stream) == []
    assert jax_validator.validate_stream(stream) == []
    # the controller reads nothing: one observation a pass, each after
    # the pass's own read, and the same reads as the default run here
    assert calls == sorted(set(calls)) and len(calls) == ck_b._fused_n
    assert ck_b.last_stats["host_syncs"] == ck_a.last_stats["host_syncs"]
    # the kill switch beats an explicit ctor flag
    os.environ[online.ADAPT_ENV] = "0"
    try:
        assert DeviceChecker(CompactionModel(_port_cfg(c)), adapt=True,
                             **kw).adapt is False
    finally:
        del os.environ[online.ADAPT_ENV]


def test_flush_at_dense_16_equals_jax_tiled_flush():
    rng = np.random.default_rng(1616)
    cap, K, nq = 1 << 12, 2, 2000
    fill = tuple(rng.integers(0, 2**32, 1000, dtype=np.uint32)
                 for _ in range(K))
    tt = fpset.empty_cols(cap, K, "cpu")
    fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64)
    tt, _, _, fpm = tiles.flush_acc_tiles(tt, from_jax_arrays(*fill), 1000,
                                          fpm)
    jt = tuple(jnp.asarray(c.numpy().view(np.uint32)) for c in tt)
    jfpm = jnp.zeros((jfpset.FPM_N,), jnp.int32)
    fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64)
    stages = ((4, 8), (8, 32))
    for _ in range(2):
        pick = rng.integers(0, 1000, nq // 2)
        kcols = tuple(np.concatenate([f[pick], rng.integers(
            0, 2**32, nq - nq // 2, dtype=np.uint32)]) for f in fill)
        jt, jn, jflag, jfpm = jtiles.flush_acc_tiles(
            jt, tuple(jnp.asarray(c) for c in kcols), jnp.int32(nq - 7),
            jfpm, dense_rounds=16, stages=stages, probe_impl="tile")
        tt, n, flag, fpm = tiles.flush_acc_tiles(
            tt, from_jax_arrays(*kcols), nq - 7, fpm, None, 16, stages)
        assert n == int(jn) > 0
        assert np.array_equal(flag.numpy(), np.asarray(jflag).astype(bool))
        for g, w in zip(tt, jt):
            assert np.array_equal(g.numpy().view(np.uint32)[:cap],
                                  np.asarray(w)[:cap])
        assert fpm.tolist() == jfpset.fpm_logical(np.asarray(jfpm)).tolist()
    assert fpset.resolve_schedule(16, stages) == (16, stages)
    assert fpset.schedule_budget(16, stages) == 32
    with pytest.raises(ValueError):
        fpset.resolve_schedule(4, ((1, 8),))


# ---- the CLI -------------------------------------------------------------


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_tune_end_to_end_then_check_resolves(tmp_path):
    rc, out, err = _cli(["tune", "bookkeeper", "-cpu", "--top-k", "1",
                         "--repeat", "1", "--adapt"])
    assert rc == 0, err
    path = out.strip().splitlines()[-1].split("profile: ")[1]
    assert schema.validate_profile_file(path) == []
    with open(path) as f:
        prof = json.load(f)
    assert prof["engine"] == "device_bfs" and prof["backend"] == "cpu"
    assert prof["knobs"]["adapt"] is True
    assert prof["tuner"]["candidates_measured"] == 2
    assert "| defaults |" in out or "| defaults * |" in out
    spec = os.path.join(SPECS, "bookkeeper.tla")

    def header(*flags, spec=spec):
        s = str(tmp_path / f"h{len(flags)}.jsonl")
        rc, out, _err = _cli(["check", spec, "-cpu", "-telemetry", s,
                              *flags])
        assert rc == 0 and "297 distinct states found" in out
        return _events(s)[0]

    # a registry module name takes specs/<name>.cfg
    hd = header(spec="bookkeeper")
    assert (hd["profile_sig"], hd["adapt"]) == (prof["sig"], True)
    hd = header("-no-adapt")
    assert (hd["profile_sig"], hd["adapt"]) == (prof["sig"], False)
    hd = header("-no-profile", "-adapt", "-fuse-group", "3")
    assert (hd["profile_sig"], hd["adapt"], hd["fuse_group"]) == (
        None, True, 3)
    rc, out, err = _cli(["tune", "bookkeeper", "-cpu", "--mode",
                         "simulate", "--top-k", "1", "--repeat", "1",
                         "--sim-depth", "16", "--sim-steps", "4096"])
    assert rc == 0, err
    spath = out.strip().splitlines()[-1].split("profile: ")[1]
    with open(spath) as f:
        sprof = json.load(f)
    assert sprof["engine"] == "sim"
    assert schema.validate_profile_file(spath) == []
