"""The port's warm layer (``pulsar_tlaplus_tpu_torch/warm/``) against the
JAX package's (``pulsar_tlaplus_tpu/warm/``), on the CPU:

- the registry's monotone axes are the JAX registry's; the module
  digests are the port's own (never equal to the JAX package's);
- ``extract_field`` equals the JAX function on the same packed rows of
  every registry layout;
- ``plan`` gives the JAX planner's mode and reason on every row of the
  JAX fallback matrix (``tests/test_warm.py``), each package planning on
  manifests it built itself from the same cfgs;
- no artifact crosses between the packages: a JAX artifact in the port's
  store plans cold (``engine_config``), a port artifact in the JAX store
  plans cold;
- the reseed seed (subscription ``MaxCrashTimes`` 2 -> 3, bookkeeper's
  popcount axis 1 -> 2) built from a port artifact is array-equal to the
  JAX seed built from the JAX artifact of the same run; the reseeded run
  equals the JAX reseeded run log for log and reaches the port's cold
  run's state set;
- the store's LRU cap, digest verification and the ``--warm`` validator.

Tolerance: exact equality."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models import registry as jregistry
from pulsar_tlaplus_tpu.utils import cfg as jcfgmod
from pulsar_tlaplus_tpu.warm import plan as jplan
from pulsar_tlaplus_tpu.warm import store as jstore
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.models import registry
from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod
from pulsar_tlaplus_tpu_torch.warm import plan as warm_plan
from pulsar_tlaplus_tpu_torch.warm import store as warm_store

# one intra-op thread a process: the suite runs a process a core
torch.set_num_threads(1)

GEOM = dict(sub_batch=64, visited_cap=1 << 10, frontier_cap=1 << 8,
            max_states=1 << 18)
SUB_CFG = """
CONSTANTS
    MessageLimit = 2
    MaxCrashTimes = 2
SPECIFICATION Spec
INVARIANTS
"""
SUB_WIDE = SUB_CFG.replace("MaxCrashTimes = 2", "MaxCrashTimes = 3")
BK_CFG = """
CONSTANTS
    NumBookies = 3
    WriteQuorum = 2
    AckQuorum = 2
    EntryLimit = 2
    MaxBookieCrashes = 1
SPECIFICATION Spec
INVARIANTS
"""
BK_WIDE = BK_CFG.replace("MaxBookieCrashes = 1", "MaxBookieCrashes = 2")


@pytest.fixture(scope="module", autouse=True)
def _tune_dir(tmp_path_factory):
    """No stray tuned profile reshapes a run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PTT_TUNE_DIR", str(tmp_path_factory.mktemp("profiles")))
        mp.delenv("PTT_TUNE_ADAPT", raising=False)
        yield


def _model(pkg_registry, pkg_cfg, spec, text):
    tlc = pkg_cfg.parse_cfg(text)
    model, _ = pkg_registry.COMPILED[spec](tlc)
    return model, dict(tlc.constants)


def _artifact(root, spec, text, jax):
    """One clean run with a final frame, saved as a warm artifact by its
    own package: ``(store, adir, checker, result, constants)``."""
    os.makedirs(root, exist_ok=True)
    if jax:
        model, consts = _model(jregistry, jcfgmod, spec, text)
        ck = JChecker(model, invariants=(),
                      checkpoint_path=os.path.join(root, "frame.npz"),
                      **GEOM)
        store_mod, plan_mod = jstore, jplan
    else:
        model, consts = _model(registry, cfgmod, spec, text)
        ck = DeviceChecker(model, invariants=(), device="cpu",
                           checkpoint_path=os.path.join(root, "frame.npz"),
                           **GEOM)
        store_mod, plan_mod = warm_store, warm_plan
    ck.final_frame = True
    r = ck.run()
    store = store_mod.WarmStore(os.path.join(root, "store"))
    man = plan_mod.manifest_for(
        spec, consts, (), ck,
        {"distinct_states": r.distinct_states,
         "levels": len(r.level_sizes), "truncated": False,
         "stop_reason": None},
    )
    adir = store.save(os.path.join(root, "frame.npz"), man)
    assert adir and store.verify(adir)[0]
    return store, adir, ck, r, consts


@pytest.fixture(scope="module")
def sub_pair(tmp_path_factory):
    """The subscription (MaxCrashTimes 2) artifact of each package."""
    root = tmp_path_factory.mktemp("sub")
    return (_artifact(str(root / "port"), "subscription", SUB_CFG, False),
            _artifact(str(root / "jax"), "subscription", SUB_CFG, True))


# ---- registry ---------------------------------------------------------


def test_monotone_axes_equal_jax_and_digests_are_the_ports():
    assert set(registry.MONOTONE_AXES) == set(jregistry.MONOTONE_AXES)
    for spec, axes in registry.MONOTONE_AXES.items():
        want = [(a.constant, a.field, a.kind)
                for a in jregistry.MONOTONE_AXES[spec]]
        assert [(a.constant, a.field, a.kind) for a in axes] == want
        d = registry.module_digest(spec)
        assert d == registry.module_digest(spec) and len(d) == 64
        assert d != jregistry.module_digest(spec)
    with pytest.raises(ValueError):
        registry.MonotoneAxis("X", "x", kind="max")
    with pytest.raises(ValueError):
        registry.module_digest("nope")


@pytest.mark.parametrize("spec", sorted(registry.COMPILED))
def test_extract_field_equals_jax(spec):
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "specs", f"{spec}.cfg")
    text = open(cfg).read()
    model, _ = _model(registry, cfgmod, spec, text)
    jmodel, _ = _model(jregistry, jcfgmod, spec, text)
    assert warm_plan.layout_sig(model) == jplan.layout_sig(jmodel)
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 1 << 32, size=(257, model.layout.W),
                        dtype=np.uint64).astype(np.uint32)
    for f in model.layout._codec.fields:
        got = warm_plan.extract_field(model.layout, rows, f[0])
        want = jplan.extract_field(jmodel.layout, rows, f[0])
        assert got.dtype == want.dtype and np.array_equal(got, want), f[0]
    with pytest.raises(ValueError):
        warm_plan.extract_field(model.layout, rows, "no_such_field")


# ---- the fallback matrix ------------------------------------------------


def _copy(art, dst):
    store, adir = art[0], art[1]
    shutil.copytree(store.root, dst)
    mod = warm_store if isinstance(store, warm_store.WarmStore) else jstore
    return mod.WarmStore(dst), os.path.join(dst, os.path.basename(adir))


def _rewrite(store, adir, **mut):
    man = store.load_manifest(adir)
    man.update(mut)
    with open(os.path.join(adir, "manifest.json"), "w") as f:
        json.dump(man, f)


def _replan(plan_mod, reg, store, ck, constants, **over):
    kw = dict(spec="subscription", constants=constants, invariants=(),
              config_sig=ck._config_sig(),
              module_digest=reg.module_digest("subscription"),
              lsig=plan_mod.layout_sig(ck.model),
              n_initial=int(ck.model.n_initial), max_states=1 << 18,
              check_deadlock=True)
    kw.update(over)
    return plan_mod.plan(store, **kw)


BASE = {"MessageLimit": 2, "MaxCrashTimes": 2}
WIDE = {"MessageLimit": 2, "MaxCrashTimes": 3}
OTHER = "incoming-changed-config-sig"
MATRIX = [
    # (name, manifest mutations, constants, config_sig override,
    #  mode, reason) — the rows of the JAX test_fallback_matrix
    ("identical", {}, BASE, None, "continue", "sig_match"),
    ("widening", {}, WIDE, OTHER, "reseed", "widened:MaxCrashTimes"),
    ("module_edit", {"module_digest": "deadbeef"}, WIDE, OTHER,
     "cold", "module_edit"),
    ("module_edit_same_sig", {"module_digest": "deadbeef"}, BASE, None,
     "cold", "module_edit"),
    ("invariant_change", {"invariants": ["SomethingElse"]}, WIDE, OTHER,
     "cold", "invariant_change"),
    ("non_axis_binding", {}, {"MessageLimit": 3, "MaxCrashTimes": 2},
     OTHER, "cold", "binding_change"),
    ("narrowing", {}, {"MessageLimit": 2, "MaxCrashTimes": 1}, OTHER,
     "cold", "narrowed"),
    ("layout_step", {"layout_sig": "other-layout"}, WIDE, OTHER,
     "cold", "layout_change"),
    ("init_change", {"n_initial": 99}, WIDE, OTHER, "cold", "init_change"),
    ("rows_windowed", {"rows_all": False}, WIDE, OTHER,
     "cold", "rows_unavailable"),
    ("budget_narrowed_reseed", {"distinct_states": (1 << 18) + 1}, WIDE,
     OTHER, "cold", "budget_too_small"),
    ("deadlock_config", {"check_deadlock": False}, WIDE, OTHER,
     "cold", "engine_config"),
    ("engine_config_same_bindings", {}, BASE, OTHER,
     "cold", "engine_config"),
]


@pytest.mark.parametrize("case", MATRIX, ids=[c[0] for c in MATRIX])
def test_fallback_matrix_equals_jax(case, sub_pair, tmp_path):
    name, mut, constants, sig_over, mode, reason = case
    got = []
    for art, plan_mod, reg in ((sub_pair[0], warm_plan, registry),
                               (sub_pair[1], jplan, jregistry)):
        store, adir = _copy(art, str(tmp_path / plan_mod.__name__))
        if mut:
            _rewrite(store, adir, **mut)
        over = {"config_sig": sig_over} if sig_over else {}
        p = _replan(plan_mod, reg, store, art[2], constants, **over)
        got.append((p.mode, p.reason))
    assert got[0] == got[1] == (mode, reason)


def test_store_edges_equal_jax(sub_pair, tmp_path):
    """Budget below the artifact, version skew, a torn manifest, a
    tampered frame: the same answers from both packages."""
    answers = []
    for i, (art, plan_mod, reg, st_mod) in enumerate((
            (sub_pair[0], warm_plan, registry, warm_store),
            (sub_pair[1], jplan, jregistry, jstore))):
        got = []
        store, adir = _copy(art, str(tmp_path / f"bud{i}"))
        p = _replan(plan_mod, reg, store, art[2], BASE,
                    max_states=art[3].distinct_states - 1)
        got.append((p.mode, p.reason))
        store, adir = _copy(art, str(tmp_path / f"ver{i}"))
        _rewrite(store, adir, warm_v=st_mod.WARM_VERSION + 1)
        p = _replan(plan_mod, reg, store, art[2], BASE)
        got.append((p.mode, p.reason))
        store, adir = _copy(art, str(tmp_path / f"torn{i}"))
        mpath = os.path.join(adir, "manifest.json")
        blob = open(mpath).read()
        open(mpath, "w").write(blob[: len(blob) // 2])
        p = _replan(plan_mod, reg, store, art[2], BASE)
        got.append((p.mode, p.reason))
        got.append(len(store.sweep()))
        assert not os.path.isdir(adir)
        store, adir = _copy(art, str(tmp_path / f"tamper{i}"))
        fpath = os.path.join(adir, "frame.npz")
        raw = bytearray(open(fpath, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(fpath, "wb").write(bytes(raw))
        got.append(store.verify(adir))
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[0][0] == ("cold", "budget_too_small")
    assert answers[0][1][0] == answers[0][2][0] == "cold"
    assert answers[0][3] == 1
    assert answers[0][4] == (False, "digest_mismatch: frame.npz")


def test_no_artifact_crosses_packages(sub_pair, tmp_path):
    port, jax = sub_pair
    # a JAX artifact in the port's store: cold, engine_config, for the
    # identical binding and for a widening alike
    dst = str(tmp_path / "port_store")
    shutil.copytree(jax[0].root, dst)
    store = warm_store.WarmStore(dst)
    for constants in (BASE, WIDE):
        p = _replan(warm_plan, registry, store, port[2], constants)
        assert (p.mode, p.reason) == ("cold", "engine_config")
    # even under the port's own config signature (the continue path)
    jadir = os.path.join(dst, os.path.basename(jax[1]))
    forged = os.path.join(dst, warm_store.sig_key(port[2]._config_sig()))
    shutil.copytree(jadir, forged)
    _rewrite(store, forged, config_sig=port[2]._config_sig())
    p = _replan(warm_plan, registry, store, port[2], BASE)
    assert (p.mode, p.reason) == ("cold", "engine_config")
    assert warm_store.validate_artifact(jadir)  # no port tag
    # a port artifact in the JAX store: cold
    dst = str(tmp_path / "jax_store")
    shutil.copytree(port[0].root, dst)
    jst = jstore.WarmStore(dst)
    for constants in (BASE, WIDE):
        assert _replan(jplan, jregistry, jst, jax[2], constants).mode == \
            "cold"


# ---- reseed -------------------------------------------------------------


def _seed_equal(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert list(a[3]) == list(b[3])


def test_reseed_seed_and_run_equal_jax(sub_pair):
    (pstore, padir, _pck, pr, _), (jst, jadir, _jck, jr, _) = sub_pair
    model, _ = _model(registry, cfgmod, "subscription", SUB_WIDE)
    jmodel, _ = _model(jregistry, jcfgmod, "subscription", SUB_WIDE)
    widened = {"MaxCrashTimes": (2, 3)}
    seed, info = warm_plan.build_reseed_seed(
        padir, pstore.load_manifest(padir), model, widened)
    jseed, jinfo = jplan.build_reseed_seed(
        jadir, jst.load_manifest(jadir), jmodel, widened)
    _seed_equal(seed, jseed)
    assert info == jinfo and info["replay_rows"] >= 1
    assert info["reused_rows"] + info["replay_rows"] == pr.distinct_states
    ck = DeviceChecker(model, invariants=(), device="cpu", **GEOM)
    ck.extra_trace_depth = len(pr.level_sizes)
    r = ck.run(seed=seed)
    jck = JChecker(jmodel, invariants=(), **GEOM)
    jck.extra_trace_depth = len(jr.level_sizes)
    jrr = jck.run(seed=jseed)
    nv = r.distinct_states
    assert nv == jrr.distinct_states and r.level_sizes == jrr.level_sizes
    W = model.layout.W
    assert np.array_equal(ck.merged_rows()[: nv * W],
                          np.asarray(jck.last_bufs["rows"][: nv * W]))
    par, lane = ck.merged_logs()
    assert np.array_equal(par, np.asarray(jck.last_bufs["parent"][:nv]))
    assert np.array_equal(lane, np.asarray(jck.last_bufs["lane"][:nv]))
    # the reseeded state set is the cold run's
    cold = DeviceChecker(model, invariants=(), device="cpu", **GEOM)
    rc = cold.run()
    assert rc.distinct_states == nv and r.violation is rc.violation is None

    def rows_set(c):
        rows = c.merged_rows()[: nv * W].reshape(nv, W)
        return rows[np.lexsort(rows.T[::-1])]

    assert np.array_equal(rows_set(ck), rows_set(cold))


def test_reseed_seed_popcount_axis_equals_jax(tmp_path):
    port = _artifact(str(tmp_path / "port"), "bookkeeper", BK_CFG, False)
    jax = _artifact(str(tmp_path / "jax"), "bookkeeper", BK_CFG, True)
    model, wide = _model(registry, cfgmod, "bookkeeper", BK_WIDE)
    jmodel, _ = _model(jregistry, jcfgmod, "bookkeeper", BK_WIDE)
    assert warm_plan.layout_sig(model) == warm_plan.layout_sig(port[2].model)
    p = _replan(warm_plan, registry, port[0], DeviceChecker(
        model, invariants=(), device="cpu", **GEOM), wide,
        spec="bookkeeper",
        module_digest=registry.module_digest("bookkeeper"))
    assert (p.mode, p.reason) == ("reseed", "widened:MaxBookieCrashes")
    widened = {"MaxBookieCrashes": (1, 2)}
    seed, info = warm_plan.build_reseed_seed(
        port[1], port[0].load_manifest(port[1]), model, widened)
    jseed, jinfo = jplan.build_reseed_seed(
        jax[1], jax[0].load_manifest(jax[1]), jmodel, widened)
    _seed_equal(seed, jseed)
    assert info == jinfo and info["levels_reused"] >= 1


# ---- the store ----------------------------------------------------------


def test_store_lru_cap_and_validator(sub_pair, tmp_path):
    port = sub_pair[0]
    adir = port[1]
    man = port[0].load_manifest(adir)
    assert man["port"] == warm_store.PORT_TAG and man["warm_v"] == 1
    assert warm_store.validate_artifact(adir) == []
    assert warm_store.validate_artifact(
        os.path.join(adir, "manifest.json")) == []
    nbytes = port[0].entry_bytes(adir)
    # two artifacts under a cap that holds one: the older is evicted
    store = warm_store.WarmStore(str(tmp_path / "lru"),
                                 max_bytes=int(nbytes * 1.5))
    frame = os.path.join(adir, "frame.npz")
    a = store.save(frame, dict(man, config_sig="sig-a_torch_"))
    os.utime(os.path.join(a, "manifest.json"), (1, 1))
    b = store.save(frame, dict(man, config_sig="sig-b_torch_"))
    assert not os.path.isdir(a) and os.path.isdir(b)
    # an artifact larger than the cap is evicted at once
    tiny = warm_store.WarmStore(str(tmp_path / "tiny"), max_bytes=1)
    c = tiny.save(frame, dict(man))
    assert c and not os.path.isdir(c)
    # a tampered frame fails the validator
    raw = bytearray(open(os.path.join(b, "frame.npz"), "rb").read())
    raw[-100] ^= 1
    open(os.path.join(b, "frame.npz"), "wb").write(bytes(raw))
    assert any("digest mismatch" in e
               for e in warm_store.validate_artifact(b))
