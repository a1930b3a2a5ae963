"""The port's subscription, bookkeeper and georeplication models against
the JAX package's, on the CPU:

- ``StructLayout`` packs and unpacks bit for bit as the JAX layout, on
  random canonical states (every element below ``2**width``, so
  state-dependent indices land out of range too: markDelete = M,
  lac = L, a cursor at P);
- ``successors`` (packed planes and ``valid``), every invariant and
  ``stutter_enabled`` equal the JAX model's under ``jax.vmap``, on those
  random states and on every reachable state of the shipped cfg;
- the engine, in both loops, finds the JAX ``DeviceChecker``'s states in
  its order (rows, parent and lane logs) at the shipped cfgs; the three
  seeded-bug counterexamples equal the JAX engine's in gid, depth,
  trace and actions; tiered runs at tight budgets equal the JAX
  untiered runs (one at K = 3 exact keys);
- ``cli check SPEC -cpu`` gives the oracle counts and, with the bug
  invariant, a TLC-style counterexample.

The configs are the JAX tests' ``CONFIGS`` plus the scaled bindings
that ``chip_smoke.py`` runs on the card (layouts only: their state
spaces are too large for the CPU).  Inputs come from
``numpy.random.default_rng``.  Tolerance: exact equality (integer
work)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models import bookkeeper as jbk
from pulsar_tlaplus_tpu.models import georeplication as jgeo
from pulsar_tlaplus_tpu.models import subscription as jsub
from pulsar_tlaplus_tpu.store.tiers import TieredStore as JStore
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.engine.device_bfs import (
    HBM_HEADROOM,
    DeviceChecker,
)
from pulsar_tlaplus_tpu_torch.models import bookkeeper as tbk
from pulsar_tlaplus_tpu_torch.models import georeplication as tgeo
from pulsar_tlaplus_tpu_torch.models import subscription as tsub
from pulsar_tlaplus_tpu_torch.store.tiers import TieredStore
from tests.test_bookkeeper import CONFIGS as BK_CONFIGS
from tests.test_georeplication import CONFIGS as GEO_CONFIGS
from tests.test_subscription import CONFIGS as SUB_CONFIGS

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")

# spec -> (JAX model class, port model class, port constants class)
SPEC_MODELS = {
    "subscription": (jsub.SubscriptionModel, tsub.SubscriptionModel,
                     tsub.SubscriptionConstants),
    "bookkeeper": (jbk.BookkeeperModel, tbk.BookkeeperModel,
                   tbk.BookkeeperConstants),
    "georeplication": (jgeo.GeoreplicationModel, tgeo.GeoreplicationModel,
                       tgeo.GeoConstants),
}

# (spec, name) -> JAX constants: the JAX tests' configs, the scaled
# bindings of chip_smoke.py, and a K = 3 exact-key binding small enough
# for the CPU (66 bits, W = 3, 7,056 states)
CONFIGS = {}
for _spec, _cfgs in (("subscription", SUB_CONFIGS),
                     ("bookkeeper", BK_CONFIGS),
                     ("georeplication", GEO_CONFIGS)):
    for _name, _c in _cfgs.items():
        CONFIGS[_spec, _name] = _c
CONFIGS["subscription", "scaled"] = jsub.SubscriptionConstants(
    message_limit=6, max_crash_times=3)
CONFIGS["bookkeeper", "scaled"] = jbk.BookkeeperConstants(
    num_bookies=4, write_quorum=3, ack_quorum=2, entry_limit=4,
    max_bookie_crashes=1)
CONFIGS["georeplication", "scaled_exact"] = jgeo.GeoConstants(
    num_clusters=3, publish_limit=2, max_replicator_crashes=2)
CONFIGS["georeplication", "scaled_hashed"] = jgeo.GeoConstants(
    num_clusters=4, publish_limit=2, max_replicator_crashes=1)
CONFIGS["georeplication", "k3"] = jgeo.GeoConstants(
    num_clusters=2, publish_limit=6, max_replicator_crashes=0)
IDS = [f"{s}-{n}" for s, n in CONFIGS]

# the seeded bugs: spec -> (invariant, config, trace length, actions)
BUGS = {
    "subscription": ("ExactlyOnceProcessing", "shipped", 7, [
        "Publish", "Deliver", "Process", "ConsumerCrash", "Deliver",
        "Process"]),
    "bookkeeper": ("ConfirmedEntryReadable", "crash2", 9, [
        "AddEntry", "WriteLand", "WriteLand", "AckArrive", "AckArrive",
        "AdvanceLAC", "BookieCrash", "BookieCrash"]),
    "georeplication": ("NoDuplicateDelivery", "shipped", 5, [
        "Publish", "Replicate", "ReplicatorCrash", "Replicate"]),
}
SHIPPED = {"subscription": (2272, 24), "bookkeeper": (297, 14),
           "georeplication": (6400, 18)}


def _models(spec, name):
    jcls, tcls, tconst = SPEC_MODELS[spec]
    c = CONFIGS[spec, name]
    return jcls(c), tcls(tconst(**dataclasses.asdict(c)))


def _random_states(jm, n, seed):
    """``n`` random canonical JAX states (numpy, batched): every element
    uniform in ``[0, 2**width)``."""
    rng = np.random.default_rng(seed)
    lay = jm.layout
    fields = []
    for (name, _n, width, *_r) in lay._codec.fields:
        shape, _ = lay.shapes[name]
        fields.append(rng.integers(0, 1 << width, size=(n, *shape),
                                   dtype=np.int64).astype(np.int32))
    return type(jm.gen_initial(jnp.int32(0)))(*fields)


def _words(t):
    return t.numpy().view(np.uint32)


def _jax_pack(jm, states, depth=1):
    fn = jm.layout.pack
    for _ in range(depth):
        fn = jax.vmap(fn)
    return np.asarray(jax.jit(fn)(states))


def _assert_same_model(jm, tm, jst):
    """successors (packed, valid), the invariants and stutter_enabled of
    the JAX states ``jst`` and their port counterparts."""
    tst = tm.from_jax_state(jst)
    jsucc, jvalid = jax.jit(jax.vmap(jm.successors))(jst)
    tsucc, tvalid = tm.successors(tst)
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert np.array_equal(_words(tm.layout.pack(tsucc)),
                          _jax_pack(jm, jsucc, depth=2))
    for inv, fn in jm.invariants.items():
        assert np.array_equal(tm.invariants[inv](tst).numpy(),
                              np.asarray(jax.jit(jax.vmap(fn))(jst))), inv
    assert np.array_equal(tm.stutter_enabled(tst).numpy(),
                          np.asarray(jax.vmap(jm.stutter_enabled)(jst)))
    for goal, fn in jm.liveness_goals.items():
        assert np.array_equal(tm.liveness_goals[goal](tst).numpy(),
                              np.asarray(jax.vmap(fn)(jst))), goal


@pytest.mark.parametrize("key", list(CONFIGS), ids=IDS)
def test_layout_pack_unpack_random(key):
    """The port's ``StructLayout`` packs as the JAX one, bit for bit, and
    unpack inverts pack; the model's protocol attributes agree."""
    jm, tm = _models(*key)
    assert (tm.layout.W, tm.layout.total_bits, tm.A) == (
        jm.layout.W, jm.layout.total_bits, jm.A)
    assert list(tm.action_ids) == list(jm.action_ids)
    assert tuple(tm.action_names) == tuple(jm.action_names)
    assert tuple(tm.default_invariants) == tuple(jm.default_invariants)
    assert tm.n_initial == jm.n_initial == 1
    jst = _random_states(jm, 257, seed=list(CONFIGS).index(key))
    tst = tm.from_jax_state(jst)
    words = tm.layout.pack(tst)
    assert np.array_equal(_words(words), _jax_pack(jm, jst))
    back = tm.layout.unpack(words)
    for f in tst._fields:
        assert torch.equal(getattr(back, f), getattr(tst, f)), f
    # an unbatched state is a batch of one; the Init state agrees
    init = tm.gen_initial(torch.zeros(3, dtype=torch.int64))
    assert np.array_equal(
        _words(tm.layout.pack(init)),
        np.repeat(np.asarray(jm.layout.pack(jm.gen_initial(jnp.int32(0))))
                  [None], 3, axis=0))
    one = tm.from_jax_state(jax.tree.map(lambda x: x[5], jst))
    assert torch.equal(tm.layout.pack(one)[0], words[5])


@pytest.mark.parametrize("key", list(CONFIGS), ids=IDS)
def test_successors_invariants_random(key):
    """Lane for lane on random canonical states, including the states
    where a lane's state-dependent index is out of range."""
    jm, tm = _models(*key)
    jst = _random_states(jm, 193, seed=100 + list(CONFIGS).index(key))
    _assert_same_model(jm, tm, jst)


# ---- the shipped cfgs through the JAX engine (one run each, shared)


def _jax_check(spec, name, sub_batch=256, fuse="level", **kw):
    jm, _tm = _models(spec, name)
    ck = JChecker(jm, sub_batch=sub_batch, visited_cap=1 << 12,
                  frontier_cap=1 << 12, fuse=fuse, **kw)
    return ck, ck.run()


@pytest.fixture(scope="module")
def jax_runs():
    """JAX engine runs, each made once for the module: the fused level
    (the default) for the shipped cfgs, which the sync counts are held
    to; the stage loop (it compiles less, and finds the same states in
    the same order) for the rest."""
    cache = {}

    def get(spec, name="shipped", invariants=None, sub_batch=256):
        key = (spec, name, invariants, sub_batch)
        if key not in cache:
            kw = {} if invariants is None else dict(invariants=invariants)
            fuse = "level" if (name, invariants) == ("shipped", None) \
                else "stage"
            cache[key] = _jax_check(spec, name, sub_batch, fuse, **kw)
        return cache[key]

    return get


@pytest.mark.parametrize("spec", sorted(SPEC_MODELS))
def test_successors_on_every_reachable_state(spec, jax_runs):
    """Every reachable state of the shipped cfg (the JAX engine's rows):
    packed as the JAX engine packed it, and the same successors,
    invariants and stutter flags."""
    jck, jr = jax_runs(spec)
    assert (jr.distinct_states, jr.diameter) == SHIPPED[spec]
    jm, tm = _models(spec, "shipped")
    nv, w = jr.distinct_states, jm.layout.W
    rows = np.asarray(jck.last_bufs["rows"][: nv * w]).reshape(nv, w)
    jst = jax.device_get(jax.jit(jax.vmap(jm.layout.unpack))(rows))
    assert np.array_equal(_words(tm.layout.pack(tm.from_jax_state(jst))),
                          rows)
    _assert_same_model(jm, tm, jst)


def _port(spec, name="shipped", **kw):
    _jm, tm = _models(spec, name)
    kw.setdefault("sub_batch", 100)
    kw.setdefault("visited_cap", 1 << 10)
    return DeviceChecker(tm, device="cpu", **kw)


def _assert_same_states(ck, r, jck, jr):
    assert r.level_sizes == jr.level_sizes
    nv = r.distinct_states
    assert nv == jr.distinct_states
    assert np.array_equal(ck.merged_rows(),
                          np.asarray(jck.last_bufs["rows"][: nv * ck.W]))
    par, lan = ck.merged_logs()
    assert np.array_equal(par, np.asarray(jck.last_bufs["parent"][:nv]))
    assert np.array_equal(lan, np.asarray(jck.last_bufs["lane"][:nv]))


@pytest.mark.parametrize("fuse", ["level", "stage"])
@pytest.mark.parametrize("spec", sorted(SPEC_MODELS))
def test_engine_state_for_state_with_jax(spec, fuse, jax_runs):
    """The oracle counts, and rows, parent and lane logs equal to the
    JAX engine's at the shipped cfg (another window size)."""
    jck, jr = jax_runs(spec)
    ck = _port(spec, fuse=fuse)
    r = ck.run()
    assert (r.distinct_states, r.diameter) == SHIPPED[spec]
    assert r.violation is None and not r.deadlock and not r.truncated
    _assert_same_states(ck, r, jck, jr)


@pytest.mark.parametrize("spec,sub_batch", [
    ("subscription", 256), ("subscription", 64), ("bookkeeper", 256),
    ("georeplication", 256)])
def test_fused_host_syncs_equal_jax_fetches(spec, sub_batch, jax_runs):
    """At the JAX engine's window size the fused level reads the device
    as often as the JAX fused level fetches its stats: subscription's 24
    narrow levels batch up to 8 a read in the ramp (4 reads at 256
    rows a window, 15 at 64), and a level wider than a window costs one
    read."""
    jck, jr = jax_runs(spec, sub_batch=sub_batch)
    ck = _port(spec, sub_batch=sub_batch, visited_cap=1 << 12)
    r = ck.run()
    _assert_same_states(ck, r, jck, jr)
    assert ck.last_stats["host_syncs"] == jck._fetch_n
    assert ck.last_stats["fuse_levels"] == r.diameter


@pytest.mark.parametrize("spec", sorted(BUGS))
def test_bug_counterexample_equals_jax(spec, jax_runs):
    """The seeded bug: the JAX engine's violating gid and depth, its
    rendered trace state for state, and the published action list."""
    inv, name, depth, actions = BUGS[spec]
    _jck, jr = jax_runs(spec, name, (inv,))
    r = _port(spec, name, invariants=(inv,)).run()
    assert r.violation == jr.violation == inv
    assert r.violation_gid == jr.violation_gid
    assert r.diameter == jr.diameter == depth == len(r.trace)
    assert r.trace_actions == jr.trace_actions == actions
    assert r.trace == jr.trace


def _tight_budget(spec, name, slack=4096, **kw):
    """A budget just above the initial tiers (the port's own byte
    estimate), so the run must spill."""
    p = _port(spec, name, hbm_budget="1T", **kw)
    est = p._device_bytes_est(p.TCAP0, p.WCAP0, p.WCAP0)
    return int(est / (1.0 - HBM_HEADROOM)) + slack


@pytest.mark.parametrize("spec,name", [("subscription", "shipped"),
                                       ("georeplication", "k3")])
def test_tiered_equals_jax_untiered(spec, name, jax_runs):
    """A budget that forces key eviction, row/log spill and cold-miss
    resolution: the JAX untiered run's states in its order, at W = 1
    (subscription) and at K = 3 exact keys (W = 3)."""
    jck, jr = jax_runs(spec, name)
    kw = dict(sub_batch=64, visited_cap=1 << 9)
    ck = _port(spec, name, hbm_budget=_tight_budget(spec, name, **kw), **kw)
    assert (ck.W, ck.K) == ((1, 2) if spec == "subscription" else (3, 3))
    r = ck.run()
    st = ck.last_stats
    assert st["spill_evictions"] >= 1, "budget never forced an eviction"
    assert st["spill_rows_evicted"] > 0
    assert st["spill_misses_resolved"] > 0
    _assert_same_states(ck, r, jck, jr)


def test_cold_lookup_of_exact_three_column_keys():
    """Exact K = 3 keys share their first two words in long blocks (a
    state's leading 64 bits), so a cold lookup searches within blocks of
    equal ``hi``: the same verdicts as the JAX store and as a set."""
    rng = np.random.default_rng(3)
    n = 20_000
    keys = [rng.integers(0, 40, n).astype(np.uint32),
            rng.integers(0, 3, n).astype(np.uint32),
            rng.integers(0, 1 << 16, n).astype(np.uint32)]
    mine, ref = TieredStore(), JStore(3)
    for lo_, hi_ in ((0, 9000), (9000, 20_000)):
        run = [k[lo_:hi_] for k in keys]
        o = np.lexsort(run[::-1])
        for st in (mine, ref):
            st.evict_keys([r[o] for r in run])
    q = [np.concatenate([k[::5], rng.integers(0, m, 8000).astype(np.uint32)])
         for k, m in zip(keys, (40, 3, 1 << 16))]
    got = mine.lookup_keys(q)
    assert np.array_equal(got, ref.lookup_keys(q))
    known = set(zip(*(k.tolist() for k in keys)))
    assert got.tolist() == [t in known for t in zip(*(c.tolist() for c in q))]
    assert got[: len(keys[0][::5])].all()
    mine.close()
    ref.close()


@pytest.mark.parametrize("spec", sorted(SHIPPED))
def test_cli_check_shipped_cfg(spec, capsys):
    rc = cli.main(["check", os.path.join(SPECS, f"{spec}.tla"), "-cpu"])
    out = capsys.readouterr().out
    states, diameter = SHIPPED[spec]
    assert rc == 0, out
    assert f"{states} distinct states found" in out
    assert f"search depth (diameter) {diameter}." in out
    _jm, tm = _models(spec, "shipped")
    assert (f"state width {tm.layout.total_bits} bits, {tm.A} successor "
            "lanes") in out


@pytest.mark.parametrize("spec", sorted(BUGS))
def test_cli_reports_seeded_bug(spec, capsys, tmp_path):
    """With the bug invariant, exit 1 and the counterexample in TLC
    style (bookkeeper at MaxBookieCrashes = 2, from a temporary cfg)."""
    inv, _name, depth, actions = BUGS[spec]
    cfg = os.path.join(SPECS, f"{spec}.cfg")
    if spec == "bookkeeper":
        text = open(cfg).read().replace("MaxBookieCrashes = 1",
                                        "MaxBookieCrashes = 2")
        cfg = str(tmp_path / "bookkeeper.cfg")
        with open(cfg, "w") as f:
            f.write(text)
    rc = cli.main(["check", os.path.join(SPECS, f"{spec}.tla"), "-config",
                   cfg, "-cpu", "-invariant", inv])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert f"Error: Invariant {inv} is violated." in out
    assert "State 1: <Initial predicate>" in out
    for i, act in enumerate(actions):
        assert f"State {i + 2}: <{act}>" in out
    assert f"State {depth + 1}:" not in out
    assert f"search depth (diameter) {depth}." in out
