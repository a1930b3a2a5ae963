"""The port's streaming simulator (``sim/engine.py``, ``sim/rng.py``) and
the CLI's liveness and simulation paths, on the CPU:

- ``sim/rng``: the words are deterministic, and one walker's words
  alone equal its words in the swarm (what replay relies on);
- the lane choice covers exactly the enabled lanes plus stutter, evenly,
  on crafted masks; nothing enabled stays put;
- on the same states (packed rows of a run, unpacked by each package)
  a forced lane gives the JAX successor, and the duplicate estimator's
  fingerprints, hits and table equal the JAX engine's;
- both seeded compaction bugs are found at the shipped cfg for seeds
  0, 1 and 2 at one budget (1,024 walkers, depth 64, 20 rounds), each
  trace ``verified`` and valid under the port's ``ref/pyeval``;
- ``producer_on`` runs clean: one round of 256 walkers at depth 32
  visits 256 * 33 states; segment clamping, the one-round default and
  an unknown invariant as the JAX tests pin them.  The CLI's paths
  are in ``test_torch_cli_live.py``.

Tolerance: exact equality (integer work)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.models import registry as jregistry
from pulsar_tlaplus_tpu.sim.engine import StreamingSimulator as JSim
from pulsar_tlaplus_tpu.utils import cfg as jcfg
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.models import registry
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.sim import rng
from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
from pulsar_tlaplus_tpu_torch.utils import cfg as tcfg
from tests.helpers import SMALL_CONFIGS

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
# producer_on as a cfg: MessageSentLimit 2, CompactionTimesLimit 2, one
# key, one value, one crash (1,654 states)
SMALL_CFG = """CONSTANTS
    MessageSentLimit = 2,
    CompactionTimesLimit = 2,
    ModelConsumer = FALSE,
    ConsumeTimesLimit = 2,
    KeySpace = {1},
    ValueSpace = {1},
    RetainNullKey = TRUE,
    MaxCrashTimes = 1,
    ModelProducer = TRUE
SPECIFICATION Spec
INVARIANTS
    TypeSafe
    CompactionHorizonCorrectness
"""


def _model(c):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


# ---- sim/rng --------------------------------------------------------


def test_rng_deterministic_and_replayable():
    w = torch.arange(4096)
    for stream, step in ((rng.INIT, 0), (rng.STEP, 7), (rng.STEP, 2**40)):
        key = rng.stream_key(12345, stream, step)
        assert key == rng.stream_key(12345, stream, step)
        a, b = rng.words(key, w), rng.words(key, w)
        assert torch.equal(a, b)
        assert int(a.min()) >= 0 and int(a.max()) < 2**32
        # one walker alone draws its word in the swarm
        for i in (0, 1, 777, 4095):
            assert torch.equal(rng.words(key, torch.tensor([i])), a[i:i + 1])
        many = rng.words(key, w, 5)
        assert many.shape == (4096, 5)
        assert torch.equal(rng.words(key, torch.tensor([9]), 5), many[9:10])
        # distinct enough to pass for random: no repeats in 4096 draws
        assert len(set(a.tolist())) == 4096
    keys = {rng.stream_key(s, st, g) for s in (0, 1) for st in (1, 2)
            for g in (0, 1, 2**32)}
    assert len(keys) == 12


@pytest.mark.parametrize("valid,stutter", [
    ([1, 0, 1, 1, 0], 0),
    ([1, 0, 1, 1, 0], 1),
    ([0, 0, 0, 0, 0], 1),
    ([0, 0, 0, 0, 0], 0),
    ([0, 0, 0, 0, 1], 0),
    ([1, 1, 1, 1, 1], 1),
])
def test_pick_lane_covers_enabled_lanes_and_stutter(valid, stutter):
    a, n = len(valid), 6 * 1024
    # evenly spaced words over [0, 2^32): each choice is taken n / k
    # times, within one
    u = (torch.arange(n, dtype=torch.int64) << 32) // n
    lane, n_en = rng.pick_lane(
        u, torch.tensor([valid] * n, dtype=torch.bool),
        torch.full((n,), bool(stutter)),
    )
    want = [i for i, v in enumerate(valid) if v] + ([a] if stutter else [])
    assert int(n_en[0]) == len(want)
    if not want:
        assert set(lane.tolist()) == {a}  # nothing enabled: stay put
        return
    counts = torch.bincount(lane, minlength=a + 1).tolist()
    assert {i for i, k in enumerate(counts) if k} == set(want)
    assert all(abs(counts[i] - n / len(want)) <= 1 for i in want)


# ---- the same states through both engines ---------------------------


SAME_STATE_CASES = {
    "compaction": SMALL_CFG,
    "subscription": None,
    "bookkeeper": None,
    "georeplication": None,
}


@functools.lru_cache(maxsize=None)
def _states(spec):
    """(JAX model, port model, JAX states, port states) of 128 of the
    first 1,024 states of a port run at the spec's cfg (producer_on for
    compaction)."""
    if SAME_STATE_CASES[spec] is None:
        cfg = os.path.join(SPECS, f"{spec}.cfg")
        jm, _ = jregistry.COMPILED[spec](jcfg.load(cfg))
        tm, _ = registry.COMPILED[spec](tcfg.load(cfg))
    else:
        c = SMALL_CONFIGS["producer_on"]
        from pulsar_tlaplus_tpu.models.compaction import CompactionModel as J

        jm, tm = J(c), _model(c)
    ck = DeviceChecker(tm, invariants=(), check_deadlock=False,
                       max_states=1024, device="cpu")
    n = ck.run().distinct_states
    pick = np.random.default_rng(7).choice(n, size=128, replace=False)
    rows = ck.last_bufs["rows"].reshape(-1, tm.layout.W)[
        torch.from_numpy(np.sort(pick))
    ]
    jst = jax.vmap(jm.layout.unpack)(jnp.asarray(rows.numpy().view(np.uint32)))
    return jm, tm, jst, tm.layout.unpack(rows)


@pytest.mark.parametrize("spec", sorted(SAME_STATE_CASES))
def test_forced_lane_gives_the_jax_successor(spec):
    jm, tm, jst, tst = _states(spec)
    sim = StreamingSimulator(tm, invariants=(), n_walkers=128, device="cpu")
    succ, valid = tm.successors(tst)
    jsucc, jvalid = jax.vmap(jm.successors)(jst)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    for lane in range(tm.A + 1):
        got = sim._take(tst, succ, torch.full((128,), lane))
        if lane == tm.A:  # the stutter lane
            want = jst
        else:
            want = jax.tree.map(lambda x: x[:, lane], jsucc)
        assert np.array_equal(
            tm.layout.pack(got).numpy().view(np.uint32),
            np.asarray(jax.vmap(jm.layout.pack)(want)),
        ), lane


@pytest.mark.parametrize("spec", sorted(SAME_STATE_CASES))
def test_fingerprints_and_dup_insert_equal_jax(spec):
    jm, tm, jst, tst = _states(spec)
    js = JSim(jm, invariants=(), n_walkers=128, dup_sample=128,
              dup_table_bits=6, profile=None)
    ts = StreamingSimulator(tm, invariants=(), n_walkers=128,
                            dup_sample=128, dup_table_bits=6, device="cpu")
    got = ts._fingerprints(tst)
    assert np.array_equal(got.numpy(), np.asarray(js._fingerprints(jst)))
    jt = jnp.zeros((64,), jnp.uint32)
    tt = torch.zeros((64,), dtype=torch.int64)
    for half in (slice(0, 128), slice(64, 128), slice(0, 128)):
        sub_j = jax.tree.map(lambda x: x[half], jst)
        sub_j = jax.tree.map(
            lambda x: jnp.concatenate([x, x])[:128], sub_j)
        sub_t = type(tst)(*[torch.cat([x[half], x[half]])[:128]
                            for x in tst])
        jt, jh = js._dup_insert(jt, sub_j)
        tt, th = ts._dup_insert(tt, sub_t)
        assert int(th) == int(jh)
        assert np.array_equal(tt.numpy(), np.asarray(jt))


# ---- whole runs -----------------------------------------------------


def _valid_trace(c, inv, trace, actions):
    """The trace starts at Init, each step is a Next step of the
    oracle, and ``inv`` fails first at the last state."""
    assert trace[0] in set(tpe.initial_states(c))
    assert len(actions) == len(trace) - 1
    for s, act, t in zip(trace, actions, trace[1:]):
        assert any(tpe.ACTION_NAMES[a] == act and u == t
                   for a, u in tpe.successors(c, s)), act
    ok = tpe.INVARIANTS[inv]
    assert all(ok(c, s) for s in trace[:-1])
    assert not ok(c, trace[-1])


@pytest.mark.parametrize("inv", ["CompactedLedgerLeak",
                                 "DuplicateNullKeyMessage"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_bugs_found_verified_and_valid(inv, seed):
    c = tpe.SHIPPED_CFG
    r = StreamingSimulator(CompactionModel(c), invariants=(inv,),
                           n_walkers=1024, depth=64, seed=seed,
                           max_rounds=20, device="cpu").run()
    assert r.violation == inv and r.stop_reason == "violation"
    assert r.verified is True
    _valid_trace(c, inv, r.trace, r.trace_actions)
    assert r.stats["host_syncs"] == r.segments


def test_producer_on_one_round_is_clean():
    r = StreamingSimulator(_model(SMALL_CONFIGS["producer_on"]),
                           n_walkers=256, depth=32, device="cpu").run()
    assert r.violation is None and r.stop_reason == "round_budget"
    assert r.states_visited == 256 * 33
    assert (r.steps, r.walks, r.segments) == (256 * 32, 256, 1)
    st = r.stats
    assert st["sim_dup_attempts"] == 256 * 33
    assert 0 < st["sim_stutter_steps"] < r.steps
    assert st["sim_enabled_lanes"] >= r.steps - st["sim_stutter_steps"]


def test_same_seed_same_run_and_seeds_differ():
    m = CompactionModel(tpe.SHIPPED_CFG)
    kw = dict(invariants=("DuplicateNullKeyMessage",), n_walkers=64,
              depth=64, max_rounds=20, device="cpu")
    a = StreamingSimulator(m, seed=3, **kw).run()
    b = StreamingSimulator(m, seed=3, **kw).run()
    c = StreamingSimulator(m, seed=4, **kw).run()
    for f in ("trace", "trace_actions", "steps", "violation_walker",
              "violation_step"):
        assert getattr(a, f) == getattr(b, f), f
    assert {k: v for k, v in a.stats.items() if "per_sec" not in k} == {
        k: v for k, v in b.stats.items() if "per_sec" not in k}
    assert (a.steps, a.violation_walker, a.stats["sim_stutter_steps"]) != (
        c.steps, c.violation_walker, c.stats["sim_stutter_steps"])


def test_segment_clamp_default_budget_unknown_invariant():
    m = _model(SMALL_CONFIGS["producer_on"])
    s = StreamingSimulator(m, depth=48, segment_len=20, device="cpu")
    assert s.L == 16 and 48 % s.L == 0  # largest divisor <= 20
    assert StreamingSimulator(m, depth=48, segment_len=500,
                              device="cpu").L == 48
    assert StreamingSimulator(m, n_walkers=8, depth=4,
                              device="cpu").max_rounds == 1
    with pytest.raises(ValueError, match="unknown invariant"):
        StreamingSimulator(m, invariants=("NoSuchInv",), device="cpu")
    r = StreamingSimulator(m, n_walkers=16, depth=64, device="cpu").run()
    assert (r.steps, r.states_visited, r.walks) == (16 * 64, 16 * 65, 16)
    assert r.segments == 2 and r.stop_reason == "round_budget"
