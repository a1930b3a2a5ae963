"""The port's mesh-sharded engine on the CPU against the JAX package's
``ShardedDeviceChecker`` (``tests/test_sharded_device.py`` and
``test_survivability_r9.py`` are the JAX side's versions):

- the routing helpers, array-equal to the JAX ``_owner`` and
  ``_bucket_scatter`` on keys made with numpy from a seed;
- runs at N = 4 and on a 2 x 2 mesh, state for state: every shard's row,
  parent and lane prefixes, the level sizes, the violating gid and the
  trace equal the JAX engine's, also from a host-enumerated seed that
  spreads the frontier over every shard (three JAX runs, module-scoped);
- the oracle's counts for every mesh, growth from tiny capacities,
  ``flush_factor``, truncation, route-overflow recovery, host-seeded
  runs, frames (resume, refusal, the device-memory drills) and liveness
  over the mesh, each against the oracle, the pins or the port's own
  uninterrupted run.

Tolerance: exact equality."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine import sharded_device as jsd
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch.engine import sharded_device as tsd
from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.parallel import mesh as tmesh
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.utils import faults
from tests.helpers import SMALL_CONFIGS, assert_valid_counterexample

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

LEAK = "CompactedLedgerLeak"
DUP = "DuplicateNullKeyMessage"
PON = SMALL_CONFIGS["producer_on"]
# the JAX tests' shapes (tests/test_sharded_device.py)
SMALL = dict(sub_batch=128, visited_cap=1 << 10)
SHIP = dict(sub_batch=512, visited_cap=1 << 13)
SEEDED = dict(sub_batch=256, visited_cap=1 << 12)


def _port(c=pe.SHIPPED_CFG):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


def _ck(c=pe.SHIPPED_CFG, **kw):
    kw.setdefault("device", "cpu")
    return tsd.ShardedDeviceChecker(_port(c), **kw)


def _state(s):
    return pe.State(*s)


@pytest.fixture(scope="module")
def oracle():
    return pe.check(PON, invariants=())


def _assert_same_shards(ck, jck):
    """Every shard's row, parent and lane prefix equals the JAX run's."""
    jm = np.asarray(jck.last_stats_matrix)
    assert ck.last_stats_matrix[:, :2].tolist() == jm[:, :2].tolist()
    W = ck.W
    for s in range(ck.N):
        n = int(jm[s, 0])
        assert np.array_equal(
            ck.last_bufs["rows"][s][: n * W].numpy().view(np.uint32),
            np.asarray(jck.last_bufs["rows"][s, : n * W]),
        ), s
        for log in ("parent", "lane"):
            assert np.array_equal(
                ck.last_bufs[log][s][:n].numpy(),
                np.asarray(jck.last_bufs[log][s, :n]),
            ), (log, s)


# ------------------------------------------------------ routing helpers


@pytest.mark.parametrize("k", [2, 3])
def test_owner_equals_jax_bit_for_bit(k):
    rng = np.random.default_rng(20261017 + k)
    keys = rng.integers(0, 2**32, size=(k, 4099), dtype=np.uint32)
    keys[:, :7] = 0xFFFFFFFF  # SENTINEL lanes mix like any other
    tk = tuple(torch.from_numpy(c.view(np.int32).copy()) for c in keys)
    import jax.numpy as jnp

    jk = tuple(jnp.asarray(c) for c in keys)
    for n in range(1, 9):
        assert np.array_equal(tsd.owner_of(tk, n).numpy(),
                              np.asarray(jsd._owner(jk, n))), n


@pytest.mark.parametrize("n,cap", [(1, 600), (3, 300), (4, 160), (8, 40),
                                   (5, 90)])
def test_bucket_scatter_equals_jax(n, cap):
    """Planes, return addresses and the overflow flag; ``(8, 40)`` and
    ``(5, 90)`` overflow a destination."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n * 1000 + cap)
    lanes = 512
    dest = rng.integers(0, n, size=lanes).astype(np.int32)
    valid = rng.random(lanes) < 0.8
    cols = [rng.integers(0, 2**32, size=lanes, dtype=np.uint32)
            for _ in range(3)]
    jo, jq, jover = jsd._bucket_scatter(
        jnp.asarray(dest), n, cap, jnp.asarray(valid),
        [jnp.asarray(c) for c in cols], [jsd.SENTINEL] * 3)
    to, tq, tover = tsd.bucket_scatter(
        torch.from_numpy(dest), n, cap, torch.from_numpy(valid),
        [torch.from_numpy(c.view(np.int32).copy()) for c in cols], [-1] * 3)
    for a, b in zip(to, jo):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert bool(tover) == bool(jover)
    counts = np.bincount(dest[valid], minlength=n)
    assert bool(tover) == bool((counts > cap).any())


def test_mesh_all_to_all_block_order():
    """Block ``d`` of producer ``s`` lands as block ``s`` of receiver
    ``d`` on every axis of a 2 x 3 mesh, and shards share a device."""
    m = tmesh.make_mesh2d(2, 3, "cpu")
    assert m.devices == [torch.device("cpu")] * 6
    for axis in ("dcn", "ici"):
        group_of = {s: g for g in m.groups(axis) for s in g}
        send = [torch.tensor([[10 * s + pos]
                              for pos in range(len(group_of[s]))])
                for s in range(6)]
        recv = m.all_to_all(send, axis)
        for g in m.groups(axis):
            for pos, d in enumerate(g):
                assert recv[d][:, 0].tolist() == [10 * s + pos for s in g]
    assert tmesh.make_mesh(5, ["cpu"]).N == 5


# ------------------------------------------- state for state with JAX


@pytest.fixture(scope="module")
def jax_pon4():
    jck = jsd.ShardedDeviceChecker(JModel(PON), n_devices=4, invariants=(),
                                   **SMALL)
    return jck, jck.run()


@pytest.fixture(scope="module")
def jax_leak22():
    jck = jsd.ShardedDeviceChecker(
        JModel(pe.SHIPPED_CFG), n_devices=4, n_slices=2, invariants=(LEAK,),
        **SHIP)
    return jck, jck.run()


def test_n4_state_for_state_with_jax(jax_pon4, oracle):
    jck, jr = jax_pon4
    ck = _ck(PON, n_devices=4, invariants=(), **SMALL)
    r = ck.run()
    assert (r.distinct_states, r.diameter) == (oracle.distinct_states,
                                               oracle.diameter)
    assert r.level_sizes == jr.level_sizes
    _assert_same_shards(ck, jck)
    # one initial state: discovery stays on its producer, shard 0, and
    # every shard owns keys
    assert ck.last_stats_matrix[:, 0].tolist() == [1654, 0, 0, 0]
    assert (ck.last_stats_matrix[:, 1] > 0).all()
    assert ck.last_stats["stats_fetches"] >= r.diameter


def test_2x2_mesh_leak_state_for_state_with_jax(jax_leak22):
    jck, jr = jax_leak22
    ck = _ck(n_devices=4, n_slices=2, invariants=(LEAK,), **SHIP)
    r = ck.run()
    assert (r.violation, r.diameter) == (LEAK, 12) == (jr.violation,
                                                      jr.diameter)
    assert r.violation_gid == jr.violation_gid
    assert r.level_sizes == jr.level_sizes
    _assert_same_shards(ck, jck)
    assert [tuple(s) for s in r.trace] == [tuple(s) for s in jr.trace]
    assert r.trace_actions == jr.trace_actions
    assert_valid_counterexample(pe.SHIPPED_CFG,
                                [_state(s) for s in r.trace],
                                r.trace_actions, LEAK)


# --------------------------------------------- counts on every mesh


@pytest.mark.parametrize("n,slices", [(1, 1), (2, 1), (4, 1), (8, 1),
                                      (4, 2), (8, 2)])
def test_counts_identical_across_meshes(n, slices, oracle):
    r = _ck(PON, n_devices=n, n_slices=slices, invariants=(), **SMALL).run()
    assert (r.distinct_states, r.diameter) == (oracle.distinct_states,
                                               oracle.diameter)
    assert r.violation is None and not r.deadlock and not r.truncated


def test_shipped_cfg_on_eight_shards():
    r = _ck(n_devices=8, **SHIP).run()
    assert (r.distinct_states, r.diameter) == (45198, 20)
    assert r.violation is None and not r.deadlock


def test_growth_from_tiny_capacities(oracle, tmp_path):
    """Tables and stores grow mid-run on every shard; the per-level
    metrics file has a line a level."""
    path = tmp_path / "m.jsonl"
    ck = _ck(PON, n_devices=4, invariants=(), sub_batch=64,
             visited_cap=1 << 6, group=2, metrics_path=str(path))
    r = ck.run()
    assert (r.distinct_states, r.diameter) == (oracle.distinct_states,
                                               oracle.diameter)
    assert ck.TCAP > 2 * ck._round_cap(1 << 6)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["level"] for x in lines] == list(range(2, r.diameter + 1))
    assert lines[-1]["distinct_states"] == r.distinct_states


def test_flush_factor():
    c = SMALL_CONFIGS["two_crashes"]
    want = pe.check(c, invariants=())
    r = _ck(c, n_devices=2, invariants=(), sub_batch=128,
            visited_cap=1 << 10, flush_factor=3).run()
    assert (r.distinct_states, r.diameter) == (want.distinct_states,
                                               want.diameter)


def test_truncation():
    r = _ck(PON, n_devices=4, invariants=(), sub_batch=64,
            visited_cap=1 << 10, max_states=64).run()
    assert r.truncated and r.stop_reason == "max_states"
    assert r.distinct_states >= 64


@pytest.mark.parametrize("n,slices", [(4, 1), (8, 2)])
def test_route_overflow_recovers(n, slices, oracle):
    ck = _ck(PON, n_devices=n, n_slices=slices, invariants=(),
             route_slack=0.03, **SMALL)
    r = ck.run()
    assert ck.route_slack > 0.03  # the recovery fired
    assert (r.distinct_states, r.diameter) == (oracle.distinct_states,
                                               oracle.diameter)


def _port_seed(c, **caps):
    """The port model's ``host_seed``, held array-equal to the JAX
    model's at the same caps."""
    seed = _port(c).host_seed(**caps)
    jseed = JModel(c).host_seed(**caps)
    for a, b in zip(seed[:3], jseed[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(seed[3]) == list(jseed[3])
    return seed


def test_host_seeded_run_counts(oracle):
    """A host-enumerated prefix (the port model's ``host_seed``, equal to
    the JAX model's) loads onto the mesh without changing counts."""
    seed = _port_seed(PON, max_level_states=40, max_total=120)
    assert len(seed[3]) > 1
    r = _ck(PON, n_devices=4, invariants=(), sub_batch=64,
            visited_cap=1 << 10).run(seed=seed)
    assert (r.distinct_states, r.diameter) == (oracle.distinct_states,
                                               oracle.diameter)


@pytest.fixture(scope="module")
def leak_seed():
    return _port_seed(pe.SHIPPED_CFG, max_level_states=300, max_total=900)


@pytest.fixture(scope="module")
def jax_seeded4(leak_seed):
    jck = jsd.ShardedDeviceChecker(JModel(pe.SHIPPED_CFG), n_devices=4,
                                   invariants=(LEAK,), **SEEDED)
    return jck, jck.run(seed=leak_seed)


def test_host_seeded_run_and_violation_trace(jax_seeded4, leak_seed):
    """The seed spreads the frontier over every shard, so several
    producers send keys to one owner in a round and the prefixes of the
    producers differ in length: the per-shard logs, the violating gid and
    the trace still equal the JAX engine's."""
    jck, jr = jax_seeded4
    ck = _ck(n_devices=4, invariants=(LEAK,), **SEEDED)
    r = ck.run(seed=leak_seed)
    produced = ck.last_stats_matrix[:, 0].tolist()
    assert min(produced) > 0 and len(set(produced)) > 1, produced
    assert (r.violation, r.diameter, len(r.trace)) == (LEAK, 12, 12)
    assert (r.violation, r.diameter) == (jr.violation, jr.diameter)
    assert r.violation_gid == jr.violation_gid
    assert r.level_sizes == jr.level_sizes
    _assert_same_shards(ck, jck)
    assert [tuple(s) for s in r.trace] == [tuple(s) for s in jr.trace]
    assert r.trace_actions == jr.trace_actions
    assert_valid_counterexample(pe.SHIPPED_CFG,
                                [_state(s) for s in r.trace],
                                r.trace_actions, LEAK)


# bench.py's scaled binding: 618-bit states, so the keys are hashed and
# ``fp_bits`` sets their columns (and with them every state's owner)
WIDE = pe.Constants(message_sent_limit=64, compaction_times_limit=3,
                    num_keys=8, num_values=2, retain_null_key=True,
                    max_crash_times=3, model_producer=True)
WIDE_KW = dict(n_devices=4, invariants=(), sub_batch=256,
               visited_cap=1 << 10, max_states=2000)


@pytest.mark.parametrize("fp_bits", [64, 96])
def test_fp_bits_and_expand_chunk(fp_bits):
    """``fp_bits // 32`` key columns; expanding a round in chunks of 64
    rows gives every shard the same logs as one chunk of 256.  The
    complete levels equal the oracle's BFS."""
    seen = set(pe.initial_states(WIDE))
    frontier, want = list(seen), [len(seen)]
    for _ in range(2):
        frontier = [t for s in frontier for _a, t in pe.successors(WIDE, s)
                    if t not in seen and not seen.add(t)]
        want.append(len(frontier))
    one = _ck(WIDE, fp_bits=fp_bits, **WIDE_KW)
    r = one.run()
    chunked = _ck(WIDE, fp_bits=fp_bits, expand_chunk=64, **WIDE_KW)
    rc = chunked.run()
    assert (one.K, one.keys.exact, chunked.Fi) == (fp_bits // 32, False, 64)
    assert r.truncated and r.level_sizes[:3] == want
    assert rc.level_sizes == r.level_sizes
    for s in range(4):
        n = int(one.last_stats_matrix[s, 0])
        assert n == int(chunked.last_stats_matrix[s, 0])
        for k, w in (("rows", one.W), ("parent", 1), ("lane", 1)):
            assert torch.equal(one.last_bufs[k][s][: n * w],
                               chunked.last_bufs[k][s][: n * w]), (k, s)


def test_fp_bits_and_expand_chunk_match_jax():
    """``fp_bits=96`` (three hashed columns: every owner changes) and
    ``expand_chunk=64`` give every shard the JAX engine's rows and logs
    at the same knobs."""
    kw = dict(WIDE_KW, fp_bits=96, expand_chunk=64)
    jck = jsd.ShardedDeviceChecker(JModel(WIDE), **kw)
    jr = jck.run()
    ck = _ck(WIDE, **kw)
    r = ck.run()
    assert (ck.K, jck.K) == (3, 3)
    assert r.level_sizes == jr.level_sizes
    _assert_same_shards(ck, jck)


def test_fp_bits_and_expand_chunk_refused():
    with pytest.raises(ValueError, match="fp_bits must be 64 or 96"):
        _ck(WIDE, fp_bits=32, **WIDE_KW)
    with pytest.raises(ValueError, match="multiple of expand_chunk"):
        _ck(WIDE, expand_chunk=100, **WIDE_KW)


def test_deadlock_gid_is_the_lowest_global_one():
    class NoStutter(CompactionModel):
        def stutter_enabled(self, s):
            return torch.zeros_like(s.length, dtype=torch.bool)

    c = SMALL_CONFIGS["two_crashes"]
    ck = tsd.ShardedDeviceChecker(
        NoStutter(tpe.Constants(**dataclasses.asdict(c))), n_devices=2,
        invariants=(), sub_batch=64, visited_cap=1 << 10, device="cpu")
    r = ck.run()
    assert r.deadlock and r.violation == "Deadlock"
    last = _state(r.trace[-1])
    assert all(t == last for _a, t in pe.successors(c, last))
    assert r.violation_gid >> ck.SB < 2


# ------------------------------------------------------ survivability


@pytest.fixture
def fault(monkeypatch):
    def arm(spec):
        if spec is None:
            monkeypatch.delenv("PTT_FAULT", raising=False)
        else:
            monkeypatch.setenv("PTT_FAULT", spec)
        faults.reset()

    yield arm
    faults.reset()


@pytest.fixture(scope="module")
def leak4():
    """The uninterrupted N = 4 leak run every frame test is held to."""
    ck = _ck(n_devices=4, invariants=(LEAK,), **SHIP)
    r = ck.run()
    assert (r.violation, r.diameter) == (LEAK, 12)
    return r, [t.clone() for t in ck.last_bufs["parent"]]


def test_truncate_and_resume_equals_uninterrupted(tmp_path, leak4):
    full, parents = leak4
    path = str(tmp_path / "s.npz")

    def make(cap):
        return _ck(n_devices=4, invariants=(LEAK,), max_states=cap,
                   checkpoint_path=path, checkpoint_every=2, **SHIP)

    r = make(3_000).run()
    assert r.truncated and r.stop_reason == "max_states"
    ck = make(1 << 26)
    r = ck.run(resume=True)
    assert (r.violation, r.violation_gid, r.level_sizes) == (
        full.violation, full.violation_gid, full.level_sizes)
    assert r.trace == full.trace
    for s in range(4):
        n = int(ck.last_stats_matrix[s, 0])
        assert torch.equal(ck.last_bufs["parent"][s][:n], parents[s][:n])
    other = _ck(PON, n_devices=4, invariants=(), checkpoint_path=path,
                **SMALL)
    with pytest.raises(ValueError, match="different configuration"):
        other.run(resume=True)
    with pytest.raises(ValueError, match="different configuration"):
        _ck(n_devices=2, invariants=(LEAK,), checkpoint_path=path,
            **SHIP).run(resume=True)


def test_oom_drill_rebuilds_once_from_its_frame(fault, tmp_path, leak4):
    full, _ = leak4
    fault("oom@level:8")
    ck = _ck(n_devices=4, invariants=(LEAK,), checkpoint_path=str(
        tmp_path / "o.npz"), checkpoint_every=1, **SHIP)
    r = ck.run()
    assert r.hbm_recovered == 1 and not r.truncated
    assert ck._headroom_frozen and ck.group == 2
    assert (r.violation, r.violation_gid, r.level_sizes) == (
        full.violation, full.violation_gid, full.level_sizes)
    assert r.trace == full.trace


@pytest.mark.parametrize("spec,what", [
    ("oom@level:3", "hbm"),
    ("oom@flush:8", "recovers"),
    ("fpset_fail@flush:2", "probe overflow on 1 shard"),
    ("ckpt_fail@frame:1", "retried"),
])
def test_fault_sites(spec, what, fault, tmp_path):
    fault(spec)
    path = str(tmp_path / "f.npz")
    if what == "hbm":
        r = _ck(PON, n_devices=4, invariants=(), **SMALL).run()
        assert r.truncated and r.stop_reason == "hbm"
        assert r.hbm_recovered == 0 and 0 < r.distinct_states < 1654
    elif what == "recovers":
        r = _ck(PON, n_devices=4, invariants=(), checkpoint_path=path,
                checkpoint_every=1, **SMALL).run()
        assert r.hbm_recovered >= 1 and not r.truncated
        assert r.distinct_states == 1654
    elif what == "retried":
        ck = _ck(n_devices=4, invariants=(DUP,), checkpoint_path=path,
                 checkpoint_every=1, **SHIP)
        r = ck.run()
        assert r.violation == DUP and ck.last_stats["ckpt_retries"] >= 1
    else:
        with pytest.raises(RuntimeError, match=what):
            _ck(PON, n_devices=4, invariants=(), **SMALL).run()


# ----------------------------------------------------------- liveness


@pytest.mark.parametrize("fairness", ["none", "wf_next"])
def test_liveness_over_the_mesh_equals_one_device(fairness):
    """Verdict, reason, lasso and the edges (as pairs of states) equal
    the single-device exploration's."""
    m = _port(PON)
    want_holds, _ = pe.check_eventually(PON, fairness)
    one = LivenessChecker(m, fairness=fairness, frontier_chunk=512,
                          visited_cap=1 << 13, device="cpu")
    r1 = one.run()
    mesh = LivenessChecker(m, fairness=fairness, frontier_chunk=512,
                           visited_cap=1 << 13, n_devices=4, device="cpu")
    r4 = mesh.run()
    assert r4.holds == r1.holds == want_holds
    assert (r4.reason, r4.distinct_states) == (r1.reason, r1.distinct_states)
    rows1, rows4 = one._rows.numpy(), mesh._rows.numpy()
    key1 = {bytes(r): i for i, r in enumerate(rows1)}
    perm = np.array([key1[bytes(r)] for r in rows4])
    n_init = mesh._explored[1]
    assert sorted(perm[:n_init]) == list(range(n_init))

    def states(ids, rows):
        return [bytes(rows[i]) for i in (ids or [])]

    assert states(r4.lasso_prefix, rows4) == states(r1.lasso_prefix, rows1)
    assert states(r4.lasso_cycle, rows4) == states(r1.lasso_cycle, rows1)
    if fairness == "wf_next":
        s1, d1, _ = one._edge_cache
        s4, d4, _ = mesh._edge_cache
        e1 = sorted(zip(s1.tolist(), d1.tolist()))
        e4 = sorted(zip(perm[s4].tolist(), perm[d4].tolist()))
        assert e4 == e1


def test_liveness_refuses_hbm_budget_on_the_mesh():
    with pytest.raises(ValueError, match="single-device explorer"):
        LivenessChecker(_port(PON), n_devices=2, hbm_budget="64M",
                        device="cpu")
