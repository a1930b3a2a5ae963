"""The sort-merge visited set on the CPU: ``ops/dedup.py``'s
``make_keys``, ``merge_new_keys``, ``sort_perm``, ``bsearch_member`` and
``merge_sorted`` and ``ops/compact.py``'s two compactions, array-equal
to the JAX package's on keys with SENTINEL padding and words at or
above 2^31; ``visited_impl="sort"`` on both device engines state for
state against the JAX engines' sort runs and gid for gid against the
port's fpset runs.  Tolerance: exact equality."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine import sharded_device as jsd
from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ops import compact as jcompact
from pulsar_tlaplus_tpu.ops import dedup as jdedup
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker
from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
    ShardedDeviceChecker,
)
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ops import compact, dedup
from pulsar_tlaplus_tpu_torch.ops.dedup import from_jax_arrays
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from tests.helpers import SMALL_CONFIGS

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

SENT = np.uint32(0xFFFFFFFF)
LEAK, DUP = "CompactedLedgerLeak", "DuplicateNullKeyMessage"


def _port(c):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


def _u32(t):
    return t.numpy().view(np.uint32)


def _keys(rng, n, k, dup=0.3):
    """``k`` u32 key columns: high words at or above 2^31, a share of
    repeated keys."""
    cols = rng.integers(0, 2**32, size=(k, n), dtype=np.uint64).astype(
        np.uint32)
    cols[0, : n // 3] |= np.uint32(1 << 31)
    rep = rng.random(n) < dup
    src = rng.integers(0, n, size=n)
    cols[:, rep] = cols[:, src[rep]]
    return cols


def _sorted_visited(rng, V, nv, k):
    """``V`` sorted visited slots (``nv`` distinct keys, SENTINEL pad)."""
    keys = np.unique(_keys(rng, 2 * nv, k, dup=0).T, axis=0)[:nv].T
    pad = np.full((k, V - keys.shape[1]), SENT, np.uint32)
    return np.concatenate([keys, pad], axis=1)


@pytest.mark.parametrize("total_bits,W", [(20, 1), (42, 2), (64, 2),
                                          (70, 3), (96, 3), (137, 5),
                                          (618, 20)])
def test_make_keys_matches_jax(total_bits, W):
    rng = np.random.default_rng(W)
    words = rng.integers(0, 2**32, size=(3000, W), dtype=np.uint64).astype(
        np.uint32)
    if total_bits < 32 * W:
        words[:, -1] &= np.uint32((1 << (total_bits - 32 * (W - 1))) - 1)
    want = jdedup.make_keys(jnp.asarray(words), total_bits)
    (packed,) = from_jax_arrays(words)
    got = dedup.make_keys(packed, total_bits)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("k", [2, 3])
def test_merge_new_keys_matches_jax(k):
    """Candidates with in-batch duplicates, visited members, SENTINEL
    (invalid) lanes and high words >= 2^31; payloads tagged in bit 31."""
    rng = np.random.default_rng(k)
    V, nv, n = 4096, 1500, 1800
    vis = _sorted_visited(rng, V, nv, k)
    cand = _keys(rng, n, k)
    hit = rng.random(n) < 0.2
    cand[:, hit] = vis[:, rng.integers(0, nv, size=int(hit.sum()))]
    cand[:, rng.random(n) < 0.1] = SENT
    pay = np.arange(n, dtype=np.uint32) | np.uint32(1 << 31)
    want = jdedup.merge_new_keys(tuple(jnp.asarray(c) for c in vis),
                                 tuple(jnp.asarray(c) for c in cand),
                                 jnp.asarray(pay))
    got = dedup.merge_new_keys(from_jax_arrays(*vis), from_jax_arrays(*cand),
                               from_jax_arrays(pay)[0])
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(_u32(g), np.asarray(w))
    assert int(got[1]) == int(want[1]) > 0
    assert np.array_equal(_u32(got[2]), np.asarray(want[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))


def test_sort_perm_bsearch_and_merge_sorted_match_jax():
    rng = np.random.default_rng(7)
    V, nv, n = 2048, 900, 1500
    vis = _sorted_visited(rng, V, nv, 3)
    q = _keys(rng, n, 3)
    hit = rng.random(n) < 0.4
    q[:, hit] = vis[:, rng.integers(0, nv, size=int(hit.sum()))]
    q[:, :5] = SENT
    invalid = rng.random(n) < 0.2
    jv, jq = [jnp.asarray(c) for c in vis], [jnp.asarray(c) for c in q]
    tv, tq = from_jax_arrays(*vis), from_jax_arrays(*q)
    want = jdedup.sort_perm(jnp.asarray(invalid), *jq)
    got = dedup.sort_perm(from_jax_arrays(invalid)[0], *tq)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for n_vis in (nv, nv // 2, 0):
        want = jdedup.bsearch_member(*jv, jnp.int32(n_vis), *jq)
        got = dedup.bsearch_member(*tv, n_vis, *tq)
        assert np.array_equal(got.numpy(), np.asarray(want)), n_vis
    new = _keys(rng, 600, 3, dup=0)
    new[:, 400:] = SENT
    want = jdedup.merge_sorted(*jv, *[jnp.asarray(c) for c in new])
    got = dedup.merge_sorted(*tv, *from_jax_arrays(*new))
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("impl", ["logshift", "sort"])
def test_compact_impls_match_jax(impl):
    """Both compactions keep the JAX kept prefix (columns and indices)."""
    rng = np.random.default_rng(11)
    n = 5000
    drop = (rng.random(n) < 0.6).astype(np.uint32)
    cols = [rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
            for _ in range(3)]
    want, widx = jcompact.compact_by_flag(
        jnp.asarray(drop), tuple(jnp.asarray(c) for c in cols), impl=impl)
    got, idx = compact.compact_by_flag(from_jax_arrays(drop)[0],
                                       from_jax_arrays(*cols), impl)
    kept = int((drop == 0).sum())
    assert np.array_equal(idx[:kept].numpy(), np.asarray(widx)[:kept])
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g)[:kept], np.asarray(w)[:kept])
    with pytest.raises(ValueError, match="compact_impl must be"):
        compact.validate_impl("shift")


# --------------------------------------------- the single-device engine


def _logs(ck, nv):
    return (ck.merged_rows()[: nv * ck.W], *ck.merged_logs())


def _jlogs(jck, nv, W):
    b = jck.last_bufs
    return tuple(np.asarray(b[k][: nv * w]) for k, w in
                 (("rows", W), ("parent", 1), ("lane", 1)))


@pytest.fixture(scope="module")
def jax_sort_runs():
    """The JAX engine's ``visited_impl="sort"`` runs (shipped cfg, both
    counterexamples), one each."""
    out = {}
    for inv in ((), (LEAK,), (DUP,)):
        jck = JChecker(JModel(pe.SHIPPED_CFG), invariants=inv,
                       sub_batch=2048, visited_cap=1 << 16,
                       frontier_cap=1 << 15, visited_impl="sort")
        out[inv] = (jck, jck.run())
    return out


@pytest.mark.parametrize("inv", [(), (LEAK,), (DUP,)])
def test_device_sort_equals_jax_sort_and_port_fpset(jax_sort_runs, inv):
    """The sort-merge set (forced onto the stage loop) gives the JAX sort
    run's rows, logs, complete level sizes, violating gid and trace; the
    counts and logs of the port's own fpset stage run gid for gid.  (A
    violation stops the port's stage loop at the flush that found it,
    the JAX one at its next sync: the last, partial level's count may
    differ, every state found is the JAX run's.)"""
    jck, jr = jax_sort_runs[inv]
    m = _port(pe.SHIPPED_CFG)
    ck = DeviceChecker(m, invariants=inv, sub_batch=2048,
                       visited_impl="sort", device="cpu")
    assert ck.fuse == "stage"
    r = ck.run()
    nv = r.distinct_states
    assert (r.level_sizes[:-1], r.violation, r.violation_gid) == (
        jr.level_sizes[:-1], jr.violation, jr.violation_gid)
    if not inv:
        assert r.level_sizes == jr.level_sizes
    for a, b in zip(_logs(ck, nv), _jlogs(jck, nv, ck.W)):
        assert np.array_equal(a, b)
    if inv:
        assert [tuple(s) for s in r.trace] == [tuple(s) for s in jr.trace]
        assert r.trace_actions == jr.trace_actions
    fp = DeviceChecker(m, invariants=inv, sub_batch=2048, fuse="stage",
                       device="cpu")
    rf = fp.run()
    assert (rf.level_sizes, rf.violation_gid) == (r.level_sizes,
                                                  r.violation_gid)
    for a, b in zip(_logs(fp, nv), _logs(ck, nv)):
        assert np.array_equal(a, b)


def test_device_sort_frames_resume(tmp_path):
    """A truncated sort run leaves a frame of its sorted columns; the
    resumed run equals the uninterrupted one."""
    c = SMALL_CONFIGS["no_retain"]
    m = _port(c)
    full = DeviceChecker(m, invariants=(), sub_batch=64, visited_impl="sort",
                         device="cpu")
    rf = full.run()
    path = str(tmp_path / "s.npz")
    cut = DeviceChecker(m, invariants=(), sub_batch=64, visited_impl="sort",
                        device="cpu", checkpoint_path=path,
                        max_states=3000)
    assert cut.run().truncated
    res = DeviceChecker(m, invariants=(), sub_batch=64, visited_impl="sort",
                        device="cpu", checkpoint_path=path)
    r = res.run(resume=True)
    assert r.level_sizes == rf.level_sizes
    nv = r.distinct_states
    for a, b in zip(_logs(res, nv), _logs(full, nv)):
        assert np.array_equal(a, b)


def test_device_sort_refusals():
    m = _port(pe.SHIPPED_CFG)
    with pytest.raises(ValueError, match="visited_impl must be"):
        DeviceChecker(m, visited_impl="tree", device="cpu")
    with pytest.raises(ValueError, match="fpset visited set"):
        DeviceChecker(m, visited_impl="sort", hbm_budget="64M",
                      device="cpu")
    with pytest.raises(ValueError, match="seed_cap sizes"):
        DeviceChecker(m, seed_cap=1 << 12, device="cpu")


# --------------------------------------------------- the sharded engine


@pytest.fixture(scope="module")
def jax_sharded_sort():
    c = SMALL_CONFIGS["no_retain"]
    out = {}
    for slices in (1, 2):
        jck = jsd.ShardedDeviceChecker(
            JModel(c), n_devices=4, n_slices=slices, sub_batch=64,
            visited_cap=1 << 6, group=2, visited_impl="sort")
        out[slices] = (jck, jck.run())
    return out


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("compact_impl", ["logshift", "sort"])
def test_sharded_sort_equals_jax(jax_sharded_sort, slices, compact_impl):
    """``ShardedDeviceChecker(visited_impl="sort")`` on 4 shards (1-D and
    2 x 2), from tiny capacities (growth by padding): every shard's logs
    equal the JAX sort run's and the port's fpset run's."""
    jck, jr = jax_sharded_sort[slices]
    m = _port(SMALL_CONFIGS["no_retain"])
    runs = []
    for vi in ("sort", "fpset"):
        ck = ShardedDeviceChecker(m, n_devices=4, n_slices=slices,
                                  sub_batch=64, visited_cap=1 << 6, group=2,
                                  device="cpu", visited_impl=vi,
                                  compact_impl=compact_impl)
        r = ck.run()
        assert r.level_sizes == jr.level_sizes
        runs.append(ck)
    for s in range(4):
        n = int(runs[0].last_stats_matrix[s, 0])
        for k in ("parent", "lane"):
            want = np.asarray(jck.last_bufs[k][s][:n])
            for ck in runs:
                assert np.array_equal(ck.last_bufs[k][s][:n].numpy(), want)


def test_sharded_sort_frames_resume(tmp_path):
    """The sharded sort run's frame (every shard's sorted columns)
    resumes to the uninterrupted run, shard for shard."""
    m = _port(SMALL_CONFIGS["no_retain"])
    kw = dict(n_devices=4, sub_batch=64, visited_cap=1 << 6,
              visited_impl="sort", device="cpu")
    full = ShardedDeviceChecker(m, **kw)
    rf = full.run()
    path = str(tmp_path / "s.npz")
    cut = ShardedDeviceChecker(m, checkpoint_path=path, max_states=3000,
                               **kw)
    assert cut.run().truncated
    res = ShardedDeviceChecker(m, checkpoint_path=path, **kw)
    r = res.run(resume=True)
    assert r.level_sizes == rf.level_sizes
    for s in range(4):
        n = int(full.last_stats_matrix[s, 0])
        for k in ("rows", "parent", "lane"):
            w = full.W if k == "rows" else 1
            assert torch.equal(res.last_bufs[k][s][: n * w],
                               full.last_bufs[k][s][: n * w])


@pytest.mark.parametrize("fairness", ["none", "wf_next"])
def test_liveness_compact_impl_sort(fairness):
    """``compact_impl="sort"`` reaches the liveness sweep and its
    exploration: the same verdict, lasso and edges."""
    m = _port(SMALL_CONFIGS["no_retain"])
    out = []
    for impl in ("logshift", "sort"):
        lc = LivenessChecker(m, fairness=fairness, compact_impl=impl,
                             device="cpu")
        r = lc.run()
        out.append((r.holds, r.reason, r.lasso_prefix, r.lasso_cycle,
                    r.distinct_states,
                    [x.tolist() for x in lc._edge_cache or ()]))
    assert out[0] == out[1]
