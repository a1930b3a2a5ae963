"""Seeded starts, per-level records and the engine knobs of the port's
``DeviceChecker`` on the CPU: ``host_seed`` array-equal to the JAX
model's; seeded runs state for state against the JAX engine's seeded
runs (violation after the prefix and inside it, the frontier window);
every seed guard; ``metrics_path`` records with the JAX keys, rewound on
resume; and each knob the port takes (``fp_bits``, ``expand_chunk``,
``flush_factor``, ``group``, ``frontier_cap``, ``compact_impl``,
``hbm_headroom``, ``miss_batch``) giving the same rows and logs across
its values.  Tolerance: exact equality."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch.engine.device_bfs import (
    HBM_HEADROOM,
    DeviceChecker,
)
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from tests.helpers import SMALL_CONFIGS, assert_valid_counterexample

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

LEAK, DUP = "CompactedLedgerLeak", "DuplicateNullKeyMessage"
PON = SMALL_CONFIGS["producer_on"]
METRIC_KEYS = {"level", "new_states", "distinct_states", "frontier",
               "wall_s", "host_wait_s", "states_per_sec", "visited_cap"}


def _port(c):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


@pytest.mark.parametrize("name,caps", [
    ("shipped", (3000, 5000)),
    ("shipped", (12000, 20000)),
    ("producer_on", (40, 120)),
    ("no_retain", (500, 2000)),
])
def test_host_seed_array_equal_to_jax(name, caps):
    """Rows (as u32 bit patterns), parents (roots ``-1 - init_idx`` in
    ``gen_initial``'s order), lanes and level sizes."""
    c = SMALL_CONFIGS[name]
    got = _port(c).host_seed(*caps)
    want = JModel(c).host_seed(*caps)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(got[3]) == list(want[3]) and len(got[3]) > 1


def _logs(ck, nv):
    return (ck.merged_rows()[: nv * ck.W], *ck.merged_logs())


def _jlogs(jck, nv, W):
    b = jck.last_bufs
    return tuple(np.asarray(b[k][: nv * w]) for k, w in
                 (("rows", W), ("parent", 1), ("lane", 1)))


CASES = {
    # name: (cfg, invariants, seed caps, JAX kwargs, port kwargs)
    "clean": (PON, (), (40, 120), dict(sub_batch=64, visited_cap=1 << 10,
                                       frontier_cap=1 << 10),
              dict(sub_batch=48)),
    "leak": (pe.SHIPPED_CFG, (LEAK,), (3000, 5000),
             dict(sub_batch=2048, visited_cap=1 << 16, frontier_cap=1 << 15),
             dict(sub_batch=700)),
    "dup_in_seed": (pe.SHIPPED_CFG, (DUP,), (12000, 20000),
                    dict(sub_batch=2048, visited_cap=1 << 16,
                         frontier_cap=1 << 15), dict(sub_batch=1024)),
    "frontier": (PON, (), (40, 120), dict(sub_batch=64, visited_cap=1 << 10,
                                          rows_window="frontier",
                                          row_cap_states=1 << 11),
                 dict(sub_batch=64, rows_window="frontier",
                      row_cap_states=1 << 11)),
}


@pytest.fixture(scope="module")
def jax_seeded():
    out = {}
    for name, (c, inv, caps, jkw, _kw) in CASES.items():
        seed = JModel(c).host_seed(*caps)
        jck = JChecker(JModel(c), invariants=inv, **jkw)
        out[name] = (jck, jck.run(seed=seed))
    return out


@pytest.mark.parametrize("fuse", ["level", "stage"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_seeded_run_equals_jax(jax_seeded, name, fuse):
    """The port's seed (``host_seed``, prestaged or not) gives the JAX
    seeded run's level sizes, violating gid, trace, rows and logs (the
    frontier window keeps no rows: logs only)."""
    c, inv, caps, _jkw, kw = CASES[name]
    jck, jr = jax_seeded[name]
    m = _port(c)
    seed = m.host_seed(*caps)
    ck = DeviceChecker(m, invariants=inv, fuse=fuse, device="cpu", **kw)
    if fuse == "level":
        ck.prestage_seed(seed)
    r = ck.run(seed=seed)
    assert (r.violation, r.violation_gid, r.diameter) == (
        jr.violation, jr.violation_gid, jr.diameter)
    nv = r.distinct_states
    if not inv or name == "dup_in_seed" or fuse == "level":
        assert r.level_sizes == jr.level_sizes
    else:  # the stage loop stops at the flush that found it
        assert r.level_sizes[:-1] == jr.level_sizes[:-1]
    want = _jlogs(jck, nv, ck.W)
    got = (_logs(ck, nv) if name != "frontier"
           else (None, *ck.merged_logs()))
    for a, b in zip(got, want):
        if a is not None:
            assert np.array_equal(a[: len(b)], b[: len(a)])
    if inv:
        assert [tuple(s) for s in r.trace] == [tuple(s) for s in jr.trace]
        assert r.trace_actions == jr.trace_actions
        assert_valid_counterexample(c, [pe.State(*s) for s in r.trace],
                                    r.trace_actions, inv[0])
    if name == "dup_in_seed":
        assert r.diameter == 4 < len(seed[3])


def test_seeded_run_accepts_the_jax_seed_tuple():
    """One seed (the JAX model's numpy tuple) feeds both engines."""
    jseed = JModel(PON).host_seed(40, 120)
    r = DeviceChecker(_port(PON), invariants=(), sub_batch=64,
                      device="cpu").run(seed=jseed)
    assert (r.distinct_states, r.diameter) == (1654, 16)


def _seed(n, lsizes, W=1):
    return (np.zeros((n, W), np.uint32), np.full(n, -1, np.int32),
            np.zeros(n, np.int32), lsizes)


def test_seed_guards():
    """Every guard of the seed loader raises on its own input."""
    m = _port(pe.SHIPPED_CFG)
    W = m.layout.W
    good = m.host_seed(3000, 5000)

    def run(seed, **kw):
        kw.setdefault("device", "cpu")
        return DeviceChecker(m, invariants=(), **kw).run(seed=seed)

    with pytest.raises(ValueError, match="do not sum"):
        run((*good[:3], list(good[3]) + [1]))
    with pytest.raises(ValueError, match="seed too large"):
        run(good, max_states=1000)
    with pytest.raises(ValueError, match="seed too large"):
        run(good, visited_impl="sort", seed_cap=4096)
    with pytest.raises(ValueError, match="mutually exclusive"):
        DeviceChecker(m, device="cpu", checkpoint_path="x.npz").run(
            seed=good, resume=True)
    # the first frontier guard: n + SEED_CHUNK > LCAP
    with pytest.raises(ValueError, match=r"seed \(3645 states\) exceeds"):
        run(good, sub_batch=64, rows_window="frontier",
            row_cap_states=1000)
    # the second one alone: the window admits the seed (n + SEED_CHUNK
    # <= LCAP, SEED_CHUNK = 2^15 < NQ) but not its frontier plus one
    # append window (lsizes[-1] + NQ > LCAP)
    nq = 5000 * m.A
    n = 36_001
    ck = DeviceChecker(m, invariants=(), sub_batch=5000,
                       rows_window="frontier", row_cap_states=1,
                       device="cpu")
    assert ck.LCAP == 2 * nq and n + (1 << 15) <= ck.LCAP < n - 1 + nq
    with pytest.raises(ValueError, match="seed frontier"):
        ck.run(seed=_seed(n, [1, n - 1], W))
    # distinct states only
    dup = (np.concatenate([good[0], good[0][-1:]]),
           np.concatenate([good[1], good[1][-1:]]),
           np.concatenate([good[2], good[2][-1:]]),
           list(good[3][:-1]) + [good[3][-1] + 1])
    with pytest.raises(ValueError, match="not all distinct"):
        run(dup)


def test_seeded_tiered_run_warns_and_equals_untiered(capsys):
    """A budget too small for the seed is overridden once (WARNING) and
    the run equals the untiered seeded run."""
    m = _port(pe.SHIPPED_CFG)
    seed = m.host_seed(3000, 5000)
    kw = dict(invariants=(), sub_batch=256, visited_cap=1 << 10,
              device="cpu")
    base = DeviceChecker(m, **kw)
    rb = base.run(seed=seed)
    probe = DeviceChecker(m, **kw)
    est = probe._device_bytes_est(probe.TCAP0, probe.WCAP0, probe.WCAP0)
    ck = DeviceChecker(m, hbm_budget=int(est / (1 - HBM_HEADROOM)) + 64,
                       progress=True, **kw)
    r = ck.run(seed=seed)
    assert capsys.readouterr().err.count(
        "WARNING: hbm_budget too small for the seed") == 1
    assert r.level_sizes == rb.level_sizes
    for a, b in zip(ck.merged_logs(), base.merged_logs()):
        assert np.array_equal(a, b)


def test_metrics_records_and_rewind(tmp_path):
    """One record a level with the JAX keys (and a seed anchor); a
    resumed run first drops the records past its frame's level."""
    m = _port(pe.SHIPPED_CFG)
    mpath = str(tmp_path / "m.jsonl")
    seed = m.host_seed(3000, 5000)
    r = DeviceChecker(m, invariants=(), sub_batch=512, metrics_path=mpath,
                      device="cpu").run(seed=seed)
    recs = [json.loads(x) for x in open(mpath)]
    assert all(set(x) == METRIC_KEYS for x in recs)
    assert [x["level"] for x in recs] == list(range(3, 21))
    assert recs[0]["new_states"] == 0 and recs[0]["frontier"] == 1458
    assert [x["new_states"] for x in recs[1:]] == r.level_sizes[3:]
    assert recs[-1]["distinct_states"] == 45198
    path = str(tmp_path / "f.npz")
    mp2 = str(tmp_path / "m2.jsonl")
    cut = DeviceChecker(m, invariants=(), sub_batch=512, metrics_path=mp2,
                        checkpoint_path=path, max_states=20000,
                        device="cpu")
    rc = cut.run()
    assert rc.truncated
    res = DeviceChecker(m, invariants=(), sub_batch=512, metrics_path=mp2,
                        checkpoint_path=path, device="cpu")
    res.run(resume=True)
    recs = [json.loads(x) for x in open(mp2)]
    cutlv = len(rc.level_sizes) - 1  # the frame rewinds the partial level
    mark = recs.index({"resumed_at_level": cutlv})
    assert [x["level"] for x in recs[:mark]] == list(range(2, cutlv + 1))
    assert [x["level"] for x in recs[mark + 1:]] == list(range(cutlv + 1, 21))


def _ref_run(c, **kw):
    ck = DeviceChecker(_port(c), invariants=(), device="cpu", **kw)
    return ck, ck.run()


@pytest.fixture(scope="module")
def pon_ref():
    return _ref_run(PON, sub_batch=64)


@pytest.mark.parametrize("kw", [
    dict(sub_batch=64, expand_chunk=16),
    dict(sub_batch=32, flush_factor=2),
    dict(sub_batch=16, flush_factor=3, expand_chunk=8, fuse="stage"),
    dict(sub_batch=64, group=1),
    dict(sub_batch=64, group=9, visited_cap=16),
    dict(sub_batch=64, frontier_cap=1 << 12),
    dict(sub_batch=64, compact_impl="sort"),
    dict(sub_batch=64, compact_impl="sort", fuse="stage"),
])
def test_knobs_keep_rows_and_logs(pon_ref, kw):
    ref, rr = pon_ref
    ck, r = _ref_run(PON, **kw)
    assert r.level_sizes == rr.level_sizes
    nv = r.distinct_states
    for a, b in zip(_logs(ck, nv), _logs(ref, nv)):
        assert np.array_equal(a, b)
    if "flush_factor" in kw:
        assert ck.NQ == kw["sub_batch"] * kw["flush_factor"] * ck.A


def test_fp_bits_on_a_hashed_binding():
    """618-bit states: ``fp_bits`` sets the key columns; the run's rows
    and logs do not depend on it (no collision at this size)."""
    wide = tpe.Constants(message_sent_limit=64, compaction_times_limit=3,
                         num_keys=8, num_values=2, retain_null_key=True,
                         max_crash_times=3, model_producer=True)
    runs = []
    for fp in (64, 96):
        ck = DeviceChecker(CompactionModel(wide), invariants=(),
                           sub_batch=256, max_states=3000, fp_bits=fp,
                           device="cpu")
        runs.append((ck, ck.run()))
        assert ck.K == fp // 32 and not ck.keys.exact
    (a, ra), (b, rb) = runs
    assert ra.level_sizes == rb.level_sizes
    nv = ra.distinct_states
    for x, y in zip(_logs(a, nv), _logs(b, nv)):
        assert np.array_equal(x, y)
    with pytest.raises(ValueError, match="fp_bits must be"):
        DeviceChecker(CompactionModel(wide), fp_bits=32, device="cpu")


@pytest.mark.parametrize("kw", [dict(hbm_headroom=0.3),
                                dict(miss_batch=64)])
def test_tier_knobs_keep_the_run(kw):
    """``hbm_headroom`` sizes the tier ceilings, ``miss_batch`` the cold
    lookups' batches: a tiered run under either equals the untiered
    run."""
    m = _port(SMALL_CONFIGS["no_retain"])
    base_kw = dict(invariants=(), sub_batch=64, visited_cap=1 << 10,
                   device="cpu")
    base = DeviceChecker(m, **base_kw)
    rb = base.run()
    probe = DeviceChecker(m, **base_kw)
    est = probe._device_bytes_est(probe.TCAP0, probe.WCAP0, probe.WCAP0)
    head = kw.get("hbm_headroom", HBM_HEADROOM)
    ck = DeviceChecker(m, hbm_budget=int(est / (1 - head)) + 4096,
                       **base_kw, **kw)
    r = ck.run()
    assert r.level_sizes == rb.level_sizes
    assert ck.last_stats["spill_evictions"] > 0
    for a, b in zip(ck.merged_logs(), base.merged_logs()):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        DeviceChecker(m, hbm_headroom=1.0, device="cpu")


def test_knob_refusals():
    m = _port(PON)
    with pytest.raises(ValueError, match="multiple of expand_chunk"):
        DeviceChecker(m, sub_batch=64, expand_chunk=24, device="cpu")
    with pytest.raises(ValueError, match="flush_factor"):
        DeviceChecker(m, flush_factor=0, device="cpu")
    with pytest.raises(ValueError, match="group"):
        DeviceChecker(m, group=0, device="cpu")
    with pytest.raises(ValueError, match="miss_batch"):
        DeviceChecker(m, miss_batch=-1, device="cpu")
