"""The port's CUDA kernels and engine on a card, against the plain
PyTorch versions on the same inputs.  Every test here needs a CUDA card
and skips without one.  This file imports no JAX, so it runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact equality (integer work)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu_torch.engine.device_bfs import (
    HBM_HEADROOM,
    DeviceChecker,
)
from pulsar_tlaplus_tpu_torch.kernels import build as kernels
from pulsar_tlaplus_tpu_torch.models import registry
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec, from_jax_arrays
from pulsar_tlaplus_tpu_torch.ref import pyeval
from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

pytestmark = pytest.mark.cuda
SPECS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "specs")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _rand_u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize(
    "total_bits,W,fp_bits",
    [(20, 1, None), (42, 2, None), (70, 3, None), (96, 3, 64),
     (137, 5, 64), (224, 7, 64), (618, 20, 64), (618, 20, 96)],
)
def test_key_plane_kernel(card, total_bits, W, fp_bits):
    """Every route of K2 (exact W = 2 unstaged, W = 20 staged, the
    runtime-width staged kernel: exact W = 1 and 3 and hashed W = 5 as
    the subscription, bookkeeper and georeplication specs key) with nc
    below one 256-row tile, not a multiple of it, and at the scaled
    run's window (2^16 x 34 rows)."""
    ks = KeySpec(total_bits, W, fp_bits)
    rng = np.random.default_rng(W)
    for nc in (1, 200, 4097, 100_003, (1 << 16) * 34):
        packed, valid = from_jax_arrays(
            _rand_u32(rng, (nc, W)), rng.random(nc) < 0.8, device=card
        )
        want = tiles.key_plane_plain(ks, packed, valid)
        got = tiles.key_plane(ks, packed, valid)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_key_plane_rejects_unaligned_rows(card):
    """The staged route bulk-copies 16-byte aligned tiles: rows that
    start 28 bytes into a buffer raise."""
    ks = KeySpec(224, 7, 64)
    packed = torch.zeros((1001, 7), dtype=torch.int32, device=card)
    valid = torch.ones((1000,), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="aligned"):
        tiles.key_plane(ks, packed[1:], valid)


@pytest.mark.parametrize("K,rounds", [(2, 8), (3, 8), (2, 3)])
def test_member_block_kernel(card, K, rounds):
    rng = np.random.default_rng(K * 10 + rounds)
    cap, n_fill, nq = 1 << 14, 6000, 20_011
    fill = from_jax_arrays(*(_rand_u32(rng, n_fill) for _ in range(K)))
    tcols = fpset.empty_cols(cap, K, "cpu")
    _n, tcols, pending, _r = fpset.probe_insert(
        tcols, fill, torch.ones(n_fill, dtype=torch.bool)
    )
    assert not pending.any()
    pick = rng.integers(0, n_fill, nq)
    fresh = rng.random(nq) < 0.4
    kcols = tuple(
        torch.where(torch.as_tensor(fresh),
                    from_jax_arrays(_rand_u32(rng, nq))[0], f[pick])
        for f in fill
    )
    valid = torch.as_tensor(rng.random(nq) < 0.9)
    want = tiles.member_block(tcols, kcols, valid, rounds)
    got = tiles.member_block(
        fpset.slot_major(tcols, card), tuple(t.to(card) for t in kcols),
        valid.to(card), rounds,
    )
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_kernels_reject_columnar_table(card):
    """K1 and K3 read the slot-major table through one pointer: K
    separate columns on the card raise instead of being copied."""
    tcols = tuple(torch.full((4097,), -1, dtype=torch.int32, device=card)
                  for _ in range(2))
    keys = tuple(torch.zeros((64,), dtype=torch.int32, device=card)
                 for _ in range(2))
    valid = torch.ones((64,), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="slot-major"):
        tiles.member_block(tcols, keys, valid)
    gen = torch.zeros((4097,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="slot-major"):
        tiles.sieve_mask_planes(tcols, gen, gen == 1)


@pytest.mark.parametrize("K,cap1", [(2, (1 << 20) + 1), (3, (1 << 20) + 1),
                                   (2, 4097), (3, 12_345)])
def test_sieve_mask_kernel(card, K, cap1):
    """K3 at odd slot counts on a slot-major table: all 2K + 1 planes
    equal the plain version's."""
    rng = np.random.default_rng(K * 7 + cap1)
    tcols = from_jax_arrays(*(_rand_u32(rng, cap1) for _ in range(K)))
    gen, cold = from_jax_arrays(
        rng.integers(0, 7, cap1).astype(np.int32), rng.random(cap1) < 0.4
    )
    want = tiles.sieve_mask_planes(tcols, gen, cold)
    got = tiles.sieve_mask_planes(
        fpset.slot_major(tcols, card), gen.to(card), cold.to(card)
    )
    for g, w in zip(got[0] + got[1] + (got[2],),
                    want[0] + want[1] + (want[2],)):
        assert torch.equal(g.cpu(), w)


def _filled(rng, cap, K, n_fill, device="cpu"):
    """A slot-major table holding ``n_fill`` random keys (plain insert on
    the CPU), and the keys."""
    fill = from_jax_arrays(*(_rand_u32(rng, n_fill) for _ in range(K)))
    tcols = fpset.empty_cols(cap, K, "cpu")
    _n, tcols, pending, _r = fpset.probe_insert(
        tcols, fill, torch.ones(n_fill, dtype=torch.bool)
    )
    assert not pending.any()
    return fpset.slot_major(tcols, device), fill


def _tail_vs_plain(card, tcols, ckeys, cids, npend, cw, n_ids):
    """H1 and its plain version on two copies of the card table: equal
    ``is_new``, stats and table slots (slot ``cap`` is the plain loop's
    trash row), and the bids left unclaimed."""
    cap = tcols[0].shape[0] - 1
    ta, tb = fpset.slot_major(tcols, card), fpset.slot_major(tcols, card)
    ca, cb = fpset.new_claims(cap, card), fpset.new_claims(cap, card)
    ck = tuple(c.to(card) for c in ckeys)
    ci = cids.to(card)
    npd = torch.full((), npend, dtype=torch.int64, device=card)
    got = fpset.insert_tail(ta, ck, ci, npd, cw, ca, n_ids)
    want = fpset.insert_tail_plain(tb, ck, ci, npd, cw, cb, n_ids)
    assert torch.equal(got[0][:n_ids], want[0][:n_ids])
    assert torch.equal(got[1], want[1])
    for a, b in zip(ta, tb):
        assert torch.equal(a[:cap], b[:cap])
    assert torch.equal(ca, fpset.new_claims(cap, card))
    return got


@pytest.mark.parametrize("K", [2, 3])
def test_insert_tail_kernel_flush(card, K):
    """A flush's tail: dup-heavy survivors of a half-full table, fewer
    survivors than lanes, several chunks."""
    rng = np.random.default_rng(40 + K)
    tcols, fill = _filled(rng, 1 << 16, K, 20_000)
    nq = 30_011
    pick = rng.integers(0, 20_000, nq)
    fresh = torch.as_tensor(rng.random(nq) < 0.5)
    keys = tuple(
        torch.where(fresh, from_jax_arrays(_rand_u32(rng, nq))[0], f[pick])
        for f in fill
    )
    ids = torch.as_tensor(np.sort(rng.choice(3 * nq, nq, replace=False))
                          .astype(np.int32))
    is_new, st = _tail_vs_plain(card, tcols, keys, ids, nq - 17, 7000,
                                3 * nq)
    assert 0 < int(is_new[:3 * nq].sum()) < nq and int(st[1]) == 0


def test_insert_tail_kernel_duplicates(card):
    """Every key eight times over the chunk: the lowest lane wins."""
    rng = np.random.default_rng(50)
    n = 8 * 4096
    base = from_jax_arrays(*(_rand_u32(rng, 4096) for _ in range(2)))
    perm = torch.as_tensor(rng.permutation(n))
    keys = tuple(c.repeat(8)[perm].contiguous() for c in base)
    tcols = fpset.empty_cols(1 << 16, 2, "cpu")
    is_new, _ = _tail_vs_plain(card, tcols, keys,
                               torch.arange(n, dtype=torch.int32), n, n, n)
    assert int(is_new[:n].sum()) == 4096


def test_insert_tail_kernel_long_chains(card):
    """A table filled to load 1/2 by the insert: long probe chains."""
    rng = np.random.default_rng(60)
    cap, n = 1 << 15, 6000
    tcols, _ = _filled(rng, cap, 2, cap // 2 - n)
    keys = from_jax_arrays(*(_rand_u32(rng, n) for _ in range(2)))
    _is_new, st = _tail_vs_plain(card, tcols, keys,
                                 torch.arange(n, dtype=torch.int32), n,
                                 1024, n)
    assert int(st[0]) > 6 * 8  # many rounds a chunk


@pytest.mark.parametrize("K", [2, 3])
def test_rehash_on_card_equals_cpu(card, K):
    """The rehash through H1: the CPU rehash's table, slot for slot."""
    rng = np.random.default_rng(70 + K)
    old, _ = _filled(rng, 1 << 16, K, 30_000)
    want, wf = fpset.rehash_cols(old, fpset.empty_cols(1 << 17, K, "cpu"),
                                 chunk=1 << 13)
    got, gf = fpset.rehash_cols(fpset.slot_major(old, card),
                                fpset.empty_cols(1 << 17, K, card),
                                chunk=1 << 13)
    assert int(gf) == int(wf) == 0
    for a, b in zip(got, want):
        assert torch.equal(a[:-1].cpu(), b[:-1])


def _tail_raw_vs_plain(card, tcols, ckeys, cids, npend, cw, n_ids,
                      max_probes=fpset.MAX_PROBES):
    """:func:`_tail_vs_plain` through a raw launch of H1 on the
    wrapper's arguments: also returns the kernel's grid rounds and grid
    barriers (``stats[2:]``)."""
    cap = tcols[0].shape[0] - 1
    ta, tb = fpset.slot_major(tcols, card), fpset.slot_major(tcols, card)
    ca, cb = fpset.new_claims(cap, card), fpset.new_claims(cap, card)
    ck = tuple(c.to(card) for c in ckeys)
    ci = cids.to(card)
    npd = torch.full((), npend, dtype=torch.int64, device=card)
    is_new = torch.zeros((n_ids + 1,), dtype=torch.bool, device=card)
    stats = torch.zeros((4,), dtype=torch.int64, device=card)
    args = fpset.insert_tail_args(
        ta, ck, ci, npd, cw, ca, is_new,
        torch.empty((2, len(ck) + 2, cw), dtype=torch.int32, device=card),
        torch.empty((2,), dtype=torch.int32, device=card), stats,
        max_probes)
    kernels.launch(*args)
    want = fpset.insert_tail_plain(tb, ck, ci, npd, cw, cb, n_ids,
                                   max_probes)
    assert torch.equal(is_new[:n_ids], want[0][:n_ids])
    assert torch.equal(stats[:2], want[1])
    for a, b in zip(ta, tb):
        assert torch.equal(a[:cap], b[:cap])
    assert torch.equal(ca, fpset.new_claims(cap, card))
    return stats.tolist()


# (cap_log2, K, keys filled, lanes, max_probes): each a path of H1's
# control flow with the tail width T = fpset.H1_TAIL (2048)
TAIL_PATHS = {
    # 20,000 fresh lanes on a near-empty table: ~750 left after round 0
    "crosses_T_in_round_0": (18, 2, 0, 20_000, 64),
    # load 1/2, two rounds: more than T lanes pending to the end
    "never_reaches_T": (17, 2, 1 << 16, 40_000, 2),
    # load 1/2: the count halves a round, the tail after a few rounds
    "tail_after_grid_rounds": (17, 2, (1 << 16) - 20_000, 20_000, 64),
    "tail_after_grid_rounds_K3": (17, 3, (1 << 16) - 20_000, 20_000, 64),
    # load 1/2, four rounds: failures in the grid and in the tail
    "max_probes_grid": (15, 2, 1 << 14, 12_000, 4),
    "max_probes_tail": (15, 2, 1 << 14, 1500, 4),
    "npend_0": (12, 2, 1000, 0, 64),
    "npend_1": (12, 2, 1000, 1, 64),
}


@pytest.mark.parametrize("path", sorted(TAIL_PATHS))
def test_insert_tail_kernel_paths(card, path):
    """Each path of H1's control flow (grid rounds, the block-local
    tail, both, a failing max_probes, npend 0 and 1) equals the plain
    loop: table slot for slot, is_new, probe rounds and failed lanes,
    bids unclaimed; the kernel's own grid-round count shows the path."""
    cap_log2, K, n_fill, n, max_probes = TAIL_PATHS[path]
    rng = np.random.default_rng(80 + cap_log2 * 3 + K + n)
    tcols, _ = _filled(rng, 1 << cap_log2, K, n_fill)
    m = max(n, 1)
    keys = from_jax_arrays(*(_rand_u32(rng, m) for _ in range(K)))
    ids = torch.arange(m, dtype=torch.int32)
    rounds, failed, grid_rounds, barriers = _tail_raw_vs_plain(
        card, tcols, keys, ids, n, m, m, max_probes)
    T = fpset.H1_TAIL
    if path == "crosses_T_in_round_0":
        # A_0, round 0's bid and decision, B_0, C_0 + A_1
        assert grid_rounds == 1 and rounds > 1 and barriers == 5
    elif path == "never_reaches_T":
        assert rounds == grid_rounds == 2 and failed > T
    elif path.startswith("tail_after_grid_rounds"):
        assert 2 <= grid_rounds < rounds and failed == 0
    elif path == "max_probes_grid":
        assert n > T and rounds == 4 and failed > 0
    elif path == "max_probes_tail":
        assert grid_rounds == 0 and rounds == 4 and failed > 0
    elif path == "npend_0":
        assert [rounds, failed, grid_rounds, barriers] == [0, 0, 0, 0]
    else:  # one lane: the tail alone, no grid barrier
        assert rounds >= 1 and [failed, grid_rounds, barriers] == [0, 0, 0]


def test_insert_tail_rejects_columnar_table(card):
    tcols = tuple(torch.full((4097,), -1, dtype=torch.int32, device=card)
                  for _ in range(2))
    keys = tuple(torch.zeros((64,), dtype=torch.int32, device=card)
                 for _ in range(2))
    ids = torch.arange(64, dtype=torch.int32, device=card)
    npend = torch.full((), 64, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="slot-major"):
        fpset.insert_tail(tcols, keys, ids, npend, 64,
                          fpset.new_claims(4096, card), 64)


def test_tiered_engine_on_card_equals_cpu(card):
    """The 253,361-state config under a budget that forces eviction: the
    CPU run's level sizes and merged rows and logs."""
    m = CompactionModel(dataclasses.replace(
        pyeval.SHIPPED_CFG, model_producer=True, retain_null_key=False
    ))
    kw = dict(invariants=(), sub_batch=4096, visited_cap=1 << 12)
    p = DeviceChecker(m, device="cpu", hbm_budget="1T", **kw)
    kw["hbm_budget"] = int(p._device_bytes_est(p.TCAP0, p.WCAP0, p.WCAP0)
                           / (1.0 - HBM_HEADROOM)) + 4096
    a = DeviceChecker(m, device="cpu", **kw)
    b = DeviceChecker(m, device=card, **kw)
    ra, rb = a.run(), b.run()
    assert (rb.distinct_states, rb.diameter) == (253361, 23)
    assert rb.level_sizes == ra.level_sizes
    assert b.last_stats["spill_evictions"] >= 1
    assert np.array_equal(b.merged_rows(), a.merged_rows())
    for x, y in zip(b.merged_logs(), a.merged_logs()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("fuse", ["level", "stage"])
def test_engine_on_card_equals_cpu(card, fuse):
    """The shipped cfg on the card: the CPU run's rows and logs."""
    m = CompactionModel(pyeval.SHIPPED_CFG)
    a = DeviceChecker(m, sub_batch=1000, device="cpu")
    b = DeviceChecker(m, sub_batch=1000, device=card, fuse=fuse)
    ra, rb = a.run(), b.run()
    assert (rb.distinct_states, rb.diameter) == (45198, 20)
    assert rb.level_sizes == ra.level_sizes
    for k in ("rows", "parent", "lane"):
        n = ra.distinct_states * (a.W if k == "rows" else 1)
        assert torch.equal(b.last_bufs[k][:n].cpu(), a.last_bufs[k][:n])


@pytest.mark.parametrize("fuse", ["level", "stage"])
@pytest.mark.parametrize("spec,states,diameter", [
    ("subscription", 2272, 24), ("bookkeeper", 297, 14),
    ("georeplication", 6400, 18)])
def test_spec_engine_on_card_equals_cpu(card, spec, states, diameter, fuse):
    """The shipped cfgs of the other three specs on the card (exact keys
    at W = 1, 1 and 2): the CPU run's rows and logs."""
    tlc = cfgmod.load(os.path.join(SPECS, f"{spec}.cfg"))
    m, _c = registry.COMPILED[spec](tlc)
    a = DeviceChecker(m, sub_batch=200, device="cpu")
    b = DeviceChecker(m, sub_batch=200, device=card, fuse=fuse)
    ra, rb = a.run(), b.run()
    assert (rb.distinct_states, rb.diameter) == (states, diameter)
    assert rb.level_sizes == ra.level_sizes
    for k in ("rows", "parent", "lane"):
        n = ra.distinct_states * (a.W if k == "rows" else 1)
        assert torch.equal(b.last_bufs[k][:n].cpu(), a.last_bufs[k][:n])


def test_key_plane_kernel_at_the_sweep_shape(card):
    """K2 on a liveness sweep chunk's successor lanes (2^14 states of
    the 253,361-state config x A = 16, exact W = 2, invalid lanes
    masked): equal to its plain version."""
    from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker

    c = dataclasses.replace(pyeval.SHIPPED_CFG, model_producer=True,
                            retain_null_key=False)
    lc = LivenessChecker(CompactionModel(c), frontier_chunk=4096,
                         visited_cap=1 << 18, device=card)
    lc._explore()
    m = lc.model
    succ, valid = m.successors(m.layout.unpack(lc._rows[: lc.SF]))
    packed = m.layout.pack(succ).reshape(-1, m.layout.W)
    vq = valid.reshape(-1)
    got = tiles.key_plane(lc.keys, packed, vq)
    want = tiles.key_plane_plain(lc.keys, packed, vq)
    assert packed.shape[0] == lc.SF * m.A
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fairness", ["none", "wf_next"])
def test_liveness_on_card_equals_cpu(card, fairness):
    """The liveness checker on the card: the CPU run's verdict, lasso
    and edge list, at several sweep chunks and groups."""
    from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker

    c = dataclasses.replace(pyeval.SHIPPED_CFG, message_sent_limit=2,
                            compaction_times_limit=2, num_keys=1,
                            num_values=1, model_producer=True,
                            model_consumer=True)
    runs = {}
    for dev in (card, "cpu"):
        lc = LivenessChecker(CompactionModel(c), fairness=fairness,
                             frontier_chunk=256, sweep_chunk=256,
                             sweep_group=3, visited_cap=1 << 13, device=dev)
        r = lc.run()
        runs[str(dev)] = (r.holds, r.reason, r.lasso_prefix, r.lasso_cycle,
                          lc._edge_cache)
    a, b = runs.values()
    assert a[:4] == b[:4]
    if fairness == "wf_next":
        for x, y in zip(a[4], b[4]):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("inv", ["CompactedLedgerLeak",
                                 "DuplicateNullKeyMessage"])
def test_simulation_on_card_equals_cpu(card, inv):
    """The same seed walks the same on the card and on the CPU: trace,
    counters, violation."""
    from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator

    runs = [
        StreamingSimulator(CompactionModel(pyeval.SHIPPED_CFG),
                           invariants=(inv,), n_walkers=512, depth=64,
                           seed=1, max_rounds=40, device=dev).run()
        for dev in (card, "cpu")
    ]
    a, b = runs
    assert a.violation == b.violation == inv
    assert a.verified is b.verified is True
    for f in ("trace", "trace_actions", "steps", "states_visited",
              "violation_walker", "violation_step"):
        assert getattr(a, f) == getattr(b, f), f
    keys = [k for k in a.stats if "per_sec" not in k]
    assert [a.stats[k] for k in keys] == [b.stats[k] for k in keys]


def _compiled(spec, device, **overrides):
    from pulsar_tlaplus_tpu_torch.frontend.codegen import CompiledSpec
    from pulsar_tlaplus_tpu_torch.frontend.interp import Spec
    from pulsar_tlaplus_tpu_torch.frontend.loader import bind_cfg
    from pulsar_tlaplus_tpu_torch.frontend.parser import parse_file

    tlc = cfgmod.load(os.path.join(SPECS, f"{spec}.cfg"))
    ast = parse_file(os.path.join(SPECS, f"{spec}.tla"))
    consts = bind_cfg(ast, tlc)
    consts.pop("__string_interning__")
    consts.update(overrides)
    return CompiledSpec(Spec(ast, consts), invariants=tuple(tlc.invariants),
                        device=device)


@pytest.mark.parametrize("spec", ["compaction", "georeplication"])
def test_compiled_model_on_card_equals_cpu(card, spec):
    """The compiled model's successors (packed), valid, invariants and
    goals on the card equal the CPU's on reachable states, at three
    buckets: 300, 5,000 and 90,000 rows (the shipped cfg's states twice
    over), padded to 1,024, 2^14 and 2^18 rows."""
    cpu = _compiled(spec, "cpu")
    gpu = _compiled(spec, card)
    ck = DeviceChecker(cpu, device="cpu", max_states=50_000)
    ck.run()
    rows = torch.as_tensor(ck.merged_rows().view(np.int32)).view(
        -1, cpu.layout.W)
    rows = torch.cat([rows] * (1 + 90_000 // rows.shape[0]))
    for n in (300, 5000, 90_000):
        s_cpu = cpu.layout.unpack(rows[:n])
        s_gpu = gpu.layout.unpack(rows[:n].to(card))
        sc, vc = cpu.successors(s_cpu)
        sg, vg = gpu.successors(s_gpu)
        assert torch.equal(gpu.layout.pack(sg).cpu(), cpu.layout.pack(sc))
        assert torch.equal(vg.cpu(), vc)
        for fns_c, fns_g in ((cpu.invariants, gpu.invariants),
                             (cpu.liveness_goals, gpu.liveness_goals)):
            for name in fns_c:
                assert torch.equal(fns_g[name](s_gpu).cpu(),
                                   fns_c[name](s_cpu)), name


def test_frame_written_on_card_restores_on_cpu(card, tmp_path):
    """A frame written by a run on the card resumes on the CPU, and
    that run equals the uninterrupted run on the CPU state for state."""
    m = CompactionModel(pyeval.SHIPPED_CFG)
    path = str(tmp_path / "f.npz")
    r1 = DeviceChecker(m, checkpoint_path=path, checkpoint_every=3,
                       max_states=10_000).run()
    assert r1.truncated and r1.stop_reason == "max_states"
    ck = DeviceChecker(m, checkpoint_path=path, device="cpu")
    r2 = ck.run(resume=True)
    full = DeviceChecker(m, device="cpu")
    r3 = full.run()
    assert (r2.distinct_states, r2.level_sizes) == (45198, r3.level_sizes)
    for a, b in zip(ck.merged_logs(), full.merged_logs()):
        assert np.array_equal(a, b)
    assert np.array_equal(ck.merged_rows(), full.merged_rows())


def test_real_device_oom_recovers_or_truncates(card, tmp_path):
    """A real ``torch.OutOfMemoryError``: once the first frame is on
    disk, the caching allocator is capped at what it holds, so the next
    table or store growth fails.  The run recovers from the frame and
    completes, or ends ``hbm`` with exact counts; it never falls back to
    the CPU."""
    c = dataclasses.replace(pyeval.SHIPPED_CFG, model_producer=True,
                            retain_null_key=False)
    m = CompactionModel(c)
    full = DeviceChecker(m, invariants=(), sub_batch=256).run()
    torch.cuda.empty_cache()
    idx = torch.cuda.current_device()
    total = torch.cuda.get_device_properties(idx).total_memory
    ck = DeviceChecker(m, invariants=(), sub_batch=256,
                       checkpoint_path=str(tmp_path / "f.npz"),
                       checkpoint_every=1)
    save = ck._save_frame

    def capped(*a):
        ok = save(*a)
        if ok and ck._ckpt_frames == 1:
            torch.cuda.set_per_process_memory_fraction(
                torch.cuda.memory_reserved(idx) / total, idx)
        return ok

    ck._save_frame = capped
    try:
        r = ck.run()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, idx)
        torch.cuda.empty_cache()
    assert ck.device.type == "cuda"
    assert r.hbm_recovered >= 1 or r.stop_reason == "hbm"
    if r.truncated:
        assert r.stop_reason == "hbm"
        n = len(r.level_sizes)
        assert r.level_sizes[:n - 1] == full.level_sizes[:n - 1]
    else:
        assert r.level_sizes == full.level_sizes


@pytest.mark.parametrize("slices", [1, 2])
def test_sharded_engine_on_card_equals_cpu(card, slices):
    """Four shards on one card (a 1-D mesh and a 2 x 2 one) equal four
    shards on the CPU state for state: every shard's rows, parent and
    lane logs, the level sizes, the violating gid and the trace."""
    from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
        ShardedDeviceChecker,
    )

    kw = dict(n_devices=4, n_slices=slices,
              invariants=("CompactedLedgerLeak",), sub_batch=512,
              visited_cap=1 << 13)
    m = CompactionModel(pyeval.SHIPPED_CFG)
    cpu = ShardedDeviceChecker(m, device="cpu", **kw)
    rc = cpu.run()
    gpu = ShardedDeviceChecker(m, device=card, **kw)
    rg = gpu.run()
    assert (rg.violation, rg.diameter) == ("CompactedLedgerLeak", 12)
    assert (rg.level_sizes, rg.violation_gid, rg.trace) == (
        rc.level_sizes, rc.violation_gid, rc.trace)
    assert gpu.mesh.devices == [gpu.device] * 4
    for s in range(4):
        n = int(cpu.last_stats_matrix[s, 0])
        assert n == int(gpu.last_stats_matrix[s, 0])
        for k in ("rows", "parent", "lane"):
            w = gpu.W if k == "rows" else 1
            assert torch.equal(gpu.last_bufs[k][s][: n * w].cpu(),
                               cpu.last_bufs[k][s][: n * w]), (k, s)


# ---- the eleventh slice: make_keys, the host engines' hash table, the
# host engines, seeded starts and the sort-merge visited set


@pytest.mark.parametrize("total_bits,W", [(20, 1), (42, 2), (70, 3),
                                          (137, 5), (618, 20)])
def test_make_keys_kernel(card, total_bits, W):
    """``dedup.make_keys`` through K2 (``KeySpec(bits, W, 96)``, a zero
    column appended at two columns) against its plain version."""
    from pulsar_tlaplus_tpu_torch.ops import dedup

    rng = np.random.default_rng(total_bits)
    words = _rand_u32(rng, (50_001, W))
    if total_bits < 32 * W:
        words[:, -1] &= (1 << (total_bits - 32 * (W - 1))) - 1
    (packed,) = from_jax_arrays(words, device=card)
    before = kernels.LAUNCHES["key_plane"]
    got = dedup.make_keys(packed, total_bits)
    assert kernels.LAUNCHES["key_plane"] == before + 1
    want = dedup.make_keys(packed.cpu(), total_bits)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_hashtable_lookup_insert_on_card(card):
    """The host engines' lookup-or-insert: K1 + H1 on the card against
    ``fpset.probe_insert`` on the CPU, with duplicates in the batch and
    in the table; the same new lanes and the same key set."""
    from pulsar_tlaplus_tpu_torch.ops import hashtable

    rng = np.random.default_rng(5)
    keys = _rand_u32(rng, (3, 40_000))
    keys[:, 20_000:] = keys[:, :20_000]  # every key twice
    valid = rng.random(40_000) < 0.9
    tabs = {}
    for d in (card, torch.device("cpu")):
        t = hashtable.empty_table(1 << 17, d)
        k = from_jax_arrays(*keys, device=d)
        (v,) = from_jax_arrays(valid, device=d)
        m0 = dict(kernels.LAUNCHES)
        new1, t, f1 = hashtable.lookup_insert(t, k[:3], v[:], None)
        new2, t, f2 = hashtable.lookup_insert(t, k[:3], v[:], None)
        if d.type == "cuda":
            assert kernels.LAUNCHES["member_block"] > m0["member_block"]
            assert kernels.LAUNCHES["insert_tail"] > m0["insert_tail"]
        assert int(f1) == 0 and int(f2) == 0 and not bool(new2.any())
        occ = ~fpset.all_sentinel(t)
        occ[-1] = False  # the trash slot holds whatever parked lanes wrote
        tabs[d.type] = (new1.cpu(), sorted(zip(*[c[occ].cpu().tolist()
                                                  for c in t])))
    assert torch.equal(tabs["cuda"][0], tabs["cpu"][0])
    assert tabs["cuda"][1] == tabs["cpu"][1]


@pytest.mark.parametrize("dedup", ["hash", "sort"])
def test_host_engine_on_card_equals_cpu(card, dedup):
    """``engine/bfs.Checker`` on the card (K2 keys; hash: K1 + H1)
    against the CPU: the same log record for record and the same
    counterexample."""
    from pulsar_tlaplus_tpu_torch.engine.bfs import Checker

    m = CompactionModel(pyeval.SHIPPED_CFG)
    runs = []
    for d in (card, "cpu"):
        ck = Checker(m, invariants=("CompactedLedgerLeak",), dedup=dedup,
                     keep_log=True, device=d)
        r = ck.run()
        lg = ck.last_run_state.log
        runs.append((r.violation_gid, r.trace, lg.packed_matrix(),
                     lg.parents(), lg.actions()))
    assert runs[0][:2] == runs[1][:2] and runs[0][0] is not None
    for a, b in zip(runs[0][2:], runs[1][2:]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("visited", ["fpset", "sort"])
def test_seeded_engine_on_card_equals_cpu(card, visited):
    """A seeded ``DeviceChecker`` (the seed's keys through K2 and K1 +
    H1, or the sort-merge set) on the card against the CPU."""
    m = CompactionModel(pyeval.SHIPPED_CFG)
    seed = m.host_seed(3000, 5000)
    runs = []
    for d in (card, "cpu"):
        ck = DeviceChecker(m, invariants=("CompactedLedgerLeak",),
                           sub_batch=1024, visited_impl=visited, device=d)
        r = ck.run(seed=seed)
        runs.append((r.level_sizes, r.violation_gid, ck.merged_rows(),
                     *ck.merged_logs()))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2:], runs[1][2:]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dedup,slices", [("sort", 1), ("hash", 2)])
def test_sharded_host_on_card_equals_cpu(card, dedup, slices):
    """``engine/sharded.ShardedChecker`` on the card against the CPU,
    log record for record."""
    from pulsar_tlaplus_tpu_torch.engine.sharded import ShardedChecker
    from pulsar_tlaplus_tpu_torch.parallel.mesh import make_mesh2d

    c = dataclasses.replace(pyeval.SHIPPED_CFG, compaction_times_limit=2)
    logs = []
    for d in (card, "cpu"):
        ck = ShardedChecker(CompactionModel(c), dedup_mode=dedup,
                            frontier_chunk=512,
                            mesh=make_mesh2d(slices, 4 // slices, d))
        r = ck.run()
        lg = ck.last_log
        logs.append((r.level_sizes, lg.packed_matrix(), lg.parents(),
                     lg.actions()))
    assert logs[0][0] == logs[1][0]
    for a, b in zip(logs[0][1:], logs[1][1:]):
        assert np.array_equal(a, b)


def test_sharded_sort_on_card_equals_cpu(card):
    """``ShardedDeviceChecker(visited_impl="sort")`` on the card against
    the CPU, shard for shard."""
    from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
        ShardedDeviceChecker,
    )

    m = CompactionModel(pyeval.SHIPPED_CFG)
    runs = []
    for d in (card, "cpu"):
        ck = ShardedDeviceChecker(m, n_devices=4, sub_batch=256,
                                  visited_cap=1 << 10, visited_impl="sort",
                                  device=d)
        r = ck.run()
        runs.append((r, ck))
    (ra, a), (rb, b) = runs
    assert (ra.distinct_states, ra.diameter) == (45198, 20)
    assert ra.level_sizes == rb.level_sizes
    for s in range(4):
        n = int(a.last_stats_matrix[s, 0])
        for k, w in (("rows", a.W), ("parent", 1), ("lane", 1)):
            assert torch.equal(a.last_bufs[k][s][: n * w].cpu(),
                               b.last_bufs[k][s][: n * w].cpu())


def test_fpset_insert_on_card_equals_probe_insert(card):
    """``FPSet.insert`` through K1 + H1 (``tiles.flush_tiles``) against
    the plain ``probe_insert`` on the same batches: the same new lanes,
    the same count and the same keys in the table; growth rehashes
    through H1."""
    rng = np.random.default_rng(12)
    fs = fpset.FPSet(2, cap=1 << 10, device=card)
    cols = fpset.empty_cols(1 << 16, 2, "cpu")
    for n in (1000, 5000, 20000):
        k = rng.integers(0, 30000, size=(2, n), dtype=np.int64).astype(
            np.int32)
        k[1] = k[0] * 7 + 1
        got = fs.insert(tuple(torch.from_numpy(c).to(card) for c in k))
        want, cols, pending, _r = fpset.probe_insert(
            cols, tuple(torch.from_numpy(c) for c in k),
            torch.ones((n,), dtype=torch.bool))
        assert not bool(pending.any())
        assert torch.equal(got.cpu(), want)
    occ = ~fpset.all_sentinel(tuple(x[:-1] for x in cols))
    assert fs.n == int(occ.sum())
    keys = tuple(c[:-1][occ] for c in cols)
    assert bool(fs.contains(tuple(c.to(card) for c in keys)).all())


def test_telemetry_adds_no_card_sync(card, tmp_path):
    """The same run with and without a telemetry stream and a heartbeat:
    equal ``host_syncs`` and equal synchronizing calls on the card
    (PyTorch's sync debug mode warns at each), and a valid stream."""
    import warnings

    from pulsar_tlaplus_tpu_torch.obs import schema

    c = dataclasses.replace(pyeval.SHIPPED_CFG, model_producer=True,
                            retain_null_key=False)
    got = []
    for on in (False, True, True, False):
        kw = (dict(telemetry=str(tmp_path / f"s{len(got)}.jsonl"),
                   heartbeat_s=0.05) if on else {})
        ck = DeviceChecker(CompactionModel(c), invariants=(), device=card,
                           **kw)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                r = ck.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert r.distinct_states == 253361
        got.append((ck.last_stats["host_syncs"],
                    sum("synchroniz" in str(w.message) for w in caught)))
        if on:
            assert schema.validate_stream(kw["telemetry"]) == []
    assert len(set(got)) == 1, got


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    """A fresh tuned-profile directory, adaptation off unless asked."""
    monkeypatch.setenv("PTT_TUNE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("PTT_TUNE_ADAPT", raising=False)
    return tmp_path


def test_flush_at_the_tuners_schedules_on_card(card):
    """The tiled flush at dense_rounds 16 (K1 at 16 rounds) and at a
    budget of 32 probes (H1's max_probes) on the card, against the same
    flush on the CPU: ``is_new``, ``n_new``, the metrics and the table."""
    rng = np.random.default_rng(1616)
    cap, k, nq = 1 << 17, 2, 40_000
    fill = tuple(_rand_u32(rng, 20_000) for _ in range(k))
    kc = tuple(np.concatenate([f[rng.integers(0, 20_000, nq // 2)],
                               _rand_u32(rng, nq - nq // 2)]) for f in fill)
    for dense, stages in ((16, None), (4, ((4, 8), (8, 32)))):
        got = []
        for dev in (card, torch.device("cpu")):
            t = fpset.empty_cols(cap, k, dev)
            fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64, device=dev)
            t, _, _, fpm = tiles.flush_acc_tiles(
                t, from_jax_arrays(*fill, device=dev), 20_000, fpm, None,
                dense, stages)
            t, n, flag, fpm = tiles.flush_acc_tiles(
                t, from_jax_arrays(*kc, device=dev), nq - 3, fpm, None,
                dense, stages)
            got.append((n, flag.cpu(), fpm.tolist(),
                        [c[:cap].cpu() for c in t]))
        (na, fa, ma, ta), (nb, fb, mb, tb) = got
        assert na == nb > 0 and torch.equal(fa, fb) and ma == mb
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))


def test_adapted_run_on_card_equals_default(card, tune_dir):
    """The 253,361-state config with and without ``adapt=True``: level
    sizes, rows and logs equal, and the same host syncs."""
    c = dataclasses.replace(pyeval.SHIPPED_CFG, model_producer=True,
                            retain_null_key=False)
    runs = []
    for adapt in (False, True):
        ck = DeviceChecker(CompactionModel(c), invariants=(), device=card,
                           adapt=adapt, sub_batch=4096)
        r = ck.run()
        nv = r.distinct_states
        runs.append((r.level_sizes, ck.last_stats["host_syncs"],
                     [ck.last_bufs[n][: nv * (ck.W if n == "rows" else 1)]
                      .cpu() for n in ("rows", "parent", "lane")]))
    (la, ha, ba), (lb, hb, bb) = runs
    assert sum(la) == 253361 and la == lb and ha == hb
    assert all(torch.equal(a, b) for a, b in zip(ba, bb))


def test_cli_tune_on_card_then_check_resolves(card, tune_dir, capsys):
    """``cli tune bookkeeper`` on the card writes a ``cuda`` profile that
    validates, and ``check`` resolves it (its header names the sig)."""
    import json

    from pulsar_tlaplus_tpu_torch import cli
    from pulsar_tlaplus_tpu_torch.obs import schema

    assert cli.main(["tune", "bookkeeper", "--top-k", "1",
                     "--repeat", "1"]) == 0
    path = capsys.readouterr().out.strip().splitlines()[-1].split(
        "profile: ")[1]
    with open(path) as f:
        prof = json.load(f)
    assert prof["backend"] == "cuda"
    assert schema.validate_profile_file(path) == []
    s = str(tune_dir / "check.jsonl")
    assert cli.main(["check", os.path.join(SPECS, "bookkeeper.tla"),
                     "-telemetry", s]) == 0
    assert "297 distinct states found" in capsys.readouterr().out
    with open(s) as f:
        assert json.loads(f.readline())["profile_sig"] == prof["sig"]


# ---- the checker daemon (service/, warm/) on the card ----------------------

DAEMON_GEOM = dict(sub_batch=64, visited_cap=1 << 10, frontier_cap=1 << 8,
                   max_states=1 << 20, checkpoint_every=1)
BK_CRASH2 = """
CONSTANTS
    NumBookies = 3
    WriteQuorum = 2
    AckQuorum = 2
    EntryLimit = 2
    MaxBookieCrashes = 2
SPECIFICATION Spec
INVARIANTS
    ConfirmedEntryReadable
"""


def _daemon_solo(path, spec, dev):
    tlc = cfgmod.load(path)
    model, _ = registry.COMPILED[spec](tlc)
    geom = {k: v for k, v in DAEMON_GEOM.items() if k != "checkpoint_every"}
    return DeviceChecker(model, invariants=tuple(tlc.invariants),
                         device=dev, **geom).run()


def test_daemon_time_slices_the_card_equal_to_cpu(card, tune_dir):
    """Two jobs time-sliced on the card at a zero slice (every boundary
    after a slice's first suspends while the other waits): each result
    equals a solo CPU run of the same cfg (counts, level sizes, verdict,
    trace), and after every suspend the pooled checker holds no device
    memory."""
    from pulsar_tlaplus_tpu_torch.service.scheduler import (
        Scheduler,
        ServiceConfig,
    )

    bk = tune_dir / "bk.cfg"
    bk.write_text(BK_CRASH2)
    shipped = os.path.join(SPECS, "compaction.cfg")
    sched = Scheduler(ServiceConfig(state_dir=str(tune_dir / "s"),
                                    slice_s=0.0, **DAEMON_GEOM))
    assert sched.pool.device.type == "cuda"
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(card)
    after = []
    run_slice = sched._run_slice

    def slice_(job, device=0):
        run_slice(job, device)
        if job.state == "suspended":
            after.append(torch.cuda.memory_allocated(card) - base)

    sched._run_slice = slice_
    jobs = [sched.submit("compaction", shipped),
            sched.submit("bookkeeper", str(bk))]
    sched.run_until_idle()
    assert after and max(after) < 1 << 20
    for job, (path, spec) in zip(jobs, ((shipped, "compaction"),
                                        (str(bk), "bookkeeper"))):
        solo = _daemon_solo(path, spec, "cpu")
        r = job.result
        assert job.suspends >= 1
        assert (r["distinct_states"], r["level_sizes"], r["violation"],
                r["violation_gid"]) == (solo.distinct_states,
                                        solo.level_sizes, solo.violation,
                                        solo.violation_gid)
        assert r["trace"] == (None if solo.trace is None
                              else [repr(s) for s in solo.trace])


def test_daemon_warm_continue_and_reseed_on_card(card, tune_dir):
    """A truncated job resubmitted continues from its artifact, and a
    widened MaxCrashTimes reseeds from one, on the card: counts equal
    the cold runs on the CPU."""
    from pulsar_tlaplus_tpu_torch.service.scheduler import (
        Scheduler,
        ServiceConfig,
    )

    sub = """
CONSTANTS
    MessageLimit = 2
    MaxCrashTimes = %d
SPECIFICATION Spec
INVARIANTS
"""
    for n in (2, 3):
        (tune_dir / f"sub{n}.cfg").write_text(sub % n)
    shipped = os.path.join(SPECS, "compaction.cfg")
    sched = Scheduler(ServiceConfig(state_dir=str(tune_dir / "s"),
                                    **DAEMON_GEOM))
    j1 = sched.submit("compaction", shipped, max_states=9_000)
    sched.run_until_idle()
    j2 = sched.submit("compaction", shipped)
    assert j2.warm_mode == "continue"
    s1 = sched.submit("subscription", str(tune_dir / "sub2.cfg"))
    sched.run_until_idle()
    s2 = sched.submit("subscription", str(tune_dir / "sub3.cfg"))
    assert (s2.warm_mode, s2.warm_reason) == ("reseed",
                                              "widened:MaxCrashTimes")
    sched.run_until_idle()
    assert j1.result["status"] == "truncated" and s1.result["status"] == "ok"
    assert (j2.result["distinct_states"], j2.result["diameter"]) == (45198,
                                                                   20)
    cold = _daemon_solo(str(tune_dir / "sub3.cfg"), "subscription", "cpu")
    assert s2.result["warm"] == "reseed"
    assert s2.result["distinct_states"] == cold.distinct_states


def test_daemon_refuses_more_slots_than_cards(card, tune_dir):
    from pulsar_tlaplus_tpu_torch.service.scheduler import ServiceConfig

    n = torch.cuda.device_count()
    cfg = ServiceConfig(state_dir=str(tune_dir / "s"), devices=n + 1)
    with pytest.raises(ValueError, match="CUDA device"):
        cfg.slot_devices()
    assert [d.index for d in ServiceConfig(
        state_dir=str(tune_dir / "s"), devices=n).slot_devices()] == \
        list(range(n))


def test_fleet_of_two_backends_on_the_card(card, tune_dir):
    """Two daemons with a slot each on the one card behind a dispatcher:
    the shipped cfg routed to 45,198 / 20, and a truncated job's artifact
    replicated to the peer, where a resubmit continues from it to the
    CPU run's counts."""
    import shutil
    import tempfile
    import time

    from pulsar_tlaplus_tpu_torch.fleet.dispatcher import (
        FleetConfig,
        FleetDispatcher,
    )
    from pulsar_tlaplus_tpu_torch.service.client import ServiceClient
    from pulsar_tlaplus_tpu_torch.service.scheduler import ServiceConfig
    from pulsar_tlaplus_tpu_torch.service.server import ServiceDaemon

    root = tempfile.mkdtemp(prefix="pttc")  # socket paths: 107 bytes
    shipped = os.path.join(SPECS, "compaction.cfg")
    daemons = [ServiceDaemon(ServiceConfig(
        state_dir=os.path.join(root, n), slice_s=0.5, **DAEMON_GEOM))
        for n in ("b0", "b1")]
    disp = None
    try:
        for d in daemons:
            assert d.sched.pool.device.type == "cuda"
            d.start()
        addrs = [d.config.socket_path for d in daemons]
        disp = FleetDispatcher(FleetConfig(
            state_dir=os.path.join(root, "d"), backends=tuple(addrs),
            health_interval_s=0.2))
        disp.start()
        cl = ServiceClient(disp.config.socket_path, timeout=600.0)
        r = cl.submit("compaction", shipped, full=True)
        w = cl.wait(r["job_id"], timeout=600.0)
        assert r["backend"] in addrs and w["backend"] == r["backend"]
        assert (w["result"]["distinct_states"],
                w["result"]["diameter"]) == (45198, 20)
        probe = cl.submit("bookkeeper", shipped.replace(
            "compaction.cfg", "bookkeeper.cfg"), max_states=150, full=True)
        assert cl.wait(probe["job_id"], timeout=600.0)["result"][
            "status"] == "truncated"
        peer = daemons[1 - addrs.index(probe["backend"])]
        end = time.time() + 120
        while not [m for _a, m in peer.sched.warm_store.manifests()
                   if m.get("spec") == "bookkeeper"]:
            assert time.time() < end, "the artifact never reached the peer"
            time.sleep(0.1)
        pcl = ServiceClient(peer.config.socket_path, timeout=600.0)
        wide = pcl.submit("bookkeeper", shipped.replace(
            "compaction.cfg", "bookkeeper.cfg"), full=True)
        assert wide["warm_mode"] == "continue"
        got = pcl.wait(wide["job_id"], timeout=600.0)["result"]
        cold = _daemon_solo(shipped.replace("compaction.cfg",
                                            "bookkeeper.cfg"),
                            "bookkeeper", "cpu")
        assert got["warm"] == "continue"
        assert (got["distinct_states"], got["level_sizes"]) == (
            cold.distinct_states, cold.level_sizes)
    finally:
        if disp is not None:
            disp.shutdown()
        for d in daemons:
            d.shutdown()
        shutil.rmtree(root, ignore_errors=True)
