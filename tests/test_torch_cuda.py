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
