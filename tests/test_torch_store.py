"""The port's tiered state store on the CPU, against the JAX package.

The budget knob, the codecs, the RAM tier, the sieve ops and the
sieve-mask plane (K3's plain version; the JAX ``sieve_mask_planes``
runs its Pallas kernel in interpret mode, as the JAX package's own
tests run it) are held against the JAX functions on the same seeded
numpy inputs.  The port's tiered engine, at budgets that force
eviction, row spill and cold-miss resolution, is held against the JAX
engine's UNTIERED run state for state.  Tolerance: exact equality
throughout (integer work; blobs byte for byte).  K3 itself is held
against its plain version on a card by ``tests/test_torch_cuda.py``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ops import fpset as jfpset
from pulsar_tlaplus_tpu.ops import tiles as jtiles
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu.store import budget as jbudget
from pulsar_tlaplus_tpu.store import compress as jcodec
from pulsar_tlaplus_tpu.store import sieve as jsieve
from pulsar_tlaplus_tpu.store.tiers import TieredStore as JStore
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.engine.device_bfs import (
    HBM_HEADROOM,
    DeviceChecker,
)
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.dedup import from_jax_arrays
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.store import budget, sieve
from pulsar_tlaplus_tpu_torch.store import compress as codec
from pulsar_tlaplus_tpu_torch.store.tiers import TieredStore
from tests.helpers import SMALL_CONFIGS, assert_valid_counterexample

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "compaction.tla")
CFG = os.path.join(ROOT, "specs", "compaction.cfg")
SENT = np.uint32(0xFFFFFFFF)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _rand_u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def _outcome(fn, *args):
    """The value of ``fn(*args)``, or the exception type it raised."""
    try:
        return fn(*args)
    except ValueError:
        return ValueError


# ---- budget ----------------------------------------------------------

BUDGET_SPECS = [
    "512M", "7.5G", "65536", 1 << 20, 3.9, " 2 gib ", "1t", "12K",
    "", "12X", "-1", 0, "0M", "1.5.2G", "G",
]


@pytest.mark.parametrize("spec", BUDGET_SPECS, ids=repr)
def test_parse_budget_matches_jax(spec):
    assert _outcome(budget.parse_budget, spec) == _outcome(
        jbudget.parse_budget, spec
    )


def test_resolve_budget_and_fmt_bytes_match_jax(monkeypatch):
    assert budget.ENV_VAR == jbudget.ENV_VAR
    monkeypatch.delenv(budget.ENV_VAR, raising=False)
    assert budget.resolve_budget(None) is None
    assert jbudget.resolve_budget(None) is None
    monkeypatch.setenv(budget.ENV_VAR, "2M")
    for arg in (None, "1M", 4096):
        assert budget.resolve_budget(arg) == jbudget.resolve_budget(arg)
    monkeypatch.setenv(budget.ENV_VAR, "2Q")
    assert _outcome(budget.resolve_budget, None) is ValueError
    assert _outcome(jbudget.resolve_budget, None) is ValueError
    for n in (0, 1023, 1024, 5 << 20, 7 << 30, (1 << 40) + 5):
        assert budget.fmt_bytes(n) == jbudget.fmt_bytes(n)


# ---- codecs ----------------------------------------------------------


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("ncols", [2, 3])
def test_codec_blobs_byte_equal_to_jax(compress, ncols):
    rng = np.random.default_rng(ncols * 10 + compress)
    cols = [_rand_u32(rng, 3000) for _ in range(ncols)]
    cols[0][:100] = SENT  # top-bit words
    hi, lo = codec.pack_keys(cols)
    jhi, jlo = jcodec.pack_keys(cols)
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    blob = codec.encode_key_run(hi, lo, compress)
    assert blob == jcodec.encode_key_run(hi, lo, compress)
    h2, l2 = codec.decode_key_run(blob[0])
    assert np.array_equal(h2, hi) and np.array_equal(l2, lo)
    back = codec.unpack_keys(h2, l2, ncols)
    assert all(np.array_equal(a, np.asarray(c)[order])
               for a, c in zip(back, cols))
    for arr in (np.arange(5000, dtype=np.int32) - 2500,
                _rand_u32(rng, 4321)):
        blob = codec.encode_plane(arr, compress)
        assert blob == jcodec.encode_plane(arr, compress)
        assert np.array_equal(codec.decode_plane(blob[0]), arr)


# ---- the RAM tier ----------------------------------------------------


def test_tiered_store_matches_jax():
    """The same evictions and spills into both stores: equal lookups,
    gathers, gap errors and counters."""
    rng = np.random.default_rng(11)
    mine, ref = TieredStore(), JStore(2)
    keys = [_rand_u32(rng, 6000) for _ in range(2)]
    keys[0][:500] |= np.uint32(1 << 31)
    runs = []
    for lo_, hi_ in ((0, 2500), (2500, 4000), (4000, 6000)):
        run = [k[lo_:hi_] for k in keys]
        hi, lo = codec.pack_keys(run)
        o = np.lexsort((lo, hi))
        runs.append([r[o] for r in run])
    W = 3
    rows = _rand_u32(rng, 900 * W)
    par = rng.integers(-5, 900, 900).astype(np.int32)
    lan = rng.integers(0, 7, 900).astype(np.int32)
    for s in (mine, ref):
        for run in runs:
            s.evict_keys(run)
        s.spill_rows(0, 400, rows[: 400 * W])
        s.spill_rows(400, 900, rows[400 * W:])
        s.spill_logs(0, 650, par[:650], lan[:650])
        s.spill_logs(650, 900, par[650:], lan[650:])
    q = [np.concatenate([k[::7], _rand_u32(rng, 2000)]) for k in keys]
    got = mine.lookup_keys(q)
    assert np.array_equal(got, ref.lookup_keys(q))
    assert got.sum() == len(keys[0][::7])
    for a, b in ((0, 900), (13, 777), (400, 401), (5, 5)):
        assert np.array_equal(mine.fetch_rows(a, b, W),
                              ref.fetch_rows(a, b, W))
        for x, y in zip(mine.fetch_logs(a, b), ref.fetch_logs(a, b)):
            assert np.array_equal(x, y)
    with pytest.raises(ValueError, match="gap"):
        mine.fetch_rows(800, 1000, W)
    assert mine.rows_spilled_hi == ref.rows_spilled_hi == 900
    mine.close()
    ref.close()
    drop = ("transfer_s", "blocked_s", "lookup_s")
    a, b = mine.stats.as_dict(), ref.stats.as_dict()
    assert {k: v for k, v in a.items() if k not in drop} == {
        k: v for k, v in b.items() if k not in drop
    }
    assert a["bytes_comp"] < a["bytes_raw"]


# ---- K3 and the sieve ops -------------------------------------------


def _table(rng, cap, K, n_fill):
    """A table of ``n_fill`` random keys (half with the top bit set)
    inserted by the JAX flush, as numpy uint32 columns, and a
    generation column in [1, 5] on the occupied slots."""
    fill = tuple(_rand_u32(rng, n_fill) for _ in range(K))
    tcols = jfpset.empty_cols(cap, K)
    tcols, _, _, _ = jfpset.flush_acc(
        tcols, tuple(jnp.asarray(c) for c in fill), jnp.int32(n_fill),
        jnp.zeros((jfpset.FPM_N,), jnp.int32),
    )
    tcols = tuple(np.asarray(c) for c in tcols)
    occ = ~np.all([c == SENT for c in tcols], axis=0)
    occ[cap] = False
    gen = np.where(occ, rng.integers(1, 6, cap + 1), 0).astype(np.int32)
    return tcols, gen


@pytest.mark.parametrize("K,cap", [(2, 1 << 13), (3, 1 << 13), (2, 1 << 11)])
def test_sieve_mask_plain_matches_jax_pallas(K, cap):
    """``sieve_mask_planes`` (the plain version on the CPU) against
    the JAX Pallas kernel at cap + 1 slots (not a multiple of its
    4096-slot tile), with raw random table words and cold mask."""
    rng = np.random.default_rng(K * 100 + cap)
    tcols = tuple(_rand_u32(rng, cap + 1) for _ in range(K))
    gen = rng.integers(0, 7, cap + 1).astype(np.int32)
    cold = rng.random(cap + 1) < 0.4
    want = jtiles.sieve_mask_planes(
        tuple(jnp.asarray(c) for c in tcols), jnp.asarray(gen),
        jnp.asarray(cold), impl="pallas",
    )
    tt = fpset.slot_major(from_jax_arrays(*tcols))
    tg, tc = from_jax_arrays(gen, cold)
    got = tiles.sieve_mask_planes(tt, tg, tc)
    plain = tiles.sieve_mask_planes_plain(tt, tg, tc)
    for g, p, w in zip(got[0] + got[1], plain[0] + plain[1],
                       want[0] + want[1]):
        assert np.array_equal(_u32(g), np.asarray(w))
        assert torch.equal(g, p)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("K", [2, 3])
def test_sort_cols_is_unsigned_lexicographic(K):
    rng = np.random.default_rng(K)
    cols = [_rand_u32(rng, 5000) for _ in range(K)]
    cols[0][::3] = cols[0][0]  # ties in the first column
    cols[0][::11] = SENT
    if K == 3:
        cols[1][::3] = cols[1][0]
    got = tiles.sort_cols(from_jax_arrays(*cols))
    order = np.lexsort(tuple(reversed(cols)))
    for g, c in zip(got, cols):
        assert np.array_equal(_u32(g), c[order])


@pytest.mark.parametrize("cutoff", [0, 2, 5], ids=["none", "some", "all"])
@pytest.mark.parametrize("K", [2, 3])
def test_extract_cold_matches_jax(K, cutoff):
    """``extract_cold`` against the JAX one under ``legacy`` (compact +
    mask + sort) and ``pallas`` (K3 in interpret mode + sort): the
    holed table, the cleared generations, the sorted full-width run
    and the count, with top-bit keys in the table."""
    rng = np.random.default_rng(K * 10 + cutoff)
    cap = 1 << 12
    tcols, gen = _table(rng, cap, K, 1700)
    tt = fpset.slot_major(from_jax_arrays(*tcols))
    (tg,) = from_jax_arrays(gen)
    holed, gen2, ev, n = sieve.extract_cold(tt, tg, cutoff)
    want_n = int(((gen >= 1) & (gen <= cutoff)).sum())
    assert n == want_n
    for impl in ("legacy", "pallas"):
        w = jsieve.extract_cold(
            tuple(jnp.asarray(c) for c in tcols), jnp.asarray(gen),
            cutoff, sieve_impl=impl,
        )
        for a, b in zip(holed, w[0]):
            assert np.array_equal(_u32(a), np.asarray(b)), impl
        assert np.array_equal(gen2.numpy(), np.asarray(w[1])), impl
        for a, b in zip(ev, w[2]):
            assert np.array_equal(_u32(a), np.asarray(b)), impl
        assert n == int(w[3]), impl
    if n:
        assert (_u32(ev[0])[:n] >= 1 << 31).any()


def test_tag_sieve_unflag_match_jax():
    rng = np.random.default_rng(5)
    cap, K = 1 << 11, 2
    tcols, gen = _table(rng, cap, K, 700)
    gen = np.where(rng.random(cap + 1) < 0.5, gen, 0).astype(np.int32)
    tt = fpset.slot_major(from_jax_arrays(*tcols))
    (tg,) = from_jax_arrays(gen)
    got = sieve.tag_generation(tt, tg, 7)
    want = jsieve.tag_generation(
        tuple(jnp.asarray(c) for c in tcols), jnp.asarray(gen), 7
    )
    assert np.array_equal(got.numpy(), np.asarray(want))
    nq = 3000
    kc = [_rand_u32(rng, nq) for _ in range(K)]
    flags = rng.random(nq) < 0.3
    *pk, lanes, n = sieve.sieve_new(from_jax_arrays(*kc),
                                    torch.from_numpy(flags))
    wout = jsieve.sieve_new(tuple(jnp.asarray(c) for c in kc),
                            jnp.asarray(flags.astype(np.uint32)))
    assert n == int(wout[-1]) == flags.sum()
    for a, b in zip(pk, wout[:K]):
        assert np.array_equal(_u32(a)[:n], np.asarray(b)[:n])
    assert np.array_equal(lanes.numpy()[:n], np.asarray(wout[K])[:n])
    m = n // 3
    got = sieve.unflag_lanes(torch.from_numpy(flags), lanes, m)
    want = jsieve.unflag_lanes(jnp.asarray(flags.astype(np.uint32)),
                               jnp.asarray(lanes.numpy()), jnp.int32(m))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(bool))
    assert got.sum() == n - m


# ---- the tiered engine ----------------------------------------------


def _mk(c, **kw):
    kw.setdefault("invariants", ())
    kw.setdefault("check_deadlock", False)
    kw.setdefault("sub_batch", 64)
    kw.setdefault("visited_cap", 1 << 9)
    return DeviceChecker(
        CompactionModel(tpe.Constants(**dataclasses.asdict(c))),
        device="cpu", **kw,
    )


def _tight_budget(c, slack=4096, **kw):
    """A budget just above the initial tiers (the JAX tests'
    ``tight_hbm_budget`` recipe on the port's own byte estimate), so
    the run must spill."""
    p = _mk(c, hbm_budget="1T", **kw)
    est = p._device_bytes_est(p.TCAP0, p.WCAP0, p.WCAP0)
    return int(est / (1.0 - HBM_HEADROOM)) + slack


def test_budget_below_initial_tiers_raises():
    c = SMALL_CONFIGS["producer_on"]
    with pytest.raises(ValueError, match="hbm_budget too small"):
        _mk(c, hbm_budget=_tight_budget(c, slack=0) // 2)


@pytest.mark.parametrize("name", ["producer_on", "no_retain"])
def test_tiered_equals_jax_untiered_state_for_state(name):
    """A budget that forces key eviction, row/log spill and cold-miss
    resolution: the same states in the same order as the JAX engine's
    untiered run — level sizes, packed rows, parent and lane logs
    (through the merged cold + window view)."""
    c = SMALL_CONFIGS[name]
    jck = JChecker(JModel(c), invariants=(), check_deadlock=False,
                   sub_batch=2048, visited_cap=1 << 16,
                   frontier_cap=1 << 15)
    jr = jck.run()
    ck = _mk(c, hbm_budget=_tight_budget(c))
    r = ck.run()
    assert r.distinct_states == jr.distinct_states
    assert r.level_sizes == jr.level_sizes
    st = ck.last_stats
    assert st["spill_evictions"] >= 1, "budget never forced an eviction"
    assert st["spill_rows_evicted"] > 0
    assert st["spill_misses_resolved"] > 0
    assert st["spill_hot_keys"] < r.distinct_states
    nv = r.distinct_states
    par, lan = ck.merged_logs()
    assert np.array_equal(par, np.asarray(jck.last_bufs["parent"][:nv]))
    assert np.array_equal(lan, np.asarray(jck.last_bufs["lane"][:nv]))
    assert np.array_equal(
        ck.merged_rows(), np.asarray(jck.last_bufs["rows"][: nv * ck.W])
    )


def test_tiered_shipped_45k_hot_under_quarter():
    kw = dict(sub_batch=512, visited_cap=1 << 12)
    ck = _mk(pe.SHIPPED_CFG,
             hbm_budget=_tight_budget(pe.SHIPPED_CFG, slack=65536, **kw),
             **kw)
    r = ck.run()
    assert (r.distinct_states, r.diameter) == (45198, 20)
    assert not r.truncated and r.violation is None
    st = ck.last_stats
    assert st["spill_hot_keys"] / r.distinct_states < 0.25
    assert st["spill_keys_evicted"] > 0
    assert st["spill_bytes_comp"] < st["spill_bytes_raw"]


def test_tiered_leak_counterexample():
    """CompactedLedgerLeak through the tiered store: the untiered
    engine's gid and depth, and a trace walked from the merged logs
    that replays."""
    kw = dict(invariants=("CompactedLedgerLeak",), check_deadlock=True,
              sub_batch=512, visited_cap=1 << 11)
    ck = _mk(pe.SHIPPED_CFG,
             hbm_budget=_tight_budget(pe.SHIPPED_CFG, **kw), **kw)
    r = ck.run()
    assert (r.violation, r.violation_gid) == ("CompactedLedgerLeak", 23329)
    assert r.diameter == 12 and len(r.trace) == 12
    assert ck._row_base > 0, "the trace did not need the cold logs"
    assert_valid_counterexample(
        pe.SHIPPED_CFG, [pe.State(*s) for s in r.trace], r.trace_actions,
        "CompactedLedgerLeak",
    )


def test_cli_hbm_budget_prints_spill_line(capsys):
    rc = cli.main(["check", SPEC, "-config", CFG, "-cpu",
                   "-hbm-budget", "64M", "-no-spill-compress"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "45198 distinct states found" in out
    assert "Spill (hbm budget 64.0 MiB)" in out
    with pytest.raises(SystemExit) as e:
        cli.main(["check", SPEC, "-config", CFG, "-cpu",
                  "-hbm-budget", "12X"])
    assert "bad hbm budget" in str(e.value.code)
