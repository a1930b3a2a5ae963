"""The port's kernels against the JAX package, on the CPU.

K2 (``ops/tiles.key_plane``) and K1 (``ops/tiles.member_block``) run
their plain PyTorch versions here — the wrappers take them for CPU
tensors — and are held against the JAX functions on the same numpy
inputs: ``tiles.key_plane(impl="pallas")`` and ``KeySpec.make``, and
``tiles.member_block_pallas`` (both Pallas kernels in interpret mode, as
the JAX package's own tests run them).  The tiled flush is held against
``flush_acc_tiles(probe_impl="pallas")``.  Tolerance: exact equality
throughout (integer work).  The CUDA kernels themselves are held against
the plain versions on a card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.ops import fpset as jfpset
from pulsar_tlaplus_tpu.ops import tiles as jtiles
from pulsar_tlaplus_tpu.ops.dedup import KeySpec as JKeySpec
from pulsar_tlaplus_tpu_torch.ops import compact, fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec, from_jax_arrays

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

SENT = np.uint32(0xFFFFFFFF)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _rand_u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


# ---- K2: key plane --------------------------------------------------

KEY_SHAPES = [
    (20, 1, None),   # exact, one word, zero-padded to 2 columns
    (42, 2, None),   # exact: the oracle configs
    (70, 3, None),   # exact, 3 columns
    (96, 3, 64),     # hashed at W=3
    (618, 20, 64),   # the scaled config
    (618, 20, 96),
]


@pytest.mark.parametrize("total_bits,W,fp_bits", KEY_SHAPES)
def test_key_plane_matches_jax(total_bits, W, fp_bits):
    jks = JKeySpec(total_bits, W, fp_bits)
    ks = KeySpec(total_bits, W, fp_bits)
    assert (ks.ncols, ks.exact) == (jks.ncols, jks.exact)
    rng = np.random.default_rng(total_bits * 100 + W)
    for nc in (257, 4999):
        packed = _rand_u32(rng, (nc, W))
        valid = rng.random(nc) < 0.8
        want = jtiles.key_plane(
            jks, jnp.asarray(packed), jnp.asarray(valid), impl="pallas"
        )
        made = jks.make(jnp.asarray(packed))
        tp, tv = from_jax_arrays(packed, valid)
        got = tiles.key_plane(ks, tp, tv)
        assert len(got) == len(want) == ks.ncols
        for g, w, m in zip(got, want, made):
            assert np.array_equal(_u32(g), np.asarray(w))
            assert np.array_equal(
                _u32(g), np.where(valid, np.asarray(m), SENT)
            )


# ---- K1: membership probe -------------------------------------------


def _filled_table(rng, cap, K, n_fill):
    """A JAX table holding ``n_fill`` random keys (inserted by the JAX
    flush), and the keys."""
    fill = tuple(_rand_u32(rng, n_fill) for _ in range(K))
    tcols = jfpset.empty_cols(cap, K)
    fpm = jnp.zeros((jfpset.FPM_N,), jnp.int32)
    tcols, _, _, _ = jfpset.flush_acc(
        tcols, tuple(jnp.asarray(c) for c in fill), jnp.int32(n_fill), fpm
    )
    return tuple(np.asarray(c) for c in tcols), fill


def _queries(rng, fill, nq, dup_frac):
    """Dup-heavy query columns (a share drawn from the table), with
    SENTINEL lanes sprinkled in."""
    ndup = int(nq * dup_frac)
    pick = rng.integers(0, fill[0].shape[0], size=ndup)
    cols = []
    for f in fill:
        c = np.concatenate([f[pick], _rand_u32(rng, nq - ndup)])
        cols.append(c)
    perm = rng.permutation(nq)
    sent = np.arange(nq) % 53 == 7
    return tuple(np.where(sent, SENT, c[perm]) for c in cols)


# (cap_log2, K, nq, dup_frac, fill_frac, rounds)
MEMBER_SHAPES = [
    (12, 2, 1000, 0.5, 0.375, 8),
    (11, 3, 2047, 0.8, 0.5, 8),
    (12, 2, 3000, 0.3, 0.5, 4),
]


@pytest.mark.parametrize("cap_log2,K,nq,dup_frac,fill_frac,rounds",
                         MEMBER_SHAPES)
def test_member_block_matches_jax(cap_log2, K, nq, dup_frac, fill_frac,
                                  rounds):
    rng = np.random.default_rng(cap_log2 * 7 + nq)
    cap = 1 << cap_log2
    tcols, fill = _filled_table(rng, cap, K, int(cap * fill_frac))
    kcols = _queries(rng, fill, nq, dup_frac)
    valid = rng.random(nq) < 0.9
    wm, wr = jtiles.member_block_pallas(
        tuple(jnp.asarray(c) for c in tcols),
        tuple(jnp.asarray(c) for c in kcols),
        jnp.asarray(valid), rounds,
    )
    tt = fpset.slot_major(from_jax_arrays(*tcols))
    tk = from_jax_arrays(*kcols)
    (tv,) = from_jax_arrays(valid)
    gm, gr = tiles.member_block(tt, tk, tv, rounds)
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    assert np.array_equal(gr.numpy(), np.asarray(wr))
    assert gm.any() and not gm.all()


# ---- the tiled flush --------------------------------------------------

# (cap_log2, K, nq, dup_frac, n_acc_frac, fill_frac)
FLUSH_SHAPES = [
    (12, 2, 1000, 0.0, 1.0, 0.375),
    (11, 2, 777, 0.5, 0.61, 0.375),
    (12, 3, 3000, 0.3, 1.0, 0.25),
    (13, 2, 5000, 0.9, 0.83, 0.25),
]


@pytest.mark.parametrize("cap_log2,K,nq,dup_frac,n_acc_frac,fill_frac",
                         FLUSH_SHAPES)
def test_flush_matches_jax(cap_log2, K, nq, dup_frac, n_acc_frac,
                           fill_frac):
    """``is_new``, ``n_new``, the metrics and the table columns equal
    the JAX flush (slot ``cap`` is the write-only trash row and is not
    compared)."""
    rng = np.random.default_rng(cap_log2 * 31 + nq)
    cap = 1 << cap_log2
    tcols, fill = _filled_table(rng, cap, K, int(cap * fill_frac))
    kcols = _queries(rng, fill, nq, dup_frac)
    # in-batch duplicates too: every 5th lane repeats its predecessor
    kcols = tuple(
        np.where(np.arange(nq) % 5 == 4, np.roll(c, 1), c) for c in kcols
    )
    n_acc = int(nq * n_acc_frac)
    fpm0 = jnp.zeros((jfpset.FPM_N,), jnp.int32)
    jt, jn, jflag, jfpm = jtiles.flush_acc_tiles(
        tuple(jnp.asarray(c) for c in tcols),
        tuple(jnp.asarray(c) for c in kcols),
        jnp.int32(n_acc), fpm0, probe_impl="pallas",
    )
    tt = fpset.slot_major(from_jax_arrays(*tcols))
    tk = from_jax_arrays(*kcols)
    fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64)
    gt, gn, gflag, gfpm = tiles.flush_acc_tiles(tt, tk, n_acc, fpm)
    assert fpset.slot_major_base(gt) is tt[0]  # updated in place
    assert gn == int(jn)
    assert np.array_equal(gflag.numpy(), np.asarray(jflag).astype(bool))
    for g, w in zip(gt, jt):
        assert np.array_equal(_u32(g)[:cap], np.asarray(w)[:cap])
    assert gfpm.tolist() == jfpset.fpm_logical(np.asarray(jfpm)).tolist()
    assert gn > 0


# FLUSH_SHAPES' tables at load <= 1/2 after two flushes (the contract
# under which the tiled and the staged flush agree)
SYNC_FREE_SHAPES = [
    (13, 2, 1000, 0.0, 1.0, 0.25),
    (11, 2, 777, 0.5, 0.61, 0.25),
    (14, 3, 3000, 0.3, 1.0, 0.125),
    (14, 2, 5000, 0.9, 0.83, 0.25),
]


@pytest.mark.parametrize("cap_log2,K,nq,dup_frac,n_acc_frac,fill_frac",
                         SYNC_FREE_SHAPES)
def test_sync_free_flush_matches_jax(cap_log2, K, nq, dup_frac, n_acc_frac,
                                     fill_frac):
    """``flush_tiles`` (no host read: ``n_new`` a 0-d tensor, ``n_acc``
    one too) against ``flush_acc_tiles``, the JAX ``flush_acc_tiles``
    and the JAX ``fpset.flush_acc`` (the XLA flush of its default
    path), over two flushes that reuse one bid buffer (the engine's
    per-table ``claims``): ``is_new`` and ``n_new`` everywhere; the
    metrics and the table slot for slot against the tiled flushes; the
    flush, failure and valid-lane counts and the set of keys against
    the staged XLA flush, which places keys in another order."""
    rng = np.random.default_rng(cap_log2 * 37 + nq)
    cap = 1 << cap_log2
    tcols, fill = _filled_table(rng, cap, K, int(cap * fill_frac))
    batches = []
    for _ in range(2):
        kc = _queries(rng, fill, nq, dup_frac)
        batches.append(tuple(
            np.where(np.arange(nq) % 5 == 4, np.roll(c, 1), c) for c in kc
        ))
    n_acc = int(nq * n_acc_frac)
    jt = jx = tuple(jnp.asarray(c) for c in tcols)
    jfpm = jxfpm = jnp.zeros((jfpset.FPM_N,), jnp.int32)
    ta = fpset.slot_major(from_jax_arrays(*tcols))
    tb = fpset.slot_major(from_jax_arrays(*tcols))
    claims = fpset.new_claims(cap, "cpu")
    fa = fb = torch.zeros((fpset.FPM_N,), dtype=torch.int64)
    for kcols in batches:
        jk = tuple(jnp.asarray(c) for c in kcols)
        jt, jn, jflag, jfpm = jtiles.flush_acc_tiles(
            jt, jk, jnp.int32(n_acc), jfpm, probe_impl="tile"
        )
        jx, jxn, jxflag, jxfpm = jfpset.flush_acc(
            jx, jk, jnp.int32(n_acc), jxfpm
        )
        tk = from_jax_arrays(*kcols)
        ta, na, flag_a, fa = tiles.flush_tiles(
            ta, tk, torch.tensor(n_acc), fa, claims
        )
        tb, nb, flag_b, fb = tiles.flush_acc_tiles(tb, tk, n_acc, fb)
        assert isinstance(nb, int) and na.dim() == 0
        assert int(na) == nb == int(jn) == int(jxn)
        assert torch.equal(flag_a, flag_b)
        for w in (jflag, jxflag):
            assert np.array_equal(flag_a.numpy(), np.asarray(w).astype(bool))
        assert torch.equal(fa, fb)
        assert fa.tolist()[2] == 0  # no failures
        assert fa.tolist() == jfpset.fpm_logical(np.asarray(jfpm)).tolist()
        jl = jfpset.fpm_logical(np.asarray(jxfpm)).tolist()
        got = fa.tolist()
        assert [got[i] for i in (0, 2, 3)] == [jl[i] for i in (0, 2, 3)]
        for a, b, w in zip(ta, tb, jt):
            assert np.array_equal(_u32(a)[:cap], np.asarray(w)[:cap])
            assert torch.equal(a[:cap], b[:cap])
        got = {tuple(r) for r in np.stack([_u32(c)[:cap] for c in ta], 1)}
        want = {tuple(r) for r in np.stack([np.asarray(c)[:cap] for c in jx],
                                           1)}
        assert got == want
    assert torch.equal(claims, fpset.new_claims(cap, "cpu"))


def test_insert_tail_plain_chunks_in_lane_order():
    """H1's plain version over several chunks, with fewer pending lanes
    than keys: equal keys across chunks resolve to the lowest lane id,
    and only the first ``npend`` lanes are read."""
    rng = np.random.default_rng(21)
    keys = from_jax_arrays(*(_rand_u32(rng, 300) for _ in range(2)))
    dup = tuple(torch.cat([c, c[:100], c[:50]]) for c in keys)
    ids = torch.arange(450, dtype=torch.int32) * 3
    tcols = fpset.empty_cols(1 << 11, 2, "cpu")
    claims = fpset.new_claims(1 << 11, "cpu")
    is_new, st = fpset.insert_tail(tcols, dup, ids, torch.tensor(420), 128,
                                   claims, 1350)
    assert torch.equal(torch.nonzero(is_new[:1350]).flatten(),
                       ids[:300].long())
    assert st.tolist()[1] == 0 and st.tolist()[0] >= 4  # >= 1 round a chunk


# (cap_log2, K, nq, fill_frac, stage limit): a table near load 1/2 (long
# probe chains); the JAX flush's insert tail gets max(DENSE_ROUNDS,
# limit) probe rounds, so limit 4 makes lanes fail
TAIL_STATS_SHAPES = [
    (12, 2, 1500, 0.375, 64),
    (12, 3, 1200, 0.4, 64),
    (11, 2, 900, 0.45, 4),
    (12, 3, 2000, 0.375, 4),
]


@pytest.mark.parametrize("cap_log2,K,nq,fill_frac,limit", TAIL_STATS_SHAPES)
def test_insert_tail_plain_stats_match_jax_flush(cap_log2, K, nq, fill_frac,
                                                 limit):
    """``insert_tail_plain``'s (probe rounds, failed lanes), with the
    prefilter's rounds added, are the JAX ``flush_acc_tiles`` flush
    metrics on the same inputs, and its table and new lanes the JAX
    flush's — the round and failure semantics H1 must reproduce,
    failures included."""
    rng = np.random.default_rng(cap_log2 * 41 + nq + limit)
    cap = 1 << cap_log2
    tcols, fill = _filled_table(rng, cap, K, int(cap * fill_frac))
    kcols = _queries(rng, fill, nq, 0.2)
    dense = jfpset.DENSE_ROUNDS
    jt, jn, jflag, jfpm = jtiles.flush_acc_tiles(
        tuple(jnp.asarray(c) for c in tcols),
        tuple(jnp.asarray(c) for c in kcols), jnp.int32(nq),
        jnp.zeros((jfpset.FPM_N,), jnp.int32), dense_rounds=dense,
        stages=((4, limit),), probe_impl="tile",
    )
    jl = jfpset.fpm_logical(np.asarray(jfpm)).tolist()
    # the port's flush up to its insert tail, then the tail's plain loop
    tt = fpset.slot_major(from_jax_arrays(*tcols))
    tk = from_jax_arrays(*kcols)
    rounds_blk = max(tiles.TILE_R, dense)
    valid = ~fpset.all_sentinel(tk)
    member, _ = tiles.member_block(tt, tk, valid, rounds_blk)
    surv = valid & ~member
    ccols, _ = compact.compact_by_flag(
        ~surv, (*tk, torch.arange(nq, dtype=torch.int32)))
    cw = max(nq // 4, min(nq, fpset.MIN_STAGE))
    is_new, st = fpset.insert_tail_plain(
        tt, ccols[:K], ccols[K], surv.sum(), cw,
        fpset.new_claims(cap, "cpu"), nq, max(dense, limit))
    rounds, failed = st.tolist()
    assert [rounds_blk + rounds, failed] == [jl[1], jl[2]]
    assert (failed > 0) == (limit == 4)
    assert np.array_equal(is_new[:nq].numpy(), np.asarray(jflag).astype(bool))
    assert int(is_new[:nq].sum()) == int(jn)
    for g, w in zip(tt, jt):
        assert np.array_equal(_u32(g)[:cap], np.asarray(w)[:cap])


def _tail_scratch(K=2, cw=64, n=64, **bad):
    """H1's launch arguments on the CPU, with ``bad`` replacing any of
    them (a CPU tensor is refused only after every type and shape)."""
    args = dict(
        tcols=fpset.empty_cols(128, K, "cpu"),
        ckeys=tuple(torch.zeros((n,), dtype=torch.int32) for _ in range(K)),
        cids=torch.zeros((n,), dtype=torch.int32),
        npend=torch.zeros((), dtype=torch.int64), cw=cw,
        claims=fpset.new_claims(128, "cpu"),
        is_new=torch.zeros((n + 1,), dtype=torch.bool),
        lists=torch.empty((2, K + 2, cw), dtype=torch.int32),
        cnt=torch.empty((2,), dtype=torch.int32),
        stats=torch.empty((4,), dtype=torch.int64),
    )
    args.update(bad)
    return args


@pytest.mark.parametrize("name,bad", [
    ("lists", torch.empty((2, 4, 64), dtype=torch.int64)),
    ("lists", torch.empty((2, 64), dtype=torch.int32)),
    ("lists", torch.empty((2, 3, 64), dtype=torch.int32)),
    ("lists", torch.empty((2, 4, 63), dtype=torch.int32)),
    ("cnt", torch.empty((2,), dtype=torch.int64)),
    ("cnt", torch.empty((1,), dtype=torch.int32)),
    ("stats", torch.empty((2,), dtype=torch.int64)),
    ("stats", torch.empty((4,), dtype=torch.int32)),
])
def test_insert_tail_args_checks_scratch(name, bad):
    """A scratch buffer of the wrong type or shape raises before any
    launch; with the right ones, a CPU tensor raises for want of a
    kernel."""
    with pytest.raises(ValueError, match="insert_tail: want"):
        fpset.insert_tail_args(**_tail_scratch(**{name: bad}))
    with pytest.raises(ValueError, match="no kernel"):
        fpset.insert_tail_args(**_tail_scratch())


def test_insert_tail_args_lists_follow_K():
    """K = 3 takes five list rows: the K = 2 shape is refused."""
    with pytest.raises(ValueError, match="insert_tail: want"):
        fpset.insert_tail_args(**_tail_scratch(
            K=3, lists=torch.empty((2, 4, 64), dtype=torch.int32)))
    with pytest.raises(ValueError, match="no kernel"):
        fpset.insert_tail_args(**_tail_scratch(K=3))


def test_flush_min_lane_wins():
    """Equal new keys in one batch: one winner, the lowest lane."""
    rng = np.random.default_rng(7)
    nq = 512
    base = _rand_u32(rng, (nq // 4, 2))
    kcols = from_jax_arrays(*(np.repeat(base[:, i], 4) for i in range(2)))
    tcols = fpset.empty_cols(1 << 10, 2, "cpu")
    fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64)
    _, n_new, is_new, _ = tiles.flush_acc_tiles(tcols, kcols, nq, fpm)
    assert n_new == nq // 4
    assert (torch.nonzero(is_new).flatten() % 4 == 0).all()


def test_compact_by_flag_keeps_order():
    rng = np.random.default_rng(3)
    keep = rng.random(1000) < 0.3
    vals = rng.integers(0, 1000, 1000)
    (out,), idx = compact.compact_by_flag(
        torch.as_tensor(~keep), (torch.as_tensor(vals),)
    )
    n = int(keep.sum())
    assert np.array_equal(out[:n].numpy(), vals[keep])
    assert np.array_equal(idx[:n].numpy(), np.flatnonzero(keep))


def test_rehash_keeps_every_key():
    rng = np.random.default_rng(11)
    keys = from_jax_arrays(*(_rand_u32(rng, 600) for _ in range(2)))
    small = fpset.empty_cols(1 << 11, 2, "cpu")
    _, small, pending, _ = fpset.probe_insert(
        small, keys, torch.ones(600, dtype=torch.bool)
    )
    assert not pending.any()
    big, failed = fpset.rehash_cols(
        small, fpset.empty_cols(1 << 12, 2, "cpu"), chunk=256
    )
    assert failed == 0
    member, resolved = tiles.member_block(
        big, keys, torch.ones(600, dtype=torch.bool), rounds=64
    )
    assert member.all() and resolved.all()


# ---- the slot-major table ---------------------------------------------


def _buffer(tcols):
    """The ``[cap + 1, K]`` int32 buffer under a table's column views."""
    buf = torch.empty(0, dtype=torch.int32)
    buf.set_(tcols[0].untyped_storage())
    return buf.reshape(tcols[0].shape[0], len(tcols))


@pytest.mark.parametrize("K", [2, 3])
def test_empty_cols_is_one_slot_major_buffer(K):
    """``empty_cols`` returns the K column views of one ``[cap + 1, K]``
    buffer, and ``probe_insert``'s in-place writes land in it."""
    tcols = fpset.empty_cols(1 << 10, K, "cpu")
    assert fpset.slot_major_base(tcols) is tcols[0]
    buf = _buffer(tcols)
    assert buf.numel() == (1 << 10) * K + K and (buf == -1).all()
    rng = np.random.default_rng(K)
    keys = from_jax_arrays(*(_rand_u32(rng, 300) for _ in range(K)))
    is_new, out, pending, _ = fpset.probe_insert(
        tcols, keys, torch.ones(300, dtype=torch.bool)
    )
    assert out is tcols and is_new.all() and not pending.any()
    rows = {tuple(r) for r in buf[:-1].tolist()}
    assert {tuple(r) for r in torch.stack(keys, 1).tolist()} <= rows
    assert len(rows) == 301  # the keys and the empty tuple


@pytest.mark.parametrize("K", [2, 3])
def test_slot_major_round_trips(K):
    """Any K columns (strided views included) come back equal, as a
    fresh slot-major table the layout check accepts."""
    rng = np.random.default_rng(K + 20)
    wide = from_jax_arrays(_rand_u32(rng, (777, 2 * K)))[0]
    cols = tuple(wide[:, 2 * c] for c in range(K))
    tcols = fpset.slot_major(cols)
    fpset.slot_major_base(tcols)
    for a, b in zip(tcols, cols):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()


@pytest.mark.parametrize("layout", ["columns", "transposed", "wide",
                                    "reordered", "int64"])
def test_slot_major_check_raises(layout):
    """The layout check K1 and K3 make on the card, as a plain helper:
    separate columns, a transposed ``[K, cap + 1]`` buffer, views of a
    wider buffer, views out of order and a wrong dtype all raise."""
    n, K = 4097, 2
    if layout == "columns":
        tcols = tuple(torch.full((n,), -1, dtype=torch.int32)
                      for _ in range(K))
    elif layout == "transposed":
        tcols = tuple(torch.full((K, n), -1, dtype=torch.int32).unbind(0))
    elif layout == "wide":
        tcols = tuple(torch.full((n, K + 1), -1, dtype=torch.int32)
                      .unbind(1)[:K])
    elif layout == "reordered":
        tcols = tuple(reversed(fpset.empty_cols(n - 1, K, "cpu")))
    else:
        tcols = tuple(torch.full((n, K), -1).unbind(1))
    with pytest.raises(ValueError, match="slot-major"):
        fpset.slot_major_base(tcols)


def test_shared_claims_match_fresh_claims():
    """One bid buffer reused over batches (as the flush and the rehash
    use it) gives the table a fresh buffer per batch gives, dup-heavy
    batches included, and comes back unclaimed."""
    rng = np.random.default_rng(12)
    raw = [_rand_u32(rng, 300) for _ in range(2)]
    keys = from_jax_arrays(*(np.concatenate([c, c[:150]]) for c in raw))
    fresh = fpset.empty_cols(1 << 11, 2, "cpu")
    shared = fpset.empty_cols(1 << 11, 2, "cpu")
    claims = fpset.new_claims(1 << 11, "cpu")
    for base in range(0, 450, 100):
        ks = tuple(c[base: base + 100] for c in keys)
        ok = torch.ones(ks[0].shape[0], dtype=torch.bool)
        n1, fresh, _, _ = fpset.probe_insert(fresh, ks, ok)
        n2, shared, _, _ = fpset.probe_insert(shared, ks, ok, claims=claims)
        assert torch.equal(n1, n2)
    for a, b in zip(fresh, shared):
        assert torch.equal(a[:-1], b[:-1])
    assert torch.equal(claims, fpset.new_claims(1 << 11, "cpu"))


def test_wrappers_have_no_fallback():
    """A tensor on a device with no kernel (here ``meta``) raises: the
    plain version is taken for CPU tensors only."""
    ks = KeySpec(42, 2)
    packed = torch.empty((4, 2), dtype=torch.int32, device="meta")
    valid = torch.empty((4,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tiles.key_plane(ks, packed, valid)
    tc = fpset.empty_cols(8, 2, "meta")
    with pytest.raises(ValueError, match="no kernel"):
        tiles.member_block(tc, (valid.int(), valid.int()), valid)


def test_insert_tail_has_no_fallback():
    """H1's wrapper, like the others: a tensor on a device with no
    kernel raises instead of taking the plain loop."""
    tc = fpset.empty_cols(8, 2, "meta")
    keys = tuple(torch.empty((4,), dtype=torch.int32, device="meta")
                 for _ in range(2))
    with pytest.raises(ValueError, match="no kernel"):
        fpset.insert_tail(
            tc, keys, keys[0], torch.empty((), dtype=torch.int64,
                                           device="meta"),
            4, fpset.new_claims(8, "meta"), 4,
        )


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """``build.launch`` counts under a lock: 8 threads launching fake
    libraries at once, switching as often as the interpreter can, leave
    every count exact (two backends in one process share the
    counters)."""
    import sys
    import threading
    import types

    from pulsar_tlaplus_tpu_torch.kernels import build

    names = list(build.SOURCES)
    libs = {n: types.SimpleNamespace(fake=lambda *a: 0) for n in names}
    monkeypatch.setattr(build, "load", lambda: libs)
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(names, 0))
    n_threads, each = 8, 5_000
    gate = threading.Barrier(n_threads)

    def body(i):
        gate.wait()
        for k in range(each):
            build.launch(names[(i + k) % len(names)], "fake")

    threads = [threading.Thread(target=body, args=(i,))
               for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    want = dict.fromkeys(names, 0)
    for i in range(n_threads):
        for k in range(each):
            want[names[(i + k) % len(names)]] += 1
    assert build.LAUNCHES == want
    assert sum(want.values()) == n_threads * each
    build.reset_launches()
    assert set(build.LAUNCHES.values()) == {0}
