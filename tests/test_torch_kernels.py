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
    tt = from_jax_arrays(*tcols)
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
    tt = from_jax_arrays(*tcols)
    tk = from_jax_arrays(*kcols)
    fpm = torch.zeros((fpset.FPM_N,), dtype=torch.int64)
    gt, gn, gflag, gfpm = tiles.flush_acc_tiles(tt, tk, n_acc, fpm)
    assert gn == int(jn)
    assert np.array_equal(gflag.numpy(), np.asarray(jflag).astype(bool))
    for g, w in zip(gt, jt):
        assert np.array_equal(_u32(g)[:cap], np.asarray(w)[:cap])
    assert gfpm.tolist() == jfpset.fpm_logical(np.asarray(jfpm)).tolist()
    assert gn > 0


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
