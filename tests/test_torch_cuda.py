"""The port's CUDA kernels and engine on a card, against the plain
PyTorch versions on the same inputs.  Every test here needs a CUDA card
and skips without one.  This file imports no JAX, so it runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact equality (integer work)."""

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec, from_jax_arrays
from pulsar_tlaplus_tpu_torch.ref import pyeval

pytestmark = pytest.mark.cuda


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
     (618, 20, 64), (618, 20, 96)],
)
def test_key_plane_kernel(card, total_bits, W, fp_bits):
    ks = KeySpec(total_bits, W, fp_bits)
    rng = np.random.default_rng(W)
    for nc in (1, 4097, 100_003):
        packed, valid = from_jax_arrays(
            _rand_u32(rng, (nc, W)), rng.random(nc) < 0.8
        )
        want = tiles.key_plane(ks, packed, valid)
        got = tiles.key_plane(ks, packed.to(card), valid.to(card))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


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
        tuple(t.to(card) for t in tcols), tuple(t.to(card) for t in kcols),
        valid.to(card), rounds,
    )
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_engine_on_card_equals_cpu(card):
    """The shipped cfg on the card: the CPU run's rows and logs."""
    m = CompactionModel(pyeval.SHIPPED_CFG)
    a = DeviceChecker(m, sub_batch=1000, device="cpu")
    b = DeviceChecker(m, sub_batch=1000, device=card)
    ra, rb = a.run(), b.run()
    assert (rb.distinct_states, rb.diameter) == (45198, 20)
    assert rb.level_sizes == ra.level_sizes
    for k in ("rows", "parent", "lane"):
        n = ra.distinct_states * (a.W if k == "rows" else 1)
        assert torch.equal(b.last_bufs[k][:n].cpu(), a.last_bufs[k][:n])
