"""Fingerprint keys — the counterpart of ``pulsar_tlaplus_tpu/ops/dedup.py``
(``SENTINEL``, ``_fmix``, ``murmur3_words``, ``KeySpec``).

Words and key columns live on the device as int32 tensors holding uint32
bit patterns: 4 bytes a word, and the all-ones empty marker ``SENTINEL``
reads as -1.  PyTorch has no uint32 ``+``, shifts or ``min``, so the
arithmetic here widens to int64 "u32 values" in ``[0, 2^32)``, masks after
every ``+``, ``*`` and ``<<``, and narrows back with :func:`i32`.  A
multiply by a 32-bit constant is split at 16 bits so that no product
leaves int64's range.  Any ordering of keys must keep SENTINEL largest,
which an int32 view does not: compare the widened values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SENTINEL = -1  # int32 bit pattern of 0xFFFFFFFF
U32 = 0xFFFFFFFF

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
FP_SEEDS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64."""
    return x.to(torch.int64) & U32


def i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 (``[0, 2^32)``) -> int32 bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for u32 values ``a`` and a 32-bit constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return ((((a * hi) & 0xFFFF) << 16) + a * lo) & U32


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & U32) | (x >> (32 - r))


def fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer over u32 values."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur3_words(words: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3_32 over the trailing word axis: u32 values ``[..., W]`` ->
    ``[...]``."""
    w = words.shape[-1]
    h = torch.full(words.shape[:-1], seed, dtype=torch.int64,
                   device=words.device)
    for i in range(w):
        k = mul32(words[..., i], _C1)
        k = mul32(rotl(k, 15), _C2)
        h = h ^ k
        h = (mul32(rotl(h, 13), 5) + 0xE6546B64) & U32
    return fmix(h ^ (4 * w))


class KeySpec:
    """Dedup-key layout for one state layout: exact 2 or 3 columns (the
    packed words themselves, zero-padded) when the state is under 64 or
    96 bits, else ``fp_bits // 32`` murmur3 fingerprint columns (default
    64 bits).  The all-SENTINEL tuple is the empty marker: unreachable in
    exact mode (a pad bit above ``total_bits`` is zero), remapped by
    flipping the last column's low bit in hashed mode."""

    def __init__(self, total_bits: int, W: int, fp_bits: int | None = None):
        if W <= 2 and total_bits < 64:
            self.ncols, self.exact = 2, True
        elif W <= 3 and total_bits < 96:
            self.ncols, self.exact = 3, True
        else:
            if fp_bits is None:
                fp_bits = 64
            if fp_bits not in (64, 96):
                raise ValueError("fp_bits must be 64 or 96")
            self.ncols, self.exact = fp_bits // 32, False
        self.total_bits = total_bits
        self.W = W

    def make(self, packed: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """packed int32 ``[N, W]`` -> ``ncols`` int32 ``[N]`` key columns."""
        n, w = packed.shape
        if self.exact:
            cols = [packed[:, i] for i in range(w)]
            while len(cols) < self.ncols:
                cols.append(torch.zeros((n,), dtype=torch.int32,
                                        device=packed.device))
            return tuple(cols)
        p = u32(packed)
        h = [murmur3_words(p, seed) for seed in FP_SEEDS[: self.ncols]]
        all_sent = h[0] == U32
        for c in h[1:]:
            all_sent = all_sent & (c == U32)
        h[-1] = torch.where(all_sent, h[-1] ^ 1, h[-1])
        return tuple(i32(c) for c in h)

    def collision_prob(self, n_states: int) -> float:
        """Expected fingerprint collisions at ``n_states`` distinct
        states (birthday bound); 0.0 in exact mode."""
        if self.exact:
            return 0.0
        return float(n_states) * float(n_states) / 2.0 ** (
            32 * self.ncols + 1
        )


def from_jax_arrays(*arrays, device="cpu"):
    """numpy arrays (as converted from the JAX package's arrays) -> the
    port's tensors: uint32 words, keys and table columns become int32
    bit-pattern views; every other dtype is kept.  Returns a tuple."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a.copy()).to(device))
    return tuple(out)
