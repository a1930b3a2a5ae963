"""Counter-based random words for the simulator — the port's counterpart
of ``jax.random.fold_in`` as ``pulsar_tlaplus_tpu/sim/engine.py`` uses it.

A word is a stateless hash ``H(seed, stream, step, walker)``: nothing is
carried from one step to the next, so a walk resumes from ``(walker
states, epoch)`` alone and one walker's stream replays without the
swarm.  ``torch.Generator`` offers neither: its Philox streams differ
between the CPU and CUDA and cannot be rewound to a (step, walker)
position.  The hash is murmur3's 32-bit finalizer, chained: the host
folds ``(seed, stream, step)`` into one key in Python ints, and the
device mixes the key with each walker (and word index) in integer torch
ops only (``ops/dedup``'s uint32 rule: int64 values below 2^32, masked
after every ``*``, ``+`` and ``<<``).  So the same walk comes out on the
CPU and on the card, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from pulsar_tlaplus_tpu_torch.ops.dedup import U32, fmix, mul32

# the streams of one seed
INIT = 1  # a behavior's initial state, at its round's first step
STEP = 2  # a walker's lane choice at a step

_GOLD = 0x9E3779B9
_C2 = 0x85EBCA6B


def _fmix_int(h: int) -> int:
    """murmur3's 32-bit finalizer on a Python int in ``[0, 2^32)``."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def stream_key(seed: int, stream: int, step: int) -> int:
    """The uint32 key of ``(seed, stream, step)``, on the host; seeds
    and steps may exceed 32 bits (both words are folded in)."""
    seed &= (1 << 64) - 1
    h = _fmix_int((seed & U32) ^ _GOLD)
    for x in (seed >> 32, stream, step & U32, (step >> 32) & U32):
        h = _fmix_int(h ^ ((x * _C2) & U32))
    return h


def words(key: int, walker: torch.Tensor,
          n: Optional[int] = None) -> torch.Tensor:
    """uint32 words (int64) for the walkers ``walker`` (int ``[B]``)
    under ``key``: ``[B]``, or ``[B, n]`` with ``n`` words a walker."""
    w = walker.to(torch.int64) & U32
    h = fmix(mul32(w, _GOLD) ^ key)
    if n is None:
        return h
    j = torch.arange(1, n + 1, dtype=torch.int64, device=walker.device)
    return fmix(h[:, None] ^ mul32(j, _C2)[None, :])


def below(u: torch.Tensor, n) -> torch.Tensor:
    """``floor(u * n / 2^32)``: a uniform integer in ``[0, n)`` from a
    uint32 word, with no float (``n`` an int or int64 tensor, at most
    2^31)."""
    return (u * n) >> 32


def pick_lane(u: torch.Tensor, valid: torch.Tensor,
              stutter: torch.Tensor):
    """One lane per walker, uniform over its enabled lanes plus the
    stutter lane (``A``) when stuttering is enabled; ``A`` when nothing
    is enabled (stay put).  ``u`` int64 ``[B]`` words, ``valid`` bool
    ``[B, A]``, ``stutter`` bool ``[B]``.  Returns ``(lane [B] in
    0..A, enabled count [B])``: the ``j``-th enabled lane for ``j =
    below(u, count)``."""
    a = valid.shape[1]
    en = torch.cat([valid, stutter[:, None]], dim=1)
    n_en = en.sum(dim=1)
    j = below(u, n_en)
    lane = (en.cumsum(dim=1) <= j[:, None]).sum(dim=1)
    return torch.where(n_en == 0, a, lane), n_en
