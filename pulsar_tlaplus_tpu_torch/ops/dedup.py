"""Fingerprint keys and the sort-merge visited set — the counterpart of
``pulsar_tlaplus_tpu/ops/dedup.py`` (``SENTINEL``, ``_fmix``,
``murmur3_words``, ``KeySpec``, ``make_keys``, ``merge_new_keys``,
``sort_perm``, ``bsearch_member``, ``merge_sorted``).

Words and key columns live on the device as int32 tensors holding uint32
bit patterns: 4 bytes a word, and the all-ones empty marker ``SENTINEL``
reads as -1.  PyTorch has no uint32 ``+``, shifts or ``min``, so the
arithmetic here widens to int64 "u32 values" in ``[0, 2^32)``, masks after
every ``+``, ``*`` and ``<<``, and narrows back with :func:`i32`.  A
multiply by a 32-bit constant is split at 16 bits so that no product
leaves int64's range.  Any ordering of keys must keep SENTINEL largest,
which an int32 view does not: compare the widened values.

The sort-merge visited set is a SENTINEL-padded array of key columns in
unsigned lexicographic order.  The JAX package sorts it with
``lax.sort`` outside any Pallas kernel; here every sort is a library
``torch.sort`` over widened values: :func:`lex_order` sorts stably from
the least significant column, two columns at a time packed into one
int64 (:func:`key64`).  96-bit keys do not fit one int64
``searchsorted``, so :func:`bsearch_member` is the JAX lexicographic
binary search, one gather a step.
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


def make_keys(packed: torch.Tensor, total_bits: int):
    """packed int32 ``[N, W]`` -> three int32 ``[N]`` dedup key columns
    (the host engines' keys): the packed words zero-padded when the
    state is under 96 bits, else three murmur3 fingerprints with the
    all-SENTINEL triple remapped — ``KeySpec(total_bits, W, 96)`` with a
    zero column appended where that spec is two columns wide.  On the
    card the columns come from the key-plane kernel (K2)."""
    from pulsar_tlaplus_tpu_torch.ops import tiles  # tiles imports dedup

    n, w = packed.shape
    spec = KeySpec(total_bits, w, fp_bits=96)
    cols = tiles.key_plane(
        spec, packed, torch.ones((n,), dtype=torch.bool,
                                 device=packed.device))
    if len(cols) == 2:
        cols = (*cols, torch.zeros((n,), dtype=torch.int32,
                                   device=packed.device))
    return tuple(cols)


def key64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the unsigned order of the int32
    bit-pattern pairs ``(a, b)``: the high word biased by 2^31."""
    return ((u32(a) - (1 << 31)) << 32) | u32(b)


def lex_order(cols) -> torch.Tensor:
    """The stable permutation sorting int32 bit-pattern columns in
    unsigned lexicographic order (SENTINEL = 0xFFFFFFFF last): stable
    sorts from the least significant end, two columns at a time as one
    int64 key (:func:`key64`), a lone first column as its u32 value."""
    cols = list(cols)
    perm = None
    i = len(cols)
    while i > 0:
        j = max(i - 2, 0)
        grp = [c if perm is None else c[perm] for c in cols[j:i]]
        k = key64(*grp) if len(grp) == 2 else u32(grp[0])
        o = torch.sort(k, stable=True).indices
        perm = o if perm is None else perm[o]
        i = j
    return perm


def _lex_less(a, b) -> torch.Tensor:
    """``a < b`` lexicographically over widened u32 columns."""
    less = a[-1] < b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        less = (x < y) | ((x == y) & less)
    return less


def same_as_prev(cols) -> torch.Tensor:
    """Entry ``i`` equals entry ``i - 1`` in every column (False at 0)."""
    n = cols[0].shape[0]
    eq = torch.zeros((n,), dtype=torch.bool, device=cols[0].device)
    if n > 1:
        e = cols[0][1:] == cols[0][:-1]
        for c in cols[1:]:
            e = e & (c[1:] == c[:-1])
        eq[1:] = e
    return eq


def merge_new_keys(vcols, ccols, cpay: torch.Tensor):
    """Sort-merge candidate key columns into the sorted visited columns
    (both SENTINEL-padded).  ``cpay`` is the candidates' payload word
    (int32 bit patterns) with the tag bit 31 set; visited entries ride
    payload 0, so one sort on ``(cols..., payload)`` — the payload
    unsigned — orders visited before same-key candidates and settles
    in-batch duplicates and membership in one pass (min-lane-wins).
    Returns ``(vcols', n_new, sorted_payload, new_flag)``; ``vcols'``
    has the width of ``vcols`` (callers guarantee the merged set
    fits); ``n_new`` is an int64 0-d tensor."""
    V = vcols[0].shape[0]
    dev = vcols[0].device
    cols = [torch.cat([v, c]) for v, c in zip(vcols, ccols)]
    pay = torch.cat([torch.zeros((V,), dtype=torch.int32, device=dev),
                     cpay.to(torch.int32)])
    order = lex_order(cols + [pay])
    scols = [c[order] for c in cols]
    sp = pay[order]
    tag = sp < 0  # bit 31: a candidate
    sent = scols[0] == SENTINEL
    for c in scols[1:]:
        sent = sent & (c == SENTINEL)
    new_flag = tag & ~sent & ~same_as_prev(scols)
    keep = ~sent & (~tag | new_flag)
    n_new = new_flag.sum()
    # blank the dropped entries before the compaction: their keys must
    # not survive into the visited columns
    ko = torch.sort((~keep).to(torch.int8), stable=True).indices[:V]
    vout = tuple(torch.where(keep, c, SENTINEL)[ko] for c in scols)
    return vout, n_new, sp, new_flag


def merge_lanes(vcols, kcols, n_acc):
    """The sort-merge flush of a window of lanes (the device engines'
    ``visited_impl="sort"``): lanes at or past ``n_acc`` (an int or a
    0-d tensor) are masked, each candidate rides its lane id tagged in
    bit 31, and the new-key flags come back in lane order.  Returns
    ``(vcols', n_new, is_new bool[n])``; nothing is read on the host."""
    n = kcols[0].shape[0]
    dev = kcols[0].device
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    cc = tuple(torch.where(lane < n_acc, c, SENTINEL) for c in kcols)
    vout, n_new, sp, new_flag = merge_new_keys(vcols, cc,
                                               lane | -(1 << 31))
    # candidates' payloads back to their lanes; visited ones to a trash
    # slot
    idx = torch.where(sp < 0, (sp & 0x7FFFFFFF).to(torch.int64), n)
    is_new = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    is_new.scatter_(0, idx, new_flag)
    return vout, n_new, is_new[:n]


def sort_perm(invalid: torch.Tensor, k1, k2, k3) -> torch.Tensor:
    """Stable permutation ordering valid lanes by key, invalid lanes
    last (int32)."""
    return lex_order([invalid.to(torch.int32), k1, k2, k3]).to(torch.int32)


def bsearch_member(vk1, vk2, vk3, n_visited, q1, q2, q3) -> torch.Tensor:
    """Membership of the query keys in the sorted visited columns (the
    first ``n_visited`` entries): a lexicographic binary search over
    widened u32 columns, one gather a step.  bool ``[nq]``."""
    cap = vk1.shape[0]
    nq = q1.shape[0]
    dev = q1.device
    v = [u32(c) for c in (vk1, vk2, vk3)]
    q = [u32(c) for c in (q1, q2, q3)]
    nvt = torch.as_tensor(n_visited, dtype=torch.int64, device=dev)
    lo = torch.zeros((nq,), dtype=torch.int64, device=dev)
    hi = nvt.expand(nq).clone()
    for _ in range(max(1, cap.bit_length())):
        mid = (lo + hi) >> 1
        at = mid.clamp(max=cap - 1)
        less = _lex_less([c[at] for c in v], q)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    at = lo.clamp(0, cap - 1)
    eq = (v[0][at] == q[0]) & (v[1][at] == q[1]) & (v[2][at] == q[2])
    return (lo < nvt) & eq


def merge_sorted(vk1, vk2, vk3, nk1, nk2, nk3):
    """Merge new key columns (SENTINEL-padded) into the sorted visited
    columns; returns the first ``cap`` entries of the merged order
    (callers guarantee the real keys fit)."""
    cap = vk1.shape[0]
    cols = [torch.cat([a, b]) for a, b in ((vk1, nk1), (vk2, nk2),
                                           (vk3, nk3))]
    order = lex_order(cols)[:cap]
    return tuple(c[order] for c in cols)


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
