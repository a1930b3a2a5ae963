"""Cold-tier codecs: delta-encoded sorted key planes, packed payloads —
a copy of ``pulsar_tlaplus_tpu/store/compress.py`` (the port imports
nothing of the JAX package; the blobs are byte-equal to its).

"Compression and Sieve" (arXiv:1208.5542) splits the slow-link traffic
problem in two: the *sieve* (store/sieve.py) keeps already-confirmed
keys from crossing at all, and the *compressor* here shrinks what must
cross and what must sit in the cold tiers.  Evicted key runs arrive
SORTED (the eviction op sorts them on the device — ``torch.sort``,
cheap where sorts are bandwidth-bound), so the natural encoding is
first-value + deltas: deltas of a sorted 64-bit key plane are small,
heavily repetitive integers that zlib (stdlib — nothing to install)
packs at a fraction of raw width, and the cumulative-sum decode is one
vectorized numpy pass.  Packed row/log payloads compress as raw planes
(their entropy is the state encoding's problem, but zero runs and
field repetition still fold well).

Keys are carried as ``(hi, lo)`` numpy planes: ``hi`` is the first two
uint32 key columns packed into one uint64 and ``lo`` the third column
(all-zero for 2-column exact keys).  Sorting by ``(hi, lo)`` is
exactly the device sort's unsigned lexicographic column order, so a
run decoded on the host binary-searches with ``np.searchsorted``
directly — no re-sort, no host-side canonicalization.

Every blob is self-describing (magic + version + flags) and carries
its element count; ``raw`` vs ``comp`` byte counts feed the spill
counters (``SpillStats``), so compression ratios are observable.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_KEY_MAGIC = b"PTSK"
_PLANE_MAGIC = b"PTSR"
_VERSION = 1
_F_COMP = 1  # payloads are zlib-compressed

# zlib level 6 is the measured sweet spot for delta planes (level 9
# buys <2% over it at ~3x the CPU); fixed so spill byte counts are
# DETERMINISTIC (``spill_bytes_per_state`` is reproducible)
_ZLEVEL = 6


def pack_keys(kcols) -> Tuple[np.ndarray, np.ndarray]:
    """K uint32 key columns -> ``(hi u64, lo u32)`` planes whose
    ``(hi, lo)`` lexicographic order equals the columns' unsigned
    column-major sort order.  K is 2 or 3 (ops/dedup.KeySpec)."""
    cs = [np.asarray(c, np.uint32) for c in kcols]
    if len(cs) not in (2, 3):
        raise ValueError(f"key planes need 2 or 3 columns: {len(cs)}")
    hi = (cs[0].astype(np.uint64) << np.uint64(32)) | cs[1].astype(
        np.uint64
    )
    lo = (
        cs[2].copy()
        if len(cs) == 3
        else np.zeros(hi.shape, np.uint32)
    )
    return hi, lo


def unpack_keys(hi: np.ndarray, lo: np.ndarray, ncols: int):
    """Inverse of :func:`pack_keys` (for tests and re-insertion)."""
    c0 = (hi >> np.uint64(32)).astype(np.uint32)
    c1 = (hi & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if ncols == 2:
        return (c0, c1)
    return (c0, c1, np.asarray(lo, np.uint32))


def _emit(payload: bytes, compress: bool) -> Tuple[bytes, int]:
    if compress:
        return zlib.compress(payload, _ZLEVEL), _F_COMP
    return payload, 0


def _take(blob: bytes, flags: int) -> bytes:
    return zlib.decompress(blob) if flags & _F_COMP else blob


def encode_key_run(
    hi: np.ndarray, lo: np.ndarray, compress: bool = True
) -> Tuple[bytes, int, int]:
    """Encode one SORTED key run; returns ``(blob, raw_bytes,
    comp_bytes)``.  ``raw_bytes`` is the in-memory plane width (the
    bytes that would cross the link uncompressed), ``comp_bytes`` the
    encoded blob size."""
    hi = np.ascontiguousarray(hi, np.uint64)
    lo = np.ascontiguousarray(lo, np.uint32)
    if hi.shape != lo.shape:
        raise ValueError("hi/lo plane shapes differ")
    n = len(hi)
    if n:
        # first value + deltas: sorted, so deltas are non-negative and
        # small — this is where the compression ratio comes from
        deltas = np.empty((n,), np.uint64)
        deltas[0] = hi[0]
        np.subtract(hi[1:], hi[:-1], out=deltas[1:])
        hp = deltas.tobytes()
    else:
        hp = b""
    lp = lo.tobytes()
    raw = hi.nbytes + lo.nbytes
    h_enc, flags = _emit(hp, compress)
    l_enc, _ = _emit(lp, compress)
    blob = (
        _KEY_MAGIC
        + struct.pack("<BBQQQ", _VERSION, flags, n, len(h_enc), len(l_enc))
        + h_enc
        + l_enc
    )
    return blob, raw, len(blob)


def decode_key_run(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a key-run blob back to the sorted ``(hi, lo)`` planes."""
    if blob[:4] != _KEY_MAGIC:
        raise ValueError("not a key-run blob (bad magic)")
    ver, flags, n, lh, ll = struct.unpack_from("<BBQQQ", blob, 4)
    if ver > _VERSION:
        raise ValueError(f"key-run blob v{ver} newer than supported")
    off = 4 + struct.calcsize("<BBQQQ")
    hp = _take(blob[off: off + lh], flags)
    lp = _take(blob[off + lh: off + lh + ll], flags)
    deltas = np.frombuffer(hp, np.uint64, count=n)
    # wraparound-safe cumulative sum restores the absolute keys
    with np.errstate(over="ignore"):
        hi = np.cumsum(deltas, dtype=np.uint64)
    lo = np.frombuffer(lp, np.uint32, count=n).copy()
    return hi, lo


def encode_plane(
    arr: np.ndarray, compress: bool = True
) -> Tuple[bytes, int, int]:
    """Encode one packed payload plane (rows as flat uint32 words,
    parent/lane logs as int32); returns ``(blob, raw, comp)``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in (np.dtype(np.uint32), np.dtype(np.int32)):
        raise ValueError(f"plane dtype must be 32-bit: {arr.dtype}")
    kind = b"u" if arr.dtype == np.dtype(np.uint32) else b"i"
    payload = arr.tobytes()
    enc, flags = _emit(payload, compress)
    blob = (
        _PLANE_MAGIC
        + struct.pack("<BBcQQ", _VERSION, flags, kind, arr.size, len(enc))
        + enc
    )
    return blob, arr.nbytes, len(blob)


def decode_plane(blob: bytes) -> np.ndarray:
    if blob[:4] != _PLANE_MAGIC:
        raise ValueError("not a payload-plane blob (bad magic)")
    ver, flags, kind, n, le = struct.unpack_from("<BBcQQ", blob, 4)
    if ver > _VERSION:
        raise ValueError(f"plane blob v{ver} newer than supported")
    off = 4 + struct.calcsize("<BBcQQ")
    payload = _take(blob[off: off + le], flags)
    dt = np.uint32 if kind == b"u" else np.int32
    return np.frombuffer(payload, dt, count=n).copy()
