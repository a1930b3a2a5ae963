"""Host-side tiers: cold key runs and row/log segments in host RAM — the
RAM tier of ``pulsar_tlaplus_tpu/store/tiers.py`` (``SpillStats``,
``TieredStore``).

The :class:`TieredStore` is the engine's "slower memory": evicted
visited-table key runs and aged row/log ranges live here, in host RAM.

- **Synchronous availability, asynchronous encoding.**  An evicted run
  is queryable the moment :meth:`evict_keys` returns (the very next
  flush may probe a just-evicted key); its encode (the codec of
  ``store/compress.py``, which sizes the compressed bytes) runs on a
  background worker, overlapped with the compute, and :meth:`flush`
  joins it (the engine joins once, at the end of the run).
  ``blocked_s`` (time actually waited there) over ``transfer_s``
  (total D2H + encode work) gives the overlap ratio.
- **Batched miss resolution.**  :meth:`lookup_keys` resolves a whole
  sieved batch against every cold run with range-pruned binary
  searches — O(batch * log(run)) per run, no per-key host loops.

The durable half of the JAX store (spill files, the checkpoint
manifest, restore, ENOSPC degradation) is not ported yet: it arrives
with checkpoints.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from pulsar_tlaplus_tpu_torch.store import compress as codec


class SpillStats:
    """Cumulative spill counters."""

    FIELDS = (
        "evictions", "keys_evicted", "rows_evicted", "logs_evicted",
        "bytes_raw", "bytes_comp", "transfer_s", "blocked_s",
        "misses_resolved", "miss_hits", "miss_batches", "lookup_s",
    )

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, 0.0 if f.endswith("_s") else 0)

    def as_dict(self) -> Dict[str, object]:
        return {
            f: (
                round(getattr(self, f), 4)
                if f.endswith("_s")
                else int(getattr(self, f))
            )
            for f in self.FIELDS
        }

    @property
    def overlap_ratio(self) -> Optional[float]:
        """Fraction of spill transfer work that overlapped compute
        (1.0 = boundaries never waited on a transfer)."""
        if self.transfer_s <= 0:
            return None
        return round(
            max(0.0, 1.0 - self.blocked_s / self.transfer_s), 4
        )


class TieredStore:
    """Cold tiers for one run, in host RAM: key runs + row/log
    segments."""

    def __init__(self, compress: bool = True):
        self.compress = bool(compress)
        self.stats = SpillStats()
        # cold key runs: [{n, hi, lo}]
        self._runs: List[Dict] = []
        # row/log segments: [{lo, hi, arr | arrs}]
        self._rows: List[Dict] = []
        self._logs: List[Dict] = []
        self._pending: List[Future] = []
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ptt-spill"
        )
        self._lock = threading.Lock()

    # ------------------------------------------------------------ keys

    @property
    def has_cold_keys(self) -> bool:
        return bool(self._runs)

    def evict_keys(self, kcols_np) -> int:
        """Ingest one SORTED evicted key run (dense uint32 numpy columns
        from the device's ``extract_cold``).  Queryable immediately;
        the encode happens on the background worker."""
        hi, lo = codec.pack_keys(kcols_np)
        n = len(hi)
        if n == 0:
            return 0
        self._runs.append({"n": n, "hi": hi, "lo": lo})
        self.stats.evictions += 1
        self.stats.keys_evicted += n
        self._submit_encode(
            lambda: codec.encode_key_run(hi, lo, self.compress)
        )
        return n

    def lookup_keys(self, kcols_np) -> np.ndarray:
        """bool mask over the query batch: True = the key is in SOME
        cold run (a false-new verdict the engine must merge back)."""
        t0 = time.perf_counter()
        qhi, qlo = codec.pack_keys(kcols_np)
        member = np.zeros(qhi.shape, bool)
        for rec in self._runs:
            hi, lo = rec["hi"], rec["lo"]
            # range pruning: most runs cover disjoint key ranges only
            # probabilistically, but the bounds check is nearly free
            sel = (qhi >= hi[0]) & (qhi <= hi[-1]) & ~member
            if not sel.any():
                continue
            qh, ql = qhi[sel], qlo[sel]
            left = np.searchsorted(hi, qh, "left")
            right = np.searchsorted(hi, qh, "right")
            # within the block of equal ``hi`` (more than one key only
            # with 3 columns: exact 3-column keys share their first two
            # words often) ``lo`` is sorted: a binary search of all the
            # queries' blocks at once for the first ``lo >= ql``
            a, b = left.copy(), right.copy()
            last = len(hi) - 1
            while True:
                open_ = a < b
                if not open_.any():
                    break
                mid = (a + b) // 2
                up = open_ & (lo[np.minimum(mid, last)] < ql)
                a = np.where(up, mid + 1, a)
                b = np.where(open_ & ~up, mid, b)
            hit = (a < right) & (lo[np.minimum(a, last)] == ql)
            member[np.nonzero(sel)[0][hit]] = True
        self.stats.misses_resolved += int(len(qhi))
        self.stats.miss_hits += int(member.sum())
        self.stats.miss_batches += 1
        self.stats.lookup_s += time.perf_counter() - t0
        return member

    # ------------------------------------------------- rows / logs

    def spill_rows(self, gid_lo: int, gid_hi: int, flat_u32) -> None:
        """Store the packed rows of gid range [gid_lo, gid_hi) (flat
        uint32, ``(gid_hi - gid_lo) * W`` words)."""
        if gid_hi <= gid_lo:
            return
        arr = np.ascontiguousarray(flat_u32, np.uint32)
        self._rows.append({"lo": int(gid_lo), "hi": int(gid_hi), "arr": arr})
        self.stats.rows_evicted += int(gid_hi - gid_lo)
        self._submit_encode(lambda: codec.encode_plane(arr, self.compress))

    def spill_logs(self, gid_lo: int, gid_hi: int, parent, lane) -> None:
        """Store the parent/lane trace-log range [gid_lo, gid_hi)."""
        if gid_hi <= gid_lo:
            return
        par = np.ascontiguousarray(parent, np.int32)
        lan = np.ascontiguousarray(lane, np.int32)
        self._logs.append(
            {"lo": int(gid_lo), "hi": int(gid_hi), "arrs": (par, lan)}
        )
        self.stats.logs_evicted += int(gid_hi - gid_lo)

        def encode():
            bp, rp, cp = codec.encode_plane(par, self.compress)
            bl, rl, cl = codec.encode_plane(lan, self.compress)
            return (bp, bl), rp + rl, cp + cl

        self._submit_encode(encode)

    def _gather(self, segs: List[Dict], lo: int, hi: int, width: int,
                pick) -> np.ndarray:
        """Concatenate segment slices covering [lo, hi) in gid order;
        raises on gaps (a spilled range the store never saw would
        silently corrupt a trace)."""
        out = []
        cur = lo
        for rec in sorted(segs, key=lambda r: r["lo"]):
            if rec["hi"] <= cur or rec["lo"] >= hi:
                continue
            if rec["lo"] > cur:
                raise ValueError(
                    f"cold tier gap: [{cur}, {rec['lo']}) missing"
                )
            a, b = cur, min(rec["hi"], hi)
            arr = pick(rec)
            out.append(
                arr[(a - rec["lo"]) * width: (b - rec["lo"]) * width]
            )
            cur = b
            if cur >= hi:
                break
        if cur < hi:
            raise ValueError(f"cold tier gap: [{cur}, {hi}) missing")
        return np.concatenate(out)

    def fetch_rows(self, gid_lo: int, gid_hi: int, W: int) -> np.ndarray:
        """Flat uint32 rows for gid range [gid_lo, gid_hi) streamed
        back from the cold segments."""
        if gid_hi <= gid_lo:
            return np.zeros((0,), np.uint32)
        return self._gather(
            self._rows, gid_lo, gid_hi, W, lambda r: r["arr"]
        )

    def fetch_logs(
        self, gid_lo: int, gid_hi: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        if gid_hi <= gid_lo:
            z = np.zeros((0,), np.int32)
            return z, z
        par = self._gather(
            self._logs, gid_lo, gid_hi, 1, lambda r: r["arrs"][0]
        )
        lan = self._gather(
            self._logs, gid_lo, gid_hi, 1, lambda r: r["arrs"][1]
        )
        return par, lan

    @property
    def rows_spilled_hi(self) -> int:
        """One past the highest spilled row gid (0 = nothing spilled);
        spilled row ranges are contiguous from 0 by construction."""
        return max((r["hi"] for r in self._rows), default=0)

    # ------------------------------------------------------ async tier

    def note_transfer(self, seconds: float) -> None:
        """Account engine-side D2H time for the spilled data (the other
        half of the transfer beside the encode).  Under the lock: the
        encode worker increments the same counter."""
        with self._lock:
            self.stats.transfer_s += float(seconds)

    def _submit_encode(self, encode) -> None:
        def job():
            t0 = time.perf_counter()
            _blob, raw, comp = encode()
            with self._lock:
                self.stats.bytes_raw += raw
                self.stats.bytes_comp += comp
                self.stats.transfer_s += time.perf_counter() - t0

        self._pending.append(self._pool.submit(job))

    def flush(self) -> None:
        """Join pending encode work (boundary barrier).  Time spent
        waiting here is the NON-overlapped share of the transfer
        work."""
        if not self._pending:
            return
        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()  # re-raises a worker failure loudly
        self.stats.blocked_s += time.perf_counter() - t0

    def close(self) -> None:
        """Join and shut down the encode worker; the tiers stay readable
        (trace walks read cold data after the run ends)."""
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)
