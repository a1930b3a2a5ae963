"""Host-side tiers: cold key runs, row/log segments, the spill manifest —
the counterpart of ``pulsar_tlaplus_tpu/store/tiers.py`` (``SpillStats``,
``TieredStore``, ``cleanup_stale_spill``).

The :class:`TieredStore` is the engine's "slower memory": evicted
visited-table key runs and aged row/log ranges live here, in host RAM
always, and for a checkpointed run also as files under the run's spill
directory, so a resume restores the whole tiered store and not only the
device window.

- **Synchronous availability, asynchronous durability.**  An evicted run
  is queryable the moment :meth:`evict_keys` returns (the very next
  flush may probe a just-evicted key); its encode (``store/compress.py``)
  and, when durable, its file write run on a background worker,
  overlapped with the compute, and :meth:`flush` joins them.
  ``blocked_s`` (time actually waited there) over ``transfer_s`` (total
  D2H + encode + write work) gives the overlap ratio.
- **Batched miss resolution.**  :meth:`lookup_keys` resolves a whole
  sieved batch against every cold run with range-pruned binary
  searches — O(batch * log(run)) per run, no per-key host loops.
- **Crash hygiene.**  Spill files are written to a per-writer-unique
  ``<name>.tmp.<pid>.<tid>`` and ``os.replace``d into place, so a killed
  run never publishes a torn file; stale temps are swept when a store
  opens its directory (:func:`cleanup_stale_spill`), and a fresh run
  wipes its directory (:meth:`wipe`).
- **Manifest-anchored resume.**  :meth:`manifest` describes every run and
  segment (counts, sizes, file names, content digests); frames embed it,
  and :meth:`restore` refuses a digest mismatch.
- **ENOSPC degrades, never crashes.**  A full disk on the background
  write (real, or the ``enospc@spill:N`` drill) latches
  :attr:`degraded`: the RAM tiers stay queryable (dedup stays exact),
  durable writes stop, :meth:`manifest` refuses, and the engine ends the
  run with ``stop_reason="spill_enospc"``.
"""

from __future__ import annotations

import errno
import hashlib
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from pulsar_tlaplus_tpu_torch.store import compress as codec
from pulsar_tlaplus_tpu_torch.utils import faults

_TMP_MARK = ".tmp."


def _digest(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()[:16]


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f"{path}{_TMP_MARK}{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def cleanup_stale_spill(spill_dir: Optional[str]) -> int:
    """Remove the ``*.tmp.<pid>.<tid>`` spill temps a crash mid-write
    left; returns how many.  A missing directory is a no-op."""
    if not spill_dir:
        return 0
    try:
        names = os.listdir(spill_dir)
    except OSError:
        return 0
    removed = 0
    for name in names:
        if _TMP_MARK not in name:
            continue
        try:
            os.remove(os.path.join(spill_dir, name))
            removed += 1
        except OSError:
            pass
    return removed


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
    """Cold tiers for one run: key runs + row/log segments.

    A ``durable`` store (a checkpointed run's) also writes every run and
    segment to ``spill_dir`` as it is created, so a frame only needs to
    embed the :meth:`manifest`.  Otherwise the cold tiers live in host
    RAM only."""

    def __init__(self, ncols: int = 2, spill_dir: Optional[str] = None,
                 compress: bool = True, durable: bool = False):
        if durable and not spill_dir:
            raise ValueError("durable spill needs a spill_dir")
        self.ncols = int(ncols)
        self.spill_dir = spill_dir
        self.compress = bool(compress)
        self.durable = bool(durable)
        self.stats = SpillStats()
        # cold key runs: [{kind, n, hi, lo, file, digest, raw, comp}]
        self._runs: List[Dict] = []
        # row/log segments: [{kind, lo, hi, arr | arrs, file(s), ...}]
        self._rows: List[Dict] = []
        self._logs: List[Dict] = []
        self._seq = 0
        self._spill_write_n = 0  # the enospc@spill fault site
        # the ENOSPC latch: durable writes stop, manifest() refuses
        self.degraded = False
        self.degraded_error: Optional[str] = None
        self._pending: List[Future] = []
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ptt-spill"
        )
        self._lock = threading.Lock()
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            cleanup_stale_spill(spill_dir)

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
        rec: Dict = {"kind": "keys", "n": n, "hi": hi, "lo": lo,
                     "file": None, "digest": None,
                     "raw": hi.nbytes + lo.nbytes, "comp": None}
        self._runs.append(rec)
        self.stats.evictions += 1
        self.stats.keys_evicted += n
        self._submit_encode(
            rec, lambda: codec.encode_key_run(hi, lo, self.compress),
            f"keys_{self._next_seq()}.ptsk",
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
        rec: Dict = {"kind": "rows", "lo": int(gid_lo), "hi": int(gid_hi),
                     "arr": arr, "file": None, "digest": None,
                     "raw": arr.nbytes, "comp": None}
        self._rows.append(rec)
        self.stats.rows_evicted += int(gid_hi - gid_lo)
        self._submit_encode(
            rec, lambda: codec.encode_plane(arr, self.compress),
            f"rows_{gid_lo}_{gid_hi}.ptsr",
        )

    def spill_logs(self, gid_lo: int, gid_hi: int, parent, lane) -> None:
        """Store the parent/lane trace-log range [gid_lo, gid_hi)."""
        if gid_hi <= gid_lo:
            return
        par = np.ascontiguousarray(parent, np.int32)
        lan = np.ascontiguousarray(lane, np.int32)
        rec: Dict = {"kind": "logs", "lo": int(gid_lo), "hi": int(gid_hi),
                     "arrs": (par, lan), "files": None, "digests": None,
                     "raw": par.nbytes + lan.nbytes, "comp": None}
        self._logs.append(rec)
        self.stats.logs_evicted += int(gid_hi - gid_lo)
        seq = self._next_seq()

        def encode():
            bp, rp, cp = codec.encode_plane(par, self.compress)
            bl, rl, cl = codec.encode_plane(lan, self.compress)
            return (bp, bl), rp + rl, cp + cl

        self._submit_encode(
            rec, encode,
            (f"parent_{gid_lo}_{gid_hi}.{seq}.ptsr",
             f"lane_{gid_lo}_{gid_hi}.{seq}.ptsr"),
        )

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

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _submit_encode(self, rec: Dict, encode, names) -> None:
        # the enospc@spill:N drill arms on the submitting (engine)
        # thread, so the write it hits is deterministic; the error is
        # raised at the worker's write, where a real full disk lands
        self._spill_write_n += 1
        inject = "enospc" in faults.poll("spill", self._spill_write_n)
        inject_n = self._spill_write_n

        def job():
            t0 = time.perf_counter()
            blob, raw, comp = encode()
            files = digests = None
            try:
                if self.durable and not self.degraded:
                    if inject:
                        raise faults.enospc_error("spill", inject_n)
                    blobs = blob if isinstance(blob, tuple) else (blob,)
                    fnames = names if isinstance(names, tuple) else (names,)
                    files, digests = [], []
                    for b, nm in zip(blobs, fnames):
                        _atomic_write(os.path.join(self.spill_dir, nm), b)
                        files.append(nm)
                        digests.append(_digest(b))
            except OSError as e:
                if e.errno != errno.ENOSPC:
                    raise  # only a full disk degrades
                files = digests = None
                with self._lock:
                    self.degraded = True
                    self.degraded_error = f"{e}"
            with self._lock:
                rec["comp"] = comp
                if rec["kind"] == "logs":
                    rec["files"], rec["digests"] = files, digests
                else:
                    rec["file"] = files[0] if files else None
                    rec["digest"] = digests[0] if digests else None
                self.stats.bytes_raw += raw
                self.stats.bytes_comp += comp
                self.stats.transfer_s += time.perf_counter() - t0

        self._pending.append(self._pool.submit(job))

    def flush(self) -> None:
        """Join pending encode/write work (a boundary barrier).  Time
        spent waiting here is the NON-overlapped share of the transfer
        work."""
        if not self._pending:
            return
        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()  # re-raises a worker failure loudly
        self.stats.blocked_s += time.perf_counter() - t0

    def close(self) -> None:
        """Join and shut down the worker; the tiers stay readable (trace
        walks read cold data after the run ends)."""
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)

    # ------------------------------------------------ manifest / resume

    def manifest(self) -> Dict[str, object]:
        """A JSON-able description of every cold run and segment, which
        frames embed; joins the pending writes first.  A degraded store
        refuses: its directory is incomplete."""
        self.flush()
        if self.degraded:
            raise ValueError(
                "spill tier degraded (ENOSPC): the spill dir is "
                "incomplete, so no frame may anchor a resume on it "
                f"({self.degraded_error})"
            )
        with self._lock:
            return {
                "spill_v": 1,
                "ncols": self.ncols,
                "compress": self.compress,
                "durable": self.durable,
                "stats": self.stats.as_dict(),
                "key_runs": [
                    {"n": r["n"], "file": r["file"], "digest": r["digest"],
                     "raw": r["raw"], "comp": r["comp"]}
                    for r in self._runs
                ],
                "rows": [
                    {"lo": r["lo"], "hi": r["hi"], "file": r["file"],
                     "digest": r["digest"], "raw": r["raw"],
                     "comp": r["comp"]}
                    for r in self._rows
                ],
                "logs": [
                    {"lo": r["lo"], "hi": r["hi"], "files": r["files"],
                     "digests": r["digests"], "raw": r["raw"],
                     "comp": r["comp"]}
                    for r in self._logs
                ],
            }

    def _read_verified(self, name: str, want_digest: str) -> bytes:
        path = os.path.join(self.spill_dir, name)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise ValueError(
                f"spill file missing/unreadable on resume: {path} ({e})"
            ) from e
        if _digest(blob) != want_digest:
            raise ValueError(
                f"spill file digest mismatch on resume: {path} — torn or "
                "foreign file; the run cannot resume from it"
            )
        return blob

    def restore(self, manifest: Dict) -> None:
        """Rebuild the cold tiers from a frame's manifest (the files
        must be under ``spill_dir``); a digest mismatch or a count that
        disagrees raises."""
        if not self.spill_dir:
            raise ValueError("restore needs a spill_dir")
        if int(manifest.get("spill_v", 0)) > 1:
            raise ValueError("spill manifest newer than supported")
        self._runs, self._rows, self._logs = [], [], []
        for e in manifest.get("key_runs", []):
            hi, lo = codec.decode_key_run(
                self._read_verified(e["file"], e["digest"]))
            if len(hi) != int(e["n"]):
                raise ValueError(
                    f"spill run {e['file']}: decoded {len(hi)} keys, "
                    f"manifest says {e['n']}"
                )
            self._runs.append({
                "kind": "keys", "n": int(e["n"]), "hi": hi, "lo": lo,
                "file": e["file"], "digest": e["digest"],
                "raw": int(e["raw"]), "comp": int(e["comp"]),
            })
        for e in manifest.get("rows", []):
            blob = self._read_verified(e["file"], e["digest"])
            self._rows.append({
                "kind": "rows", "lo": int(e["lo"]), "hi": int(e["hi"]),
                "arr": codec.decode_plane(blob), "file": e["file"],
                "digest": e["digest"], "raw": int(e["raw"]),
                "comp": int(e["comp"]),
            })
        for e in manifest.get("logs", []):
            bp = self._read_verified(e["files"][0], e["digests"][0])
            bl = self._read_verified(e["files"][1], e["digests"][1])
            self._logs.append({
                "kind": "logs", "lo": int(e["lo"]), "hi": int(e["hi"]),
                "arrs": (codec.decode_plane(bp), codec.decode_plane(bl)),
                "files": e["files"], "digests": e["digests"],
                "raw": int(e["raw"]), "comp": int(e["comp"]),
            })
        # the cumulative counters go on from the frame's
        st = manifest.get("stats") or {}
        for f in SpillStats.FIELDS:
            if f in st:
                setattr(self.stats, f,
                        float(st[f]) if f.endswith("_s") else int(st[f]))
        self._seq = len(self._runs) + len(self._rows) + len(self._logs)

    def wipe(self) -> None:
        """Fresh-run hygiene: drop every spill file of the directory (the
        run owns it) and reset the tiers."""
        self._runs, self._rows, self._logs = [], [], []
        self.stats = SpillStats()
        if not self.spill_dir:
            return
        try:
            names = os.listdir(self.spill_dir)
        except OSError:
            return
        for name in names:
            if name.endswith((".ptsk", ".ptsr")) or _TMP_MARK in name:
                try:
                    os.remove(os.path.join(self.spill_dir, name))
                except OSError:
                    pass
