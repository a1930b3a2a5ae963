"""Checkpoint frames — the counterpart of
``pulsar_tlaplus_tpu/utils/ckpt.py``.

A week-long check survives a crash through its frames (TLC's
``states/`` directory).  This module is the engine-agnostic half:

- **Atomicity**: a frame is written to a per-writer-unique
  ``<path>.tmp.<pid>.<tid>.npz`` and ``os.replace``d over the target, so
  a crash mid-write never leaves half a frame where a resumable one
  was, and two writers racing on one path each publish a whole frame.
- **Signature**: every frame embeds a configuration signature
  (:func:`config_sig`); :func:`load_frame` refuses a frame written under
  another configuration (another model, invariant set, key geometry or
  engine — a frame of the JAX package too) with one clean error.
- **Format version**: frames carry ``__format__``; readers accept every
  version up to :data:`FORMAT_VERSION`.
- **Compacted table occupancy** (:func:`pack_table` /
  :func:`restore_table`): only the occupied slots of the visited table
  are stored, as their slot indices and their keys per column — the JAX
  codec's arrays (``fp_tcap``, ``fp_slot``, ``fpk<i>``, ...).  The form
  does not depend on the table's layout: the port's table is slot-major
  (``[cap + 1, K]``), the JAX one column-major, and a restore writes each
  key back into its own slot (no rehash, no kernel).  The occupied slots
  are found on the device, so only they cross to the host.
- **Hardened writer**: a transient ``OSError`` retries with bounded
  exponential backoff (``PTT_FAULT=ckpt_fail@frame:N`` injects one);
  stale temps of a crashed writer are removed at run start
  (:func:`cleanup_stale_tmp`, scoped to the one frame path).
- **Preemption**: :class:`PreemptionWatcher` turns SIGTERM/SIGINT into
  "write a frame at the next level boundary and stop resumably".

Frames are uncompressed ``.npz`` (the JAX package deflates its frames):
at the card's state rates a deflate of a multi-GB frame would cost tens
of seconds of host time at every frame.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.utils import faults

FORMAT_VERSION = 2

# bounded retry of a transient frame-write failure: MAX_WRITE_RETRIES
# retries with exponential backoff from WRITE_BACKOFF_S
MAX_WRITE_RETRIES = 3
WRITE_BACKOFF_S = 0.05


def config_sig(**fields) -> str:
    """Canonical signature string of keyword fields (sorted, so two call
    sites building the same configuration agree)."""
    return repr(tuple(sorted((k, repr(v)) for k, v in fields.items())))


def model_sig(model) -> str:
    """Model identity for a frame's signature (the JAX engines'
    contract): hand models carry their Constants in ``.c``; compiled
    specs are their module name, constant bindings and lane labels."""
    c = getattr(model, "c", None)
    if c is not None:
        return repr(c)
    spec = getattr(model, "spec", None)
    if spec is not None:
        return repr((
            getattr(spec.module, "name", "?"),
            sorted((k, repr(v)) for k, v in spec.constants.items()),
            tuple(getattr(model, "lane_labels", ())),
        ))
    return type(model).__name__


def save_frame(
    path: str, sig: str, arrays: Dict[str, np.ndarray],
    wall_s: float = 0.0,
    meta: Optional[Dict[str, object]] = None,
) -> Tuple[int, float, int]:
    """Write one frame atomically; returns ``(bytes, write seconds,
    retries)``.  ``sig`` is the writer's configuration signature,
    ``wall_s`` the run's cumulative wall time (a resumed run's rate stays
    meaningful end to end), ``meta`` a small JSON-able dict stored under
    ``__meta__``; a ``frame_seq`` in it is the ``frame`` fault site."""
    t0 = time.perf_counter()
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}.npz"
    extra = {}
    if meta:
        extra["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                          dtype=np.uint8)
    inject = (meta is not None and meta.get("frame_seq") is not None
              and "ckpt_fail" in faults.poll("frame",
                                             int(meta["frame_seq"])))
    retries = 0
    while True:
        try:
            if inject:
                inject = False  # transient: the first attempt only
                raise OSError(28, "No space left on device "
                              "(injected fault ckpt_fail, PTT_FAULT)")
            np.savez(
                tmp,
                __format__=np.int64(FORMAT_VERSION),
                sig=np.frombuffer(sig.encode(), dtype=np.uint8),
                wall_s=np.float64(wall_s),
                **extra,
                **arrays,
            )
            nbytes = os.path.getsize(tmp)
            os.replace(tmp, path)
            return nbytes, time.perf_counter() - t0, retries
        except OSError:
            # a failed attempt's temp must not linger (on ENOSPC,
            # removing it is what lets the retry succeed)
            try:
                os.remove(tmp)
            except OSError:
                pass
            if retries >= MAX_WRITE_RETRIES:
                raise
            time.sleep(WRITE_BACKOFF_S * (1 << retries))
            retries += 1


def cleanup_stale_tmp(path: Optional[str]) -> bool:
    """Remove the ``<path>.tmp.*.npz`` temps a crash mid-write left (the
    atomic replace never published them).  Only this frame path's:
    sibling frames in the directory are not touched.  True when
    something was removed."""
    if not path:
        return False
    d, base = os.path.split(path)
    prefix = base + ".tmp."
    removed = False
    try:
        names = os.listdir(d or ".")
    except OSError:
        return False
    for name in names:
        if not (name.startswith(prefix) and name.endswith(".npz")):
            continue
        try:
            os.remove(os.path.join(d, name))
            removed = True
        except OSError:
            pass
    return removed


def frame_meta(d) -> Dict[str, object]:
    """Writer metadata of a loaded frame (the writer's ``run_id``,
    ``frame_seq``, ``level``; ``{}`` for a frame that carries none)."""
    if "__meta__" not in d:
        return {}
    try:
        return json.loads(d["__meta__"].tobytes().decode())
    except (ValueError, AttributeError):
        return {}


def load_frame(path: str, sig: str, what: str = "configuration"):
    """Open a frame, check its format and signature, return the npz.
    A file that is not a frame fails with one "unrecognized checkpoint
    format" error; a missing file raises FileNotFoundError as it is
    (nothing to resume is not a corrupt frame)."""
    try:
        d = np.load(path)
        frame_sig = d["sig"].tobytes().decode()
        version = int(d["__format__"]) if "__format__" in d else 1
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001
        raise ValueError(
            f"unrecognized checkpoint format at {path!r} — not written "
            f"by this engine ({type(e).__name__}: {e})"
        ) from e
    if version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint frame format v{version} is newer than this "
            f"build supports (v{FORMAT_VERSION}); upgrade to resume it"
        )
    if frame_sig != sig:
        raise ValueError(f"checkpoint was written by a different {what}")
    return d


# ------------------------------------------------ the table's codec


def pack_table(tcols, prefix: str = "fp") -> Dict[str, np.ndarray]:
    """The compacted occupancy of a visited table (K int32 column views
    of ``cap + 1`` slots, the last the trash slot): the occupied slots'
    indices (int64) and keys (uint32 a column), found on the table's
    device; only they are copied to the host."""
    cap = tcols[0].shape[0] - 1
    body = [c[:cap] for c in tcols]
    occ = body[0] != -1
    for c in body[1:]:
        occ = occ | (c != -1)
    slots = occ.nonzero().reshape(-1)
    keys = torch.stack([c.index_select(0, slots) for c in body], dim=1)
    keys = keys.to("cpu").numpy().view(np.uint32)
    out: Dict[str, np.ndarray] = {
        f"{prefix}_tcap": np.int64(cap),
        f"{prefix}_ndim": np.int64(1),
        f"{prefix}_cnt": np.asarray([len(keys)], np.int64),
        f"{prefix}_slot": slots.to("cpu").numpy().astype(np.int64),
    }
    for i in range(len(tcols)):
        out[f"{prefix}k{i}"] = np.ascontiguousarray(keys[:, i])
    return out


def restore_table(d, tcols, prefix: str = "fp") -> int:
    """Write a packed frame's keys into their own slots of an empty
    table of the same capacity (K int32 column views, e.g.
    ``fpset.empty_cols``), in place on the table's device.  Returns the
    number of keys."""
    cap = int(d[f"{prefix}_tcap"])
    if int(d[f"{prefix}_ndim"]) != 1 or tcols[0].shape[0] != cap + 1:
        raise ValueError("frame table does not fit this table")
    dev = tcols[0].device
    slots = torch.from_numpy(
        np.asarray(d[f"{prefix}_slot"], np.int64)).to(dev)
    for i, c in enumerate(tcols):
        keys = np.ascontiguousarray(d[f"{prefix}k{i}"], np.uint32)
        c.index_copy_(0, slots, torch.from_numpy(keys.view(np.int32))
                      .to(dev))
    return int(slots.shape[0])


# --------------------------------------------------------- preemption


class PreemptionWatcher:
    """SIGTERM/SIGINT -> "write a frame at the next level boundary".

    The first signal only sets :attr:`requested`: the engine finishes
    the level it is on, writes a resumable frame and returns a truncated
    result with ``stop_reason="preempted"``.  A second SIGINT raises
    KeyboardInterrupt at once.  A context manager; it installs its
    handlers only when ``enabled`` and on the main thread."""

    def __init__(self, enabled: bool = True, log=None):
        self.enabled = enabled
        self.requested = False
        self._log = log
        self._prev: Dict[int, object] = {}
        self._installed = False

    def _handle(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.requested = True
        msg = (f"{signal.Signals(signum).name} received: checkpointing at "
               "the next level boundary, then exiting resumably")
        if self._log is not None:
            self._log(msg)
        else:
            import sys

            print(f"  {msg}", file=sys.stderr, flush=True)

    def __enter__(self):
        if (self.enabled
                and threading.current_thread() is threading.main_thread()):
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handle)
                except (ValueError, OSError):
                    break
            else:
                self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            for sig, prev in self._prev.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass
            self._installed = False
        return False
