"""State/trace logs of the host engines — the counterpart of
``pulsar_tlaplus_tpu/engine/statelog.py`` (``MemoryLog``, ``FileLog``,
``_PyFileStore``).

The engine appends every new state's ``(packed row, parent gid, action
id)`` record in gid order and reads single records back to rebuild a
counterexample and to checkpoint.

- :class:`MemoryLog` keeps numpy chunks in host RAM (the default).
- :class:`FileLog` keeps them in a file, for logs larger than RAM: the
  native store (``native/logstore.cpp``, a plain-C library loaded with
  ``ctypes``), or, when it cannot be built, :class:`_PyFileStore` with
  the same record format (one WARNING on stderr).  The record is
  ``packed u32 x W | parent i64 | action i32``, little-endian: a file
  written here is byte-equal to the JAX package's from the same
  appends.
"""

from __future__ import annotations

import bisect
import ctypes
import os
import struct
import subprocess
import sys
from typing import List, Tuple

import numpy as np


class MemoryLog:
    def __init__(self, row_words: int):
        self.row_words = row_words
        self._starts: List[int] = []
        self._packed: List[np.ndarray] = []
        self._parent: List[np.ndarray] = []
        self._action: List[np.ndarray] = []
        self._n = 0

    def append(self, packed: np.ndarray, parent: np.ndarray,
               action: np.ndarray) -> int:
        first = self._n
        self._starts.append(first)
        self._packed.append(np.asarray(packed, np.uint32))
        self._parent.append(np.asarray(parent).astype(np.int64))
        self._action.append(np.asarray(action).astype(np.int32))
        self._n += len(packed)
        return first

    def __len__(self) -> int:
        return self._n

    def get(self, gid: int) -> Tuple[np.ndarray, int, int]:
        i = bisect.bisect_right(self._starts, gid) - 1
        off = gid - self._starts[i]
        return (self._packed[i][off], int(self._parent[i][off]),
                int(self._action[i][off]))

    def packed_matrix(self) -> np.ndarray:
        """All packed rows in gid order."""
        if not self._packed:
            return np.zeros((0, self.row_words), np.uint32)
        return np.concatenate(self._packed)

    def parents(self) -> np.ndarray:
        return (np.concatenate(self._parent) if self._parent
                else np.zeros((0,), np.int64))

    def actions(self) -> np.ndarray:
        return (np.concatenate(self._action) if self._action
                else np.zeros((0,), np.int32))


_warned_fallback = False


class FileLog:
    """Disk-backed log: the native store when it builds, else pure
    Python.  ``fresh=True`` truncates an existing file at ``path`` (a
    fresh run must not append after stale records)."""

    def __init__(self, path: str, row_words: int, fresh: bool = False):
        global _warned_fallback
        self.row_words = row_words
        self.path = path
        if fresh and os.path.exists(path):
            os.truncate(path, 0)
        try:
            self._store = _NativeStore(path, row_words)
            self.native = True
        except (OSError, subprocess.CalledProcessError) as e:
            if not _warned_fallback:
                _warned_fallback = True
                print(f"WARNING: native log store unavailable ({e!r:.120});"
                      " using the pure-Python file store", file=sys.stderr)
            self._store = _PyFileStore(path, row_words)
            self.native = False

    def close(self):
        if self._store is not None:
            self._store.close()
        self._store = None

    def append(self, packed: np.ndarray, parent: np.ndarray,
               action: np.ndarray) -> int:
        packed = np.ascontiguousarray(packed, np.uint32)
        parent = np.ascontiguousarray(parent, np.int64)
        action = np.ascontiguousarray(action, np.int32)
        return self._store.append(packed.tobytes(), parent.tobytes(),
                                  action.tobytes(), len(packed))

    def __len__(self) -> int:
        return len(self._store)

    def get(self, gid: int) -> Tuple[np.ndarray, int, int]:
        row_bytes, parent, action = self._store.get(gid)
        return (np.frombuffer(row_bytes, np.uint32).copy(), int(parent),
                int(action))

    def packed_matrix(self) -> np.ndarray:
        out = np.zeros((len(self), self.row_words), np.uint32)
        for g in range(len(self)):
            out[g] = self.get(g)[0]
        return out

    def sync(self):
        self._store.sync()

    def truncate(self, n: int):
        """Drop the records past ``n`` (a resume discards those appended
        after the last frame)."""
        if n > len(self):
            raise ValueError("cannot truncate forward")
        if n == len(self):
            return
        rec = self.row_words * 4 + 12
        self.sync()
        self.close()
        os.truncate(self.path, n * rec)
        self.__init__(self.path, self.row_words)


class _NativeStore:
    """The native store (``native/logstore.cpp``) behind ``ctypes``."""

    def __init__(self, path: str, row_words: int):
        from pulsar_tlaplus_tpu_torch.native import load_logstore

        if not 0 < row_words <= 1 << 16:
            raise ValueError("row_words out of range")
        self._lib = load_logstore()
        self.row_words = row_words
        self.rec = row_words * 4 + 12
        fd, n = ctypes.c_int(-1), ctypes.c_int64(0)
        rc = self._lib.ptt_ls_open(path.encode(), self.rec,
                                   ctypes.byref(fd), ctypes.byref(n))
        if rc == -22:  # EINVAL: a partial record
            raise ValueError(
                "existing file size is not a whole number of records")
        self._check(rc, path)
        self._fd, self._n = fd.value, n.value
        self._buf = ctypes.create_string_buffer(self.rec)

    @staticmethod
    def _check(rc: int, what: str = "") -> None:
        if rc:
            raise OSError(-rc, os.strerror(-rc), what)

    def close(self):
        if self._fd >= 0:
            self._lib.ptt_ls_close(self._fd)
            self._fd = -1

    def append(self, packed: bytes, parents: bytes, actions: bytes,
               n: int) -> int:
        if (len(packed) != n * self.row_words * 4 or len(parents) != n * 8
                or len(actions) != n * 4):
            raise ValueError("buffer sizes do not match n")
        first = self._n
        self._check(self._lib.ptt_ls_append(
            self._fd, first, self.row_words, packed, parents, actions, n))
        self._n += n
        return first

    def __len__(self) -> int:
        return self._n

    def get(self, gid: int):
        if not 0 <= gid < self._n:
            raise IndexError("gid out of range")
        self._check(self._lib.ptt_ls_get(self._fd, gid, self.rec,
                                         self._buf))
        raw = self._buf.raw
        rw4 = self.row_words * 4
        parent, action = struct.unpack_from("<qi", raw, rw4)
        return raw[:rw4], parent, action

    def sync(self):
        self._check(self._lib.ptt_ls_sync(self._fd))


class _PyFileStore:
    """Pure-Python store with the native store's record format."""

    def __init__(self, path: str, row_words: int):
        self.rec = row_words * 4 + 12
        self.row_words = row_words
        self._f = open(path, "a+b")
        self._f.seek(0, 2)
        if self._f.tell() % self.rec:
            raise ValueError(
                "existing file size is not a whole number of records")
        self._n = self._f.tell() // self.rec

    def close(self):
        self._f.close()

    def append(self, packed: bytes, parents: bytes, actions: bytes,
               n: int) -> int:
        rw4 = self.row_words * 4
        first = self._n
        chunks = []
        for i in range(n):
            chunks.append(packed[i * rw4: (i + 1) * rw4])
            chunks.append(parents[i * 8: (i + 1) * 8])
            chunks.append(actions[i * 4: (i + 1) * 4])
        self._f.seek(0, 2)
        self._f.write(b"".join(chunks))
        self._n += n
        return first

    def __len__(self) -> int:
        return self._n

    def get(self, gid: int):
        self._f.flush()
        self._f.seek(gid * self.rec)
        buf = self._f.read(self.rec)
        rw4 = self.row_words * 4
        parent, action = struct.unpack_from("<qi", buf, rw4)
        return buf[:rw4], parent, action

    def sync(self):
        self._f.flush()
