"""Host-side native code of the port: ``logstore.cpp``, the host
engines' disk-backed state log, built by ``g++`` into a plain-C shared
library under ``build/torch_native/`` at first use and loaded with
``ctypes`` (``engine/statelog.py``)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "logstore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None


def build() -> Path:
    """Compile ``logstore.cpp`` unless a library of this source and these
    flags exists; returns its path (raises when ``g++`` fails)."""
    src = SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"liblogstore_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


def load_logstore():
    """The loaded library with its signatures set (built on first
    use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64, p = ctypes.c_int64, ctypes.c_char_p
        lib.ptt_ls_open.argtypes = (p, i64, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(i64))
        lib.ptt_ls_append.argtypes = (ctypes.c_int, i64, i64, p, p, p, i64)
        lib.ptt_ls_get.argtypes = (ctypes.c_int, i64, i64, ctypes.c_void_p)
        lib.ptt_ls_sync.argtypes = (ctypes.c_int,)
        lib.ptt_ls_close.argtypes = (ctypes.c_int,)
        for f in (lib.ptt_ls_open, lib.ptt_ls_append, lib.ptt_ls_get,
                  lib.ptt_ls_sync, lib.ptt_ls_close):
            f.restype = ctypes.c_int
        _lib = lib
    return _lib
