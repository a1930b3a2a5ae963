"""Host-side native code of the port, each source built by ``g++`` under
``build/torch_native/`` at first use (the output named by a hash of the
source and flags; no prebuilt binary ships in the package):

- ``logstore.cpp``, the host engines' disk-backed state log, a plain-C
  shared library loaded with ``ctypes`` (``engine/statelog.py``);
- ``compaction_bfs.cpp``, the native CPU baseline checker of the
  compaction spec (packed states, 64-bit fingerprints, level-synchronous
  BFS over worker threads), a standalone binary that ``run_baseline``
  runs: the yardstick of the card engine's states/s."""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "logstore.cpp"
BASELINE_SRC = HERE / "compaction_bfs.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
BASELINE_FLAGS = ("-O2", "-std=c++17", "-pthread")

_lib = None


def _build(src: Path, flags, name: str) -> Path:
    """Compile ``src`` with ``flags`` into ``BUILD_DIR/name`` (``{tag}``
    in it: a hash of the source and flags) unless that exists; a temp
    file and ``os.replace``, so a concurrent build never reads a torn
    output.  Raises when ``g++`` fails."""
    tag = hashlib.sha1(src.read_bytes()
                       + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / name.format(tag=tag)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *flags, str(src), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile ``logstore.cpp`` unless a library of this source and these
    flags exists; returns its path (raises when ``g++`` fails)."""
    return _build(SRC, FLAGS, "liblogstore_{tag}.so")


def build_baseline() -> Path:
    """Compile ``compaction_bfs.cpp`` (``g++ -O2 -std=c++17 -pthread``)
    unless a binary of this source and these flags exists; returns its
    path (raises when ``g++`` fails)."""
    return _build(BASELINE_SRC, BASELINE_FLAGS, "compaction_bfs_{tag}")


def run_baseline(
    m: int, k: int, v: int, c: int, crash: int, producer: bool,
    retain: bool, budget_s: float, threads: int = 1,
    table_log2: int | None = None, with_levels: bool = False,
) -> dict:
    """Run the native baseline checker; returns its JSON result dict
    (``distinct_states``, ``levels``, ``wall_s``, ``states_per_sec``,
    ``truncated``, ``violated``, ``threads``).

    ``table_log2`` sizes the fingerprint table (slots = 2^n; default 27
    with the producer, else 22); small configs should pass ~22 so a run
    does not zero-fill the 1 GB table.  ``with_levels`` adds
    ``level_records``: the per-level stderr records (``level``, ``new``,
    ``cum``, ``wall_s``, ``complete``; the initial level prints none).
    A run that hit an invariant violation is refused: it stopped early,
    so its states/s is no baseline."""
    binary = build_baseline()
    if table_log2 is None:
        table_log2 = 27 if producer else 22
    p = subprocess.run(
        [
            str(binary), str(m), str(k), str(v), str(c), str(crash),
            "1" if producer else "0", "1" if retain else "0",
            str(budget_s), str(threads), str(table_log2),
        ],
        capture_output=True, text=True,
    )
    if p.returncode not in (0, 1):
        raise RuntimeError(f"baseline checker failed: {p.stderr[:500]}")
    res = json.loads(p.stdout.strip().splitlines()[-1])
    if res.get("violated"):
        raise RuntimeError(
            "native baseline run hit an invariant violation; its "
            f"partial-run throughput is not a valid baseline: {res}"
        )
    if with_levels:
        res["level_records"] = level_records(p.stderr)
    return res


def level_records(stderr: str) -> list:
    """The baseline's per-level JSON lines out of its stderr."""
    return [json.loads(ln) for ln in stderr.splitlines()
            if ln.startswith('{"level"')]


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
