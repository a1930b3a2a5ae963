"""Builds and loads the port's CUDA kernels — the counterpart of
``pulsar_tlaplus_tpu/ops/tiles.py``'s ``pallas_available`` /
``pallas_lowers_natively``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (one ``nvcc`` per source, all
started together) and loaded with ``ctypes``.  The libraries go to
``build/torch_kernels/`` at the repository root, named by a digest of the
source and flags, so a changed source is rebuilt and an unchanged one is
reused.  Nothing is built or loaded at import time: the first
:func:`load` builds, then launches the self-test kernel (K0) and raises
unless it computed ``x + 1``.

Every C function returns ``cudaGetLastError()``; :func:`launch` raises
on a nonzero code and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = {
    "selftest": "selftest.cu",
    "key_plane": "key_plane.cu",
    "member_block": "member.cu",
    "sieve_mask": "sieve_mask.cu",
    "insert_tail": "insert_tail.cu",
}

P = ctypes.c_void_p
I64 = ctypes.c_int64
_SIGNATURES = {
    "selftest": {
        "ptt_selftest": (P, P, ctypes.c_int, P),
        "ptt_empty": (P,),
        "ptt_error_string": (ctypes.c_int,),
    },
    "key_plane": {
        "ptt_key_plane": (
            P, P, P, I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, P,
        ),
    },
    "member_block": {
        "ptt_member_block": (
            P, P, P, P, P, P, P, I64, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int, P,
        ),
    },
    "sieve_mask": {
        "ptt_sieve_mask": (P, P, P, P, I64, ctypes.c_int, P),
    },
    "insert_tail": {
        "ptt_insert_tail": (
            P, P, P, P, P, P, P, P, P, P, P, I64, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int, I64, P,
        ),
    },
}

# launches per kernel since the last reset (chip_smoke.py resets them
# around the main path to show that it ran through the kernels)
LAUNCHES = {name: 0 for name in SOURCES}
# several threads launch at once (the daemons' slots, two backends in one
# process): every update of LAUNCHES holds this lock
_launch_lock = threading.Lock()

_libs: dict = {}


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, else ``PATH``, else ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME")
    for c in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def build() -> dict:
    """Compile every source whose library is missing, in parallel.
    Returns name -> library path; raises with nvcc's output on a
    failed build.  ptxas's register/spill report of the last build of
    each kernel is kept beside it as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode:
            failed.append(f"{name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load() -> dict:
    """name -> loaded ``ctypes.CDLL`` (built on first use), after the
    self-test kernel passed on the current device."""
    if not _libs:
        libs = {}
        for name, path in build().items():
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            libs[name] = lib
        libs["selftest"].ptt_error_string.restype = ctypes.c_char_p
        _libs.update(libs)
        try:
            selftest(torch.device("cuda", torch.cuda.current_device()))
        except BaseException:
            _libs.clear()
            raise
    return _libs


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(name: str, fn: str, *args) -> None:
    """Call kernel wrapper ``fn`` of library ``name``; raise on a CUDA
    error (a refused launch never runs, and a later synchronize would
    not report it) and count the launch."""
    rc = getattr(load()[name], fn)(*args)
    if rc:
        msg = _libs["selftest"].ptt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    with _launch_lock:
        LAUNCHES[name] += 1


def selftest(device: torch.device) -> None:
    """Launch K0 (``o = x + 1`` over int32[8]) on ``device`` and check
    it — run once after building and at the start of each checker run
    on a card."""
    x = torch.arange(8, dtype=torch.int32, device=device)
    o = torch.empty_like(x)
    with torch.cuda.device(device):
        launch("selftest", "ptt_selftest", ptr(x), ptr(o), 8, stream(device))
    if not torch.equal(o.cpu(), torch.arange(1, 9, dtype=torch.int32)):
        raise RuntimeError(
            f"kernel self-test failed on {torch.cuda.get_device_name(device)}"
            f": got {o.tolist()}, want x + 1"
        )


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
