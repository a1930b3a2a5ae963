"""Time the PyTorch port's membership probe (K1) and key plane (K2)
against an earlier version of their CUDA sources, in turns on one card.

    mkdir -p build/ab_old
    git show 202fee0:pulsar_tlaplus_tpu_torch/kernels/csrc/member.cu \\
        > build/ab_old/member.cu
    git show 202fee0:pulsar_tlaplus_tpu_torch/kernels/csrc/key_plane.cu \\
        > build/ab_old/key_plane.cu
    python3 scripts/torch_kernel_ab.py build/ab_old

The earlier K1 reads K separate table columns, ``ptt_member_block(t0,
t1, t2, q0, q1, q2, valid, member, resolved, nq, capm, k, rounds,
stream)``, and is given a columnar copy of the slot-major table; the
earlier K2 has the current signature.  Both are built with the port's
nvcc flags.  The inputs are those of ``chip_smoke.py`` phases 2a and 2b:
nc = 2^16 x 34 rows of W = 20 words with 64-bit fingerprints, and nq =
2^16 x 34 lanes on a 2^26-slot table holding 16M keys.  Every version's
output must equal the plain PyTorch version's.  Each kernel is timed
as CUDA events around 100 raw launches on preallocated outputs, in the
order old, new, new, old.  Last, the plain ``fpset.probe_insert`` of
nq fresh keys into a copy of the table in each layout, timed on the
host clock between synchronizations (its rounds sync with the host),
in the same order.  Prints the card (``nvidia-smi`` name and
power limit) and, as its last line, one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pulsar_tlaplus_tpu_torch.kernels import build as kernels  # noqa: E402
from pulsar_tlaplus_tpu_torch.ops import fpset, tiles  # noqa: E402
from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec  # noqa: E402

P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
OLD = {
    "member": ("ptt_member_block",
               (P,) * 9 + (I64, ctypes.c_uint32, INT, INT, P)),
    "key_plane": ("ptt_key_plane", (P, P, P, I64, INT, INT, INT, P)),
}
ITERS = 100
SEED = 20261017


def build_old(src_dir: Path) -> dict:
    """name -> the earlier kernel's C function, built by nvcc."""
    out = {}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, (fn, argtypes) in OLD.items():
        lib = kernels.BUILD_DIR / f"ab_old_{name}.so"
        subprocess.run(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib),
             str(src_dir / f"{name}.cu")],
            check=True, capture_output=True, text=True,
        )
        f = getattr(ctypes.CDLL(str(lib)), fn)
        f.argtypes, f.restype = argtypes, INT
        out[name] = f
    return out


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(ITERS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / ITERS


def checked(rc: int) -> None:
    if rc:
        raise RuntimeError(f"CUDA error {rc}")


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    old = build_old(Path(sys.argv[1]))
    kernels.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ptr, stream = kernels.ptr, kernels.stream(dev)

    def rand_i32(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    res = {}
    # ---- K2 at the scaled window
    ks, nc = KeySpec(618, 20, 64), (1 << 16) * 34
    packed = rand_i32(nc, ks.W)
    valid = torch.rand(nc, device=dev, generator=gen) < 0.8
    want = torch.stack(tiles.key_plane_plain(ks, packed, valid))
    outs = {v: torch.empty((2, nc), dtype=torch.int32, device=dev)
            for v in ("old", "new")}
    new_args = tiles.key_plane_args(ks, packed, valid, outs["new"])
    runs = {
        "old": lambda: checked(old["key_plane"](
            ptr(packed), ptr(valid), ptr(outs["old"]), nc, ks.W, 2, 0,
            stream)),
        "new": lambda: kernels.launch(*new_args),
    }
    res["key_plane"] = {"old": [], "new": []}
    for v in ("old", "new", "new", "old"):
        res["key_plane"][v].append(time_ms(runs[v]))
        if not torch.equal(outs[v], want):
            raise AssertionError(f"key_plane {v} differs from plain")

    # ---- K1 at the scaled run's last table tier
    cap, k = 1 << 26, 2
    tcols = fpset.empty_cols(cap, k, dev)
    claims = fpset.new_claims(cap, dev)
    fill = tuple(rand_i32(16 << 20) for _ in range(k))
    for base in range(0, fill[0].shape[0], 1 << 22):
        kc = tuple(c[base: base + (1 << 22)] for c in fill)
        fpset.probe_insert(tcols, kc, ~fpset.all_sentinel(kc),
                           claims=claims)
    del claims
    cols = tuple(c.contiguous() for c in tcols)  # the columnar copy
    nq = (1 << 16) * 34
    pick = torch.randint(0, fill[0].shape[0], (nq,), device=dev,
                         generator=gen)
    fresh = torch.rand(nq, device=dev, generator=gen) < 0.4
    kcols = tuple(torch.where(fresh, rand_i32(nq), f[pick]) for f in fill)
    sent = torch.arange(nq, device=dev) % 97 == 3
    kcols = tuple(torch.where(sent, -1, c).contiguous() for c in kcols)
    lane = torch.arange(nq, device=dev)
    valid = (lane < nq - 12345) & ~fpset.all_sentinel(kcols)
    want = torch.stack(tiles.member_block_plain(tcols, kcols, valid))
    flags = {v: torch.empty((2, nq), dtype=torch.bool, device=dev)
             for v in ("old", "new")}
    new_args = tiles.member_block_args(tcols, kcols, valid, flags["new"][0],
                                       flags["new"][1], tiles.TILE_R)
    runs = {
        "old": lambda: checked(old["member"](
            ptr(cols[0]), ptr(cols[1]), None, ptr(kcols[0]), ptr(kcols[1]),
            None, ptr(valid), ptr(flags["old"][0]), ptr(flags["old"][1]),
            nq, cap - 1, k, tiles.TILE_R, stream)),
        "new": lambda: kernels.launch(*new_args),
    }
    res["member_block"] = {"old": [], "new": []}
    for v in ("old", "new", "new", "old"):
        res["member_block"][v].append(time_ms(runs[v]))
        if not torch.equal(flags[v], want):
            raise AssertionError(f"member_block {v} differs from plain")

    # ---- the plain probe's insert of fresh keys into each layout
    ins = tuple(rand_i32(nq) for _ in range(k))
    ok = torch.ones(nq, dtype=torch.bool, device=dev)
    res["probe_insert_ms"] = {"old": [], "new": []}
    for v in ("old", "new", "new", "old"):
        t = (fpset.slot_major(tcols) if v == "new"
             else tuple(c.clone() for c in cols))
        claims = fpset.new_claims(cap, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fpset.probe_insert(t, ins, ok, claims=claims)
        torch.cuda.synchronize()
        res["probe_insert_ms"][v].append((time.perf_counter() - t0) * 1e3)
        del t, claims

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    # kernels: device ms a launch; probe_insert_ms: host ms a call
    out = {"card": smi, "iters": ITERS, "order": "old,new,new,old",
           "timings": res}
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
