"""Time the PyTorch port's kernels against earlier versions of their CUDA
sources, in turns on one card.

    mkdir -p build/ab_old
    git show 202fee0:pulsar_tlaplus_tpu_torch/kernels/csrc/member.cu \\
        > build/ab_old/member.cu
    git show 202fee0:pulsar_tlaplus_tpu_torch/kernels/csrc/key_plane.cu \\
        > build/ab_old/key_plane.cu
    git show 1fd0109:pulsar_tlaplus_tpu_torch/kernels/csrc/insert_tail.cu \\
        > build/ab_old/insert_tail.cu
    python3 scripts/torch_kernel_ab.py build/ab_old

Each kernel whose earlier source is in the directory is timed against
the checkout's; the others are skipped.  All are built with the port's
nvcc flags.  The inputs are those of ``chip_smoke.py`` phases 2a, 2b and
2d: nc = 2^16 x 34 rows of W = 20 words with 64-bit fingerprints, and
nq = 2^16 x 34 lanes on a 2^26-slot table holding 16M keys.  Every
version's output must equal the plain PyTorch version's.

- K2 and K1: the earlier K1 reads K separate table columns,
  ``ptt_member_block(t0, t1, t2, q0, q1, q2, valid, member, resolved,
  nq, capm, k, rounds, stream)``, and is given a columnar copy of the
  slot-major table; the earlier K2 has the current signature.  Each is
  timed as CUDA events around 100 raw launches on preallocated outputs,
  in the order old, new, new, old.  Last, the plain
  ``fpset.probe_insert`` of nq fresh keys into a copy of the table in
  each layout, on the host clock between synchronizations, in the same
  order.
- H1, the insert tail: the earlier kernel takes no ``lists`` and writes
  two stats.  Beside it run the checkout's kernel (``new``) and the
  points of ``H1_SWEEP``, the same source built with other block widths
  (``-DPTT_H1_THREADS``) and tail widths (``-DPTT_H1_TAIL``).  Two
  inputs: the scaled flush (K1's survivors of the nq lanes, in chunks of
  nq / 4), each launch on a table restored before it (CUDA events around
  each of 10 launches), and the rehash of a 2^25-slot table at load 1/2
  into 2^26 slots (its 32 chunk launches of 2^20 slots timed together,
  on a fresh table each of 3 times).  Order: old, new, the sweep, the
  sweep reversed, new, old.  Each version's table, ``is_new`` and
  stats must equal the plain loop's after every timing.  Then, once
  for each version, the scaled flush cut at ``max_probes`` in
  ``ROUND_CUTS`` (a round's cost is the step between two cuts) and at
  npend = 0 and 1, each against the plain loop at the same cut.

Prints the card (``nvidia-smi`` name and power limit) and, as its last
line, one JSON object.
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
from pulsar_tlaplus_tpu_torch.ops.compact import compact_by_flag  # noqa: E402
from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec  # noqa: E402

P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
U32 = ctypes.c_uint32
OLD = {
    "member": ("ptt_member_block", (P,) * 9 + (I64, U32, INT, INT, P)),
    "key_plane": ("ptt_key_plane", (P, P, P, I64, INT, INT, INT, P)),
    "insert_tail": ("ptt_insert_tail",
                    (P,) * 11 + (I64, U32, INT, INT, I64, P)),
}
# (block width, tail width) points of the H1 sweep; the checkout's
# kernel (1024, 2048) runs as "new"
H1_SWEEP = ((256, 1024), (512, 2048), (1024, 1), (1024, 4096),
            (1024, 8192))
# max_probes cuts of the scaled flush for H1's round profile
ROUND_CUTS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 64)
ITERS = 100
SEED = 20261017


def build_lib(src: Path, tag: str, fn: str, argtypes, defines=()):
    """``fn`` of ``src`` built by nvcc (with ``-D`` ``defines``)."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kernels.BUILD_DIR / f"ab_{tag}.so"
    subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS,
         *(f"-D{d}" for d in defines), "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True,
    )
    f = getattr(ctypes.CDLL(str(lib)), fn)
    f.argtypes, f.restype = argtypes, INT
    return f


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


def time_each(setup, fn, iters) -> float:
    """Mean device ms of ``fn`` with ``setup`` before each call, outside
    the timed span (one untimed warm-up)."""
    setup()
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def checked(rc: int) -> None:
    if rc:
        raise RuntimeError(f"CUDA error {rc}")


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    src_dir = Path(sys.argv[1])
    old = {name: build_lib(src_dir / f"{name}.cu", f"old_{name}", fn, at)
           for name, (fn, at) in OLD.items()
           if (src_dir / f"{name}.cu").exists()}
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
    if "key_plane" in old:
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
        del packed, valid, want, outs, new_args, runs

    # ---- the scaled run's last table tier and a flush's lanes on it
    cap, k = 1 << 26, 2
    tcols = fpset.empty_cols(cap, k, dev)
    claims = fpset.new_claims(cap, dev)
    fill = tuple(rand_i32(16 << 20) for _ in range(k))
    for base in range(0, fill[0].shape[0], 1 << 22):
        kc = tuple(c[base: base + (1 << 22)] for c in fill)
        fpset.probe_insert(tcols, kc, ~fpset.all_sentinel(kc),
                           claims=claims)
    nq = (1 << 16) * 34
    pick = torch.randint(0, fill[0].shape[0], (nq,), device=dev,
                         generator=gen)
    fresh = torch.rand(nq, device=dev, generator=gen) < 0.4
    kcols = tuple(torch.where(fresh, rand_i32(nq), f[pick]) for f in fill)
    sent = torch.arange(nq, device=dev) % 97 == 3
    kcols = tuple(torch.where(sent, -1, c).contiguous() for c in kcols)
    lane = torch.arange(nq, device=dev)
    valid = (lane < nq - 12345) & ~fpset.all_sentinel(kcols)
    del fill, pick, fresh, sent

    # ---- K1
    if "member" in old:
        cols = tuple(c.contiguous() for c in tcols)  # the columnar copy
        want = torch.stack(tiles.member_block_plain(tcols, kcols, valid))
        flags = {v: torch.empty((2, nq), dtype=torch.bool, device=dev)
                 for v in ("old", "new")}
        new_args = tiles.member_block_args(
            tcols, kcols, valid, flags["new"][0], flags["new"][1],
            tiles.TILE_R)
        runs = {
            "old": lambda: checked(old["member"](
                ptr(cols[0]), ptr(cols[1]), None, ptr(kcols[0]),
                ptr(kcols[1]), None, ptr(valid), ptr(flags["old"][0]),
                ptr(flags["old"][1]), nq, cap - 1, k, tiles.TILE_R,
                stream)),
            "new": lambda: kernels.launch(*new_args),
        }
        res["member_block"] = {"old": [], "new": []}
        for v in ("old", "new", "new", "old"):
            res["member_block"][v].append(time_ms(runs[v]))
            if not torch.equal(flags[v], want):
                raise AssertionError(f"member_block {v} differs from plain")

        # the plain probe's insert of fresh keys into each layout
        ins = tuple(rand_i32(nq) for _ in range(k))
        ok = torch.ones(nq, dtype=torch.bool, device=dev)
        res["probe_insert_ms"] = {"old": [], "new": []}
        for v in ("old", "new", "new", "old"):
            t = (fpset.slot_major(tcols) if v == "new"
                 else tuple(c.clone() for c in cols))
            cl = fpset.new_claims(cap, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fpset.probe_insert(t, ins, ok, claims=cl)
            torch.cuda.synchronize()
            res["probe_insert_ms"][v].append(
                (time.perf_counter() - t0) * 1e3)
            del t, cl
        del cols, want, flags, new_args, runs, ins, ok

    # ---- H1
    if "insert_tail" in old:
        res["insert_tail"] = ab_insert_tail(
            old["insert_tail"], dev, rand_i32, tcols, kcols, valid, claims)

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


def ab_insert_tail(old_fn, dev, rand_i32, tcols, kcols, valid, claims):
    """H1's A/B (module docstring); returns the timings by version."""
    src = kernels.CSRC / kernels.SOURCES["insert_tail"]
    sweep = {
        f"t{th}_tail{tl}": build_lib(
            src, f"h1_t{th}_tail{tl}", "ptt_insert_tail",
            kernels._SIGNATURES["insert_tail"]["ptt_insert_tail"],
            (f"PTT_H1_THREADS={th}", f"PTT_H1_TAIL={tl}"))
        for th, tl in H1_SWEEP
    }
    order = ["old", "new", *sweep, *reversed(sweep), "new", "old"]
    ptr, stream = kernels.ptr, kernels.stream(dev)
    cap, k = tcols[0].shape[0] - 1, len(tcols)

    def launcher(v, work, claims, ckeys, cids, npd, cw, n_ids,
                 max_probes=fpset.MAX_PROBES):
        """(launch, is_new, its two stats, the buffers with all four) of
        version ``v`` on these inputs."""
        is_new = torch.zeros((n_ids + 1,), dtype=torch.bool, device=dev)
        stats = torch.zeros((4,), dtype=torch.int64, device=dev)
        cnt = torch.empty((2,), dtype=torch.int32, device=dev)
        if v == "old":
            state = torch.empty((cw,), dtype=torch.uint8, device=dev)
            n = ckeys[0].shape[0]
            args = (ptr(work[0]), ptr(ckeys[0]), ptr(ckeys[1]), None,
                    ptr(cids), ptr(npd), ptr(claims), ptr(is_new),
                    ptr(state), ptr(cnt), ptr(stats), cw,
                    work[0].shape[0] - 2, k, max_probes, min(cw, n), stream)
            fn = lambda: checked(old_fn(*args))  # noqa: E731
            return fn, is_new, stats[:2], (is_new, stats[:2], state, cnt)
        lists = torch.empty((2, k + 2, cw), dtype=torch.int32, device=dev)
        args = fpset.insert_tail_args(work, ckeys, cids, npd, cw, claims,
                                      is_new, lists, cnt, stats, max_probes)
        if v == "new":
            fn = lambda: kernels.launch(*args)  # noqa: E731
        else:
            f = sweep[v]
            fn = lambda: checked(f(*args[2:]))  # noqa: E731
        return fn, is_new, stats, (is_new, stats, lists, cnt)

    out = {}
    # -- the scaled flush: K1's survivors, chunks of nq / 4
    nq = kcols[0].shape[0]
    member, _res = tiles.member_block(tcols, kcols, valid)
    surv = valid & ~member
    lane = torch.arange(nq, dtype=torch.int32, device=dev)
    cc, _ = compact_by_flag(~surv, (*kcols, lane))
    ckeys, cids = cc[:k], cc[k]
    npend = int(surv.sum())
    npd = torch.full((), npend, dtype=torch.int64, device=dev)
    cw = max(nq // 4, min(nq, fpset.MIN_STAGE))
    snap = fpset.slot_major(tcols)
    want_t = fpset.slot_major(tcols)
    want_new, want_st = fpset.insert_tail_plain(
        want_t, ckeys, cids, npd, cw, fpset.new_claims(cap, dev), nq)
    work = fpset.slot_major(tcols)

    def restore():
        for a, b in zip(work, snap):  # views: writes reach the buffer
            a.copy_(b)

    flush = {"survivors": npend, "chunk": cw, "plain_stats":
             want_st.tolist(), "ms": {v: [] for v in dict.fromkeys(order)},
             "stats": {}}
    for v in order:
        fn, is_new, stats, keep = launcher(v, work, claims, ckeys, cids,
                                           npd, cw, nq)
        flush["ms"][v].append(time_each(
            lambda: (restore(), keep[0].zero_()), fn, 10))
        if not (torch.equal(stats[:2], want_st)
                and torch.equal(is_new[:nq], want_new[:nq])
                and all(torch.equal(a[:cap], b[:cap])
                        for a, b in zip(work, want_t))
                and torch.equal(claims, fpset.new_claims(cap, dev))):
            raise AssertionError(f"insert_tail {v}: flush differs from "
                                 f"plain (stats {stats.tolist()})")
        flush["stats"][v] = keep[1].tolist()
    out["scaled_flush"] = flush

    # -- where a launch's time goes: the same flush cut at max_probes
    # rounds a chunk (each round's cost is the step between two cuts),
    # and npend = 0 (the launch alone) and 1 (one lane in the tail)
    prof = {"max_probes": list(ROUND_CUTS), "ms": {}, "stats": {},
            "plain_stats": {}}
    for what, n_p, mp in ([(f"max_probes={m}", npend, m)
                           for m in ROUND_CUTS]
                          + [("npend=0", 0, 64), ("npend=1", 1, 64)]):
        want_t = fpset.slot_major(tcols)
        npx = torch.full((), n_p, dtype=torch.int64, device=dev)
        want_new, want_st = fpset.insert_tail_plain(
            want_t, ckeys, cids, npx, cw, fpset.new_claims(cap, dev), nq,
            mp)
        prof["plain_stats"][what] = want_st.tolist()
        for v in dict.fromkeys(order):
            fn, is_new, stats, keep = launcher(v, work, claims, ckeys, cids,
                                               npx, cw, nq, mp)
            prof["ms"].setdefault(v, {})[what] = time_each(
                lambda: (restore(), keep[0].zero_()), fn, 10)
            if not (torch.equal(stats[:2], want_st)
                    and torch.equal(is_new[:nq], want_new[:nq])
                    and all(torch.equal(a[:cap], b[:cap])
                            for a, b in zip(work, want_t))):
                raise AssertionError(f"insert_tail {v} at {what}: differs "
                                     f"from plain (stats {stats.tolist()})")
            prof["stats"].setdefault(v, {})[what] = keep[1].tolist()
    out["round_profile"] = prof
    del snap, want_t, work, want_new

    # -- the 2^25 -> 2^26 rehash: 32 chunk launches of 2^20 slots
    ocap, chunk = 1 << 25, 1 << 20
    old_t = fpset.empty_cols(ocap, k, dev)
    ocl = fpset.new_claims(ocap, dev)
    fill = tuple(rand_i32(ocap // 2) for _ in range(k))
    for base in range(0, ocap // 2, 1 << 22):
        kc = tuple(c[base: base + (1 << 22)] for c in fill)
        fpset.probe_insert(old_t, kc, ~fpset.all_sentinel(kc), claims=ocl)
    del fill, ocl
    chunks = []
    for b0 in range(0, ocap, chunk):
        ks = tuple(c[b0: b0 + chunk] for c in old_t)
        occ = ~fpset.all_sentinel(ks)
        cc, _ = compact_by_flag(~occ, (*ks, torch.arange(
            chunk, dtype=torch.int32, device=dev)))
        chunks.append((cc[:k], cc[k], occ.sum()))
    del old_t
    ncap = 1 << 26
    rcl = fpset.new_claims(ncap, dev)
    want_t = fpset.empty_cols(ncap, k, dev)
    for ck, ci, npc in chunks:
        fpset.insert_tail_plain(want_t, ck, ci, npc, chunk, rcl, chunk)
    work = fpset.empty_cols(ncap, k, dev)
    rehash = {"chunks": len(chunks), "ms": {v: [] for v in
                                            dict.fromkeys(order)}}
    for v in order:
        runs = [launcher(v, work, rcl, ck, ci, npc, chunk, chunk)
                for ck, ci, npc in chunks]

        def all_chunks():
            for fn, *_ in runs:
                fn()

        def fresh_table():
            for c in work:
                c.fill_(-1)

        rehash["ms"][v].append(time_each(fresh_table, all_chunks, 3))
        if not (all(torch.equal(a[:-1], b[:-1])
                    for a, b in zip(work, want_t))
                and all(int(s[1]) == 0 for _f, _n, s, _k in runs)
                and torch.equal(rcl, fpset.new_claims(ncap, dev))):
            raise AssertionError(f"insert_tail {v}: rehash differs from "
                                 "the plain loop's")
        del runs
    out["rehash_2p25_to_2p26"] = rehash
    return out


if __name__ == "__main__":
    sys.exit(main())
