"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version on the card (exact equality: integer work),
times both, then drives the port's main path — ``cli check`` of the
shipped compaction cfg, the checker on the 253,361-state config, both
published counterexamples, and the scaled bench config to its 17,787,334
-state level — with the kernels' launch counters zeroed before and read
after.  Each phase prints one line with its seconds.  The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``; any
failed phase exits non-zero without them.  Exits non-zero at once when
no CUDA device is available or the port cannot be imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet) for each kernel's bound: memory
# rate, and the 32-bit non-tensor rate (67 T/s in float32; the kernels'
# integer ALU work is counted against it)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
SCALED_PREV_TOTAL = 636_718  # cumulative states after level 5
SCALED_TOTAL = 17_787_334  # cumulative states after level 6
SEED = 20261017
SPECS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "specs")


def _phase(name, fn, failures):
    t = time.time()
    try:
        detail = fn()
        status = "ok"
    except Exception as e:  # noqa: BLE001 — recorded, fails the run below
        detail, status = f"{type(e).__name__}: {e}", "FAILED"
        failures.append(f"{name}: {detail}")
    print(f"[{name}] {status} {time.time() - t:.2f}s {detail}", flush=True)


def _bound(nbytes, ops):
    """(least milliseconds for the work, what bounds it): the bytes
    over the memory rate or the operations over the ALU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _time_ms(torch, fn, iters):
    """Mean milliseconds of ``fn`` on the card (CUDA events, one warm-up
    call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from pulsar_tlaplus_tpu_torch import cli
        from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
        from pulsar_tlaplus_tpu_torch.kernels import build as kernels
        from pulsar_tlaplus_tpu_torch.models.compaction import (
            CompactionModel,
        )
        from pulsar_tlaplus_tpu_torch.ops import fpset, tiles
        from pulsar_tlaplus_tpu_torch.ops.dedup import KeySpec
        from pulsar_tlaplus_tpu_torch.ref import pyeval
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    failures: list = []
    record: dict = {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)

    def rand_i32(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    # ---- 1: build + K0 self-test
    def build():
        t = time.time()
        kernels.build()
        built = time.time() - t
        kernels.load()  # loads, then launches K0 and checks x + 1
        x = torch.arange(8, dtype=torch.int32, device=dev)
        o = torch.empty_like(x)

        def k0():
            kernels.launch("selftest", "ptt_selftest", kernels.ptr(x),
                           kernels.ptr(o), 8, kernels.stream(dev))

        ms = _time_ms(torch, k0, 200)
        err = int((o - (x + 1)).abs().max())
        if err:
            raise AssertionError(f"K0 computed {o.tolist()}")
        record["selftest"] = dict(
            ms=ms, plain_ms=_time_ms(torch, lambda: x + 1, 200),
            max_abs_err=err, bound=_bound(64, 8),
        )
        regs = {
            n: re.findall(r"Used \d+ registers[^\n]*",
                          (kernels.BUILD_DIR / f"{n}.log").read_text())
            for n in kernels.SOURCES
            if (kernels.BUILD_DIR / f"{n}.log").exists()
        }
        return f"nvcc {built:.1f}s; K0 x+1 ok; ptxas {regs}"

    _phase("1 build+selftest", build, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # ---- 2: kernels against their plain versions on the card
    def k2():
        notes = []
        # the main path's shapes: the shipped cfg's widest window (3645
        # rows x A=7, exact W=2) and a scaled-config window (2^16 rows
        # x A=34, W=20, 64-bit fingerprints); ragged sizes and 96-bit
        # fingerprints for coverage
        cases = [
            (KeySpec(42, 2), 3645 * 7),
            (KeySpec(618, 20, 64), (1 << 16) * 34),
            (KeySpec(618, 20, 96), 1_000_003),
            (KeySpec(70, 3), 99_991),
        ]
        worst = 0
        for ks, nc in cases:
            packed = rand_i32(nc, ks.W)
            valid = torch.rand(nc, device=dev, generator=gen) < 0.8
            got = tiles.key_plane(ks, packed, valid)
            want = tiles.key_plane_plain(ks, packed, valid)
            err = max(
                int((g.long() - w.long()).abs().max()) for g, w in
                zip(got, want)
            )
            if err:
                raise AssertionError(f"K2 W={ks.W} K={ks.ncols}: err {err}")
            worst = max(worst, err)
            notes.append(f"W={ks.W},K={ks.ncols},nc={nc}")
            if ks is cases[1][0]:
                timed = packed, valid
        # timed at the scaled window (the path's widest key plane), on
        # the inputs compared above
        ks, nc = cases[1]
        packed, valid = timed
        nbytes = nc * (ks.W * 4 + 1 + ks.ncols * 4)
        # murmur3: ~5 ops a word plus ~6 a word and column, fmix ~13 a
        # column
        ops = nc * (ks.W * (5 + 6 * ks.ncols) + 13 * ks.ncols)
        record["key_plane"] = dict(
            ms=_time_ms(torch, lambda: tiles.key_plane(ks, packed, valid),
                        50),
            plain_ms=_time_ms(
                torch, lambda: tiles.key_plane_plain(ks, packed, valid), 5
            ),
            max_abs_err=worst, bytes=nbytes, bound=_bound(nbytes, ops),
        )
        return "equal: " + "; ".join(notes) + (
            f"; timed W=20 K=2 nc={nc}: {record['key_plane']}"
        )

    _phase("2a K2 key_plane vs plain", k2, failures)

    def k1():
        # a visited table at the scaled run's last tier (2^26 slots)
        # holding 16M keys, filled by the plain insert
        cap, k = 1 << 26, 2
        tcols = fpset.empty_cols(cap, k, dev)
        claims = fpset.new_claims(cap, dev)
        fill = tuple(rand_i32(16 << 20) for _ in range(k))
        for base in range(0, fill[0].shape[0], 1 << 22):
            ks = tuple(c[base: base + (1 << 22)] for c in fill)
            _n, tcols, pending, _r = fpset.probe_insert(
                tcols, ks, ~fpset.all_sentinel(ks), claims=claims
            )
            if pending.any():
                raise AssertionError("plain insert left lanes pending")
        # an accumulator at the path's width: dup-heavy (60% present),
        # SENTINEL lanes, and a partial n_acc
        nq = (1 << 16) * 34
        pick = torch.randint(0, fill[0].shape[0], (nq,), device=dev,
                             generator=gen)
        fresh = torch.rand(nq, device=dev, generator=gen) < 0.4
        kcols = tuple(
            torch.where(fresh, rand_i32(nq), f[pick]) for f in fill
        )
        sent = torch.arange(nq, device=dev) % 97 == 3
        kcols = tuple(torch.where(sent, -1, c).contiguous() for c in kcols)
        lane = torch.arange(nq, device=dev)
        valid = (lane < nq - 12345) & ~fpset.all_sentinel(kcols)
        got = tiles.member_block(tcols, kcols, valid)
        want = tiles.member_block_plain(tcols, kcols, valid)
        err = 0
        for g, w, what in zip(got, want, ("member", "resolved")):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"K1 {what}: {int((g != w).sum())} lanes differ"
                )
            err = max(err, int((g.int() - w.int()).abs().max()))
        # the bytes this data needs: keys, valid, both flags, and K
        # table words per probed slot (a lane stops at its key or at
        # the first empty slot)
        h = fpset.slot_hash(kcols)
        probes = torch.zeros(nq, dtype=torch.int64, device=dev)
        live = valid.clone()
        for r in range(tiles.TILE_R):
            s = (h + (r * (r + 1) >> 1)) & (cap - 1)
            sv = tuple(c[s] for c in tcols)
            probes += live.long()
            stop = fpset.all_sentinel(sv) | (
                (sv[0] == kcols[0]) & (sv[1] == kcols[1])
            )
            live = live & ~stop
        n_probes = int(probes.sum())
        nbytes = nq * (k * 4 + 1 + 2) + n_probes * k * 4
        # slot hash ~10 ops a column, ~2 + 5K a probe
        ops = nq * 10 * k + n_probes * (2 + 5 * k)
        record["member_block"] = dict(
            ms=_time_ms(
                torch, lambda: tiles.member_block(tcols, kcols, valid), 50
            ),
            plain_ms=_time_ms(
                torch,
                lambda: tiles.member_block_plain(tcols, kcols, valid), 5,
            ),
            max_abs_err=err, bytes=nbytes, bound=_bound(nbytes, ops),
        )
        return (
            f"equal at cap=2^26 (16M keys), nq={nq}: "
            f"{int(got[0].sum())} members, {int((~got[1]).sum())} "
            f"unresolved, {n_probes / max(int(valid.sum()), 1):.3f} "
            f"probes/valid lane; {record['member_block']}"
        )

    _phase("2b K1 member_block vs plain", k1, failures)
    torch.cuda.empty_cache()

    # ---- 3-6: the main path, launch counters zeroed around it
    kernels.reset_launches()
    per_phase = {}

    def counted(name, fn):
        before = dict(kernels.LAUNCHES)

        def run():
            out = fn()
            per_phase[name] = {
                k: v - before[k] for k, v in kernels.LAUNCHES.items()
            }
            return f"{out}; launches {per_phase[name]}"

        _phase(name, run, failures)

    def shipped():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["check", os.path.join(SPECS, "compaction.tla"),
                           "-config", os.path.join(SPECS, "compaction.cfg")])
        out = buf.getvalue()
        m = re.search(r"(\d+) distinct states found, search depth "
                      r"\(diameter\) (\d+)", out)
        got = (rc, m and (int(m.group(1)), int(m.group(2))))
        if got != (0, (45198, 20)) or "Error" in out:
            raise AssertionError(f"cli check: rc/counts {got}\n{out}")
        return f"cli check: 45198 states, diameter 20, rc 0 ({out.splitlines()[-1]})"

    counted("3 shipped cfg (cli)", shipped)

    def full():
        c = dataclasses.replace(
            pyeval.SHIPPED_CFG, model_producer=True, retain_null_key=False
        )
        r = DeviceChecker(CompactionModel(c), invariants=()).run()
        got = (r.distinct_states, r.diameter, r.violation, r.deadlock)
        if got != (253361, 23, None, False):
            raise AssertionError(f"got {got}")
        return f"253361 states, diameter 23 ({r.states_per_sec:.0f} st/s)"

    counted("4 producer on, RetainNullKey=FALSE", full)

    def bugs():
        notes = []
        for inv, depth in (("CompactedLedgerLeak", 12),
                           ("DuplicateNullKeyMessage", 4)):
            c = pyeval.SHIPPED_CFG
            r = DeviceChecker(CompactionModel(c), invariants=(inv,)).run()
            if (r.violation, r.diameter, len(r.trace or ())) != (
                inv, depth, depth
            ):
                raise AssertionError(
                    f"{inv}: {r.violation} depth {r.diameter}"
                )
            ok = pyeval.INVARIANTS[inv]
            if r.trace[0] not in set(pyeval.initial_states(c)):
                raise AssertionError(f"{inv}: trace starts off Init")
            for s, act, t in zip(r.trace, r.trace_actions, r.trace[1:]):
                if not any(
                    pyeval.ACTION_NAMES[a] == act and u == t
                    for a, u in pyeval.successors(c, s)
                ):
                    raise AssertionError(f"{inv}: {act} does not replay")
                if not ok(c, s):
                    raise AssertionError(f"{inv}: violated before the end")
            if ok(c, r.trace[-1]):
                raise AssertionError(f"{inv}: last state does not violate")
            notes.append(f"{inv} length {depth} replays (gid "
                         f"{r.violation_gid})")
        return "; ".join(notes)

    counted("5 counterexamples", bugs)

    def scaled_cfg():
        # bench.py's scaled config: |Msgs|=64, |Keys|=8, |Values|=2, 3
        # compactions, 3 crashes, producer on (618-bit states)
        return pyeval.Constants(
            message_sent_limit=64, compaction_times_limit=3, num_keys=8,
            num_values=2, retain_null_key=True, max_crash_times=3,
            model_producer=True, model_consumer=False,
        )

    def scaled():
        torch.cuda.reset_peak_memory_stats(dev)
        ck = DeviceChecker(CompactionModel(scaled_cfg()),
                           max_states=SCALED_TOTAL + 1)
        r = ck.run()
        cum, tot = [], 0
        for n in r.level_sizes:
            tot += n
            cum.append(tot)
        if cum[4:6] != [SCALED_PREV_TOTAL, SCALED_TOTAL] or r.violation:
            raise AssertionError(
                f"level totals {cum} (want ...{SCALED_PREV_TOTAL}, "
                f"{SCALED_TOTAL}), violation {r.violation}"
            )
        st = ck.last_stats
        return (
            f"level totals {cum} (level 7 partial: stop "
            f"{r.stop_reason}); {r.distinct_states} states in "
            f"{r.wall_s:.2f}s = {r.states_per_sec:.0f} st/s; table "
            f"{st['fpset_table_cap']} slots, load "
            f"{st['fpset_occupancy']:.3f}; {st['fpset_flushes']} flushes, "
            f"{st['fpset_probe_rounds']} probe rounds; device memory "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB in use, "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB peak"
        )

    counted("6 scaled cfg (618-bit, 64-bit fp)", scaled)

    launches = dict(kernels.LAUNCHES)
    print(f"[7 launches on the main path] {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            failures.append(f"kernel {name} never launched on the main path")

    # ---- 8: where the time goes in the scaled run (after the counts
    # were read: this run is the profiler's, not the main path's)
    def profile():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        ck = DeviceChecker(CompactionModel(scaled_cfg()),
                           max_states=SCALED_TOTAL + 1)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      acc_events=True) as prof:
            t = time.time()
            r = ck.run()
            torch.cuda.synchronize()
            wall = time.time() - t
        allev = prof.key_averages()
        # kernels and copies only: a CPU op's entry repeats the device
        # time of the kernels it launched
        ev = [e for e in allev if e.device_type == DeviceType.CUDA]

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        busy = sum(dev_us(e) for e in ev) / 1e6
        if busy <= 0:
            return (f"wall {wall:.2f}s; torch.profiler reported no device "
                    "time on this machine")
        top = sorted(ev, key=dev_us, reverse=True)[:5]
        # the same device time by the PyTorch op that launched it
        ops = [e for e in allev
               if e.device_type == DeviceType.CPU and dev_us(e) > 0]
        top_ops = sorted(ops, key=dev_us, reverse=True)[:8]
        ours = sum(dev_us(e) for e in ev
                   if "member_kernel" in e.key or "key_plane_kernel" in e.key)
        # buffer fills (torch.full/zeros), the probe's claims among them
        fills = [e for e in allev if e.key == "aten::fill_"]
        fill_ms = sum(dev_us(e) for e in fills) / 1e3
        n_fill = sum(e.count for e in fills)
        syncs = [e for e in allev if e.key == "aten::_local_scalar_dense"]
        n_sync = sum(e.count for e in syncs)
        sync_s = sum(e.self_cpu_time_total for e in syncs) / 1e6
        return (
            f"{r.distinct_states} states, wall {wall:.2f}s under the "
            f"profiler; device busy {busy:.3f}s ({busy / wall:.1%} of "
            f"wall); K1+K2 {ours / 1e6:.4f}s ({ours / 1e6 / busy:.2%} of "
            f"device time); {n_sync} host syncs (.item) holding "
            f"{sync_s:.3f}s of host time; aten::fill_ {fill_ms:.1f}ms "
            f"x{n_fill}; device time by op: "
            + "; ".join(
                f"{e.key} {dev_us(e) / 1e3:.1f}ms x{e.count}"
                for e in top_ops
            )
            + "; top kernels: "
            + "; ".join(
                f"{e.key[:60]} {dev_us(e) / 1e3:.1f}ms x{e.count}"
                for e in top
            )
        )

    _phase("8 profile of the scaled run", profile, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    replaces = {
        "selftest": "pulsar_tlaplus_tpu/ops/tiles.py:172",
        "member_block": "pulsar_tlaplus_tpu/ops/tiles.py:326",
        "key_plane": "pulsar_tlaplus_tpu/ops/tiles.py:517",
    }
    out = []
    for name in ("selftest", "member_block", "key_plane"):
        rec = record[name]
        out.append(dict(
            name=name,
            route="cuda",
            source="pulsar_tlaplus_tpu_torch/kernels/csrc/"
            + kernels.SOURCES[name],
            replaces=replaces[name],
            launches=launches[name],
            max_abs_err=rec["max_abs_err"],
            ms=rec["ms"],
            plain_ms=rec["plain_ms"],
            bound_ms=rec["bound"][0],
            bound_by=rec["bound"][1],
            library_ms=None,
        ))
    print(smi, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
