"""Command-line interface — the ``check`` subcommand of
``pulsar_tlaplus_tpu/cli.py`` on the PyTorch/CUDA engine:

    python -m pulsar_tlaplus_tpu_torch.cli check SPEC.tla [-config FILE.cfg]
        [-invariant NAME ...] [-nodeadlock] [-maxstates N] [-cpu]
        [-fuse level|stage] [-fuse-group G]
        [-hbm-budget BYTES [-no-spill-compress]]

It runs exhaustive BFS of the named spec on the GPU (``-cpu``: on the
CPU) and prints a TLC-style summary: distinct states, diameter, and a
counterexample trace on an invariant violation or a deadlock; with
``-hbm-budget``, one more line sums up what spilled to host RAM.  Exit code
0 when the search completes clean, 1 on a violation or deadlock (or an
error), 3 when the state budget truncated the search.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _report(r, constants, wall: float) -> int:
    """TLC-style result report; returns the process exit code."""
    from pulsar_tlaplus_tpu_torch.utils.render import render_trace

    if r.violation and r.violation != "Deadlock":
        print(f"Error: Invariant {r.violation} is violated.")
    elif r.deadlock:
        print("Error: Deadlock reached.")
    if r.violation:
        print("The behavior up to this point is:")
        print(render_trace(r.trace, r.trace_actions, constants))
    print(
        f"{r.distinct_states} distinct states found, "
        f"search depth (diameter) {r.diameter}."
    )
    print(
        f"Finished in {wall:.1f}s "
        f"({r.states_per_sec:.0f} distinct states/sec)."
    )
    if r.fp_collision_prob:
        print(
            "The calculated (optimistic) probability of a fingerprint "
            f"collision at this state count is {r.fp_collision_prob:.3g}."
        )
    if r.violation or r.deadlock:
        return 1
    if r.truncated:
        print(
            "WARNING: search truncated by the state budget — the state "
            "space was NOT exhausted; absence of violations is "
            f"inconclusive. (stop reason: {r.stop_reason})"
        )
        return 3
    return 0


def _check(args) -> int:
    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
    from pulsar_tlaplus_tpu_torch.models import registry
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

    module = os.path.splitext(os.path.basename(args.spec))[0]
    cfg_path = args.config or os.path.splitext(args.spec)[0] + ".cfg"
    if not os.path.exists(cfg_path):
        sys.exit(f"tpu-tlc: config file not found: {cfg_path}")
    tlc_cfg = cfgmod.load(cfg_path)
    if module not in registry.COMPILED:
        sys.exit(
            f"tpu-tlc: no model for module {module!r} in the PyTorch port "
            f"(has: {', '.join(sorted(registry.COMPILED))})"
        )
    try:
        model, constants = registry.COMPILED[module](tlc_cfg)
    except ValueError as e:
        sys.exit(f"tpu-tlc: {e}")
    invariants = tuple(args.invariant or tlc_cfg.invariants)
    unknown = [i for i in invariants if i not in model.invariants]
    if unknown:
        sys.exit(f"tpu-tlc: unknown invariant(s): {unknown}")
    try:
        ck = DeviceChecker(
            model,
            invariants=invariants,
            check_deadlock=not args.nodeadlock,
            max_states=args.maxstates,
            device="cpu" if args.cpu else None,
            progress=True,
            hbm_budget=args.hbm_budget,
            spill_compress=not args.no_spill_compress,
            fuse=args.fuse,
            fuse_group=args.fuse_group,
        )
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    print(
        f"tpu-tlc: checking {module} @ {cfg_path} on {ck.device} "
        f"(state width {model.layout.total_bits} bits, "
        f"{model.A} successor lanes; invariants: {list(invariants) or 'none'})"
    )
    t0 = time.time()
    try:
        r = ck.run()
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    rc = _report(r, constants, time.time() - t0)
    if ck.tiered:
        _report_spill(ck)
    return rc


def _report_spill(ck) -> None:
    """One line on the tiered store's work in the run."""
    from pulsar_tlaplus_tpu_torch.store.budget import fmt_bytes

    st = ck.last_stats
    print(
        f"Spill (hbm budget {fmt_bytes(ck.hbm_budget)}): "
        f"{st['spill_evictions']} evictions, {st['spill_keys_evicted']} "
        f"keys and {st['spill_rows_evicted']} rows spilled to host RAM "
        f"({fmt_bytes(st['spill_bytes_comp'])} encoded), "
        f"{st['spill_misses_resolved']} misses resolved "
        f"({st['spill_miss_hits']} cold hits), {st['spill_hot_keys']} "
        "keys hot"
        + ("; WARNING: the budget was overridden"
           if ck._budget_overridden else "")
        + "."
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu-tlc-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("check", help="exhaustive BFS model checking")
    pc.add_argument("spec", help="the .tla module to check")
    pc.add_argument("-config", default=None,
                    help="TLC .cfg (default: SPEC with a .cfg suffix)")
    pc.add_argument("-invariant", action="append", default=None,
                    help="invariant to check (repeatable; default: the "
                    "cfg's INVARIANTS)")
    pc.add_argument("-nodeadlock", action="store_true",
                    help="do not report deadlocks")
    pc.add_argument("-maxstates", type=int, default=200_000_000)
    pc.add_argument("-cpu", action="store_true",
                    help="run on the CPU instead of the GPU")
    pc.add_argument(
        "-fuse", choices=("level", "stage"), default="level",
        help="level (default): the fused level — a level's windows run "
        "with no host read between them and ramp levels batch up to "
        "-fuse-group per read; stage: read the device after every "
        "window (the differential path)",
    )
    pc.add_argument(
        "-fuse-group", dest="fuse_group", type=int, default=None,
        metavar="G",
        help="max ramp levels (frontier within one expand window) one "
        "host read may close under -fuse level (default 8; 1 disables "
        "the batching)",
    )
    pc.add_argument(
        "-hbm-budget", dest="hbm_budget", metavar="BYTES", default=None,
        help="device-memory byte budget for the tiered state store (e.g. "
        "7.5G, 512M; PTT_HBM_BUDGET env works too): visited keys and "
        "aged rows/trace logs past the budget spill to host RAM through "
        "the sieve-and-compress pipeline — breaks the device-memory "
        "ceiling on max_states",
    )
    pc.add_argument(
        "-no-spill-compress", dest="no_spill_compress",
        action="store_true",
        help="spill raw planes instead of delta+zlib (trades link bytes "
        "for encode CPU)",
    )
    args = p.parse_args(argv)
    return _check(args)


if __name__ == "__main__":
    sys.exit(main())
