"""Command-line interface — the ``check`` subcommand of
``pulsar_tlaplus_tpu/cli.py`` on the PyTorch/CUDA engine:

    python -m pulsar_tlaplus_tpu_torch.cli check SPEC.tla [-config FILE.cfg]
        [-invariant NAME ...] [-nodeadlock] [-maxstates N] [-cpu]

It runs exhaustive BFS of the named spec on the GPU (``-cpu``: on the
CPU) and prints a TLC-style summary: distinct states, diameter, and a
counterexample trace on an invariant violation or a deadlock.  Exit code
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
    return _report(r, constants, time.time() - t0)


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
    args = p.parse_args(argv)
    return _check(args)


if __name__ == "__main__":
    sys.exit(main())
