"""Command-line interface — the ``check`` and ``simulate`` subcommands of
``pulsar_tlaplus_tpu/cli.py`` on the PyTorch/CUDA engine:

    python -m pulsar_tlaplus_tpu_torch.cli check SPEC.tla [-config FILE.cfg]
        [-invariant NAME ...] [-nodeadlock] [-maxstates N] [-cpu]
        [-interp | -force-compile]
        [-fuse level|stage] [-fuse-group G]
        [-hbm-budget BYTES [-no-spill-compress]]
        [-property NAME [-fairness none|wf_next] [-sweep-group G]]
        [-simulate N [-depth D] [-segment L] [-sim-seed S] [-sim-steps N]]
    python -m pulsar_tlaplus_tpu_torch.cli simulate SPEC [-config FILE.cfg]
        [-invariant NAME ...] [-walkers N] [-depth D] [-segment L]
        [-sim-seed S] [-sim-steps N] [-time-budget SEC] [-cpu]

``check`` runs exhaustive BFS of the named spec on the GPU (``-cpu``: on
the CPU) and prints a TLC-style summary.  A module of the registry runs
its hand-written model; any other module (or any module under
``-force-compile``) goes through the spec->kernel compiler
(``frontend/codegen.py``), which falls back to the generic interpreter
(``engine/interp_check.py``, a host BFS) when it declines the spec;
``-interp`` forces the interpreter.  The summary: distinct states, diameter, and a
counterexample trace on an invariant violation or a deadlock; with
``-hbm-budget``, one more line sums up what spilled to host RAM.  After a
clean pass it checks the cfg's ``PROPERTIES`` (``<>goal`` properties).
``-property`` checks one liveness property instead of the invariants,
``-simulate`` runs random walks instead of the exhaustive search, as
``simulate`` does (SPEC is a module name or a ``.tla`` path).  Exit code
0 when the search completes clean (or the property holds, or the walks
found nothing), 1 on a violation, a deadlock or a violated property (or
an error), 3 when the state budget truncated the search.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# exploration window of a liveness check (the JAX CLI's -chunk default)
LIVENESS_CHUNK = 4096


def _report(r, constants, wall: float) -> int:
    """TLC-style result report; returns the process exit code."""
    from pulsar_tlaplus_tpu_torch.utils.render import render_trace

    if r.violation == "__EvalError__":
        print(
            "Error: evaluating the spec on this state is undefined "
            "(TLC would report an evaluation error here)."
        )
    elif r.violation and r.violation != "Deadlock":
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
    fp_p = getattr(r, "fp_collision_prob", 0.0)
    if fp_p:
        print(
            "The calculated (optimistic) probability of a fingerprint "
            f"collision at this state count is {fp_p:.3g}."
        )
    if r.violation or r.deadlock:
        return 1
    if r.truncated:
        reason = getattr(r, "stop_reason", None)
        print(
            "WARNING: search truncated by the state budget — the state "
            "space was NOT exhausted; absence of violations is "
            "inconclusive." + (f" (stop reason: {reason})" if reason else "")
        )
        return 3
    return 0


def _verdict(prop, args, lres) -> None:
    verdict = "satisfied" if lres.holds else "VIOLATED"
    print(
        f"Temporal property {prop} (fairness={args.fairness}): "
        f"{verdict} — {lres.reason}"
    )


def _report_liveness(prop, args, lres) -> int:
    """Liveness verdict report; returns the exit code (0 holds, 1
    violated)."""
    _verdict(prop, args, lres)
    print(f"{lres.distinct_states} distinct states examined.")
    return 0 if lres.holds else 1


def _report_simulation(sres, constants) -> int:
    """TLC ``-simulate``-shaped report; returns the exit code (0 clean,
    1 violation)."""
    from pulsar_tlaplus_tpu_torch.utils.render import render_trace

    if sres.violation:
        print(f"Error: Invariant {sres.violation} is violated.")
        print("The behavior up to this point is:")
        print(render_trace(sres.trace, sres.trace_actions, constants))
        if sres.verified is False:
            print(
                "WARNING: the replayed behavior FAILED independent "
                "re-verification — report this as an engine bug."
            )
    print(
        f"Simulation: {sres.n_walkers} walkers of depth {sres.depth} "
        f"({sres.states_visited} states visited, {sres.steps} steps, "
        f"{sres.walks} completed walks)."
    )
    print(
        f"Finished in {sres.wall_s:.1f}s ({sres.steps_per_sec:,.0f} "
        f"steps/sec, {sres.walks_per_sec:,.1f} walks/sec)"
        + (
            f"; sampled duplicate ratio ~{sres.dup_ratio_est:.1%}."
            if sres.dup_ratio_est is not None
            else "."
        )
    )
    if sres.violation:
        return 1
    print(
        "No violation found within the simulation budget "
        f"(stop reason: {sres.stop_reason}); simulation is NOT "
        "exhaustive — absence of violations is inconclusive."
    )
    return 0


def _liveness(args, model, goal):
    from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker

    return LivenessChecker(
        model,
        goal=goal,
        fairness=args.fairness,
        frontier_chunk=LIVENESS_CHUNK,
        max_states=args.maxstates,
        sweep_group=args.sweep_group,
        hbm_budget=args.hbm_budget,
        spill_compress=False if args.no_spill_compress else None,
        device="cpu" if args.cpu else None,
        progress=True,
    )


def _check_properties(args, model, properties, rc: int) -> int:
    """Check the cfg's PROPERTIES after a clean safety pass, over one
    exploration; a property that is not a ``<>goal`` of the model only
    warns."""
    lck = None
    for prop in properties:
        if prop not in getattr(model, "liveness_goals", {}):
            print(
                f"tpu-tlc: WARNING: cfg PROPERTIES entry {prop} is not "
                "checkable here (only <>(predicate) properties are "
                "supported); safety verdict unaffected"
            )
            continue
        try:
            if lck is None:
                lck = _liveness(args, model, prop)
                lres = lck.run()
            else:
                lres = lck.run_goal(prop)
        except (ValueError, RuntimeError) as e:
            sys.exit(f"tpu-tlc: {e}")
        _verdict(prop, args, lres)
        if not lres.holds:
            rc = 1
    return rc


def _simulate(args, model, constants, invariants, n_walkers: int,
              time_budget=None, header=None) -> int:
    from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator

    try:
        sim = StreamingSimulator(
            model,
            invariants=invariants,
            n_walkers=n_walkers,
            depth=args.depth,
            segment_len=args.segment,
            seed=args.sim_seed,
            max_steps=args.sim_steps,
            time_budget_s=time_budget,
            device="cpu" if args.cpu else None,
            progress=True,
        )
        if header is not None:
            header(sim.device)
        sres = sim.run()
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    return _report_simulation(sres, constants)


def _load_model(module: str, cfg_path: str):
    """(model, constants, parsed cfg) of a registry module at a cfg."""
    from pulsar_tlaplus_tpu_torch.models import registry
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

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
    return model, constants, tlc_cfg


def _invariants(args, model, tlc_cfg):
    invariants = tuple(args.invariant or tlc_cfg.invariants)
    unknown = [i for i in invariants if i not in model.invariants]
    if unknown:
        sys.exit(f"tpu-tlc: unknown invariant(s): {unknown}")
    return invariants


def _header(module, cfg_path, device, model, invariants) -> None:
    print(
        f"tpu-tlc: checking {module} @ {cfg_path} on {device} "
        f"(state width {model.layout.total_bits} bits, "
        f"{model.A} successor lanes; invariants: {list(invariants) or 'none'})"
    )


def _check(args) -> int:
    from pulsar_tlaplus_tpu_torch.models import registry
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

    for flag in ("checkpoint", "recover", "sharded"):
        if getattr(args, flag):
            sys.exit(f"tpu-tlc: -{flag} is not ported to the PyTorch "
                     "engine yet")
    module = os.path.splitext(os.path.basename(args.spec))[0]
    cfg_path = args.config or os.path.splitext(args.spec)[0] + ".cfg"
    if args.interp or args.force_compile or module not in registry.COMPILED:
        if not os.path.exists(cfg_path):
            sys.exit(f"tpu-tlc: config file not found: {cfg_path}")
        tlc_cfg = cfgmod.load(cfg_path)
        invariants = tuple(args.invariant or tlc_cfg.invariants)
        if args.interp:
            return _check_interp(args, module, tlc_cfg, invariants)
        return _check_compiled_spec(args, module, tlc_cfg, invariants)
    model, constants, tlc_cfg = _load_model(module, cfg_path)
    invariants = _invariants(args, model, tlc_cfg)
    return _dispatch_engines(
        args, model, constants, invariants, tlc_cfg,
        lambda dev: _header(module, cfg_path, dev, model, invariants),
    )


def _parse_spec(args, tlc_cfg):
    """(spec, interned strings) of ``args.spec`` bound to the cfg."""
    from pulsar_tlaplus_tpu_torch.frontend.interp import Spec
    from pulsar_tlaplus_tpu_torch.frontend.loader import bind_cfg
    from pulsar_tlaplus_tpu_torch.frontend.parser import parse_file

    ast = parse_file(args.spec)
    consts = bind_cfg(ast, tlc_cfg)
    interned = consts.pop("__string_interning__", None) or {}
    return Spec(ast, consts), interned


def _print_interned(interned) -> None:
    for cname, mapping in interned.items():
        pairs = ", ".join(f'"{s}" -> {i}' for s, i in mapping.items())
        print(f"tpu-tlc: note: {cname} strings interned as naturals: {pairs}")


def _check_compiled_spec(args, module, tlc_cfg, invariants) -> int:
    """The spec->kernel compiler path: parse and bind the spec, compile
    Init/Next/invariants to a batched model (``frontend/codegen.py``)
    and run it through the same engines as a registry model.  Falls
    back to the generic interpreter when the spec uses a construct
    outside the compilable subset."""
    from pulsar_tlaplus_tpu_torch.frontend.codegen import CompiledSpec
    from pulsar_tlaplus_tpu_torch.frontend.codegen_ir import CodegenError

    try:
        spec, interned = _parse_spec(args, tlc_cfg)
    except (ValueError, OSError) as e:
        sys.exit(f"tpu-tlc: {e}")
    try:
        cs = CompiledSpec(spec, invariants=invariants,
                          device="cpu" if args.cpu else None)
    except CodegenError as e:
        print(
            f"tpu-tlc: note: spec->kernel compiler declined ({e}); "
            "falling back to the generic interpreter"
        )
        return _check_interp(args, module, tlc_cfg, invariants)
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")

    def header(_dev):
        print(
            f"tpu-tlc: checking {module} @ {args.spec} via the spec->kernel "
            f"compiler (state width {cs.layout.total_bits} bits, {cs.A} "
            f"successor lanes; invariants: {list(invariants) or 'none'})"
        )
        _print_interned(interned)

    return _dispatch_engines(args, cs, None, invariants, tlc_cfg, header,
                             checker_invariants=cs.default_invariants)


def _check_interp(args, module, tlc_cfg, invariants) -> int:
    """The generic-interpreter path: any spec in the supported subset,
    exhaustive BFS on the host."""
    from pulsar_tlaplus_tpu_torch.engine.interp_check import InterpChecker

    if args.simulate or args.liveness_property:
        sys.exit(
            "tpu-tlc: -simulate/-property need a compiled model "
            f"and the generic-interpreter path was selected for '{module}' "
            f"({'-interp forced' if args.interp else 'module not in the compiled registry'}); "
            "the interpreter path is exhaustive BFS only"
        )
    if tlc_cfg.properties:
        print(
            "tpu-tlc: WARNING: cfg PROPERTIES "
            f"{list(tlc_cfg.properties)} are NOT checked on the "
            "generic-interpreter path (safety only)"
        )
    t0 = time.time()
    try:
        spec, interned = _parse_spec(args, tlc_cfg)
        spec.check_assumes()
        print(
            f"tpu-tlc: checking {module} @ {args.spec} via the generic "
            f"interpreter (invariants: {list(invariants) or 'none'})"
        )
        _print_interned(interned)
        r = InterpChecker(
            spec,
            invariants=invariants,
            check_deadlock=not args.nodeadlock,
            max_states=args.maxstates,
        ).run()
    except (ValueError, OSError) as e:
        sys.exit(f"tpu-tlc: {e}")
    return _report(r, None, time.time() - t0)


def _dispatch_engines(args, model, constants, invariants, tlc_cfg, header,
                      checker_invariants=None) -> int:
    """Engine selection shared by the registry and compiler paths:
    a liveness property, simulation, or the device checker, all over
    the batched model protocol.  ``header(device)`` prints the run's
    first line."""
    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker

    if args.liveness_property:
        try:
            lck = _liveness(args, model, args.liveness_property)
            header(lck.device)
            lres = lck.run()
        except (ValueError, RuntimeError) as e:
            sys.exit(f"tpu-tlc: {e}")
        return _report_liveness(args.liveness_property, args, lres)
    if args.simulate:
        return _simulate(args, model, constants, invariants, args.simulate,
                         header=header)
    try:
        ck = DeviceChecker(
            model,
            invariants=checker_invariants or invariants,
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
    header(ck.device)
    t0 = time.time()
    try:
        r = ck.run()
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    rc = _report(r, constants, time.time() - t0)
    if ck.tiered:
        _report_spill(ck)
    if rc == 0 and tlc_cfg.properties:
        rc = _check_properties(args, model, tlc_cfg.properties, rc)
    return rc


def _cmd_simulate(args) -> int:
    """The ``simulate`` subcommand: SPEC is a registry module name or a
    ``.tla`` path; the cfg defaults to ``specs/<module>.cfg`` (a path:
    its ``.cfg`` sibling)."""
    spec = args.spec
    module = os.path.splitext(os.path.basename(spec))[0]
    cfg_path = args.config
    if cfg_path is None:
        if spec.endswith(".tla"):
            cfg_path = os.path.splitext(spec)[0] + ".cfg"
        else:
            cfg_path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "specs", f"{module}.cfg",
            )
    model, constants, tlc_cfg = _load_model(module, cfg_path)
    invariants = _invariants(args, model, tlc_cfg)
    print(
        f"tpu-tlc: simulating {module} ({args.walkers} walkers, depth "
        f"{args.depth}; invariants: {list(invariants) or 'none'})"
    )
    return _simulate(args, model, constants, invariants, args.walkers,
                     time_budget=args.time_budget)


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


def _sim_args(p) -> None:
    """The options ``check -simulate`` and ``simulate`` share."""
    p.add_argument("-depth", type=int, default=64,
                   help="steps per behavior before walkers restart "
                   "(TLC -simulate depth; default 64)")
    p.add_argument("-segment", type=int, default=None, metavar="STEPS",
                   help="steps per host read (clamped to a divisor of "
                   "-depth; default min(depth, 32))")
    p.add_argument("-sim-seed", dest="sim_seed", type=int,
                   default=0, help="seed of the walk stream, which is "
                   "deterministic given it (default 0)")
    p.add_argument("-sim-steps", dest="sim_steps", type=int,
                   default=None, help="total step budget across the "
                   "swarm (default: one depth round)")


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
    pc.add_argument("-interp", action="store_true",
                    help="check with the generic interpreter (host BFS) "
                    "instead of a compiled model")
    pc.add_argument("-force-compile", "-compile", dest="force_compile",
                    action="store_true",
                    help="compile the spec even when the registry has a "
                    "hand-written model for it")
    # the JAX CLI's checkpoint and mesh flags: not ported yet (refused)
    pc.add_argument("-checkpoint", default=None, help=argparse.SUPPRESS)
    pc.add_argument("-recover", action="store_true", help=argparse.SUPPRESS)
    pc.add_argument("-sharded", type=int, default=0, help=argparse.SUPPRESS)
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
    pc.add_argument("-property", dest="liveness_property", metavar="NAME",
                    help="check a liveness property (e.g. Termination) "
                    "instead of invariants")
    pc.add_argument("-fairness", choices=("none", "wf_next"),
                    default="none",
                    help="fairness assumption for -property and the cfg's "
                    "PROPERTIES (default: none, like the raw Spec)")
    pc.add_argument("-sweep-group", dest="sweep_group", type=int,
                    default=None, metavar="G",
                    help="liveness edge sweep: chunks per host read "
                    "(default: up to 8, within 2^22 lanes)")
    pc.add_argument("-simulate", type=int, default=0, metavar="N",
                    help="simulation mode: N random walkers instead of "
                    "exhaustive BFS")
    _sim_args(pc)

    ps = sub.add_parser("simulate", help="walker-swarm simulation (TLC "
                        "-simulate) under a step or time budget")
    ps.add_argument("spec", help="registry module name (e.g. compaction) "
                    "or a .tla path")
    ps.add_argument("-config", default=None,
                    help=".cfg constant bindings (default: "
                    "specs/<spec>.cfg)")
    ps.add_argument("-invariant", action="append", default=None,
                    help="invariant to check (repeatable; default: the "
                    "cfg's INVARIANTS)")
    ps.add_argument("-walkers", type=int, default=1024, metavar="N",
                    help="walker swarm width (default 1024)")
    _sim_args(ps)
    ps.add_argument("-time-budget", dest="time_budget", type=float,
                    default=None, metavar="SEC", help="wall-clock budget")
    ps.add_argument("-cpu", action="store_true",
                    help="run on the CPU instead of the GPU")
    args = p.parse_args(argv)
    return _cmd_simulate(args) if args.cmd == "simulate" else _check(args)


if __name__ == "__main__":
    sys.exit(main())
