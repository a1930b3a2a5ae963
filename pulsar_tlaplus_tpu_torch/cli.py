"""Command-line interface — the ``check`` and ``simulate`` subcommands of
``pulsar_tlaplus_tpu/cli.py`` on the PyTorch/CUDA engine:

    python -m pulsar_tlaplus_tpu_torch.cli check SPEC.tla [-config FILE.cfg]
        [-invariant NAME ...] [-nodeadlock] [-maxstates N] [-cpu]
        [-interp | -force-compile]
        [-fuse level|stage] [-fuse-group G]
        [-hbm-budget BYTES [-no-spill-compress]]
        [-property NAME [-fairness none|wf_next] [-sweep-group G]]
        [-simulate N [-depth D] [-segment L] [-sim-seed S] [-sim-steps N]]
        [-checkpoint PATH [-recover]] [-metrics FILE] [-chunk N]
        [-telemetry FILE] [-progress SEC] [-xprof DIR [-xprof-levels LO:HI]]
        [-engine device|host] [-visited fpset|sort] [-compact logshift|sort]
        [-sharded N [-slices S] [-sharded-engine device|host]
         [-sharded-dedup sort|hash] | -workers N]
        [-no-profile] [-adapt | -no-adapt]
    python -m pulsar_tlaplus_tpu_torch.cli simulate SPEC [-config FILE.cfg]
        [-invariant NAME ...] [-walkers N] [-depth D] [-segment L]
        [-sim-seed S] [-sim-steps N] [-time-budget SEC] [-cpu]
        [-checkpoint PATH [-recover]] [-telemetry FILE] [-progress SEC]
        [-no-profile]
    python -m pulsar_tlaplus_tpu_torch.cli tune SPEC [-config FILE.cfg]
        [-invariant NAME ...] [--mode check|simulate] [--sim-depth D]
        [--sim-steps N] [--maxstates N] [--budget SEC] [--hbm-budget BYTES]
        [--visited-cap N] [--frontier-cap N] [--sub-batch N] [--top-k K]
        [--repeat N] [--candidates N] [--calibration FILE]
        [--stream-dir DIR] [--ledger FILE] [--adapt] [-cpu]
    python -m pulsar_tlaplus_tpu_torch.cli serve [STATE_DIR | --state-dir D]
        [-cpu] [--devices N] [--slice SEC] [--maxstates N] [-chunk N]
        [--spec NAME ...] [--recover [--drain]] [--warm-max-bytes B]
        [--tcp HOST:PORT --tokens FILE] [quotas...]
    python -m pulsar_tlaplus_tpu_torch.cli submit SPEC CFG [--wait|--watch]
        [--maxstates N] [--mode check|simulate] [--no-warm] [--priority N]
    python -m pulsar_tlaplus_tpu_torch.cli status|watch|cancel [JOB_ID]
    python -m pulsar_tlaplus_tpu_torch.cli trace STREAM... [-o FILE]
    python -m pulsar_tlaplus_tpu_torch.cli metrics [--stream FILE]
    python -m pulsar_tlaplus_tpu_torch.cli top [--stream FILE...]
        [--interval SEC] [--once]
    python -m pulsar_tlaplus_tpu_torch.cli ledger [--ledger FILE]
        add FILE... | list [--key K] | show REF | compare REF REF |
        gate [--current REF] [--baseline REF] [--threshold REL] [--keys K...]

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
``simulate`` does (SPEC is a module name or a ``.tla`` path).
``-sharded N`` checks on the mesh-sharded engine
(``engine/sharded_device.py``) over N shards, ``-slices S`` arranged as
an S-slice 2-D mesh; the shards take the cards present in turn and
share them when N exceeds them (under ``-cpu`` all sit on the CPU).
``-workers N`` is TLC's worker count: ``-sharded N`` capped at the cards
present (at N under ``-cpu``), the single-device engine at 1.
``-sharded-engine host`` (or ``-sharded-dedup hash``, which needs it)
runs the host-staged sharded driver (``engine/sharded.py``), and
``-engine host`` the host-driver engine (``engine/bfs.py``, hash dedup
on the device, the state log on the host).  ``-visited sort`` gives the
device engines the sort-merge visited set, ``-compact`` their
compaction; ``-chunk N`` is the frontier rows a device window or a host
chunk expands (default: the engine's own; 4096 on the host engines, as
in the JAX CLI); ``-metrics FILE`` appends one JSON record a level.
``-checkpoint PATH`` writes resumable frames there (the device checker
every 5 levels and at any truncation, the liveness sweep every 5
chunks, the simulator every 8 segments), and SIGTERM/SIGINT then stops
the run with a frame; ``-recover`` continues from the frame (and refuses
when there is none).  ``tune`` searches the knob space of the device
engine (``--mode simulate``: the simulator's) with the cost model,
measures the top ``--top-k`` candidates and the defaults in turns
(min of ``--repeat``), and saves the winner as a tuned profile
(``tune/``) under ``PTT_TUNE_DIR`` (default ``~/.ptt_profiles``);
``check`` and ``simulate`` resolve the profile of their config unless
``-no-profile`` (flags given explicitly win over it), and ``-adapt`` /
``-no-adapt`` turn the online controller on or off (``PTT_TUNE_ADAPT=0``
turns it off everywhere).  ``-telemetry FILE`` writes every engine's
versioned JSONL event stream (``obs/telemetry.py``), ``-progress SEC``
a TLC-style progress line that often (neither reads the device), and
``-xprof DIR`` a ``torch.profiler`` Chrome trace of the single-device
engine's ``-xprof-levels`` window.  ``trace`` turns streams into a
Perfetto trace, ``metrics --stream`` into Prometheus text, ``top
--stream`` into a dashboard, and ``ledger`` keeps the cross-run
regression ledger.  ``serve`` runs the resident daemon (``service/``):
checkers warmed for the registry, jobs time-sliced on the card at level
boundaries, warm starts from earlier runs (``warm/``); ``submit``,
``status``, ``watch``, ``cancel``, and ``metrics``/``top`` without
``--stream`` talk to it over its unix socket (``--socket tcp://HOST:
PORT --token T`` for the TCP listener).  ``dispatch`` runs the fleet
dispatcher (``fleet/``): N ``serve`` daemons behind one endpoint that
speaks the same protocol (routing by live load, warm-artifact
replication, failover); the client commands work against it unchanged,
``metrics --aggregate`` scrapes every backend through it, and ``top
--dispatch`` shows its routing view.
Exit code 0 when the search completes clean (or
the property holds, or the walks found nothing), 1 on a violation, a
deadlock or a violated property (or an error), 3 when a budget, device
memory or a preemption truncated the search (no verdict).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# exploration window of a liveness check and the sharded engine's
# sub_batch (the JAX CLI's -chunk default)
LIVENESS_CHUNK = 4096
SHARDED_CHUNK = 4096


def _profile_arg(args):
    """``"auto"`` (resolve the config's tuned profile) unless
    ``-no-profile``."""
    return None if args.no_profile else "auto"


def _adapt_arg(args):
    """``-no-adapt`` -> False, ``-adapt`` -> True, else None (the
    profile or ``PTT_TUNE_ADAPT`` decides)."""
    if args.no_adapt:
        return False
    return True if args.adapt else None


def _report(r, constants, wall: float, checkpoint=None) -> int:
    """TLC-style result report; returns the process exit code."""
    from pulsar_tlaplus_tpu_torch.utils.render import render_trace

    def print_trace():
        if r.trace is None:
            print("(trace unavailable: run was truncated before the "
                  "counterexample could be reconstructed)")
        else:
            print("The behavior up to this point is:")
            print(render_trace(r.trace, r.trace_actions, constants))

    if r.violation == "__EvalError__":
        print(
            "Error: evaluating the spec on this state is undefined "
            "(TLC would report an evaluation error here)."
        )
        print_trace()
    elif r.violation and r.violation != "Deadlock":
        print(f"Error: Invariant {r.violation} is violated.")
        print_trace()
    elif r.deadlock:
        print("Error: Deadlock reached.")
        print_trace()
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
    hbm_rec = getattr(r, "hbm_recovered", 0)
    if hbm_rec:
        print(
            f"Note: recovered from device-memory exhaustion {hbm_rec} "
            "time(s) by rebuilding from the checkpoint at degraded "
            "capacity."
        )
    if r.violation or r.deadlock:
        return 1
    if r.truncated:
        reason = getattr(r, "stop_reason", None)
        if reason == "preempted":
            if checkpoint and os.path.exists(checkpoint):
                print(
                    "WARNING: search preempted (SIGTERM/SIGINT) — a "
                    "resumable checkpoint frame is on disk; continue "
                    "with -recover."
                )
            else:
                print(
                    "WARNING: search preempted (SIGTERM/SIGINT) before "
                    "any checkpoint frame could be written — the run "
                    "is NOT resumable."
                )
        else:
            print(
                "WARNING: search truncated by the state/time budget — the "
                "state space was NOT exhausted; absence of violations is "
                "inconclusive."
                + (f" (stop reason: {reason})" if reason else "")
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
    violated, 3 preempted or truncated: no verdict)."""
    if lres.truncated:
        if lres.stop_reason == "preempted":
            if args.checkpoint and os.path.exists(args.checkpoint):
                print(
                    f"Temporal property {prop}: run preempted "
                    "(SIGTERM/SIGINT) — no verdict.  A resumable "
                    "frame is on disk; continue with -recover."
                )
            else:
                print(
                    f"Temporal property {prop}: run preempted "
                    "(SIGTERM/SIGINT) before any frame could be "
                    "written — no verdict, and the run is NOT "
                    "resumable."
                )
        else:
            print(
                f"Temporal property {prop}: run truncated "
                f"({lres.stop_reason or 'unknown'}) — no verdict."
            )
        return 3
    _verdict(prop, args, lres)
    print(f"{lres.distinct_states} distinct states examined.")
    return 0 if lres.holds else 1


def _report_simulation(sres, constants, checkpoint=None) -> int:
    """TLC ``-simulate``-shaped report; returns the exit code (0 clean,
    1 violation, 3 preempted: the walk resumes with -recover)."""
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
    if sres.truncated:
        if sres.stop_reason == "preempted" and checkpoint and (
            os.path.exists(checkpoint)
        ):
            print(
                "WARNING: simulation preempted (SIGTERM/SIGINT) — a "
                "resumable frame is on disk; continue the identical "
                "walk stream with -recover."
            )
        else:
            print(
                "WARNING: simulation interrupted "
                f"({sres.stop_reason or 'unknown'}) — the walk "
                "stream did not reach its budget."
            )
        return 3
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
        compact_impl=args.compact,
        profile=_profile_arg(args),
        device="cpu" if args.cpu else None,
        progress=True,
        checkpoint_path=args.checkpoint,
        telemetry=args.telemetry,
        heartbeat_s=args.progress,
    )


def _no_frame(args) -> None:
    sys.exit(
        "tpu-tlc: -recover needs an existing -checkpoint file "
        f"(got: {args.checkpoint})"
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
        if lres.truncated:
            # no verdict: the remaining properties are not checked
            return _report_liveness(prop, args, lres)
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
            checkpoint_path=args.checkpoint,
            telemetry=args.telemetry,
            heartbeat_s=args.progress,
            profile=_profile_arg(args),
        )
        if header is not None:
            header(sim)
        sres = sim.run(resume=args.recover)
    except FileNotFoundError:
        _no_frame(args)
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    return _report_simulation(sres, constants, args.checkpoint)


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

    _sharded_args(args)
    module, cfg_path = _spec_cfg(args)
    if args.recover and not args.interp and (
        not args.checkpoint or not os.path.exists(args.checkpoint)
    ):
        _no_frame(args)
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


def _sharded_args(args) -> None:
    """The JAX CLI's mesh options: ``-workers`` to ``-sharded``, and the
    checks on ``-slices`` and the engine options."""
    if args.engine == "host" and args.hbm_budget:
        sys.exit("tpu-tlc: -hbm-budget needs the device engine (the host "
                 "engine has no tiered store)")
    if isinstance(args.workers, int) and not args.sharded:
        if args.cpu:
            avail = args.workers
        else:
            import torch

            avail = max(torch.cuda.device_count(), 1)
        n = min(args.workers, avail)
        capped = (f" (capped from {args.workers}: {avail} devices "
                  "available)" if n != args.workers else "")
        if n == 1:
            print(f"tpu-tlc: note: -workers {args.workers} runs the "
                  f"single-chip device engine{capped}", file=sys.stderr)
            args.sharded = 0
        else:
            print(f"tpu-tlc: note: -workers {args.workers} maps to "
                  f"-sharded {n} (mesh-sharded checking){capped}")
            args.sharded = n
    if not args.sharded and (args.slices > 1
                             or args.sharded_dedup != "sort"):
        sys.exit("tpu-tlc: -slices/-sharded-dedup require -sharded N")
    if args.sharded:
        if args.slices > 1 and args.sharded % args.slices:
            sys.exit("tpu-tlc: -sharded must be divisible by -slices")
        if args.hbm_budget:
            sys.exit("tpu-tlc: -hbm-budget needs the single-device engine "
                     "(the sharded engine has no tiered store)")


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

    if args.simulate or args.sharded or args.liveness_property:
        sys.exit(
            "tpu-tlc: -simulate/-sharded/-property need a compiled model "
            f"and the generic-interpreter path was selected for '{module}' "
            f"({'-interp forced' if args.interp else 'module not in the compiled registry'}); "
            "the interpreter path is exhaustive BFS only"
        )
    if (
        args.checkpoint or args.recover or args.metrics
        or args.telemetry or args.progress or args.xprof
    ):
        sys.exit(
            "tpu-tlc: -checkpoint/-recover/-metrics/-telemetry/"
            "-progress/-xprof are not supported on the generic-"
            "interpreter path yet"
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

    if args.xprof and (
        args.liveness_property or args.simulate or args.sharded
        or args.engine != "device"
    ):
        # the level-windowed profiler exists only on the single-device
        # engine: never let a user wait out a run believing otherwise
        print(
            "tpu-tlc: note: -xprof is only supported on the "
            "single-device engine; no trace will be captured",
            file=sys.stderr,
        )
    if args.liveness_property:
        try:
            lck = _liveness(args, model, args.liveness_property)
            header(lck.device)
            lres = lck.run(resume=args.recover)
        except FileNotFoundError:
            _no_frame(args)
        except (ValueError, RuntimeError) as e:
            sys.exit(f"tpu-tlc: {e}")
        return _report_liveness(args.liveness_property, args, lres)
    if args.simulate:
        return _simulate(args, model, constants, invariants, args.simulate,
                         header=lambda sim: header(sim.device))
    if args.sharded:
        return _check_sharded(args, model, constants,
                              checker_invariants or invariants, header)
    try:
        if args.engine == "host":
            from pulsar_tlaplus_tpu_torch.engine.bfs import Checker

            ck = Checker(
                model,
                invariants=checker_invariants or invariants,
                check_deadlock=not args.nodeadlock,
                frontier_chunk=args.chunk or SHARDED_CHUNK,
                max_states=args.maxstates,
                progress=True,
                metrics_path=args.metrics,
                checkpoint_path=args.checkpoint,
                device="cpu" if args.cpu else None,
                telemetry=args.telemetry,
                heartbeat_s=args.progress,
            )
        else:
            ck = DeviceChecker(
                model,
                invariants=checker_invariants or invariants,
                check_deadlock=not args.nodeadlock,
                max_states=args.maxstates,
                device="cpu" if args.cpu else None,
                progress=True,
                hbm_budget=args.hbm_budget,
                spill_compress=False if args.no_spill_compress else None,
                fuse=args.fuse,
                fuse_group=args.fuse_group,
                checkpoint_path=args.checkpoint,
                metrics_path=args.metrics,
                visited_impl=args.visited,
                compact_impl=args.compact,
                profile=_profile_arg(args),
                adapt=_adapt_arg(args),
                telemetry=args.telemetry,
                heartbeat_s=args.progress,
                xprof_dir=args.xprof,
                xprof_levels=args.xprof_window,
                **({"sub_batch": args.chunk} if args.chunk else {}),
            )
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    header(ck.device)
    t0 = time.time()
    try:
        r = ck.run(resume=args.recover)
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    rc = _report(r, constants, time.time() - t0, checkpoint=args.checkpoint)
    if getattr(ck, "tiered", False):
        _report_spill(ck)
    if rc == 0 and tlc_cfg.properties:
        rc = _check_properties(args, model, tlc_cfg.properties, rc)
    return rc


def _check_sharded(args, model, constants, invariants, header) -> int:
    """The mesh-sharded engine over ``-sharded`` shards (``-slices``
    slices): the device-resident one, or with ``-sharded-engine host``
    (``-sharded-dedup hash`` needs it) the host-staged driver.  The
    cfg's PROPERTIES are not checked after it, as in the JAX CLI."""
    from pulsar_tlaplus_tpu_torch.engine.sharded import ShardedChecker
    from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
        ShardedDeviceChecker,
    )
    from pulsar_tlaplus_tpu_torch.parallel.mesh import make_mesh2d

    dev = "cpu" if args.cpu else None
    host = args.sharded_engine == "host" or args.sharded_dedup == "hash"
    if host and args.sharded_engine == "device":
        print("tpu-tlc: note: -sharded-dedup hash needs the host-staged "
              "sharded driver; using -sharded-engine host")
    try:
        if host:
            ck = ShardedChecker(
                model,
                invariants=invariants,
                check_deadlock=not args.nodeadlock,
                frontier_chunk=args.chunk or SHARDED_CHUNK,
                max_states=args.maxstates,
                mesh=make_mesh2d(args.slices, args.sharded // args.slices,
                                 dev),
                dedup_mode=args.sharded_dedup,
                metrics_path=args.metrics,
                checkpoint_path=args.checkpoint,
                progress=True,
                telemetry=args.telemetry,
                heartbeat_s=args.progress,
            )
        else:
            ck = ShardedDeviceChecker(
                model,
                n_devices=args.sharded,
                invariants=invariants,
                check_deadlock=not args.nodeadlock,
                sub_batch=args.chunk or SHARDED_CHUNK,
                max_states=args.maxstates,
                progress=True,
                metrics_path=args.metrics,
                checkpoint_path=args.checkpoint,
                n_slices=args.slices,
                device=dev,
                visited_impl=args.visited,
                compact_impl=args.compact or "logshift",
                telemetry=args.telemetry,
                heartbeat_s=args.progress,
            )
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    header(ck.device)
    m = ck.mesh
    devs = ", ".join(str(d) for d in m.distinct_devices())
    mesh = f", {m.D}x{m.I} mesh" if m.D > 1 else ""
    how = " (host-staged)" if host else ""
    print(f"tpu-tlc: mesh-sharded{how} over {m.N} shards{mesh} on {devs}")
    t0 = time.time()
    try:
        r = ck.run(resume=args.recover)
    except (ValueError, RuntimeError) as e:
        sys.exit(f"tpu-tlc: {e}")
    return _report(r, constants, time.time() - t0, checkpoint=args.checkpoint)


def _spec_cfg(args):
    """(module, cfg path) of SPEC, a registry module name or a ``.tla``
    path: ``-config``, else the path's ``.cfg`` sibling, else
    ``specs/<module>.cfg``."""
    spec = args.spec
    module = os.path.splitext(os.path.basename(spec))[0]
    if args.config:
        return module, args.config
    if spec.endswith(".tla"):
        return module, os.path.splitext(spec)[0] + ".cfg"
    return module, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "specs", f"{module}.cfg")


def _cmd_simulate(args) -> int:
    """The ``simulate`` subcommand: SPEC as :func:`_spec_cfg` reads it."""
    module, cfg_path = _spec_cfg(args)
    model, constants, tlc_cfg = _load_model(module, cfg_path)
    invariants = _invariants(args, model, tlc_cfg)

    def header(sim):
        print(
            f"tpu-tlc: simulating {module} ({sim.B} walkers, depth "
            f"{args.depth}; invariants: {list(invariants) or 'none'})"
        )

    return _simulate(args, model, constants, invariants, args.walkers,
                     time_budget=args.time_budget, header=header)


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


def _positive_or_word(v: str):
    """``-workers``: a worker count, or the JAX CLI's word for the
    single-device engine (``gpu``; ``tpu`` is accepted too)."""
    if v in ("gpu", "tpu"):
        return v
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"-workers must be >= 1: {v}")
    return n


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


def _tel_args(p) -> None:
    """The telemetry options ``check`` and ``simulate`` share."""
    p.add_argument(
        "-telemetry", metavar="FILE",
        help="write the structured run-event stream (versioned JSONL: "
        "run header, per-level progress, per-flush fpset metrics, "
        "checkpoint frames, recovery/fault events, final result) to "
        "this file")
    p.add_argument(
        "-progress", type=float, default=None, metavar="SEC",
        help="TLC-style periodic progress line every SEC seconds "
        "(default off), reported from the last host snapshot: it adds "
        "no device syncs")


def _ckpt_args(p) -> None:
    p.add_argument("-checkpoint", default=None, metavar="PATH",
                   help="write resumable checkpoint frames to PATH "
                   "(SIGTERM/SIGINT then stops the run with a frame)")
    p.add_argument("-recover", action="store_true",
                   help="resume the run from the -checkpoint frame")


def _profile_args(p) -> None:
    p.add_argument(
        "-no-profile", dest="no_profile", action="store_true",
        help="skip tuned-profile resolution: the engine defaults and the "
        "flags given only (profiles otherwise resolve by config "
        "signature from PTT_TUNE_DIR, default ~/.ptt_profiles)")


# --------------------------------------------------------------- tune


def _tune_parser(sub) -> None:
    pt = sub.add_parser(
        "tune", help="cost-model-driven tuning: rank the knob space with "
        "the calibrated cost model, measure the top K and the defaults "
        "in turns, save the winner as a tuned profile the engines "
        "resolve by config signature")
    pt.add_argument("spec", help="registry module name (or its .tla path)")
    pt.add_argument("-config", default=None,
                    help=".cfg constant bindings (default: "
                    "specs/<spec>.cfg)")
    pt.add_argument("-invariant", action="append", default=None,
                    help="invariant the tuned runs check (repeatable; "
                    "default: the cfg's INVARIANTS; part of the key)")
    pt.add_argument("--mode", choices=("check", "simulate"),
                    default="check",
                    help="tune the device checker (default) or the "
                    "simulator's n_walkers and segment_len")
    pt.add_argument("--sim-depth", dest="sim_depth", type=int, default=64,
                    help="with --mode simulate: steps per behavior")
    pt.add_argument("--sim-steps", dest="sim_steps", type=int,
                    default=None,
                    help="with --mode simulate: the swarm-total step "
                    "budget of a measured run (default 4 rounds of 1024 "
                    "walkers)")
    pt.add_argument("--maxstates", type=int, default=1 << 22,
                    help="state budget of a measured run")
    pt.add_argument("--budget", type=float, default=None, metavar="SEC",
                    help="time budget of a measured run")
    pt.add_argument("--hbm-budget", dest="hbm_budget", default=None,
                    metavar="BYTES",
                    help="tune under a tiered-store byte budget (adds the "
                    "spill knobs to the space; the profile's key is the "
                    "tiered one)")
    pt.add_argument("--visited-cap", dest="visited_cap", type=int,
                    default=1 << 16,
                    help="initial visited-table room of a measured run")
    pt.add_argument("--frontier-cap", dest="frontier_cap", type=int,
                    default=1 << 14,
                    help="initial row-store room of a measured run")
    pt.add_argument("--sub-batch", dest="sub_batch", type=int,
                    default=None,
                    help="the base window the sub_batch candidates scale "
                    "and the defaults run at (default: the engine's "
                    "65,536; the profile then carries the winner's)")
    pt.add_argument("--top-k", dest="top_k", type=int, default=4,
                    help="candidates measured beside the defaults")
    pt.add_argument("--repeat", type=int, default=2,
                    help="interleaved repetitions a measured candidate "
                    "(min of N)")
    pt.add_argument("--candidates", type=int, default=None,
                    help="cap the enumerated space")
    pt.add_argument("--calibration", default=None, metavar="FILE",
                    help="unit costs from scripts/torch_calibrate.py "
                    "(default: the backend's fallback costs)")
    pt.add_argument("--adapt", action="store_true",
                    help="write the profile with online adaptation on")
    pt.add_argument("--stream-dir", dest="stream_dir", default=None,
                    metavar="DIR",
                    help="keep the measured runs' telemetry streams here")
    pt.add_argument("--ledger", default=None, metavar="FILE",
                    help="add every measured run to this ledger")
    pt.add_argument("-cpu", action="store_true",
                    help="run on the CPU instead of the GPU")


def _cmd_tune(args) -> int:
    """``tune``: predict, measure, persist (``tune/search.py``); prints
    the report and the profile's path."""
    import glob
    import json
    import tempfile

    from pulsar_tlaplus_tpu_torch.obs import attribution, ledger
    from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
    from pulsar_tlaplus_tpu_torch.tune import search as tune_search

    module, cfg_path = _spec_cfg(args)
    model, _constants, tlc_cfg = _load_model(module, cfg_path)
    invariants = _invariants(args, model, tlc_cfg)
    cal = None
    if args.calibration:
        try:
            cal = attribution.load_calibration(args.calibration)
        except (OSError, ValueError) as e:
            print(f"tpu-tlc: {e}", file=sys.stderr)
            return 2
    stream_dir = args.stream_dir
    if stream_dir is None and args.ledger:
        stream_dir = tempfile.mkdtemp(prefix="ptt_tune_")

    def log(msg: str) -> None:
        print(f"tpu-tlc tune: {msg}", file=sys.stderr, flush=True)

    dev = "cpu" if args.cpu else None
    try:
        if args.mode == "simulate":
            profile, rows = tune_search.tune_sim(
                model, invariants=invariants, spec_label=module,
                depth=args.sim_depth, total_steps=args.sim_steps,
                top_k=args.top_k, repeat=args.repeat, calibration=cal,
                stream_dir=stream_dir, device=dev, log=log)
        else:
            base_kw = dict(visited_cap=args.visited_cap,
                           frontier_cap=args.frontier_cap,
                           max_states=args.maxstates)
            if args.hbm_budget:
                base_kw["hbm_budget"] = args.hbm_budget
            profile, rows = tune_search.tune_device(
                model, invariants=invariants, spec_label=module,
                base_kw=base_kw, sub_batch=args.sub_batch,
                budget_s=args.budget, top_k=args.top_k,
                repeat=args.repeat, candidate_limit=args.candidates,
                calibration=cal, adapt=args.adapt, stream_dir=stream_dir,
                device=dev, log=log)
    except (ValueError, RuntimeError) as e:
        print(f"tpu-tlc: tune failed: {e}", file=sys.stderr)
        return 2
    print(tune_search.render_report(profile, rows))
    print(f"profile: {tune_profiles.path_for(profile['sig'])}")
    if args.ledger and stream_dir:
        recs = []
        for p in sorted(glob.glob(os.path.join(stream_dir,
                                               "tune_*.jsonl"))):
            try:
                recs.append(ledger.record_from_file(p))
            except (OSError, ValueError, json.JSONDecodeError):
                continue
        added = ledger.append(args.ledger, recs)
        print(f"ingested {added} measured run(s) into {args.ledger}")
    return 0


# ---------------------------------------------- checking as a service

DEFAULT_STATE_DIR = os.path.expanduser("~/.ptt_serve")


def _socket_of(args) -> str:
    """Client socket resolution: explicit --socket wins; otherwise the
    daemon's well-known location inside --state-dir."""
    if getattr(args, "socket", None):
        return args.socket
    return os.path.join(
        os.path.abspath(args.state_dir), "serve.sock"
    )


def _service_client(args):
    from pulsar_tlaplus_tpu_torch.service.client import ServiceClient

    return ServiceClient(
        _socket_of(args),
        timeout=args.timeout,
        token=getattr(args, "token", None),
        retries=getattr(args, "retries", 4),
    )


def _client_die(msg: str):
    """Transport/daemon failure: exit 2 (no verification verdict).
    Never 1 — the exit-code contract reserves 1 for violation/
    deadlock, and a CI pipeline must be able to tell "the daemon was
    down" from "the spec is broken"."""
    print(f"tpu-tlc: {msg}", file=sys.stderr)
    sys.exit(2)


def _client_fail(op: str, e) -> None:
    """Map a client-side failure to the exit-code contract on EVERY
    subcommand: 4 = auth rejected, 5 = over quota / load shed, 2 =
    transport/daemon failure — so `status` with an expired token
    reads "fix my token", not "the daemon is down"."""
    from pulsar_tlaplus_tpu_torch.service.client import (
        AdmissionRejected,
        AuthError,
        BackendUnavailable,
    )

    if isinstance(e, AuthError):
        print(f"tpu-tlc: {op} rejected (auth): {e}", file=sys.stderr)
        sys.exit(4)
    if isinstance(e, AdmissionRejected):
        print(
            f"tpu-tlc: {op} rejected ({e.code}): {e}", file=sys.stderr
        )
        sys.exit(5)
    if isinstance(e, BackendUnavailable):
        # the fleet had no healthy backend even after the retry
        # budget: transport-class (exit 2), NEVER a spec verdict
        _client_die(f"{op}: fleet has no healthy backend: {e}")
    _client_die(f"{op} failed: {e}")


def _print_job_line(j: dict) -> None:
    extra = ""
    if j.get("state") == "done" and (
        "status" in j or "distinct_states" in j or "steps" in j
    ):
        if j.get("mode") == "simulate":
            extra = (
                f"  {j.get('status', '?')} "
                f"{j.get('steps', '?')} sim steps"
            )
        else:
            extra = (
                f"  {j.get('status', '?')} "
                f"{j.get('distinct_states', '?')} states"
            )
    elif j.get("error"):
        extra = f"  {j['error'][:80]}"
    warm = ""
    if j.get("warm_mode"):
        # the reuse decision: continue / reseed with its match, or cold
        # with the typed fallback reason
        warm = f" warm={j['warm_mode']}:{j.get('warm_reason')}"
    # a fleet listing row names its owning backend (and may omit the
    # slice counters, which live on the backend, not the dispatcher)
    at = f" @{j['backend']}" if j.get("backend") else ""
    print(
        f"{j['job_id']}  {j.get('spec') or '?':<16} "
        f"{j.get('state') or '?':<10} "
        f"slices={j.get('slices', 0)} suspends={j.get('suspends', 0)}"
        f"{warm}{extra}{at}"
    )


def _service_exit(state: str, result, error) -> int:
    """Exit-code contract mirroring ``check``: 0 clean, 1 violation/
    deadlock, 2 failed/cancelled, 3 truncated (no verification
    verdict)."""
    if state == "done" and result:
        status = result.get("status")
        if status == "ok":
            return 0
        if status in ("violation", "deadlock"):
            return 1
        return 3  # truncated: NOT a verification result
    return 2


def _report_job_result(job_id: str, state: str, result, error) -> int:
    if state == "done" and result:
        status = result.get("status")
        if status in ("violation", "deadlock"):
            name = result.get("violation") or "Deadlock"
            print(f"Error: job {job_id}: {name}.")
            if result.get("trace"):
                print("The behavior up to this point is:")
                for i, (s, a) in enumerate(
                    zip(
                        result["trace"],
                        ["<init>"] + (result.get("trace_actions") or []),
                    )
                ):
                    print(f"  {i + 1}: [{a}] {s}")
        if result.get("mode") == "simulate":
            print(
                f"Simulation: {result.get('steps')} steps, "
                f"{result.get('states_visited')} states visited, "
                f"{result.get('walks')} completed walks."
            )
        else:
            print(
                f"{result.get('distinct_states')} distinct states "
                f"found, search depth (diameter) "
                f"{result.get('diameter')}."
            )
        print(
            f"Job {job_id} finished in {result.get('wall_s')}s over "
            f"{result.get('slices')} slice(s) "
            f"({result.get('suspends')} suspension(s))."
        )
        if status == "truncated":
            print(
                "WARNING: search truncated "
                f"(stop reason: {result.get('stop_reason')}) — "
                "absence of violations is inconclusive."
            )
    elif error:
        print(f"Job {job_id} FAILED: {error}")
    else:
        print(f"Job {job_id}: {state}")
    return _service_exit(state, result, error)


def _cmd_serve(args) -> int:
    """The resident daemon: prewarm, listen, serve until SIGTERM/SIGINT
    or a ``shutdown`` request (``--drain``: until the queue is idle).
    Runs on the card (slot i on cuda:i) unless ``-cpu``."""
    from pulsar_tlaplus_tpu_torch.service.scheduler import ServiceConfig
    from pulsar_tlaplus_tpu_torch.service.server import ServiceDaemon

    def log(msg: str) -> None:
        print(f"tpu-tlc serve: {msg}", file=sys.stderr, flush=True)

    state_dir = args.state_dir or args.state_pos or DEFAULT_STATE_DIR
    config = ServiceConfig(
        state_dir=os.path.abspath(state_dir),
        socket_path=args.socket or "",
        devices=args.devices,
        cpu=args.cpu,
        slice_s=args.slice,
        max_states=args.maxstates,
        checkpoint_every=args.checkpoint_every,
        keep_terminal=args.keep_terminal,
        sub_batch=args.chunk,
        specs=tuple(args.spec or ()),
        profiles="none" if args.no_profiles else "auto",
        tcp=args.tcp or "",
        tokens_path=args.tokens or "",
        queue_cap=args.queue_cap,
        tenant_max_queued=args.tenant_max_queued,
        tenant_max_running=args.tenant_max_running,
        tenant_max_states=args.tenant_max_states,
        **(
            {"warm_max_bytes": args.warm_max_bytes}
            if args.warm_max_bytes is not None
            else {}
        ),
    )
    try:
        daemon = ServiceDaemon(config, recover=args.recover, log=log)
    except (RuntimeError, ValueError) as e:  # lock held / bad tokens /
        #                                      no card for a slot
        sys.exit(f"tpu-tlc: {e}")
    if not args.no_prewarm:
        daemon.prewarm()
    try:
        daemon.start()
    except OSError as e:  # TCP bind failure (port in use, EACCES)
        daemon.shutdown()
        sys.exit(f"tpu-tlc: cannot listen: {e}")
    daemon.install_signal_handlers()
    # the ready line goes to STDOUT so wrappers/tests can block on it
    print(f"serving on {config.socket_path}", flush=True)
    if daemon.tcp_port is not None:
        print(f"serving on tcp port {daemon.tcp_port}", flush=True)
    daemon.serve_forever(drain=args.drain)
    return 0


def _cmd_dispatch(args) -> int:
    """The fleet dispatcher: poll the backends, listen, route until
    SIGTERM/SIGINT or a ``shutdown`` request.  Touches no device."""
    from pulsar_tlaplus_tpu_torch.fleet.dispatcher import (
        FleetConfig,
        FleetDispatcher,
    )

    def log(msg: str) -> None:
        print(f"tpu-tlc dispatch: {msg}", file=sys.stderr, flush=True)

    config = FleetConfig(
        state_dir=os.path.abspath(args.state_dir),
        backends=tuple(args.backend or ()),
        socket_path=args.socket or "",
        tcp=args.tcp or "",
        tokens_path=args.tokens or "",
        health_interval_s=args.health_interval,
        fail_after=args.fail_after,
        backend_timeout_s=args.backend_timeout,
        replicate=not args.no_replicate,
        recover=args.recover,
        readmit_after=args.readmit_after,
        hold_max=args.hold_max,
        hold_s=args.hold_s,
    )
    try:
        disp = FleetDispatcher(config, log=log)
    except (RuntimeError, ValueError) as e:  # lock held / bad tokens
        sys.exit(f"tpu-tlc: {e}")
    try:
        disp.start()
    except OSError as e:
        disp.shutdown()
        sys.exit(f"tpu-tlc: cannot listen: {e}")
    disp.install_signal_handlers()
    # the ready line goes to STDOUT so wrappers/tests can block on it
    print(f"dispatching on {config.socket_path}", flush=True)
    if disp.tcp_port is not None:
        print(f"dispatching on tcp port {disp.tcp_port}", flush=True)
    disp.serve_forever()
    return 0


def _cmd_submit(args) -> int:
    from pulsar_tlaplus_tpu_torch.service.client import ServiceError

    sim = None
    if args.mode == "simulate":
        sim = {
            k: v
            for k, v in (
                ("n_walkers", args.walkers),
                ("depth", args.depth),
                ("segment_len", args.segment),
                ("seed", args.sim_seed),
                ("max_steps", args.sim_steps),
            )
            if v is not None
        }
    cl = _service_client(args)
    try:
        reply = cl.submit(
            args.spec,
            os.path.abspath(args.config),
            invariants=args.invariant,
            max_states=args.maxstates,
            time_budget_s=args.time_budget,
            priority=args.priority,
            deadline_s=args.deadline_s,
            submit_id=args.submit_id,
            mode=args.mode,
            sim=sim,
            warm=not args.no_warm,
            full=True,
        )
        jid = reply["job_id"]
    except (ServiceError, OSError) as e:
        # distinct exit codes for rejected-at-the-door: 4 = bad/missing
        # token, 5 = over quota / load shed — a CI lane tells "fix my token" from
        # "back off" from "the daemon is down" (2) without parsing
        _client_fail("submit", e)
    print(jid)
    if reply.get("warm_mode"):
        # the reuse plan, up front: continue / reseed with its match, or
        # cold with the typed reason
        print(
            f"warm plan: {reply['warm_mode']} "
            f"({reply.get('warm_reason')})",
            file=sys.stderr,
        )
    if args.watch:
        return _watch_stream(cl, jid, args.timeout)
    if args.wait:
        try:
            r = cl.wait(jid, timeout=args.timeout)
        except TimeoutError as e:
            _client_die(str(e))
        return _report_job_result(
            jid, r.get("state"), r.get("result"), r.get("error")
        )
    return 0


def _cmd_status(args) -> int:
    from pulsar_tlaplus_tpu_torch.service.client import ServiceError

    cl = _service_client(args)
    try:
        if args.job_id:
            _print_job_line(cl.status(args.job_id))
        else:
            jobs = cl.status()
            if not jobs:
                print("(no jobs)")
            for j in jobs:
                _print_job_line(j)
    except (ServiceError, OSError) as e:
        _client_fail("status", e)
    return 0


def _watch_stream(cl, job_id: str, timeout: float) -> int:
    """Stream a job's relayed telemetry to stdout; returns the job's
    exit code from the terminating ``done`` message."""
    from pulsar_tlaplus_tpu_torch.service.client import ServiceError

    try:
        for msg in cl.watch(job_id, timeout_s=timeout):
            if "event" in msg:
                e = msg["event"]
                kind = e.get("event", "?")
                if kind == "level":
                    print(
                        f"[{e.get('run_id', '?')[:6]}] level "
                        f"{e.get('level')}: {e.get('distinct_states')} "
                        f"distinct, frontier {e.get('frontier')}, "
                        f"{e.get('states_per_sec')} st/s",
                        flush=True,
                    )
                elif kind in ("run_header", "result", "progress",
                              "ckpt_frame"):
                    print(
                        f"[{e.get('run_id', '?')[:6]}] {kind} "
                        + " ".join(
                            f"{k}={e[k]}"
                            for k in (
                                "resume", "distinct_states", "wall_s",
                                "frame_seq", "states_per_sec",
                            )
                            if k in e
                        ),
                        flush=True,
                    )
            elif "done" in msg:
                d = msg["done"]
                return _report_job_result(
                    job_id, d.get("state"), d.get("result"),
                    d.get("error"),
                )
            elif "error" in msg or not msg.get("ok", True):
                _client_die(f"watch: {msg.get('error')}")
    except (ServiceError, OSError) as e:
        _client_fail("watch", e)
    return 2  # stream ended without a done record


def _cmd_watch(args) -> int:
    return _watch_stream(_service_client(args), args.job_id, args.timeout)


def _cmd_cancel(args) -> int:
    from pulsar_tlaplus_tpu_torch.service.client import ServiceError

    cl = _service_client(args)
    try:
        state = cl.cancel(args.job_id)
    except (ServiceError, OSError) as e:
        _client_fail("cancel", e)
    print(f"{args.job_id}: {state}")
    return 0


# ------------------------------------------------------ stream readers

def _load_stream(path: str):
    """``(events, rc)``: a stream's events with its parse warnings
    printed, or rc 2 when it cannot be read."""
    from pulsar_tlaplus_tpu_torch.obs import report

    try:
        events, errors = report.load_events(path)
    except OSError as e:
        print(f"tpu-tlc: {e}", file=sys.stderr)
        return None, 2
    for e in errors:
        print(f"tpu-tlc: {path}: WARNING: {e}", file=sys.stderr)
    return events, 0


def _cmd_trace(args) -> int:
    """Telemetry stream(s) -> Perfetto-loadable Chrome trace JSON."""
    from pulsar_tlaplus_tpu_torch.obs import trace

    # label streams by basename stem; name collisions pull in the
    # parent directory (``jobs/*/events.jsonl``)
    stems = [os.path.splitext(os.path.basename(p))[0] for p in args.stream]

    def label(i: int) -> str:
        if stems.count(stems[i]) == 1:
            return stems[i]
        parent = os.path.basename(
            os.path.dirname(os.path.abspath(args.stream[i])))
        return f"{parent}/{stems[i]}" if parent else stems[i]

    streams = []
    for i, p in enumerate(args.stream):
        events, rc = _load_stream(p)
        if rc:
            return rc
        if not events:
            print(f"tpu-tlc: {p}: no telemetry events", file=sys.stderr)
            return 2
        streams.append((label(i), events))
    tr = trace.write_trace(streams, args.output)
    n = sum(1 for e in tr["traceEvents"] if e.get("ph") != "M")
    print(
        f"wrote {args.output}: {n} event(s) from {len(streams)} "
        "stream(s) — open in https://ui.perfetto.dev"
    )
    return 0


def _cmd_metrics(args) -> int:
    """Prometheus text metrics: scrape the daemon, or derive the same
    families from a telemetry stream tail (``--stream``)."""
    from pulsar_tlaplus_tpu_torch.obs import metrics as metrics_mod
    from pulsar_tlaplus_tpu_torch.service.client import ServiceError

    if args.stream:
        events, rc = _load_stream(args.stream)
        if rc:
            return rc
        sys.stdout.write(metrics_mod.render_stream_metrics(events))
        return 0
    cl = _service_client(args)
    try:
        sys.stdout.write(cl.metrics(aggregate=args.aggregate))
    except (ServiceError, OSError) as e:
        _client_fail("metrics", e)
    return 0


def _cmd_top(args) -> int:
    """The dashboard: poll the daemon (default) or tail telemetry
    stream(s) (``--stream``); ``--once`` renders one frame (no clear
    codes) and exits."""
    from pulsar_tlaplus_tpu_torch.obs import top as top_mod
    from pulsar_tlaplus_tpu_torch.service.client import ServiceError

    if args.stream:
        model = top_mod.TopModel(", ".join(args.stream))

        def frame():
            return top_mod.tail_stream_frame(args.stream, model)
    elif args.dispatch:
        # fleet flight deck: one dispatcher ping + one aggregate scrape
        # a frame
        cl = _service_client(args)
        fleet_model = top_mod.FleetTopModel(_socket_of(args))

        def frame():
            return top_mod.poll_dispatch_frame(cl, fleet_model)
    else:
        cl = _service_client(args)
        model = top_mod.TopModel(_socket_of(args))

        def frame():
            return top_mod.poll_daemon_frame(cl, model)
    try:
        while True:
            try:
                text = frame()
            except (ServiceError, OSError) as e:
                _client_fail("top", e)
            if args.once:
                print(text)
                return 0
            sys.stdout.write(top_mod.CLEAR + text + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        print()
        return 0


def _cmd_ledger(args) -> int:
    """The cross-run regression ledger (``obs/ledger.py``): ingest BENCH
    artifacts and telemetry streams into an append-only JSONL ledger,
    render trajectories and per-run deltas, and gate regressions."""
    import json

    from pulsar_tlaplus_tpu_torch.obs import ledger

    path = args.ledger

    def _rec_of(ref: str, recs):
        # a REF naming an existing file is ingested on the fly
        if os.path.exists(ref):
            return ledger.record_from_file(ref)
        return ledger.resolve(recs, ref)

    if args.ledger_cmd == "add":
        recs = []
        for p in args.files:
            try:
                recs.append(ledger.record_from_file(p))
            except (OSError, ValueError, json.JSONDecodeError) as e:
                print(f"tpu-tlc: {p}: {e}", file=sys.stderr)
                return 2
        added = ledger.append(path, recs)
        print(
            f"ingested {added} new record(s) of {len(recs)} into "
            f"{path} ({len(ledger.load(path))} total)"
        )
        return 0
    recs = ledger.load(path)
    if args.ledger_cmd == "list":
        print(ledger.render_list(recs, key=args.key))
        return 0
    try:
        if args.ledger_cmd == "show":
            print(ledger.render_show(_rec_of(args.ref, recs)))
            return 0
        if args.ledger_cmd == "compare":
            a = _rec_of(args.ref_a, recs)
            b = _rec_of(args.ref_b, recs)
            print(ledger.render_compare(a, b))
            return 0
        if args.ledger_cmd == "gate":
            return _ledger_gate(args, recs, _rec_of)
    except (KeyError, OSError, ValueError, json.JSONDecodeError) as e:
        # exit 2 (an input failure): for ``gate`` a malformed file must
        # never read as exit 1, "regression found"
        msg = e.args[0] if isinstance(e, KeyError) else str(e)
        print(f"tpu-tlc: {msg}", file=sys.stderr)
        return 2
    return 2


def _ledger_gate(args, recs, rec_of) -> int:
    from pulsar_tlaplus_tpu_torch.obs import ledger

    if args.current:
        cur = rec_of(args.current, recs)
    elif recs:
        cur = recs[-1]
    else:
        print("tpu-tlc: empty ledger, nothing to gate", file=sys.stderr)
        return 2
    if args.baseline:
        base = rec_of(args.baseline, recs)
    else:
        # the newest record BEFORE the current one with the same config
        # key, profile context and warm context
        cut = next((i for i, r in enumerate(recs)
                    if r.get("digest") == cur.get("digest")), len(recs))
        base = next(
            (r for r in reversed(recs[:cut])
             if r.get("key") == cur.get("key")
             and ledger.baseline_matches_profile(r, args.profile, cur)
             and ledger.baseline_matches_warm(r, cur)),
            None,
        )
        if base is None:
            print(
                "tpu-tlc: no baseline with a matching config "
                f"key, profile context ({args.profile!r}), "
                "and warm context "
                f"({ledger.warm_of(cur)!r}) in the ledger "
                "(pass --baseline REF)",
                file=sys.stderr,
            )
            return 2
    keys = tuple(args.keys) if args.keys else None
    violations = ledger.gate(base, cur, threshold=args.threshold, keys=keys)
    print(
        f"baseline {base.get('source')} "
        f"({base.get('digest', '?')[:8]}) vs current "
        f"{cur.get('source')} ({cur.get('digest', '?')[:8]})"
    )
    print(ledger.render_gate(violations))
    return 1 if violations else 0


def _add_client_args(sp) -> None:
    sp.add_argument(
        "--state-dir", default=DEFAULT_STATE_DIR,
        help="daemon state directory (socket lives at "
        "<state-dir>/serve.sock; default ~/.ptt_serve)",
    )
    sp.add_argument(
        "--socket", default=None,
        help="daemon address (overrides --state-dir): a unix socket "
        "path, or tcp://HOST:PORT for the authenticated TCP "
        "transport (pair with --token)",
    )
    sp.add_argument(
        "--token", default=None,
        help="bearer token for the TCP transport (serve --tokens; "
        "the unix socket needs none)",
    )
    sp.add_argument(
        "--retries", type=int, default=4,
        help="transport retry budget (exponential backoff + jitter "
        "on connect/transient failures; default 4)",
    )
    sp.add_argument(
        "--timeout", type=float, default=600.0,
        help="client wait/stream timeout in seconds",
    )


def _service_parsers(sub) -> None:
    """The ``serve``, ``dispatch``, ``submit``, ``status``, ``watch`` and
    ``cancel`` subcommands."""
    ps = sub.add_parser(
        "serve",
        help="resident multi-tenant checker daemon: checkers and kernels "
        "warmed for the spec registry, a FIFO job queue, and time "
        "slicing of the card between jobs",
    )
    # the JAX CLI's positional, or --state-dir as the client commands
    # spell it: one or the other
    where = ps.add_mutually_exclusive_group()
    where.add_argument(
        "state_pos", nargs="?", default=None, metavar="state_dir",
        help="daemon state directory (socket, queue.json, per-job "
        "dirs, warm artifacts; default ~/.ptt_serve)",
    )
    where.add_argument("--state-dir", dest="state_dir", default=None,
                       help="the same, as an option")
    ps.add_argument("--socket", default=None, help="override socket path")
    ps.add_argument(
        "--tcp", default=None, metavar="HOST:PORT",
        help="additionally listen on an authenticated TCP socket "
        "(port 0 = ephemeral; REQUIRES --tokens; the unix socket "
        "stays the no-auth localhost path)",
    )
    ps.add_argument(
        "--tokens", default=None, metavar="FILE",
        help="tokens.json mapping bearer tokens to tenants (validate "
        "with scripts/torch_check_telemetry_schema.py --tokens)",
    )
    ps.add_argument(
        "--queue-cap", type=int, default=64,
        help="global cap on alive jobs; past it submits are SHED "
        "with a typed capacity error (0 = unlimited; default 64)",
    )
    ps.add_argument(
        "--tenant-max-queued", type=int, default=16,
        help="per-tenant cap on queued jobs (0 = unlimited)",
    )
    ps.add_argument(
        "--tenant-max-running", type=int, default=0,
        help="per-tenant cap on jobs holding device slices "
        "(running + suspended; 0 = unlimited)",
    )
    ps.add_argument(
        "--tenant-max-states", type=int, default=0,
        help="per-tenant cap on the aggregate max_states budget of "
        "live jobs (0 = unlimited)",
    )
    ps.add_argument(
        "--spec", action="append", default=None,
        help="registry spec to prewarm at startup (repeatable; "
        "default: every spec with a default cfg in specs/)",
    )
    ps.add_argument(
        "--slice", type=float, default=2.0, metavar="SEC",
        help="scheduling quantum: a running job suspends at its next "
        "level boundary after SEC seconds when another job waits "
        "(default 2.0)",
    )
    ps.add_argument(
        "--maxstates", type=int, default=50_000_000,
        help="service state ceiling (also the per-job default budget)",
    )
    ps.add_argument(
        "--checkpoint-every", type=int, default=2,
        help="levels between a running job's frames",
    )
    ps.add_argument(
        "--keep-terminal", type=int, default=512,
        help="finished-job records retained for status/result "
        "queries; oldest beyond this are pruned from the table and "
        "disk (0 = keep forever)",
    )
    ps.add_argument(
        "-chunk", type=int, default=None, metavar="N",
        help="frontier rows a window expands (the engine's sub_batch, "
        "as given; default: the tuned profile's, else 65,536)",
    )
    ps.add_argument(
        "--no-prewarm", action="store_true",
        help="skip startup prewarm (the first submit per spec builds "
        "its checker)",
    )
    ps.add_argument(
        "--warm-max-bytes", type=int, default=None, metavar="BYTES",
        help="LRU byte cap on the warm-artifact store (default 1 GiB; "
        "0 disables the warm layer — no artifacts, every submit runs "
        "cold)",
    )
    ps.add_argument(
        "--no-profiles", action="store_true",
        help="skip tuned-profile resolution when building pooled "
        "checkers",
    )
    ps.add_argument(
        "--recover", action="store_true",
        help="reload queue.json and resume/re-run interrupted jobs "
        "(after SIGTERM or a crash)",
    )
    ps.add_argument(
        "--drain", action="store_true",
        help="exit once the queue is idle (with --recover: complete "
        "the persisted queue, then stop)",
    )
    ps.add_argument("-cpu", action="store_true",
                    help="run the daemon on the CPU instead of the GPU")
    ps.add_argument(
        "--devices", type=int, default=1, metavar="N",
        help="local device slots the scheduler runs jobs on at once "
        "(slot i on cuda:i; more than the cards present is refused; "
        "default 1)",
    )

    pd = sub.add_parser(
        "dispatch",
        help="fleet dispatcher: front N `serve` daemons behind one "
        "authenticated endpoint speaking the same wire protocol — "
        "load-signal routing, warm-artifact replication, failover",
    )
    pd.add_argument(
        "state_dir", nargs="?",
        default=os.path.expanduser("~/.ptt_fleet"),
        help="dispatcher state directory (socket, fleet_jobs.json; "
        "default ~/.ptt_fleet)",
    )
    pd.add_argument(
        "--backend", action="append", default=None, metavar="ADDR",
        help="backend daemon address (repeatable; a unix socket path "
        "or tcp://HOST:PORT — TCP backends need a tokens.json entry "
        "for the 'fleet' tenant)",
    )
    pd.add_argument(
        "--socket", default=None, help="override dispatcher socket path"
    )
    pd.add_argument(
        "--tcp", default=None, metavar="HOST:PORT",
        help="additionally listen on an authenticated TCP socket "
        "(port 0 = ephemeral; REQUIRES --tokens)",
    )
    pd.add_argument(
        "--tokens", default=None, metavar="FILE",
        help="tokens.json shared with the backends (client tokens "
        "are forwarded; the 'fleet' entry is the dispatcher's own "
        "identity)",
    )
    pd.add_argument(
        "--health-interval", type=float, default=0.5, metavar="SEC",
        help="backend health-poll period (default 0.5s)",
    )
    pd.add_argument(
        "--fail-after", type=int, default=3, metavar="N",
        help="consecutive failed polls before a backend is drained "
        "from routing (default 3)",
    )
    pd.add_argument(
        "--backend-timeout", type=float, default=10.0, metavar="SEC",
        help="per-request timeout toward a backend (default 10s)",
    )
    pd.add_argument(
        "--no-replicate", action="store_true",
        help="disable warm-artifact replication between backends "
        "(jobs still route and fail over; resubmits only warm-start "
        "on their original backend)",
    )
    pd.add_argument(
        "--recover", action="store_true",
        help="rebuild the routing table from fleet_jobs.json + a "
        "re-poll of every backend before accepting work (after a "
        "crash or kill -9): acked jobs resolve exactly-once, "
        "unconfirmed jobs on reachable backends are typed 'lost'",
    )
    pd.add_argument(
        "--readmit-after", type=int, default=2, metavar="N",
        help="consecutive clean polls before a drained backend "
        "rejoins routing (default 2 — hysteresis so a flapping "
        "backend cannot thrash failover)",
    )
    pd.add_argument(
        "--hold-max", type=int, default=16, metavar="N",
        help="submits held waiting for a backend while the whole "
        "fleet is down (overflow sheds with a typed 'capacity' "
        "rejection; default 16)",
    )
    pd.add_argument(
        "--hold-s", type=float, default=10.0, metavar="SEC",
        help="how long a held submit waits for a backend to rejoin "
        "before the typed backend_unavailable rejection (default 10s)",
    )

    pj = sub.add_parser(
        "submit", help="queue a check job on the running daemon"
    )
    pj.add_argument("spec", help="registry spec name (e.g. compaction)")
    pj.add_argument("config", help=".cfg constant bindings")
    pj.add_argument(
        "-invariant", action="append", default=None,
        help="invariant to check (repeatable; default: cfg INVARIANTS)",
    )
    pj.add_argument("--maxstates", type=int, default=None)
    pj.add_argument(
        "--time-budget", type=float, default=None, metavar="SEC",
        help="cumulative engine-wall budget across scheduling slices",
    )
    pj.add_argument(
        "--mode", choices=["check", "simulate"], default="check",
        help="workload: exhaustive BFS (default) or the streaming "
        "walker swarm (simulation jobs time-slice at segment "
        "boundaries)",
    )
    pj.add_argument("--walkers", type=int, default=None,
                    help="with --mode simulate: walker swarm width")
    pj.add_argument("--depth", type=int, default=None,
                    help="with --mode simulate: steps per behavior")
    pj.add_argument("--segment", type=int, default=None,
                    help="with --mode simulate: steps per device dispatch")
    pj.add_argument(
        "--sim-seed", dest="sim_seed", type=int, default=None,
        help="with --mode simulate: walk seed (deterministic stream)",
    )
    pj.add_argument(
        "--sim-steps", dest="sim_steps", type=int, default=None,
        help="with --mode simulate: total step budget across the "
        "swarm (default: one depth-round)",
    )
    pj.add_argument(
        "--priority", type=int, default=0, metavar="N",
        help="scheduling priority (higher first; a waiting higher-"
        "priority job preempts a running lower one at its next "
        "level boundary; clamped to [-9, 9] at the daemon; default 0)",
    )
    pj.add_argument(
        "--deadline-s", type=float, default=None, metavar="SEC",
        help="wall-clock deadline from submit; past it the job is "
        "cancelled with stop_reason=deadline (exit 3, no verdict)",
    )
    pj.add_argument(
        "--no-warm", action="store_true",
        help="opt this job out of warm-start reuse AND artifact "
        "harvesting: always a full cold recheck",
    )
    pj.add_argument(
        "--submit-id", default=None, metavar="ID",
        help="idempotency key: a retried submit with the same id "
        "returns the SAME job instead of enqueueing twice "
        "(auto-generated when omitted)",
    )
    pj.add_argument(
        "--wait", action="store_true",
        help="block until the job finishes; exit code mirrors `check`",
    )
    pj.add_argument(
        "--watch", action="store_true",
        help="stream the job's relayed telemetry until it finishes",
    )
    _add_client_args(pj)
    pst = sub.add_parser(
        "status", help="job table (or one job) from the daemon"
    )
    pst.add_argument("job_id", nargs="?", default=None)
    _add_client_args(pst)
    pw = sub.add_parser(
        "watch", help="stream a job's telemetry (level progress, "
        "heartbeat, per-slice run headers) until it finishes",
    )
    pw.add_argument("job_id")
    _add_client_args(pw)
    pca = sub.add_parser("cancel", help="cancel a queued/running job")
    pca.add_argument("job_id")
    _add_client_args(pca)


def _reader_parsers(sub) -> None:
    """The ``trace``, ``metrics``, ``top`` and ``ledger`` subcommands."""
    ptr = sub.add_parser(
        "trace",
        help="convert telemetry stream(s) into Perfetto-loadable Chrome "
        "trace JSON: BFS levels, frame stalls, sweep chunks, daemon job "
        "slices and fleet hops on one timeline",
    )
    ptr.add_argument("stream", nargs="+", help="telemetry JSONL file(s)")
    ptr.add_argument("-o", "--output", default="trace.json",
                     help="output trace file (default trace.json)")
    pm = sub.add_parser(
        "metrics",
        help="Prometheus text metrics: scrape the live daemon's `metrics` "
        "verb, or derive the same families from a stream tail (--stream)",
    )
    pm.add_argument("--stream", default=None, metavar="FILE",
                    help="derive metrics from this telemetry JSONL")
    pm.add_argument("--aggregate", action="store_true",
                    help="fleet mode: against a dispatcher, scrape every "
                    "live backend too, re-emitted under a `backend` "
                    "label beside the fleet rollups")
    _add_client_args(pm)
    pt = sub.add_parser(
        "top",
        help="dashboard: job table, rate sparklines, status line — "
        "polling the daemon or tailing stream(s) (--stream)",
    )
    pt.add_argument("--stream", action="append", default=None,
                    metavar="FILE",
                    help="tail telemetry JSONL file(s) (repeatable)")
    pt.add_argument("--interval", type=float, default=2.0, metavar="SEC",
                    help="refresh interval (default 2s)")
    pt.add_argument("--once", action="store_true",
                    help="render one frame (no ANSI clear) and exit")
    pt.add_argument("--dispatch", action="store_true",
                    help="fleet flight deck: poll a dispatcher (backend "
                    "table, routing scores, fleet latency quantiles)")
    _add_client_args(pt)
    pl = sub.add_parser(
        "ledger",
        help="cross-run regression ledger: ingest BENCH_*.json artifacts "
        "and telemetry streams into an append-only JSONL ledger, render "
        "trajectories and deltas, gate regressions",
    )
    pl.add_argument("--ledger", default="LEDGER.jsonl", metavar="FILE",
                    help="ledger file (append-only JSONL; default "
                    "./LEDGER.jsonl)")
    lsub = pl.add_subparsers(dest="ledger_cmd", required=True)
    pla = lsub.add_parser("add",
                          help="ingest artifacts/streams (idempotent by "
                          "digest)")
    pla.add_argument("files", nargs="+",
                     help="BENCH_*.json artifacts and/or telemetry "
                     ".jsonl streams")
    pll = lsub.add_parser("list",
                          help="trajectory table of every ledger record")
    pll.add_argument("--key", default=None,
                     help="only records with this config key")
    pls = lsub.add_parser("show", help="every key of one record")
    pls.add_argument("ref", help="digest prefix, source name, 1-based "
                     "index, or a file path (ingested on the fly)")
    plc = lsub.add_parser("compare",
                          help="per-key delta table between two runs")
    plc.add_argument("ref_a", help="baseline record REF (or file path)")
    plc.add_argument("ref_b", help="current record REF (or file path)")
    plg = lsub.add_parser(
        "gate",
        help="exit 1 when the current run regresses past the threshold "
        "vs its baseline (same config key by default)",
    )
    plg.add_argument("--current", default=None,
                     help="current record REF or file path (default: "
                     "newest ledger record)")
    plg.add_argument("--baseline", default=None,
                     help="baseline record REF or file path (default: "
                     "newest earlier record with the same config key)")
    plg.add_argument("--threshold", type=float, default=0.1, metavar="REL",
                     help="relative regression tolerance (default 0.10 = "
                     "10%%)")
    plg.add_argument("--keys", nargs="*", default=None,
                     help="gated keys (default: every known gate key)")
    plg.add_argument("--profile", default="same", metavar="CTX",
                     help="baseline profile context: same (default), "
                     "none, any, or a profile-sig prefix")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu-tlc-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("check", help="exhaustive BFS model checking")
    pc.add_argument("spec", help="the .tla module to check (or a registry "
                    "module name: specs/<name>.cfg by default)")
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
    _ckpt_args(pc)
    pc.add_argument(
        "-workers", type=_positive_or_word, default="gpu",
        help="'gpu' (default: the single-device engine) or a worker "
        "count N (TLC parity: maps to '-sharded N', capped at the cards "
        "present, or at N under -cpu)",
    )
    pc.add_argument("-sharded", type=int, default=0, metavar="N",
                    help="run mesh-sharded over N shards (several may "
                    "share a card)")
    pc.add_argument("-slices", type=int, default=1, metavar="S",
                    help="with -sharded: arrange the N shards as S slices "
                    "(2-D dcn x ici mesh, keys routed owner slice first)")
    pc.add_argument("-sharded-engine", dest="sharded_engine",
                    choices=("device", "host"), default="device",
                    help="device (default): the device-resident sharded "
                    "engine; host: the host-staged driver (needed for "
                    "-sharded-dedup hash)")
    pc.add_argument("-sharded-dedup", dest="sharded_dedup",
                    choices=("sort", "hash"), default="sort",
                    help="the host-staged driver's visited set: sorted "
                    "columns (default) or a hash table")
    pc.add_argument("-visited", choices=("fpset", "sort"), default="fpset",
                    help="the device engines' visited set: fpset (the "
                    "hash table, default) or sort (the sort-merge flush, "
                    "for differential runs; runs the stage loop)")
    pc.add_argument("-compact", choices=("logshift", "sort"),
                    default=None,
                    help="the device engines' stream compaction: logshift "
                    "(prefix sum, default unless a tuned profile sets it) "
                    "or sort (a stable sort)")
    pc.add_argument("-engine", choices=("device", "host"), default="device",
                    help="the non-sharded engine: device (default) or host "
                    "(the host-driver engine: hash dedup, the state log "
                    "on the host)")
    pc.add_argument("-chunk", type=int, default=None, metavar="N",
                    help="frontier rows a window (device engines) or a "
                    "chunk (host engines, default 4096) expands")
    pc.add_argument("-metrics", default=None, metavar="FILE",
                    help="append per-level JSONL metrics to FILE")
    _tel_args(pc)
    pc.add_argument(
        "-xprof", metavar="DIR",
        help="write a torch.profiler Chrome trace of the -xprof-levels "
        "window of the single-device engine into DIR")
    pc.add_argument(
        "-xprof-levels", metavar="LO:HI", default=None,
        help="BFS level window for -xprof (e.g. 6:7; default: the whole "
        "run)")
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
    _profile_args(pc)
    pc.add_argument(
        "-adapt", action="store_true",
        help="online adaptation: a controller at the fused level's pass "
        "boundaries moves the ramp cap and the probe schedule from what "
        "each pass's read brought back (a telemetry 'tune' record a "
        "move; the states found and their order are unchanged)")
    pc.add_argument(
        "-no-adapt", dest="no_adapt", action="store_true",
        help="online adaptation off even where the tuned profile turns "
        "it on (PTT_TUNE_ADAPT=0 is the environment's equivalent)")

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
    ps.add_argument("-walkers", type=int, default=None, metavar="N",
                    help="walker swarm width (default: the tuned "
                    "profile's, else 1024)")
    _sim_args(ps)
    ps.add_argument("-time-budget", dest="time_budget", type=float,
                    default=None, metavar="SEC", help="wall-clock budget")
    ps.add_argument("-cpu", action="store_true",
                    help="run on the CPU instead of the GPU")
    _ckpt_args(ps)
    _tel_args(ps)
    _profile_args(ps)
    _tune_parser(sub)
    _service_parsers(sub)
    _reader_parsers(sub)
    args = p.parse_args(argv)
    readers = {"trace": _cmd_trace, "metrics": _cmd_metrics,
               "top": _cmd_top, "ledger": _cmd_ledger, "tune": _cmd_tune,
               "serve": _cmd_serve, "dispatch": _cmd_dispatch,
               "submit": _cmd_submit,
               "status": _cmd_status, "watch": _cmd_watch,
               "cancel": _cmd_cancel}
    if args.cmd in readers:
        return readers[args.cmd](args)
    if args.cmd == "simulate":
        return _cmd_simulate(args)
    args.xprof_window = None
    if args.xprof_levels:
        from pulsar_tlaplus_tpu_torch.obs.telemetry import parse_level_window

        try:
            args.xprof_window = parse_level_window(args.xprof_levels)
        except ValueError as e:
            sys.exit(f"tpu-tlc: -xprof-levels: {e}")
    return _check(args)


if __name__ == "__main__":
    sys.exit(main())
