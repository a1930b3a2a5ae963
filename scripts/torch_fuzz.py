#!/usr/bin/env python
"""Differential fuzz harness of the PyTorch port: randomized .cfg
constant bindings, device engine vs interpreter.

For each of the four registered specs, seeded-randomly sample small
constant bindings from the declared axes (the same draws as the JAX
package's ``scripts/fuzz.py`` for the same seed), then run the SAME
binding through two independent implementations and cross-check:

- the **device engine** (``engine/device_bfs.DeviceChecker``: the
  hand-written batched model on the card, or on the CPU with ``--cpu``),
  and
- the **interpreter**: the pure-Python reference evaluator for
  compaction (``ref/pyeval.py``), the generic TLA+ interpreter over the
  spec's own ``.tla`` source for the other three
  (``engine/interp_check.InterpChecker``).

Checked per binding: distinct-state count, diameter, verdict (violation
name / deadlock / clean), violation-trace length, and the device
engine's counterexample REPLAYED state for state through the
interpreter's transition relation: every claimed action must be a real
interpreter successor producing the same rendered state, the invariant
must hold until the final state and fail on it.

``--widen`` switches to the WARM RESEED differential: per spec, sample a
base binding, run it cold to completion, harvest a warm artifact
(``warm/store.py``), then WIDEN one declared-monotone axis
(``models/registry.MONOTONE_AXES``) and cross-check the warm-reseeded
run against an independent cold run at the widened binding: clean runs
must agree on the exact reachable STATE SET (sorted packed rows, not
just counts), verdict runs must both find a verdict and the warm
counterexample must replay through the interpreter.  A planner REFUSAL
(the widening stepped the counter field's bit length ->
``layout_change``) must carry that typed reason: the planner wrongly
reseeding is a failure, the planner refusing soundly is not.

Usage:

    python scripts/torch_fuzz.py --seed 7 --per-spec 3            # sweep
    python scripts/torch_fuzz.py --seed 0 --per-spec 1 --spec compaction
    python scripts/torch_fuzz.py --seed 0 --per-spec 5 --widen    # reseed
    python scripts/torch_fuzz.py --seed 7 --per-spec 3 --cpu      # no card

The device engine runs on the card unless ``--cpu`` (``device="cpu"``)
is given; without a card it raises ("no CUDA device").  Exit status:
0 = every binding agreed, 1 = mismatches (listed on stderr as JSON),
2 = usage.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
from typing import Dict, List, Optional, Tuple

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_DIR = os.path.join(ROOT, "specs")

SPECS = ("compaction", "bookkeeper", "georeplication", "subscription")

# engine geometry for every fuzz point: small caps, growth exercised
DEVICE_KW = dict(
    sub_batch=256, visited_cap=1 << 12, frontier_cap=1 << 10,
    max_states=1 << 18,
)
# interpreter BFS is pure Python: bindings are sampled small enough
# that this cap never binds on a correct implementation
INTERP_MAX_STATES = 200_000


# ------------------------------------------------------ binding axes


def sample_binding(spec: str, rng: random.Random):
    """One randomized constants object for ``spec`` (small shapes: every
    axis value keeps the interpreter BFS in the seconds range)."""
    if spec == "compaction":
        from pulsar_tlaplus_tpu_torch.ref.pyeval import Constants

        producer = rng.random() < 0.7
        return Constants(
            message_sent_limit=rng.randint(1, 2 if not producer else 3),
            compaction_times_limit=rng.randint(1, 3),
            num_keys=rng.randint(1, 2),
            num_values=rng.randint(1, 2),
            retain_null_key=rng.random() < 0.5,
            max_crash_times=rng.randint(0, 2),
            model_producer=producer,
            model_consumer=False,
        )
    if spec == "bookkeeper":
        from pulsar_tlaplus_tpu_torch.models.bookkeeper import (
            BookkeeperConstants,
        )

        e = rng.randint(2, 3)
        qw = rng.randint(1, e)
        return BookkeeperConstants(
            num_bookies=e,
            write_quorum=qw,
            ack_quorum=rng.randint(1, qw),
            entry_limit=rng.randint(1, 2),
            max_bookie_crashes=rng.randint(0, 2),
        )
    if spec == "georeplication":
        from pulsar_tlaplus_tpu_torch.models.georeplication import (
            GeoConstants,
        )

        return GeoConstants(
            num_clusters=2,
            publish_limit=rng.randint(1, 2),
            max_replicator_crashes=rng.randint(0, 1),
        )
    if spec == "subscription":
        from pulsar_tlaplus_tpu_torch.models.subscription import (
            SubscriptionConstants,
        )

        return SubscriptionConstants(
            message_limit=rng.randint(1, 3),
            max_crash_times=rng.randint(0, 2),
        )
    raise ValueError(f"unknown spec {spec!r}")


def _model_of(spec: str, constants):
    from pulsar_tlaplus_tpu_torch.models import bookkeeper as bk
    from pulsar_tlaplus_tpu_torch.models import georeplication as geo
    from pulsar_tlaplus_tpu_torch.models import subscription as subm
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel

    return {
        "compaction": CompactionModel,
        "bookkeeper": bk.BookkeeperModel,
        "georeplication": geo.GeoreplicationModel,
        "subscription": subm.SubscriptionModel,
    }[spec](constants)


def _interp_constants(spec: str, c) -> Dict[str, int]:
    """Constants object -> the .tla CONSTANT bindings (the registry's
    inverse mapping)."""
    if spec == "bookkeeper":
        return {
            "NumBookies": c.num_bookies,
            "WriteQuorum": c.write_quorum,
            "AckQuorum": c.ack_quorum,
            "EntryLimit": c.entry_limit,
            "MaxBookieCrashes": c.max_bookie_crashes,
        }
    if spec == "georeplication":
        return {
            "NumClusters": c.num_clusters,
            "PublishLimit": c.publish_limit,
            "MaxReplicatorCrashes": c.max_replicator_crashes,
        }
    if spec == "subscription":
        return {
            "MessageLimit": c.message_limit,
            "MaxCrashTimes": c.max_crash_times,
        }
    raise ValueError(spec)


def _state_fields(spec: str, model, t: tuple) -> tuple:
    """An interpreter state tuple (VARIABLES order) -> the model's state
    fields as numpy arrays (``model.from_jax_state`` takes them)."""
    import numpy as np

    def mask(n, ids):
        v = np.zeros((n,), np.int32)
        for i in ids:
            v[i - 1] = 1
        return v

    if spec == "bookkeeper":
        added, stored, acked, lac, crashed = t
        return (added, np.stack([mask(model.L, es) for es in stored]),
                np.stack([mask(model.E, bs) for bs in acked]), lac,
                mask(model.E, crashed))
    if spec == "georeplication":
        pub, hwm, cur, ack, dup, crash = t
        n = model.N
        dmat = np.stack([np.stack([mask(model.P, dup[d][sr])
                                   for sr in range(n)]) for d in range(n)])
        return (np.asarray(pub), np.asarray(hwm), np.asarray(cur),
                np.asarray(ack), dmat, crash)
    if spec == "subscription":
        produced, delivered, pending, acked, mark, ever, dup, crash = t
        m = model.M
        return (produced, mask(m, delivered), mask(m, pending),
                mask(m, acked), mark, mask(m, ever), mask(m, dup), crash)
    raise ValueError(spec)


_MODULES: Dict[str, object] = {}


def _parsed_module(spec: str):
    mod = _MODULES.get(spec)
    if mod is None:
        from pulsar_tlaplus_tpu_torch.frontend.parser import parse_file

        mod = parse_file(os.path.join(SPEC_DIR, f"{spec}.tla"))
        _MODULES[spec] = mod
    return mod


# ------------------------------------------------------- the two runs


def device_result(spec: str, constants, invariants, device=None):
    """The binding on the port's device engine: on the card unless
    ``device`` names another (``"cpu"``); raises with no card."""
    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker

    model = _model_of(spec, constants)
    return DeviceChecker(
        model,
        invariants=invariants,
        # pyeval has no deadlock analysis, so the compaction
        # cross-check compares pure invariant semantics
        check_deadlock=(spec != "compaction"),
        device=device,
        **DEVICE_KW,
    ).run()


def interp_result(spec: str, constants, invariants):
    """(result, replayer): the replayer re-walks a device trace through
    THIS interpreter's transition relation and returns what is wrong
    with it, or None."""
    if spec == "compaction":
        from pulsar_tlaplus_tpu_torch.ref import pyeval as pe

        res = pe.check(
            constants, invariants=invariants,
            max_states=INTERP_MAX_STATES,
        )

        def replay(trace, actions, invariant) -> Optional[str]:
            inits = set(pe.initial_states(constants))
            if not trace or trace[0] not in inits:
                return "trace does not start at an initial state"
            inv = pe.INVARIANTS[invariant]
            for s, act, t in zip(trace, actions, trace[1:]):
                succ = {}
                for a, st in pe.successors(constants, s):
                    succ.setdefault(pe.ACTION_NAMES[a], []).append(st)
                if t not in succ.get(act, []):
                    return f"step {act!r} is not an interpreter successor"
                if not inv(constants, s):
                    return "invariant fails before the final state"
            if inv(constants, trace[-1]):
                return "invariant holds on the final state"
            return None

        return res, replay

    from pulsar_tlaplus_tpu_torch.engine.interp_check import InterpChecker
    from pulsar_tlaplus_tpu_torch.frontend.interp import Spec, install_defs

    spec_obj = Spec(
        _parsed_module(spec), _interp_constants(spec, constants)
    )
    res = InterpChecker(
        spec_obj, invariants=invariants,
        max_states=INTERP_MAX_STATES,
    ).run()
    model = _model_of(spec, constants)
    install_defs(spec_obj)

    def rendered(t):
        # device trace states are the model's rendered states: render
        # interpreter states the same way
        return model.to_pystate(
            model.from_jax_state(_state_fields(spec, model, t)))

    def replay(trace, actions, invariant) -> Optional[str]:
        if not trace:
            return "trace does not start at an initial state"
        cur = None
        for s0 in spec_obj.initial_states():
            if rendered(s0) == trace[0]:
                cur = s0
                break
        if cur is None:
            return "trace does not start at an initial state"
        for act, want in zip(actions, trace[1:]):
            if not spec_obj.eval_predicate(invariant, cur):
                return "invariant fails before the final state"
            nxt = [
                t
                for lab, t in spec_obj.successors(cur)
                if lab == act and rendered(t) == want
            ]
            if not nxt:
                return f"step {act!r} is not an interpreter successor"
            cur = nxt[0]
        if spec_obj.eval_predicate(invariant, cur):
            return "invariant holds on the final state"
        return None

    return res, replay


def device_summary(rd) -> Dict[str, object]:
    """The fields of a device run that a record keeps."""
    return {
        "distinct_states": rd.distinct_states,
        "diameter": rd.diameter,
        "violation": rd.violation,
        "deadlock": bool(rd.deadlock),
        "trace_len": len(rd.trace) if rd.trace else None,
    }


def fuzz_one(spec: str, constants, device=None) -> Dict[str, object]:
    """One binding through both implementations; returns the record
    (``mismatches`` empty = agreement)."""
    model = _model_of(spec, constants)
    invariants = tuple(model.default_invariants)
    binding = (
        dataclasses.asdict(constants)
        if dataclasses.is_dataclass(constants)
        else repr(constants)
    )
    rec: Dict[str, object] = {
        "spec": spec,
        "binding": binding,
        "invariants": list(invariants),
    }
    mism: List[str] = []
    rd = device_result(spec, constants, invariants, device=device)
    ri, replay = interp_result(spec, constants, invariants)
    rec["device"] = device_summary(rd)
    rec["interp"] = {
        "distinct_states": ri.distinct_states,
        "diameter": ri.diameter,
        "violation": ri.violation,
        "deadlock": bool(getattr(ri, "deadlock", False)),
        "trace_len": len(ri.trace) if ri.trace else None,
    }
    if rd.violation != ri.violation:
        mism.append(
            f"verdict: device={rd.violation!r} interp={ri.violation!r}"
        )
    if spec != "compaction" and bool(rd.deadlock) != bool(
        getattr(ri, "deadlock", False)
    ):
        mism.append(
            f"deadlock: device={rd.deadlock} "
            f"interp={getattr(ri, 'deadlock', False)}"
        )
    if rd.violation is None and ri.violation is None and not rd.deadlock:
        # clean runs must agree exactly on the explored space
        if rd.distinct_states != ri.distinct_states:
            mism.append(
                f"distinct_states: device={rd.distinct_states} "
                f"interp={ri.distinct_states}"
            )
        if rd.diameter != ri.diameter:
            mism.append(
                f"diameter: device={rd.diameter} interp={ri.diameter}"
            )
    if rd.violation and ri.violation and rd.violation == ri.violation:
        # both found it: shortest traces must be the same LENGTH (the
        # states may differ: BFS ties), and the device counterexample
        # must replay state for state through the interpreter
        if rd.trace is not None and ri.trace is not None and (
            len(rd.trace) != len(ri.trace)
        ):
            mism.append(
                f"trace length: device={len(rd.trace)} "
                f"interp={len(ri.trace)}"
            )
        if rd.trace is not None:
            err = replay(rd.trace, rd.trace_actions, rd.violation)
            if err:
                mism.append(f"device trace replay: {err}")
    rec["mismatches"] = mism
    return rec


def _stderr_log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(
    seed: int,
    per_spec: int,
    specs: Tuple[str, ...] = SPECS,
    log=None,
    device=None,
) -> Tuple[List[Dict], List[Dict]]:
    """The sweep: ``per_spec`` sampled bindings per spec, one shared
    seeded RNG (the whole sweep replays from ``--seed``).  Returns
    (all records, failing records)."""
    _log = log or _stderr_log
    rng = random.Random(seed)
    records: List[Dict] = []
    for spec in specs:
        done = 0
        while done < per_spec:
            try:
                constants = sample_binding(spec, rng)
                if hasattr(constants, "validate"):
                    constants.validate()
            except ValueError:
                continue  # invalid corner of the axes: resample
            rec = fuzz_one(spec, constants, device=device)
            records.append(rec)
            done += 1
            _log(
                f"fuzz {spec} #{done}: "
                f"{rec['device']['distinct_states']} states, "
                f"verdict={rec['device']['violation'] or 'clean'}"
                + (
                    f"  MISMATCH: {rec['mismatches']}"
                    if rec["mismatches"]
                    else ""
                )
            )
    failures = [r for r in records if r["mismatches"]]
    return records, failures


# --------------------------------------------- warm-reseed differential

# constants-dataclass field of each declared-monotone axis (the registry
# axes name cfg constants and packed-state fields; the samplers build
# the models' constants objects)
AXIS_FIELDS = {
    ("compaction", "MaxCrashTimes"): "max_crash_times",
    ("subscription", "MaxCrashTimes"): "max_crash_times",
    ("bookkeeper", "MaxBookieCrashes"): "max_bookie_crashes",
    ("georeplication", "MaxReplicatorCrashes"):
        "max_replicator_crashes",
}


def _cfg_constants(spec: str, c) -> Dict[str, object]:
    """Constants object -> the cfg-level CONSTANT bindings the warm
    manifests carry (the registry's inverse mapping; compaction's
    model-value sets included)."""
    if spec == "compaction":
        return {
            "MessageSentLimit": c.message_sent_limit,
            "CompactionTimesLimit": c.compaction_times_limit,
            "KeySpace": frozenset(range(1, c.num_keys + 1)),
            "ValueSpace": frozenset(range(1, c.num_values + 1)),
            "RetainNullKey": c.retain_null_key,
            "MaxCrashTimes": c.max_crash_times,
            "ModelProducer": c.model_producer,
            "ModelConsumer": c.model_consumer,
        }
    return _interp_constants(spec, c)


def _rows_set(ck, n: int):
    """The run's reachable state set as sorted packed rows (exact: the
    warm-vs-cold clean-run equality is SET equality, not count
    equality)."""
    import numpy as np

    rows = ck.merged_rows()[: n * ck.W].reshape(n, ck.W)
    return rows[np.lexsort(rows.T[::-1])]


def widen_one(
    spec: str, rng: random.Random, scratch: str, device=None
) -> Dict[str, object]:
    """One warm-reseed differential point: base cold run -> artifact
    -> widened plan -> (reseeded run vs cold run) or an asserted sound
    refusal."""
    import numpy as np

    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
    from pulsar_tlaplus_tpu_torch.models import registry
    from pulsar_tlaplus_tpu_torch.ops.packing import bitlen
    from pulsar_tlaplus_tpu_torch.warm import plan as warm_plan
    from pulsar_tlaplus_tpu_torch.warm import store as warm_store

    axes = registry.MONOTONE_AXES.get(spec, ())
    rec: Dict[str, object] = {"spec": spec, "mode": "widen"}
    mism: List[str] = []
    if not axes:
        rec["skipped"] = "no declared monotone axis"
        rec["mismatches"] = []
        return rec
    kw = dict(DEVICE_KW, device=device)
    check_deadlock = spec != "compaction"

    for _attempt in range(50):
        constants = sample_binding(spec, rng)
        axis = axes[rng.randrange(len(axes))]
        field = AXIS_FIELDS[(spec, axis.constant)]
        old_val = int(getattr(constants, field))
        # prefer a bitlen-preserving widening (it exercises the real
        # reseed path); every ~4th point keeps a random delta so the
        # sound-refusal branch (layout_change) stays covered too
        deltas = [1, 2]
        rng.shuffle(deltas)
        if rng.random() < 0.75:
            deltas.sort(
                key=lambda dd: bitlen(old_val + dd) != bitlen(old_val)
            )
        new_val = old_val + deltas[0]
        try:
            constants.validate()
            new_constants = dataclasses.replace(
                constants, **{field: new_val}
            )
            new_constants.validate()
        except (ValueError, TypeError):
            continue
        break
    else:
        rec["skipped"] = "no valid widening sampled"
        rec["mismatches"] = []
        return rec
    rec["binding"] = dataclasses.asdict(constants)
    rec["widened"] = {axis.constant: [old_val, new_val]}
    model_old = _model_of(spec, constants)
    model_new = _model_of(spec, new_constants)
    invariants = tuple(model_old.default_invariants)
    os.makedirs(scratch, exist_ok=True)
    frame = os.path.join(scratch, "frame.npz")
    ck_base = DeviceChecker(
        model_old, invariants=invariants,
        check_deadlock=check_deadlock, checkpoint_path=frame, **kw,
    )
    ck_base.final_frame = True
    r_base = ck_base.run()
    rec["base"] = {
        "distinct_states": r_base.distinct_states,
        "violation": r_base.violation,
        "deadlock": bool(r_base.deadlock),
    }
    if r_base.violation or r_base.deadlock or r_base.truncated:
        # the daemon only harvests clean/truncated-clean runs; a
        # verdict at the base binding is not a reseed scenario
        rec["skipped"] = "base run has a verdict"
        rec["mismatches"] = []
        return rec
    store = warm_store.WarmStore(os.path.join(scratch, "warm"))
    man = warm_plan.manifest_for(
        spec, _cfg_constants(spec, constants), invariants, ck_base,
        {
            "distinct_states": int(r_base.distinct_states),
            "levels": len(r_base.level_sizes),
            "truncated": False,
            "stop_reason": r_base.stop_reason,
        },
    )
    if store.save(frame, man) is None:
        rec["mismatches"] = ["artifact save failed"]
        return rec
    ck_new = DeviceChecker(
        model_new, invariants=invariants,
        check_deadlock=check_deadlock, **kw,
    )
    plan = warm_plan.plan(
        store,
        spec=spec,
        constants=_cfg_constants(spec, new_constants),
        invariants=invariants,
        config_sig=ck_new._config_sig(),
        module_digest=registry.module_digest(spec),
        lsig=warm_plan.layout_sig(model_new),
        n_initial=int(model_new.n_initial),
        max_states=int(kw["max_states"]),
        check_deadlock=check_deadlock,
    )
    rec["plan"] = {"mode": plan.mode, "reason": plan.reason}
    if plan.mode != "reseed":
        # a refusal must be the SOUND one: the only legitimate cause
        # of a refused pure-axis widening is a bitlen step on the
        # counter field (layout_change)
        stepped = (
            warm_plan.layout_sig(model_new)
            != warm_plan.layout_sig(model_old)
        )
        if plan.mode == "cold" and stepped and (
            plan.reason == warm_plan.REASON_LAYOUT_CHANGE
        ):
            rec["skipped"] = (
                f"sound refusal: bitlen({old_val})="
                f"{bitlen(old_val)} -> bitlen({new_val})="
                f"{bitlen(new_val)}"
            )
        else:
            mism.append(
                f"planner refused a valid widening: {plan.mode}/"
                f"{plan.reason} (layout stepped: {stepped})"
            )
        rec["mismatches"] = mism
        return rec
    ok, why = store.verify(plan.artifact)
    if not ok:
        rec["mismatches"] = [f"artifact failed verify: {why}"]
        return rec
    seed, info = warm_plan.build_reseed_seed(
        plan.artifact, plan.manifest, model_new, plan.widened
    )
    rec["reseed"] = info
    # merged seed levels no longer bound the parent-chain depth
    ck_new.extra_trace_depth = len(r_base.level_sizes)
    r_warm = ck_new.run(seed=seed)
    ck_cold = DeviceChecker(
        model_new, invariants=invariants,
        check_deadlock=check_deadlock, **kw,
    )
    r_cold = ck_cold.run()
    rec["warm"] = {
        "distinct_states": r_warm.distinct_states,
        "violation": r_warm.violation,
        "deadlock": bool(r_warm.deadlock),
    }
    rec["cold"] = {
        "distinct_states": r_cold.distinct_states,
        "violation": r_cold.violation,
        "deadlock": bool(r_cold.deadlock),
    }
    warm_verdict = bool(r_warm.violation or r_warm.deadlock)
    cold_verdict = bool(r_cold.violation or r_cold.deadlock)
    if warm_verdict != cold_verdict:
        mism.append(
            f"verdict class: warm={r_warm.violation or r_warm.deadlock}"
            f" cold={r_cold.violation or r_cold.deadlock}"
        )
    elif not cold_verdict:
        # clean runs: the reachable SETS must be identical
        if r_warm.distinct_states != r_cold.distinct_states:
            mism.append(
                f"distinct_states: warm={r_warm.distinct_states} "
                f"cold={r_cold.distinct_states}"
            )
        else:
            sw = _rows_set(ck_new, r_warm.distinct_states)
            sc = _rows_set(ck_cold, r_cold.distinct_states)
            if not np.array_equal(sw, sc):
                mism.append("reachable state SETS differ")
    elif r_warm.violation and r_warm.trace is not None:
        # the warm counterexample must be REAL: replay it through the
        # independent interpreter at the widened binding
        _ri, replay = interp_result(spec, new_constants, invariants)
        err = replay(
            r_warm.trace, r_warm.trace_actions, r_warm.violation
        )
        if err:
            mism.append(f"warm trace replay: {err}")
    rec["mismatches"] = mism
    return rec


def run_widen(
    seed: int,
    per_spec: int,
    specs: Tuple[str, ...] = SPECS,
    log=None,
    device=None,
) -> Tuple[List[Dict], List[Dict]]:
    """The --widen sweep: ``per_spec`` reseed differentials per spec
    from one seeded RNG (replayable from --seed)."""
    import shutil
    import tempfile

    _log = log or _stderr_log
    rng = random.Random(seed)
    records: List[Dict] = []
    for spec in specs:
        for k in range(per_spec):
            scratch = tempfile.mkdtemp(prefix=f"ptt_widen_{spec}_")
            try:
                rec = widen_one(spec, rng, scratch, device=device)
            finally:
                shutil.rmtree(scratch, ignore_errors=True)
            records.append(rec)
            _log(
                f"widen {spec} #{k + 1}: "
                + (
                    f"skipped ({rec['skipped']})"
                    if rec.get("skipped")
                    else f"{rec.get('plan', {}).get('mode')} "
                    f"warm={rec.get('warm', {}).get('distinct_states')}"
                    f" cold={rec.get('cold', {}).get('distinct_states')}"
                )
                + (
                    f"  MISMATCH: {rec['mismatches']}"
                    if rec["mismatches"]
                    else ""
                )
            )
    failures = [r for r in records if r["mismatches"]]
    return records, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="differential fuzz: randomized constant bindings, "
        "the port's device engine vs the interpreter, over the four "
        "registered specs"
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--per-spec", type=int, default=3,
        help="sampled bindings per spec (default 3)",
    )
    ap.add_argument(
        "--spec", action="append", default=None,
        help=f"restrict to this spec (repeatable; known: {SPECS})",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="print every record as JSON on stdout",
    )
    ap.add_argument(
        "--widen", action="store_true",
        help="warm-reseed differential: randomized constant WIDENINGS "
        "on the declared-monotone axes, warm-vs-cold state-set equality",
    )
    ap.add_argument(
        "--cpu", action="store_true",
        help="run the device engine on the CPU instead of the card",
    )
    args = ap.parse_args(argv)
    specs = tuple(args.spec) if args.spec else SPECS
    unknown = [s for s in specs if s not in SPECS]
    if unknown:
        ap.error(f"unknown spec(s) {unknown} (known: {SPECS})")
    from pulsar_tlaplus_tpu_torch.utils.device import resolve

    try:
        device = resolve("cpu" if args.cpu else None)
    except RuntimeError as e:
        ap.error(str(e))
    sweep = run_widen if args.widen else run
    records, failures = sweep(args.seed, args.per_spec, specs,
                              device=device)
    if args.json:
        print(json.dumps(records, default=str))
    for f in failures:
        print(json.dumps(f, default=str), file=sys.stderr)
    print(
        f"{len(records)} binding(s), {len(failures)} mismatch(es)",
        file=sys.stderr,
    )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
