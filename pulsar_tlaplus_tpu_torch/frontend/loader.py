"""Bind a parsed TLC ``.cfg`` to a parsed module for the generic
interpreter / codegen: model values intern to :class:`~.interp.MV`,
ordinary constants pass through.

Also provides the compaction-specific bridge from the engine's
``pyeval.Constants`` (used by differential tests and the CLI, which
canonicalizes key/value spaces to ``1..n`` via :mod:`..utils.cfg`).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict

from pulsar_tlaplus_tpu_torch.frontend import tla_ast as A
from pulsar_tlaplus_tpu_torch.frontend.interp import MV, Spec
from pulsar_tlaplus_tpu_torch.utils.cfg import TLCConfig

def reference_spec_path(module: str = "compaction") -> str:
    """The ``.tla`` module file of ``module`` in this repo's ``specs/``."""
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(repo_root, "specs", f"{module}.tla")


COMPACTION_MODEL_VALUES = (
    "Nil",
    "Compactor_In_PhaseOne",
    "Compactor_In_PhaseTwoWrite",
    "Compactor_In_PhaseTwoUpdateContext",
    "Compactor_In_PhaseTwoUpdateHorizon",
    "Compactor_In_PhaseTwoPersistCusror",
    "Compactor_In_PhaseTwoDeleteLedger",
)


def bind_cfg(
    module: A.Module, cfg: TLCConfig, intern_strings: bool = True
) -> Dict[str, object]:
    """cfg bindings -> interpreter constants dict for `module`.

    String-set constants are interned to ``1..n`` (sorted order) when
    ``intern_strings`` — resolving the reference's cfg/ASSUME discrepancy
    (compaction.cfg:7 binds strings; compaction.tla:29 ASSUMEs
    ``SUBSET Nat``; SURVEY.md §1-L4).  The mapping is recorded under the
    ``"__string_interning__"`` key for trace rendering.
    """
    out: Dict[str, object] = {}
    interned: Dict[str, Dict[str, int]] = {}
    for name in module.constants:
        if name in cfg.model_values:
            out[name] = MV(name)
        elif name in cfg.constants:
            v = cfg.constants[name]
            if (
                intern_strings
                and isinstance(v, frozenset)
                and v
                and all(isinstance(x, str) for x in v)
            ):
                mapping = {s: i for i, s in enumerate(sorted(v), 1)}
                warnings.warn(
                    f"{name}: interning string elements {sorted(v)} to "
                    f"1..{len(v)} (cfg/ASSUME discrepancy, SURVEY.md §1-L4)"
                )
                interned[name] = mapping
                v = frozenset(mapping.values())
            out[name] = v
        else:
            raise ValueError(f"cfg binds no CONSTANT {name}")
    out["__string_interning__"] = interned
    return out


_PHASE_BY_MV = {
    "Compactor_In_PhaseOne": 0,
    "Compactor_In_PhaseTwoWrite": 1,
    "Compactor_In_PhaseTwoUpdateContext": 2,
    "Compactor_In_PhaseTwoUpdateHorizon": 3,
    "Compactor_In_PhaseTwoPersistCusror": 4,
    "Compactor_In_PhaseTwoDeleteLedger": 5,
}


def compaction_pystate(state: tuple):
    """Generic-interpreter state tuple (compaction var order) ->
    ``pyeval.State`` for differential testing / trace rendering."""
    from pulsar_tlaplus_tpu_torch.ref import pyeval as pe

    (msgs, ledgers, cursor, cstate, p1, horizon, context, crash, consume) = state

    def rec(r):
        return (r["id"], r["key"], r["value"])

    nil = MV("Nil")
    messages = tuple(rec(r) for r in msgs)
    led = tuple(
        None if l == nil else tuple(rec(r) for r in l) for l in ledgers
    )
    cur = (
        None
        if cursor == nil
        else (cursor["compactionHorizon"], cursor["compactedTopicContext"])
    )
    if p1 == nil:
        p1v = None
    else:
        lfk = p1["latestForKey"]
        items = (
            tuple(enumerate(lfk, 1)) if isinstance(lfk, tuple) else lfk.items
        )
        p1v = (p1["readPosition"], tuple(items))
    return pe.State(
        messages=messages,
        ledgers=led,
        cursor=cur,
        cstate=_PHASE_BY_MV[cstate.name],
        p1=p1v,
        horizon=horizon,
        context=context,
        crash=crash,
        consume=consume,
    )


def compaction_constants(c) -> Dict[str, object]:
    """pyeval.Constants -> interpreter constants for the compaction module
    (key/value spaces canonicalized to 1..n, reference compaction.cfg:2-20)."""
    d: Dict[str, object] = {
        "MessageSentLimit": c.message_sent_limit,
        "CompactionTimesLimit": c.compaction_times_limit,
        "ModelConsumer": c.model_consumer,
        "ConsumeTimesLimit": c.consume_times_limit,
        "KeySpace": frozenset(range(1, c.num_keys + 1)),
        "ValueSpace": frozenset(range(1, c.num_values + 1)),
        "RetainNullKey": c.retain_null_key,
        "MaxCrashTimes": c.max_crash_times,
        "ModelProducer": c.model_producer,
    }
    for mv in COMPACTION_MODEL_VALUES:
        d[mv] = MV(mv)
    return d
