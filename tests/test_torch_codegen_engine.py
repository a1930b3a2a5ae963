"""The port's engines on compiled models (``frontend/codegen.py``)
against the JAX package's engines on its ``CompiledSpec``, on the CPU:

- the port's ``DeviceChecker`` on the compiled subscription and
  bookkeeper models finds the JAX ``DeviceChecker``'s states in its
  order (level sizes, rows, parent and lane logs), in both loops;
- both compaction counterexamples equal the JAX compiled path's (gid,
  depth, trace and actions);
- a poisoned invariant gives ``__EvalError__`` and the JAX trace;
- liveness and simulation on compiled models (the JAX
  ``LivenessChecker``'s verdicts and edges; both seeded bugs found).

The CLI's routing: ``tests/test_torch_codegen_cli.py``.

The JAX reference runs use its stage loop (it compiles less and finds
the same states in the same order).  vmap's "performance drop" warning
is an error here.  Tolerance: exact equality (integer work)."""

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.frontend import codegen as jcg
from pulsar_tlaplus_tpu.frontend import interp as JI
from pulsar_tlaplus_tpu.frontend.parser import parse_module as j_parse_module
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.frontend import codegen as tcg
from pulsar_tlaplus_tpu_torch.frontend import interp as TI
from pulsar_tlaplus_tpu_torch.frontend.parser import (
    parse_module as t_parse_module,
)
from tests.test_torch_codegen import _bind, _invariants

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")


@pytest.fixture(scope="module")
def runs():
    """(JAX checker + result, port compiled model) per spec, made once."""
    cache = {}

    def get(spec):
        if spec not in cache:
            js, ts = _bind(spec, {})
            inv = _invariants(spec)
            jcs = jcg.CompiledSpec(js, invariants=inv)
            cache[spec] = (*_jax_run(jcs),
                           tcg.CompiledSpec(ts, invariants=inv,
                                            device="cpu"))
        return cache[spec]

    return get


def _jax_run(jcs, **kw):
    # the JAX walk resolves UNCHANGED through the interpreter's global
    # definition registry: point it at this spec
    JI.install_defs(jcs.spec)
    ck = JChecker(jcs, sub_batch=256, visited_cap=1 << 12,
                  frontier_cap=1 << 12, fuse="stage", **kw)
    return ck, ck.run()


@pytest.mark.parametrize("fuse", ["level", "stage"])
@pytest.mark.parametrize("spec", ["subscription", "bookkeeper"])
def test_engine_state_for_state_with_jax(spec, fuse, runs):
    """The port's checker on the compiled model finds the JAX checker's
    states (on the JAX compiled model) in its order: level sizes, rows,
    parent and lane logs."""
    jck, jr, tcs = runs(spec)
    ck = DeviceChecker(tcs, sub_batch=100, visited_cap=1 << 10,
                       device="cpu", fuse=fuse)
    r = ck.run()
    assert r.violation is None and not r.deadlock and not r.truncated
    assert r.level_sizes == jr.level_sizes
    nv = r.distinct_states
    assert nv == jr.distinct_states
    assert np.array_equal(ck.merged_rows(),
                          np.asarray(jck.last_bufs["rows"][: nv * ck.W]))
    par, lan = ck.merged_logs()
    assert np.array_equal(par, np.asarray(jck.last_bufs["parent"][:nv]))
    assert np.array_equal(lan, np.asarray(jck.last_bufs["lane"][:nv]))


@pytest.mark.parametrize("inv,depth", [("CompactedLedgerLeak", 12),
                                       ("DuplicateNullKeyMessage", 4)])
def test_compaction_counterexample_equals_jax(inv, depth):
    """Both seeded compaction bugs on the compiled path: the JAX compiled
    path's gid, depth and trace (states and actions)."""
    js, ts = _bind("compaction", {})
    JI.install_defs(js)
    jr = JChecker(jcg.CompiledSpec(js, invariants=(inv,)), sub_batch=1024,
                  visited_cap=1 << 16, frontier_cap=1 << 14,
                  fuse="stage").run()
    r = DeviceChecker(tcg.CompiledSpec(ts, invariants=(inv,), device="cpu"),
                      sub_batch=1024, device="cpu").run()
    assert r.violation == jr.violation == inv
    assert r.violation_gid == jr.violation_gid
    assert r.diameter == jr.diameter == depth == len(r.trace)
    assert r.trace == jr.trace
    assert r.trace_actions == jr.trace_actions


POISON_TLA = """---- MODULE poisoninv ----
EXTENDS Naturals, Sequences
VARIABLES x
Init == x = 0
Next == x < 2 /\\ x' = x + 1
BadInv == <<5, 6>>[x] > 0
====
"""


def test_invariant_poison_reports_eval_error_as_jax():
    """An invariant whose evaluation errors (an out-of-domain index) is
    an evaluation error, ``__EvalError__``, not a violation of the
    invariant (tests/test_codegen.py:166), with JAX's trace."""
    jcs = jcg.CompiledSpec(JI.Spec(j_parse_module(POISON_TLA), {}),
                           invariants=("BadInv",))
    jr = JChecker(jcs, sub_batch=8, visited_cap=1 << 10,
                  frontier_cap=1 << 10, fuse="stage").run()
    tcs = tcg.CompiledSpec(TI.Spec(t_parse_module(POISON_TLA), {}),
                           invariants=("BadInv",), device="cpu")
    r = DeviceChecker(tcs, sub_batch=8, visited_cap=1 << 10,
                      device="cpu").run()
    assert r.violation == jr.violation == "__EvalError__"
    assert r.violation_gid == jr.violation_gid
    assert r.trace == jr.trace
    assert r.trace_actions == jr.trace_actions




@pytest.mark.parametrize("fairness", ["wf_next", "none"])
def test_liveness_on_compiled_model_equals_jax(fairness):
    """``Termination`` on the compiled subscription model: the JAX
    ``LivenessChecker``'s verdict, reason, lasso and edge list (on the
    JAX compiled model)."""
    from pulsar_tlaplus_tpu.engine.liveness import LivenessChecker as JLive
    from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker

    js, ts = _bind("subscription", {})
    JI.install_defs(js)
    jl = JLive(jcg.CompiledSpec(js), goal="Termination", fairness=fairness,
               frontier_chunk=512, visited_cap=1 << 13)
    jr = jl.run()
    tl = LivenessChecker(tcg.CompiledSpec(ts, device="cpu"),
                         goal="Termination", fairness=fairness,
                         frontier_chunk=512, device="cpu")
    r = tl.run()
    assert (r.holds, r.reason, r.distinct_states) == (
        jr.holds, jr.reason, jr.distinct_states)
    assert (r.lasso_prefix, r.lasso_cycle) == (jr.lasso_prefix,
                                               jr.lasso_cycle)
    # (no fairness: the stuttering verdict needs no edges)
    assert (tl._edge_cache is None) == (jl._edge_cache is None)
    for a, b in zip(tl._edge_cache or (), jl._edge_cache or ()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("inv", ["CompactedLedgerLeak",
                                 "DuplicateNullKeyMessage"])
def test_simulation_finds_seeded_bugs_on_compiled_model(inv):
    """The simulator on compiled compaction.tla finds both seeded bugs,
    with a trace it re-verifies step by step through ``successors``."""
    from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator

    _js, ts = _bind("compaction", {})
    cs = tcg.CompiledSpec(ts, invariants=(inv,), device="cpu")
    r = StreamingSimulator(cs, invariants=(inv,), n_walkers=1024, depth=64,
                           seed=0, max_rounds=20, device="cpu").run()
    assert r.violation == inv and r.stop_reason == "violation"
    assert r.verified is True
    assert len(r.trace) == len(r.trace_actions) + 1
    assert set(r.trace_actions) <= set(cs.action_names)
