"""The port's liveness checker (``engine/liveness.py``) against the JAX
package's ``LivenessChecker`` and the port's oracle
``ref/pyeval.check_eventually``, on the CPU:

- ``Termination`` on ``producer_on``, ``two_crashes`` and
  ``consumer_on`` (the JAX liveness tests' cases) under ``none`` and
  ``wf_next``: verdict, reason and lasso equal the JAX engine's, the
  verdict equals the oracle's;
- the edge list ``(src, dst, out_deg)`` array-equal to the JAX engine's
  at sweep groups 1 and 3 over several sweep chunks;
- a ``max_run`` too small for a chunk's equal-key runs fails loudly in
  both engines;
- a tiered exploration at a tight ``hbm_budget`` (rows spilled to the
  host) gives the same edges;
- ``Termination`` of subscription, bookkeeper and georeplication at
  their shipped cfgs, in both fairness modes.

Tolerance: exact equality (integer work, gid lists)."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.liveness import LivenessChecker as JLive
from pulsar_tlaplus_tpu.models import registry as jregistry
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.utils import cfg as jcfg
from pulsar_tlaplus_tpu_torch.engine.device_bfs import HBM_HEADROOM
from pulsar_tlaplus_tpu_torch.engine.liveness import LivenessChecker
from pulsar_tlaplus_tpu_torch.models import registry
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.utils import cfg as tcfg
from tests.helpers import SMALL_CONFIGS

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")

CASES = {
    "producer_on": SMALL_CONFIGS["producer_on"],
    "two_crashes": SMALL_CONFIGS["two_crashes"],
    # the stub consumer never advances consumeTimes: the goal is
    # unreachable and the Consumer self-loop is a fair not-goal cycle
    "consumer_on": dataclasses.replace(
        SMALL_CONFIGS["producer_on"], model_consumer=True
    ),
}
FAIRNESS = ("none", "wf_next")
# a sweep chunk of 256 states: several chunks per run
KW = dict(frontier_chunk=256, visited_cap=1 << 12, sweep_chunk=256)


def _port(c, **kw):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


def _verdict(r):
    return (r.holds, r.reason, r.lasso_prefix, r.lasso_cycle,
            r.distinct_states)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX engine's verdicts per fairness and its edge list."""
    lc = JLive(JModel(CASES[name]), fairness="wf_next", **KW)
    got = {}
    for fairness in ("wf_next", "none"):
        lc.fairness = fairness
        got[fairness] = _verdict(lc.run())
    return got, tuple(np.asarray(a) for a in lc._edge_cache)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fairness", FAIRNESS)
def test_verdict_equals_jax_and_oracle(name, fairness):
    c = CASES[name]
    r = LivenessChecker(_port(c), fairness=fairness, device="cpu",
                        **KW).run()
    assert _verdict(r) == _jax(name)[0][fairness]
    want, _reason = tpe.check_eventually(
        tpe.Constants(**dataclasses.asdict(c)), fairness
    )
    assert r.holds == want


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("group", [1, 3])
def test_edges_equal_jax(name, group):
    lc = LivenessChecker(_port(CASES[name]), fairness="wf_next",
                         sweep_group=group, device="cpu", **KW)
    lc.run()
    st = lc.last_stats
    assert st["sweep_chunks"] > 3 and st["sweep_group"] == group
    src, dst, out_deg = lc._edge_cache
    jsrc, jdst, jdeg = _jax(name)[1]
    assert np.array_equal(src, jsrc)
    assert np.array_equal(dst, jdst)
    assert np.array_equal(out_deg, jdeg)
    assert out_deg.sum() == len(src) == st["edges"]


def test_max_run_overflow_fails_loudly_in_both():
    c = CASES["producer_on"]
    with pytest.raises(RuntimeError, match="could not resolve"):
        JLive(JModel(c), fairness="wf_next", max_run=1, **KW).run()
    with pytest.raises(RuntimeError, match="could not resolve"):
        LivenessChecker(_port(c), fairness="wf_next", max_run=1,
                        device="cpu", **KW).run()


def test_tiered_exploration_gives_the_same_edges():
    c = CASES["two_crashes"]
    probe = LivenessChecker(_port(c), hbm_budget="1T", device="cpu", **KW)
    ck = probe._checker
    est = ck._device_bytes_est(ck.TCAP0, ck.WCAP0, ck.WCAP0)
    budget = int(est / (1.0 - HBM_HEADROOM)) + 4096
    lc = LivenessChecker(_port(c), fairness="wf_next", hbm_budget=budget,
                         device="cpu", **KW)
    r = lc.run()
    assert lc._checker.tiered and lc._checker._row_base > 0
    assert lc._checker.last_stats["spill_evictions"] >= 1
    assert _verdict(r) == _jax("two_crashes")[0]["wf_next"]
    for got, want in zip(lc._edge_cache, _jax("two_crashes")[1]):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("spec", ["subscription", "bookkeeper",
                                  "georeplication"])
def test_other_specs_termination_equals_jax(spec):
    cfg = os.path.join(SPECS, f"{spec}.cfg")
    jm, _ = jregistry.COMPILED[spec](jcfg.load(cfg))
    tm, _ = registry.COMPILED[spec](tcfg.load(cfg))
    jl = JLive(jm, fairness="wf_next", frontier_chunk=512,
               visited_cap=1 << 13)
    tl = LivenessChecker(tm, fairness="wf_next", frontier_chunk=512,
                         visited_cap=1 << 13, device="cpu")
    for fairness in ("wf_next", "none"):
        jl.fairness = tl.fairness = fairness
        assert _verdict(tl.run()) == _verdict(jl.run()), fairness
    for got, want in zip(tl._edge_cache, jl._edge_cache):
        assert np.array_equal(got, np.asarray(want))


def test_unknown_goal_and_fairness_raise():
    m = _port(CASES["producer_on"])
    with pytest.raises(ValueError, match="unknown liveness property"):
        LivenessChecker(m, goal="NoSuchGoal", device="cpu")
    with pytest.raises(ValueError, match="unknown fairness"):
        LivenessChecker(m, fairness="sf_next", device="cpu")
