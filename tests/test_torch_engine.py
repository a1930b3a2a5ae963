"""The port's engine and CLI on the CPU: the oracle counts, the JAX
engine's discovery order state for state, the published bug
counterexamples, and the no-GPU behavior of the entry points.
Tolerance: exact equality."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from tests.helpers import SMALL_CONFIGS, assert_valid_counterexample

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "compaction.tla")
CFG = os.path.join(ROOT, "specs", "compaction.cfg")


def _model(c):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


def _state(s):
    """A port oracle state as the JAX package's oracle state."""
    return pe.State(*s)


def test_shipped_cfg_state_for_state_with_jax():
    """45,198 states, diameter 20, and rows, parent log, lane log and
    level sizes equal to the JAX ``DeviceChecker``'s — with different
    window sizes on the two sides (discovery order does not depend on
    them)."""
    jck = JChecker(
        JModel(pe.SHIPPED_CFG), sub_batch=2048, visited_cap=1 << 16,
        frontier_cap=1 << 15,
    )
    jr = jck.run()
    ck = DeviceChecker(
        _model(pe.SHIPPED_CFG), sub_batch=700, visited_cap=1 << 11,
        device="cpu",
    )
    r = ck.run()
    assert (r.distinct_states, r.diameter) == (45198, 20)
    assert r.violation is None and not r.deadlock and not r.truncated
    assert r.level_sizes == jr.level_sizes
    nv, W = r.distinct_states, ck.W
    assert np.array_equal(
        ck.last_bufs["rows"][: nv * W].numpy().view(np.uint32),
        np.asarray(jck.last_bufs["rows"][: nv * W]),
    )
    for log in ("parent", "lane"):
        assert np.array_equal(
            ck.last_bufs[log][:nv].numpy(),
            np.asarray(jck.last_bufs[log][:nv]),
        ), log


# the JAX engine's pinned verdicts (tests/test_tiles.py BUG_ORACLE_PINS)
BUGS = {
    "CompactedLedgerLeak": (23329, 12),
    "DuplicateNullKeyMessage": (3645, 4),
}


@pytest.mark.parametrize("invariant", sorted(BUGS))
def test_bug_counterexamples(invariant):
    """Both published counterexamples: the JAX engine's violating gid,
    the oracle's depth, and a trace that replays step by step."""
    gid, depth = BUGS[invariant]
    r = DeviceChecker(
        _model(pe.SHIPPED_CFG), invariants=(invariant,), sub_batch=512,
        device="cpu",
    ).run()
    assert r.violation == invariant
    assert r.violation_gid == gid
    assert r.diameter == depth and len(r.trace) == depth
    assert_valid_counterexample(
        pe.SHIPPED_CFG, [_state(s) for s in r.trace], r.trace_actions,
        invariant,
    )


@pytest.mark.parametrize("name", sorted(SMALL_CONFIGS))
def test_small_configs_match_oracle(name):
    c = SMALL_CONFIGS[name]
    want = pe.check(c)
    r = DeviceChecker(
        _model(c), sub_batch=1024, visited_cap=1 << 6, device="cpu"
    ).run()
    assert r.distinct_states == want.distinct_states
    assert r.diameter == want.diameter
    assert r.violation == want.violation and not r.deadlock


def test_max_states_truncates():
    r = DeviceChecker(
        _model(pe.SHIPPED_CFG), sub_batch=256, max_states=5000,
        device="cpu",
    ).run()
    assert r.truncated and r.stop_reason == "max_states"
    assert r.distinct_states >= 5000
    assert r.level_sizes[:3] == [729, 1458, 1458]


class _NoStutter(CompactionModel):
    """The model with the stuttering disjuncts taken away, so that the
    spec's terminal states become deadlocks."""

    def stutter_enabled(self, s):
        return torch.zeros_like(s.length, dtype=torch.bool)


class _JNoStutter(JModel):
    def stutter_enabled(self, s):
        return jnp.bool_(False)


def test_deadlock_matches_jax():
    """Deadlock detection: the same deadlocked gid and diameter as the
    JAX engine, and a trace ending in a state with no non-stuttering
    successor."""
    c = SMALL_CONFIGS["two_crashes"]
    jr = JChecker(
        _JNoStutter(c), sub_batch=64, visited_cap=1 << 10,
        frontier_cap=1 << 10,
    ).run()
    r = DeviceChecker(
        _NoStutter(tpe.Constants(**dataclasses.asdict(c))), sub_batch=64,
        device="cpu",
    ).run()
    assert r.deadlock and jr.deadlock
    assert r.violation == "Deadlock"
    assert (r.violation_gid, r.diameter) == (jr.violation_gid, jr.diameter)
    last = _state(r.trace[-1])
    assert all(t == last for _a, t in pe.successors(c, last))


def test_entry_points_raise_without_gpu(monkeypatch):
    """With no GPU the checker and the CLI refuse to run unless the CPU
    was asked for — never a silent fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceChecker(_model(pe.SHIPPED_CFG))
    with pytest.raises(SystemExit) as e:
        cli.main(["check", SPEC, "-config", CFG])
    assert "no CUDA device" in str(e.value.code)


def test_cli_check_on_cpu(capsys):
    rc = cli.main(["check", SPEC, "-config", CFG, "-cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "45198 distinct states found" in out
    assert "search depth (diameter) 20" in out


def test_cli_reports_counterexample(capsys):
    rc = cli.main([
        "check", SPEC, "-config", CFG, "-cpu",
        "-invariant", "DuplicateNullKeyMessage",
    ])
    out = capsys.readouterr().out
    assert rc == 1
    assert "Error: Invariant DuplicateNullKeyMessage is violated." in out
    assert "State 4: <CompactorPhaseTwoUpdateContext>" in out
