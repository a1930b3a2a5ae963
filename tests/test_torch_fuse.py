"""The port's fused level (``fuse="level"``, the default) on the CPU —
the counterpart of ``tests/test_fuse.py``.

- level against stage, state for state (level sizes, rows, parent and
  lane logs), with and without mid-level growth;
- level against the JAX ``DeviceChecker(fuse="level")`` at the same
  window size, state for state;
- both bug oracles and the ``max_states`` truncation in level mode;
- the sync-count gate: on ``producer_on`` (1,654 states, 16 levels) the
  port pins its exact ``host_syncs`` and ``fuse_levels``: a ramp sync
  closes at least 4 levels, and a steady-state level without growth
  costs exactly one sync.

Tolerance: exact equality throughout."""

import dataclasses
import os

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


def _mk(c, fuse="level", sub_batch=256, **kw):
    kw.setdefault("visited_cap", 1 << 12)
    return DeviceChecker(
        CompactionModel(tpe.Constants(**dataclasses.asdict(c))),
        invariants=kw.pop("invariants", ()), sub_batch=sub_batch,
        fuse=fuse, device="cpu", **kw,
    )


def _logs(ck, nv):
    """Rows, parent and lane logs of the first ``nv`` states as numpy."""
    return [
        np.asarray(ck.last_bufs[k][: nv * (ck.W if k == "rows" else 1)])
        .view(np.int32)
        for k in ("rows", "parent", "lane")
    ]


def _assert_same_run(r_a, ck_a, r_b, ck_b):
    assert r_a.distinct_states == r_b.distinct_states
    assert r_a.level_sizes == r_b.level_sizes
    nv = r_a.distinct_states
    for name, a, b in zip(("rows", "parent", "lane"), _logs(ck_a, nv),
                          _logs(ck_b, nv)):
        assert np.array_equal(a, b), name


# ---- state for state ------------------------------------------------


@pytest.mark.parametrize(
    "name,sub_batch,visited_cap,fuse_group",
    [
        ("producer_on", 256, 1 << 12, None),
        ("two_crashes", 256, 1 << 12, None),
        # tiny tiers: growth syncs mid-level and inside ramp batches
        ("producer_on", 16, 1 << 6, 2),
        ("two_crashes", 48, 1 << 6, None),
    ],
)
def test_level_vs_stage_state_for_state(name, sub_batch, visited_cap,
                                        fuse_group):
    c = SMALL_CONFIGS[name]
    ck_l = _mk(c, sub_batch=sub_batch, visited_cap=visited_cap,
               fuse_group=fuse_group)
    ck_s = _mk(c, "stage", sub_batch=sub_batch, visited_cap=visited_cap)
    r_l, r_s = ck_l.run(), ck_s.run()
    assert r_l.distinct_states == pe.check(c, invariants=()).distinct_states
    _assert_same_run(r_l, ck_l, r_s, ck_s)
    assert ck_l.last_stats["fpset_valid_lanes"] == (
        ck_s.last_stats["fpset_valid_lanes"]
    )
    assert ck_l.last_stats["host_syncs"] < ck_s.last_stats["host_syncs"]


@pytest.mark.parametrize("name", ["producer_on", "two_crashes"])
def test_level_vs_jax_fused_state_for_state(name):
    """The JAX engine's fused level at the same window size: level
    sizes, rows, parent and lane logs."""
    c = SMALL_CONFIGS[name]
    jck = JChecker(JModel(c), invariants=(), sub_batch=256,
                   visited_cap=1 << 12, frontier_cap=1 << 12, fuse="level")
    jr = jck.run()
    ck = _mk(c)
    r = ck.run()
    assert jck.fuse == ck.fuse == "level"
    assert (r.distinct_states, r.level_sizes) == (
        jr.distinct_states, jr.level_sizes
    )
    nv, W = r.distinct_states, ck.W
    got = _logs(ck, nv)
    want = [np.asarray(jck.last_bufs["rows"][: nv * W]).view(np.int32)] + [
        np.asarray(jck.last_bufs[k][:nv]) for k in ("parent", "lane")
    ]
    for name_, a, b in zip(("rows", "parent", "lane"), got, want):
        assert np.array_equal(a, b), name_
    assert ck.last_stats["fuse_levels"] == jck.last_stats["fuse_levels"]


# ---- verdicts ---------------------------------------------------------


@pytest.mark.parametrize(
    "invariant,gid,depth,sub_batch,visited_cap",
    [
        ("CompactedLedgerLeak", 23329, 12, 2048, 1 << 16),
        ("DuplicateNullKeyMessage", 3645, 4, 2048, 1 << 16),
        # tiny tiers: growth syncs inside levels, where a stop may land
        ("CompactedLedgerLeak", 23329, 12, 96, 1 << 6),
    ],
)
def test_level_bug_oracles(invariant, gid, depth, sub_batch, visited_cap):
    """Both published counterexamples in level mode: the JAX engine's
    violating gid, the stage loop's trace, and a trace that replays."""
    kw = dict(invariants=(invariant,), sub_batch=sub_batch,
              visited_cap=visited_cap)
    r_l = _mk(pe.SHIPPED_CFG, **kw).run()
    r_s = _mk(pe.SHIPPED_CFG, "stage", **kw).run()
    assert r_l.violation == r_s.violation == invariant
    assert r_l.violation_gid == r_s.violation_gid == gid
    assert r_l.diameter == r_s.diameter == depth
    assert r_l.trace == r_s.trace
    assert r_l.trace_actions == r_s.trace_actions
    assert_valid_counterexample(
        pe.SHIPPED_CFG, [pe.State(*s) for s in r_l.trace],
        r_l.trace_actions, invariant,
    )


def test_level_max_states_equals_jax():
    """``max_states`` truncation: the JAX fused engine's state count and
    level sizes, and the stage loop's."""
    jr = JChecker(JModel(pe.SHIPPED_CFG), sub_batch=256,
                  visited_cap=1 << 12, frontier_cap=1 << 12,
                  max_states=5000, fuse="level").run()
    ck = _mk(pe.SHIPPED_CFG, max_states=5000)
    r = ck.run()
    r_s = _mk(pe.SHIPPED_CFG, "stage", max_states=5000).run()
    for got in (r, r_s):
        assert got.truncated and got.stop_reason == "max_states"
        assert (got.distinct_states, got.level_sizes) == (
            jr.distinct_states, jr.level_sizes
        )


# ---- the sync-count gate ----------------------------------------------


def test_sync_count_gate_ramp():
    """sub_batch=256: every producer_on frontier fits one window, so
    after the initial states' sync the whole run is two ramp batches of
    8 levels (the last one the empty level that ends the search): 3
    syncs, as the JAX engine's 3 stats fetches."""
    ck = _mk(SMALL_CONFIGS["producer_on"])
    r = ck.run()
    assert (r.distinct_states, r.diameter) == (1654, 16)
    st = ck.last_stats
    assert st["host_syncs"] == 3
    assert st["fuse_levels"] == 16
    assert st["fuse_levels"] / (st["host_syncs"] - 1) >= 4
    assert st["syncs_per_level"] == round(3 / 16, 2)


def test_sync_count_gate_steady_state():
    """sub_batch=64: the four levels whose frontiers (1, 5, 24, 56 rows)
    fit one window run as one ramp batch, every steady-state level
    (frontiers of 76..212 rows, two to four windows each) costs exactly
    one sync, and the tail's 56-row frontier opens a ramp batch that
    closes one level: 1 + 1 + 11 + 1 = 14 syncs, as the JAX engine's 14
    fetches.  The stage loop reads the device after every window."""
    ck = _mk(SMALL_CONFIGS["producer_on"], sub_batch=64)
    r = ck.run()
    assert (r.distinct_states, r.diameter) == (1654, 16)
    steady = sum(1 for f in r.level_sizes if f > 64)
    assert steady == 11
    st = ck.last_stats
    assert st["host_syncs"] == 1 + 1 + steady + 1 == 14
    assert st["fuse_levels"] == 16  # 4 + 11 + 1
    ck_s = _mk(SMALL_CONFIGS["producer_on"], "stage", sub_batch=64)
    ck_s.run()
    windows = sum(-(-f // 64) for f in r.level_sizes)
    assert ck_s.last_stats["host_syncs"] >= 2 * windows


def test_fuse_group_one_disables_ramp_batching():
    """fuse_group=1: one ramp level a sync (16 + the initial states')."""
    ck = _mk(SMALL_CONFIGS["producer_on"], fuse_group=1)
    r = ck.run()
    assert r.distinct_states == 1654
    assert ck.last_stats["host_syncs"] == 17
    assert ck.last_stats["fuse_levels"] == 16


def test_fuse_ctor_validation():
    c = SMALL_CONFIGS["producer_on"]
    with pytest.raises(ValueError, match="fuse must be"):
        _mk(c, fuse="banana")
    with pytest.raises(ValueError, match="fuse_group"):
        _mk(c, fuse_group=0)
    assert _mk(c).fuse == "level"  # the default, as in the JAX package


@pytest.mark.parametrize("flags", [["-fuse", "stage"],
                                   ["-fuse", "level", "-fuse-group", "2"]])
def test_cli_fuse_flags(capsys, flags):
    rc = cli.main(["check", SPEC, "-config", CFG, "-cpu", *flags])
    out = capsys.readouterr().out
    assert rc == 0
    assert "45198 distinct states found" in out
    assert "search depth (diameter) 20" in out
