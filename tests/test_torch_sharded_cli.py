"""The port's CLI on the mesh-sharded engine, on the CPU: ``check
-sharded N [-slices S]``, ``-workers N``, compiled specs sharded,
``-checkpoint/-recover`` through a killed process, and a message for
every option not ported.  The counterexample's lines are held against
the JAX CLI's (one JAX run); the rest against the pins and the oracle.

Tolerance: exact equality."""

import os
import re
import subprocess
import sys

import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch import cli
from tests.helpers import assert_valid_counterexample

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "compaction.tla")
COUNT = re.compile(r"(\d+) distinct states found, search depth "
                   r"\(diameter\) (\d+)\.")


def _run(capsys, *argv):
    rc = cli.main(["check", SPEC, "-cpu", *argv])
    cap = capsys.readouterr()
    m = COUNT.search(cap.out)
    return rc, m and (int(m.group(1)), int(m.group(2))), cap


def _trace_lines(out):
    """The report from the error line to the count line, wall excluded."""
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("Error:"))
    j = next(k for k, ln in enumerate(lines) if COUNT.search(ln))
    return lines[i: j + 1]


@pytest.mark.parametrize("argv,header", [
    (("-sharded", "4"), "over 4 shards on"),
    (("-sharded", "4", "-slices", "2"), "over 4 shards, 2x2 mesh on"),
    (("-workers", "4"), "over 4 shards on"),
])
def test_sharded_shipped_cfg(argv, header, capsys):
    rc, counts, cap = _run(capsys, *argv)
    assert (rc, counts) == (0, (45198, 20))
    assert header in cap.out and "Error" not in cap.out
    if argv[0] == "-workers":
        assert "-workers 4 maps to -sharded 4" in cap.out


def test_workers_one_runs_the_single_device_engine(capsys):
    rc, counts, cap = _run(capsys, "-workers", "1")
    assert (rc, counts) == (0, (45198, 20))
    assert ("-workers 1 runs the single-chip device engine" in cap.err)
    assert "shards" not in cap.out


@pytest.fixture(scope="module")
def jax_leak_lines():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jcli.main(["check", SPEC, "-sharded", "4", "-invariant",
                        "CompactedLedgerLeak"])
    return rc, _trace_lines(buf.getvalue())


@pytest.mark.parametrize("inv,depth", [("CompactedLedgerLeak", 12),
                                       ("DuplicateNullKeyMessage", 4)])
def test_sharded_counterexamples(inv, depth, capsys, jax_leak_lines):
    from pulsar_tlaplus_tpu_torch.engine.sharded_device import (
        ShardedDeviceChecker,
    )
    from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe

    rc, counts, cap = _run(capsys, "-sharded", "4", "-invariant", inv)
    assert rc == 1 and counts[1] == depth
    assert f"Error: Invariant {inv} is violated." in cap.out
    if inv == "CompactedLedgerLeak":
        assert (rc, _trace_lines(cap.out)) == jax_leak_lines
    r = ShardedDeviceChecker(
        CompactionModel(tpe.SHIPPED_CFG), n_devices=4, invariants=(inv,),
        sub_batch=cli.SHARDED_CHUNK, device="cpu").run()
    assert len(r.trace) == depth
    assert_valid_counterexample(pe.SHIPPED_CFG,
                                [pe.State(*s) for s in r.trace],
                                r.trace_actions, inv)


def test_compiled_spec_sharded(capsys):
    """A compiled model on two shards (bookkeeper's shipped cfg: 297
    states, diameter 14; chip_smoke phase 38 runs compaction's)."""
    spec = os.path.join(ROOT, "specs", "bookkeeper.tla")
    rc = cli.main(["check", spec, "-cpu", "-force-compile", "-sharded",
                   "2"])
    out = capsys.readouterr().out
    m = COUNT.search(out)
    assert (rc, int(m.group(1)), int(m.group(2))) == (0, 297, 14)
    assert "via the spec->kernel compiler" in out
    assert "over 2 shards on" in out


def test_kill_then_recover_sharded(tmp_path):
    """A sharded run killed at level 9 (``PTT_FAULT``) leaves a frame;
    ``-recover`` finishes it to the pins."""
    path = str(tmp_path / "s.npz")
    cmd = [sys.executable, "-m", "pulsar_tlaplus_tpu_torch.cli", "check",
           SPEC, "-cpu", "-sharded", "4", "-checkpoint", path]
    env = dict(os.environ, PYTHONPATH=ROOT, PTT_FAULT="kill@level:9",
               OMP_NUM_THREADS="1")
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 137 and os.path.exists(path), p.stderr[-800:]
    env.pop("PTT_FAULT")
    p = subprocess.run(cmd + ["-recover"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-800:]
    m = COUNT.search(p.stdout)
    assert (int(m.group(1)), int(m.group(2))) == (45198, 20)
    assert "resumed at level 5" in p.stderr  # the CLI frames every 5 levels


@pytest.mark.parametrize("argv,msg", [
    (("-visited", "sort", "-hbm-budget", "64M"),
     "hbm_budget with visited_impl='sort' is unsupported"),
    (("-engine", "host", "-hbm-budget", "64M"),
     "-hbm-budget needs the device engine"),
    (("-sharded-dedup", "hash"),
     "-slices/-sharded-dedup require -sharded N"),
    (("-slices", "2"), "-slices/-sharded-dedup require -sharded N"),
    (("-sharded", "3", "-slices", "2"),
     "-sharded must be divisible by -slices"),
    (("-sharded", "2", "-interp"),
     "-simulate/-sharded/-property need a compiled model"),
    (("-sharded", "2", "-hbm-budget", "64M"),
     "-hbm-budget needs the single-device engine"),
])
def test_refusals(argv, msg):
    with pytest.raises(SystemExit) as e:
        cli.main(["check", SPEC, "-cpu", *argv])
    assert msg in str(e.value.code)
