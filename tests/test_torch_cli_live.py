"""The CLI's liveness and simulation paths against the JAX CLI, on the
CPU: ``check -property`` under both fairness modes, the cfg's
``PROPERTIES`` after a clean safety pass (with a property that is not a
goal), ``check -simulate`` and the ``simulate`` subcommand, each with
``-cpu``: the same report lines and exit codes.  Walk streams differ
between the packages (each has its own random words), so a violating
simulation is compared by its verdict lines; a clean one by all of its
lines but the timing."""

import os
import re

import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu_torch import cli
from tests.test_torch_sim import SMALL_CFG

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "compaction.tla")


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _lines(out, *prefixes):
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


@pytest.fixture
def small_cfg(tmp_path):
    p = tmp_path / "small.cfg"
    p.write_text(SMALL_CFG)
    return str(p)


@pytest.mark.parametrize("fairness", ["none", "wf_next"])
def test_cli_property_matches_jax(fairness, small_cfg, capsys):
    argv = ["check", SPEC, "-config", small_cfg, "-cpu", "-property",
            "Termination", "-fairness", fairness]
    jrc, jout = _run(jcli.main, argv, capsys)
    rc, out = _run(cli.main, argv, capsys)
    want = _lines(jout, "Temporal property", "1654 distinct")
    assert len(want) == 2
    assert (rc, _lines(out, "Temporal property", "1654 distinct")) == (
        jrc, want)


def test_cli_cfg_properties_after_safety_pass(tmp_path, capsys):
    p = tmp_path / "props.cfg"
    p.write_text(SMALL_CFG + "PROPERTIES\n    Termination\n    NoSuchGoal\n")
    argv = ["check", SPEC, "-config", str(p), "-cpu", "-fairness", "none"]
    jrc, jout = _run(jcli.main, argv, capsys)
    rc, out = _run(cli.main, argv, capsys)
    keep = ("Temporal property", "tpu-tlc: WARNING", "1654 distinct")
    # unfair: the property is violated after a clean safety pass
    assert jrc == rc == 1
    assert len(_lines(jout, *keep)) == 3
    assert _lines(out, *keep) == _lines(jout, *keep)


def test_cli_check_simulate_matches_jax(small_cfg, capsys):
    clean = ["check", SPEC, "-config", small_cfg, "-cpu", "-simulate",
             "256", "-depth", "32"]
    jrc, jout = _run(jcli.main, clean, capsys)
    rc, out = _run(cli.main, clean, capsys)
    keep = ("Simulation:", "No violation", "Error:")
    assert _lines(jout, "Simulation:") == [
        "Simulation: 256 walkers of depth 32 (8448 states visited, 8192 "
        "steps, 256 completed walks)."]
    assert (rc, _lines(out, *keep)) == (jrc, _lines(jout, *keep)) == (
        0, _lines(jout, *keep))
    bug = ["check", SPEC, "-cpu", "-simulate", "1024",
           "-invariant", "DuplicateNullKeyMessage", "-sim-steps", "1000000"]
    jrc, jout = _run(jcli.main, bug, capsys)
    rc, out = _run(cli.main, bug, capsys)
    assert rc == jrc == 1
    assert _lines(out, "Error:", "The behavior") == _lines(
        jout, "Error:", "The behavior")
    assert "WARNING" not in out


def test_cli_simulate_subcommand_matches_jax(small_cfg, capsys):
    tail = ["-config", small_cfg, "-cpu", "-walkers", "64", "-depth", "16"]
    jrc, jout = _run(jcli.main, ["simulate", "compaction", *tail,
                                 "-seed", "5", "-max-steps", "3072"], capsys)
    rc, out = _run(cli.main, ["simulate", "compaction", *tail,
                              "-sim-seed", "5", "-sim-steps", "3072"], capsys)
    keep = ("tpu-tlc: simulating", "Simulation:", "No violation")
    assert len(_lines(jout, *keep)) == 3
    assert (rc, _lines(out, *keep)) == (jrc, _lines(jout, *keep))
    assert re.search(r"Finished in [\d.]+s \([\d,]+ steps/sec", out)
