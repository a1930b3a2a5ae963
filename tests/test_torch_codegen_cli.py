"""``cli check`` of the port on compiled models and the interpreter,
against the JAX CLI, on the CPU: ``-force-compile`` (``-compile``) and
a module outside the registry reach the spec->kernel compiler (the JAX
header line; 45,198 / 20 for compaction.tla), and a spec the compiler
declines prints the JAX note and falls back to the interpreter.

Tolerance: exact equality of the printed lines (the timing line
aside)."""

import contextlib
import io
import os
import shutil

import pytest

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu.frontend import interp as JI
from pulsar_tlaplus_tpu_torch import cli as tcli
from tests.test_torch_codegen import SPECS, _bind

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")


def _cli_lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [ln for ln in buf.getvalue().splitlines()
                if not ln.startswith("Finished in")]


def test_cli_force_compile_prints_jax_lines():
    """``check -force-compile`` compiles a registry spec: the JAX CLI's
    header (state width, lanes, invariants) and counts."""
    spec = os.path.join(SPECS, "subscription.tla")
    JI.install_defs(_bind("subscription", {})[0])
    want = _cli_lines(jcli.main, ["check", spec, "-compile"])
    got = _cli_lines(tcli.main, ["check", spec, "-force-compile", "-cpu"])
    assert got == want
    assert got[1][0].endswith(
        "via the spec->kernel compiler (state width 22 bits, 13 successor "
        "lanes; invariants: ['TypeOK', 'NoLostMessage', "
        "'AckedWasProcessed'])")
    assert "2272 distinct states found, search depth (diameter) 24." in got[1]


def test_cli_compaction_force_compile():
    """The acceptance run: compiled compaction.tla at its shipped cfg,
    45,198 states, diameter 20, 111 bits and 19 lanes."""
    rc, lines = _cli_lines(tcli.main, [
        "check", os.path.join(SPECS, "compaction.tla"), "-force-compile",
        "-cpu"])
    assert rc == 0
    assert lines[0] == (
        f"tpu-tlc: checking compaction @ {SPECS}/compaction.tla via the "
        "spec->kernel compiler (state width 111 bits, 19 successor lanes; "
        "invariants: ['TypeSafe', 'CompactionHorizonCorrectness'])")
    assert "45198 distinct states found, search depth (diameter) 20." in lines


def test_cli_unregistered_module_reaches_the_compiler(tmp_path):
    """A module outside the registry is compiled without
    ``-force-compile``."""
    for ext in ("tla", "cfg"):
        shutil.copy(os.path.join(SPECS, f"subscription.{ext}"),
                    tmp_path / f"mysub.{ext}")
    rc, lines = _cli_lines(tcli.main, ["check", str(tmp_path / "mysub.tla"),
                                       "-cpu"])
    assert rc == 0
    assert "via the spec->kernel compiler (state width 22 bits" in lines[0]
    assert "2272 distinct states found, search depth (diameter) 24." in lines


DECLINED_TLA = """---- MODULE declined ----
EXTENDS Naturals, FiniteSets
VARIABLES x
Init == x = 0
Next == x < 3 /\\ x' = x + Cardinality(SUBSET {x}) - 1
====
"""


def test_cli_declined_spec_falls_back_as_jax(tmp_path):
    """A construct outside the compilable subset (SUBSET of a dynamic
    set): the JAX note word for word, then the interpreter's run."""
    (tmp_path / "declined.tla").write_text(DECLINED_TLA)
    (tmp_path / "declined.cfg").write_text("INIT Init\nNEXT Next\n")
    argv = ["check", str(tmp_path / "declined.tla"), "-nodeadlock"]
    want = _cli_lines(jcli.main, argv)
    got = _cli_lines(tcli.main, argv + ["-cpu"])
    assert got == want
    assert got[1][0] == (
        "tpu-tlc: note: spec->kernel compiler declined (cannot compile "
        "unary SUBSET at (5, 39)); falling back to the generic interpreter")
    assert "4 distinct states found, search depth (diameter) 4." in got[1]
