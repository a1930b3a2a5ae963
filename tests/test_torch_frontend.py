"""The port's TLA+ front end (``pulsar_tlaplus_tpu_torch/frontend/``:
lexer, parser, AST, loader, interpreter) and its generic-interpreter
checker (``engine/interp_check.py``, the ``-interp`` path) against the
JAX package's, on the CPU:

- all four specs parse to the same trees, node for node and field for
  field (the node classes' modules aside);
- ``bind_cfg`` binds the same constants and interns the same strings;
- ``InterpChecker`` gives the same count, diameter, level sizes and
  counterexample trace on a small compaction binding and the shipped
  subscription cfg, and ``format_value`` renders the same text;
- ``check -interp`` prints the same lines through both CLIs (the
  ``Finished in`` timing line aside), clean and with a counterexample.

Tolerance: exact equality."""

import contextlib
import dataclasses
import io
import os

import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu.engine import interp_check as jic
from pulsar_tlaplus_tpu.frontend import interp as JI
from pulsar_tlaplus_tpu.frontend import loader as jloader
from pulsar_tlaplus_tpu.frontend.parser import parse_file as j_parse
from pulsar_tlaplus_tpu.utils import cfg as jcfg
from pulsar_tlaplus_tpu_torch import cli as tcli
from pulsar_tlaplus_tpu_torch.engine import interp_check as tic
from pulsar_tlaplus_tpu_torch.frontend import interp as TI
from pulsar_tlaplus_tpu_torch.frontend import loader as tloader
from pulsar_tlaplus_tpu_torch.frontend.parser import parse_file as t_parse
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.utils import cfg as tcfg

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SPEC_NAMES = ("compaction", "subscription", "bookkeeper", "georeplication")


def _norm(x):
    """A comparable form of an AST or value: node classes by name,
    dataclass fields recursively, model values by name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _norm(getattr(x, f.name)))
            for f in dataclasses.fields(x)
        )
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_norm(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted((k, _norm(v)) for k, v in x.items()))
    if isinstance(x, frozenset):
        return ("set",) + tuple(sorted(map(repr, map(_norm, x))))
    if type(x).__name__ in ("MV", "FDict"):
        return (type(x).__name__, repr(x))
    return x


@pytest.mark.parametrize("spec", SPEC_NAMES)
def test_parse_trees_equal_jax(spec):
    path = os.path.join(SPECS, f"{spec}.tla")
    assert _norm(t_parse(path)) == _norm(j_parse(path))


@pytest.mark.parametrize("spec", SPEC_NAMES)
def test_bind_cfg_equal_jax(spec):
    path = os.path.join(SPECS, f"{spec}.tla")
    cfg = os.path.join(SPECS, f"{spec}.cfg")
    got = tloader.bind_cfg(t_parse(path), tcfg.load(cfg))
    want = jloader.bind_cfg(j_parse(path), jcfg.load(cfg))
    assert _norm(got) == _norm(want)
    assert got["__string_interning__"] == want["__string_interning__"]


def test_bind_cfg_interns_strings_as_jax(tmp_path):
    """A string-set constant interns to 1..n in sorted order (the
    reference compaction.cfg binds KeySpace to strings)."""
    text = open(os.path.join(SPECS, "compaction.cfg")).read().replace(
        "KeySpace = {1, 2}", 'KeySpace = {"k2", "k1"}')
    cfg = tmp_path / "strings.cfg"
    cfg.write_text(text)
    path = os.path.join(SPECS, "compaction.tla")
    with pytest.warns(UserWarning, match="interning"):
        got = tloader.bind_cfg(t_parse(path), tcfg.load(str(cfg)))
    with pytest.warns(UserWarning, match="interning"):
        want = jloader.bind_cfg(j_parse(path), jcfg.load(str(cfg)))
    assert got["__string_interning__"] == want["__string_interning__"] == {
        "KeySpace": {"k1": 1, "k2": 2}}
    assert _norm(got) == _norm(want)


def _interp_pair(spec, overrides=None, compaction=None):
    path = os.path.join(SPECS, f"{spec}.tla")
    out = []
    for parse, loader, cfgmod, I in (
        (j_parse, jloader, jcfg, JI), (t_parse, tloader, tcfg, TI)
    ):
        ast = parse(path)
        if compaction is not None:
            consts = loader.compaction_constants(compaction)
        else:
            consts = loader.bind_cfg(
                ast, cfgmod.load(os.path.join(SPECS, f"{spec}.cfg")))
            consts.pop("__string_interning__")
        consts.update(overrides or {})
        out.append(I.Spec(ast, consts))
    return out


SMALL_COMPACTION = tpe.Constants(
    message_sent_limit=2, compaction_times_limit=2, num_keys=1,
    num_values=1, max_crash_times=1, model_producer=True)


@pytest.mark.parametrize("case,invariants", [
    ("compaction_small", ("TypeSafe", "CompactionHorizonCorrectness")),
    ("compaction_small", ("CompactedLedgerLeak",)),
    ("subscription", ("TypeOK", "NoLostMessage", "AckedWasProcessed")),
    ("subscription", ("ExactlyOnceProcessing",)),
])
def test_interp_checker_equals_jax(case, invariants):
    if case == "compaction_small":
        js, ts = _interp_pair("compaction", compaction=SMALL_COMPACTION)
    else:
        js, ts = _interp_pair(case)
    want = jic.InterpChecker(js, invariants=invariants).run()
    got = tic.InterpChecker(ts, invariants=invariants).run()
    for f in ("distinct_states", "diameter", "violation", "deadlock",
              "level_sizes", "truncated", "trace", "trace_actions"):
        assert getattr(got, f) == getattr(want, f), f
    if case == "subscription" and invariants[0] == "ExactlyOnceProcessing":
        assert got.violation == invariants[0] and len(got.trace) == 7


def test_format_value_equals_jax():
    """Every variable of the first 500 reachable states of the small
    compaction binding renders to the same TLA+ text."""
    js, ts = _interp_pair("compaction", compaction=SMALL_COMPACTION)
    JI.install_defs(js)
    TI.install_defs(ts)
    jf, tf = js.initial_states(), ts.initial_states()
    n = 0
    while jf and n < 500:
        assert len(jf) == len(tf)
        for a, b in zip(jf, tf):
            assert [tic.format_value(x) for x in b] == [
                jic.format_value(x) for x in a]
            n += 1
        jf = [t for s in jf[:20] for _a, t in js.successors(s)]
        tf = [t for s in tf[:20] for _a, t in ts.successors(s)]


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [ln for ln in buf.getvalue().splitlines()
                if not ln.startswith("Finished in")]


@pytest.mark.parametrize("extra", [[], ["-invariant",
                                        "ExactlyOnceProcessing"]])
def test_cli_interp_prints_jax_lines(extra):
    spec = os.path.join(SPECS, "subscription.tla")
    want = _lines(jcli.main, ["check", spec, "-interp", *extra])
    got = _lines(tcli.main, ["check", spec, "-interp", "-cpu", *extra])
    assert got == want
    assert got[0] == (1 if extra else 0)


@pytest.mark.parametrize("flags", [["-checkpoint", "ck.bin"], ["-recover"],
                                   ["-sharded", "4"]])
def test_cli_refuses_unported_flags(flags, capsys, tmp_path, monkeypatch):
    """``-checkpoint``/``-recover`` and the JAX CLI's mesh flag
    ``-sharded`` are ported to the device engines: the generic-interpreter
    path refuses them as the JAX CLI does, ``-recover`` with no frame is
    refused on every path, a registry model's run writes its frame, and
    ``-sharded`` runs the registry and compiled models on the mesh."""
    monkeypatch.chdir(tmp_path)
    spec = os.path.join(SPECS, "subscription.tla")
    for extra in ([], ["-interp"], ["-force-compile"]):
        argv = ["check", spec, "-cpu", *extra, *flags]
        if flags[0] == "-checkpoint" and extra != ["-interp"]:
            if not extra:  # (the compiled path's frames: test_torch_ckpt)
                assert tcli.main(argv) == 0
                assert os.path.exists(tmp_path / "ck.bin")
            continue
        if flags[0] == "-sharded" and extra != ["-interp"]:
            assert tcli.main(argv) == 0
            assert "2272 distinct states found" in capsys.readouterr().out
            continue
        with pytest.raises(SystemExit) as e:
            tcli.main(argv)
        msg = str(e.value)
        if flags[0] == "-sharded":
            assert "-simulate/-sharded/-property need a compiled model" in msg
        elif extra == ["-interp"]:
            assert "not supported on the generic-interpreter path" in msg
        else:
            assert "-recover needs an existing -checkpoint file" in msg
    capsys.readouterr()