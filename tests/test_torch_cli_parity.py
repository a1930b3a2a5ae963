"""The port's CLI takes every option the JAX CLI takes, on the CPU.

For every subcommand of ``pulsar_tlaplus_tpu/cli.py``, every option
string of the JAX parser must be accepted by the port's parser
(``pulsar_tlaplus_tpu_torch/cli.py``), apart from ``BY_DESIGN`` below,
one reason each.  Both parsers are built inside ``main()``: the walk
patches ``argparse.ArgumentParser.parse_args`` to raise with the parser
and reads its subparsers' ``option_strings``.

Then the two repairs this walk pins:

- ``simulate`` takes the JAX spellings ``-seed``, ``-max-steps`` and
  ``-rounds``; the ``-sim-*`` spellings stay as aliases, and
  ``-rounds R`` stops where ``StreamingSimulator(max_rounds=R)`` does;
- ``check -profile DIR`` writes a ``torch.profiler`` Chrome trace of the
  whole check, and is refused beside ``-xprof``.

Tolerance: exact equality (option sets, step and walk counts)."""

import argparse
import json
import os
import re

import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.models import registry
from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
from pulsar_tlaplus_tpu_torch.utils import cfg as tcfg
from tests.test_torch_sim import SMALL_CFG

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "compaction.tla")
CFG = os.path.join(ROOT, "specs", "compaction.cfg")

# (subcommand path, JAX option string or None for the whole subcommand)
# -> why the port has no counterpart
BY_DESIGN = {
    (("cache",), None): "it manages the JAX package's cache of compiled "
    "XLA executables (utils/aot_cache.py); the port compiles no XLA",
    (("check",), "-probe-impl"): "a choice between the XLA and Pallas "
    "routes of the flush probe; the port has one route a device (K1 on "
    "the card, its plain version on the CPU)",
    (("check",), "-expand-impl"): "a choice between the XLA and Pallas "
    "routes of the key plane; the port has one route a device (K2)",
    (("check",), "-sieve-impl"): "a choice between the XLA and Pallas "
    "routes of the sieve mask; the port has one route a device (K3)",
    (("serve",), "--no-tiers"): "it skips the daemon's XLA warmup of "
    "every engine tier; the port builds no XLA executables to warm",
}


class _Parser(Exception):
    pass


def _parser_of(main) -> argparse.ArgumentParser:
    """The top-level parser ``main`` builds, caught at ``parse_args``."""
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        raise _Parser(self)

    argparse.ArgumentParser.parse_args = grab
    try:
        main(["check", SPEC])
    except _Parser as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("main() never parsed its arguments")


def _options(p, path=()):
    """{subcommand path: set of option strings} of a parser tree."""
    out, opts = {}, set()
    for a in p._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sp in a.choices.items():
                out.update(_options(sp, path + (name,)))
        else:
            opts.update(a.option_strings)
    out[path] = opts
    return out


def test_port_parser_takes_every_jax_option():
    jax_opts = _options(_parser_of(jcli.main))
    port_opts = _options(_parser_of(cli.main))
    missing = set()
    for path, opts in jax_opts.items():
        if path not in port_opts:
            missing.add((path, None))
            continue
        missing.update((path, o) for o in opts - port_opts[path])
    assert missing == set(BY_DESIGN), {
        "missing, not by design": sorted(missing - set(BY_DESIGN), key=str),
        "by design, no longer missing": sorted(set(BY_DESIGN) - missing,
                                               key=str)}
    assert all(why for why in BY_DESIGN.values())


def _run(argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def _sim_line(out):
    (line,) = [ln for ln in out.splitlines() if ln.startswith("Simulation:")]
    return line


@pytest.fixture
def small_cfg(tmp_path):
    p = tmp_path / "small.cfg"
    p.write_text(SMALL_CFG)
    return str(p)


def test_simulate_rounds_stop_where_the_simulator_does(small_cfg, capsys):
    """``-seed 1 -rounds 2`` parses and stops with the steps and walks of
    ``StreamingSimulator(seed=1, max_rounds=2)``; ``-sim-seed`` is the
    same flag."""
    tail = ["-config", small_cfg, "-cpu", "-walkers", "64", "-depth", "16",
            "-no-profile", "-rounds", "2"]
    rc, out = _run(["simulate", "compaction", *tail, "-seed", "1"], capsys)
    rc2, out2 = _run(["simulate", "compaction", *tail, "-sim-seed", "1"],
                     capsys)
    model, _c = registry.COMPILED["compaction"](tcfg.load(small_cfg))
    r = StreamingSimulator(model, n_walkers=64, depth=16, seed=1,
                           max_rounds=2, device="cpu", profile=None).run()
    assert (r.steps, r.walks) == (2 * 64 * 16, 2 * 64)
    want = (f"Simulation: 64 walkers of depth 16 ({r.states_visited} states "
            f"visited, {r.steps} steps, {r.walks} completed walks).")
    assert (rc, _sim_line(out)) == (rc2, _sim_line(out2)) == (0, want)


def test_simulate_max_steps_is_sim_steps(small_cfg, capsys):
    tail = ["-config", small_cfg, "-cpu", "-walkers", "64", "-depth", "16",
            "-no-profile"]
    rc, out = _run(["simulate", "compaction", *tail, "-seed", "5",
                    "-max-steps", "3072"], capsys)
    rc2, out2 = _run(["simulate", "compaction", *tail, "-sim-seed", "5",
                      "-sim-steps", "3072"], capsys)
    assert (rc, _sim_line(out)) == (rc2, _sim_line(out2))
    assert "3072 steps" in _sim_line(out)


def test_check_keeps_only_the_sim_spellings(capsys):
    """``check`` has ``-sim-seed``/``-sim-steps`` and no ``-rounds``, as
    the JAX ``check`` does."""
    with pytest.raises(SystemExit):
        cli.main(["check", SPEC, "-cpu", "-simulate", "8", "-rounds", "2"])
    assert "unrecognized arguments: -rounds" in capsys.readouterr().err


def test_check_profile_traces_the_whole_run(tmp_path, capsys):
    d = tmp_path / "prof"
    rc, out = _run(["check", SPEC, "-config", CFG, "-cpu", "-no-profile",
                    "-profile", str(d)], capsys)
    assert rc == 0
    assert "45198 distinct states found, search depth (diameter) 20." in out
    (name,) = os.listdir(d)
    with open(d / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the trace opens before the model is built and closes after the
    # result: the engine's own ops and the level loop are both in it
    assert any(n.startswith("aten::") for n in names)
    assert len(events) > 1000


def test_check_profile_with_xprof_is_refused(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["check", SPEC, "-cpu", "-profile", str(tmp_path / "a"),
                  "-xprof", str(tmp_path / "b")])
    msg = str(e.value.code)
    assert re.search(r"-profile\b", msg) and "-xprof" in msg
    assert not os.path.exists(tmp_path / "a")
