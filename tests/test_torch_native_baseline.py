"""The port's native CPU baseline checker (``native/compaction_bfs.cpp``,
``native.build_baseline``/``run_baseline``) on the CPU:

- the published oracles: 45,198 states / 20 levels at the shipped cfg,
  253,361 / 23 with the producer modeled and ``RetainNullKey=FALSE``,
  at one thread and at four;
- ``producer_on``, ``two_crashes`` and ``no_retain`` give the states and
  diameter of both the port's ``ref/pyeval.check`` and the JAX one;
- binary parity: on those configs the port's binary prints the stdout
  fields and per-level ``new``/``cum`` lines of the JAX source, which
  the test compiles with g++ into its own temp dir (reading the JAX
  file, writing nothing into its package);
- the wrapper refuses a violated run and a failed build, and builds
  under ``build/torch_native/`` only.

Tolerance: exact equality (integer counts)."""

import dataclasses
import hashlib
import json
import os
import subprocess

import pytest
import torch

from pulsar_tlaplus_tpu.ref import pyeval as jpe
from pulsar_tlaplus_tpu_torch import native
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from tests.helpers import SMALL_CONFIGS

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(ROOT, "pulsar_tlaplus_tpu", "native")
PORT_NATIVE = os.path.join(ROOT, "pulsar_tlaplus_tpu_torch", "native")
SMALL = ["producer_on", "two_crashes", "no_retain"]


def _args(c):
    return (c.message_sent_limit, c.num_keys, c.num_values,
            c.compaction_times_limit, c.max_crash_times, c.model_producer,
            c.retain_null_key)


def _run(c, **kw):
    return native.run_baseline(*_args(c), 300.0, table_log2=22, **kw)


def _raw(binary, c):
    """(stdout JSON, per-level stderr records) of one binary's run."""
    m, k, v, cc, crash, prod, retain = _args(c)
    p = subprocess.run(
        [str(binary), str(m), str(k), str(v), str(cc), str(crash),
         str(int(prod)), str(int(retain)), "300", "1", "22"],
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1]), (
        native.level_records(p.stderr))


def _tree(d):
    return {n: hashlib.sha256(open(os.path.join(d, n), "rb").read()
                              ).hexdigest()
            for n in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, n))}


@pytest.fixture(scope="module")
def jax_binary(tmp_path_factory):
    """The JAX package's baseline source compiled into a temp dir."""
    out = tmp_path_factory.mktemp("jax_baseline") / "compaction_bfs"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-pthread",
         os.path.join(JAX_NATIVE, "compaction_bfs.cpp"), "-o", str(out)],
        check=True, capture_output=True)
    return out


@pytest.mark.parametrize("threads", [1, 4])
def test_shipped_cfg_published_count(threads):
    r = _run(tpe.SHIPPED_CFG, threads=threads)
    assert not r["truncated"] and not r["violated"]
    assert (r["distinct_states"], r["levels"]) == (45198, 20)
    assert r["threads"] == threads


@pytest.mark.parametrize("threads", [1, 4])
def test_full_cfg_published_count(threads):
    r = native.run_baseline(3, 2, 2, 3, 1, True, False, 300.0,
                            threads=threads, table_log2=22,
                            with_levels=True)
    assert not r["truncated"] and not r["violated"]
    assert (r["distinct_states"], r["levels"]) == (253361, 23)
    lv = r["level_records"]
    assert [x["level"] for x in lv] == list(range(2, 24))
    assert lv[-1]["cum"] == 253361 and all(x["complete"] for x in lv)
    assert all(b["cum"] - a["cum"] == b["new"] for a, b in zip(lv, lv[1:]))


@pytest.mark.parametrize("name", SMALL)
def test_small_configs_match_both_pyevals(name):
    jc = SMALL_CONFIGS[name]
    tc = tpe.Constants(**dataclasses.asdict(jc))
    r = _run(tc)
    want_j = jpe.check(jc, invariants=())
    want_t = tpe.check(tc, invariants=())
    assert not r["truncated"] and not r["violated"]
    assert (r["distinct_states"], r["levels"]) == (
        want_t.distinct_states, want_t.diameter) == (
        want_j.distinct_states, want_j.diameter)


@pytest.mark.parametrize("name", SMALL)
def test_binary_matches_the_jax_source(name, jax_binary):
    c = SMALL_CONFIGS[name]
    port, port_lv = _raw(native.build_baseline(), c)
    ref, ref_lv = _raw(jax_binary, c)
    keys = ("distinct_states", "levels", "truncated", "violated")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    strip = lambda lv: [(x["level"], x["new"], x["cum"], x["complete"])
                        for x in lv]
    assert strip(port_lv) == strip(ref_lv)
    assert len(port_lv) == port["levels"] - 1


def test_violated_run_is_refused(tmp_path, monkeypatch):
    """A run that hit a violation stopped early: its rate is no
    baseline, so the wrapper raises (exit code 1 with violated: true)."""
    fake = tmp_path / "fake_bfs"
    fake.write_text(
        "#!/bin/sh\n"
        "echo '{\"distinct_states\": 7, \"levels\": 2, \"wall_s\": 0.0, "
        "\"states_per_sec\": 1.0, \"truncated\": false, \"violated\": true, "
        "\"threads\": 1}'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "build_baseline", lambda: fake)
    with pytest.raises(RuntimeError, match="invariant violation"):
        native.run_baseline(2, 1, 1, 3, 1, False, True, 5.0)
    fake.write_text("#!/bin/sh\necho boom >&2\nexit 2\n")
    with pytest.raises(RuntimeError, match="baseline checker failed: boom"):
        native.run_baseline(2, 1, 1, 3, 1, False, True, 5.0)


def test_build_lands_under_build_and_nowhere_else(tmp_path, monkeypatch):
    assert str(native.BUILD_DIR) == os.path.join(
        os.path.realpath(ROOT), "build", "torch_native")
    assert os.path.dirname(native.build_baseline()) == str(native.BUILD_DIR)
    before = (_tree(JAX_NATIVE), _tree(PORT_NATIVE))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    out = native.build_baseline()
    assert out.parent == tmp_path / "out" and os.access(out, os.X_OK)
    assert os.listdir(tmp_path / "out") == [out.name]
    assert (_tree(JAX_NATIVE), _tree(PORT_NATIVE)) == before
    # a second call finds the binary of this source and these flags
    assert native.build_baseline() == out


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "compaction_bfs.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "BASELINE_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(subprocess.CalledProcessError):
        native.build_baseline()
    assert not any((tmp_path / "out").iterdir())
