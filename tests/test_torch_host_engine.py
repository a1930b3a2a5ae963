"""The host-driver engine on the CPU: ``engine/statelog.py`` (the native
and pure-Python file stores, byte-equal to the JAX package's files),
``ops/hashtable.py``, ``engine/core.py``'s dedup steps and
``engine/bfs.Checker`` in hash and sort modes, each against the JAX
package on the same inputs (logs record for record, counterexamples,
kill and resume, per-level records), and the CLI's ``-engine host``,
``-visited``, ``-compact``, ``-chunk`` and ``-metrics`` lines against
the JAX CLI's.  Tolerance: exact equality."""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu.engine import core as jcore
from pulsar_tlaplus_tpu.engine.bfs import Checker as JChecker
from pulsar_tlaplus_tpu.engine.statelog import FileLog as JFileLog
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ops import hashtable as jhashtable
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch import cli, native
from pulsar_tlaplus_tpu_torch.engine import core, statelog
from pulsar_tlaplus_tpu_torch.engine.bfs import Checker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ops import fpset, hashtable
from pulsar_tlaplus_tpu_torch.ops.dedup import from_jax_arrays
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from tests.helpers import SMALL_CONFIGS, assert_valid_counterexample

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "specs", "compaction.tla")
LEAK, DUP = "CompactedLedgerLeak", "DuplicateNullKeyMessage"
NR = SMALL_CONFIGS["no_retain"]


def _port(c):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


def _log_arrays(log):
    return (log.packed_matrix(), log.parents(), log.actions())


# ------------------------------------------------------------ statelog


def _sample(n=300, w=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)
            .astype(np.uint32), rng.integers(-9, 10**6, size=n),
            rng.integers(0, 40, size=n))


def test_memory_log():
    p, par, act = _sample()
    log = statelog.MemoryLog(3)
    assert log.append(p[:100], par[:100], act[:100]) == 0
    assert log.append(p[100:], par[100:], act[100:]) == 100
    row, g, a = log.get(150)
    assert np.array_equal(row, p[150]) and (g, a) == (par[150], act[150])
    for got, want in zip(_log_arrays(log), (p, par, act)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("store", ["native", "python"])
def test_file_log_byte_equal_to_jax(tmp_path, monkeypatch, store):
    """The same appends give the JAX ``FileLog``'s file byte for byte,
    from the native store and from the pure-Python one; reopen, get and
    truncate behave as there."""
    p, par, act = _sample()
    if store == "python":
        def broken():
            raise OSError("no toolchain")

        monkeypatch.setattr(native, "build", broken)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(statelog, "_warned_fallback", False)
    a = statelog.FileLog(str(tmp_path / "a.log"), 3, fresh=True)
    assert a.native == (store == "native")
    b = JFileLog(str(tmp_path / "b.log"), 3, fresh=True)
    for log in (a, b):
        log.append(p[:120], par[:120], act[:120])
        log.append(p[120:], par[120:], act[120:])
        log.sync()
    assert (tmp_path / "a.log").read_bytes() == (tmp_path / "b.log").read_bytes()
    a.close()
    a = statelog.FileLog(str(tmp_path / "a.log"), 3)
    assert len(a) == 300 and np.array_equal(a.get(299)[0], p[299])
    a.truncate(200)
    assert len(a) == 200 and os.path.getsize(tmp_path / "a.log") == 200 * 24
    with pytest.raises(ValueError):
        a.truncate(250)
    with open(tmp_path / "a.log", "ab") as f:
        f.write(b"\0" * 5)
    with pytest.raises(ValueError, match="whole number of records"):
        statelog.FileLog(str(tmp_path / "a.log"), 3)


def test_fallback_warns_once(tmp_path, monkeypatch, capsys):
    def broken():
        raise OSError("no toolchain")

    monkeypatch.setattr(native, "build", broken)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(statelog, "_warned_fallback", False)
    for i in range(2):
        assert not statelog.FileLog(str(tmp_path / f"{i}.log"), 2).native
    assert capsys.readouterr().err.count("WARNING: native log store") == 1


# ----------------------------------------------------------- hashtable


def test_hashtable_lookup_insert_matches_jax():
    """``is_new`` (min-lane-wins over in-batch duplicates, members
    settled) equals the JAX table's over three batches and a growth."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=(3, 6000), dtype=np.uint64).astype(
        np.uint32)
    keys[:, 3000:] = keys[:, rng.integers(0, 3000, size=3000)]
    valid = rng.random(6000) < 0.9
    jt = jhashtable.empty_table(1 << 13)
    t = hashtable.empty_table(1 << 13, "cpu")
    for sl in (slice(0, 2000), slice(2000, 4000), slice(4000, 6000)):
        if sl.start == 4000:
            jt = jhashtable.rehash_into(jt, jhashtable.empty_table(1 << 15))
            t = hashtable.rehash_into(t, hashtable.empty_table(1 << 15,
                                                               "cpu"))
        jnew, *jt5 = jhashtable.lookup_insert(
            *jt, *[jnp.asarray(c[sl]) for c in keys],
            jnp.asarray(valid[sl]))
        jt, jfailed = tuple(jt5[:4]), jt5[4]
        new, t, failed = hashtable.lookup_insert(
            t, from_jax_arrays(*[c[sl] for c in keys]),
            torch.from_numpy(valid[sl]))
        assert np.array_equal(new.numpy(), np.asarray(jnew))
        assert int(failed) == int(jfailed) == 0
    occ = ~fpset.all_sentinel(t)
    occ[-1] = False
    assert int(occ.sum()) == int(np.asarray(jt[3])[:-1].sum())


def test_hashtable_overflow_is_counted():
    """A full table reports unresolved lanes: never a silent drop."""
    keys = np.arange(3 * 3000, dtype=np.uint32).reshape(3, 3000)
    _new, _t, failed = hashtable.lookup_insert(
        hashtable.empty_table(1 << 11, "cpu"), from_jax_arrays(*keys),
        torch.ones(3000, dtype=torch.bool))
    assert int(failed) > 0
    with pytest.raises(ValueError, match="power of two"):
        hashtable.empty_table(1000, "cpu")


# ---------------------------------------------------------------- core


@pytest.mark.parametrize("mode", ["sort", "hash"])
def test_dedup_core_matches_jax(mode):
    """One expand chunk of the no_retain binding deduplicated against a
    visited set holding part of it: the new states (key order / lane
    order), parents, actions, count and violations equal JAX's."""
    jm, m = JModel(NR), _port(NR)
    rng = np.random.default_rng(1)
    n = 4000
    words = np.zeros((n, m.layout.W), np.uint32)
    states = list(pe.initial_states(NR))
    seen = []
    for s in states:
        for _a, t in pe.successors(NR, s):
            seen.append(t)
    pool = (states + seen) * (n // (len(states) + len(seen)) + 1)
    words = m._pack_pystates([tpe.State(*s) for s in pool[:n]])
    valid = rng.random(n) < 0.9
    parent = rng.integers(0, 1000, size=n).astype(np.int32)
    action = rng.integers(0, 7, size=n).astype(np.int32)
    inv = (LEAK, DUP, "TypeSafe")
    tw, tv, tp, ta = from_jax_arrays(words, valid, parent, action)
    jw = jnp.asarray(words)
    # a visited set with the first 500 lanes' keys
    k = [np.asarray(c) for c in jdedup_keys(jw, m.layout.total_bits)]
    if mode == "sort":
        V = 8192
        pre = np.unique(np.stack(k)[:, :500].T, axis=0).T
        vis = np.full((3, V), 0xFFFFFFFF, np.uint32)
        vis[:, : pre.shape[1]] = pre
        nv = pre.shape[1]
        want = jcore.dedup_core(jm, inv, jw, jnp.asarray(valid),
                                jnp.asarray(parent), jnp.asarray(action),
                                *[jnp.asarray(c) for c in vis], jnp.int32(nv))
        got = core.dedup_core(m, inv, tw, tv, tp, ta,
                              *from_jax_arrays(*vis), nv)
        n_new = int(want[3])
        assert int(got[3]) == n_new > 0
        for i in (4, 5, 6):
            assert np.array_equal(got[i].numpy().view(np.uint32),
                                  np.asarray(want[i]))
        gviol, wviol = got[7], want[7]
    else:
        jt = jhashtable.empty_table(1 << 14)
        jt = jhashtable.lookup_insert(
            *jt, *[jnp.asarray(c[:500]) for c in k],
            jnp.ones(500, bool))[1:5]
        want = jcore.dedup_core_hash(jm, inv, jw, jnp.asarray(valid),
                                     jnp.asarray(parent),
                                     jnp.asarray(action), *jt)
        t = hashtable.empty_table(1 << 14, "cpu")
        _n, t, _f = hashtable.lookup_insert(
            t, from_jax_arrays(*[c[:500] for c in k]),
            torch.ones(500, dtype=torch.bool))
        got = core.dedup_core_hash(m, inv, tw, tv, tp, ta, t)
        n_new = int(want[3])
        assert int(got[3]) == n_new > 0 and int(got[6]) == 0
        gviol, wviol = got[5], want[8]
    assert np.array_equal(got[0][:n_new].numpy().view(np.uint32),
                          np.asarray(want[0])[:n_new])
    for i in (1, 2):
        assert np.array_equal(got[i][:n_new].numpy(),
                              np.asarray(want[i])[:n_new])
    assert gviol.tolist() == np.asarray(wviol).tolist()


def jdedup_keys(words, bits):
    from pulsar_tlaplus_tpu.ops import dedup as jdedup

    return jdedup.make_keys(words, bits)


def test_partition_perm_matches_jax():
    keep = np.random.default_rng(2).random(3000) < 0.4
    want = jcore.partition_perm(jnp.asarray(keep))
    assert np.array_equal(core.partition_perm(torch.from_numpy(keep))
                          .numpy(), np.asarray(want))


# ------------------------------------------------------------- Checker


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX host engine's runs, each once: (checker, result)."""
    out = {}
    for key, c, inv, dedup_mode, chunk in (
        ("nr_hash", NR, (), "hash", 256),
        ("nr_sort", NR, (), "sort", 256),
        ("leak_hash", pe.SHIPPED_CFG, (LEAK,), "hash", 4096),
        ("dup_sort", pe.SHIPPED_CFG, (DUP,), "sort", 4096),
    ):
        jck = JChecker(JModel(c), invariants=inv, dedup=dedup_mode,
                       frontier_chunk=chunk, keep_log=True)
        out[key] = (jck, jck.run())
    return out


@pytest.mark.parametrize("key,c,inv,dedup_mode,chunk,cap", [
    ("nr_hash", NR, (), "hash", 256, 1 << 6),
    ("nr_sort", NR, (), "sort", 256, 1 << 6),
    ("leak_hash", pe.SHIPPED_CFG, (LEAK,), "hash", 4096, 1 << 13),
    ("dup_sort", pe.SHIPPED_CFG, (DUP,), "sort", 4096, 1 << 13),
])
def test_checker_log_equals_jax(jax_runs, key, c, inv, dedup_mode, chunk,
                                cap):
    """The port's host engine logs the JAX engine's states record for
    record (rows, parents, action ids; hash: lane order, sort: key order
    a chunk), with the same level sizes and counterexample — from a tiny
    table (growth by fourfold rehash / padding)."""
    jck, jr = jax_runs[key]
    ck = Checker(_port(c), invariants=inv, dedup=dedup_mode,
                 frontier_chunk=chunk, visited_cap=cap, keep_log=True,
                 device="cpu")
    r = ck.run()
    assert (r.distinct_states, r.level_sizes, r.violation,
            r.violation_gid) == (jr.distinct_states, jr.level_sizes,
                                 jr.violation, jr.violation_gid)
    for a, b in zip(_log_arrays(ck.last_run_state.log),
                    _log_arrays(jck.last_run_state.log)):
        assert np.array_equal(a, b)
    if inv:
        assert [tuple(s) for s in r.trace] == [tuple(s) for s in jr.trace]
        assert r.trace_actions == jr.trace_actions
        assert_valid_counterexample(c, [pe.State(*s) for s in r.trace],
                                    r.trace_actions, inv[0])


def test_checker_file_log_equals_jax_file(tmp_path):
    """A ``state_log_path`` run writes the JAX engine's file byte for
    byte (the native store)."""
    paths = [str(tmp_path / "p.log"), str(tmp_path / "j.log")]
    Checker(_port(NR), invariants=(), frontier_chunk=256,
            state_log_path=paths[0], device="cpu").run()
    JChecker(JModel(NR), invariants=(), frontier_chunk=256,
             state_log_path=paths[1]).run()
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and len(a) == 7992 * (2 * 4 + 12)


def test_checker_truncate_resume_and_metrics(tmp_path):
    """A state budget stops the run at a level boundary with a frame; a
    resume (bigger budget) ends equal to the uninterrupted run, and the
    per-level records are rewound to the frame's level first."""
    full = Checker(_port(NR), invariants=(), frontier_chunk=256,
                   keep_log=True, device="cpu")
    rf = full.run()
    path, mpath = str(tmp_path / "h.npz"), str(tmp_path / "m.jsonl")
    cut = Checker(_port(NR), invariants=(), frontier_chunk=256,
                  checkpoint_path=path, max_states=3000, metrics_path=mpath,
                  device="cpu")
    r = cut.run()
    assert r.truncated and r.stop_reason is None
    recs = [json.loads(x) for x in open(mpath)]
    assert [x["level"] for x in recs] == list(range(2, len(r.level_sizes)
                                                    + 1))
    assert set(recs[0]) == {"level", "new_states", "distinct_states",
                            "frontier", "wall_s", "states_per_sec",
                            "visited_cap"}
    with open(mpath, "a") as f:  # a record past the frame
        f.write(json.dumps({"level": 99}) + "\n")
    res = Checker(_port(NR), invariants=(), frontier_chunk=256,
                  checkpoint_path=path, metrics_path=mpath, keep_log=True,
                  device="cpu")
    r2 = res.run(resume=True)
    assert r2.level_sizes == rf.level_sizes
    for a, b in zip(_log_arrays(res.last_run_state.log),
                    _log_arrays(full.last_run_state.log)):
        assert np.array_equal(a, b)
    recs = [json.loads(x) for x in open(mpath)]
    assert {"resumed_at_level": len(r.level_sizes)} in recs
    assert all(x.get("level", 0) != 99 for x in recs)
    assert recs[-1]["level"] == len(rf.level_sizes)


DRIVER = r"""
import hashlib, json, sys, torch
import numpy as np
torch.set_num_threads(1)
from pulsar_tlaplus_tpu_torch.engine.bfs import Checker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ref import pyeval
c = pyeval.Constants(message_sent_limit=3, compaction_times_limit=2,
                     num_keys=2, num_values=1, retain_null_key=False,
                     max_crash_times=1)
path, log = sys.argv[1], sys.argv[2] or None
ck = Checker(CompactionModel(c), invariants=(), frontier_chunk=256,
             checkpoint_path=path, checkpoint_every=1, keep_log=True,
             state_log_path=log, device="cpu")
r = ck.run(resume=sys.argv[3] == "1")
lg = ck.last_run_state.log
recs = [lg.get(g) for g in range(len(lg))]
h = hashlib.sha256()
h.update(np.stack([x[0] for x in recs]).astype(np.uint32).tobytes())
h.update(np.asarray([x[1] for x in recs], np.int64).tobytes())
h.update(np.asarray([x[2] for x in recs], np.int32).tobytes())
print(json.dumps([r.level_sizes, h.hexdigest()]))
"""


@pytest.mark.parametrize("file_log", [False, True])
def test_checker_kill_and_resume(tmp_path, file_log):
    """``kill@level:6`` ends the process (137) after its frames; a fresh
    process resumes it (a file log is truncated back to the frame's
    count) to the uninterrupted run's level sizes and log digest."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    path = str(tmp_path / "k.npz")
    log = str(tmp_path / "k.log") if file_log else ""

    def go(resume, fault=None, ckpt=path):
        e = dict(env, **({"PTT_FAULT": fault} if fault else {}))
        return subprocess.run(
            [sys.executable, "-c", DRIVER, ckpt, log, resume],
            cwd=ROOT, env=e, capture_output=True, text=True, timeout=300)

    p = go("0", "kill@level:6")
    assert p.returncode == 137 and os.path.exists(path), p.stderr[-500:]
    p = go("1")
    assert p.returncode == 0, p.stderr[-800:]
    full = Checker(_port(NR), invariants=(), frontier_chunk=256,
                   keep_log=True, device="cpu")
    rf = full.run()
    import hashlib

    h = hashlib.sha256()
    for a, t in zip(_log_arrays(full.last_run_state.log),
                    (np.uint32, np.int64, np.int32)):
        h.update(np.ascontiguousarray(a, t).tobytes())
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [
        rf.level_sizes, h.hexdigest()]


def test_checker_refusals():
    m = _port(NR)
    with pytest.raises(ValueError, match="dedup must be"):
        Checker(m, dedup="tree", device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        Checker(m, visited_cap=1000, device="cpu")
    with pytest.raises(ValueError, match="unknown invariant"):
        Checker(m, invariants=("Nope",), device="cpu")


# ----------------------------------------------------------------- CLI

COUNT = re.compile(r"(\d+) distinct states found, search depth "
                   r"\(diameter\) (\d+)\.")


def _summary(text):
    """The report's lines, the run-specific ones dropped (header, wall,
    sharded placement)."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("Finished in", "tpu-tlc: checking",
                                  "tpu-tlc: mesh-sharded"))]


@pytest.fixture(scope="module")
def jax_cli():
    out = {}
    for argv in (("-engine", "host", "-invariant", LEAK),
                 ("-engine", "host", "-chunk", "1000", "-invariant", DUP),
                 ("-visited", "sort", "-compact", "sort", "-invariant", DUP)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = jcli.main(["check", SPEC, *argv])
        out[argv] = (rc, _summary(buf.getvalue()))
    return out


@pytest.mark.parametrize("argv", [
    ("-engine", "host", "-invariant", LEAK),
    ("-engine", "host", "-chunk", "1000", "-invariant", DUP),
    ("-visited", "sort", "-compact", "sort", "-invariant", DUP),
])
def test_cli_lines_equal_jax(jax_cli, argv, capsys):
    rc = cli.main(["check", SPEC, "-cpu", *argv])
    assert (rc, _summary(capsys.readouterr().out)) == jax_cli[argv]


def test_cli_engine_host_clean_and_metrics(tmp_path, capsys):
    mpath = str(tmp_path / "m.jsonl")
    rc = cli.main(["check", SPEC, "-cpu", "-engine", "host", "-metrics",
                   mpath])
    m = COUNT.search(capsys.readouterr().out)
    assert (rc, int(m.group(1)), int(m.group(2))) == (0, 45198, 20)
    recs = [json.loads(x) for x in open(mpath)]
    assert [x["level"] for x in recs] == list(range(2, 21))
    rc = cli.main(["check", SPEC, "-cpu", "-visited", "sort", "-metrics",
                   mpath, "-chunk", "1024"])
    m = COUNT.search(capsys.readouterr().out)
    assert (rc, int(m.group(1)), int(m.group(2))) == (0, 45198, 20)
