"""The host-staged sharded engine (``engine/sharded.ShardedChecker``) on
the CPU against the JAX package's: ``bucket`` array-equal to the JAX
``_bucket``; the state log record for record at N = 2, N = 4 and on a
2 x 2 mesh in both dedup modes (the JAX run's last frame holds its whole
log); the counterexample; frames and resume; per-level records; and the
CLI's ``-sharded-engine host`` / ``-sharded-dedup hash`` lines against
the JAX CLI's.  Tolerance: exact equality."""

import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu.engine.sharded import ShardedChecker as JSharded
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.parallel.mesh import make_mesh2d as jmesh2d
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.engine import sharded
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.parallel.mesh import make_mesh2d
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from tests.helpers import SMALL_CONFIGS, assert_valid_counterexample

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

PON = SMALL_CONFIGS["producer_on"]
SPEC = "specs/compaction.tla"
LEAK = "CompactedLedgerLeak"
MESHES = [(2, 1), (4, 1), (4, 2)]  # (shards, slices)


def _port(c):
    return CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


def test_bucket_matches_jax():
    """Stable by destination, dense ``[n_dest * L]`` blocks, invalid
    lanes dropped: values and valid flags equal the JAX ``_bucket``'s."""
    rng = np.random.default_rng(4)
    L, nd = 3000, 4
    dest = rng.integers(0, nd, size=L).astype(np.int32)
    valid = rng.random(L) < 0.7
    vals = rng.integers(0, 2**31, size=(L, 3)).astype(np.int32)
    par = rng.integers(-1, 10**5, size=L).astype(np.int32)
    jck = JSharded(JModel(PON), n_devices=1)
    jv, (jvals, jpar) = jck._bucket(jnp.asarray(dest), jnp.asarray(valid),
                                    (jnp.asarray(vals), jnp.asarray(par)), nd)
    v, (tv, tp) = sharded.bucket(torch.from_numpy(dest),
                                 torch.from_numpy(valid),
                                 (torch.from_numpy(vals),
                                  torch.from_numpy(par)), nd)
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert np.array_equal(tv.numpy(), np.asarray(jvals))
    assert np.array_equal(tp.numpy(), np.asarray(jpar))


def _jmesh(n, slices):
    return jmesh2d(slices, n // slices) if slices > 1 else None


@pytest.fixture(scope="module")
def jax_logs(tmp_path_factory):
    """Each mesh and dedup mode's JAX run and its whole log (from its
    last frame: a frame every level)."""
    out = {}
    d = tmp_path_factory.mktemp("jax_sharded_host")
    for dedup in ("sort", "hash"):
        for n, slices in MESHES:
            path = str(d / f"{dedup}{n}{slices}.npz")
            jr = JSharded(JModel(PON), n_devices=n, invariants=(),
                          frontier_chunk=64, visited_cap=1 << 12,
                          mesh=_jmesh(n, slices), dedup_mode=dedup,
                          checkpoint_path=path, checkpoint_every=1).run()
            f = np.load(path)
            out[dedup, n, slices] = (jr, f["packed"], f["parent"],
                                     f["action"])
    return out


@pytest.mark.parametrize("n,slices", MESHES)
@pytest.mark.parametrize("dedup", ["sort", "hash"])
def test_log_equals_jax(jax_logs, dedup, n, slices):
    """Rows, parents and action ids record for record (owners' lanes in
    key order or lane order, shard by shard), from a tiny visited set
    (fourfold growth: padding or rehash)."""
    jr, *want = jax_logs[dedup, n, slices]
    ck = sharded.ShardedChecker(_port(PON), invariants=(), frontier_chunk=64,
                                visited_cap=1 << 6, dedup_mode=dedup,
                                mesh=make_mesh2d(slices, n // slices, "cpu"))
    r = ck.run()
    assert (r.distinct_states, r.level_sizes) == (jr.distinct_states,
                                                  jr.level_sizes)
    lg = ck.last_log
    for a, b in zip((lg.packed_matrix(), lg.parents(), lg.actions()), want):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def jax_leak():
    return JSharded(JModel(pe.SHIPPED_CFG), n_devices=4, invariants=(LEAK,),
                    frontier_chunk=1024, dedup_mode="hash").run()


def test_counterexample_equals_jax(jax_leak):
    ck = sharded.ShardedChecker(_port(pe.SHIPPED_CFG), n_devices=4,
                                invariants=(LEAK,), frontier_chunk=1024,
                                dedup_mode="hash", device="cpu")
    r = ck.run()
    assert (r.violation, r.diameter, r.level_sizes) == (
        jax_leak.violation, jax_leak.diameter, jax_leak.level_sizes)
    assert [tuple(s) for s in r.trace] == [tuple(s) for s in jax_leak.trace]
    assert r.trace_actions == jax_leak.trace_actions
    assert_valid_counterexample(pe.SHIPPED_CFG,
                                [pe.State(*s) for s in r.trace],
                                r.trace_actions, LEAK)


@pytest.mark.parametrize("dedup", ["sort", "hash"])
def test_truncate_resume_and_metrics(tmp_path, dedup):
    """A state budget stops at a level boundary with a frame; the resumed
    run's log equals the uninterrupted one's; the records carry the JAX
    keys and are rewound to the frame's level."""
    kw = dict(invariants=(), frontier_chunk=64, dedup_mode=dedup,
              n_devices=4, device="cpu")
    full = sharded.ShardedChecker(_port(PON), **kw)
    rf = full.run()
    path, mpath = str(tmp_path / "s.npz"), str(tmp_path / "m.jsonl")
    r = sharded.ShardedChecker(_port(PON), checkpoint_path=path,
                               max_states=600, metrics_path=mpath,
                               **kw).run()
    assert r.truncated
    recs = [json.loads(x) for x in open(mpath)]
    assert set(recs[0]) == {"level", "new_states", "distinct_states",
                            "frontier", "wall_s", "states_per_sec",
                            "visited_cap_per_shard", "n_shards"}
    res = sharded.ShardedChecker(_port(PON), checkpoint_path=path,
                                 metrics_path=mpath, **kw)
    r2 = res.run(resume=True)
    assert r2.level_sizes == rf.level_sizes
    for a, b in ((res.last_log.packed_matrix(),
                  full.last_log.packed_matrix()),
                 (res.last_log.parents(), full.last_log.parents()),
                 (res.last_log.actions(), full.last_log.actions())):
        assert np.array_equal(a, b)
    recs = [json.loads(x) for x in open(mpath)]
    assert {"resumed_at_level": len(r.level_sizes)} in recs
    assert recs[-1]["level"] == len(rf.level_sizes)


def _summary(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith(("Finished in", "tpu-tlc: checking",
                                  "tpu-tlc: mesh-sharded"))]


@pytest.mark.parametrize("argv", [
    ("-sharded", "2", "-sharded-dedup", "hash", "-invariant",
     "DuplicateNullKeyMessage"),
    ("-sharded", "4", "-slices", "2", "-sharded-engine", "host",
     "-invariant", "DuplicateNullKeyMessage"),
])
def test_cli_lines_equal_jax(argv, capsys):
    """The JAX CLI's summary and exit code (its note on ``-sharded-dedup
    hash`` included)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrc = jcli.main(["check", SPEC, *argv])
    rc = cli.main(["check", SPEC, "-cpu", *argv])
    out = capsys.readouterr().out
    assert (rc, _summary(out)) == (jrc, _summary(buf.getvalue()))
    assert "mesh-sharded (host-staged) over" in out
