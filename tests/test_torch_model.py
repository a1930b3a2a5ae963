"""The port's packed-state codec and batched model against the JAX
package, on the CPU: the same oracle states (sampled from the copied
``pyeval`` BFS) go through both sides.  Tolerance: exact equality
(integer work)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.ops.packing import SState as JState
from pulsar_tlaplus_tpu.ref import pyeval as pe
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.ops.packing import smap
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from tests.helpers import SMALL_CONFIGS, oracle_sample

CONFIGS = dict(SMALL_CONFIGS)
# the scaled config of bench.py: 618-bit states in W=20 words, A=34
CONFIGS["scaled"] = pe.Constants(
    message_sent_limit=64, compaction_times_limit=3, num_keys=8,
    num_values=2, retain_null_key=True, max_crash_times=3,
    model_producer=True, model_consumer=False,
)
CONFIGS["producer_no_retain"] = dataclasses.replace(
    pe.SHIPPED_CFG, model_producer=True, retain_null_key=False
)


def _models(c):
    return JModel(c), CompactionModel(tpe.Constants(**dataclasses.asdict(c)))


@functools.lru_cache(maxsize=None)
def _sample(name):
    # three levels of the scaled config are already 813 states
    levels = 3 if name == "scaled" else 4
    return tuple(oracle_sample(CONFIGS[name], n_states=80, levels=levels))


def _batches(name, jm, tm):
    """The same sample as a stacked JAX SState and a port SState."""
    samp = _sample(name)
    js = [jm.from_pystate(s) for s in samp]
    jst = JState(*[
        jnp.asarray(np.stack([getattr(x, f) for x in js]))
        for f in JState._fields
    ])
    tst = smap(
        lambda *xs: torch.cat(xs),
        *[tm.from_pystate(tpe.State(*s)) for s in samp],
    )
    return samp, jst, tst


def _words(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layout_pack_unpack(name):
    """Packed words equal the JAX ``Layout.pack`` on oracle samples, and
    unpack inverts pack (back to the same oracle states)."""
    c = CONFIGS[name]
    jm, tm = _models(c)
    assert (tm.layout.W, tm.layout.total_bits) == (
        jm.layout.W, jm.layout.total_bits
    )
    samp, jst, tst = _batches(name, jm, tm)
    words = tm.layout.pack(tst)
    assert np.array_equal(
        _words(words), np.asarray(jax.jit(jax.vmap(jm.layout.pack))(jst))
    )
    back = tm.layout.unpack(words)
    for f in tst._fields:
        assert torch.equal(getattr(back, f), getattr(tst, f)), f
    for i, s in enumerate(samp):
        assert tuple(tm.to_pystate(back, i)) == tuple(s)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_successors_lane_for_lane(name):
    """The successor and valid planes equal ``vmap(successors)`` lane
    for lane (compared packed), as do the invariants and the stutter
    flags."""
    c = CONFIGS[name]
    jm, tm = _models(c)
    assert tm.A == jm.A and list(tm.action_ids) == list(jm.action_ids)
    _samp, jst, tst = _batches(name, jm, tm)
    jsucc, jvalid = jax.jit(jax.vmap(jm.successors))(jst)
    tsucc, tvalid = tm.successors(tst)
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert np.array_equal(
        _words(tm.layout.pack(tsucc)),
        np.asarray(jax.jit(jax.vmap(jax.vmap(jm.layout.pack)))(jsucc)),
    )
    for inv, fn in jm.invariants.items():
        assert np.array_equal(
            tm.invariants[inv](tst).numpy(),
            np.asarray(jax.jit(jax.vmap(fn))(jst)),
        ), inv
    assert np.array_equal(
        tm.stutter_enabled(tst).numpy(),
        np.asarray(jax.vmap(jm.stutter_enabled)(jst)),
    )


@pytest.mark.parametrize("name", ["shipped", "no_retain", "scaled"])
def test_gen_initial(name):
    """Mixed-radix initial states equal the JAX decode (729 at the
    shipped cfg), packed."""
    c = CONFIGS[name]
    jm, tm = _models(c)
    assert tm.n_initial == jm.n_initial
    n = min(tm.n_initial, 729)
    idx = np.arange(n)
    want = jax.vmap(jm.layout.pack)(
        jax.vmap(jm.gen_initial)(jnp.asarray(idx, jnp.int32))
    )
    got = tm.layout.pack(tm.gen_initial(torch.as_tensor(idx)))
    assert np.array_equal(_words(got), np.asarray(want))


def test_replay_trace_matches_oracle_successors():
    """``replay_trace`` and the generic ``replay_lane_trace`` (through
    the batched successors) rebuild the same behavior."""
    from pulsar_tlaplus_tpu_torch.engine.core import replay_lane_trace

    c = tpe.Constants(**dataclasses.asdict(SMALL_CONFIGS["producer_on"]))
    tm = CompactionModel(c)
    npl = tm.n_producer_lanes
    lanes = [0, npl, npl + 1, npl + 2, 3]
    a = tm.replay_trace(0, lanes)
    b = replay_lane_trace(tm, 0, lanes)
    assert a == b
    assert a[1][0] == "Producer" and a[1][1] == "CompactorPhaseOne"
