"""The port's spec->kernel compiler (``pulsar_tlaplus_tpu_torch/frontend/
codegen.py``) against the JAX package's ``CompiledSpec``, on the CPU:

- per spec: the ``DescCodec`` fields, ``total_bits`` and ``W``, the
  lanes (labels, ``A``, ``action_ids``) and the descriptors equal JAX's;
  lane order and successor sets equal the port's interpreter's;
- every initial state packs to the JAX words (host-enumerated inits and
  the factored counting init, 43M states at MessageSentLimit 8);
- ``successors`` (packed words and ``valid``), every invariant and every
  liveness goal equal JAX's under ``jax.vmap`` on >= 512 reachable
  states of each spec (a BFS of the JAX interpreter, encoded by the JAX
  codegen, carried over with ``from_jax_state``), at two batch buckets;
- the batched functions walk the AST once per bucket, and the replayed
  graph equals the eager walk.

The engines on compiled models: ``tests/test_torch_codegen_engine.py``.

vmap's "performance drop" warning (an op without a batching rule) is an
error here.  Tolerance: exact equality (integer work)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# recording a graph (a dispatch mode) imports torch._dynamo, which
# imports cProfile and with it the stdlib ``profile``; other test
# modules put scripts/ (it has a profile.py) first on sys.path while
# they run, so import it here, at collection, before they do
import torch._dynamo  # noqa: F401,E402

from pulsar_tlaplus_tpu.frontend import codegen as jcg
from pulsar_tlaplus_tpu.frontend import interp as JI
from pulsar_tlaplus_tpu.frontend import loader as jloader
from pulsar_tlaplus_tpu.frontend.codegen_ir import encode_value as j_encode
from pulsar_tlaplus_tpu.frontend.parser import parse_file as j_parse
from pulsar_tlaplus_tpu.utils import cfg as jcfg
from pulsar_tlaplus_tpu_torch.frontend import codegen as tcg
from pulsar_tlaplus_tpu_torch.frontend import interp as TI
from pulsar_tlaplus_tpu_torch.frontend import loader as tloader
from pulsar_tlaplus_tpu_torch.frontend.codegen_ir import build_scope
from pulsar_tlaplus_tpu_torch.frontend.parser import parse_file as t_parse
from pulsar_tlaplus_tpu_torch.ops.packing import tree_leaves
from pulsar_tlaplus_tpu_torch.ref import pyeval as tpe
from pulsar_tlaplus_tpu_torch.utils import cfg as tcfg

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SPEC_NAMES = ("compaction", "subscription", "bookkeeper", "georeplication")

# binding -> (spec, constant overrides of specs/SPEC.cfg)
BINDINGS = {
    "compaction": ("compaction", {}),
    "subscription": ("subscription", {}),
    "bookkeeper": ("bookkeeper", {}),
    "georeplication": ("georeplication", {}),
    # >= 512 states (the shipped cfg has 297)
    "bookkeeper_wide": ("bookkeeper", {"NumBookies": 4, "WriteQuorum": 3}),
    "compaction_producer": ("compaction", {"ModelProducer": True,
                                           "RetainNullKey": False}),
}


def _bind(spec, overrides):
    """(JAX Spec, port Spec) of specs/SPEC.tla at its cfg + overrides."""
    path = os.path.join(SPECS, f"{spec}.tla")
    cfg = os.path.join(SPECS, f"{spec}.cfg")
    out = []
    for parse, loader, cfgmod, I in (
        (j_parse, jloader, jcfg, JI), (t_parse, tloader, tcfg, TI)
    ):
        ast = parse(path)
        consts = loader.bind_cfg(ast, cfgmod.load(cfg))
        consts.pop("__string_interning__")
        consts.update(overrides)
        out.append(I.Spec(ast, consts))
    return out


def _invariants(spec):
    return tuple(tcfg.load(os.path.join(SPECS, f"{spec}.cfg")).invariants)


@pytest.fixture(scope="module")
def compiled():
    """(JAX CompiledSpec, port CompiledSpec) per binding, built once."""
    cache = {}

    def get(binding):
        if binding not in cache:
            spec, over = BINDINGS[binding]
            js, ts = _bind(spec, over)
            inv = _invariants(spec)
            cache[binding] = (jcg.CompiledSpec(js, invariants=inv),
                              tcg.CompiledSpec(ts, invariants=inv,
                                               device="cpu"))
        return cache[binding]

    return get


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("spec", SPEC_NAMES)
def test_codec_lanes_and_descriptors_equal_jax(spec, compiled):
    jcs, tcs = compiled(spec)
    assert [f[:3] for f in tcs.layout._codec.fields] == [
        f[:3] for f in jcs.layout._codec.fields
    ]
    assert (tcs.layout.total_bits, tcs.layout.W) == (
        jcs.layout.total_bits, jcs.layout.W)
    assert repr(tcs.var_descs) == repr(jcs.var_descs)
    assert tcs.lane_labels == jcs.lane_labels
    assert tcs.A == jcs.A
    assert tcs.action_names == jcs.action_names
    assert np.array_equal(tcs.action_ids, jcs.action_ids)
    assert tcs.n_initial == jcs.n_initial
    assert tcs.default_invariants == jcs.default_invariants
    assert sorted(tcs.liveness_goals) == sorted(jcs.liveness_goals)


def test_lane_order_matches_interpreter():
    """Per-state successor sets equal the port's interpreter's, lane by
    lane in its enumeration order (tests/test_codegen.py:85 on the
    port), on the first levels of a small compaction binding."""
    c = tpe.Constants(message_sent_limit=2, compaction_times_limit=2,
                      num_keys=1, num_values=1, max_crash_times=1,
                      model_producer=True)
    module = t_parse(os.path.join(SPECS, "compaction.tla"))
    spec = TI.Spec(module, tloader.compaction_constants(c))
    TI.install_defs(spec)
    cs = tcg.CompiledSpec(spec, device="cpu")
    frontier = spec.initial_states()
    seen = set(frontier)
    for _lvl in range(4):
        batch = frontier[:40]
        enc = [{v: tcg.encode_value(cs.var_descs[v], val)
                for v, val in zip(spec.vars, s)} for s in batch]
        for e in enc:
            e[tcg.ERR_VAR] = np.bool_(False)
        tree = tcg.tree_map(lambda *xs: np.stack(xs), *enc)
        succ, valid = cs.successors(cs.from_jax_state(tree))
        nxt = []
        for b, s in enumerate(batch):
            want = [(a, t) for a, t in spec.successors(s)]
            got = []
            for k in range(cs.A):
                if not bool(valid[b, k]):
                    continue
                one = tcg.tree_map(lambda x: x[b, k][None], succ)
                assert not bool(one[tcg.ERR_VAR][0])
                dec = cs.decode_state(one)
                got.append((cs.lane_labels[k],
                            tuple(dec[v] for v in spec.vars)))
            assert {t for _a, t in got} == {t for _a, t in want}
            for _a, t in want:
                if t not in seen:
                    seen.add(t)
                    nxt.append(t)
        frontier = nxt


def _jax_pack_init(jcs, idx):
    return np.asarray(jax.jit(jax.vmap(
        lambda i: jcs.layout.pack(jcs.gen_initial(i))))(jnp.asarray(
            idx, jnp.int32)))


@pytest.mark.parametrize("spec", SPEC_NAMES)
def test_initial_states_pack_equal_jax(spec, compiled):
    jcs, tcs = compiled(spec)
    idx = np.arange(min(tcs.n_initial, 2048))
    got = tcs.layout.pack(tcs.gen_initial(torch.as_tensor(idx)))
    assert np.array_equal(_words(got), _jax_pack_init(jcs, idx))


def test_factored_counting_init_equals_jax():
    """The mixed-radix counting init (tests/test_codegen.py:131): 43M
    initial states at MessageSentLimit 8, sampled."""
    js, ts = _bind("compaction", {"MessageSentLimit": 8})
    jcs = jcg.CompiledSpec(js)
    tcs = tcg.CompiledSpec(ts, device="cpu")
    assert tcs._factored_init is not None
    assert tcs.n_initial == jcs.n_initial == 9 ** 8
    rng = np.random.default_rng(8)
    idx = np.concatenate([[0, 1, 12345, tcs.n_initial - 1],
                          rng.integers(0, tcs.n_initial, 1020)])
    got = tcs.layout.pack(tcs.gen_initial(torch.as_tensor(idx)))
    assert np.array_equal(_words(got), _jax_pack_init(jcs, idx))


def _reachable(spec, n):
    """The first ``n`` states of a BFS of the JAX interpreter."""
    JI.install_defs(spec)
    frontier = list(spec.initial_states())
    seen = dict.fromkeys(frontier)
    while frontier and len(seen) < n:
        nxt = []
        for s in frontier:
            for _a, t in spec.successors(s):
                if t not in seen:
                    seen[t] = None
                    nxt.append(t)
        frontier = nxt
    return list(seen)[:n]


def _jax_tree(jcs, states):
    rows = []
    for s in states:
        d = {v: j_encode(jcs.var_descs[v], val)
             for v, val in zip(jcs.spec.vars, s)}
        d[jcg.ERR_VAR] = np.bool_(False)
        rows.append(d)
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *rows)


@pytest.mark.parametrize("binding", ["compaction", "subscription",
                                     "bookkeeper_wide", "georeplication"])
def test_model_equals_jax_on_reachable_states(binding, compiled):
    """successors (as packed words), valid, every invariant and every
    liveness goal, array-equal to JAX's on 1,024 reachable states, at
    two buckets (1,024 rows, and 300 rows padded to 1,024)."""
    jcs, tcs = compiled(binding)
    jtree = _jax_tree(jcs, _reachable(jcs.spec, 1024))  # installs its defs
    assert len(jtree[jcg.ERR_VAR]) >= 512
    jsucc, jvalid = jax.jit(jax.vmap(jcs.successors))(jtree)
    jwords = np.asarray(jax.jit(jax.vmap(jax.vmap(jcs.layout.pack)))(jsucc))
    jinv = {n: np.asarray(jax.jit(jax.vmap(f))(jtree))
            for n, f in jcs.invariants.items()}
    jgoal = {n: np.asarray(jax.jit(jax.vmap(f))(jtree))
             for n, f in jcs.liveness_goals.items()}
    full = tcs.from_jax_state(jtree)
    for n in (len(jtree[jcg.ERR_VAR]), 300):
        tree = tcg.tree_map(lambda x: x[:n], full)
        succ, valid = tcs.successors(tree)
        assert np.array_equal(_words(tcs.layout.pack(succ)), jwords[:n])
        assert np.array_equal(valid.numpy(), np.asarray(jvalid)[:n])
        for name, fn in tcs.invariants.items():
            assert np.array_equal(fn(tree).numpy(), jinv[name][:n]), name
        for name, fn in tcs.liveness_goals.items():
            assert np.array_equal(fn(tree).numpy(), jgoal[name][:n]), name
        # the port's unpack inverts its pack on the successors
        words = tcs.layout.pack(succ)
        assert torch.equal(tcs.layout.pack(tcs.layout.unpack(words)), words)


def test_ast_walked_once_per_bucket():
    """The first call at a bucket walks the AST (recording its graph);
    later calls at that bucket replay it without walking, and the
    replay equals an eager walk of the same states."""
    _js, ts = _bind("subscription", {})
    cs = tcg.CompiledSpec(ts, invariants=_invariants("subscription"),
                          device="cpu")
    s0 = cs.gen_initial(torch.zeros(5, dtype=torch.int64))
    walks = cs.walks
    succ0, _valid0 = cs.successors(s0)  # records the 1,024-row bucket
    assert cs.walks == walks + 1
    s = cs.layout.unpack(
        cs.layout.pack(succ0).reshape(-1, cs.layout.W))  # 65 lanes' states
    builds, walks = cs.graph_builds, cs.walks
    succ, valid = cs.successors(s)
    succ2, valid2 = cs.successors(tcg.tree_map(lambda x: x[:7], s))
    assert (cs.walks, cs.graph_builds) == (walks, builds)
    with build_scope(cs._build_on(s[tcg.ERR_VAR].device)):
        esucc, evalid = torch.func.vmap(cs._successors1)(s)
    assert cs.walks == walks + 1
    assert torch.equal(valid, evalid) and torch.equal(valid2, evalid[:7])
    for a, b in zip(tree_leaves(succ), tree_leaves(esucc)):
        assert torch.equal(a, b)
    assert torch.equal(cs.layout.pack(succ2), cs.layout.pack(succ)[:7])


@pytest.mark.parametrize("inplace", [False, True])
def test_record_refuses_in_place_ops(inplace):
    """A recorded graph folds and merges nodes as pure: recording a
    function that writes a tensor in place raises instead of yielding a
    graph whose replays would change its own constants."""
    from pulsar_tlaplus_tpu_torch.frontend.record import record

    def fn(d):
        y = d["x"] * 2
        return y.add_(1) if inplace else y + 1

    x = {"x": torch.arange(6, dtype=torch.int32).reshape(3, 2)}
    if inplace:
        with pytest.raises(RuntimeError, match="in place"):
            record(torch.func.vmap(fn), x)
        return
    g = record(torch.func.vmap(fn), x)
    for _ in range(2):  # replays leave the graph's constants as they were
        assert torch.equal(g({"x": x["x"] + 5}), (x["x"] + 5) * 2 + 1)
