"""Record a tensor function once as an ATen graph and replay it — the
port's counterpart of tracing a function once under ``jax.jit``.

:func:`record` runs ``fn`` on real inputs under a dispatch mode that
logs every ATen call it reaches (after ``torch.func.vmap`` has batched
it), and builds a ``torch.fx`` graph of them: the inputs' leaves are the
placeholders, every tensor the function did not compute from them (a
device constant of the codegen's cache) is a graph attribute, and the
output tree is rebuilt from the graph's outputs.  The graph replays
exactly on new inputs of the same shapes, dtypes and devices: the
recorded function must not branch in Python on tensor data (the
codegen's per-state walks do not; neither does vmap), and must write no
tensor in place (recording raises at the first ATen op that does).

It records what ``make_fx(..., tracing_mode="real")`` records, without
its per-op metadata snapshots (a fresh ``FakeTensorMode`` and a stack
trace for every output), which cost ~1 ms a node on the codegen's deep
walks.
"""

from __future__ import annotations

import operator
from typing import Callable, List

import torch
import torch.fx
from torch.utils._python_dispatch import TorchDispatchMode

from pulsar_tlaplus_tpu_torch.ops.packing import tree_leaves


def _unflatten(tree, leaves):
    """``tree`` with its leaves (in ``tree_leaves`` order) replaced."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            vals = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(rebuild(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(rebuild(x) for x in t)
        return next(it)

    return rebuild(tree)


class _Recorder(TorchDispatchMode):
    """Logs ATen calls into an fx graph while running them."""

    def __init__(self, graph: torch.fx.Graph, root: torch.nn.Module):
        super().__init__()
        self.graph = graph
        self.root = root
        self.nodes = {}  # id(tensor) -> fx node
        self.alive: List[torch.Tensor] = []  # pins ids for the recording
        self.n_consts = 0

    def node_of(self, t: torch.Tensor):
        n = self.nodes.get(id(t))
        if n is None:
            name = f"_const{self.n_consts}"
            self.n_consts += 1
            self.root.register_buffer(name, t, persistent=False)
            n = self.graph.get_attr(name)
            self.nodes[id(t)] = n
            self.alive.append(t)
        return n

    def lift(self, a):
        if isinstance(a, torch.Tensor):
            return self.node_of(a)
        if isinstance(a, (list, tuple)):
            return type(a)(self.lift(x) for x in a)
        if isinstance(a, dict):
            return {k: self.lift(v) for k, v in a.items()}
        return a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.is_mutable:
            # a replay would write to the graph's constants or reuse a
            # value from before the write (folding and merging assume
            # pure nodes)
            raise RuntimeError(f"record: {func} writes a tensor in place; "
                               "a recorded function must be pure")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        node = self.graph.call_function(
            func, self.lift(tuple(args)), self.lift(kwargs)
        )
        if isinstance(out, torch.Tensor):
            self.nodes[id(out)] = node
            self.alive.append(out)
        elif isinstance(out, (tuple, list)):
            for i, o in enumerate(out):
                if isinstance(o, torch.Tensor):
                    self.nodes[id(o)] = self.graph.call_function(
                        operator.getitem, (node, i)
                    )
                    self.alive.append(o)
        return out


class Recorded:
    """A recorded graph: call it on a tree shaped like the recording's
    input; returns a tree shaped like its output."""

    def __init__(self, module: torch.fx.GraphModule, out_tree):
        self.module = module
        self.out_tree = out_tree
        self.n_nodes = len(module.graph.nodes)

    def __call__(self, x):
        return _unflatten(self.out_tree, self.module(*tree_leaves(x)))


def record(fn: Callable, x) -> Recorded:
    """Run ``fn(x)`` once on real tensors and return its graph."""
    graph = torch.fx.Graph()
    root = torch.nn.Module()
    rec = _Recorder(graph, root)
    leaves = tree_leaves(x)
    for i, t in enumerate(leaves):
        rec.nodes[id(t)] = graph.placeholder(f"x{i}")
        rec.alive.append(t)
    with rec:
        out = fn(x)
    out_leaves = tree_leaves(out)
    graph.output(tuple(rec.node_of(t) for t in out_leaves))
    _fold_and_merge(graph, root)
    module = torch.fx.GraphModule(root, graph)
    module.graph.eliminate_dead_code()
    module.recompile()
    return Recorded(module, _unflatten(out, [None] * len(out_leaves)))


FOLD_MAX_NUMEL = 1 << 12  # a folded constant is at most this large


def _hashable(a):
    if isinstance(a, (list, tuple)):
        return tuple(_hashable(x) for x in a)
    if isinstance(a, dict):
        return tuple(sorted((k, _hashable(v)) for k, v in a.items()))
    hash(a)
    return a


def _fold_and_merge(graph: torch.fx.Graph, root: torch.nn.Module) -> None:
    """Shrink the recorded graph without changing what it computes:
    a pure call whose tensor inputs are all constants (the codegen's
    lifted values, ``arange``, scalar wrappers) is computed once now and
    becomes a constant when small; a pure call equal to an earlier one
    (same op, same inputs) is replaced by it.  Each node costs a replay
    its host dispatch, so both cut the host time of every window."""
    values = {}  # constant node -> its tensor
    for node in graph.nodes:
        if node.op == "get_attr":
            values[node] = getattr(root, node.target)
    seen = {}
    n_folded = 0
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if not hasattr(node.target, "_schema"):  # operator.getitem
            continue
        inputs = node.all_input_nodes
        if all(n in values for n in inputs):
            args = torch.fx.node.map_arg(node.args, lambda n: values[n])
            kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: values[n])
            val = node.target(*args, **kwargs)
            if (isinstance(val, torch.Tensor)
                    and val.numel() <= FOLD_MAX_NUMEL):
                name = f"_fold{n_folded}"
                n_folded += 1
                root.register_buffer(name, val, persistent=False)
                with graph.inserting_before(node):
                    const = graph.get_attr(name)
                values[const] = val
                node.replace_all_uses_with(const)
                graph.erase_node(node)
                continue
        try:
            key = (node.target, _hashable(node.args),
                   _hashable(node.kwargs))
        except TypeError:
            continue
        prev = seen.get(key)
        if prev is None:
            seen[key] = node
        else:
            node.replace_all_uses_with(prev)
            graph.erase_node(node)
