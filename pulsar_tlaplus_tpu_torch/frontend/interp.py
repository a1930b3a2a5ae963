"""Generic structural interpreter for the TLA+ subset — the universal
semantic oracle (host side).

Evaluates any parsed module (SURVEY.md §1-L2 operator set) with a fixed
constants binding: initial-state enumeration, successor enumeration
(nondeterminism via ``\\E`` / disjunction / ``x' \\in S`` branching),
invariant evaluation, and a simple explicit-state BFS — i.e. a miniature
TLC.  The batched codegen (:mod:`.codegen`) is differential-tested against
this module; this module is differential-tested against the hand-written
``ref/pyeval.py`` oracle on the compaction spec.

Value canon (hashable):
  int | bool | str | MV(model value) | tuple (sequence == fn over 1..n)
  | FDict (record / general function) | frozenset (set).
Functions whose domain is exactly ``1..n`` normalize to tuples, matching
TLC's "sequences are functions" equality.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from pulsar_tlaplus_tpu_torch.frontend import tla_ast as A


class EvalError(ValueError):
    pass


# --------------------------------------------------------------------------
# values
# --------------------------------------------------------------------------


class MV:
    """Interned model value (e.g. Nil, Compactor_In_PhaseOne)."""

    _interned: Dict[str, "MV"] = {}
    __slots__ = ("name",)

    def __new__(cls, name: str):
        mv = cls._interned.get(name)
        if mv is None:
            mv = object.__new__(cls)
            mv.name = name
            cls._interned[name] = mv
        return mv

    def __repr__(self):
        return self.name

    def __hash__(self):
        return hash(("MV", self.name))

    def __eq__(self, other):
        return self is other or (
            isinstance(other, MV) and other.name == self.name
        )


class FDict:
    """Immutable function/record: sorted items tuple, hashable."""

    __slots__ = ("items", "_map", "_hash")

    def __init__(self, mapping: Dict):
        self.items = tuple(sorted(mapping.items(), key=lambda kv: _sort_key(kv[0])))
        self._map = dict(self.items)
        self._hash = hash(("FDict", self.items))

    def keys(self):
        return self._map.keys()

    def __getitem__(self, k):
        return self._map[k]

    def __contains__(self, k):
        return k in self._map

    def __len__(self):
        return len(self.items)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, FDict) and self.items == other.items

    def __repr__(self):
        return "[" + ", ".join(f"{k} |-> {v!r}" for k, v in self.items) + "]"


def _sort_key(v):
    """Deterministic cross-type ordering (for CHOOSE and FDict canon)."""
    if isinstance(v, bool):
        return (0, v)
    if isinstance(v, int):
        return (1, v)
    if isinstance(v, str):
        return (2, v)
    if isinstance(v, MV):
        return (3, v.name)
    if isinstance(v, tuple):
        return (4, tuple(_sort_key(x) for x in v))
    if isinstance(v, FDict):
        return (5, tuple((_sort_key(k), _sort_key(x)) for k, x in v.items))
    if isinstance(v, frozenset):
        return (6, tuple(sorted(_sort_key(x) for x in v)))
    raise EvalError(f"unorderable value {v!r}")


def make_fn(mapping: Dict):
    """Function constructor with the 1..n => tuple normalization."""
    n = len(mapping)
    if n == 0:
        return ()  # empty function == empty sequence (TLC: <<>>)
    ks = mapping.keys()
    if all(isinstance(k, int) and not isinstance(k, bool) for k in ks):
        if set(ks) == set(range(1, n + 1)):
            return tuple(mapping[i] for i in range(1, n + 1))
    return FDict(mapping)


# Lazy infinite/huge spaces -------------------------------------------------


class Space:
    """A set we can test membership in (and maybe enumerate)."""

    def __contains__(self, v) -> bool:
        raise NotImplementedError

    def enumerate(self) -> Iterator:
        raise EvalError(f"cannot enumerate {self!r}")


class NatSpace(Space):
    def __contains__(self, v):
        return isinstance(v, int) and not isinstance(v, bool) and v >= 0

    def __repr__(self):
        return "Nat"


class IntSpace(Space):
    def __contains__(self, v):
        return isinstance(v, int) and not isinstance(v, bool)

    def __repr__(self):
        return "Int"


class BoolSpace(Space):
    def __contains__(self, v):
        return isinstance(v, bool)

    def enumerate(self):
        return iter((False, True))

    def __repr__(self):
        return "BOOLEAN"


class PowerSpace(Space):
    """SUBSET S"""

    def __init__(self, base):
        self.base = base

    def __contains__(self, v):
        if not isinstance(v, frozenset):
            return False
        return all(x in _as_container(self.base) for x in v)

    def enumerate(self):
        elems = sorted(_enum_set(self.base), key=_sort_key)
        for r in range(len(elems) + 1):
            for combo in itertools.combinations(elems, r):
                yield frozenset(combo)

    def __repr__(self):
        return f"SUBSET {self.base!r}"


class FnSpaceV(Space):
    """[S -> T] — set of total functions S -> T."""

    def __init__(self, domain: frozenset, codomain):
        self.domain = domain
        self.codomain = codomain

    def __contains__(self, v):
        dom = sorted(self.domain, key=_sort_key)
        if isinstance(v, tuple):
            if set(self.domain) != set(range(1, len(v) + 1)):
                return False
            return all(x in _as_container(self.codomain) for x in v)
        if isinstance(v, FDict):
            if set(v.keys()) != set(self.domain):
                return False
            return all(
                v[k] in _as_container(self.codomain) for k in dom
            )
        return False

    def enumerate(self):
        dom = sorted(self.domain, key=_sort_key)
        cod = sorted(_enum_set(self.codomain), key=_sort_key)
        for combo in itertools.product(cod, repeat=len(dom)):
            yield make_fn(dict(zip(dom, combo)))

    def __repr__(self):
        return f"[{set(self.domain)!r} -> {self.codomain!r}]"


class RecordSpaceV(Space):
    """[f1: S1, ...] — set of records."""

    def __init__(self, fields: Tuple[Tuple[str, object], ...]):
        self.fields = fields

    def __contains__(self, v):
        if not isinstance(v, FDict):
            return False
        if set(v.keys()) != {f for f, _ in self.fields}:
            return False
        return all(v[f] in _as_container(s) for f, s in self.fields)

    def enumerate(self):
        names = [f for f, _ in self.fields]
        spaces = [sorted(_enum_set(s), key=_sort_key) for _, s in self.fields]
        for combo in itertools.product(*spaces):
            yield FDict(dict(zip(names, combo)))

    def __repr__(self):
        return f"[{', '.join(f'{f}: …' for f, _ in self.fields)}]"


def _as_container(s):
    if isinstance(s, (frozenset, Space)):
        return s
    raise EvalError(f"not a set: {s!r}")


def _enum_set(s) -> Iterable:
    if isinstance(s, frozenset):
        return s
    if isinstance(s, Space):
        return s.enumerate()
    raise EvalError(f"not an enumerable set: {s!r}")


# --------------------------------------------------------------------------
# environment
# --------------------------------------------------------------------------


@dataclass
class OpDef:
    params: Tuple[str, ...]
    body: A.Node
    env: "Env"


class Thunk:
    """Lazy, memoized LET binding (TLC evaluates LET defs on demand —
    required for the vacuous-guard patterns, SURVEY.md C23)."""

    __slots__ = ("fn", "done", "value")

    def __init__(self, fn):
        self.fn = fn
        self.done = False
        self.value = None

    def force(self):
        if not self.done:
            self.value = self.fn()
            self.done = True
        return self.value


class Env:
    """Chained scope: name -> value | OpDef | Thunk."""

    __slots__ = ("table", "parent")

    def __init__(self, table=None, parent: Optional["Env"] = None):
        self.table = table if table is not None else {}
        self.parent = parent

    def lookup(self, name: str):
        e = self
        while e is not None:
            if name in e.table:
                v = e.table[name]
                return v.force() if isinstance(v, Thunk) else v
            e = e.parent
        raise EvalError(f"unbound name {name}")

    def lookup_raw(self, name: str):
        e = self
        while e is not None:
            if name in e.table:
                return e.table[name]
            e = e.parent
        raise EvalError(f"unbound name {name}")

    def child(self, table) -> "Env":
        return Env(table, self)


# --------------------------------------------------------------------------
# the interpreter
# --------------------------------------------------------------------------


class Spec:
    """A parsed module + constants binding, ready to evaluate."""

    def __init__(self, module: A.Module, constants: Dict[str, object]):
        self.module = module
        self.constants = dict(constants)
        self.defs = module.defs_by_name()
        missing = [c for c in module.constants if c not in constants]
        if missing:
            raise EvalError(f"unbound CONSTANTS: {missing}")
        base: Dict[str, object] = {
            "Nat": NatSpace(),
            "Int": IntSpace(),
            "BOOLEAN": BoolSpace(),
        }
        base.update(BUILTINS)
        base.update(constants)
        for d in module.defs:
            if d.params:
                base[d.name] = OpDef(d.params, d.body, None)  # env set below
        self.genv = Env(base)
        for v in base.values():
            if isinstance(v, OpDef):
                v.env = self.genv
        # zero-arg defs become lazy globals (memoized once constants bound),
        # except those that reference VARIABLES (evaluated per state).
        self._state_defs = set()
        varset = set(module.variables)
        for d in module.defs:
            if not d.params and _refs_any(d.body, varset, self.defs):
                self._state_defs.add(d.name)
        for d in module.defs:
            if d.params or d.name in self._state_defs:
                continue
            self.genv.table[d.name] = Thunk(
                lambda b=d.body: eval_expr(b, self.genv)
            )
        self.vars: Tuple[str, ...] = tuple(module.variables)

    # -- assumptions -------------------------------------------------------

    def check_assumes(self) -> None:
        for a in self.module.assumes:
            v = eval_expr(a, self.genv)
            if v is not True:
                raise EvalError(f"ASSUME violated at {a.loc}")

    # -- states ------------------------------------------------------------

    def state_env(self, state: Tuple) -> Env:
        t = dict(zip(self.vars, state))
        env = self.genv.child(t)
        for name in self._state_defs:
            d = self.defs[name]
            t[name] = Thunk(lambda b=d.body, e=env: eval_expr(b, e))
        return env

    def initial_states(self, init_name: str = "Init") -> List[Tuple]:
        _enum._defs = self.defs
        d = self.defs[init_name]
        out = []
        for asg in enum_formula(
            d.body, self.genv, {}, set(self.vars), primed=False
        ):
            missing = [v for v in self.vars if v not in asg]
            if missing:
                raise EvalError(f"Init leaves {missing} unassigned")
            out.append(tuple(asg[v] for v in self.vars))
        return out

    def successors(
        self, state: Tuple, next_name: str = "Next"
    ) -> List[Tuple[str, Tuple]]:
        """[(action_label, successor_state)] — includes self-loops."""
        _enum._defs = self.defs
        env = self.state_env(state)
        d = self.defs[next_name]
        out = []
        for label, asg in enum_action_labeled(
            d.body, env, {}, set(self.vars), None
        ):
            for v in self.vars:
                if v not in asg:
                    raise EvalError(
                        f"action {label or next_name} leaves {v}' unassigned"
                    )
            out.append((label or next_name, tuple(asg[v] for v in self.vars)))
        return out

    def eval_predicate(self, name: str, state: Tuple) -> bool:
        env = self.state_env(state)
        v = eval_expr(self.defs[name].body, env)
        if not isinstance(v, bool):
            raise EvalError(f"{name} is not boolean: {v!r}")
        return v

    def eval_in_state(self, node: A.Node, state: Tuple):
        return eval_expr(node, self.state_env(state))


def _refs_any(node, names: set, defs, _seen=None) -> bool:
    """Does `node` (transitively through zero-arg defs) reference `names`?"""
    if _seen is None:
        _seen = set()
    found = False

    def walk(n):
        nonlocal found
        if found or not isinstance(n, A.Node):
            return
        if isinstance(n, A.Name):
            if n.name in names:
                found = True
            elif n.name in defs and n.name not in _seen:
                _seen.add(n.name)
                walk(defs[n.name].body)
            return
        if isinstance(n, A.Apply) and n.op in defs and n.op not in _seen:
            _seen.add(n.op)
            walk(defs[n.op].body)
        for f in n.__dataclass_fields__:
            v = getattr(n, f)
            if isinstance(v, A.Node):
                walk(v)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, A.Node):
                        walk(x)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, A.Node):
                                walk(y)
                            elif isinstance(y, tuple):
                                for z in y:
                                    if isinstance(z, A.Node):
                                        walk(z)

    walk(node)
    return found


# --------------------------------------------------------------------------
# expression evaluation
# --------------------------------------------------------------------------


def eval_expr(node: A.Node, env: Env):
    k = type(node)
    if k is A.Num:
        return node.value
    if k is A.Bool:
        return node.value
    if k is A.Str:
        return node.value
    if k is A.Name:
        return env.lookup(node.name)
    if k is A.Prime:
        if isinstance(node.expr, A.Name):
            return env.lookup(node.expr.name + "'")
        raise EvalError(f"cannot prime non-variable at {node.loc}")
    if k is A.BinOp:
        return _eval_binop(node, env)
    if k is A.UnOp:
        return _eval_unop(node, env)
    if k is A.Junction:
        if node.op == "/\\":
            for item in node.items:
                if eval_expr(item, env) is not True:
                    return False
            return True
        for item in node.items:
            if eval_expr(item, env) is True:
                return True
        return False
    if k is A.Apply:
        d = env.lookup(node.op)
        if isinstance(d, OpDef):
            if len(d.params) != len(node.args):
                raise EvalError(f"arity mismatch calling {node.op}")
            args = {
                p: eval_expr(a, env) for p, a in zip(d.params, node.args)
            }
            return eval_expr(d.body, d.env.child(args))
        if callable(d):  # builtin (Len, Append, ...)
            return d(*[eval_expr(a, env) for a in node.args])
        raise EvalError(f"{node.op} is not an operator")
    if k is A.Index:
        f = eval_expr(node.fn, env)
        if len(node.args) != 1:
            raise EvalError("multi-arg function application unsupported")
        i = eval_expr(node.args[0], env)
        return apply_fn(f, i, node.loc)
    if k is A.Field:
        r = eval_expr(node.expr, env)
        if not isinstance(r, FDict) or node.name not in r:
            raise EvalError(f"no field {node.name} in {r!r} at {node.loc}")
        return r[node.name]
    if k is A.TupleExpr:
        return tuple(eval_expr(e, env) for e in node.items)
    if k is A.SetEnum:
        return frozenset(eval_expr(e, env) for e in node.items)
    if k is A.SetFilter:
        dom = eval_expr(node.domain, env)
        out = []
        for v in _enum_set(dom):
            if eval_expr(node.pred, env.child({node.var: v})) is True:
                out.append(v)
        return frozenset(out)
    if k is A.SetMap:
        dom = eval_expr(node.domain, env)
        return frozenset(
            eval_expr(node.expr, env.child({node.var: v}))
            for v in _enum_set(dom)
        )
    if k is A.FnConstruct:
        dom = eval_expr(node.domain, env)
        return make_fn(
            {
                v: eval_expr(node.body, env.child({node.var: v}))
                for v in _enum_set(dom)
            }
        )
    if k is A.FnExcept:
        f = eval_expr(node.fn, env)
        return _eval_except(f, node, env)
    if k is A.RecordLit:
        return FDict(
            {name: eval_expr(e, env) for name, e in node.fields}
        )
    if k is A.RecordSpace:
        return RecordSpaceV(
            tuple((name, eval_expr(e, env)) for name, e in node.fields)
        )
    if k is A.FnSpace:
        dom = eval_expr(node.domain, env)
        return FnSpaceV(frozenset(_enum_set(dom)), eval_expr(node.codomain, env))
    if k is A.Quant:
        return _eval_quant(node, env, 0)
    if k is A.Choose:
        dom = eval_expr(node.domain, env)
        for v in sorted(_enum_set(dom), key=_sort_key):
            if eval_expr(node.pred, env.child({node.var: v})) is True:
                return v
        raise EvalError(f"CHOOSE has no witness at {node.loc}")
    if k is A.If:
        c = eval_expr(node.cond, env)
        if c is True:
            return eval_expr(node.then, env)
        if c is False:
            return eval_expr(node.orelse, env)
        raise EvalError(f"IF condition not boolean at {node.loc}")
    if k is A.Let:
        t: Dict[str, object] = {}
        child = env.child(t)
        for name, params, body in node.defs:
            if params:
                t[name] = OpDef(params, body, child)
            else:
                t[name] = Thunk(lambda b=body, e=child: eval_expr(b, e))
        return eval_expr(node.body, child)
    if k is A.Lambda:
        return OpDef(node.params, node.body, env)
    raise EvalError(f"cannot evaluate {type(node).__name__} at {node.loc}")


def apply_fn(f, i, loc=(0, 0)):
    if isinstance(f, tuple):
        if not (isinstance(i, int) and 1 <= i <= len(f)):
            raise EvalError(f"index {i!r} out of domain 1..{len(f)} at {loc}")
        return f[i - 1]
    if isinstance(f, FDict):
        if i not in f:
            raise EvalError(f"{i!r} not in DOMAIN at {loc}")
        return f[i]
    raise EvalError(f"cannot apply non-function {f!r} at {loc}")


def _eval_except(f, node: A.FnExcept, env: Env):
    # rebuild as mapping, apply updates (with @ = old value), re-canonize
    if isinstance(f, tuple):
        m = {i + 1: v for i, v in enumerate(f)}
    elif isinstance(f, FDict):
        m = dict(f.items)
    else:
        raise EvalError(f"EXCEPT on non-function at {node.loc}")
    for idx_e, val_e in node.updates:
        i = eval_expr(idx_e, env)
        if i not in m:
            raise EvalError(f"EXCEPT index {i!r} out of domain at {node.loc}")
        v = eval_expr(val_e, env.child({"@": m[i]}))
        m[i] = v
    return make_fn(m)


def _eval_quant(node: A.Quant, env: Env, b: int):
    if b == len(node.bindings):
        v = eval_expr(node.body, env)
        if not isinstance(v, bool):
            raise EvalError(f"quantifier body not boolean at {node.loc}")
        return v
    var, dom_e = node.bindings[b]
    dom = eval_expr(dom_e, env)
    if node.kind == "A":
        for v in _enum_set(dom):
            if not _eval_quant(node, env.child({var: v}), b + 1):
                return False
        return True
    for v in _enum_set(dom):
        if _eval_quant(node, env.child({var: v}), b + 1):
            return True
    return False


def _eval_binop(node: A.BinOp, env: Env):
    op = node.op
    if op == "/\\":
        l = eval_expr(node.lhs, env)
        if l is not True:
            return False
        return eval_expr(node.rhs, env) is True
    if op == "\\/":
        l = eval_expr(node.lhs, env)
        if l is True:
            return True
        return eval_expr(node.rhs, env) is True
    if op == "=>":
        l = eval_expr(node.lhs, env)
        if l is not True:
            return True
        return eval_expr(node.rhs, env) is True
    if op == "<=>":
        return (eval_expr(node.lhs, env) is True) == (
            eval_expr(node.rhs, env) is True
        )
    l = eval_expr(node.lhs, env)
    r = eval_expr(node.rhs, env)
    if op == "=":
        return _tla_eq(l, r)
    if op == "#":
        return not _tla_eq(l, r)
    if op in ("<", ">", "<=", ">=", "\\leq", "\\geq"):
        if not (isinstance(l, int) and isinstance(r, int)):
            raise EvalError(f"comparison on non-integers at {node.loc}")
        return {
            "<": l < r,
            ">": l > r,
            "<=": l <= r,
            ">=": l >= r,
            "\\leq": l <= r,
            "\\geq": l >= r,
        }[op]
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "*":
        return l * r
    if op == "\\div":
        if r == 0:
            raise EvalError(f"division by zero at {node.loc}")
        return l // r
    if op == "%":
        if r == 0:
            raise EvalError(f"modulo by zero at {node.loc}")
        return l % r
    if op == "..":
        return frozenset(range(l, r + 1))
    if op == "\\in":
        return l in _as_container(r)
    if op == "\\notin":
        return l not in _as_container(r)
    if op == "\\cup" or op == "\\union":
        return frozenset(_enum_set(l)) | frozenset(_enum_set(r))
    if op == "\\cap" or op == "\\intersect":
        return frozenset(_enum_set(l)) & frozenset(_enum_set(r))
    if op == "\\":
        return frozenset(_enum_set(l)) - frozenset(_enum_set(r))
    if op == "\\subseteq":
        return all(x in _as_container(r) for x in l)
    if op == "\\o":
        return tuple(l) + tuple(r)
    raise EvalError(f"unknown operator {op} at {node.loc}")


def _tla_eq(l, r) -> bool:
    return l == r and type(l) is type(r) or _eq_loose(l, r)


def _eq_loose(l, r) -> bool:
    # ints/bools: Python would conflate True == 1; TLA+ doesn't.
    if isinstance(l, bool) != isinstance(r, bool):
        return False
    return l == r


def _eval_unop(node: A.UnOp, env: Env):
    op = node.op
    if op == "~":
        v = eval_expr(node.expr, env)
        if not isinstance(v, bool):
            raise EvalError(f"~ on non-boolean at {node.loc}")
        return not v
    if op == "-":
        return -eval_expr(node.expr, env)
    if op == "DOMAIN":
        f = eval_expr(node.expr, env)
        if isinstance(f, tuple):
            return frozenset(range(1, len(f) + 1))
        if isinstance(f, FDict):
            return frozenset(f.keys())
        raise EvalError(f"DOMAIN of non-function at {node.loc}")
    if op == "SUBSET":
        return PowerSpace(eval_expr(node.expr, env))
    if op == "UNION":
        s = eval_expr(node.expr, env)
        out = frozenset()
        for x in _enum_set(s):
            out |= frozenset(_enum_set(x))
        return out
    if op == "UNCHANGED":
        raise EvalError(
            f"UNCHANGED outside action context at {node.loc}"
        )
    raise EvalError(f"unknown unary {op} at {node.loc}")


# builtin operators from EXTENDS Naturals/FiniteSets/Sequences ------------


def _builtin_len(s):
    if isinstance(s, tuple):
        return len(s)
    raise EvalError(f"Len of non-sequence {s!r}")


def _builtin_append(s, v):
    if isinstance(s, tuple):
        return s + (v,)
    raise EvalError(f"Append to non-sequence {s!r}")


def _builtin_cardinality(s):
    if isinstance(s, frozenset):
        return len(s)
    return len(list(_enum_set(s)))


def _builtin_head(s):
    if isinstance(s, tuple) and s:
        return s[0]
    raise EvalError("Head of empty/non-sequence")


def _builtin_tail(s):
    if isinstance(s, tuple) and s:
        return s[1:]
    raise EvalError("Tail of empty/non-sequence")


def _builtin_subseq(s, a, b):
    if isinstance(s, tuple):
        return s[a - 1 : b]
    raise EvalError("SubSeq of non-sequence")


def _builtin_selectseq(s, test):
    if not isinstance(test, OpDef):
        raise EvalError("SelectSeq filter must be LAMBDA/operator")
    out = []
    for v in s:
        keep = eval_expr(test.body, test.env.child({test.params[0]: v}))
        if keep is True:
            out.append(v)
    return tuple(out)


BUILTINS: Dict[str, Callable] = {
    "Len": _builtin_len,
    "Append": _builtin_append,
    "Cardinality": _builtin_cardinality,
    "Head": _builtin_head,
    "Tail": _builtin_tail,
    "SubSeq": _builtin_subseq,
    "SelectSeq": _builtin_selectseq,
}


# --------------------------------------------------------------------------
# action enumeration (nondeterministic formula -> assignments)
# --------------------------------------------------------------------------


def enum_formula(
    node: A.Node,
    env: Env,
    assigns: Dict[str, object],
    varset: set,
    primed: bool,
) -> Iterator[Dict[str, object]]:
    """Enumerate variable assignments satisfying an Init-style (primed=False)
    or action-style (primed=True) formula."""
    for _label, asg in _enum(node, env, dict(assigns), varset, primed, None):
        yield asg


def enum_action_labeled(
    node: A.Node,
    env: Env,
    assigns: Dict[str, object],
    varset: set,
    label: Optional[str],
) -> Iterator[Tuple[Optional[str], Dict[str, object]]]:
    yield from _enum(node, env, dict(assigns), varset, True, label)


def _eval_with_assigns(
    node: A.Node, env: Env, assigns: Dict[str, object]
) -> object:
    """Evaluate an expression that may reference primed variables."""
    primed_tbl = {v + "'": val for v, val in assigns.items()}
    return eval_expr(node, env.child(primed_tbl))


def _enum(
    node: A.Node,
    env: Env,
    assigns: Dict[str, object],
    varset: set,
    primed: bool,
    label: Optional[str],
) -> Iterator[Tuple[Optional[str], Dict[str, object]]]:
    k = type(node)

    # conjunction: thread assignments left to right
    if k is A.Junction and node.op == "/\\":
        yield from _enum_conj(list(node.items), env, assigns, varset, primed, label)
        return
    if k is A.BinOp and node.op == "/\\":
        yield from _enum_conj(
            [node.lhs, node.rhs], env, assigns, varset, primed, label
        )
        return
    # disjunction: branch
    if k is A.Junction and node.op == "\\/":
        for item in node.items:
            yield from _enum(item, env, dict(assigns), varset, primed, label)
        return
    if k is A.BinOp and node.op == "\\/":
        yield from _enum(node.lhs, env, dict(assigns), varset, primed, label)
        yield from _enum(node.rhs, env, dict(assigns), varset, primed, label)
        return
    # \E branches
    if k is A.Quant and node.kind == "E":
        yield from _enum_exists(node, 0, env, assigns, varset, primed, label)
        return
    # LET in action position: bind defs (lazily), recurse into the body
    if k is A.Let:
        t: Dict[str, object] = {}
        child = env.child(t)
        # LET defs may reference primed vars assigned so far
        primed_tbl = {v + "'": val for v, val in assigns.items()}
        defenv = child.child(primed_tbl)
        for name, params, body in node.defs:
            if params:
                t[name] = OpDef(params, body, defenv)
            else:
                t[name] = Thunk(lambda b=body, e=defenv: eval_expr(b, e))
        yield from _enum(node.body, child, assigns, varset, primed, label)
        return
    # IF in action position
    if k is A.If:
        c = _eval_with_assigns(node.cond, env, assigns)
        if c is True:
            yield from _enum(node.then, env, assigns, varset, primed, label)
        elif c is False:
            yield from _enum(node.orelse, env, assigns, varset, primed, label)
        else:
            raise EvalError(f"IF condition not boolean at {node.loc}")
        return
    # named action (operator ref/application) — recurse for labeling
    if k is A.Name:
        e = env
        found = None
        while e is not None:
            if node.name in e.table:
                found = e.table[node.name]
                break
            e = e.parent
        if isinstance(found, Thunk):
            # zero-arg definition: recurse into its AST for labels/assigns
            spec_defs = getattr(_enum, "_defs", None)
            if spec_defs and node.name in spec_defs:
                yield from _enum(
                    spec_defs[node.name].body,
                    env,
                    assigns,
                    varset,
                    primed,
                    label or node.name,
                )
                return
    if k is A.Apply:
        d = env.lookup(node.op)
        if isinstance(d, OpDef):
            args = {
                p: _eval_with_assigns(a, env, assigns)
                for p, a in zip(d.params, node.args)
            }
            yield from _enum(
                d.body,
                d.env.child(args),
                assigns,
                varset,
                primed,
                label or node.op,
            )
            return
    # UNCHANGED
    if k is A.UnOp and node.op == "UNCHANGED":
        if not primed:
            raise EvalError("UNCHANGED in Init")
        names = _unchanged_names(node.expr, varset)
        for v in names:
            cur = env.lookup(v)
            if v in assigns:
                if not _tla_eq(assigns[v], cur):
                    return
            else:
                assigns[v] = cur
        yield (label, assigns)
        return
    # assignment / membership on a (primed) variable
    tgt = _assign_target(node, varset, primed)
    if tgt is not None:
        var, kind, rhs = tgt
        if kind == "=":
            val = _eval_with_assigns(rhs, env, assigns)
            if var in assigns:
                if _tla_eq(assigns[var], val):
                    yield (label, assigns)
                return
            assigns[var] = val
            yield (label, assigns)
            return
        # kind == "\\in"
        dom = _eval_with_assigns(rhs, env, assigns)
        if var in assigns:
            if assigns[var] in _as_container(dom):
                yield (label, assigns)
            return
        for v in _enum_set(dom):
            a2 = dict(assigns)
            a2[var] = v
            yield (label, a2)
        return
    # plain guard
    v = _eval_with_assigns(node, env, assigns)
    if v is True:
        yield (label, assigns)
    elif v is not False:
        raise EvalError(f"formula not boolean at {node.loc}: {v!r}")


def _enum_conj(items, env, assigns, varset, primed, label):
    if not items:
        yield (label, assigns)
        return
    head, rest = items[0], items[1:]
    for lab, asg in _enum(head, env, assigns, varset, primed, label):
        yield from _enum_conj(rest, env, asg, varset, primed, lab or label)


def _enum_exists(node, b, env, assigns, varset, primed, label):
    if b == len(node.bindings):
        yield from _enum(node.body, env, assigns, varset, primed, label)
        return
    var, dom_e = node.bindings[b]
    dom = _eval_with_assigns(dom_e, env, assigns)
    for v in sorted(_enum_set(dom), key=_sort_key):
        yield from _enum_exists(
            node, b + 1, env.child({var: v}), dict(assigns), varset, primed, label
        )


def _assign_target(node, varset, primed):
    """Recognize  x' = e | x' \\in S  (action) or  x = e | x \\in S  (Init)."""
    if not isinstance(node, A.BinOp) or node.op not in ("=", "\\in"):
        return None
    lhs = node.lhs
    if primed:
        if isinstance(lhs, A.Prime) and isinstance(lhs.expr, A.Name):
            nm = lhs.expr.name
            if nm in varset:
                return nm, node.op, node.rhs
        return None
    if isinstance(lhs, A.Name) and lhs.name in varset:
        return lhs.name, node.op, node.rhs
    return None


def _unchanged_names(node, varset, defs=None) -> List[str]:
    """Variables under UNCHANGED, expanding tuple-of-vars definitions via
    ``defs`` (default: the AST registry installed by BFS/Spec helpers)."""
    spec_defs = defs if defs is not None else getattr(_enum, "_defs", {})
    out: List[str] = []

    def walk(n):
        if isinstance(n, A.TupleExpr):
            for x in n.items:
                walk(x)
        elif isinstance(n, A.Name):
            if n.name in varset:
                out.append(n.name)
            elif n.name in spec_defs:
                walk(spec_defs[n.name].body)
            else:
                raise EvalError(f"UNCHANGED of unknown name {n.name}")
        else:
            raise EvalError(f"UNCHANGED of unsupported expr at {n.loc}")

    walk(node)
    return out


def install_defs(spec: Spec) -> None:
    """Register the module's definition table for AST-walking helpers
    (UNCHANGED expansion and action labeling)."""
    _enum._defs = spec.defs


# --------------------------------------------------------------------------
# explicit-state BFS (mini-TLC, host side)
# --------------------------------------------------------------------------


@dataclass
class CheckResult:
    distinct_states: int
    diameter: int
    violation: Optional[str] = None
    trace: Optional[List[Tuple]] = None
    trace_actions: Optional[List[str]] = None
    deadlock: bool = False


def bfs_check(
    spec: Spec,
    invariants: Tuple[str, ...] = (),
    check_deadlock: bool = True,
    max_states: int = 10_000_000,
) -> CheckResult:
    """Reference BFS: exact TLC semantics, host only.  For oracle use and
    small configs; the device engines are the production path."""
    install_defs(spec)
    spec.check_assumes()
    parent: Dict[Tuple, Tuple] = {}
    action_of: Dict[Tuple, str] = {}

    def trace_to(s):
        chain = [s]
        acts = []
        while s in parent:
            acts.append(action_of[s])
            s = parent[s]
            chain.append(s)
        chain.reverse()
        acts.reverse()
        return chain, acts

    init = spec.initial_states()
    seen = set(init)
    frontier = list(init)
    for s in frontier:
        for inv in invariants:
            if not spec.eval_predicate(inv, s):
                return CheckResult(
                    len(seen), 0, violation=inv, trace=[s], trace_actions=[]
                )
    diameter = 0
    while frontier:
        nxt = []
        for s in frontier:
            succs = spec.successors(s)
            if check_deadlock and not succs:
                chain, acts = trace_to(s)
                return CheckResult(
                    len(seen),
                    diameter,
                    deadlock=True,
                    trace=chain,
                    trace_actions=acts,
                )
            for label, t in succs:
                if t in seen:
                    continue
                seen.add(t)
                parent[t] = s
                action_of[t] = label
                for inv in invariants:
                    if not spec.eval_predicate(inv, t):
                        chain, acts = trace_to(t)
                        return CheckResult(
                            len(seen),
                            diameter + 1,
                            violation=inv,
                            trace=chain,
                            trace_actions=acts,
                        )
                nxt.append(t)
        if len(seen) > max_states:
            raise EvalError(f"state space exceeds {max_states}")
        frontier = nxt
        if frontier:
            diameter += 1
    return CheckResult(len(seen), diameter)
