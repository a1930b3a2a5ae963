"""TLA+ -> PyTorch compiler — the counterpart of
``pulsar_tlaplus_tpu/frontend/codegen.py``: parsed module + constants ->
a batched model for the port's engines (device BFS, tiered store,
liveness, simulation), with no hand-written model.

Pipeline (per spec + cfg binding), as in the JAX package:

1. **Static splitting** — ``Init``/``Next`` are walked exactly like the
   interpreter's enumerator (frontend/interp.py ``_enum``): conjunction
   threads assignments, disjunction / ``\\E`` / ``x' \\in S`` branch.
   Every branch becomes a static *lane*; nondeterministic binders bind
   their variable to each element of the (statically bounded) domain,
   with a membership guard when the domain is state-dependent.  Lane
   order matches the interpreter's enumeration order (AST order,
   ``_sort_key``-sorted domains) so the two paths are differential
   tests of each other.
2. **Descriptor inference** — an abstract pass over the same compiler
   evaluates descs only (:mod:`.codegen_ir`), with guard-based
   narrowing (``Len(s) < c``, ``x < c`` ...) so bounded-growth patterns
   (Append under a limit guard, counters under a max) reach a fixpoint.
3. **Concrete compilation** — the same traversal with data: every
   expression value is a :class:`CVal` (descriptor + tensor tree +
   poison bit) of ONE state.  Sub-expressions that do not reference
   state variables are evaluated by the host interpreter and lifted as
   constants — the tensor compiler only ever sees the state-dependent
   paths.
4. **Batching** — the per-state walk is mapped over a batch with
   ``torch.func.vmap`` (the JAX package maps it with ``jax.vmap``) and
   recorded once per (function, device, batch bucket) as an ATen graph
   (``record.py``); later calls pad their batch to the bucket (a power
   of four) and replay the graph, so the AST is walked once per
   bucket, never once per window (the counterpart of tracing once under
   ``jit``).  The walk has no Python branch on data, the condition both
   vmap and the replay need.

**Poison semantics**: TLC evaluates lazily and *errors* on demanded
out-of-domain values; vectorized evaluation is eager, so undefinedness
is tracked as a poison bit with short-circuit algebra (``a /\\ b``
demands ``b`` only when ``a`` holds, masked quantifier elements drop
their body's poison, IF selects branch poison).  A poison demanded by a
valid lane sets the hidden ``__err__`` state bit; the auto-invariant
``__EvalError__`` then halts the check with a trace to the state whose
evaluation TLC would have rejected — never a silently wrong result.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.frontend import tla_ast as A
from pulsar_tlaplus_tpu_torch.frontend.codegen_ir import (
    BOOL,
    Build,
    CodegenError,
    DBool,
    DEnum,
    DFun,
    DInt,
    DOpt,
    DRec,
    DSeq,
    DSet,
    DescCodec,
    I32,
    JV,
    _pad_axis,
    all_,
    any_,
    arange,
    asarray,
    b_,
    build_scope,
    coerce,
    const,
    data_eq,
    data_where,
    decode_value,
    desc_of_value,
    encode_value,
    encode_value_zero,
    i32,
    isum,
    join,
    ones,
    shape_of,
    stack,
    tree_leaves,
    tree_map,
    where,
    zero_data,
    zeros,
)
from pulsar_tlaplus_tpu_torch.frontend.interp import (
    EvalError,
    Spec,
    _enum_set,
    _refs_any,
    _sort_key,
    _unchanged_names,
    eval_expr,
)
from pulsar_tlaplus_tpu_torch.frontend.record import record

FALSE = False  # poison "constant" (host bool promotes under tensor ops)


@dataclass
class CVal:
    """Compiled value: descriptor + data tree + poison.

    ``data`` is None in the abstract (inference) pass.  ``poison`` is a
    scalar bool array (or host False) meaning "TLC evaluation of this
    value would have errored"."""

    desc: object
    data: object = None
    poison: object = FALSE


def _or(a, b):
    if a is FALSE:
        return b
    if b is FALSE:
        return a
    return a | b


def _and_val(cond_val, p):
    """Poison of an expression demanded only when ``cond_val`` holds."""
    if p is FALSE:
        return FALSE
    return asarray(cond_val) & p


class CEnv:
    """Chained compile-time scope: name -> ("host", v) | ("cv", CVal) |
    ("op", OpDef-like with a CEnv)."""

    __slots__ = ("table", "parent")

    def __init__(self, table=None, parent=None):
        self.table = table if table is not None else {}
        self.parent = parent

    def get(self, name):
        e = self
        while e is not None:
            if name in e.table:
                return e.table[name]
            e = e.parent
        return None

    def child(self, table):
        return CEnv(table, self)

    def host_overlay(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        e = self
        seen = set()
        while e is not None:
            for k, v in e.table.items():
                if k in seen:
                    continue
                seen.add(k)
                if isinstance(v, tuple) and v and v[0] == "host":
                    out[k] = v[1]
            e = e.parent
        return out

    def dynamic_names(self) -> set:
        out = set()
        e = self
        seen = set()
        while e is not None:
            for k, v in e.table.items():
                if k in seen:
                    continue
                seen.add(k)
                if isinstance(v, tuple) and v and v[0] in ("cv", "op"):
                    if v[0] == "cv":
                        out.add(k)
                    else:  # dynamic only if its body is
                        out.add(k)
            e = e.parent
        return out


@dataclass
class Lane:
    """One static Next/Init branch: label + host binder values + the
    conjunct list to compile under those bindings."""

    label: Optional[str]
    binds: Tuple[Tuple[str, object], ...]  # (name, host value)
    guards_pre: Tuple[Tuple[A.Node, object], ...]  # extra membership guards
    conjuncts: Tuple[A.Node, ...]
    env_tables: Tuple[Dict, ...] = ()  # LET tables captured on the path


class Compiler:
    """Expression/action compiler for one Spec (module + constants)."""

    MAX_LANES = 4096
    MAX_UNIVERSE = 4096

    def __init__(self, spec: Spec):
        self.spec = spec
        self.varset = set(spec.vars)
        self.abstract = False
        self.var_descs: Dict[str, object] = {}

    # ------------------------------------------------------------ util

    def _dyn_names(self, cenv: CEnv) -> set:
        names = set(self.varset)
        names |= {v + "'" for v in self.varset}
        names |= cenv.dynamic_names()
        names |= self.spec._state_defs
        return names

    def is_dynamic(self, node: A.Node, cenv: CEnv) -> bool:
        return _refs_any(node, self._dyn_names(cenv), self.spec.defs)

    def host_eval(self, node: A.Node, cenv: CEnv):
        env = self.spec.genv.child(cenv.host_overlay())
        return eval_expr(node, env)

    def lift(self, v) -> CVal:
        """Host value -> CVal constant."""
        d = desc_of_value(v)
        if self.abstract:
            return CVal(d, None)
        data = tree_map(const, encode_value(d, v))
        return CVal(d, data)

    def as_cval(self, x) -> CVal:
        return x if isinstance(x, CVal) else self.lift(x)

    def _coerce(self, cv: CVal, d) -> CVal:
        if cv.desc == d:
            return cv
        if self.abstract:
            return CVal(d, None, cv.poison)
        out = coerce(JV(cv.desc, cv.data), d)
        return CVal(d, out.data, cv.poison)

    def _join2(self, a: CVal, b: CVal):
        d = join(a.desc, b.desc)
        return self._coerce(a, d), self._coerce(b, d), d

    # -------------------------------------------------- narrowing (assign)

    def narrow_to(self, cv: CVal, d) -> CVal:
        """Re-represent ``cv`` under ``d``, poisoning (not erroring) when
        the value falls outside — the runtime descriptor guard that makes
        optimistic inference safe.  Recurses structurally; the returned
        poison may carry structure axes (callers reduce/gate them)."""
        if cv.desc == d:
            return cv
        if self.abstract:
            return CVal(d, None, cv.poison)
        try:
            return self._coerce(cv, d)
        except CodegenError:
            pass
        p = cv.poison
        s = cv.desc
        if isinstance(d, DInt) and isinstance(s, DInt):
            x = cv.data
            p = _or(p, (x < d.lo) | (x > d.hi))
            return CVal(d, torch.clamp(x, d.lo, d.hi), p)
        if isinstance(d, DEnum) and isinstance(s, DEnum):
            codes = []
            ok = zeros(shape_of(cv.data), BOOL)
            for i, m in enumerate(s.members):
                if m in d.members:
                    codes.append(d.members.index(m))
                    ok = ok | (cv.data == i)
                else:
                    codes.append(0)
            remap = asarray(codes, I32)
            return CVal(d, remap[cv.data], _or(p, ~ok))
        if isinstance(d, DSet) and isinstance(s, DSet):
            m = cv.data
            cols = []
            for u in d.universe:
                if u in s.universe:
                    cols.append(m[..., s.universe.index(u)])
                else:
                    cols.append(
                        zeros(shape_of(m)[:-1], BOOL)
                    )
            drop = [
                i for i, u in enumerate(s.universe)
                if u not in d.universe
            ]
            if drop:
                p = _or(
                    p,
                    any_(m[..., asarray(drop)], axis=-1),
                )
            out = (
                stack(cols, axis=-1)
                if cols
                else zeros(shape_of(m)[:-1] + (0,), BOOL)
            )
            return CVal(d, out, p)
        if isinstance(d, DSeq) and isinstance(s, DSeq):
            ln, ed = cv.data
            p = _or(p, ln > d.cap)
            ln = torch.clamp(ln, max=d.cap)
            if s.cap and d.cap and d.elem is not None and s.elem is not None:
                e2 = self.narrow_to(CVal(s.elem, ed), d.elem)
                if e2.poison is not FALSE:
                    live = arange(s.cap) < ln
                    p = _or(p, any_(_bcast(live, asarray(e2.poison))
                                       & e2.poison))
                ed = e2.data

                def fit(x):
                    if x.shape[0] >= d.cap:
                        return x[: d.cap]
                    return _pad_axis(x, 0, d.cap)

                ed = tree_map(fit, ed)
            else:
                ed = zero_data(d.elem, (d.cap,)) if d.cap else (
                    zeros((0,), I32)
                )
            return CVal(d, (ln, ed), p)
        if isinstance(d, DRec) and isinstance(s, DRec):
            if tuple(f for f, _ in d.fields) != tuple(
                f for f, _ in s.fields
            ):
                raise CodegenError(f"record mismatch {s} -> {d}")
            datas = {}
            for (fn_, fd), (_, sd) in zip(d.fields, s.fields):
                sub = self.narrow_to(CVal(sd, cv.data[fn_]), fd)
                datas[fn_] = sub.data
                p = _or(p, sub.poison)
            return CVal(d, datas, p)
        if isinstance(d, DOpt) and isinstance(s, DOpt):
            if s.nil != d.nil:
                raise CodegenError(f"nil mismatch {s} -> {d}")
            pres, inner = cv.data
            sub = self.narrow_to(CVal(s.inner, inner), d.inner)
            if sub.poison is not FALSE:
                p = _or(p, any_(_bcast(pres, asarray(sub.poison))
                                   & sub.poison))
            return CVal(d, (pres, sub.data), p)
        if (
            isinstance(d, DFun)
            and isinstance(s, DFun)
            and d.keys == s.keys
            and d.partial == s.partial
        ):
            pres, vd = cv.data
            sub = self.narrow_to(CVal(s.val, vd), d.val)
            if sub.poison is not FALSE:
                sp = asarray(sub.poison)
                if d.partial:
                    m = torch.movedim(asarray(pres), -1, 0)
                    sp = _bcast(m, sp) & sp
                p = _or(p, any_(sp))
            return CVal(d, (pres, sub.data), p)
        if isinstance(d, DOpt) and not isinstance(s, DOpt):
            inner = self.narrow_to(cv, d.inner)
            return CVal(
                d, (b_(True), inner.data), inner.poison
            )
        raise CodegenError(f"cannot narrow {s} -> {d}")

    # ---------------------------------------------------------- domains

    def domain_universe(self, node: A.Node, cenv: CEnv):
        """Resolve a binder/quantifier domain to
        ``(sorted host universe, memfn or None)``.  Host domains
        enumerate exactly (memfn None); state-dependent domains get a
        static universe from their descriptor plus a per-element
        membership compiler ``memfn(elem) -> CVal[DBool]``."""
        if not self.is_dynamic(node, cenv):
            dom = self.host_eval(node, cenv)
            elems = sorted(_enum_set(dom), key=_sort_key)
            if len(elems) > self.MAX_UNIVERSE:
                raise CodegenError(f"domain too large: {len(elems)}")
            return elems, None
        if isinstance(node, A.BinOp) and node.op == "..":
            lo = self.as_cval(self.compile(node.lhs, cenv))
            hi = self.as_cval(self.compile(node.rhs, cenv))
            self._want_int(lo, node)
            self._want_int(hi, node)
            if lo.desc is None or hi.desc is None:
                return [], (lambda e: CVal(DBool(), None))
            if hi.desc.hi - lo.desc.lo > self.MAX_UNIVERSE:
                raise CodegenError(f"dynamic range too wide at {node.loc}")
            elems = list(range(lo.desc.lo, hi.desc.hi + 1))
            p = _or(lo.poison, hi.poison)

            def memfn(e):
                if self.abstract:
                    return CVal(DBool(), None, p)
                return CVal(
                    DBool(), (lo.data <= e) & (e <= hi.data), p
                )

            return elems, memfn
        cv = self.as_cval(self.compile(node, cenv))
        d = cv.desc
        if d is None and self.abstract:
            return [], (lambda e: CVal(DBool(), None))
        if isinstance(d, DSet):

            def memfn(e):
                if e not in d.universe:
                    return CVal(
                        DBool(),
                        None if self.abstract else b_(False),
                    )
                i = d.universe.index(e)
                if self.abstract:
                    return CVal(DBool(), None, cv.poison)
                return CVal(DBool(), cv.data[..., i], cv.poison)

            return list(d.universe), memfn
        raise CodegenError(f"cannot bound dynamic domain {d}")

    # ------------------------------------------------------- expression

    def compile(self, node: A.Node, cenv: CEnv):
        """-> host value (static) or CVal (dynamic)."""
        if not self.is_dynamic(node, cenv):
            return self.host_eval(node, cenv)
        k = type(node)
        fn = getattr(self, "_c_" + k.__name__, None)
        if fn is None:
            raise CodegenError(
                f"cannot compile {k.__name__} at {node.loc}"
            )
        return fn(node, cenv)

    def cbool(self, node: A.Node, cenv: CEnv) -> CVal:
        v = self.compile(node, cenv)
        if isinstance(v, CVal):
            if not isinstance(v.desc, DBool):
                raise CodegenError(f"expected boolean at {node.loc}")
            return v
        if not isinstance(v, bool):
            raise CodegenError(f"expected boolean at {node.loc}, got {v!r}")
        return self.lift(v)

    # atoms

    def _c_Name(self, node: A.Name, cenv: CEnv):
        ent = cenv.get(node.name)
        if ent is not None:
            kind = ent[0]
            if kind == "host":
                return ent[1]
            if kind == "cv":
                return ent[1]
            if kind == "op":
                raise CodegenError(f"operator {node.name} used as value")
        # zero-arg state-dependent definition: inline its body
        if node.name in self.spec.defs:
            return self.compile(self.spec.defs[node.name].body, cenv)
        raise CodegenError(f"unbound name {node.name} at {node.loc}")

    def _c_Prime(self, node: A.Prime, cenv: CEnv):
        if isinstance(node.expr, A.Name):
            ent = cenv.get(node.expr.name + "'")
            if ent is not None and ent[0] == "cv":
                return ent[1]
            raise CodegenError(
                f"{node.expr.name}' referenced before assignment"
            )
        raise CodegenError(f"cannot prime non-variable at {node.loc}")

    # boolean structure (lazy poison algebra)

    def _c_Junction(self, node: A.Junction, cenv: CEnv):
        if node.op == "/\\":
            return self._conj([*node.items], cenv)
        return self._disj([*node.items], cenv)

    def _conj(self, items, cenv) -> CVal:
        acc_v, acc_p = True, FALSE
        for it in items:
            cv = self.cbool(it, cenv)
            if self.abstract:
                continue
            acc_p = _or(acc_p, _and_val(acc_v, cv.poison))
            acc_v = asarray(acc_v) & cv.data if acc_v is not True else cv.data
        if self.abstract:
            return CVal(DBool(), None)
        return CVal(DBool(), asarray(acc_v), acc_p)

    def _disj(self, items, cenv) -> CVal:
        acc_v, acc_p = False, FALSE
        for it in items:
            cv = self.cbool(it, cenv)
            if self.abstract:
                continue
            acc_p = _or(acc_p, _and_val(~asarray(acc_v), cv.poison))
            acc_v = (
                asarray(acc_v) | cv.data if acc_v is not False else cv.data
            )
        if self.abstract:
            return CVal(DBool(), None)
        return CVal(DBool(), asarray(acc_v), acc_p)

    # operators

    def _c_BinOp(self, node: A.BinOp, cenv: CEnv):
        op = node.op
        if op == "/\\":
            return self._conj([node.lhs, node.rhs], cenv)
        if op == "\\/":
            return self._disj([node.lhs, node.rhs], cenv)
        if op == "=>":
            l = self.cbool(node.lhs, cenv)
            r = self.cbool(node.rhs, cenv)
            if self.abstract:
                return CVal(DBool(), None)
            return CVal(
                DBool(),
                ~l.data | r.data,
                _or(l.poison, _and_val(l.data, r.poison)),
            )
        if op == "<=>":
            l = self.cbool(node.lhs, cenv)
            r = self.cbool(node.rhs, cenv)
            if self.abstract:
                return CVal(DBool(), None)
            return CVal(DBool(), l.data == r.data, _or(l.poison, r.poison))
        if op in ("\\in", "\\notin"):
            return self._c_membership(node, cenv)
        l = self.as_cval(self.compile(node.lhs, cenv))
        r = self.as_cval(self.compile(node.rhs, cenv))
        p = _or(l.poison, r.poison)
        if op in ("=", "#"):
            lc, rc, d = self._join2(l, r)
            if self.abstract:
                return CVal(DBool(), None, p)
            eq = data_eq(d, lc.data, rc.data)
            return CVal(DBool(), eq if op == "=" else ~eq, p)
        if op in ("<", ">", "<=", ">=", "\\leq", "\\geq"):
            self._want_int(l, node)
            self._want_int(r, node)
            if self.abstract:
                return CVal(DBool(), None, p)
            f = {
                "<": torch.lt, ">": torch.gt,
                "<=": torch.le, ">=": torch.ge,
                "\\leq": torch.le, "\\geq": torch.ge,
            }[op]
            return CVal(DBool(), f(l.data, r.data), p)
        if op in ("+", "-", "*", "\\div", "%"):
            return self._arith(op, l, r, p, node)
        if op in ("\\cup", "\\union", "\\cap", "\\intersect", "\\"):
            return self._setop(op, l, r, p)
        if op == "\\subseteq":
            a, b, d = self._join2(l, r)
            if not isinstance(d, DSet):
                raise CodegenError(f"\\subseteq on non-sets at {node.loc}")
            if self.abstract:
                return CVal(DBool(), None, p)
            return CVal(
                DBool(), all_(~a.data | b.data, axis=-1), p
            )
        if op == "..":
            # dynamic range as a value: DSet over the static envelope
            self._want_int(l, node)
            self._want_int(r, node)
            if l.desc is None or r.desc is None:
                return CVal(None, None)
            if r.desc.hi - l.desc.lo > self.MAX_UNIVERSE:
                raise CodegenError(f"dynamic range too wide at {node.loc}")
            uni = tuple(range(l.desc.lo, r.desc.hi + 1))
            d = DSet(uni)
            if self.abstract:
                return CVal(d, None, p)
            u = asarray(uni, I32)
            mask = (l.data <= u) & (u <= r.data)
            return CVal(d, mask, p)
        raise CodegenError(f"cannot compile operator {op} at {node.loc}")

    def _want_int(self, cv: CVal, node):
        if cv.desc is None and self.abstract:
            return
        if not isinstance(cv.desc, DInt):
            raise CodegenError(f"expected integer at {node.loc}: {cv.desc}")

    def _arith(self, op, l: CVal, r: CVal, p, node) -> CVal:
        self._want_int(l, node)
        self._want_int(r, node)
        if l.desc is None or r.desc is None:
            return CVal(None, None)
        a, b = l.desc, r.desc
        if op == "+":
            d = DInt(a.lo + b.lo, a.hi + b.hi)
            fn = lambda x, y: x + y
        elif op == "-":
            d = DInt(a.lo - b.hi, a.hi - b.lo)
            fn = lambda x, y: x - y
        elif op == "*":
            cs = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
            d = DInt(min(cs), max(cs))
            fn = lambda x, y: x * y
        elif op == "\\div":
            if b.lo <= 0:
                raise CodegenError(f"\\div by possibly-nonpositive at {node.loc}")
            d = DInt(min(a.lo // b.lo, a.lo // b.hi, 0),
                     max(a.hi // b.lo, a.hi // max(b.lo, 1), 0))
            fn = lambda x, y: x // y
        elif op == "%":
            if b.lo <= 0:
                raise CodegenError(f"% by possibly-nonpositive at {node.loc}")
            d = DInt(0, b.hi - 1)
            fn = lambda x, y: x % y
        else:  # pragma: no cover
            raise CodegenError(op)
        if self.abstract:
            return CVal(d, None, p)
        return CVal(d, fn(l.data, r.data), p)

    def _setop(self, op, l: CVal, r: CVal, p) -> CVal:
        a, b, d = self._join2(l, r)
        if not isinstance(d, DSet):
            raise CodegenError(f"set operator {op} on {d}")
        if self.abstract:
            return CVal(d, None, p)
        if op in ("\\cup", "\\union"):
            m = a.data | b.data
        elif op in ("\\cap", "\\intersect"):
            m = a.data & b.data
        else:
            m = a.data & ~b.data
        return CVal(d, m, p)

    def _c_membership(self, node: A.BinOp, cenv: CEnv) -> CVal:
        neg = node.op == "\\notin"
        l = self.compile(node.lhs, cenv)
        rhs_dyn = self.is_dynamic(node.rhs, cenv)
        if not rhs_dyn:
            dom = self.host_eval(node.rhs, cenv)
            elems = sorted(_enum_set(dom), key=_sort_key)
            lcv = self.as_cval(l)
            if self.abstract:
                return CVal(DBool(), None, lcv.poison)
            m = b_(False)
            for e in elems:
                ec = self.lift(e)
                try:
                    a, b, d = self._join2(lcv, ec)
                except CodegenError:
                    continue  # incomparable kinds never equal
                m = m | data_eq(d, a.data, b.data)
            out = ~m if neg else m
            return CVal(DBool(), out, lcv.poison)
        # dynamic set on the right
        if isinstance(l, CVal):
            # dynamic element in dynamic set: one-hot over the universe
            rcv = self.as_cval(self.compile(node.rhs, cenv))
            if not isinstance(rcv.desc, DSet):
                raise CodegenError(f"\\in non-set at {node.loc}")
            uni = rcv.desc.universe
            if self.abstract:
                return CVal(DBool(), None, _or(l.poison, rcv.poison))
            m = b_(False)
            for i, e in enumerate(uni):
                ec = self.lift(e)
                try:
                    a, b, d = self._join2(l, ec)
                except CodegenError:
                    continue
                m = m | (data_eq(d, a.data, b.data) & rcv.data[..., i])
            out = ~m if neg else m
            return CVal(DBool(), out, _or(l.poison, rcv.poison))
        _elems, memfn = self.domain_universe(node.rhs, cenv)
        cv = memfn(l)
        if self.abstract or not neg:
            return cv
        return CVal(DBool(), ~cv.data, cv.poison)

    def _c_UnOp(self, node: A.UnOp, cenv: CEnv):
        op = node.op
        if op == "~":
            cv = self.cbool(node.expr, cenv)
            if self.abstract:
                return cv
            return CVal(DBool(), ~cv.data, cv.poison)
        if op == "-":
            cv = self.as_cval(self.compile(node.expr, cenv))
            self._want_int(cv, node)
            d = DInt(-cv.desc.hi, -cv.desc.lo)
            if self.abstract:
                return CVal(d, None, cv.poison)
            return CVal(d, -cv.data, cv.poison)
        if op == "DOMAIN":
            cv = self.as_cval(self.compile(node.expr, cenv))
            d = cv.desc
            if isinstance(d, DSeq):
                out = DSet(tuple(range(1, d.cap + 1)))
                if self.abstract:
                    return CVal(out, None, cv.poison)
                ln = cv.data[0]
                idx = arange(1, d.cap + 1)
                return CVal(out, idx <= ln, cv.poison)
            if isinstance(d, DFun):
                out = DSet(d.keys)
                if self.abstract:
                    return CVal(out, None, cv.poison)
                pres = cv.data[0]
                if not d.partial:
                    pres = ones((len(d.keys),), BOOL)
                return CVal(out, pres, cv.poison)
            raise CodegenError(f"DOMAIN of {d} at {node.loc}")
        raise CodegenError(f"cannot compile unary {op} at {node.loc}")

    def _c_Apply(self, node: A.Apply, cenv: CEnv):
        ent = cenv.get(node.op)
        if ent is not None and ent[0] == "op":
            _k, params, body, defcenv = ent
            return self._inline(params, body, defcenv, node, cenv)
        if node.op in self.spec.defs and self.spec.defs[node.op].params:
            d = self.spec.defs[node.op]
            return self._inline(d.params, d.body, CEnv(), node, cenv)
        if node.op in _BUILTIN_COMPILERS:
            return _BUILTIN_COMPILERS[node.op](self, node, cenv)
        raise CodegenError(f"cannot compile call to {node.op} at {node.loc}")

    def _inline(self, params, body, defcenv: CEnv, node: A.Apply, cenv: CEnv):
        if len(params) != len(node.args):
            raise CodegenError(f"arity mismatch calling {node.op}")
        table = {}
        for p, a in zip(params, node.args):
            v = self.compile(a, cenv)
            table[p] = ("cv", v) if isinstance(v, CVal) else ("host", v)
        return self.compile(body, defcenv.child(table))

    def _c_Index(self, node: A.Index, cenv: CEnv):
        if len(node.args) != 1:
            raise CodegenError("multi-arg application unsupported")
        if self.abstract:
            fk = getattr(self, "_fact_key", None)
            fk = fk(node, cenv) if fk is not None else None
            if fk is not None:
                ent = cenv.get(fk)
                if ent is not None and ent[0] == "cv":
                    return ent[1]
        f = self.as_cval(self.compile(node.fn, cenv))
        i = self.compile(node.args[0], cenv)
        d = f.desc
        if isinstance(d, DOpt):
            # TLC: applying Nil is an error -> poison, index the inner
            inner = CVal(
                d.inner,
                None if self.abstract else f.data[1],
                _or(f.poison, None if self.abstract else ~f.data[0]),
            )
            if self.abstract:
                inner.poison = f.poison
            return self._index_into(inner, i, node)
        return self._index_into(f, i, node)

    def _as_int_index(self, icv: CVal) -> CVal:
        """Unwrap an optional index (applying Nil is a TLC error ->
        poison) and require an integer."""
        if isinstance(icv.desc, DOpt):
            icv = CVal(
                icv.desc.inner,
                None if self.abstract else icv.data[1],
                icv.poison
                if self.abstract
                else _or(icv.poison, ~icv.data[0]),
            )
        return icv

    def _index_into(self, f: CVal, i, node) -> CVal:
        d = f.desc
        if d is None or isinstance(d, DEnum):
            if self.abstract:
                return CVal(None, None)
            raise CodegenError(f"cannot index into {d} at {node.loc}")
        if isinstance(d, DSeq):
            icv = self._as_int_index(self.as_cval(i))
            self._want_int(icv, node)
            if d.elem is None or d.cap == 0:
                return CVal(
                    DInt(0, 0),
                    None if self.abstract else i32(0),
                    _or(f.poison, icv.poison)
                    if self.abstract
                    else _or(_or(f.poison, icv.poison), b_(True)),
                )
            if self.abstract:
                return CVal(d.elem, None, _or(f.poison, icv.poison))
            ln, ed = f.data
            idx = icv.data
            oob = (idx < 1) | (idx > ln)
            # exactly one position: a gather (the JAX code sums a
            # one-hot selection, which is one op here against six)
            sel = torch.clamp(idx - 1, 0, d.cap - 1)
            data = tree_map(lambda x: x[sel], ed)
            return CVal(d.elem, data, _or(_or(f.poison, icv.poison), oob))
        if isinstance(d, DFun):
            if not isinstance(i, CVal):  # static key
                if i not in d.keys:
                    return CVal(
                        d.val,
                        None if self.abstract else _zero(self, d.val),
                        True if self.abstract else b_(True),
                    )
                k = d.keys.index(i)
                if self.abstract:
                    return CVal(d.val, None, f.poison)
                pres, vd = f.data
                p = f.poison
                if d.partial:
                    p = _or(p, ~pres[..., k])
                data = tree_map(lambda x: x[k], vd)
                return CVal(d.val, data, p)
            # dynamic key over static universe: one-hot select
            icv = i
            if self.abstract:
                return CVal(d.val, None, _or(f.poison, icv.poison))
            pres, vd = f.data
            hits = []
            for key in d.keys:
                kc = self.lift(key)
                try:
                    a, b, dd = self._join2(icv, kc)
                    hits.append(asarray(data_eq(dd, a.data, b.data)))
                except CodegenError:
                    hits.append(b_(False))
            onehot = stack(torch.broadcast_tensors(*hits), axis=-1)
            found = any_(onehot, axis=-1)
            inpres = (
                any_(onehot & pres, axis=-1) if d.partial else found
            )
            data = tree_map(
                lambda x: _onehot_pick_axis(onehot, x), vd
            )
            p = _or(_or(f.poison, icv.poison), ~inpres)
            return CVal(d.val, data, p)
        raise CodegenError(f"cannot index into {d} at {node.loc}")

    def _c_Field(self, node: A.Field, cenv: CEnv):
        r = self.as_cval(self.compile(node.expr, cenv))
        d = r.desc
        if d is None or isinstance(d, DEnum):
            # bottom / nil-only value: field access is TLC-undefined
            if self.abstract:
                return CVal(None, None)
            raise CodegenError(f".{node.name} on {d} at {node.loc}")
        if isinstance(d, DOpt):
            inner = d.inner
            p = r.poison if self.abstract else _or(r.poison, ~r.data[0])
            r = CVal(inner, None if self.abstract else r.data[1], p)
            d = inner
        if not isinstance(d, DRec):
            raise CodegenError(f".{node.name} on {d} at {node.loc}")
        fd = d.field(node.name)
        if self.abstract:
            return CVal(fd, None, r.poison)
        return CVal(fd, r.data[node.name], r.poison)

    def _c_TupleExpr(self, node: A.TupleExpr, cenv: CEnv):
        items = [self.as_cval(self.compile(e, cenv)) for e in node.items]
        ed = None
        for it in items:
            ed = join(ed, it.desc)
        d = DSeq(ed, len(items))
        p = FALSE
        for it in items:
            p = _or(p, it.poison)
        if self.abstract:
            return CVal(d, None, p)
        if not items:
            return CVal(d, (i32(0), zeros((0,), I32)), p)
        datas = [self._coerce(it, ed).data for it in items]
        stacked = tree_map(lambda *xs: stack(xs), *datas)
        return CVal(d, (i32(len(items)), stacked), p)

    def _c_SetEnum(self, node: A.SetEnum, cenv: CEnv):
        items = [self.compile(e, cenv) for e in node.items]
        host_atoms = set()
        for it, e in zip(items, node.items):
            cv = self.as_cval(it)
            host_atoms |= set(_desc_atoms(cv.desc, e))
        uni = tuple(sorted(host_atoms, key=_sort_key))
        d = DSet(uni)
        p = FALSE
        for it in items:
            if isinstance(it, CVal):
                p = _or(p, it.poison)
        if self.abstract:
            return CVal(d, None, p)
        mask = zeros((len(uni),), BOOL)
        for it in items:
            cv = self.as_cval(it)
            hits = []
            for u in uni:
                uc = self.lift(u)
                try:
                    a, b, dd = self._join2(cv, uc)
                    hits.append(data_eq(dd, a.data, b.data))
                except CodegenError:
                    hits.append(b_(False))
            mask = mask | stack(hits, axis=-1)
        return CVal(d, mask, p)

    def _c_SetFilter(self, node: A.SetFilter, cenv: CEnv):
        elems, memfn = self.domain_universe(node.domain, cenv)
        uni = tuple(elems)
        d = DSet(uni)
        if self.abstract:
            # poison: quantified bodies may poison; ignored per-element
            return CVal(d, None)
        masks, p = [], FALSE
        for e in elems:
            sub = cenv.child({node.var: ("host", e)})
            pv = self.cbool(node.pred, sub)
            m = pv.data
            pe = pv.poison
            if memfn is not None:
                mem = memfn(e)
                m = m & mem.data
                pe = _and_val(mem.data, pe)
            masks.append(m)
            p = _or(p, pe)
        mask = stack(masks, axis=-1) if masks else zeros((0,), BOOL)
        return CVal(d, mask, p)

    def _c_SetMap(self, node: A.SetMap, cenv: CEnv):
        elems, memfn = self.domain_universe(node.domain, cenv)
        # value universe: atoms of the body desc across all bindings
        vals: List[CVal] = []
        for e in elems:
            sub = cenv.child({node.var: ("host", e)})
            vals.append(self.as_cval(self.compile(node.expr, sub)))
        atoms = set()
        for cv in vals:
            atoms |= set(_desc_atoms(cv.desc, node))
        uni = tuple(sorted(atoms, key=_sort_key))
        d = DSet(uni)
        if self.abstract:
            return CVal(d, None)
        mask = zeros((len(uni),), BOOL)
        p = FALSE
        for e, cv in zip(elems, vals):
            sel = b_(True)
            if memfn is not None:
                sel = memfn(e).data
            p = _or(p, _and_val(sel, cv.poison))
            hits = []
            for u in uni:
                uc = self.lift(u)
                try:
                    a, b, dd = self._join2(cv, uc)
                    hits.append(data_eq(dd, a.data, b.data) & sel)
                except CodegenError:
                    hits.append(b_(False))
            mask = mask | stack(hits, axis=-1)
        return CVal(d, mask, p)

    def _c_FnConstruct(self, node: A.FnConstruct, cenv: CEnv):
        # [i \in 1..n |-> e] IS a sequence in the TLA+ value canon
        # (interp make_fn normalization); compile 1..hi domains to DSeq
        dom = node.domain
        if (
            isinstance(dom, A.BinOp)
            and dom.op == ".."
            and self.is_dynamic(dom, cenv)
            and not self.is_dynamic(dom.lhs, cenv)
            and self.host_eval(dom.lhs, cenv) == 1
        ):
            hi = self.as_cval(self.compile(dom.rhs, cenv))
            self._want_int(hi, node)
            if hi.desc is None:
                return CVal(None, None)
            cap = max(hi.desc.hi, 0)
            vals = []
            p = hi.poison
            for j in range(1, cap + 1):
                sub = cenv.child({node.var: ("host", j)})
                cv = self.as_cval(self.compile(node.body, sub))
                vals.append(cv)
            ed = None
            for cv in vals:
                ed = join(ed, cv.desc)
            d = DSeq(ed, cap)
            if self.abstract:
                return CVal(d, None, FALSE)
            ln = torch.clamp(hi.data, 0, cap)
            if cap == 0:
                return CVal(d, (ln, zeros((0,), I32)), p)
            live = arange(cap) < ln
            for j, cv in enumerate(vals):
                p = _or(p, _and_val(live[j], cv.poison))
            datas = [self._coerce(cv, ed).data for cv in vals]
            stacked = tree_map(
                lambda *xs: stack(xs), *datas
            )
            stacked = tree_map(
                lambda x: where(_bcast(live, x), x, torch.zeros_like(x)),
                stacked,
            )
            return CVal(d, (ln, stacked), p)
        elems, memfn = self.domain_universe(node.domain, cenv)
        if memfn is None and list(elems) == list(range(1, len(elems) + 1)):
            # static contiguous 1..n domain: also a sequence
            vals = []
            p = FALSE
            for j in elems:
                sub = cenv.child({node.var: ("host", j)})
                cv = self.as_cval(self.compile(node.body, sub))
                p = _or(p, cv.poison)
                vals.append(cv)
            ed = None
            for cv in vals:
                ed = join(ed, cv.desc)
            d = DSeq(ed, len(elems))
            if self.abstract:
                return CVal(d, None, FALSE)
            if not vals:
                return CVal(
                    d, (i32(0), zeros((0,), I32)), p
                )
            datas = [self._coerce(cv, ed).data for cv in vals]
            stacked = tree_map(
                lambda *xs: stack(xs), *datas
            )
            return CVal(d, (i32(len(elems)), stacked), p)
        keys = tuple(sorted(elems, key=_sort_key))
        vals: List[CVal] = []
        pres: List = []
        p = FALSE
        for e in keys:
            sub = cenv.child({node.var: ("host", e)})
            cv = self.as_cval(self.compile(node.body, sub))
            if memfn is not None and not self.abstract:
                sel = memfn(e).data
                pres.append(sel)
                p = _or(p, _and_val(sel, cv.poison))
            else:
                p = _or(p, cv.poison)
            vals.append(cv)
        vd = None
        for cv in vals:
            vd = join(vd, cv.desc)
        d = DFun(keys, vd, partial=memfn is not None)
        if self.abstract:
            return CVal(d, None, FALSE)
        datas = [self._coerce(cv, vd).data for cv in vals]
        stacked = tree_map(lambda *xs: stack(xs), *datas)
        if memfn is not None:
            pr = stack(pres, axis=-1)
            stacked = tree_map(
                lambda x: _mask_axis(pr, x), stacked
            )
        else:
            pr = ()
        return CVal(d, (pr, stacked), p)

    def _c_FnExcept(self, node: A.FnExcept, cenv: CEnv):
        cur = self.as_cval(self.compile(node.fn, cenv))
        for idx_e, val_e in node.updates:
            cur = self._except_one(cur, idx_e, val_e, cenv, node)
        return cur

    def _except_one(self, cur: CVal, idx_e, val_e, cenv, node) -> CVal:
        d = cur.desc
        if isinstance(d, DSeq):
            icv = self._as_int_index(self.as_cval(self.compile(idx_e, cenv)))
            self._want_int(icv, node)
            old = self._index_into(cur, icv, node)
            sub = cenv.child({"@": ("cv", old)})
            vcv = self.as_cval(self.compile(val_e, sub))
            elem = join(d.elem, vcv.desc)
            nd = DSeq(elem, d.cap)
            p = _or(_or(cur.poison, icv.poison), vcv.poison)
            if self.abstract:
                return CVal(nd, None, p)
            cc = self._coerce(cur, nd)
            ln, ed = cc.data
            oob = (icv.data < 1) | (icv.data > ln)
            if d.cap == 0:
                return CVal(nd, (ln, ed), _or(p, oob))
            sel = torch.clamp(icv.data - 1, 0, nd.cap - 1)
            onehot = arange(nd.cap) == sel
            vcc = self._coerce(vcv, elem)
            ed = tree_map(
                lambda x, v: _onehot_set(onehot, x, v), ed, vcc.data
            )
            # out-of-cap writes must not corrupt slot data
            live = arange(nd.cap) < ln
            ed = tree_map(
                lambda x, o: where(_bcast(live, x), x, o), ed, cc.data[1]
            )
            return CVal(nd, (ln, ed), _or(p, oob))
        if isinstance(d, DFun):
            i = self.compile(idx_e, cenv)
            if isinstance(i, CVal):
                return self._except_fun_dynamic(cur, i, val_e, cenv, node)
            if i not in d.keys:
                return CVal(
                    d, cur.data,
                    True if self.abstract else _or(cur.poison, b_(True)),
                )
            k = d.keys.index(i)
            old = self._index_into(cur, i, node)
            sub = cenv.child({"@": ("cv", old)})
            vcv = self.as_cval(self.compile(val_e, sub))
            val = join(d.val, vcv.desc)
            nd = DFun(d.keys, val, d.partial)
            p = _or(cur.poison, vcv.poison)
            if self.abstract:
                return CVal(nd, None, p)
            cc = self._coerce(cur, nd)
            pres, vd = cc.data
            if d.partial:
                p = _or(p, ~pres[..., k])
            vcc = self._coerce(vcv, val)
            onehot = arange(len(d.keys)) == k
            vd = tree_map(
                lambda x, v: _onehot_set(onehot, x, v), vd, vcc.data
            )
            return CVal(nd, (pres, vd), p)
        raise CodegenError(f"EXCEPT on {d} at {node.loc}")

    def _except_fun_dynamic(
        self, cur: CVal, icv: CVal, val_e, cenv, node
    ) -> CVal:
        """``[f EXCEPT ![i] = e]`` with a dynamic key: one-hot update
        over the static key universe; out-of-domain keys poison (gated
        by the enclosing guards' lazy algebra)."""
        d = cur.desc
        old = self._index_into(cur, icv, node)
        sub = cenv.child({"@": ("cv", old)})
        vcv = self.as_cval(self.compile(val_e, sub))
        val = join(d.val, vcv.desc)
        nd = DFun(d.keys, val, d.partial)
        p = _or(cur.poison, icv.poison)
        if self.abstract:
            return CVal(nd, None, p)
        hits = []
        for key in d.keys:
            kc = self.lift(key)
            try:
                a, b, dd = self._join2(icv, kc)
                hits.append(asarray(data_eq(dd, a.data, b.data)))
            except CodegenError:
                hits.append(b_(False))
        onehot = stack(torch.broadcast_tensors(*hits), axis=-1)
        found = any_(onehot, axis=-1)
        cc = self._coerce(cur, nd)
        pres, vd = cc.data
        if d.partial:
            p = _or(p, any_(onehot & ~pres, axis=-1))
        vcc = self._coerce(vcv, val)
        vd = tree_map(
            lambda x, v: _onehot_set_dyn(onehot, x, v), vd, vcc.data
        )
        p = _or(p, _or(~found, vcc.poison))
        return CVal(nd, (pres, vd), p)

    def _c_RecordLit(self, node: A.RecordLit, cenv: CEnv):
        fields = []
        datas = {}
        p = FALSE
        for name, e in sorted(node.fields, key=lambda fe: fe[0]):
            cv = self.as_cval(self.compile(e, cenv))
            fields.append((name, cv.desc))
            p = _or(p, cv.poison)
            if not self.abstract:
                datas[name] = cv.data
        d = DRec(tuple(fields))
        if self.abstract:
            return CVal(d, None, p)
        return CVal(d, datas, p)

    def _c_Quant(self, node: A.Quant, cenv: CEnv):
        return self._quant(node, 0, cenv)

    def _quant(self, node: A.Quant, b: int, cenv: CEnv) -> CVal:
        if b == len(node.bindings):
            return self.cbool(node.body, cenv)
        var, dom_e = node.bindings[b]
        elems, memfn = self.domain_universe(dom_e, cenv)
        vals, p = [], FALSE
        for e in sorted(elems, key=_sort_key):
            sub = cenv.child({var: ("host", e)})
            cv = self._quant(node, b + 1, sub)
            if self.abstract:
                continue
            v = cv.data
            pe = cv.poison
            if memfn is not None:
                mem = memfn(e)
                pe = _and_val(mem.data, pe)
                v = (
                    (v | ~mem.data)
                    if node.kind == "A"
                    else (v & mem.data)
                )
            vals.append(v)
            p = _or(p, pe)
        if self.abstract:
            return CVal(DBool(), None)
        if not vals:
            return CVal(DBool(), b_(node.kind == "A"))
        st = stack(vals, axis=-1)
        out = all_(st, axis=-1) if node.kind == "A" else any_(st, axis=-1)
        return CVal(DBool(), out, p)

    def _c_Choose(self, node: A.Choose, cenv: CEnv):
        elems, memfn = self.domain_universe(node.domain, cenv)
        elems = sorted(elems, key=_sort_key)
        cands: List[Tuple[CVal, object]] = []
        p = FALSE
        for e in elems:
            sub = cenv.child({node.var: ("host", e)})
            pv = self.cbool(node.pred, sub)
            if self.abstract:
                continue
            sel = pv.data
            pe = pv.poison
            if memfn is not None:
                mem = memfn(e)
                sel = sel & mem.data
                pe = _and_val(mem.data, pe)
            cands.append((self.lift(e), sel))
            p = _or(p, pe)
        vd = None
        for e in elems:
            vd = join(vd, desc_of_value(e))
        if vd is None:
            # statically empty domain (possible mid-fixpoint): always a
            # no-witness error if demanded; bottom / poisoned placeholder
            if self.abstract:
                return CVal(None, None)
            return CVal(DInt(0, 0), i32(0), b_(True))
        if self.abstract:
            return CVal(vd, None)
        # first (by _sort_key order) element whose predicate holds
        out = self._coerce(self.lift(elems[0]), vd).data
        found = b_(False)
        for cv, sel in cands:
            take = sel & ~found
            dd = self._coerce(cv, vd).data
            out = tree_map(
                lambda o, n: where(_bcast(take, n), n, o), out, dd
            )
            found = found | sel
        return CVal(vd, out, _or(p, ~found))

    def _c_If(self, node: A.If, cenv: CEnv):
        c = self.cbool(node.cond, cenv)
        t = self.as_cval(self.compile(node.then, cenv))
        e = self.as_cval(self.compile(node.orelse, cenv))
        tc, ec, d = self._join2(t, e)
        if self.abstract:
            return CVal(d, None, FALSE)
        data = data_where(d, c.data, tc.data, ec.data)
        p = _or(
            c.poison,
            _or(_and_val(c.data, tc.poison), _and_val(~c.data, ec.poison)),
        )
        return CVal(d, data, p)

    def _c_Let(self, node: A.Let, cenv: CEnv):
        table = {}
        sub = cenv.child(table)
        for name, params, body in node.defs:
            if params:
                table[name] = ("op", params, body, sub)
            else:
                if self.is_dynamic(body, sub):
                    table[name] = ("cv", self.as_cval(self.compile(body, sub)))
                else:
                    table[name] = ("host", self.host_eval(body, sub))
        return self.compile(node.body, sub)

    def _c_Lambda(self, node: A.Lambda, cenv: CEnv):
        raise CodegenError(f"LAMBDA outside SelectSeq at {node.loc}")

    def _c_Num(self, node, cenv):
        return node.value

    def _c_Bool(self, node, cenv):
        return node.value

    def _c_Str(self, node, cenv):
        return node.value


def _bcast(mask, arr):
    extra = arr.ndim - asarray(mask).ndim
    if extra > 0:
        return asarray(mask).reshape(shape_of(mask) + (1,) * extra)
    return mask


def _onehot_pick_axis(onehot, x):
    """x[..., k, ...]?  vals have leading key axis at position 0 after the
    batch dims collapse — here x is [k, ...] and onehot [..., k]."""
    oh = onehot
    # onehot [..., k]; x [k, ...]: contract over k
    oh2 = torch.movedim(oh, -1, 0)
    while oh2.ndim < x.ndim:
        oh2 = oh2[..., None]
    return where(oh2, x, 0).sum(dim=0).to(x.dtype)


def _onehot_set(onehot, x, v):
    """x[cap, ...] with x[i] = v where onehot[i]."""
    oh = onehot
    while oh.ndim < x.ndim:
        oh = oh[..., None]
    vv = asarray(v)
    return where(oh, vv, x)


def _onehot_set_dyn(onehot, x, v):
    """x[k, ...] updated with v where onehot[..., k] (dynamic key)."""
    oh = torch.movedim(asarray(onehot), -1, 0)
    while oh.ndim < x.ndim:
        oh = oh[..., None]
    return where(oh, asarray(v), x)


def _mask_axis(pres, x):
    """Zero val slots whose presence bit is off (canonical form)."""
    m = torch.movedim(pres, -1, 0)
    while m.ndim < x.ndim:
        m = m[..., None]
    return where(m, x, torch.zeros_like(x))


def _zero(compiler: Compiler, d):
    return tree_map(const, encode_value_zero(d))


def _desc_atoms(d, node) -> List:
    """Enumerable host atoms of a scalar descriptor (for set universes)."""
    if isinstance(d, DInt):
        if d.hi - d.lo > Compiler.MAX_UNIVERSE:
            raise CodegenError(f"int range too wide for a set universe: {d}")
        return list(range(d.lo, d.hi + 1))
    if isinstance(d, DBool):
        return [False, True]
    if isinstance(d, DEnum):
        return list(d.members)
    raise CodegenError(
        f"set universe of non-atomic desc {d} at {getattr(node, 'loc', None)}"
    )


# ---------------------------------------------------------------- builtins


def _unopt(c: Compiler, cv: CVal) -> CVal:
    """Unwrap an option value: using Nil where a sequence/set/record is
    demanded is a TLC evaluation error -> poison."""
    if isinstance(cv.desc, DOpt):
        return CVal(
            cv.desc.inner,
            None if c.abstract else cv.data[1],
            cv.poison if c.abstract else _or(cv.poison, ~cv.data[0]),
        )
    return cv


def _b_len(c: Compiler, node: A.Apply, cenv: CEnv):
    s = _unopt(c, c.as_cval(c.compile(node.args[0], cenv)))
    if s.desc is None and c.abstract:
        return CVal(None, None)
    if not isinstance(s.desc, DSeq):
        raise CodegenError(f"Len of {s.desc} at {node.loc}")
    d = DInt(0, s.desc.cap)
    if c.abstract:
        return CVal(d, None, s.poison)
    return CVal(d, s.data[0], s.poison)


def _b_append(c: Compiler, node: A.Apply, cenv: CEnv):
    s = _unopt(c, c.as_cval(c.compile(node.args[0], cenv)))
    v = c.as_cval(c.compile(node.args[1], cenv))
    if s.desc is None and c.abstract:
        return CVal(None, None)
    if not isinstance(s.desc, DSeq):
        raise CodegenError(f"Append to {s.desc} at {node.loc}")
    elem = join(s.desc.elem, v.desc)
    cap = s.desc.cap + 1
    d = DSeq(elem, cap)
    p = _or(s.poison, v.poison)
    if c.abstract:
        return CVal(d, None, p)
    sc = c._coerce(s, DSeq(elem, cap))
    ln, ed = sc.data
    vcc = c._coerce(v, elem)
    onehot = arange(cap) == torch.clamp(ln, 0, cap - 1)
    ed = tree_map(
        lambda x, nv: _onehot_set(onehot, x, nv), ed, vcc.data
    )
    return CVal(d, (ln + 1, ed), p)


def _b_head(c: Compiler, node: A.Apply, cenv: CEnv):
    s = _unopt(c, c.as_cval(c.compile(node.args[0], cenv)))
    fake = A.Index(fn=node.args[0], args=(A.Num(value=1),), loc=node.loc)
    return c._index_into(s, c.lift(1), fake)


def _b_tail(c: Compiler, node: A.Apply, cenv: CEnv):
    s = _unopt(c, c.as_cval(c.compile(node.args[0], cenv)))
    if s.desc is None and c.abstract:
        return CVal(None, None)
    if not isinstance(s.desc, DSeq):
        raise CodegenError(f"Tail of {s.desc} at {node.loc}")
    d = DSeq(s.desc.elem, max(s.desc.cap - 1, 0))
    p = s.poison
    if c.abstract:
        return CVal(d, None, p)
    ln, ed = s.data
    p = _or(p, ln < 1)
    ed2 = tree_map(lambda x: x[1:], ed)
    return CVal(d, (torch.clamp(ln - 1, min=0), ed2), p)


def _b_cardinality(c: Compiler, node: A.Apply, cenv: CEnv):
    s = _unopt(c, c.as_cval(c.compile(node.args[0], cenv)))
    if s.desc is None and c.abstract:
        return CVal(None, None)
    if not isinstance(s.desc, DSet):
        raise CodegenError(f"Cardinality of {s.desc} at {node.loc}")
    d = DInt(0, len(s.desc.universe))
    if c.abstract:
        return CVal(d, None, s.poison)
    return CVal(
        d, isum(s.data, -1), s.poison
    )


def _b_selectseq(c: Compiler, node: A.Apply, cenv: CEnv):
    s = _unopt(c, c.as_cval(c.compile(node.args[0], cenv)))
    if s.desc is None and c.abstract:
        return CVal(None, None)
    if not isinstance(s.desc, DSeq):
        raise CodegenError(f"SelectSeq of {s.desc} at {node.loc}")
    lam = node.args[1]
    if isinstance(lam, A.Lambda):
        params, body, lamenv = lam.params, lam.body, cenv
    else:
        ent = cenv.get(getattr(lam, "name", None)) if isinstance(
            lam, A.Name
        ) else None
        if ent is not None and ent[0] == "op":
            _k, params, body, lamenv = ent
        elif (
            isinstance(lam, A.Name)
            and lam.name in c.spec.defs
            and c.spec.defs[lam.name].params
        ):
            dd = c.spec.defs[lam.name]
            params, body, lamenv = dd.params, dd.body, CEnv()
        else:
            raise CodegenError(f"SelectSeq filter unsupported at {node.loc}")
    cap = s.desc.cap
    d = DSeq(s.desc.elem, cap)
    if c.abstract:
        return CVal(d, None, s.poison)
    ln, ed = s.data
    keeps, p = [], s.poison
    for j in range(cap):
        ej = CVal(
            s.desc.elem, tree_map(lambda x: x[j], ed)
        )
        sub = lamenv.child({params[0]: ("cv", ej)})
        kv = c.cbool(body, sub)
        live = asarray(j < ln)
        keeps.append(kv.data & live)
        p = _or(p, _and_val(live, kv.poison))
    if cap == 0:
        return CVal(d, (i32(0), ed), p)
    keep = stack(keeps)  # [cap]
    tgt = torch.cumsum(keep.to(I32), 0).to(I32) - 1  # kept j -> output slot
    out_ln = isum(keep, 0)
    # out[i] = elem at the (i+1)-th kept position: one-hot matrix [i, j]
    sel = keep[None, :] & (tgt[None, :] == arange(cap)[:, None])
    ed2 = tree_map(
        lambda x: _compress(sel, x), ed
    )
    return CVal(d, (out_ln, ed2), p)


def _compress(sel, x):
    """sel[i, j]: out[i] = x[j] where sel (at most one j per i)."""
    s = sel
    while s.ndim < x.ndim + 1:
        s = s[..., None]
    return where(s, x[None, ...], 0).sum(dim=1).to(x.dtype)


_BUILTIN_COMPILERS = {
    "Len": _b_len,
    "Append": _b_append,
    "Head": _b_head,
    "Tail": _b_tail,
    "Cardinality": _b_cardinality,
    "SelectSeq": _b_selectseq,
}


# ---------------------------------------------------------------- actions


@dataclass
class ActState:
    """One lane in progress: primed assignments + accumulated guard."""

    cenv: CEnv
    assigns: Dict[str, CVal] = field(default_factory=dict)
    valid: object = True  # True | bool array
    poison: object = FALSE
    label: Optional[str] = None

    def fork(self) -> "ActState":
        return ActState(
            self.cenv, dict(self.assigns), self.valid, self.poison,
            self.label,
        )


class ActionCompiler(Compiler):
    """Adds the Init/Next lane walker to the expression compiler.

    The walk mirrors the interpreter's ``_enum`` exactly: conjunction
    threads assignments left to right, disjunction / ``\\E`` /
    ``x' \\in S`` fork lanes, named definitions inline (first name on
    the path labels the lane), IF forks on its (possibly dynamic)
    condition, UNCHANGED copies current values.  In the abstract pass
    recognized guards narrow variable descriptors so bounded-growth
    patterns converge."""

    def __init__(self, spec: Spec, primed: bool):
        super().__init__(spec)
        self.primed = primed
        self.lanes: List[ActState] = []

    # -- guard narrowing (abstract pass only) --------------------------

    _FLIP = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "="}

    def _narrow(self, node: A.Node, cenv: CEnv) -> CEnv:
        if not self.abstract or not isinstance(node, A.BinOp):
            return cenv
        op, lhs, rhs = node.op, node.lhs, node.rhs
        if op == "\\in":
            return self._narrow_membership(lhs, rhs, cenv)
        if op not in ("<", ">", "<=", ">=", "="):
            return cenv
        if self.is_dynamic(rhs, cenv) and not self.is_dynamic(lhs, cenv):
            lhs, rhs = rhs, lhs
            op = self._FLIP[op]
        if self.is_dynamic(rhs, cenv):
            # dynamic bound (e.g. ``lac < added``): use the rhs
            # DESCRIPTOR's static envelope — lac < added <= added.hi
            try:
                rcv = self.as_cval(self.compile(rhs, cenv))
            except CodegenError:
                return cenv
            if not isinstance(rcv.desc, DInt):
                return cenv
            blo, bhi = rcv.desc.lo, rcv.desc.hi
        else:
            try:
                bound = self.host_eval(rhs, cenv)
            except EvalError:
                return cenv
            if not isinstance(bound, int) or isinstance(bound, bool):
                return cenv
            blo = bhi = bound
        hi = {"<": bhi - 1, "<=": bhi, "=": bhi}.get(op)
        lo = {">": blo + 1, ">=": blo, "=": blo}.get(op)
        # Len(v) bound -> narrow the seq cap
        if (
            isinstance(lhs, A.Apply)
            and lhs.op == "Len"
            and len(lhs.args) == 1
            and isinstance(lhs.args[0], A.Name)
        ):
            nm = lhs.args[0].name
            ent = cenv.get(nm)
            if ent is not None and ent[0] == "cv" and isinstance(
                ent[1].desc, DSeq
            ) and hi is not None:
                d = ent[1].desc
                nd = DSeq(d.elem, min(d.cap, max(hi, 0)))
                return cenv.child({nm: ("cv", CVal(nd, None))})
            return cenv
        if isinstance(lhs, A.Name):
            ent = cenv.get(lhs.name)
            if ent is not None and ent[0] == "cv" and isinstance(
                ent[1].desc, DInt
            ):
                d = ent[1].desc
                nlo = max(d.lo, lo) if lo is not None else d.lo
                nhi = min(d.hi, hi) if hi is not None else d.hi
                if nlo > nhi:
                    nlo, nhi = d.lo, d.hi  # contradictory guard: skip
                return cenv.child(
                    {lhs.name: ("cv", CVal(DInt(nlo, nhi), None))}
                )
        # guard on an indexed element, e.g. ``published[c] < Limit``:
        # record an index-level fact (sound: scoped to this lane's env
        # and to this exact host index) consulted by _c_Index
        fk = self._fact_key(lhs, cenv)
        if fk is not None:
            cur = self.as_cval(self.compile(lhs, cenv))
            if isinstance(cur.desc, DInt):
                d = cur.desc
                nlo = max(d.lo, lo) if lo is not None else d.lo
                nhi = min(d.hi, hi) if hi is not None else d.hi
                if nlo <= nhi:
                    return cenv.child(
                        {fk: ("cv", CVal(DInt(nlo, nhi), None))}
                    )
        return cenv

    def _fact_key(self, node, cenv: CEnv) -> Optional[str]:
        """Stable key for ``Name[host-index]`` / ``Name[i][j]`` chains."""
        idxs = []
        while isinstance(node, A.Index) and len(node.args) == 1:
            if self.is_dynamic(node.args[0], cenv):
                return None
            try:
                idxs.append(self.host_eval(node.args[0], cenv))
            except EvalError:
                return None
            node = node.fn
        if not idxs or not isinstance(node, A.Name):
            return None
        ent = cenv.get(node.name)
        if ent is None or ent[0] != "cv":
            return None
        # key by the resolved binding's identity, not the bare name, so a
        # LET binding shadowing a state variable never inherits its facts
        return f"__fact__:{id(ent)}:{list(reversed(idxs))!r}"

    def _narrow_membership(self, lhs, rhs, cenv: CEnv) -> CEnv:
        """Guard ``v \\in S`` or ``v ± c \\in S``: bound v's int range by
        S's static universe (the membership-guard analog of the CMP
        narrowing; needed for mutual-growth patterns like
        ``(markDelete + 1) \\in acked`` + ``markDelete' = markDelete + 1``)."""
        shift = 0
        if (
            isinstance(lhs, A.BinOp)
            and lhs.op in ("+", "-")
            and isinstance(lhs.lhs, A.Name)
            and not self.is_dynamic(lhs.rhs, cenv)
        ):
            try:
                c = self.host_eval(lhs.rhs, cenv)
            except EvalError:
                return cenv
            if not isinstance(c, int) or isinstance(c, bool):
                return cenv
            shift = c if lhs.op == "+" else -c
            lhs = lhs.lhs
        if not isinstance(lhs, A.Name):
            return cenv
        ent = cenv.get(lhs.name)
        if ent is None or ent[0] != "cv" or not isinstance(
            ent[1].desc, DInt
        ):
            return cenv
        try:
            elems, _m = self.domain_universe(rhs, cenv)
        except CodegenError:
            return cenv
        ints = [e for e in elems if isinstance(e, int)
                and not isinstance(e, bool)]
        if not ints:
            return cenv
        d = ent[1].desc
        nlo = max(d.lo, min(ints) - shift)
        nhi = min(d.hi, max(ints) - shift)
        if nlo > nhi:
            return cenv
        return cenv.child({lhs.name: ("cv", CVal(DInt(nlo, nhi), None))})

    # -- the walk ------------------------------------------------------

    def run(self, node: A.Node, cenv: CEnv) -> List[ActState]:
        self.lanes = []
        st = ActState(cenv)
        self._act(node, st, self._finish)
        return self.lanes

    def _finish(self, st: ActState):
        if len(self.lanes) >= self.MAX_LANES:
            raise CodegenError("action lane explosion (raise MAX_LANES?)")
        self.lanes.append(st)

    def _guard(self, node: A.Node, st: ActState, cont):
        cv = self.cbool(node, st.cenv)
        if not self.abstract:
            st.poison = _or(st.poison, _and_val(st.valid, cv.poison))
            st.valid = (
                cv.data if st.valid is True else st.valid & cv.data
            )
        st.cenv = self._narrow(node, st.cenv)
        cont(st)

    def _assign(self, var: str, cv: CVal, st: ActState, cont):
        key = var + "'"
        if var in st.assigns:
            prev = st.assigns[var]
            if not self.abstract:
                a, b, d = self._join2(prev, cv)
                eq = data_eq(d, a.data, b.data)
                st.poison = _or(
                    st.poison, _and_val(st.valid, _or(prev.poison, cv.poison))
                )
                st.valid = eq if st.valid is True else st.valid & eq
            cont(st)
            return
        st.assigns[var] = cv
        st.cenv = st.cenv.child({key: ("cv", cv)})
        cont(st)

    def _act(self, node: A.Node, st: ActState, cont):
        k = type(node)
        if k is A.Junction and node.op == "/\\":
            self._conj_act(list(node.items), st, cont)
            return
        if k is A.BinOp and node.op == "/\\":
            self._conj_act([node.lhs, node.rhs], st, cont)
            return
        if k is A.Junction and node.op == "\\/":
            for item in node.items:
                self._act(item, st.fork(), cont)
            return
        if k is A.BinOp and node.op == "\\/":
            self._act(node.lhs, st.fork(), cont)
            self._act(node.rhs, st.fork(), cont)
            return
        if k is A.Quant and node.kind == "E":
            self._exists(node, 0, st, cont)
            return
        if k is A.Let:
            table: Dict[str, object] = {}
            sub = st.cenv.child(table)
            for name, params, body in node.defs:
                if params:
                    table[name] = ("op", params, body, sub)
                elif self.is_dynamic(body, sub):
                    table[name] = (
                        "cv", self.as_cval(self.compile(body, sub))
                    )
                else:
                    table[name] = ("host", self.host_eval(body, sub))
            st.cenv = sub
            self._act(node.body, st, cont)
            return
        if k is A.If:
            if not self.is_dynamic(node.cond, st.cenv):
                c = self.host_eval(node.cond, st.cenv)
                self._act(node.then if c else node.orelse, st, cont)
                return
            t = st.fork()
            self._guard(node.cond, t, lambda s: self._act(node.then, s, cont))
            e = st.fork()
            self._guard(
                A.UnOp(op="~", expr=node.cond, loc=node.loc), e,
                lambda s: self._act(node.orelse, s, cont),
            )
            return
        if k is A.Name and node.name in self.spec.defs:
            d = self.spec.defs[node.name]
            if not d.params:
                st.label = st.label or node.name
                self._act(d.body, st, cont)
                return
        if k is A.Apply and node.op in self.spec.defs:
            d = self.spec.defs[node.op]
            if d.params:
                table = {}
                for p, a in zip(d.params, node.args):
                    v = self.compile(a, st.cenv)
                    table[p] = (
                        ("cv", v) if isinstance(v, CVal) else ("host", v)
                    )
                st.label = st.label or node.op
                st.cenv = st.cenv.child(table)
                self._act(d.body, st, cont)
                return
        if k is A.UnOp and node.op == "UNCHANGED":
            if not self.primed:
                raise CodegenError("UNCHANGED in Init")
            for v in _unchanged_names(node.expr, self.varset,
                                         self.spec.defs):
                ent = st.cenv.get(v)
                if ent is None or ent[0] != "cv":
                    raise CodegenError(f"UNCHANGED of unbound {v}")
                # _assign mutates st in place and calls cont synchronously
                self._assign(v, ent[1], st, lambda s: None)
            cont(st)
            return
        tgt = self._assign_target(node)
        if tgt is not None:
            var, kind, rhs = tgt
            if kind == "=":
                cv = self.as_cval(self.compile(rhs, st.cenv))
                self._assign(var, cv, st, cont)
                return
            # x' \in S : fork one lane per universe element
            if not self.is_dynamic(rhs, st.cenv):
                dom = self.host_eval(rhs, st.cenv)
                elems = sorted(_enum_set(dom), key=_sort_key)
                if len(elems) * max(len(self.lanes), 1) > self.MAX_LANES:
                    raise CodegenError(
                        f"x' \\in S fanout too large ({len(elems)})"
                    )
                for e in elems:
                    s2 = st.fork()
                    self._assign(var, self.lift(e), s2, cont)
                return
            elems, memfn = self.domain_universe(rhs, st.cenv)
            for e in sorted(elems, key=_sort_key):
                s2 = st.fork()
                mem = memfn(e)
                if not self.abstract:
                    s2.poison = _or(s2.poison, _and_val(s2.valid, mem.poison))
                    s2.valid = (
                        mem.data
                        if s2.valid is True
                        else s2.valid & mem.data
                    )
                self._assign(var, self.lift(e), s2, cont)
            return
        # plain guard
        self._guard(node, st, cont)

    def _conj_act(self, items, st: ActState, cont):
        if not items:
            cont(st)
            return
        head, rest = items[0], items[1:]
        self._act(head, st, lambda s: self._conj_act(rest, s, cont))

    def _exists(self, node: A.Quant, b: int, st: ActState, cont):
        if b == len(node.bindings):
            self._act(node.body, st, cont)
            return
        var, dom_e = node.bindings[b]
        elems, memfn = self.domain_universe(dom_e, st.cenv)
        elems = sorted(elems, key=_sort_key)
        for e in elems:
            s2 = st.fork()
            if memfn is not None:
                mem = memfn(e)
                if not self.abstract:
                    s2.poison = _or(s2.poison, _and_val(s2.valid, mem.poison))
                    s2.valid = (
                        mem.data
                        if s2.valid is True
                        else s2.valid & mem.data
                    )
            s2.cenv = s2.cenv.child({var: ("host", e)})
            self._exists(node, b + 1, s2, cont)

    def _assign_target(self, node):
        if not isinstance(node, A.BinOp) or node.op not in ("=", "\\in"):
            return None
        lhs = node.lhs
        if self.primed:
            if isinstance(lhs, A.Prime) and isinstance(lhs.expr, A.Name):
                nm = lhs.expr.name
                if nm in self.varset:
                    return nm, node.op, node.rhs
            return None
        if isinstance(lhs, A.Name) and lhs.name in self.varset:
            return lhs.name, node.op, node.rhs
        return None


# ---------------------------------------------------------- inference


ERR_VAR = "__err__"


def infer_var_descs(spec: Spec, max_iters: int = 64) -> Dict[str, object]:
    """Abstract fixpoint: Init seeds the descriptors, Next widens them
    (with guard narrowing) until stable."""
    descs: Dict[str, object] = {}
    # Init seeds: when Init factors into per-variable draws, a
    # representative sample covering every per-slot candidate value
    # joins to the same descriptors as the full cross product — which
    # can be astronomically large (compaction.tla:191-194 at M=64);
    # otherwise enumerate host-side through the interpreter (exact)
    vfactors = _factor_init_values(spec)
    init_sample = (
        _init_value_sample(vfactors)
        if vfactors is not None
        else spec.initial_states()
    )
    for s in init_sample:
        for v, val in zip(spec.vars, s):
            descs[v] = join(descs.get(v), desc_of_value(val))
    for _ in range(max_iters):
        ac = ActionCompiler(spec, primed=True)
        ac.abstract = True
        cenv = CEnv(
            {v: ("cv", CVal(descs[v], None)) for v in spec.vars}
        )
        lanes = ac.run(spec.defs["Next"].body, cenv)
        new = dict(descs)
        for lane in lanes:
            for v in spec.vars:
                if v not in lane.assigns:
                    raise CodegenError(
                        f"lane {lane.label} leaves {v}' unassigned"
                    )
                new[v] = join(new[v], lane.assigns[v].desc)
        if new == descs:
            return descs
        descs = new
    raise CodegenError("descriptor inference did not converge")


# ----------------------------------------------------- engine adapter


class _FactoredInit:
    """Cross-product initial-state set generated by a mixed-radix
    counting kernel instead of host enumeration (VERDICT r2 #5 /
    SURVEY.md §3.2: the reference's ``ModelProducer=FALSE`` Init draws
    ``(|KeySet|*|ValueSet|)^MessageSentLimit`` sequences — host
    enumeration explodes where counting is free).

    ``factors`` is one entry per state variable, in ``spec.vars``
    order:

    - ``("const", encoded)`` — a single value (``var = expr``);
    - ``("choice", tables, n)`` — ``var \\in S``: pytree with a leading
      ``n`` axis of encoded candidate values;
    - ``("funseq", tables, radices)`` — a filtered function/sequence
      space factored per position: pytree with leading ``[P, R]`` axes
      (position, per-position candidate), plus per-position radices.

    ``gen_initial(idx)`` peels mixed-radix digits off ``idx`` (least
    significant factor first) and gathers each variable's encoded
    value — O(state size), fully traced, no tables of the product.
    """

    def __init__(self, factors, n_initial: int):
        self.factors = factors
        self.n = n_initial

    def gen(self, idx):
        """One initial state (``idx`` a 0-d int64 tensor; vmapped by the
        caller)."""
        out = {}
        rem = idx
        for var, kind, payload in self.factors:
            if kind == "const":
                out[var] = tree_map(const, payload)
                continue
            if kind == "choice":
                tables, n = payload
                digit = rem % n
                rem = rem // n
                out[var] = tree_map(lambda t: const(t)[digit], tables)
                continue
            mk, tables, radices = payload
            digits = []
            for r in radices:
                digits.append(rem % r)
                rem = rem // r
            dvec = torch.stack(digits)
            pvec = torch.arange(
                len(radices), dtype=torch.int64, device=dvec.device
            )
            out[var] = tree_map(
                asarray,
                mk(tree_map(lambda t: const(t)[pvec, dvec], tables)),
            )
        out[ERR_VAR] = b_(False)
        return out


def _factor_init_values(spec: Spec):
    """Recognize a purely conjunctive Init over per-variable draws;
    returns per-variable VALUE factors (one per ``spec.vars`` entry) or
    ``None`` when Init falls outside the factored form (callers then
    host-enumerate, exact as before).

    Handled conjunct shapes (after resolving constant-guarded
    disjunction branches, e.g. the reference's ModelProducer split):

    - ``var = closed_expr`` -> ``("const", value)``
    - ``var \\in closed_set_expr`` -> ``("choice", values)``
    - ``var \\in {f \\in [D -> R] : \\A i \\in D : P(i, f[i])}`` ->
      ``("funseq", per_position_values, dom_len)`` — the filter factors
      per position because ``P`` sees ``f`` only at ``i``, so position
      ``d``'s candidates are ``{r \\in R : P(d, r)}``
    """
    from pulsar_tlaplus_tpu_torch.frontend import interp as I
    from pulsar_tlaplus_tpu_torch.frontend import tla_ast as A

    if hasattr(spec, "_init_factor_cache"):
        return spec._init_factor_cache
    spec._init_factor_cache = None
    # eval_expr resolves spec-level definitions through this module
    # slot; spec.initial_states() used to set it as a side effect, and
    # later compile passes (UNCHANGED resolution) still read it
    I._enum._defs = spec.defs
    d = spec.defs.get("Init")
    if d is None or d.params:
        return None
    genv = spec.genv
    varset = set(spec.vars)

    def closed(node) -> bool:
        return not I._refs_any(node, varset, spec.defs)

    def flatten(node, out):
        """Conjunction flattener; constant-guarded disjunctions resolve
        to their single live branch."""
        if isinstance(node, A.Junction) and node.op == "/\\":
            for it in node.items:
                if not flatten(it, out):
                    return False
            return True
        if isinstance(node, A.BinOp) and node.op == "/\\":
            return flatten(node.lhs, out) and flatten(node.rhs, out)
        if (
            isinstance(node, A.Junction) and node.op == "\\/"
        ) or (isinstance(node, A.BinOp) and node.op == "\\/"):
            items = (
                node.items
                if isinstance(node, A.Junction)
                else (node.lhs, node.rhs)
            )
            live = []
            for br in items:
                sub: list = []
                guards_true = True
                if not flatten(br, sub):
                    return False
                kept = []
                for c in sub:
                    if c[0] == "guard":
                        if not c[1]:
                            guards_true = False
                    else:
                        kept.append(c)
                if guards_true:
                    live.append(kept)
            if len(live) != 1:
                return False  # nondeterministic across branches
            out.extend(live[0])
            return True
        if closed(node):
            try:
                val = I.eval_expr(node, genv)
            except I.EvalError:
                return False
            if not isinstance(val, bool):
                return False
            out.append(("guard", val))
            return True
        # var = expr / var \in expr
        if isinstance(node, A.BinOp) and node.op in ("=", "\\in"):
            lhs = node.lhs
            if (
                isinstance(lhs, A.Name)
                and lhs.name in varset
                and closed(node.rhs)
            ):
                out.append((node.op, lhs.name, node.rhs))
                return True
        return False

    conj: list = []
    if not flatten(d.body, conj):
        return None
    assigned = {}
    for c in conj:
        if c[0] == "guard":
            if not c[1]:
                return None  # Init is unsatisfiable; fall back
            continue
        op, var, rhs = c
        if var in assigned:
            return None
        assigned[var] = (op, rhs)
    if set(assigned) != varset:
        return None

    factors = []
    for var in spec.vars:
        op, rhs = assigned[var]
        if op == "=":
            try:
                factors.append(("const", I.eval_expr(rhs, genv)))
            except I.EvalError:
                return None
            continue
        fact = _factor_membership_values(spec, rhs)
        if fact is None:
            return None
        factors.append(fact)
    spec._init_factor_cache = factors
    return factors


def _init_value_sample(factors):
    """Representative initial states covering every per-slot candidate
    value — sufficient to seed descriptor inference (descriptors are
    per-field value joins, so covering each slot's candidates is as
    informative as the full cross product)."""
    width = 1
    for f in factors:
        if f[0] == "choice":
            width = max(width, len(f[1]))
        elif f[0] == "funseq":
            width = max(width, max(len(p) for p in f[1]))
    states = []
    for j in range(width):
        row = []
        for f in factors:
            if f[0] == "const":
                row.append(f[1])
            elif f[0] == "choice":
                row.append(f[1][min(j, len(f[1]) - 1)])
            else:
                from pulsar_tlaplus_tpu_torch.frontend import interp as I

                per_pos, dom_vals = f[1], f[2]
                picks = [
                    p[min(j, len(p) - 1)] for p in per_pos
                ]
                if list(dom_vals) == list(range(1, len(dom_vals) + 1)):
                    row.append(tuple(picks))
                else:
                    row.append(
                        I.make_fn(dict(zip(dom_vals, picks)))
                    )
        states.append(tuple(row))
    return states


def _fvar_only_indexed(node, fvar: str, ivar: str) -> bool:
    """True iff every occurrence of ``fvar`` in ``node`` is exactly the
    application ``fvar[ivar]`` (and ``fvar``/``ivar`` are never
    shadowed-rebound, conservatively rejected)."""
    from pulsar_tlaplus_tpu_torch.frontend import tla_ast as A
    import dataclasses as _dc

    ok = True

    def walk(n):
        nonlocal ok
        if not ok or not isinstance(n, A.Node):
            return
        if isinstance(n, A.Index):
            if (
                isinstance(n.fn, A.Name)
                and n.fn.name == fvar
            ):
                if not (
                    len(n.args) == 1
                    and isinstance(n.args[0], A.Name)
                    and n.args[0].name == ivar
                ):
                    ok = False
                return
        if isinstance(n, A.Name) and n.name == fvar:
            ok = False
            return
        # conservatively reject rebinding of either name
        for binder_attr in ("var",):
            v = getattr(n, binder_attr, None)
            if v in (fvar, ivar):
                ok = False
                return
        if isinstance(n, (A.Quant,)):
            for v, _dom in n.bindings:
                if v in (fvar, ivar):
                    ok = False
                    return
        for f in _dc.fields(n):
            v = getattr(n, f.name)
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

    walk(node)
    return ok


def _factor_membership_values(spec: Spec, rhs):
    """Factor one membership conjunct at the VALUE level; returns
    ``("choice", values)`` or ``("funseq", per_position_values,
    dom_len)`` or None."""
    from pulsar_tlaplus_tpu_torch.frontend import interp as I
    from pulsar_tlaplus_tpu_torch.frontend import tla_ast as A

    genv = spec.genv
    # the pointwise-filtered function space
    if (
        isinstance(rhs, A.SetFilter)
        and isinstance(rhs.domain, A.FnSpace)
        and isinstance(rhs.pred, A.Quant)
        and rhs.pred.kind == "A"
        and len(rhs.pred.bindings) == 1
    ):
        fvar = rhs.var
        ivar, idom = rhs.pred.bindings[0]
        if not _fvar_only_indexed(rhs.pred.body, fvar, ivar):
            # the one-entry-function probe below is only faithful when
            # the predicate sees f exclusively as f[ivar]; DOMAIN f,
            # Len(f), f[other] etc. would silently mis-evaluate
            return None
        try:
            dom_vals = sorted(
                I._enum_set(I.eval_expr(rhs.domain.domain, genv)),
                key=I._sort_key,
            )
            rng_vals = sorted(
                I._enum_set(I.eval_expr(rhs.domain.codomain, genv)),
                key=I._sort_key,
            )
            quant_dom = frozenset(
                I._enum_set(I.eval_expr(idom, genv))
            )
        except I.EvalError:
            return None
        per_pos = []
        try:
            for dv in dom_vals:
                if dv not in quant_dom:
                    per_pos.append(list(rng_vals))
                    continue
                keep = []
                for rv in rng_vals:
                    # P sees f only at f[ivar]: a one-entry function
                    # faithfully evaluates it, and any other access
                    # raises (-> fall back to host enumeration)
                    env = genv.child(
                        {
                            fvar: I.make_fn({dv: rv}),
                            ivar: dv,
                        }
                    )
                    v = I.eval_expr(rhs.pred.body, env)
                    if not isinstance(v, bool):
                        return None
                    if v:
                        keep.append(rv)
                per_pos.append(keep)
        except I.EvalError:
            return None
        if any(not p for p in per_pos):
            return None  # empty position => empty set; fall back
        return ("funseq", per_pos, tuple(dom_vals))
    # a flat closed enumerable set
    try:
        vals = sorted(
            I._enum_set(I.eval_expr(rhs, genv)), key=I._sort_key
        )
    except I.EvalError:
        return None
    if not vals or len(vals) > 1 << 20:
        return None
    return ("choice", vals)


def _try_factor_init(spec: Spec, var_descs) -> Optional[_FactoredInit]:
    """Encode the value factors of :func:`_factor_init_values` into the
    counting-kernel generator; ``None`` when Init does not factor or a
    value falls outside its descriptors (callers host-enumerate)."""
    vfactors = _factor_init_values(spec)
    if vfactors is None:
        return None
    factors = []
    n_total = 1
    try:
        for var, f in zip(spec.vars, vfactors):
            desc = var_descs[var]
            if f[0] == "const":
                factors.append((var, "const", encode_value(desc, f[1])))
                continue
            if f[0] == "choice":
                vals = f[1]
                enc = [encode_value(desc, v) for v in vals]
                tables = tree_map(
                    lambda *xs: np.stack(xs), *enc
                )
                factors.append((var, "choice", (tables, len(vals))))
                n_total *= len(vals)
                continue
            enc2 = _encode_funseq(desc, f[1], f[2])
            if enc2 is None:
                return None
            payload, count = enc2
            factors.append((var, "funseq", payload))
            n_total *= count
    except CodegenError:
        return None
    return _FactoredInit(factors, n_total)


def _encode_funseq(desc, per_pos, dom_vals):
    """Encode per-position candidate tables for a factored function or
    sequence draw: pytree with leading [position, candidate] axes (pad
    repeats the last candidate; unreachable digits).  Returns
    ``((mk, stacked, radices), count)`` or None."""
    dom_len = len(dom_vals)
    radices = [len(p) for p in per_pos]
    rmax = max(radices)
    if isinstance(desc, DSeq):
        if (
            desc.cap < dom_len
            or desc.elem is None
            or list(dom_vals) != list(range(1, dom_len + 1))
        ):
            return None
        elem_desc = desc.elem
        mk = lambda full: (np.int32(dom_len), full)  # noqa: E731
    elif isinstance(desc, DFun) and not desc.partial:
        if tuple(desc.keys) != tuple(dom_vals):
            return None
        elem_desc = desc.val
        mk = lambda full: ((), full)  # noqa: E731
    else:
        return None
    rows = [
        [
            encode_value(elem_desc, p[min(j, len(p) - 1)])
            for j in range(rmax)
        ]
        for p in per_pos
    ]
    stacked = tree_map(
        lambda *xs: np.stack(xs),
        *[
            tree_map(lambda *ys: np.stack(ys), *row)
            for row in rows
        ],
    )
    # sequences shorter than cap: pad positions to desc.cap with zero
    # elements so the stacked tree matches the codec layout
    if isinstance(desc, DSeq) and desc.cap > dom_len:
        zero = encode_value_zero(elem_desc)
        pad = tree_map(
            lambda z: np.broadcast_to(
                np.asarray(z)[None, None],
                (desc.cap - dom_len, rmax) + np.asarray(z).shape,
            ),
            zero,
        )
        stacked = tree_map(
            lambda t, pz: np.concatenate([t, pz], axis=0),
            stacked, pad,
        )
        radices = radices + [1] * (desc.cap - dom_len)
    n = 1
    for r in radices:
        n *= r
    return ((mk, stacked, radices), n)


class CompiledSpec:
    """Engine-facing compiled model for an arbitrary spec, with the hand
    models' batched protocol: ``layout`` (pack/unpack of any batch
    shape), ``gen_initial(idx [B])``, ``successors(states) -> (states
    [B, A], valid [B, A])``, ``invariants[name](states) -> bool [B]``,
    ``liveness_goals``, ``stutter_enabled``, ``to_pystate``.  A state
    is the JAX package's ``{var: data tree}`` dict with a leading batch
    axis on every leaf.

    Evaluation errors TLC would raise become the hidden ``__err__``
    state bit, surfaced by the auto-invariant ``__EvalError__``.

    Each batched function is a per-state walk mapped with vmap and
    recorded once per (function, device, bucket) as an ATen graph;
    ``walks`` counts the per-state walks, ``graph_builds`` and
    ``graph_build_s`` the graphs recorded and the seconds spent on them,
    ``graph_calls`` and ``graph_replay_s`` the replays and the host
    seconds they took to enqueue.  A failed record or replay raises:
    nothing falls back to the eager walk."""

    MIN_BUCKET = 1024  # the smallest bucket, on every device
    MAX_BUCKET = 1 << 18  # larger calls run in chunks of this many rows

    def __init__(self, spec: Spec, invariants: Tuple[str, ...] = (),
                 device=None):
        from pulsar_tlaplus_tpu_torch.utils import device as device_mod

        self.spec = spec
        spec.check_assumes()
        self.var_descs = infer_var_descs(spec)
        self.codec_descs = dict(self.var_descs)
        self.codec_descs[ERR_VAR] = DBool()
        self.layout = DescCodec(self.codec_descs)
        # initial states: a mixed-radix counting kernel when Init is a
        # recognizable cross product of per-variable draws; otherwise
        # host-enumerated by the interpreter (exact parity) and encoded
        # once into a gatherable device table
        self._factored_init = _try_factor_init(spec, self.var_descs)
        if self._factored_init is not None:
            self.n_initial = self._factored_init.n
            self._init_rows = None
        else:
            init_states = spec.initial_states()
            self.n_initial = len(init_states)
            rows = []
            for s in init_states:
                d = {
                    v: encode_value(self.var_descs[v], val)
                    for v, val in zip(spec.vars, s)
                }
                d[ERR_VAR] = np.bool_(False)
                rows.append(d)
            self._init_rows = tree_map(lambda *xs: np.stack(xs), *rows)
        # concrete lane structure (fixed by descs; probe with abstract
        # pass to learn labels/count)
        probe = ActionCompiler(spec, primed=True)
        probe.abstract = True
        cenv = CEnv(
            {v: ("cv", CVal(self.var_descs[v], None)) for v in spec.vars}
        )
        lanes = probe.run(spec.defs["Next"].body, cenv)
        self.lane_labels = [ln.label or "Next" for ln in lanes]
        self.A = len(lanes)
        names: List[str] = []
        for lb in self.lane_labels:
            if lb not in names:
                names.append(lb)
        self.action_names = tuple(names)
        self.action_ids = np.asarray(
            [names.index(lb) for lb in self.lane_labels], np.int32
        )
        self.requested_invariants = tuple(invariants)
        for name in self.requested_invariants:
            if name not in spec.defs:
                raise CodegenError(f"spec defines no invariant {name}")
        self.default_invariants = tuple(invariants) + ("__EvalError__",)
        self.walks = 0
        self.graph_builds = 0
        self.graph_build_s = 0.0
        self.graph_calls = 0
        self.graph_replay_s = 0.0
        self._graphs: Dict[tuple, object] = {}
        self._builds: Dict[str, Build] = {}
        self._fillers: Dict[str, Dict] = {}
        self._inv_last = None
        self.device = device_mod.resolve(device)
        self._check_compiles()

    # -- per-state walks (mapped over a batch by vmap) -----------------

    def _state_env(self, state) -> "CEnv":
        return CEnv(
            {
                v: ("cv", CVal(self.var_descs[v], state[v]))
                for v in self.spec.vars
            }
        )

    def _initial1(self, idx):
        self.walks += 1
        hi = min(self.n_initial, (1 << 31) - 1) - 1
        i = torch.clamp(idx.to(torch.int64), 0, hi)
        if self._factored_init is not None:
            return self._factored_init.gen(i)
        return tree_map(lambda t: const(t)[i], self._init_rows)

    def _successors1(self, state):
        """state dict -> (stacked successor dicts [A, ...], valid [A])."""
        self.walks += 1
        ac = ActionCompiler(self.spec, primed=True)
        lanes = ac.run(self.spec.defs["Next"].body, self._state_env(state))
        if len(lanes) != self.A:
            raise CodegenError("lane structure drifted")
        succs, valids = [], []
        for lane in lanes:
            out = {}
            poison = lane.poison
            for v in self.spec.vars:
                cv = lane.assigns[v]
                nv = ac.narrow_to(cv, self.var_descs[v])
                poison = _or(poison, _and_val(lane.valid, nv.poison))
                out[v] = tree_map(asarray, nv.data)
            err = asarray(poison) if poison is not FALSE else b_(False)
            out[ERR_VAR] = state[ERR_VAR] | err
            succs.append(out)
            valids.append(b_(True) if lane.valid is True else lane.valid)
        stacked = tree_map(lambda *xs: stack(xs), *succs)
        return stacked, stack(valids)

    def _compile_invariant(self, name: str, state):
        return Compiler(self.spec).cbool(
            self.spec.defs[name].body, self._state_env(state)
        )

    def _invariants1(self, state):
        """Every default invariant in one walk: bool ``[n]`` in
        ``default_invariants`` order (the requested ones, then
        ``__EvalError__``), as JAX evaluates them in one fused check."""
        self.walks += 1
        oks = []
        bad = state[ERR_VAR]
        for name in self.requested_invariants:
            cv = self._compile_invariant(name, state)
            ok = asarray(cv.data)
            if cv.poison is not FALSE:
                # poison while evaluating the invariant is an evaluation
                # error, not a violation of ``name``: it counts as "ok"
                # here and fails ``__EvalError__`` instead (TLC raises an
                # evaluation error rather than report the invariant
                # violated); so does a lane's poison (the ERR_VAR bit)
                ok = ok | asarray(cv.poison)
                bad = bad | asarray(cv.poison)
            oks.append(ok)
        oks.append(~bad)
        return stack(oks)

    def _goal1(self, body, state):
        self.walks += 1
        cv = Compiler(self.spec).cbool(body, self._state_env(state))
        ok = asarray(cv.data)
        if cv.poison is not FALSE:
            # an evaluation error inside the goal body counts as
            # not-goal (TLC would raise; the engine surfaces the
            # __EvalError__ invariant separately)
            ok = ok & ~asarray(cv.poison)
        return ok

    # -- batching: vmap + one recorded graph per bucket ----------------

    def _build_on(self, device) -> Build:
        """The codegen context of ``device``; its first use walks every
        function once eagerly on a one-state batch, which uploads every
        constant (so the recorded graphs capture device constants) and
        fails an unsupported construct before any search starts."""
        key = str(device)
        b = self._builds.get(key)
        if b is None:
            b = self._builds[key] = Build(device)
            with build_scope(b):
                idx = torch.zeros((1,), dtype=torch.int64, device=b.device)
                s = torch.func.vmap(self._initial1)(idx)
                torch.func.vmap(self._successors1)(s)
                for fn in self._state_fns().values():
                    torch.func.vmap(fn)(s)
        return b

    def _state_fns(self):
        fns = {("inv",): self._invariants1}
        for name, body in self._goal_bodies().items():
            fns[("goal", name)] = (
                lambda s, body=body: self._goal1(body, s)
            )
        return fns

    def _check_compiles(self):
        self._build_on(self.device)

    @staticmethod
    def _bucket(n: int) -> int:
        """The batch a call of ``n <= MAX_BUCKET`` rows is padded to: a
        power of four from ``MIN_BUCKET`` up (at most 4x the rows, and
        few buckets, so few graphs)."""
        b = CompiledSpec.MIN_BUCKET
        while b < n:
            b <<= 2
        return min(b, CompiledSpec.MAX_BUCKET)

    def _filler(self, device):
        """One state every padded row repeats: the all-zero packed word
        decoded (every int at its range's low end, so no lane divides
        by zero or indexes out of range)."""
        key = str(device)
        if key not in self._fillers:
            self._fillers[key] = self.layout.unpack(
                torch.zeros((1, self.layout.W), dtype=torch.int32,
                            device=device)
            )
        return self._fillers[key]

    def _run(self, key, fn1, x, filler):
        ref = tree_leaves(x)[0]
        n, dev = ref.shape[0], ref.device
        if n > self.MAX_BUCKET:
            # chunks of the largest bucket (bounded memory and graphs)
            parts = [
                self._run(key, fn1, tree_map(lambda t: t[a: a + m], x),
                          filler)
                for a in range(0, n, self.MAX_BUCKET)
                for m in (min(self.MAX_BUCKET, n - a),)
            ]
            return tree_map(lambda *ts: torch.cat(ts), *parts)
        bucket = self._bucket(n)
        build = self._build_on(dev)
        if bucket != n:
            x = tree_map(
                lambda t, f: torch.cat(
                    [t, f.expand(bucket - n, *f.shape[1:])]
                ),
                x, filler,
            )
        gkey = (key, str(dev), bucket)
        g = self._graphs.get(gkey)
        if g is None:
            t0 = time.perf_counter()
            with build_scope(build):
                g = record(torch.func.vmap(fn1), x)
            self._graphs[gkey] = g
            self.graph_builds += 1
            self.graph_build_s += time.perf_counter() - t0
        self.graph_calls += 1
        t0 = time.perf_counter()
        out = g(x)
        self.graph_replay_s += time.perf_counter() - t0
        if bucket != n:
            out = tree_map(lambda t: t[:n], out)
        return out

    # -- model protocol (batched) --------------------------------------

    def gen_initial(self, idx: torch.Tensor):
        """Initial states ``#idx`` (``idx`` an integer tensor ``[B]``)."""
        idx = idx.to(torch.int64)
        zero = torch.zeros((1,), dtype=torch.int64, device=idx.device)
        return self._run(("init",), self._initial1, idx, zero)

    def successors(self, states):
        """States ``[B]`` -> (successor states ``[B, A]``, valid bool
        ``[B, A]``), lanes in the interpreter's enumeration order."""
        ref = states[ERR_VAR]
        return self._run(("succ",), self._successors1, states,
                         self._filler(ref.device))

    def stutter_enabled(self, states):
        # stuttering disjuncts are ordinary lanes here; deadlock checking
        # already sees them through the valid mask
        ref = states[ERR_VAR]
        return torch.zeros(ref.shape, dtype=torch.bool, device=ref.device)

    def _batched(self, key, fn1):
        def fn(states):
            return self._run(key, fn1, states,
                             self._filler(states[ERR_VAR].device))

        return fn

    def _all_invariants(self, states):
        """bool ``[B, n]``: every default invariant of ``states``, from
        one graph.  The last result is kept, so the engines' calls of
        each invariant on one batch replay the graph once."""
        last = self._inv_last
        if last is not None and last[0] is states:
            return last[1]
        out = self._run(("inv",), self._invariants1, states,
                        self._filler(states[ERR_VAR].device))
        self._inv_last = (states, out)
        return out

    @property
    def invariants(self):
        return {
            name: (lambda states, i=i: self._all_invariants(states)[:, i])
            for i, name in enumerate(self.default_invariants)
        }

    def _goal_bodies(self):
        """Named ``<>(predicate)`` temporal properties: a definition
        qualifies when its body is an eventually-applied state
        predicate (the fragment ``Termination`` uses)."""
        return {
            name: d.body.expr
            for name, d in self.spec.defs.items()
            if isinstance(d.body, A.UnOp) and d.body.op == "<>"
        }

    @property
    def liveness_goals(self):
        fns = self._state_fns()
        return {
            name: self._batched(("goal", name), fns[("goal", name)])
            for name in self._goal_bodies()
        }

    # -- conversions, trace rendering ----------------------------------

    def decode_state(self, state, b: int = 0) -> Dict[str, object]:
        """Row ``b`` of a batch -> {var: interpreter canon value}."""
        host = tree_map(lambda x: x[b].cpu().numpy(), state)
        return {
            v: decode_value(self.var_descs[v], host[v])
            for v in self.spec.vars
        }

    def to_pystate(self, state, b: int = 0) -> Dict[str, str]:
        """Row ``b`` of a batch -> rendered {var: value}
        (``utils.render``'s dict protocol)."""
        from pulsar_tlaplus_tpu_torch.engine.interp_check import format_value

        return {
            v: format_value(x) for v, x in self.decode_state(state, b).items()
        }

    def fingerprint_leaves(self, states):
        """The state's leaves in the JAX pytree order (the simulator's
        duplicate estimator hashes them)."""
        return tree_leaves(states)

    def from_jax_state(self, tree, device="cpu"):
        """A JAX compiled state tree (numpy leaves, batched or not) ->
        int32 / bool tensors on ``device``, batch shape ``[*B]``
        (``[1]`` for one unbatched state)."""
        def conv(x):
            a = np.asarray(x)
            a = a.astype(np.bool_ if a.dtype == np.bool_ else np.int32)
            return torch.as_tensor(a).to(device)

        out = tree_map(conv, dict(tree))
        if out[ERR_VAR].dim() == 0:
            out = tree_map(lambda t: t[None], out)
        return out
