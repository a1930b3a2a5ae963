"""Typed IR for the TLA+ -> PyTorch compiler — the counterpart of
``pulsar_tlaplus_tpu/frontend/codegen_ir.py``.

- **Descriptors** (:class:`DInt` ...): static types-with-bounds inferred
  for every expression — int ranges, enumerated atoms (strings / model
  values), sequences with static capacity, records, functions over
  static key universes (total or partial), finite sets as bitmask
  universes, and option types (``Nil ∪ T``).  Descriptors determine the
  bit-width of every packed-state field.  Copied from the JAX package.
- **JV**: a runtime value = descriptor + a tree (dicts and tuples) of
  int32 / bool tensors (data is ``None`` during the abstract/fixpoint
  pass; tensor layouts mirror the descriptor tree).
- **Structural ops**: TLA+ equality, IF/where-selection, coercion
  between compatible descriptors, and canonical zeroing of dead slots so
  packing is injective (equal TLA+ states <-> equal packed words).
- **DescCodec**: descriptor tree -> ``ops.packing._FieldCodec`` bit
  layout, bit for bit the JAX one, packing and unpacking any leading
  batch shape; plus host-side ``encode``/``decode`` between interpreter
  canon values (frontend/interp.py) and numpy leaf arrays.

Tensors are made on the device of the active :class:`Build` (entered
with :func:`build_scope`), every factory with an explicit ``device=``;
host values lifted into the codegen go through the build's constant
cache, so each constant is uploaded once per device, and a graph traced
after a warm walk captures it as a device constant (``codegen.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pulsar_tlaplus_tpu_torch.frontend.interp import (
    FDict,
    MV,
    _sort_key,
    make_fn,
)
from pulsar_tlaplus_tpu_torch.ops.packing import (
    _FieldCodec,
    bitlen,
    smap as tree_map,
    tree_leaves,
)

I32 = torch.int32
BOOL = torch.bool


# --------------------------------------------------------------------------
# tensor helpers (the jax.numpy subset the codegen uses)
# --------------------------------------------------------------------------


class Build:
    """One device's codegen context: the device every tensor is made
    on, and the cache of host constants uploaded to it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.consts: Dict[tuple, torch.Tensor] = {}


_BUILD: contextvars.ContextVar = contextvars.ContextVar("codegen_build")


@contextlib.contextmanager
def build_scope(build: Build):
    """Make ``build`` the active device context of the codegen."""
    token = _BUILD.set(build)
    try:
        yield build
    finally:
        _BUILD.reset(token)


def _build() -> Build:
    b = _BUILD.get(None)
    return b if b is not None else Build("cpu")


def const(x, dtype=None) -> torch.Tensor:
    """A host value (Python or numpy scalar or array) as a tensor on the
    active build's device, uploaded once and cached (int -> int32)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    a = np.asarray(x)
    if dtype is None:
        dtype = BOOL if a.dtype == np.bool_ else I32
    a = a.astype(np.bool_ if dtype == BOOL else np.int32)
    b = _build()
    key = (str(dtype), a.shape, a.tobytes())
    t = b.consts.get(key)
    if t is None:
        t = torch.as_tensor(a).to(b.device)
        b.consts[key] = t
    return t


asarray = const  # the name of the jnp call it replaces


def i32(v) -> torch.Tensor:
    return const(v, I32)


def b_(v) -> torch.Tensor:
    return const(bool(v), BOOL)


def zeros(shape, dtype) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=_build().device)


def ones(shape, dtype) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=_build().device)


def arange(*args) -> torch.Tensor:
    """int32 ``arange`` (the JAX default integer type)."""
    return torch.arange(*args, dtype=I32, device=_build().device)


def stack(xs, axis: int = 0) -> torch.Tensor:
    return torch.stack([asarray(x) for x in xs], dim=axis)


def where(c, x, y) -> torch.Tensor:
    return torch.where(asarray(c), x, y)


def all_(x, axis=None) -> torch.Tensor:
    x = asarray(x)
    return x.all() if axis is None else x.all(dim=axis)


def any_(x, axis=None) -> torch.Tensor:
    x = asarray(x)
    return x.any() if axis is None else x.any(dim=axis)


def isum(x, axis) -> torch.Tensor:
    """int32 sum (``jnp.sum`` of int32 / bool; torch widens to int64)."""
    return x.to(I32).sum(dim=axis).to(I32)


def shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


class CodegenError(ValueError):
    """Spec construct outside the compilable subset (callers fall back
    to the generic interpreter path, engine/interp_check.py)."""


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DInt:
    lo: int = 0
    hi: int = 0  # inclusive; lo <= hi


@dataclass(frozen=True)
class DBool:
    pass


@dataclass(frozen=True)
class DEnum:
    """Enumerated atoms (strings / model values); code = index into
    ``members`` (sorted by the interpreter's cross-type _sort_key)."""

    members: Tuple[object, ...] = ()


@dataclass(frozen=True)
class DSeq:
    """Sequence of ``elem`` with current length <= ``cap`` (static)."""

    elem: Optional["Desc"] = None
    cap: int = 0


@dataclass(frozen=True)
class DRec:
    fields: Tuple[Tuple[str, "Desc"], ...] = ()

    def field(self, name: str) -> "Desc":
        for f, d in self.fields:
            if f == name:
                return d
        raise CodegenError(f"record has no field {name}")


@dataclass(frozen=True)
class DFun:
    """Function over a static key universe; ``partial`` adds a per-key
    presence mask (dynamic DOMAIN ⊆ keys)."""

    keys: Tuple[object, ...] = ()  # sorted by _sort_key
    val: Optional["Desc"] = None
    partial: bool = False


@dataclass(frozen=True)
class DSet:
    """Finite set as a presence bitmask over a static sorted universe."""

    universe: Tuple[object, ...] = ()


@dataclass(frozen=True)
class DOpt:
    """``Nil ∪ T`` (or any single-atom ∪ T union)."""

    inner: Optional["Desc"] = None
    nil: object = None  # the atom representing "absent" (usually MV Nil)


Desc = object

ZSEQ = DSeq(None, 0)  # the empty sequence <<>> before an elem desc is known


def desc_of_value(v) -> Desc:
    """Exact descriptor of one interpreter canon value."""
    if isinstance(v, bool):
        return DBool()
    if isinstance(v, int):
        return DInt(v, v)
    if isinstance(v, (str, MV)):
        return DEnum((v,))
    if isinstance(v, tuple):
        if not v:
            return ZSEQ
        e = desc_of_value(v[0])
        for x in v[1:]:
            e = join(e, desc_of_value(x))
        return DSeq(e, len(v))
    if isinstance(v, FDict):
        ks = [k for k, _ in v.items]
        if all(isinstance(k, str) for k in ks):
            return DRec(tuple((k, desc_of_value(x)) for k, x in v.items))
        vd = None
        for _, x in v.items:
            xd = desc_of_value(x)
            vd = xd if vd is None else join(vd, xd)
        return DFun(tuple(ks), vd, partial=False)
    if isinstance(v, frozenset):
        return DSet(tuple(sorted(v, key=_sort_key)))
    raise CodegenError(f"value outside the compilable canon: {v!r}")


def _merge_universe(a: Tuple, b: Tuple) -> Tuple:
    seen = set(a)
    merged = list(a) + [x for x in b if x not in seen]
    return tuple(sorted(merged, key=_sort_key))


def _is_nil_enum(d: Desc) -> Optional[object]:
    if isinstance(d, DEnum) and len(d.members) == 1:
        return d.members[0]
    return None


def join(a: Desc, b: Desc) -> Desc:
    """Least-upper-bound of two descriptors (fixpoint lattice)."""
    if a is None:
        return b
    if b is None:
        return a
    if type(a) is type(b):
        if isinstance(a, DInt):
            return DInt(min(a.lo, b.lo), max(a.hi, b.hi))
        if isinstance(a, DBool):
            return a
        if isinstance(a, DEnum):
            return DEnum(_merge_universe(a.members, b.members))
        if isinstance(a, DSeq):
            return DSeq(join(a.elem, b.elem), max(a.cap, b.cap))
        if isinstance(a, DRec):
            if tuple(f for f, _ in a.fields) != tuple(f for f, _ in b.fields):
                raise CodegenError(
                    f"record field mismatch: {a.fields} vs {b.fields}"
                )
            return DRec(
                tuple(
                    (f, join(d1, d2))
                    for (f, d1), (_, d2) in zip(a.fields, b.fields)
                )
            )
        if isinstance(a, DFun):
            keys = _merge_universe(a.keys, b.keys)
            partial = a.partial or b.partial or keys != a.keys or keys != b.keys
            return DFun(keys, join(a.val, b.val), partial)
        if isinstance(a, DSet):
            return DSet(_merge_universe(a.universe, b.universe))
        if isinstance(a, DOpt):
            if a.nil != b.nil:
                raise CodegenError(f"option nil mismatch: {a.nil} vs {b.nil}")
            return DOpt(join(a.inner, b.inner), a.nil)
    # mixed kinds: a single-atom enum (Nil-like) unions with any
    # non-enum/bool kind as an option type (ints included — e.g. the
    # reference's ``IF maxledgerId = 1 THEN Nil ELSE maxledgerId - 1``)
    na, nb = _is_nil_enum(a), _is_nil_enum(b)
    if na is not None and not isinstance(b, (DEnum, DBool)):
        if isinstance(b, DOpt):
            if b.nil != na:
                raise CodegenError(f"option nil mismatch: {b.nil} vs {na}")
            return b
        return DOpt(b, na)
    if nb is not None and not isinstance(a, (DEnum, DBool)):
        return join(b, a)
    if isinstance(a, DOpt) and not isinstance(b, DOpt):
        return DOpt(join(a.inner, b), a.nil)
    if isinstance(b, DOpt) and not isinstance(a, DOpt):
        return DOpt(join(b.inner, a), b.nil)
    # seq <-> fun over an integer run (interpreter canon: 1..n funcs ARE
    # tuples) — unify as a partial function over 1..max
    if isinstance(a, DSeq) and isinstance(b, DFun):
        return join(_seq_as_fun(a), b)
    if isinstance(a, DFun) and isinstance(b, DSeq):
        return join(a, _seq_as_fun(b))
    raise CodegenError(f"cannot join {a} with {b}")


def _seq_as_fun(s: DSeq) -> DFun:
    return DFun(tuple(range(1, s.cap + 1)), s.elem, partial=True)


def desc_eq(a: Desc, b: Desc) -> bool:
    return a == b




# --------------------------------------------------------------------------
# runtime values
# --------------------------------------------------------------------------


class JV:
    """Runtime value: descriptor + tree of tensors (None = abstract).

    Data layout by descriptor kind (leading batch axes allowed — seq
    elements carry a leading ``cap`` axis, fun values a ``len(keys)``
    axis):

    - DInt  -> i32 (absolute value, offset applied only at pack)
    - DBool -> bool
    - DEnum -> i32 (code = index into members)
    - DSeq  -> (length i32, elem_data with leading cap axis)
    - DRec  -> {field: data}
    - DFun  -> (present bool[keys] | (), val_data with leading keys axis)
    - DSet  -> bool[universe] mask
    - DOpt  -> (present bool, inner_data)
    """

    __slots__ = ("desc", "data")

    def __init__(self, desc: Desc, data=None):
        self.desc = desc
        self.data = data

    def __repr__(self):
        return f"JV({self.desc}, {'∙' if self.data is not None else '—'})"


def zero_data(d: Desc, batch: Tuple[int, ...] = ()):
    """All-zero data tree for descriptor ``d`` with leading batch dims."""
    batch = tuple(batch)
    if isinstance(d, DInt) or isinstance(d, DEnum):
        return zeros(batch, I32)
    if isinstance(d, DBool):
        return zeros(batch, BOOL)
    if isinstance(d, DSeq):
        return (
            zeros(batch, I32),
            zero_data(d.elem, batch + (d.cap,)) if d.cap else _empty(d, batch),
        )
    if isinstance(d, DRec):
        return {f: zero_data(fd, batch) for f, fd in d.fields}
    if isinstance(d, DFun):
        pres = zeros(batch + (len(d.keys),), BOOL) if d.partial else ()
        return (pres, zero_data(d.val, batch + (len(d.keys),)))
    if isinstance(d, DSet):
        return zeros(batch + (len(d.universe),), BOOL)
    if isinstance(d, DOpt):
        return (zeros(batch, BOOL), zero_data(d.inner, batch))
    raise CodegenError(f"zero_data: bad desc {d}")


def _empty(d: DSeq, batch):
    # cap-0 sequence: elem desc may be None; keep a zero-size leaf so the
    # tree structure stays stable
    return zeros(tuple(batch) + (0,), I32)


def _expand(mask, arr):
    """Broadcast a batch-shaped mask against a leaf with extra trailing
    dims."""
    extra = arr.ndim - mask.ndim
    if extra > 0:
        mask = mask.reshape(tuple(mask.shape) + (1,) * extra)
    return mask


def data_where(d: Desc, cond, a, b):
    """Elementwise select between two data trees of descriptor ``d``."""
    cond = asarray(cond)
    return tree_map(lambda x, y: torch.where(_expand(cond, x), x, y), a, b)


# --------------------------------------------------------------------------
# structural equality (TLA+ semantics, canonical-form aware)
# --------------------------------------------------------------------------


def data_eq(d: Desc, a, b):
    """Equality of two data trees under the SAME descriptor.

    Batched: returns a bool tensor of the common batch shape.  Dead
    slots (seq beyond length, absent fun keys / opt values) are
    ignored."""
    if isinstance(d, (DInt, DEnum, DBool)):
        return a == b
    if isinstance(d, DSeq):
        la, ea = a
        lb, eb = b
        if d.cap == 0:
            return la == lb
        pos_ok = data_eq(d.elem, ea, eb)  # [..., cap]
        idx = arange(d.cap)
        # live[..., j] == (j < la); dead positions compare equal
        live = idx < (la[..., None] if _bdims(la) else la)
        return (la == lb) & all_(pos_ok | ~live, axis=-1)
    if isinstance(d, DRec):
        out = None
        for f, fd in d.fields:
            e = data_eq(fd, a[f], b[f])
            out = e if out is None else out & e
        return out if out is not None else b_(True)
    if isinstance(d, DFun):
        pa, va = a
        pb, vb = b
        ve = data_eq(d.val, va, vb)  # [..., k]
        if d.partial:
            both = pa & pb
            return all_((pa == pb) & (ve | ~both), axis=-1)
        return all_(ve, axis=-1)
    if isinstance(d, DSet):
        return all_(a == b, axis=-1)
    if isinstance(d, DOpt):
        pa, ia = a
        pb, ib = b
        inner = data_eq(d.inner, ia, ib)
        return (pa == pb) & (inner | ~(pa & pb))
    raise CodegenError(f"data_eq: bad desc {d}")


# --------------------------------------------------------------------------
# coercion between compatible descriptors
# --------------------------------------------------------------------------


def _code_map(src: Tuple, dst: Tuple) -> np.ndarray:
    pos = {k: i for i, k in enumerate(dst)}
    try:
        return np.asarray([pos[k] for k in src], np.int32)
    except KeyError as e:
        raise CodegenError(f"universe {src} not contained in {dst}") from e


def coerce(jv: JV, d: Desc) -> JV:
    """Re-represent ``jv`` under the (wider) descriptor ``d``."""
    s = jv.desc
    if desc_eq(s, d):
        return JV(d, jv.data)
    a = jv.data
    if isinstance(d, DInt) and isinstance(s, DInt):
        if s.lo < d.lo or s.hi > d.hi:
            raise CodegenError(f"cannot narrow int {s} -> {d}")
        return JV(d, a)
    if isinstance(d, DBool) and isinstance(s, DBool):
        return JV(d, a)
    if isinstance(d, DEnum) and isinstance(s, DEnum):
        m = _code_map(s.members, d.members)
        return JV(d, const(m)[a])
    if isinstance(d, DSeq) and isinstance(s, DSeq):
        ln, ed = a
        if s.cap == 0:
            return JV(d, (ln, zero_data(d.elem, _bshape(ln) + (d.cap,))))
        ejv = coerce(JV(s.elem, ed), d.elem)
        ed = ejv.data
        if d.cap > s.cap:
            ed = tree_map(lambda x: _pad_axis(x, _bdims(ln), d.cap), ed)
        elif d.cap < s.cap:
            raise CodegenError(f"cannot narrow seq cap {s.cap} -> {d.cap}")
        return JV(d, (ln, ed))
    if isinstance(d, DRec) and isinstance(s, DRec):
        return JV(
            d,
            {
                f: coerce(JV(s.field(f), a[f]), fd).data
                for f, fd in d.fields
            },
        )
    if isinstance(d, DFun):
        if isinstance(s, DSeq):
            return coerce(_seq_to_fun_jv(JV(s, a)), d)
        if isinstance(s, DFun):
            if s.partial and not d.partial:
                raise CodegenError(
                    f"cannot coerce partial fun {s} to total {d}"
                )
            pres, vd = a
            vjv = coerce(JV(s.val, vd), d.val)
            vd = vjv.data
            if d.keys != s.keys:
                m = _code_map(s.keys, d.keys)
                k = len(d.keys)
                bd = _fun_bdims(s, a)
                src_pres = (
                    pres
                    if s.partial
                    else ones(bd + (len(s.keys),), BOOL)
                )
                new_pres = zeros(bd + (k,), BOOL)
                new_vd = zero_data(d.val, bd + (k,))
                idx = const(m)
                new_pres = _scatter_axis(new_pres, idx, src_pres, len(bd))
                new_vd = tree_map(
                    lambda dst, srcl: _scatter_axis(dst, idx, srcl, len(bd)),
                    new_vd,
                    vd,
                )
                pres2 = new_pres if d.partial else ()
                return JV(d, (pres2, new_vd))
            pres2 = (
                pres
                if (s.partial and d.partial)
                else (
                    ones(_fun_bdims(s, a) + (len(d.keys),), BOOL)
                    if d.partial
                    else ()
                )
            )
            return JV(d, (pres2, vd))
    if isinstance(d, DSet) and isinstance(s, DSet):
        m = _code_map(s.universe, d.universe)
        bd = tuple(a.shape[:-1])
        out = zeros(bd + (len(d.universe),), BOOL)
        return JV(d, _scatter_axis(out, const(m), a, len(bd)))
    if isinstance(d, DOpt):
        if isinstance(s, DOpt):
            if s.nil != d.nil:
                raise CodegenError(
                    f"option nil mismatch: {s.nil} vs {d.nil}"
                )
            inner = coerce(JV(s.inner, a[1]), d.inner)
            return JV(d, (a[0], inner.data))
        nil = _is_nil_enum(s)
        if nil is not None and nil == d.nil:
            bshape = _bshape(a)
            return JV(d, (zeros(bshape, BOOL), zero_data(d.inner, bshape)))
        inner = coerce(JV(s, a), d.inner)
        bshape = _bshape_of(d.inner, inner.data)
        return JV(d, (ones(bshape, BOOL), inner.data))
    raise CodegenError(f"cannot coerce {s} -> {d}")


def _seq_to_fun_jv(jv: JV) -> JV:
    s = jv.desc
    ln, ed = jv.data
    keys = tuple(range(1, s.cap + 1))
    idx = arange(s.cap)
    pres = idx < (ln[..., None] if _bdims(ln) else ln)
    return JV(DFun(keys, s.elem, partial=True), (pres, ed))


def _bdims(arr) -> int:
    return arr.ndim if hasattr(arr, "ndim") else 0


def _bshape(arr) -> Tuple[int, ...]:
    return tuple(arr.shape) if hasattr(arr, "shape") else ()


def _bshape_of(d: Desc, data) -> Tuple[int, ...]:
    """Batch shape of a data tree (leading dims of its scalar leaves)."""
    if isinstance(d, (DInt, DEnum, DBool)):
        return _bshape(data)
    if isinstance(d, DSeq):
        return _bshape(data[0])
    if isinstance(d, DRec):
        if not d.fields:
            return ()
        return _bshape_of(d.fields[0][1], data[d.fields[0][0]])
    if isinstance(d, DFun):
        sh = _bshape_of(d.val, data[1])
        return sh[:-1]
    if isinstance(d, DSet):
        return _bshape(data)[:-1]
    if isinstance(d, DOpt):
        return _bshape(data[0])
    raise CodegenError(f"bshape: bad desc {d}")


def _fun_bdims(s: DFun, data) -> Tuple[int, ...]:
    return _bshape_of(s, data)


def _pad_axis(x, axis: int, new_cap: int):
    """Zero-pad ``x`` along ``axis`` to ``new_cap`` entries."""
    pad = new_cap - x.shape[axis]
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, zeros(shape, x.dtype)], dim=axis)


def _scatter_axis(dst, idx, src, axis: int):
    """dst[..., idx[j], ...] = src[..., j, ...] along ``axis``."""
    return torch.movedim(
        torch.index_put(
            torch.movedim(dst, axis, 0),
            (idx.to(torch.int64),),
            torch.movedim(asarray(src), axis, 0),
        ),
        0,
        axis,
    )


# --------------------------------------------------------------------------
# canonical zeroing (injective packing)
# --------------------------------------------------------------------------


def _zero_where_not(keep, x):
    return torch.where(_expand(keep, x), x, torch.zeros_like(x))


def canonicalize(d: Desc, data):
    """Zero dead slots: seq elements >= length, absent fun keys, absent
    opt inners — the codegen analog of the hand-written layouts'
    canonical-form obligations (ops/packing.py module docstring)."""
    if isinstance(d, (DInt, DEnum, DBool, DSet)):
        return data
    if isinstance(d, DSeq):
        ln, ed = data
        if d.cap == 0:
            return (ln, ed)
        ed = canonicalize(d.elem, ed)
        idx = arange(d.cap)
        live = idx < (ln[..., None] if _bdims(ln) else ln)
        ed = tree_map(lambda x: _zero_where_not(live, x), ed)
        return (ln, ed)
    if isinstance(d, DRec):
        return {f: canonicalize(fd, data[f]) for f, fd in d.fields}
    if isinstance(d, DFun):
        pres, vd = data
        vd = canonicalize(d.val, vd)
        if d.partial:
            vd = tree_map(lambda x: _zero_where_not(pres, x), vd)
        return (pres, vd)
    if isinstance(d, DOpt):
        pres, inner = data
        inner = canonicalize(d.inner, inner)
        inner = tree_map(lambda x: _zero_where_not(pres, x), inner)
        return (pres, inner)
    raise CodegenError(f"canonicalize: bad desc {d}")


# --------------------------------------------------------------------------
# codec: descriptor tree -> bit-packed words
# --------------------------------------------------------------------------


def _leaf_fields(d: Desc, path: str, n: int, out: List):
    """Flatten a descriptor into (path, count, width, kind, desc) leaf
    fields; ``n`` is the product of enclosing static axes."""
    if isinstance(d, DInt):
        out.append((path, n, bitlen(max(d.hi - d.lo, 0)), "int", d))
    elif isinstance(d, DBool):
        out.append((path, n, 1, "bool", d))
    elif isinstance(d, DEnum):
        out.append((path, n, bitlen(max(len(d.members) - 1, 0)), "enum", d))
    elif isinstance(d, DSeq):
        out.append((path + ".len", n, bitlen(d.cap), "int", DInt(0, d.cap)))
        if d.cap:
            _leaf_fields(d.elem, path + ".e", n * d.cap, out)
        else:
            out.append((path + ".e", 0, 0, "pad", None))
    elif isinstance(d, DRec):
        for f, fd in d.fields:
            _leaf_fields(fd, path + "." + f, n, out)
    elif isinstance(d, DFun):
        if d.partial:
            out.append((path + ".pres", n * len(d.keys), 1, "bool", DBool()))
        _leaf_fields(d.val, path + ".v", n * len(d.keys), out)
    elif isinstance(d, DSet):
        out.append((path, n * len(d.universe), 1, "bool", DBool()))
    elif isinstance(d, DOpt):
        out.append((path + ".pres", n, 1, "bool", DBool()))
        _leaf_fields(d.inner, path + ".inner", n, out)
    else:
        raise CodegenError(f"leaf_fields: bad desc {d}")


def _collect_leaves(d: Desc, data, out: List):
    """Flatten data in the same order as _leaf_fields, normalizing to the
    packed representation (int offset applied; bools stay bool, the
    codec reads them as 0/1)."""
    if isinstance(d, DInt):
        out.append(data.to(I32) - d.lo)
    elif isinstance(d, (DBool, DSet)):
        out.append(data)
    elif isinstance(d, DEnum):
        out.append(data.to(I32))
    elif isinstance(d, DSeq):
        ln, ed = data
        out.append(ln.to(I32))
        if d.cap:
            _collect_leaves(d.elem, ed, out)
        else:
            out.append(None)  # the zero-width pad field: the codec skips it
    elif isinstance(d, DRec):
        for f, fd in d.fields:
            _collect_leaves(fd, data[f], out)
    elif isinstance(d, DFun):
        pres, vd = data
        if d.partial:
            out.append(pres)
        _collect_leaves(d.val, vd, out)
    elif isinstance(d, DOpt):
        pres, inner = data
        out.append(pres)
        _collect_leaves(d.inner, inner, out)
    else:
        raise CodegenError(f"collect: bad desc {d}")


def _rebuild(d: Desc, leaves: List, shape: Tuple[int, ...]):
    """Inverse of _collect_leaves: pop flat int32 ``[n_rows, count]``
    tensors, reshape to the batch shape + the descriptor's axes, undo
    the int offset."""
    if isinstance(d, DInt):
        return leaves.pop(0).reshape(shape) + d.lo
    if isinstance(d, DBool):
        return leaves.pop(0).reshape(shape) != 0
    if isinstance(d, DEnum):
        return leaves.pop(0).reshape(shape)
    if isinstance(d, DSeq):
        ln = leaves.pop(0).reshape(shape)
        if d.cap:
            ed = _rebuild(d.elem, leaves, shape + (d.cap,))
        else:
            pad = leaves.pop(0)
            ed = torch.zeros(shape + (0,), dtype=I32, device=pad.device)
        return (ln, ed)
    if isinstance(d, DRec):
        return {f: _rebuild(fd, leaves, shape) for f, fd in d.fields}
    if isinstance(d, DFun):
        k = len(d.keys)
        pres = (
            leaves.pop(0).reshape(shape + (k,)) != 0 if d.partial else ()
        )
        vd = _rebuild(d.val, leaves, shape + (k,))
        return (pres, vd)
    if isinstance(d, DSet):
        return leaves.pop(0).reshape(shape + (len(d.universe),)) != 0
    if isinstance(d, DOpt):
        pres = leaves.pop(0).reshape(shape) != 0
        inner = _rebuild(d.inner, leaves, shape)
        return (pres, inner)
    raise CodegenError(f"rebuild: bad desc {d}")


class DescCodec:
    """Bit-packed codec for a whole state = ordered {var: Desc}: the JAX
    ``DescCodec``'s field list, bit for bit, over any leading batch
    shape.

    The engine-facing state tree is ``{var: data_tree}`` (plain dicts
    and tuples of tensors), every leaf with the batch shape ``[*B]``
    leading."""

    def __init__(self, var_descs: "Dict[str, Desc]"):
        self.var_descs = dict(var_descs)
        fields = []
        for v, d in self.var_descs.items():
            _leaf_fields(d, v, 1, fields)
        self._codec = _FieldCodec(
            [(p, n, w) for p, n, w, _k, _d in fields]
        )
        self._n_leaves = {}
        for v, d in self.var_descs.items():
            per_var: List = []
            _leaf_fields(d, v, 1, per_var)
            self._n_leaves[v] = len(per_var)
        self.total_bits = self._codec.total_bits
        self.W = self._codec.W
        self._builds: Dict[str, Build] = {}

    def _build_on(self, device) -> Build:
        key = str(device)
        if key not in self._builds:
            self._builds[key] = Build(device)
        return self._builds[key]

    def pack(self, state: Dict) -> torch.Tensor:
        """States ``[*B]`` -> int32 words ``[*B, W]``."""
        first = state[next(iter(self.var_descs))]
        ref = tree_leaves(first)[0]
        d0 = self.var_descs[next(iter(self.var_descs))]
        batch = _bshape_of(d0, first)
        n = int(np.prod(batch, dtype=np.int64))
        vals: List = []
        with build_scope(self._build_on(ref.device)):
            for v, d in self.var_descs.items():
                leaves: List = []
                _collect_leaves(d, canonicalize(d, state[v]), leaves)
                vals.extend(leaves)
        words = self._codec.pack(vals, n, ref.device)
        return words.reshape(*batch, self.W)

    def unpack(self, words: torch.Tensor) -> Dict:
        """int32 words ``[*B, W]`` -> states ``[*B]``."""
        batch = tuple(words.shape[:-1])
        flat = self._codec.unpack(words.reshape(-1, self.W))
        arrays = [flat[f[0]] for f in self._codec.fields]
        out = {}
        pos = 0
        for v, d in self.var_descs.items():
            k = self._n_leaves[v]
            out[v] = _rebuild(d, list(arrays[pos: pos + k]), batch)
            pos += k
        return out


# --------------------------------------------------------------------------
# host-side encode/decode (interpreter canon <-> numpy data trees)
# --------------------------------------------------------------------------


def encode_value(d: Desc, v) -> object:
    """Interpreter canon value -> numpy data tree under descriptor d."""
    if isinstance(d, DInt):
        if not (isinstance(v, int) and not isinstance(v, bool)):
            raise CodegenError(f"expected int for {d}, got {v!r}")
        return np.int32(v)
    if isinstance(d, DBool):
        if not isinstance(v, bool):
            raise CodegenError(f"expected bool, got {v!r}")
        return np.bool_(v)
    if isinstance(d, DEnum):
        if v not in d.members:
            raise CodegenError(f"{v!r} not in enum {d.members}")
        return np.int32(d.members.index(v))
    if isinstance(d, DSeq):
        if isinstance(v, FDict):
            raise CodegenError(f"expected sequence, got {v!r}")
        if not isinstance(v, tuple):
            raise CodegenError(f"expected sequence, got {v!r}")
        if len(v) > d.cap:
            raise CodegenError(f"sequence longer than cap {d.cap}: {v!r}")
        ed = [encode_value(d.elem, x) for x in v]
        zero = encode_value_zero(d.elem)
        ed += [zero] * (d.cap - len(v))
        stacked = (
            _stack_host(ed) if d.cap else np.zeros((0,), np.int32)
        )
        return (np.int32(len(v)), stacked)
    if isinstance(d, DRec):
        if not isinstance(v, FDict):
            raise CodegenError(f"expected record, got {v!r}")
        return {f: encode_value(fd, v[f]) for f, fd in d.fields}
    if isinstance(d, DFun):
        if isinstance(v, tuple):
            m = {i + 1: x for i, x in enumerate(v)}
        elif isinstance(v, FDict):
            m = dict(v.items)
        else:
            raise CodegenError(f"expected function, got {v!r}")
        extra = set(m) - set(d.keys)
        if extra:
            raise CodegenError(
                f"function keys outside descriptor universe: {extra}"
            )
        pres = np.asarray([k in m for k in d.keys], np.bool_)
        if not d.partial and not pres.all():
            raise CodegenError(f"total fun missing keys: {v!r}")
        vals = [
            encode_value(d.val, m[k]) if k in m else encode_value_zero(d.val)
            for k in d.keys
        ]
        return (pres if d.partial else (), _stack_host(vals))
    if isinstance(d, DSet):
        if not isinstance(v, frozenset):
            raise CodegenError(f"expected set, got {v!r}")
        extra = v - set(d.universe)
        if extra:
            raise CodegenError(f"set members outside universe: {extra}")
        return np.asarray([u in v for u in d.universe], np.bool_)
    if isinstance(d, DOpt):
        if v == d.nil and isinstance(v, type(d.nil)):
            return (np.bool_(False), encode_value_zero(d.inner))
        return (np.bool_(True), encode_value(d.inner, v))
    raise CodegenError(f"encode: bad desc {d}")


def encode_value_zero(d: Desc):
    """Canonical zero data for one (unbatched) value of descriptor d.

    Note: DInt zeros are ``d.lo`` so they pack to 0 through DescCodec
    (which always canonicalizes before packing).  ``canonicalize``
    itself zeroes dead slots to raw 0, which packs to ``-lo mod 2^w``;
    the two agree whenever ``lo == 0`` and otherwise only the
    canonicalized form ever reaches ``pack`` — do not compare
    host-encoded and device-canonicalized data trees directly."""
    if isinstance(d, DInt):
        return np.int32(d.lo)  # packs to 0
    if isinstance(d, DBool):
        return np.bool_(False)
    if isinstance(d, DEnum):
        return np.int32(0)
    if isinstance(d, DSeq):
        z = encode_value_zero(d.elem) if d.cap else None
        stacked = (
            _stack_host([z] * d.cap) if d.cap else np.zeros((0,), np.int32)
        )
        return (np.int32(0), stacked)
    if isinstance(d, DRec):
        return {f: encode_value_zero(fd) for f, fd in d.fields}
    if isinstance(d, DFun):
        vals = _stack_host([encode_value_zero(d.val)] * len(d.keys))
        pres = (
            np.zeros((len(d.keys),), np.bool_) if d.partial else ()
        )
        return (pres, vals)
    if isinstance(d, DSet):
        return np.zeros((len(d.universe),), np.bool_)
    if isinstance(d, DOpt):
        return (np.bool_(False), encode_value_zero(d.inner))
    raise CodegenError(f"zero: bad desc {d}")


def _stack_host(datas: List):
    if not datas:
        return np.zeros((0,), np.int32)
    return tree_map(lambda *xs: np.stack(xs), *datas)


def decode_value(d: Desc, data) -> object:
    """Numpy data tree -> interpreter canon value (host side)."""
    g = np.asarray
    if isinstance(d, DInt):
        return int(g(data))
    if isinstance(d, DBool):
        return bool(g(data))
    if isinstance(d, DEnum):
        return d.members[int(g(data))]
    if isinstance(d, DSeq):
        ln, ed = data
        n = int(g(ln))
        return tuple(
            decode_value(d.elem, _index_host(ed, i)) for i in range(n)
        )
    if isinstance(d, DRec):
        return FDict({f: decode_value(fd, data[f]) for f, fd in d.fields})
    if isinstance(d, DFun):
        pres, vd = data
        m = {}
        for i, k in enumerate(d.keys):
            if d.partial and not bool(g(pres)[i]):
                continue
            m[k] = decode_value(d.val, _index_host(vd, i))
        return make_fn(m)
    if isinstance(d, DSet):
        mask = g(data)
        return frozenset(u for i, u in enumerate(d.universe) if mask[i])
    if isinstance(d, DOpt):
        pres, inner = data
        if not bool(g(pres)):
            return d.nil
        return decode_value(d.inner, inner)
    raise CodegenError(f"decode: bad desc {d}")


def _index_host(data, i: int):
    return tree_map(lambda x: x[i], data)
