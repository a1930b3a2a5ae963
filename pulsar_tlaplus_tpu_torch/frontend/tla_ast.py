"""AST for the TLA+ subset (SURVEY.md §1-L2 closed operator set).

Nodes are plain frozen dataclasses; ``loc`` is (line, col) of the head
token for error messages. The parser builds these; the interpreter
(:mod:`.interp`) and codegen (:mod:`.codegen`) consume them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

Loc = Tuple[int, int]


@dataclass(frozen=True)
class Node:
    loc: Loc = field(default=(0, 0), compare=False)


# --- atoms -----------------------------------------------------------------


@dataclass(frozen=True)
class Num(Node):
    value: int = 0


@dataclass(frozen=True)
class Str(Node):
    value: str = ""


@dataclass(frozen=True)
class Bool(Node):
    value: bool = False


@dataclass(frozen=True)
class Name(Node):
    """Identifier reference (constant, variable, bound var, or operator)."""

    name: str = ""


@dataclass(frozen=True)
class Prime(Node):
    """x' — next-state value of a variable."""

    expr: Node = None


# --- operators -------------------------------------------------------------


@dataclass(frozen=True)
class BinOp(Node):
    """op in: = # < > <= >= + - * \\div % .. \\in \\notin \\cup \\cap
    \\subseteq \\ (setminus) /\\ \\/ => <=>"""

    op: str = ""
    lhs: Node = None
    rhs: Node = None


@dataclass(frozen=True)
class UnOp(Node):
    """op in: ~ (lnot), - (negate), [] (always), <> (eventually),
    DOMAIN, SUBSET, UNION, UNCHANGED, ENABLED"""

    op: str = ""
    expr: Node = None


@dataclass(frozen=True)
class Junction(Node):
    """Aligned /\\ or \\/ bullet list (n-ary)."""

    op: str = ""  # "/\\" or "\\/"
    items: Tuple[Node, ...] = ()


# --- structured expressions ------------------------------------------------


@dataclass(frozen=True)
class Apply(Node):
    """Operator application Op(e1, ..., en)."""

    op: str = ""
    args: Tuple[Node, ...] = ()


@dataclass(frozen=True)
class Index(Node):
    """Function/sequence application f[e] (possibly multi-arg f[a, b])."""

    fn: Node = None
    args: Tuple[Node, ...] = ()


@dataclass(frozen=True)
class Field(Node):
    """Record field access r.f"""

    expr: Node = None
    name: str = ""


@dataclass(frozen=True)
class TupleExpr(Node):
    """<<e1, ..., en>> — tuple/sequence literal."""

    items: Tuple[Node, ...] = ()


@dataclass(frozen=True)
class SetEnum(Node):
    """{e1, ..., en}"""

    items: Tuple[Node, ...] = ()


@dataclass(frozen=True)
class SetFilter(Node):
    """{x \\in S : p}"""

    var: str = ""
    domain: Node = None
    pred: Node = None


@dataclass(frozen=True)
class SetMap(Node):
    """{e : x \\in S}  (single bound var in our subset)"""

    expr: Node = None
    var: str = ""
    domain: Node = None


@dataclass(frozen=True)
class FnConstruct(Node):
    """[x \\in S |-> e]"""

    var: str = ""
    domain: Node = None
    body: Node = None


@dataclass(frozen=True)
class FnExcept(Node):
    """[f EXCEPT ![a] = e, ![b] = e2] — updates as ((index_expr,), value).
    `@` inside the value refers to the old entry (parsed as Name('@'))."""

    fn: Node = None
    updates: Tuple[Tuple[Node, Node], ...] = ()


@dataclass(frozen=True)
class RecordLit(Node):
    """[f1 |-> e1, ..., fn |-> en]"""

    fields: Tuple[Tuple[str, Node], ...] = ()


@dataclass(frozen=True)
class RecordSpace(Node):
    """[f1: S1, ..., fn: Sn] — set of records."""

    fields: Tuple[Tuple[str, Node], ...] = ()


@dataclass(frozen=True)
class FnSpace(Node):
    """[S -> T] — set of functions."""

    domain: Node = None
    codomain: Node = None


@dataclass(frozen=True)
class Quant(Node):
    """\\A / \\E with one or more (var, domain) bindings."""

    kind: str = ""  # "A" or "E"
    bindings: Tuple[Tuple[str, Node], ...] = ()
    body: Node = None


@dataclass(frozen=True)
class Choose(Node):
    """CHOOSE x \\in S : p"""

    var: str = ""
    domain: Node = None
    pred: Node = None


@dataclass(frozen=True)
class If(Node):
    cond: Node = None
    then: Node = None
    orelse: Node = None


@dataclass(frozen=True)
class Let(Node):
    """LET defs IN body; defs are (name, params, expr)."""

    defs: Tuple[Tuple[str, Tuple[str, ...], Node], ...] = ()
    body: Node = None


@dataclass(frozen=True)
class Lambda(Node):
    params: Tuple[str, ...] = ()
    body: Node = None


@dataclass(frozen=True)
class BoxAction(Node):
    """[A]_v  (action or its stutter); with UnOp('[]') around it in Spec."""

    action: Node = None
    sub: Node = None


@dataclass(frozen=True)
class Fairness(Node):
    """WF_v(A) / SF_v(A)"""

    kind: str = ""  # "WF" or "SF"
    sub: Node = None
    action: Node = None


# --- module-level ----------------------------------------------------------


@dataclass(frozen=True)
class Definition(Node):
    name: str = ""
    params: Tuple[str, ...] = ()
    body: Node = None


@dataclass(frozen=True)
class Module(Node):
    name: str = ""
    extends: Tuple[str, ...] = ()
    constants: Tuple[str, ...] = ()
    variables: Tuple[str, ...] = ()
    assumes: Tuple[Node, ...] = ()
    defs: Tuple[Definition, ...] = ()

    def defs_by_name(self):
        return {d.name: d for d in self.defs}
