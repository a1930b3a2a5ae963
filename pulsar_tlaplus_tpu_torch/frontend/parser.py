"""Column-aware Pratt parser for the TLA+ subset.

TLA+'s conjunction/disjunction *junction lists* are alignment-sensitive:

    /\\ a
    /\\ b

parses as an n-ary conjunction whose items are delimited by the bullet
column — any token at column <= the bullet's column terminates the item.
This is implemented by threading a ``min_col`` through the expression
parser: a token starting at column < ``min_col`` acts like EOF.  A ``/\\``
or ``\\/`` in *prefix* position starts a junction list; in *infix*
position it is the ordinary binary operator.

Precedence follows the TLA+ operator table (Lamport, "Specifying
Systems", table 6); only levels needed by the subset are included.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from pulsar_tlaplus_tpu_torch.frontend import tla_ast as A
from pulsar_tlaplus_tpu_torch.frontend.lexer import (
    EOF,
    IDENT,
    NUMBER,
    OP,
    STRING,
    Token,
    tokenize,
)


class ParseError(ValueError):
    pass


# (left_bp, right_bp) — higher binds tighter. right < left => right-assoc.
_INFIX = {
    "<=>": (2, 3),
    "=>": (2, 2),  # right-assoc
    "\\/": (4, 5),
    "/\\": (6, 7),
    "=": (10, 11),
    "#": (10, 11),
    "<": (10, 11),
    ">": (10, 11),
    "<=": (10, 11),
    ">=": (10, 11),
    "\\leq": (10, 11),
    "\\geq": (10, 11),
    "\\in": (10, 11),
    "\\notin": (10, 11),
    "\\subseteq": (10, 11),
    "\\cup": (16, 17),
    "\\union": (16, 17),
    "\\cap": (16, 17),
    "\\intersect": (16, 17),
    "\\": (16, 17),
    "..": (18, 19),
    "+": (20, 21),
    "-": (20, 21),
    "*": (24, 25),
    "\\div": (24, 25),
    "%": (24, 25),
    "\\o": (26, 27),
}

_QUANT_BODY_BP = 1  # quantifier/CHOOSE bodies extend as far as possible


class Parser:
    def __init__(self, toks: List[Token]):
        self.toks = toks
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != EOF:
            self.i += 1
        return t

    def at(self, value: str, kind: str = OP) -> bool:
        t = self.peek()
        return t.kind == kind and t.value == value

    def expect(self, value: str, kind: str = OP) -> Token:
        t = self.peek()
        if t.kind != kind or t.value != value:
            raise ParseError(f"expected {value!r}, got {t}")
        return self.next()

    def _eof_for(self, min_col: int) -> bool:
        t = self.peek()
        return t.kind == EOF or (t.col < min_col) or t.value in ("====", "----")

    # -- expressions ---------------------------------------------------------

    def parse_expr(self, min_col: int, bp: int = 0) -> A.Node:
        lhs = self.parse_prefix(min_col)
        while True:
            if self._eof_for(min_col):
                return lhs
            t = self.peek()
            # postfix: prime, function application, record access
            if t.kind == OP and t.value == "'":
                self.next()
                lhs = A.Prime(loc=(t.line, t.col), expr=lhs)
                continue
            if t.kind == OP and t.value == "[" and bp <= 28:
                # f[e1, ..., en]
                self.next()
                args = self._expr_list(min_col, "]")
                lhs = A.Index(loc=(t.line, t.col), fn=lhs, args=tuple(args))
                continue
            if t.kind == OP and t.value == ".":
                nxt = self.peek(1)
                if nxt.kind == IDENT:
                    self.next()
                    self.next()
                    lhs = A.Field(
                        loc=(t.line, t.col), expr=lhs, name=nxt.value
                    )
                    continue
            if t.kind == OP and t.value in _INFIX:
                lbp, rbp = _INFIX[t.value]
                if lbp < bp:
                    return lhs
                self.next()
                rhs = self.parse_expr(min_col, rbp)
                lhs = A.BinOp(
                    loc=(t.line, t.col), op=t.value, lhs=lhs, rhs=rhs
                )
                continue
            return lhs

    def _expr_list(self, min_col: int, closer: str) -> List[A.Node]:
        args: List[A.Node] = []
        if not self.at(closer):
            args.append(self.parse_expr(min_col))
            while self.at(","):
                self.next()
                args.append(self.parse_expr(min_col))
        self.expect(closer)
        return args

    def _bindings(self, min_col: int) -> List[Tuple[str, A.Node]]:
        """x \\in S, y \\in T, ...  (also `x, y \\in S` sugar)."""
        out: List[Tuple[str, A.Node]] = []
        while True:
            names = [self.expect_ident()]
            while self.at(","):
                # lookahead: another name followed by \in or ','
                save = self.i
                self.next()
                if self.peek().kind == IDENT and self.peek(1).value in (
                    "\\in",
                    ",",
                ):
                    names.append(self.expect_ident())
                else:
                    self.i = save
                    break
            self.expect("\\in")
            dom = self.parse_expr(min_col, 12)  # tighter than \in level
            for nm in names:
                out.append((nm, dom))
            if self.at(","):
                self.next()
                continue
            return out

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind != IDENT:
            raise ParseError(f"expected identifier, got {t}")
        self.next()
        return t.value

    def parse_prefix(self, min_col: int) -> A.Node:
        t = self.peek()
        if self._eof_for(min_col):
            raise ParseError(f"unexpected end of expression at {t}")
        loc = (t.line, t.col)

        if t.kind == NUMBER:
            self.next()
            return A.Num(loc=loc, value=int(t.value))
        if t.kind == STRING:
            self.next()
            return A.Str(loc=loc, value=t.value)
        if t.kind == IDENT:
            self.next()
            if self.at("("):
                self.next()
                args = self._expr_list(min_col, ")")
                return A.Apply(loc=loc, op=t.value, args=tuple(args))
            return A.Name(loc=loc, name=t.value)

        v = t.value
        if v == "TRUE" or v == "FALSE":
            self.next()
            return A.Bool(loc=loc, value=(v == "TRUE"))
        if v in ("Nat", "Int", "BOOLEAN"):
            self.next()
            return A.Name(loc=loc, name=v)
        if v == "@":
            self.next()
            return A.Name(loc=loc, name="@")
        if v in ("/\\", "\\/"):
            # junction list anchored at this column
            return self._junction(v, t.col)
        if v == "~" or v == "\\lnot" or v == "\\neg":
            self.next()
            return A.UnOp(loc=loc, op="~", expr=self.parse_expr(min_col, 9))
        if v == "-":
            self.next()
            return A.UnOp(loc=loc, op="-", expr=self.parse_expr(min_col, 23))
        if v in ("[]", "<>"):
            self.next()
            # [][A]_v or <>(e)
            if v == "[]" and self.at("["):
                inner = self._box_action(min_col, loc)
                return A.UnOp(loc=loc, op="[]", expr=inner)
            return A.UnOp(
                loc=loc, op=v, expr=self.parse_expr(min_col, 5)
            )
        if v in ("DOMAIN", "SUBSET", "UNION", "UNCHANGED", "ENABLED"):
            self.next()
            # operand = atom + postfix only (application binds tighter than
            # these prefix ops: DOMAIN f[x] == DOMAIN (f[x]) per the TLA+
            # precedence table), so parse at bp 28 — application's gate —
            # which still excludes every infix operator (max lbp 27).
            return A.UnOp(
                loc=loc, op=v, expr=self.parse_expr(min_col, 28)
            )
        if v in ("WF_", "SF_"):
            self.next()
            sub = self.parse_prefix(min_col)
            self.expect("(")
            act = self._expr_list(min_col, ")")
            if len(act) != 1:
                raise ParseError(f"{v}(...) takes one action at {loc}")
            return A.Fairness(
                loc=loc, kind=v[:2], sub=sub, action=act[0]
            )
        if v == "\\A" or v == "\\E":
            self.next()
            binds = self._bindings(min_col)
            self.expect(":")
            body = self.parse_expr(min_col, _QUANT_BODY_BP)
            return A.Quant(
                loc=loc,
                kind="A" if v == "\\A" else "E",
                bindings=tuple(binds),
                body=body,
            )
        if v == "CHOOSE":
            self.next()
            var = self.expect_ident()
            self.expect("\\in")
            dom = self.parse_expr(min_col, 12)
            self.expect(":")
            pred = self.parse_expr(min_col, _QUANT_BODY_BP)
            return A.Choose(loc=loc, var=var, domain=dom, pred=pred)
        if v == "IF":
            self.next()
            cond = self.parse_expr(min_col, _QUANT_BODY_BP + 1)
            self.expect("THEN")
            then = self.parse_expr(min_col, _QUANT_BODY_BP + 1)
            self.expect("ELSE")
            orelse = self.parse_expr(min_col, _QUANT_BODY_BP)
            return A.If(loc=loc, cond=cond, then=then, orelse=orelse)
        if v == "LET":
            self.next()
            defs = []
            while True:
                dt = self.peek()
                name = self.expect_ident()
                params: Tuple[str, ...] = ()
                if self.at("("):
                    self.next()
                    ps = [self.expect_ident()]
                    while self.at(","):
                        self.next()
                        ps.append(self.expect_ident())
                    self.expect(")")
                    params = tuple(ps)
                self.expect("==")
                # LET bodies are delimited by alignment: body tokens sit
                # right of the defined name's column
                body = self.parse_expr(dt.col + 1, 0)
                defs.append((name, params, body))
                if self.peek().kind == IDENT and self.peek(1).value in (
                    "==",
                    "(",
                ):
                    # another LET definition (Name == ... or Name(..) == ...)
                    if self.peek(1).value == "(":
                        # distinguish definition from application: scan to
                        # matching ')' and check for '=='
                        save = self.i
                        self.next()
                        depth = 0
                        isdef = False
                        while True:
                            tk = self.peek()
                            if tk.kind == EOF:
                                break
                            if tk.value == "(":
                                depth += 1
                            elif tk.value == ")":
                                depth -= 1
                                if depth == 0:
                                    isdef = self.peek(1).value == "=="
                                    break
                            self.next()
                        self.i = save
                        if not isdef:
                            break
                    continue
                break
            self.expect("IN")
            body = self.parse_expr(min_col, _QUANT_BODY_BP)
            return A.Let(loc=loc, defs=tuple(defs), body=body)
        if v == "LAMBDA":
            self.next()
            ps = [self.expect_ident()]
            while self.at(","):
                self.next()
                ps.append(self.expect_ident())
            self.expect(":")
            body = self.parse_expr(min_col, _QUANT_BODY_BP)
            return A.Lambda(loc=loc, params=tuple(ps), body=body)
        if v == "(":
            self.next()
            e = self.parse_expr(min_col, 0)
            self.expect(")")
            return e
        if v == "<<":
            self.next()
            items = self._expr_list(min_col, ">>")
            return A.TupleExpr(loc=loc, items=tuple(items))
        if v == "{":
            return self._set_expr(min_col, loc)
        if v == "[":
            return self._bracket_expr(min_col, loc)
        raise ParseError(f"unexpected token {t}")

    def _junction(self, op: str, col: int) -> A.Node:
        """Aligned bullet list of `op` at exactly column `col`."""
        items: List[A.Node] = []
        loc = None
        while True:
            t = self.peek()
            if not (t.kind == OP and t.value == op and t.col == col):
                break
            if loc is None:
                loc = (t.line, t.col)
            self.next()
            items.append(self.parse_expr(col + 1, 0))
        if len(items) == 1:
            return items[0]
        return A.Junction(loc=loc, op=op, items=tuple(items))

    def _box_action(self, min_col: int, loc) -> A.Node:
        """[A]_v following a '[]' token (caller consumed '[]')."""
        self.expect("[")
        act = self.parse_expr(min_col, 0)
        self.expect("]")
        self.expect("_")
        sub = self.parse_prefix(min_col)
        return A.BoxAction(loc=loc, action=act, sub=sub)

    def _set_expr(self, min_col: int, loc) -> A.Node:
        self.expect("{")
        if self.at("}"):
            self.next()
            return A.SetEnum(loc=loc, items=())
        # could be: {e, ...} | {x \in S : p} | {e : x \in S}
        save = self.i
        if self.peek().kind == IDENT and self.peek(1).value == "\\in":
            var = self.expect_ident()
            self.next()  # \in
            dom = self.parse_expr(min_col, 12)
            if self.at(":"):
                self.next()
                pred = self.parse_expr(min_col, 0)
                self.expect("}")
                return A.SetFilter(
                    loc=loc, var=var, domain=dom, pred=pred
                )
            self.i = save  # it was `{x \in S}` as an element? fall through
        first = self.parse_expr(min_col, 0)
        if self.at(":"):
            self.next()
            var = self.expect_ident()
            self.expect("\\in")
            dom = self.parse_expr(min_col, 0)
            self.expect("}")
            return A.SetMap(loc=loc, expr=first, var=var, domain=dom)
        items = [first]
        while self.at(","):
            self.next()
            items.append(self.parse_expr(min_col, 0))
        self.expect("}")
        return A.SetEnum(loc=loc, items=tuple(items))

    def _bracket_expr(self, min_col: int, loc) -> A.Node:
        """[x \\in S |-> e] | [f EXCEPT ...] | [f1 |-> e1,...]
        | [f1: S1, ...] | [S -> T] | [A]_v (action subscript)."""
        self.expect("[")
        # [x \in S |-> e]
        if self.peek().kind == IDENT and self.peek(1).value == "\\in":
            save = self.i
            var = self.expect_ident()
            self.next()
            dom = self.parse_expr(min_col, 12)
            if self.at("|->"):
                self.next()
                body = self.parse_expr(min_col, 0)
                self.expect("]")
                return A.FnConstruct(
                    loc=loc, var=var, domain=dom, body=body
                )
            self.i = save
        # [name |-> e, ...] or [name: S, ...]
        if self.peek().kind == IDENT and self.peek(1).value in ("|->", ":"):
            kind = self.peek(1).value
            fields = []
            while True:
                nm = self.expect_ident()
                self.expect(kind)
                e = self.parse_expr(min_col, 0)
                fields.append((nm, e))
                if self.at(","):
                    self.next()
                    continue
                break
            self.expect("]")
            if kind == "|->":
                return A.RecordLit(loc=loc, fields=tuple(fields))
            return A.RecordSpace(loc=loc, fields=tuple(fields))
        first = self.parse_expr(min_col, 0)
        if self.at("->"):
            self.next()
            cod = self.parse_expr(min_col, 0)
            self.expect("]")
            return A.FnSpace(loc=loc, domain=first, codomain=cod)
        if self.peek().value == "EXCEPT":
            self.next()
            updates = []
            while True:
                self.expect("!")
                self.expect("[")
                idx = self.parse_expr(min_col, 0)
                self.expect("]")
                self.expect("=")
                val = self.parse_expr(min_col, 0)
                updates.append((idx, val))
                if self.at(","):
                    self.next()
                    continue
                break
            self.expect("]")
            return A.FnExcept(loc=loc, fn=first, updates=tuple(updates))
        # action subscript [A]_v
        self.expect("]")
        if self.at("_"):
            self.next()
            sub = self.parse_prefix(min_col)
            return A.BoxAction(loc=loc, action=first, sub=sub)
        raise ParseError(f"cannot parse bracket expression at {loc}")


def parse_module(src: str) -> A.Module:
    toks = tokenize(src)
    p = Parser(toks)
    p.expect("----")
    p.expect("MODULE")
    name = p.expect_ident()
    p.expect("----")
    extends: List[str] = []
    constants: List[str] = []
    variables: List[str] = []
    assumes: List[A.Node] = []
    defs: List[A.Definition] = []
    while True:
        t = p.peek()
        if t.kind == EOF:
            raise ParseError(
                f"module {name} is not terminated by '====' (truncated file?)"
            )
        if t.value == "====":
            break
        if t.value == "----":  # separator line
            p.next()
            continue
        if t.value == "EXTENDS":
            p.next()
            extends.append(p.expect_ident())
            while p.at(","):
                p.next()
                extends.append(p.expect_ident())
            continue
        if t.value in ("CONSTANT", "CONSTANTS"):
            p.next()
            constants.append(p.expect_ident())
            while p.at(","):
                p.next()
                constants.append(p.expect_ident())
            continue
        if t.value in ("VARIABLE", "VARIABLES"):
            p.next()
            variables.append(p.expect_ident())
            while p.at(","):
                p.next()
                variables.append(p.expect_ident())
            continue
        if t.value in ("ASSUME", "ASSUMPTION"):
            p.next()
            assumes.append(p.parse_expr(t.col + 1, 0))
            continue
        if t.value == "THEOREM":
            p.next()
            p.parse_expr(t.col + 1, 0)  # parsed, not checked
            continue
        if t.kind == IDENT:
            loc = (t.line, t.col)
            dname = p.expect_ident()
            params: Tuple[str, ...] = ()
            if p.at("("):
                p.next()
                ps = [p.expect_ident()]
                while p.at(","):
                    p.next()
                    ps.append(p.expect_ident())
                p.expect(")")
                params = tuple(ps)
            p.expect("==")
            body = p.parse_expr(t.col + 1, 0)
            defs.append(
                A.Definition(loc=loc, name=dname, params=params, body=body)
            )
            continue
        raise ParseError(f"unexpected module-level token {t}")
    return A.Module(
        loc=(1, 1),
        name=name,
        extends=tuple(extends),
        constants=tuple(constants),
        variables=tuple(variables),
        assumes=tuple(assumes),
        defs=tuple(defs),
    )


def parse_file(path: str) -> A.Module:
    with open(path) as f:
        return parse_module(f.read())
