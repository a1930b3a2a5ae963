"""Tokenizer for the TLA+ subset used by the Pulsar specs.

Produces a token stream with (line, column) positions — columns are
load-bearing in TLA+ because conjunction/disjunction *junction lists* are
alignment-sensitive (the parser uses them to delimit bullet items).

Covers the closed operator set inventoried in SURVEY.md §1-L2 (everything
``compaction.tla`` uses: reference ``specs/compaction.tla``),
plus a few safe extras (Cardinality-style calls are plain identifiers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

# Token kinds
IDENT = "IDENT"
NUMBER = "NUMBER"
STRING = "STRING"
OP = "OP"  # punctuation / operator symbol (value holds the spelling)
EOF = "EOF"

# Multi-character symbols, longest first so maximal munch works.
_SYMBOLS = [
    "=============================================================================",
    "|->",
    "<=>",
    "==",
    "=>",
    "<=",
    ">=",
    "..",
    "<<",
    ">>",
    "[]",
    "<>",
    "->",
    "|-",
    "/\\",
    "\\/",
    "#",
    "=",
    "<",
    ">",
    "+",
    "-",
    "*",
    "%",
    "(",
    ")",
    "[",
    "]",
    "{",
    "}",
    ",",
    ":",
    ".",
    "'",
    "!",
    "@",
    "_",
    "~",
    "|",
    ";",
]

# Backslash keywords (operators spelled `\name`), plus `\` alone = set minus.
_BACKSLASH_WORDS = {
    "in",
    "notin",
    "cup",
    "cap",
    "subseteq",
    "subset",
    "div",
    "A",
    "E",
    "union",
    "intersect",
    "leq",
    "geq",
    "neg",
    "lnot",
    "land",
    "lor",
    "X",
    "o",
}

_WORD_OPS = {
    # word-shaped keywords the parser treats specially
    "MODULE",
    "EXTENDS",
    "CONSTANT",
    "CONSTANTS",
    "VARIABLE",
    "VARIABLES",
    "ASSUME",
    "ASSUMPTION",
    "THEOREM",
    "IF",
    "THEN",
    "ELSE",
    "CASE",
    "OTHER",
    "LET",
    "IN",
    "CHOOSE",
    "LAMBDA",
    "EXCEPT",
    "DOMAIN",
    "SUBSET",
    "UNION",
    "UNCHANGED",
    "ENABLED",
    "INSTANCE",
    "LOCAL",
    "WF_",
    "SF_",
    "TRUE",
    "FALSE",
    "BOOLEAN",
    "Nat",
    "Int",
}


@dataclass(frozen=True)
class Token:
    kind: str
    value: str
    line: int  # 1-based
    col: int  # 1-based

    def __repr__(self) -> str:  # compact for parser errors
        return f"{self.value!r}@{self.line}:{self.col}"


class LexError(ValueError):
    pass


def _is_ident_start(ch: str) -> bool:
    return ch.isalpha()


def _is_ident_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


def tokenize(src: str) -> List[Token]:
    """Tokenize a module source string."""
    toks: List[Token] = []
    i, n = 0, len(src)
    line, col = 1, 1

    def advance(k: int) -> None:
        nonlocal i, line, col
        for _ in range(k):
            if src[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        ch = src[i]
        # whitespace
        if ch in " \t\r\n":
            advance(1)
            continue
        # line comment
        if src.startswith("\\*", i):
            while i < n and src[i] != "\n":
                advance(1)
            continue
        # block comment (nested)
        if src.startswith("(*", i):
            start = (line, col)
            depth = 0
            while i < n:
                if src.startswith("(*", i):
                    depth += 1
                    advance(2)
                elif src.startswith("*)", i):
                    depth -= 1
                    advance(2)
                    if depth == 0:
                        break
                else:
                    advance(1)
            if depth != 0:
                raise LexError(
                    f"unterminated block comment opened at "
                    f"{start[0]}:{start[1]}"
                )
            continue
        # module header/footer dashes: runs of 4+ '-' or '=' are delimiters
        if ch == "-" and src.startswith("----", i):
            j = i
            while j < n and src[j] == "-":
                j += 1
            toks.append(Token(OP, "----", line, col))
            advance(j - i)
            continue
        if ch == "=" and src.startswith("====", i):
            j = i
            while j < n and src[j] == "=":
                j += 1
            toks.append(Token(OP, "====", line, col))
            advance(j - i)
            continue
        # string literal
        if ch == '"':
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == "\\" and j + 1 < n:
                    buf.append(src[j + 1])
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at {line}:{col}")
            toks.append(Token(STRING, "".join(buf), line, col))
            advance(j + 1 - i)
            continue
        # number
        if ch.isdigit():
            j = i
            while j < n and src[j].isdigit():
                j += 1
            toks.append(Token(NUMBER, src[i:j], line, col))
            advance(j - i)
            continue
        # backslash operators: \/ , \in \cup ... , or bare \ (set minus)
        if ch == "\\":
            if src.startswith("\\/", i):
                toks.append(Token(OP, "\\/", line, col))
                advance(2)
                continue
            j = i + 1
            while j < n and src[j].isalpha():
                j += 1
            word = src[i + 1 : j]
            if word and word in _BACKSLASH_WORDS:
                toks.append(Token(OP, "\\" + word, line, col))
                advance(j - i)
            elif word:
                raise LexError(f"unknown operator \\{word} at {line}:{col}")
            else:
                toks.append(Token(OP, "\\", line, col))
                advance(1)
            continue
        # identifier / word keyword (WF_ / SF_ fused with the subscript var)
        if _is_ident_start(ch):
            j = i
            while j < n and _is_ident_char(src[j]):
                j += 1
            word = src[i:j]
            if word.startswith(("WF_", "SF_")):
                toks.append(Token(OP, word[:3], line, col))
                rest = word[3:]
                if rest:
                    toks.append(Token(IDENT, rest, line, col + 3))
                advance(j - i)
                continue
            kind = OP if word in _WORD_OPS else IDENT
            toks.append(Token(kind, word, line, col))
            advance(j - i)
            continue
        # symbols (maximal munch)
        for sym in _SYMBOLS:
            if src.startswith(sym, i):
                toks.append(Token(OP, sym, line, col))
                advance(len(sym))
                break
        else:
            raise LexError(f"unexpected character {ch!r} at {line}:{col}")
    toks.append(Token(EOF, "<eof>", line, col))
    return toks
