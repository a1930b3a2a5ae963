"""TLC model-configuration (.cfg) front end (SURVEY.md §1-L4).

Parses the TLC config grammar subset the reference exercises
(``compaction.cfg``): two ``CONSTANTS`` blocks (value bindings and
model-value self-bindings), ``SPECIFICATION``, and ``INVARIANTS``
(``compaction.cfg:2-31``), with ``\\*`` comments.

Constant canonicalization: the spec reserves 0 for NullKey/NullValue and
``ASSUME``s ``KeySpace \\in SUBSET Nat`` (compaction.tla:29-32), but the
shipped cfg binds strings (``{"key1", "key2"}`` at compaction.cfg:7) — a
strict evaluator rejects that (SURVEY.md §1-L4 discrepancy).  Like the
intent of the spec's own encoding, non-integer space elements are interned
to ``1..n`` with a warning; integer spaces are required to be exactly
``1..n`` (the packed encoding relabels any gap-free positive set).
"""

from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List

from pulsar_tlaplus_tpu_torch.ref.pyeval import Constants


@dataclass
class TLCConfig:
    constants: Dict[str, object] = field(default_factory=dict)
    model_values: List[str] = field(default_factory=list)
    specification: str = "Spec"
    invariants: List[str] = field(default_factory=list)
    properties: List[str] = field(default_factory=list)


def _strip_comments(text: str) -> str:
    # \* line comments and (* ... *) block comments (not nested in cfgs)
    text = re.sub(r"\\\*.*", "", text)
    text = re.sub(r"\(\*.*?\*\)", "", text, flags=re.S)
    return text


def _parse_value(tok: str):
    tok = tok.strip()
    if tok == "TRUE":
        return True
    if tok == "FALSE":
        return False
    if re.fullmatch(r"-?\d+", tok):
        return int(tok)
    if tok.startswith("{"):
        inner = tok.strip("{}").strip()
        if not inner:
            return frozenset()
        return frozenset(_parse_value(p) for p in inner.split(","))
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    return tok  # identifier / model value


def parse_cfg(text: str) -> TLCConfig:
    cfg = TLCConfig()
    text = _strip_comments(text)
    # tokenize into sections
    section = None
    # assignments may span lines; normalize whitespace, then split on
    # keywords
    tokens = re.split(
        r"\b(CONSTANTS?|SPECIFICATION|INVARIANTS?|PROPERTIES|INIT|NEXT)\b", text
    )
    i = 1
    while i < len(tokens):
        kw, body = tokens[i], tokens[i + 1] if i + 1 < len(tokens) else ""
        i += 2
        if kw.startswith("CONSTANT"):
            for m in re.finditer(
                r"([A-Za-z_]\w*)\s*=\s*(\{[^}]*\}|\"[^\"]*\"|[^,\s]+)", body
            ):
                name, val = m.group(1), _parse_value(m.group(2))
                if val == name:
                    cfg.model_values.append(name)
                else:
                    cfg.constants[name] = val
        elif kw == "SPECIFICATION":
            cfg.specification = body.strip().split()[0]
        elif kw.startswith("INVARIANT"):
            cfg.invariants += [
                p for p in re.split(r"[\s,]+", body.strip()) if p
            ]
        elif kw == "PROPERTIES":
            cfg.properties += [
                p for p in re.split(r"[\s,]+", body.strip()) if p
            ]
    return cfg


def _intern_space(name: str, val) -> int:
    """Canonicalize a key/value space to its size (elements -> 1..n)."""
    if isinstance(val, frozenset):
        if all(isinstance(x, int) for x in val):
            n = len(val)
            if val and (0 in val):
                raise ValueError(
                    f"{name}: 0 is reserved for the null element "
                    "(compaction.tla:30,32)"
                )
            if val != frozenset(range(1, n + 1)):
                warnings.warn(
                    f"{name}: relabeling {sorted(val)} to 1..{n} "
                    "(packed encoding uses dense positive ints)"
                )
            return n
        warnings.warn(
            f"{name}: non-integer elements {sorted(map(str, val))} violate "
            f"ASSUME {name} \\in SUBSET Nat (compaction.tla:29-32); "
            f"interning to 1..{len(val)}"
        )
        return len(val)
    raise ValueError(f"{name} must be a finite set, got {val!r}")


def to_constants(cfg: TLCConfig) -> Constants:
    """Bind a parsed cfg to the compaction spec's nine parameters."""
    c = cfg.constants
    required = [
        "MessageSentLimit",
        "CompactionTimesLimit",
        "ModelConsumer",
        "ConsumeTimesLimit",
        "KeySpace",
        "ValueSpace",
        "RetainNullKey",
        "MaxCrashTimes",
        "ModelProducer",
    ]
    missing = [r for r in required if r not in c]
    if missing:
        raise ValueError(f"cfg missing CONSTANTS: {missing}")
    out = Constants(
        message_sent_limit=int(c["MessageSentLimit"]),
        compaction_times_limit=int(c["CompactionTimesLimit"]),
        model_consumer=bool(c["ModelConsumer"]),
        consume_times_limit=int(c["ConsumeTimesLimit"]),
        num_keys=_intern_space("KeySpace", c["KeySpace"]),
        num_values=_intern_space("ValueSpace", c["ValueSpace"]),
        retain_null_key=bool(c["RetainNullKey"]),
        max_crash_times=int(c["MaxCrashTimes"]),
        model_producer=bool(c["ModelProducer"]),
    )
    out.validate()
    return out


def load(path: str) -> TLCConfig:
    with open(path) as f:
        return parse_cfg(f.read())
