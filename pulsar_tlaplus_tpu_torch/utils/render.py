"""TLA+-style pretty-printing of states and counterexample traces, mirroring
TLC's error-trace output format so existing eyes/tooling can read it."""

from __future__ import annotations

from typing import List, Optional

from pulsar_tlaplus_tpu_torch.ref import pyeval


def _msg(m) -> str:
    return f"[id |-> {m[0]}, key |-> {_key(m[1])}, value |-> {_val(m[2])}]"


def _key(k: int) -> str:
    return str(k)


def _val(v: int) -> str:
    return str(v)


def _seq(entries) -> str:
    return "<<" + ", ".join(_msg(m) for m in entries) + ">>"


def render_state(s, c) -> str:
    if isinstance(s, dict):
        # generic model protocol: to_pystate returns an ordered mapping
        # TLA+ variable name -> rendered value (str or plain value)
        return "\n".join(f"/\\ {k} = {v}" for k, v in s.items())
    lines = []
    lines.append(f"/\\ messages = {_seq(s.messages)}")
    led = ", ".join(
        f"{i+1} :> " + ("Nil" if v is None else _seq(v))
        for i, v in enumerate(s.ledgers)
    )
    lines.append(f"/\\ compactedLedgers = ({led})")
    if s.cursor is None:
        lines.append("/\\ cursor = Nil")
    else:
        lines.append(
            f"/\\ cursor = [compactionHorizon |-> {s.cursor[0]}, "
            f"compactedTopicContext |-> {s.cursor[1]}]"
        )
    lines.append(f"/\\ compactorState = {pyeval.PHASE_NAMES[s.cstate]}")
    if s.p1 is None:
        lines.append("/\\ phaseOneResult = Nil")
    else:
        latest = ", ".join(f"{k} :> {p}" for k, p in s.p1[1])
        lines.append(
            f"/\\ phaseOneResult = [readPosition |-> {s.p1[0]}, "
            f"latestForKey |-> ({latest})]"
        )
    lines.append(f"/\\ compactionHorizon = {s.horizon}")
    lines.append(f"/\\ compactedTopicContext = {s.context}")
    lines.append(f"/\\ crashTimes = {s.crash}")
    lines.append(f"/\\ consumeTimes = {s.consume}")
    return "\n".join(lines)


def render_trace(
    trace: List[pyeval.State],
    actions: Optional[List[str]],
    c,
) -> str:
    out = []
    for i, s in enumerate(trace):
        if i == 0:
            hdr = f"State {i+1}: <Initial predicate>"
        else:
            hdr = f"State {i+1}: <{actions[i-1]}>"
        out.append(hdr)
        out.append(render_state(s, c))
        out.append("")
    return "\n".join(out)
