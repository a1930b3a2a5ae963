"""Plain reference of ``specs/compaction.tla`` (Apache Pulsar topic
compaction), written from the spec and independent of the checker under
test.

States are Python tuples, as TLA+ values: ``messages`` is a tuple of
``(id, key, value)``, ``ledgers`` a tuple of ``CompactionTimesLimit``
slots (``None`` = Nil, else a tuple of message triples), ``cursor``
``None`` or ``(horizon, context)``, ``p1`` ``None`` or ``(readPosition,
latestForKey)``.  Keys and values are ``1..n`` with 0 for NullKey /
NullValue (compaction.tla:47-50).

Beside the semantics, this file works out again from the CONSTANTS the
two things needed to read a checker's output:

- the **lane order**: Next's disjuncts in the spec's order
  (compaction.tla:216-231), the Producer's ``\\E key, value`` bindings in
  set order (key outer), the stuttering disjuncts (Consumer,
  Terminating) left out;
- the **packed row**: the compressed encoding (a message's id is its
  position, a ledger a mask of kept positions, ``latestForKey`` derived
  from the messages and ``readPosition``), fields in a fixed order, each
  element ``bitlen(range)`` bits wide, packed from bit 0 of word 0
  upwards into 32-bit words.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

PHASE_ONE, TWO_WRITE, TWO_CONTEXT, TWO_HORIZON, TWO_PERSIST, TWO_DELETE = (
    range(6))
NULL = 0


class Consts(NamedTuple):
    M: int  # MessageSentLimit
    C: int  # CompactionTimesLimit
    consumer: bool  # ModelConsumer
    consume_limit: int  # ConsumeTimesLimit
    K: int  # |KeySpace|
    V: int  # |ValueSpace|
    retain_null: bool  # RetainNullKey
    max_crash: int  # MaxCrashTimes
    producer: bool  # ModelProducer


class State(NamedTuple):
    messages: tuple
    ledgers: tuple
    cursor: Optional[tuple]
    cstate: int
    p1: Optional[tuple]
    horizon: int
    context: int
    crash: int
    consume: int


def _space(name: str, xs) -> int:
    xs = sorted(xs)
    if xs != list(range(1, len(xs) + 1)):
        raise ValueError(f"{name} must be 1..n, got {xs}")
    return len(xs)


def consts(constants: Dict[str, object]) -> Consts:
    """The CONSTANTS as a configuration file states them (TLC names)."""
    c = constants
    return Consts(
        M=int(c["MessageSentLimit"]), C=int(c["CompactionTimesLimit"]),
        consumer=bool(c["ModelConsumer"]),
        consume_limit=int(c["ConsumeTimesLimit"]),
        K=_space("KeySpace", c["KeySpace"]),
        V=_space("ValueSpace", c["ValueSpace"]),
        retain_null=bool(c["RetainNullKey"]),
        max_crash=int(c["MaxCrashTimes"]), producer=bool(c["ModelProducer"]),
    )


# ------------------------------------------------------------ semantics


def initial_states(c: Consts) -> List[State]:
    """Init (compaction.tla:188-202), the messages' bindings in set order
    (position 1 varies slowest)."""
    rest = (tuple([None] * c.C), None, PHASE_ONE, None, 0, 0, 0, 0)
    if c.producer:
        return [State((), *rest)]
    kv = [(k, v) for k in range(c.K + 1) for v in range(c.V + 1)]
    out = [()]
    for i in range(c.M):
        out = [m + ((i + 1, k, v),) for m in out for k, v in kv]
    # mixed radix with position 1 as the least significant digit
    out.sort(key=lambda m: [(k, v) for _i, k, v in reversed(m)])
    return [State(m, *rest) for m in out]


def _max_ledger(ledgers) -> int:
    """MaxCompactedLedgerId (compaction.tla:103-106), 0 when all Nil."""
    return max((i + 1 for i, x in enumerate(ledgers) if x is not None),
               default=0)


def _latest(messages, upto: int) -> tuple:
    """latestForKey over positions 1..upto (compaction.tla:97-98)."""
    last = {}
    for i in range(upto):
        if messages[i][1] != NULL:
            last[messages[i][1]] = i + 1
    return tuple(sorted(last.items()))


def _compact(c: Consts, messages, p1) -> tuple:
    """CompactMessages (compaction.tla:107-119)."""
    readpos, latest = p1
    latest = dict(latest)
    out = []
    for i in range(readpos):
        m = messages[i]
        if m[1] == NULL:
            if c.retain_null:
                out.append(m)
        elif latest[m[1]] == i + 1:
            out.append(m)
    return tuple(out)


def lanes(c: Consts, s: State) -> List[Optional[State]]:
    """Every non-stuttering lane of Next in lane order: the successor, or
    None where the lane is disabled."""
    out: List[Optional[State]] = []
    n = len(s.messages)
    if c.producer:  # Producer (compaction.tla:83-87, gated at 218-219)
        for k in range(c.K + 1):
            for v in range(c.V + 1):
                out.append(s._replace(messages=s.messages + ((n + 1, k, v),))
                           if n < c.M else None)
    # CompactorPhaseOne (93-100)
    out.append(s._replace(p1=(n, _latest(s.messages, n)), cstate=TWO_WRITE)
               if s.cstate == PHASE_ONE and s.p1 is None and n > 0 else None)
    # CompactorPhaseTwoWrite (121-132)
    new_id = _max_ledger(s.ledgers) + 1
    if s.p1 is not None and s.cstate == TWO_WRITE and new_id <= c.C:
        led = list(s.ledgers)
        led[new_id - 1] = _compact(c, s.messages, s.p1)
        out.append(s._replace(ledgers=tuple(led), cstate=TWO_CONTEXT))
    else:
        out.append(None)
    # CompactorPhaseTwoUpdateContext (135-139)
    out.append(s._replace(context=_max_ledger(s.ledgers), cstate=TWO_HORIZON)
               if s.cstate == TWO_CONTEXT else None)
    # CompactorPhaseTwoUpdateHorizon (141-145)
    out.append(s._replace(horizon=s.p1[0], cstate=TWO_PERSIST)
               if s.cstate == TWO_HORIZON else None)
    # CompactorPhaseTwoPersistCusror [sic] (147-151)
    out.append(s._replace(cursor=(s.horizon, s.context), cstate=TWO_DELETE)
               if s.cstate == TWO_PERSIST else None)
    # CompactorPhaseTwoDeleteLedger (153-165)
    if s.cstate == TWO_DELETE:
        top = _max_ledger(s.ledgers)
        led = list(s.ledgers)
        if top >= 2:
            led[top - 2] = None
        out.append(s._replace(ledgers=tuple(led), cstate=PHASE_ONE, p1=None))
    else:
        out.append(None)
    # BrokerCrash (169-182): recover from the durable cursor
    if s.crash < c.max_crash:
        h, ctx = s.cursor if s.cursor is not None else (0, 0)
        out.append(s._replace(crash=s.crash + 1, cstate=PHASE_ONE, p1=None,
                              horizon=h, context=ctx))
    else:
        out.append(None)
    return out


def is_initial(c: Consts, s: State) -> bool:
    """Whether ``s`` satisfies Init (compaction.tla:188-202)."""
    if c.producer:
        return s == initial_states(c)[0]
    return (len(s.messages) == c.M and s.ledgers == tuple([None] * c.C)
            and s[2:] == (None, PHASE_ONE, None, 0, 0, 0, 0))


def termination_goal(c: Consts, s: State) -> bool:
    """The body of Termination (compaction.tla:303-307)."""
    return (len(s.messages) == c.M and s.cstate == TWO_WRITE
            and _max_ledger(s.ledgers) == c.C
            and (not c.consumer or s.consume == c.consume_limit))


def stutter_enabled(c: Consts, s: State) -> bool:
    """Consumer (185-186) or Terminating (205-214) is enabled."""
    return c.consumer or termination_goal(c, s)


def _type_safe(c: Consts, s: State) -> bool:
    """TypeSafe (compaction.tla:236-248)."""
    def ok(m):
        return 1 <= m[0] <= c.M and 0 <= m[1] <= c.K and 0 <= m[2] <= c.V

    n = len(s.messages)
    if not all(ok(m) for m in s.messages):
        return False
    if any(led is not None and not all(ok(m) for m in led)
           for led in s.ledgers):
        return False
    if s.p1 is not None and not (1 <= s.p1[0] <= n and all(
            1 <= pos <= n for _k, pos in s.p1[1])):
        return False
    if s.cursor is not None and not (1 <= s.cursor[0] <= c.M
                                     and 1 <= s.cursor[1] <= c.C):
        return False
    return (0 <= s.cstate <= 5 and 0 <= s.horizon <= c.M
            and 0 <= s.context <= c.C and 0 <= s.crash <= c.max_crash)


def _leak(c: Consts, s: State) -> bool:
    """CompactedLedgerLeak (251-253)."""
    return sum(x is not None for x in s.ledgers) <= 2


def _horizon_correct(c: Consts, s: State) -> bool:
    """CompactionHorizonCorrectness (259-274): every message up to the
    horizon (a null key only if retained) has an entry of its key at or
    after its id in the context's ledger."""
    if s.horizon == 0:
        return True
    led = s.ledgers[s.context - 1] if s.context >= 1 else None
    led = led or ()
    for mid, key, _v in s.messages[: s.horizon]:
        if key == NULL and not c.retain_null:
            continue
        if not any(e[1] == key and e[0] >= mid for e in led):
            return False
    return True


def _dup_null(c: Consts, s: State) -> bool:
    """DuplicateNullKeyMessage (280-294)."""
    if not (c.retain_null and s.context != 0):
        return True
    led = s.ledgers[s.context - 1] or ()
    after = set(s.messages[s.horizon:])
    return not any(e[1] == NULL and e in after for e in led)


INVARIANTS = {
    "TypeSafe": _type_safe,
    "CompactedLedgerLeak": _leak,
    "CompactionHorizonCorrectness": _horizon_correct,
    "DuplicateNullKeyMessage": _dup_null,
}


# ------------------------------------------------------------- the row


def _bitlen(n: int) -> int:
    return int(n).bit_length()


def fields(c: Consts) -> List[tuple]:
    """(name, elements, bits) in row order."""
    mb, cb = _bitlen(c.M), _bitlen(c.C)
    out = [("length", 1, mb), ("keys", c.M, _bitlen(c.K)),
           ("vals", c.M, _bitlen(c.V))]
    for i in range(c.C):
        out += [(f"led_present{i}", 1, 1), (f"led_mask{i}", c.M, 1)]
    return out + [
        ("cursor_present", 1, 1), ("cursor_h", 1, mb), ("cursor_c", 1, cb),
        ("cstate", 1, 3), ("p1_present", 1, 1), ("p1_readpos", 1, mb),
        ("horizon", 1, mb), ("context", 1, cb),
        ("crash", 1, _bitlen(c.max_crash)),
        ("consume", 1, _bitlen(c.consume_limit) if c.consumer else 0),
    ]


def row_words(c: Consts) -> int:
    return max(1, -(-sum(n * w for _f, n, w in fields(c)) // 32))


def _values(c: Consts, s: State) -> Dict[str, List[int]]:
    n = len(s.messages)
    for i, m in enumerate(s.messages):
        if m[0] != i + 1:
            raise ValueError(f"message {i + 1} has id {m[0]}")
    pad = [0] * (c.M - n)
    v = {"length": [n], "keys": [m[1] for m in s.messages] + pad,
         "vals": [m[2] for m in s.messages] + pad}
    for i, led in enumerate(s.ledgers):
        mask = [0] * c.M
        for e in led or ():
            if s.messages[e[0] - 1] != e:
                raise ValueError(f"ledger entry {e} is not message {e[0]}")
            mask[e[0] - 1] = 1
        v[f"led_present{i}"] = [int(led is not None)]
        v[f"led_mask{i}"] = mask
    cur = s.cursor or (0, 0)
    if s.p1 is not None and s.p1[1] != _latest(s.messages, s.p1[0]):
        raise ValueError("latestForKey is not the messages' latest")
    v.update(cursor_present=[int(s.cursor is not None)], cursor_h=[cur[0]],
             cursor_c=[cur[1]], cstate=[s.cstate],
             p1_present=[int(s.p1 is not None)],
             p1_readpos=[s.p1[0] if s.p1 else 0], horizon=[s.horizon],
             context=[s.context], crash=[s.crash], consume=[s.consume])
    return v


def encode(c: Consts, s: State) -> List[int]:
    """A state's row: ``row_words(c)`` uint32 words."""
    v, x, at = _values(c, s), 0, 0
    for name, n, w in fields(c):
        for e in v[name]:
            if not 0 <= e < (1 << w) or (w == 0 and e):
                raise ValueError(f"{name} = {e} does not fit {w} bits")
            x |= e << at
            at += w
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(row_words(c))]


def _from_values(c: Consts, v: Dict[str, List[int]]) -> State:
    n = v["length"][0]
    msgs = tuple((i + 1, v["keys"][i], v["vals"][i]) for i in range(n))
    leds = []
    for i in range(c.C):
        mask = v[f"led_mask{i}"]
        if v[f"led_present{i}"][0]:
            leds.append(tuple(msgs[j] for j in range(min(n, c.M))
                              if mask[j]))
        else:
            leds.append(None)
    p1 = None
    if v["p1_present"][0]:
        rp = v["p1_readpos"][0]
        p1 = (rp, _latest(msgs, min(rp, n)))
    return State(
        msgs, tuple(leds),
        (v["cursor_h"][0], v["cursor_c"][0]) if v["cursor_present"][0]
        else None,
        v["cstate"][0], p1, v["horizon"][0], v["context"][0], v["crash"][0],
        v["consume"][0])


def decode(c: Consts, words) -> State:
    """A row (uint32 words) back to a state; raises where the row is not
    the canonical encoding of the state it reads as."""
    x = sum(int(w) << (32 * i) for i, w in enumerate(words))
    v, at = {}, 0
    for name, n, w in fields(c):
        v[name] = [(x >> (at + j * w)) & ((1 << w) - 1) for j in range(n)]
        at += n * w
    s = _from_values(c, v)
    if encode(c, s) != [int(w) for w in words]:
        raise ValueError("row is not in canonical form")
    return s


def from_fields(c: Consts, f: Dict[str, object]) -> State:
    """One walker's unpacked fields (the simulator's state: ``length``,
    ``keys``, ``vals``, ``led_present [C]``, ``led_bits [C, M]``,
    ``cursor_*``, ``cstate``, ``p1_*``, ``horizon``, ``context``,
    ``crash``, ``consume``) as a state; raises where they are not
    canonical (padding past the length, bits of an absent ledger)."""
    def one(name):
        return int(f[name])

    v = {"length": [one("length")], "keys": [int(x) for x in f["keys"]],
         "vals": [int(x) for x in f["vals"]]}
    for i in range(c.C):
        v[f"led_present{i}"] = [int(f["led_present"][i])]
        v[f"led_mask{i}"] = [int(b) for b in f["led_bits"][i]]
    for name in ("cursor_present", "cursor_h", "cursor_c", "cstate",
                 "p1_present", "p1_readpos", "horizon", "context", "crash",
                 "consume"):
        v[name] = [one(name)]
    s = _from_values(c, v)
    if _values(c, s) != v:
        raise ValueError("walker state is not in canonical form")
    return s


def bfs(c: Consts, invariants=(), max_levels: int = 10**6) -> dict:
    """Breadth-first search from Init: level sizes, the first violated
    invariant and whether a deadlock was met (the CPU tests' pins)."""
    seen = set()
    frontier = []
    for s in initial_states(c):
        if s not in seen:
            seen.add(s)
            frontier.append(s)
    sizes, violation, deadlock = [], None, False
    while frontier:
        sizes.append(len(frontier))
        for s in frontier:
            for name in invariants:
                if violation is None and not INVARIANTS[name](c, s):
                    violation = name
        if violation is not None or len(sizes) == max_levels:
            break
        nxt = []
        for s in frontier:
            succ = [t for t in lanes(c, s) if t is not None]
            if not succ and not stutter_enabled(c, s):
                deadlock = True
            for t in succ:
                if t not in seen:
                    seen.add(t)
                    nxt.append(t)
        frontier = nxt
    return dict(level_sizes=sizes, distinct=len(seen), violation=violation,
                deadlock=deadlock)
