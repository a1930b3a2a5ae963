"""Pure-Python reference evaluator for the ``compaction`` spec.

This is the *oracle* half of the differential-test strategy (SURVEY.md §4):
an independent, deliberately naive transliteration of the TLA+ semantics of
``specs/compaction.tla`` into Python, with no packing, masking, or
vectorization tricks.  The TPU engine must match this evaluator's reachable
state set, diameter, and invariant verdicts exactly.

State representation is structural (tuples / frozensets), mirroring the TLA+
value model:

- ``messages``: tuple of ``(id, key, value)`` triples
  (``compaction.tla:57``; record ``[id |-> .., key |-> .., value |-> ..]``
  per ``compaction.tla:80-81``)
- ``ledgers``: length-``CompactionTimesLimit`` tuple; each slot ``None`` (Nil)
  or a tuple of message triples (``compaction.tla:58-59``)
- ``cursor``: ``None`` or ``(compactionHorizon, compactedTopicContext)``
  (``compaction.tla:60``)
- ``cstate``: int 0..5 encoding the six ``Compactor_In_*`` model values
  (``compaction.tla:39-44``)
- ``p1``: ``None`` or ``(readPosition, latestForKey)`` where ``latestForKey``
  is a sorted tuple of ``(key, pos)`` pairs (``compaction.tla:64,97-98``)
- ``horizon``, ``context``, ``crash``, ``consume``: ints
  (``compaction.tla:65-70``)

Keys/values are canonicalized to integers ``1..K`` / ``1..V`` with 0 reserved
for NullKey/NullValue (``compaction.tla:47-50``); see SURVEY.md §1-L4 for the
string-key discrepancy in the shipped cfg which this canonicalization
resolves.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterable, Iterator, NamedTuple, Optional


# Compactor phase encoding (compaction.tla:38-44, 52-54).
PHASE_ONE = 0
PHASE_TWO_WRITE = 1
PHASE_TWO_UPDATE_CONTEXT = 2
PHASE_TWO_UPDATE_HORIZON = 3
PHASE_TWO_PERSIST_CURSOR = 4
PHASE_TWO_DELETE_LEDGER = 5

PHASE_NAMES = (
    "Compactor_In_PhaseOne",
    "Compactor_In_PhaseTwoWrite",
    "Compactor_In_PhaseTwoUpdateContext",
    "Compactor_In_PhaseTwoUpdateHorizon",
    "Compactor_In_PhaseTwoPersistCusror",  # [sic] compaction.tla:43
    "Compactor_In_PhaseTwoDeleteLedger",
)

NULL_KEY = 0  # compaction.tla:47
NULL_VALUE = 0  # compaction.tla:48

# Action ids, aligned with the Next disjunction order (compaction.tla:216-231).
ACTION_NAMES = (
    "Producer",
    "CompactorPhaseOne",
    "CompactorPhaseTwoWrite",
    "CompactorPhaseTwoUpdateContext",
    "CompactorPhaseTwoUpdateHorizon",
    "CompactorPhaseTwoPersistCusror",
    "CompactorPhaseTwoDeleteLedger",
    "BrokerCrash",
    "Consumer",
    "Terminating",
)


@dataclass(frozen=True)
class Constants:
    """The nine input parameters (compaction.tla:10-23) with keys/values
    canonicalized to ``1..num_keys`` / ``1..num_values``."""

    message_sent_limit: int = 3
    compaction_times_limit: int = 3
    model_consumer: bool = False
    consume_times_limit: int = 2
    num_keys: int = 2
    num_values: int = 2
    retain_null_key: bool = True
    max_crash_times: int = 1
    model_producer: bool = False

    @property
    def key_set(self) -> range:
        # KeySet == KeySpace \cup {NullKey} (compaction.tla:49)
        return range(0, self.num_keys + 1)

    @property
    def value_set(self) -> range:
        # ValueSet == ValueSpace \cup {NullValue} (compaction.tla:50)
        return range(0, self.num_values + 1)

    def validate(self) -> None:
        # ASSUME block (compaction.tla:25-35).
        for field in (
            "message_sent_limit",
            "compaction_times_limit",
            "consume_times_limit",
            "num_keys",
            "num_values",
            "max_crash_times",
        ):
            if getattr(self, field) < 0:
                raise ValueError(f"ASSUME violated: {field} must be in Nat")


SHIPPED_CFG = Constants()  # mirrors compaction.cfg:2-11 (keys interned)


class State(NamedTuple):
    messages: tuple  # tuple[(id, key, value), ...]
    ledgers: tuple  # C slots: None | tuple[(id, key, value), ...]
    cursor: Optional[tuple]  # None | (horizon, context)
    cstate: int
    p1: Optional[tuple]  # None | (read_position, ((key, pos), ...))
    horizon: int
    context: int
    crash: int
    consume: int


def initial_states(c: Constants) -> Iterator[State]:
    """Init (compaction.tla:188-202)."""
    rest = dict(
        ledgers=(None,) * c.compaction_times_limit,
        cursor=None,
        cstate=PHASE_ONE,
        p1=None,
        horizon=0,
        context=0,
        crash=0,
        consume=0,
    )
    if c.model_producer:
        yield State(messages=(), **rest)  # compaction.tla:189-190
    else:
        # messages \in {id-consistent length-M sequences} (compaction.tla:191-194)
        m = c.message_sent_limit
        per_pos = [
            [(i + 1, k, v) for k in c.key_set for v in c.value_set]
            for i in range(m)
        ]
        for msgs in itertools.product(*per_pos):
            yield State(messages=tuple(msgs), **rest)


def _max_ledger_id(ledgers: tuple) -> int:
    """MaxCompactedLedgerId (compaction.tla:103-106). 1-based; 0 when empty."""
    mx = 0
    for i, led in enumerate(ledgers):
        if led is not None:
            mx = i + 1
    return mx


def _compact_messages(messages: tuple, p1: tuple, retain_null_key: bool) -> tuple:
    """CompactMessages (compaction.tla:107-119)."""
    read_position, latest = p1
    latest_map = dict(latest)
    out = []
    for i in range(1, read_position + 1):
        mid, key, value = messages[i - 1]
        if key == NULL_KEY:
            if retain_null_key:
                out.append((mid, key, value))
        elif i == latest_map[key]:
            out.append((mid, key, value))
    return tuple(out)


def successors(c: Constants, s: State) -> Iterator[tuple[int, State]]:
    """Next (compaction.tla:216-231): yields (action_id, successor).

    Stuttering disjuncts (Consumer compaction.tla:185-186, Terminating
    compaction.tla:205-214) yield the state itself; they are included so
    enabledness/deadlock analysis is faithful, but BFS dedup drops them.
    """
    msgs = s.messages
    n = len(msgs)

    # Producer (compaction.tla:83-87), gated at compaction.tla:218-219.
    if c.model_producer and n < c.message_sent_limit:
        for key in c.key_set:
            for value in c.value_set:
                yield 0, s._replace(messages=msgs + ((n + 1, key, value),))

    # CompactorPhaseOne (compaction.tla:93-100).
    if s.cstate == PHASE_ONE and s.p1 is None and n > 0:
        latest: dict[int, int] = {}
        for i in range(1, n + 1):
            key = msgs[i - 1][1]
            if key != NULL_KEY:
                latest[key] = i  # Max over positions == last occurrence
        p1 = (n, tuple(sorted(latest.items())))
        yield 1, s._replace(p1=p1, cstate=PHASE_TWO_WRITE)

    # CompactorPhaseTwoWrite (compaction.tla:121-132).
    if s.p1 is not None and s.cstate == PHASE_TWO_WRITE:
        new_id = _max_ledger_id(s.ledgers) + 1
        if 1 <= new_id <= c.compaction_times_limit:
            compacted = _compact_messages(msgs, s.p1, c.retain_null_key)
            ledgers = list(s.ledgers)
            ledgers[new_id - 1] = compacted
            yield 2, s._replace(
                ledgers=tuple(ledgers), cstate=PHASE_TWO_UPDATE_CONTEXT
            )

    # CompactorPhaseTwoUpdateContext (compaction.tla:135-139).
    if s.cstate == PHASE_TWO_UPDATE_CONTEXT:
        yield 3, s._replace(
            context=_max_ledger_id(s.ledgers), cstate=PHASE_TWO_UPDATE_HORIZON
        )

    # CompactorPhaseTwoUpdateHorizon (compaction.tla:141-145).
    if s.cstate == PHASE_TWO_UPDATE_HORIZON:
        yield 4, s._replace(horizon=s.p1[0], cstate=PHASE_TWO_PERSIST_CURSOR)

    # CompactorPhaseTwoPersistCusror (compaction.tla:147-151).
    if s.cstate == PHASE_TWO_PERSIST_CURSOR:
        yield 5, s._replace(
            cursor=(s.horizon, s.context), cstate=PHASE_TWO_DELETE_LEDGER
        )

    # CompactorPhaseTwoDeleteLedger (compaction.tla:153-165).
    if s.cstate == PHASE_TWO_DELETE_LEDGER:
        max_id = _max_ledger_id(s.ledgers)
        if max_id == 0:
            # TLC: oldCompactedLedgerId = -1 -> compactedLedgers[-1] is an
            # out-of-domain evaluation error (unreachable from Init; this
            # state can only be constructed by hand).
            raise ValueError("DeleteLedger with no compacted ledger: out of domain")
        old_id = None if max_id == 1 else max_id - 1  # compaction.tla:160
        ledgers = s.ledgers
        if old_id is not None and ledgers[old_id - 1] is not None:
            tmp = list(ledgers)
            tmp[old_id - 1] = None
            ledgers = tuple(tmp)
        yield 6, s._replace(ledgers=ledgers, cstate=PHASE_ONE, p1=None)

    # BrokerCrash (compaction.tla:169-182).
    if s.crash < c.max_crash_times:
        horizon, context = s.cursor if s.cursor is not None else (0, 0)
        yield 7, s._replace(
            crash=s.crash + 1,
            cstate=PHASE_ONE,
            p1=None,
            horizon=horizon,
            context=context,
        )

    # Consumer stutter (compaction.tla:185-186), gated at compaction.tla:229-230.
    if c.model_consumer:
        yield 8, s

    # Terminating self-loop (compaction.tla:205-214).  Its guard is the
    # same condition as the Termination property body (compaction.tla:303-307).
    if termination_goal(c, s):
        yield 9, s


# ---------------------------------------------------------------------------
# Invariants (compaction.tla:236-294)
# ---------------------------------------------------------------------------


def type_safe(c: Constants, s: State) -> bool:
    """TypeSafe (compaction.tla:236-248)."""
    def msg_ok(m):
        mid, key, value = m
        return (
            1 <= mid <= c.message_sent_limit
            and key in c.key_set
            and value in c.value_set
        )

    if not all(msg_ok(m) for m in s.messages):
        return False
    for led in s.ledgers:
        if led is not None and not all(msg_ok(m) for m in led):
            return False
    if s.p1 is not None:
        read_position, latest = s.p1
        n = len(s.messages)
        if not (1 <= read_position <= n):
            return False
        if not all(1 <= pos <= n for _, pos in latest):
            return False
    if not (0 <= s.cstate <= 5):
        return False
    if not (0 <= s.horizon <= c.message_sent_limit):
        return False
    if not (0 <= s.context <= c.compaction_times_limit):
        return False
    if not (0 <= s.crash <= c.max_crash_times):
        return False
    if s.cursor is not None:
        h, ctx = s.cursor
        if not (
            1 <= h <= c.message_sent_limit
            and 1 <= ctx <= c.compaction_times_limit
        ):
            return False
    return True


def compacted_ledger_leak(c: Constants, s: State) -> bool:
    """CompactedLedgerLeak (compaction.tla:251-253): <= 2 live ledgers."""
    return sum(1 for led in s.ledgers if led is not None) <= 2


def compaction_horizon_correctness(c: Constants, s: State) -> bool:
    """CompactionHorizonCorrectness (compaction.tla:259-274).

    Lazy-evaluation fidelity: when horizon == 0 the \\A is vacuous and
    ``compactedLedgers[compactedTopicContext]`` (possibly index 0, out of
    domain) must never be forced (SURVEY.md C23).
    """
    if s.horizon == 0:
        return True
    ledger = s.ledgers[s.context - 1] if s.context >= 1 else None
    if ledger is None:
        ledger = ()  # out-of-domain / Nil deref would be a TLC error; treat
        # as empty so the \E below fails (documented deviation; unreachable
        # in this spec's reachable states).
    for i in range(1, s.horizon + 1):
        mid, key, value = s.messages[i - 1]
        if key == NULL_KEY and not c.retain_null_key:
            continue  # Nil entry: RetainNullKey => ... is vacuously true
        ok = any(lm[1] == key and lm[0] >= mid for lm in ledger)
        if not ok:
            return False
    return True


def duplicate_null_key_message(c: Constants, s: State) -> bool:
    """DuplicateNullKeyMessage (compaction.tla:280-294)."""
    if not (c.retain_null_key and s.context != 0):
        return True
    ledger = s.ledgers[s.context - 1]
    if ledger is None:
        ledger = ()
    n = len(s.messages)
    after = []
    for j in range(s.horizon + 1, n + 1):
        m = s.messages[j - 1]
        if m[1] == NULL_KEY and not c.retain_null_key:
            after.append(None)
        else:
            after.append(m)
    for entry in ledger:
        if entry[1] != NULL_KEY:
            continue
        if any(entry == a for a in after):
            return False
    return True


INVARIANTS = {
    "TypeSafe": type_safe,
    "CompactedLedgerLeak": compacted_ledger_leak,
    "CompactionHorizonCorrectness": compaction_horizon_correctness,
    "DuplicateNullKeyMessage": duplicate_null_key_message,
}


# ---------------------------------------------------------------------------
# Liveness (compaction.tla:303-307)
# ---------------------------------------------------------------------------


def termination_goal(c: Constants, s: State) -> bool:
    """Body of the Termination property ``<>(...)`` (compaction.tla:303-307)."""
    return (
        len(s.messages) == c.message_sent_limit
        and s.cstate == PHASE_TWO_WRITE
        and _max_ledger_id(s.ledgers) == c.compaction_times_limit
        and ((not c.model_consumer) or s.consume == c.consume_times_limit)
    )


def check_eventually(c: Constants, fairness: str = "none"):
    """Oracle liveness check of ``<>goal`` over ``Spec == Init /\\ [][Next]_vars``.

    fairness="none": the raw spec admits infinite stuttering anywhere, so
    ``<>P`` holds iff every *initial* state satisfies P (otherwise: stutter
    at a violating initial state forever).

    fairness="wf_next" (i.e. Spec /\\ WF_vars(Next)): WF constrains only
    ``<Next>_vars`` steps — Next steps that *change* vars.  Stuttering
    disjuncts (Consumer, Terminating) are not ``<Next>_vars`` steps and
    cannot discharge the fairness obligation, so a fair behavior may
    stutter forever only where no var-changing Next step is enabled.
    ``<>P`` is violated iff some path from an initial state through
    only-not-P states reaches (a) a state with no var-changing successor,
    or (b) a cycle (of var-changing transitions; self-loops are by
    definition stutters and excluded) of not-P states.

    Returns (holds: bool, reason: str).
    """
    seen = {}
    order = []
    frontier = []
    for s in initial_states(c):
        if s not in seen:
            seen[s] = len(order)
            order.append(s)
            frontier.append(s)
    n_init = len(order)
    edges = []
    i = 0
    while i < len(order):
        s = order[i]
        for _a, t in successors(c, s):
            if t not in seen:
                seen[t] = len(order)
                order.append(t)
            if t != s:  # <Next>_vars steps only; self-loops are stutters
                edges.append((seen[s], seen[t]))
        i += 1
    goal = [termination_goal(c, s) for s in order]

    if fairness == "none":
        bad = [i for i in range(n_init) if not goal[i]]
        if bad:
            return False, (
                "stuttering counterexample: initial state may stutter "
                "forever without reaching the goal (no fairness assumed)"
            )
        return True, "every initial state satisfies the goal"

    if fairness != "wf_next":
        raise ValueError(f"unknown fairness: {fairness}")
    # restrict to not-goal states reachable from not-goal inits via
    # not-goal-only paths
    adj = {}
    out_deg = [0] * len(order)
    for u, v in edges:
        out_deg[u] += 1
        if not goal[u] and not goal[v]:
            adj.setdefault(u, []).append(v)
    r = set()
    stack = [i for i in range(n_init) if not goal[i]]
    while stack:
        u = stack.pop()
        if u in r:
            continue
        r.add(u)
        for v in adj.get(u, ()):
            if v not in r:
                stack.append(v)
    for u in r:
        if out_deg[u] == 0:
            return False, (
                "fair stuttering at a not-goal state with no var-changing "
                "successor"
            )
    # cycle detection within R via Kahn's algorithm
    indeg = {u: 0 for u in r}
    for u in r:
        for v in adj.get(u, ()):
            if v in r:
                indeg[v] += 1
    queue = [u for u in r if indeg[u] == 0]
    removed = 0
    while queue:
        u = queue.pop()
        removed += 1
        for v in adj.get(u, ()):
            if v in r:
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
    if removed < len(r):
        return False, "cycle of not-goal states is fairly traversable"
    return True, "all fair behaviors reach the goal"

DEFAULT_INVARIANTS = ("TypeSafe", "CompactionHorizonCorrectness")  # compaction.cfg:25-31


@dataclass
class CheckResult:
    distinct_states: int
    diameter: int  # BFS levels, initial states = level 1 (TLC convention)
    violation: Optional[str] = None  # invariant name
    trace: Optional[list] = None  # list[State] from an initial state
    trace_actions: Optional[list] = None  # action ids along the trace


def check(
    c: Constants,
    invariants: Iterable[str] = DEFAULT_INVARIANTS,
    max_states: int = 10_000_000,
) -> CheckResult:
    """Breadth-first model checking (the implied TLC engine; SURVEY.md §1-L1).

    Returns on first invariant violation with a shortest counterexample
    trace, like TLC.
    """
    c.validate()
    inv_fns = [(name, INVARIANTS[name]) for name in invariants]
    seen: dict[State, tuple[Optional[State], int]] = {}  # state -> (parent, action)
    frontier: list[State] = []

    def build_trace(s: State) -> tuple[list, list]:
        states, actions = [s], []
        while True:
            parent, act = seen[states[-1]]
            if parent is None:
                break
            actions.append(act)
            states.append(parent)
        return list(reversed(states)), list(reversed(actions))

    for s in initial_states(c):
        if s not in seen:
            seen[s] = (None, -1)
            frontier.append(s)
            if len(seen) > max_states:
                raise RuntimeError(f"state explosion: >{max_states} states")
    depth = 1
    for name, fn in inv_fns:
        for s in frontier:
            if not fn(c, s):
                tr, acts = build_trace(s)
                return CheckResult(len(seen), depth, name, tr, acts)

    while frontier:
        new: list[State] = []
        for s in frontier:
            for act, t in successors(c, s):
                if t not in seen:
                    seen[t] = (s, act)
                    new.append(t)
                    if len(seen) > max_states:
                        raise RuntimeError(
                            f"state explosion: >{max_states} states"
                        )
        if not new:
            break
        depth += 1
        for name, fn in inv_fns:
            for t in new:
                if not fn(c, t):
                    tr, acts = build_trace(t)
                    return CheckResult(len(seen), depth, name, tr, acts)
        frontier = new

    return CheckResult(len(seen), depth, None, None, None)
