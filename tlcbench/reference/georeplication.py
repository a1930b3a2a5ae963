"""Plain reference of ``specs/georeplication.tla`` (Apache Pulsar
geo-replication over a full mesh of clusters), written from the spec and
independent of the checker under test.

A state is ``(published, recvHwm, repCursor, repAcked, duplicated,
crashTimes)``: ``published`` a tuple over clusters, the three matrices
tuples of tuples (``recvHwm[dst][src]``, ``repCursor[src][dst]``,
``repAcked[src][dst]``), ``duplicated[dst][src]`` a frozenset of seqnos.
Clusters are ``0..N-1`` here for ``1..N`` in the spec.

The lane order is Next's disjuncts in the spec's order (Publish,
Replicate, PersistCursor, ReplicatorCrash; Terminating stutters), each
``\\E`` bound in set order: ``c`` for Publish, the pairs ``src # dst``
source-major for the others.  The row packs the variables in that order,
matrices row-major, each count ``bitlen(PublishLimit)`` bits (crashTimes
``bitlen(MaxReplicatorCrashes)``) and ``duplicated[dst][src]`` as
``PublishLimit`` bits, seqno ``q`` at bit ``q - 1``; elements from bit 0
of word 0 upwards into 32-bit words.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional


class Consts(NamedTuple):
    N: int  # NumClusters
    P: int  # PublishLimit
    max_crash: int  # MaxReplicatorCrashes


class State(NamedTuple):
    published: tuple
    recv_hwm: tuple
    rep_cursor: tuple
    rep_acked: tuple
    duplicated: tuple
    crash: int


def consts(constants: Dict[str, object]) -> Consts:
    c = Consts(int(constants["NumClusters"]), int(constants["PublishLimit"]),
               int(constants["MaxReplicatorCrashes"]))
    if c.N < 2 or c.P < 1 or c.max_crash < 0:
        raise ValueError(f"ASSUME violated: {c}")
    return c


def _set(m, i, j, x):
    return tuple(tuple(x if (a, b) == (i, j) else y
                       for b, y in enumerate(row))
                 for a, row in enumerate(m))


def initial_states(c: Consts) -> List[State]:
    z = tuple(tuple(0 for _ in range(c.N)) for _ in range(c.N))
    e = tuple(tuple(frozenset() for _ in range(c.N)) for _ in range(c.N))
    return [State(tuple([0] * c.N), z, z, z, e, 0)]


def is_initial(c: Consts, s: State) -> bool:
    return s == initial_states(c)[0]


def _pairs(c: Consts):
    return [(s, d) for s in range(c.N) for d in range(c.N) if s != d]


def lanes(c: Consts, s: State) -> List[Optional[State]]:
    out: List[Optional[State]] = []
    for k in range(c.N):  # Publish
        pub = tuple(x + (i == k) for i, x in enumerate(s.published))
        out.append(s._replace(published=pub)
                   if s.published[k] < c.P else None)
    for src, dst in _pairs(c):  # Replicate
        cur = s.rep_cursor[src][dst]
        if cur < s.published[src]:
            nxt, hwm = cur + 1, s.recv_hwm[dst][src]
            dup = s.duplicated
            if nxt <= hwm:
                dup = _set(dup, dst, src, dup[dst][src] | {nxt})
            out.append(s._replace(
                rep_cursor=_set(s.rep_cursor, src, dst, nxt),
                recv_hwm=_set(s.recv_hwm, dst, src, max(nxt, hwm)),
                duplicated=dup))
        else:
            out.append(None)
    for src, dst in _pairs(c):  # PersistCursor
        cur = s.rep_cursor[src][dst]
        out.append(s._replace(rep_acked=_set(s.rep_acked, src, dst, cur))
                   if s.rep_acked[src][dst] < cur else None)
    for src, dst in _pairs(c):  # ReplicatorCrash
        ack = s.rep_acked[src][dst]
        out.append(s._replace(rep_cursor=_set(s.rep_cursor, src, dst, ack),
                              crash=s.crash + 1)
                   if s.crash < c.max_crash and ack < s.rep_cursor[src][dst]
                   else None)
    return out


def done(c: Consts, s: State) -> bool:
    return all(x == c.P for x in s.published) and all(
        s.rep_cursor[a][b] == c.P and s.rep_acked[a][b] == c.P
        for a, b in _pairs(c))


def stutter_enabled(c: Consts, s: State) -> bool:
    """Terminating is enabled."""
    return done(c, s)


def _type_ok(c: Consts, s: State) -> bool:
    for k in range(c.N):
        if not (0 <= s.published[k] <= c.P and s.recv_hwm[k][k] == 0
                and s.rep_cursor[k][k] == 0 and s.rep_acked[k][k] == 0
                and not s.duplicated[k][k]):
            return False
    for src, dst in _pairs(c):
        cur, ack = s.rep_cursor[src][dst], s.rep_acked[src][dst]
        hwm = s.recv_hwm[dst][src]
        if not (0 <= cur <= s.published[src] and 0 <= ack <= cur
                and 0 <= hwm <= s.published[src]
                and s.duplicated[dst][src] <= set(range(1, hwm + 1))):
            return False
    return 0 <= s.crash <= c.max_crash


def _cursor_within(c: Consts, s: State) -> bool:
    return all(s.rep_cursor[a][b] <= s.recv_hwm[b][a] for a, b in _pairs(c))


def _no_phantom(c: Consts, s: State) -> bool:
    return all(s.recv_hwm[b][a] <= s.published[a] for a, b in _pairs(c))


def _no_dup(c: Consts, s: State) -> bool:
    return not any(x for row in s.duplicated for x in row)


INVARIANTS = {
    "TypeOK": _type_ok,
    "CursorWithinWatermark": _cursor_within,
    "NoPhantomMessages": _no_phantom,
    "NoDuplicateDelivery": _no_dup,
}


def _bitlen(n: int) -> int:
    return int(n).bit_length()


def fields(c: Consts) -> List[tuple]:
    pb, nn = _bitlen(c.P), c.N * c.N
    return [("published", c.N, pb), ("recv_hwm", nn, pb),
            ("rep_cursor", nn, pb), ("rep_acked", nn, pb),
            ("duplicated", nn * c.P, 1), ("crash", 1, _bitlen(c.max_crash))]


def row_words(c: Consts) -> int:
    return max(1, -(-sum(n * w for _f, n, w in fields(c)) // 32))


def _values(c: Consts, s: State) -> Dict[str, List[int]]:
    dup = []
    for row in s.duplicated:
        for x in row:
            if not x <= set(range(1, c.P + 1)):
                raise ValueError(f"seqnos {sorted(x)} outside 1..{c.P}")
            dup += [int(q in x) for q in range(1, c.P + 1)]
    return {"published": list(s.published),
            "recv_hwm": [x for r in s.recv_hwm for x in r],
            "rep_cursor": [x for r in s.rep_cursor for x in r],
            "rep_acked": [x for r in s.rep_acked for x in r],
            "duplicated": dup, "crash": [s.crash]}


def encode(c: Consts, s: State) -> List[int]:
    v, x, at = _values(c, s), 0, 0
    for name, n, w in fields(c):
        for e in v[name]:
            if not 0 <= e < (1 << w) or (w == 0 and e):
                raise ValueError(f"{name} = {e} does not fit {w} bits")
            x |= e << at
            at += w
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(row_words(c))]


def decode(c: Consts, words) -> State:
    x = sum(int(w) << (32 * i) for i, w in enumerate(words))
    v, at = {}, 0
    for name, n, w in fields(c):
        v[name] = [(x >> (at + j * w)) & ((1 << w) - 1) for j in range(n)]
        at += n * w
    n, p = c.N, c.P

    def mat(xs):
        return tuple(tuple(xs[a * n:(a + 1) * n]) for a in range(n))

    d = v["duplicated"]
    dup = tuple(tuple(frozenset(q + 1 for q in range(p)
                                if d[(a * n + b) * p + q])
                      for b in range(n)) for a in range(n))
    s = State(tuple(v["published"]), mat(v["recv_hwm"]),
              mat(v["rep_cursor"]), mat(v["rep_acked"]), dup, v["crash"][0])
    if encode(c, s) != [int(w) for w in words]:
        raise ValueError("row is not in canonical form")
    return s


def bfs(c: Consts, invariants=(), max_levels: int = 10**6) -> dict:
    """Breadth-first search from Init (the CPU tests' pins)."""
    seen = set(initial_states(c))
    frontier = list(seen)
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
