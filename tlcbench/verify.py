"""What decides ``correct``: the window's output held against the plain
reference.  Every number compared is a count of faults with the limit
0 (an exact comparison).

A check cell (``check_window``):

- ``checks_off_pins``: checks of the window whose complete levels, level
  count or verdict differ from the configuration's pins (every check);
- of one check kept from the window, drawn from the seed, on the card in
  plain PyTorch: ``duplicate_rows`` (two gids hold one state) and
  ``order_breaks`` (a parent outside the level before, a lane outside
  ``0..A-1``, or gids not in (parent, lane) order within a level);
- of a sample of its states drawn from the seed, on the host by the
  reference: ``bad_edges`` (a root that is not that initial state, or a
  state that is not its parent's successor at its lane, or one that an
  earlier lane of the parent already gives), ``bad_invariants`` (an
  invariant of the configuration fails), and ``missing_successors``
  (a successor of a state whose next level is complete that the check
  never found, or a deadlock the check did not report).

A simulate cell (``sim_window``): every recorded walker's first state is
an initial state (``bad_inits``), every step goes to a successor, or
stays where the state may stutter or nothing is enabled
(``bad_steps``), and every visited state satisfies the invariants
(``bad_invariants``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# an odd 64-bit multiplier (as int64) for the rows' lookup hash
MULT = 0x100000001B3


# states of the kept check whose edges are held to the reference, and
# states whose successors must all have been found
EDGES, CLOSURE = 2000, 200


def _lim(value) -> dict:
    return {"value": int(value), "limit": 0}


# ------------------------------------------------------------- checks


def off_pins(summary: dict, pins: dict, capped: bool) -> bool:
    """Whether one check's level sizes or verdict leave the pins.  A
    check stopped by the window's end is held to its complete levels."""
    sizes, want = summary["level_sizes"], pins["level_sizes"]
    if summary["violation"] is not None or summary["deadlock"]:
        return True
    if summary["stop_reason"] == "time_budget":
        done = sizes[:-1]
        return done != want[: len(done)]
    if capped:  # cut by the state cap inside the level after the pins
        return (summary["stop_reason"] != "max_states"
                or sizes[: len(want)] != want or len(sizes) != len(want) + 1)
    return summary["truncated"] or sizes != want


def _row_hash(rows: torch.Tensor) -> torch.Tensor:
    h = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for w in range(rows.shape[1]):
        h = h * MULT + (rows[:, w].to(torch.int64) & MASK32) + 1
    return h


class RowSet:
    """The kept check's rows, sorted by a hash for lookups."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        h = _row_hash(rows)
        self.h, self.order = torch.sort(h)

    def duplicates(self) -> int:
        same = (self.h[1:] == self.h[:-1]).nonzero().flatten()
        if same.numel() == 0:
            return 0
        a = self.rows[self.order[same]]
        b = self.rows[self.order[same + 1]]
        return int((a == b).all(dim=1).sum())

    def contains(self, words: List[List[int]]) -> List[bool]:
        if not words:
            return []
        q = torch.tensor(np.array(words, dtype=np.uint32).view(np.int32),
                         device=self.rows.device)
        hq = _row_hash(q)
        lo = torch.searchsorted(self.h, hq).tolist()
        hi = torch.searchsorted(self.h, hq, right=True).tolist()
        out = []
        for i, (a, b) in enumerate(zip(lo, hi)):
            hit = False
            if b > a:
                cand = self.rows[self.order[a:b]]
                hit = bool((cand == q[i]).all(dim=1).any())
            out.append(hit)
        return out


def order_breaks(parent: torch.Tensor, lane: torch.Tensor,
                 sizes: List[int], A: int, n_initial: int) -> int:
    """Gids out of (parent, lane) order within a level, parents outside
    the level before, lanes outside ``0..A-1``; roots log
    ``-1 - init_index`` in increasing order."""
    dev = parent.device
    p, ln = parent.to(torch.int64), lane.to(torch.int64)
    n = p.shape[0]
    sz = torch.tensor(sizes, dtype=torch.int64, device=dev)
    level = torch.repeat_interleave(torch.arange(len(sizes), device=dev), sz)
    ends = torch.cumsum(sz, 0)
    starts = ends - sz
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    root = level == 0
    idx = torch.where(root, -1 - p, 0)
    bad |= root & ((idx < 0) | (idx >= n_initial))
    lv = level.clamp(min=1) - 1
    bad |= ~root & ((p < starts[lv]) | (p >= ends[lv]) | (ln < 0)
                    | (ln >= A))
    key = torch.where(root, idx, p * A + ln)
    same = level[1:] == level[:-1]
    bad[1:] |= same & (key[1:] <= key[:-1])
    return int(bad.sum())


def _levels_of(gids: np.ndarray, sizes: List[int]) -> np.ndarray:
    return np.searchsorted(np.cumsum(sizes), gids, side="right")


def check_window(ref, c, config: dict, summaries: List[dict],
                 kept: Optional[dict], seed: int) -> dict:
    pins = config["pins"]
    capped = bool(config.get("max_states"))
    n_off = sum(off_pins(s, pins, capped) for s in summaries)
    out = {"checks_off_pins": _lim(n_off)}
    if kept is None:  # the window finished no check and stopped none
        out["no_check_kept"] = _lim(1)
        out["_failed_checks"] = n_off
        return out
    rows, parent, lane = kept["rows"], kept["parent"], kept["lane"]
    s = kept["summary"]
    sizes = s["level_sizes"]
    A = s["A"]
    inits = ref.initial_states(c)
    rs = RowSet(rows)
    out["duplicate_rows"] = _lim(rs.duplicates())
    out["order_breaks"] = _lim(order_breaks(parent, lane, sizes, A,
                                            len(inits)))
    # the last level whose successors all lie in the kept check: a cut
    # check's last level is partial, and so the one before is not closed
    closable = len(sizes) - 1 if not s["truncated"] else len(sizes) - 3
    rng = np.random.default_rng(seed)
    n = rows.shape[0]
    firsts = np.cumsum([0] + sizes[:-1])
    pick = np.unique(np.concatenate([
        rng.choice(n, size=min(EDGES, n),
                   replace=False),
        firsts, firsts + np.array(sizes) - 1, [n - 1]]))
    lv = _levels_of(pick, sizes)
    par = parent[torch.as_tensor(pick, device=parent.device)].cpu().numpy()
    lan = lane[torch.as_tensor(pick, device=lane.device)].cpu().numpy()
    need = np.unique(np.concatenate([pick, par[par >= 0]]))
    got = rows[torch.as_tensor(need, device=rows.device)].cpu().numpy()
    words = {int(g): got[i].view(np.uint32).tolist()
             for i, g in enumerate(need)}
    bad_edges = bad_inv = 0
    states = {}
    for g in need:
        try:
            states[int(g)] = ref.decode(c, words[int(g)])
        except ValueError:
            states[int(g)] = None
    invs = [ref.INVARIANTS[i] for i in config["invariants"]]
    for g, p, ln, level in zip(pick.tolist(), par.tolist(), lan.tolist(),
                               lv.tolist()):
        st = states[g]
        if st is None:
            bad_edges += 1
            continue
        if any(not f(c, st) for f in invs):
            bad_inv += 1
        if level == 0:
            bad_edges += not (0 <= -1 - p < len(inits)
                              and inits[-1 - p] == st)
            continue
        ps = states.get(p)
        if ps is None or not 0 <= ln < A:
            bad_edges += 1
            continue
        succ = ref.lanes(c, ps)
        t = succ[ln]
        if t is None or ref.encode(c, t) != words[g]:
            bad_edges += 1
        elif any(u is not None and u == t for u in succ[:ln]):
            bad_edges += 1  # an earlier lane of the parent gives it
    # closure: every successor of a sampled state whose next level is
    # complete was found
    cand = [g for g, level in zip(pick.tolist(), lv.tolist())
            if level <= closable and states[g] is not None]
    k = min(CLOSURE, len(cand))
    close = rng.choice(cand, size=k, replace=False) if k else []
    queries, missing = [], 0
    for g in close:
        st = states[int(g)]
        succ = [t for t in ref.lanes(c, st) if t is not None]
        if not succ and not ref.stutter_enabled(c, st):
            missing += 1  # a deadlock the check did not report
        queries += [ref.encode(c, t) for t in succ]
    missing += sum(not x for x in rs.contains(queries))
    out["bad_edges"] = _lim(bad_edges)
    out["bad_invariants"] = _lim(bad_inv)
    out["missing_successors"] = _lim(missing)
    out["_failed_checks"] = n_off + int(bad_edges + bad_inv + missing > 0)
    return out


# ----------------------------------------------------------- simulate


def _walker(snap: dict, i: int) -> dict:
    return {k: v[i] for k, v in snap.items()}


def sim_window(ref, c, config: dict, snaps: List[dict], result,
               depth: int) -> dict:
    """``snaps``: the sampled walkers' states, one dict of numpy fields
    (walkers first) a step, each walker through the round drawn for it,
    from that round's initial states."""
    invs = [ref.INVARIANTS[i] for i in config["invariants"]]
    bad_init = bad_step = bad_inv = 0
    failed = set()
    n = len(next(iter(snaps[0].values()))) if snaps else 0
    for w in range(n):
        prev = None
        for j, snap in enumerate(snaps):
            try:
                st = ref.from_fields(c, _walker(snap, w))
            except ValueError:
                st = None
            if st is None:
                bad_step += 1
                failed.add(w)
                prev = None
                continue
            if any(not f(c, st) for f in invs):
                bad_inv += 1
                failed.add(w)
            if j == 0:
                if not ref.is_initial(c, st):
                    bad_init += 1
                    failed.add(w)
            elif prev is not None:
                succ = [t for t in ref.lanes(c, prev) if t is not None]
                ok = st in succ or (st == prev and (
                    not succ or ref.stutter_enabled(c, prev)))
                if not ok:
                    bad_step += 1
                    failed.add(w)
            prev = st
    out = {"bad_inits": _lim(bad_init), "bad_steps": _lim(bad_step),
           "bad_invariants": _lim(bad_inv),
           "round_not_recorded": _lim(0 if snaps else 1)}
    out["_failed_walkers"] = len(failed)
    return out
