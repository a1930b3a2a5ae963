"""Level sizes of a configuration's binding by the plain reference alone:
the ``pins`` a configuration file holds.  A breadth-first search that
keeps only the frontier as states and every state seen as its packed
row (one integer), so it reaches the scaled bindings on the host.

    python3 -m tlcbench.pins CONFIG [--levels N]

prints one JSON line: ``level_sizes``, ``distinct``, the first violated
invariant of the configuration, whether a deadlock was met, seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def level_sizes(ref, c, invariants, max_levels: int) -> dict:
    invs = [ref.INVARIANTS[i] for i in invariants]

    def key(s) -> int:
        return sum(w << (32 * i) for i, w in enumerate(ref.encode(c, s)))

    frontier = list(dict.fromkeys(ref.initial_states(c)))
    seen = {key(s) for s in frontier}
    sizes, violation, deadlock = [], None, False
    while frontier:
        sizes.append(len(frontier))
        if violation is None:
            violation = next((i for s in frontier for i, f in
                              zip(invariants, invs) if not f(c, s)), None)
        if violation is not None or len(sizes) == max_levels:
            break
        nxt = []
        last = len(sizes) + 1 == max_levels
        for s in frontier:
            succ = [t for t in ref.lanes(c, s) if t is not None]
            if not succ and not ref.stutter_enabled(c, s):
                deadlock = True
            for t in succ:
                k = key(t)
                if k not in seen:
                    seen.add(k)
                    # the last level is counted, not kept
                    nxt.append(None if last else t)
        frontier = nxt
        if last and frontier:
            sizes.append(len(frontier))  # its invariants are not evaluated
            break
    return dict(level_sizes=sizes, distinct=len(seen), violation=violation,
                deadlock=deadlock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--levels", type=int, default=10**6)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tlcbench import harness

    cfg = harness.load_config(a.config)
    ref = harness.load_reference(cfg["reference"])
    t = time.perf_counter()
    out = level_sizes(ref, ref.consts(cfg["constants"]), cfg["invariants"],
                      a.levels)
    out["seconds"] = round(time.perf_counter() - t, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
