"""The readings that the limits of ``correct`` are set from, and the
faults they must catch, run through the benchmark's own harness in one
process (the benchmark's runs never run this):

    python3 tlcbench/control.py --workload NAME --seeds 1,2,3 \
        --seconds S --plant none|control|unchanged|half|altered [--out F]

- ``none``: the program as it is (the lower readings);
- ``control``: the configuration's guarantee broken one step down — a
  check's visited-set keys one 32-bit column narrower (64-bit hashed
  keys as 32-bit, exact 80-bit keys as 64-bit); a simulation's states
  with the crash counter one bit narrower than the layout gives it (a
  narrower key field would map each successor onto another valid one,
  since NullKey is a key);
- ``unchanged``: every successor lane returns its state unchanged;
- ``half``: the second half of every batch left out (no lane enabled);
- ``altered``: one field of one successor lane altered where the model
  produces it.

Each seed's compared numbers go to standard output as one JSON line,
and to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _narrow_keys():
    """``tiles.key_plane`` with its last key column zeroed on valid
    lanes: the keys one 32-bit column narrower."""
    import torch
    from pulsar_tlaplus_tpu_torch.ops import tiles

    orig = tiles.key_plane

    def narrow(keyspec, packedf, vflat):
        cols = orig(keyspec, packedf, vflat)
        empty = torch.stack([c == -1 for c in cols]).all(dim=0)
        last = torch.where(empty, cols[-1], torch.zeros_like(cols[-1]))
        return tuple(torch.stack([*cols[:-1], last]).unbind(0))

    tiles.key_plane = narrow
    try:
        yield
    finally:
        tiles.key_plane = orig


class _Faulty:
    """The model with its successors broken by ``fault``."""

    def __init__(self, model, fault: str):
        self._inner, self._fault = model, fault

    def successors(self, states):
        from pulsar_tlaplus_tpu_torch.ops.packing import smap

        succ, valid = self._inner.successors(states)
        a = valid.shape[1]
        if self._fault == "unchanged":
            succ = smap(lambda x: x.unsqueeze(1).expand(
                x.shape[0], a, *x.shape[1:]).clone(), states)
        elif self._fault == "half":
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = False
        elif self._fault == "altered":
            first = succ._fields[0]
            x = getattr(succ, first).clone()
            x[:, a - 1] = x[:, a - 1] ^ 1
            succ = succ._replace(**{first: x})
        elif self._fault == "narrow_counter":
            bits = int(self._inner.c.max_crash_times).bit_length() - 1
            succ = succ._replace(crash=succ.crash & ((1 << bits) - 1))
        else:
            raise ValueError(f"unknown fault {self._fault!r}")
        return succ, valid

    def __getattr__(self, name):
        return getattr(self._inner, name)


def plant(kind: str):
    """A ``plant(driver)`` for ``harness.run_cell``."""
    def apply(driver):
        if kind == "none":
            return
        if kind == "control":
            if type(driver).__name__ == "SimulateDriver":
                driver.model = _Faulty(driver.model, "narrow_counter")
                return
            window = driver.window

            def narrowed(*a, **k):
                with _narrow_keys():
                    return window(*a, **k)

            driver.window = narrowed
            return
        driver.model = _Faulty(driver.model, kind)

    return apply


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for the limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plant", default="none",
                    choices=("none", "control", "unchanged", "half",
                             "altered"))
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from tlcbench import harness

    harness.clean_env()
    lines = []
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        with open(os.devnull, "w") as sink:
            line = harness.run_cell(a.workload, seed, a.seconds, False, t0,
                                    plant=plant(a.plant), out=sink,
                                    err=sink)
        rec = dict(workload=a.workload, plant=a.plant, seed=seed,
                   correct=line["correct"], compared=line["compared"],
                   attempted=line["attempted"], metrics=line["metrics"],
                   notes=line["notes"])
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    if a.out:
        with open(a.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
