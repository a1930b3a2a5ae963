"""Level totals of the subscription, bookkeeper and georeplication specs
at their scaled bindings, from the JAX package's ``DeviceChecker``.

    JAX_PLATFORMS=cpu python scripts/spec_scaled_pins.py [NAME ...]

NAME is one or more of ``SCALED`` below (default: all).  For each binding
it prints one JSON line: the constants, the state layout (bits, words
W, key columns K, exact or hashed keys), the lanes A, the level sizes,
the cumulative level totals, the distinct count, the diameter, whether
``max_states`` cut the run, and the wall seconds.  ``chip_smoke.py``
pins these totals (``SPEC_SCALED``) and holds the PyTorch port's runs on
the card to them; where a run is cut, only its complete levels (all but
the last) are pinned.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (module, constants, max_states)
SCALED = {
    "subscription": ("subscription",
                     dict(MessageLimit=6, MaxCrashTimes=3), 1 << 26),
    "bookkeeper": ("bookkeeper",
                   dict(NumBookies=4, WriteQuorum=3, AckQuorum=2,
                        EntryLimit=4, MaxBookieCrashes=1), 1 << 26),
    "geo_exact": ("georeplication",
                  dict(NumClusters=3, PublishLimit=2,
                       MaxReplicatorCrashes=2), 1 << 26),
    "geo_hashed": ("georeplication",
                   dict(NumClusters=4, PublishLimit=2,
                        MaxReplicatorCrashes=1), 10_000_000),
}


def main(names) -> int:
    from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker
    from pulsar_tlaplus_tpu.models import registry
    from pulsar_tlaplus_tpu.ops.dedup import KeySpec

    class _Cfg:  # the one field the registry's factories read
        def __init__(self, constants):
            self.constants = constants

    for name in names:
        module, consts, max_states = SCALED[name]
        model, _c = registry.COMPILED[module](_Cfg(consts))
        lay = model.layout
        ks = KeySpec(lay.total_bits, lay.W)
        t = time.time()
        r = DeviceChecker(model, max_states=max_states).run()
        print(json.dumps(dict(
            name=name, module=module, constants=consts,
            max_states=max_states, bits=lay.total_bits, W=lay.W,
            K=ks.ncols, exact=ks.exact, A=model.A,
            level_sizes=r.level_sizes,
            totals=list(itertools.accumulate(r.level_sizes)),
            distinct=r.distinct_states, diameter=r.diameter,
            truncated=r.truncated, violation=r.violation,
            wall_s=round(time.time() - t, 1),
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(SCALED)))
