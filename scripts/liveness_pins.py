"""Liveness pins: the JAX package's ``LivenessChecker`` on the CPU, for
the bindings whose ``Termination`` verdicts ``chip_smoke.py`` holds the
PyTorch port to.

    JAX_PLATFORMS=cpu python scripts/liveness_pins.py [NAME ...]

NAME is one or more of the cases of ``_cases`` below (default: all):
the 9,445,152-state tier of ``scripts/liveness_scale.py`` (912 s on 8
CPU cores, 3 GB of RAM), the 253,361-state config (on the hand model
and, ``compiled_full``, on the spec->kernel compiler's model), the
``consumer_on`` lasso oracle, and the other three specs at their
shipped cfgs.  For
each it prints one JSON line: the constants, the distinct and initial
state counts, the ``<Next>_vars`` edge count, the out-degree histogram
(``bincount(out_deg)``), the SHA-256 of the edge list (``src`` then
``dst``, int32 little-endian, in the engine's order), and for each
fairness mode the verdict, its reason and the lasso's gids, with the
wall seconds.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def edge_digest(src, dst) -> str:
    """SHA-256 of the edge list as the pins state it: the same digest
    as the port's ``engine/liveness.edge_digest``."""
    h = hashlib.sha256()
    h.update(np.asarray(src, "<i4").tobytes())
    h.update(np.asarray(dst, "<i4").tobytes())
    return h.hexdigest()


def _cases():
    """name -> (model factory, LivenessChecker knobs)."""
    from pulsar_tlaplus_tpu.models import registry
    from pulsar_tlaplus_tpu.models.compaction import CompactionModel
    from pulsar_tlaplus_tpu.ref import pyeval as pe
    from pulsar_tlaplus_tpu.utils import cfg as cfgmod

    tier9m = pe.Constants(
        message_sent_limit=4, compaction_times_limit=3, num_keys=2,
        num_values=2, retain_null_key=True, max_crash_times=2,
        model_producer=True, model_consumer=False,
    )
    full = dataclasses.replace(
        pe.SHIPPED_CFG, model_producer=True, retain_null_key=False
    )
    # the JAX liveness tests' consumer_on lasso oracle
    # (tests/test_compact.py CONSUMER_CFG)
    consumer = pe.Constants(
        message_sent_limit=2, compaction_times_limit=2, num_keys=1,
        num_values=1, max_crash_times=1, model_producer=True,
        model_consumer=True,
    )

    def compaction(c):
        return lambda: CompactionModel(c)

    def shipped(spec):
        cfg = os.path.join(ROOT, "specs", f"{spec}.cfg")
        return lambda: registry.COMPILED[spec](cfgmod.load(cfg))[0]

    cases = {
        "9m": (compaction(tier9m),
               dict(frontier_chunk=1 << 16, visited_cap=1 << 24,
                    max_states=12_000_000, sweep_chunk=1 << 17)),
        "full": (compaction(full),
                 dict(frontier_chunk=4096, visited_cap=1 << 18)),
        "consumer_on": (compaction(consumer),
                        dict(frontier_chunk=256, sweep_chunk=256,
                             visited_cap=1 << 13)),
    }
    for spec in ("subscription", "bookkeeper", "georeplication"):
        cases[spec] = (shipped(spec),
                       dict(frontier_chunk=512, visited_cap=1 << 13))
    # the 253,361-state config on the spec->kernel compiler's model of
    # specs/compaction.tla (other lanes than the hand model: other edges)
    cases["compiled_full"] = (
        compiled("compaction", ModelProducer=True, RetainNullKey=False),
        dict(frontier_chunk=4096, visited_cap=1 << 18))
    return cases


def compiled(spec, **overrides):
    """A factory of the JAX ``CompiledSpec`` of specs/SPEC.tla at its
    cfg with ``overrides``."""
    def make():
        from pulsar_tlaplus_tpu.frontend.codegen import CompiledSpec
        from pulsar_tlaplus_tpu.frontend.interp import Spec
        from pulsar_tlaplus_tpu.frontend.loader import bind_cfg
        from pulsar_tlaplus_tpu.frontend.parser import parse_file
        from pulsar_tlaplus_tpu.utils import cfg as cfgmod

        ast = parse_file(os.path.join(ROOT, "specs", f"{spec}.tla"))
        consts = bind_cfg(
            ast, cfgmod.load(os.path.join(ROOT, "specs", f"{spec}.cfg")))
        consts.pop("__string_interning__")
        consts.update(overrides)
        return CompiledSpec(Spec(ast, consts))

    return make


def main(names) -> int:
    from pulsar_tlaplus_tpu.engine.liveness import LivenessChecker

    cases = _cases()
    for name in names or list(cases):
        make, kw = cases[name]
        t = time.time()
        model = make()
        lc = LivenessChecker(model, fairness="wf_next", **kw)
        verdicts = {}
        for fairness in ("wf_next", "none"):
            lc.fairness = fairness
            r = lc.run()
            verdicts[fairness] = dict(
                holds=r.holds, reason=r.reason,
                lasso_prefix=r.lasso_prefix, lasso_cycle=r.lasso_cycle,
            )
        n, n_init = lc._explored
        src, dst, out_deg = lc._edge_cache
        print(json.dumps(dict(
            name=name,
            constants=repr(getattr(model, "c", None)
                           or model.spec.constants),
            distinct=n,
            n_init=n_init, edges=int(len(src)),
            out_deg_sum=int(out_deg.sum()),
            out_deg_hist=np.bincount(out_deg).tolist(),
            edges_sha256=edge_digest(src, dst),
            verdicts=verdicts, wall_s=round(time.time() - t, 1),
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
