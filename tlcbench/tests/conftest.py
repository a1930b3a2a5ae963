"""The benchmark's CPU tests: small bindings in ``tests/configs`` and a
bench of cells over them, run on the CPU with the card check skipped."""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_BENCH = dict(
    workloads=[
        dict(name="cs.check", config="compaction-shipped", traffic="check",
             chips=1),
        dict(name="cc.check", config="compaction-cut", traffic="check",
             chips=1),
        dict(name="gs.check", config="georeplication-shipped",
             traffic="check", chips=1),
        dict(name="cc.simulate", config="compaction-cut",
             traffic="simulate", chips=1),
    ],
    end_to_end=[dict(name="states_per_s", unit="states/s",
                     workloads=["cs.check", "cc.check", "gs.check"]),
                dict(name="sim_steps_per_s", unit="steps/s",
                     workloads=["cc.simulate"]),
                dict(name="setup_s", unit="s")],
    per_layer=[dict(name="host_syncs_per_level.check", unit="syncs/level",
                    workloads=["cs.check", "cc.check", "gs.check"])],
)


@pytest.fixture
def small(monkeypatch):
    """The harness with the small test bindings beside its own."""
    import torch

    from tlcbench import harness

    torch.set_num_threads(1)
    orig = harness.load_config

    def load(name):
        p = HERE / "configs" / f"{name}.json"
        return json.loads(p.read_text()) if p.exists() else orig(name)

    monkeypatch.setattr(harness, "load_config", load)
    return harness
