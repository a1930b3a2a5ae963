"""Walker-swarm simulation (TLC's ``-simulate``) — the counterpart of
``pulsar_tlaplus_tpu/sim``: :class:`~.engine.StreamingSimulator` runs
thousands of random walks a segment on one device under step, round and
time budgets, deterministic given ``seed`` (``sim/rng.py``)."""

from pulsar_tlaplus_tpu_torch.sim.engine import (  # noqa: F401
    SimulationResult,
    StreamingSimulator,
)
