"""The one-shot simulation API — the counterpart of
``pulsar_tlaplus_tpu/engine/simulate.py``: one behavior round of
``n_walkers`` walkers at ``depth`` steps on the streaming engine
(``sim/engine.py``), with its earliest-violation replay."""

from __future__ import annotations

from typing import Optional, Tuple

from pulsar_tlaplus_tpu_torch.sim.engine import (  # noqa: F401 — re-export
    SimulationResult,
    StreamingSimulator,
)


class Simulator:
    """One-round walker-batch simulation."""

    def __init__(
        self,
        model,
        invariants: Optional[Tuple[str, ...]] = None,
        n_walkers: int = 4096,
        depth: int = 64,
        seed: int = 0,
        device=None,
    ):
        self._eng = StreamingSimulator(
            model,
            invariants=invariants,
            n_walkers=n_walkers,
            depth=depth,
            seed=seed,
            max_rounds=1,
            device=device,
        )
        self.model = model
        self.invariant_names = self._eng.invariant_names
        self.B = self._eng.B
        self.T = self._eng.T
        self.seed = seed

    def run(self) -> SimulationResult:
        return self._eng.run()
