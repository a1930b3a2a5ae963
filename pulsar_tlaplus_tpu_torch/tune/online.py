"""Online adaptation — a controller at fused-pass boundaries over the
flush metrics the pass's read already brought to the host; the
counterpart of ``pulsar_tlaplus_tpu/tune/online.py`` (pure Python,
copied).

The fused level reads the device once a pass (``device_bfs._lv_read``:
the state count, the flush-metrics vector, the work vector).  This
controller closes the loop mid-run for the two knobs that are safe to
move between passes, and reads nothing else — it adds no sync:

- **ramp-batch cap** (``fuse_cap``): the levels one ramp pass may close,
  bounded to ``[2, RMAX]``.  Repeated early exits (a pass closing fewer
  levels than asked) shrink the cap toward what the frontier sustains
  (floor 2: at a cap of 1 the signal that grows it back would vanish);
  repeated full batches grow it back toward ``RMAX``.
- **fpset dense rounds** (``fpset_dense_rounds``), bounded to
  ``[MIN_DENSE, MAX_DENSE]``.  Raising it is the pre-emptive remedy when
  the running ``fpset_max_probe_rounds`` climbs toward the schedule's
  probe budget; once raised under pressure it never lowers again
  (hysteresis against a running max).  In the port's tiled flush the
  membership kernel K1 runs ``max(TILE_R, dense)`` rounds — a runtime
  argument of the kernel, so a change costs no rebuild — so only a raise
  past ``TILE_R`` (to 16) changes what the flush launches.

Neither knob can change the states found or their order: the cap only
moves pass boundaries, and the probe schedule only moves which lanes the
membership pass settles before the insert tail (dedup is
min-lane-wins whatever the schedule) — pinned on both published bug
oracles and the producer-on config (``tests/test_torch_tune.py``).

Kill switch: ``-no-adapt`` at the CLI, and ``PTT_TUNE_ADAPT=0``
disables adaptation everywhere (``=1`` turns it on where nothing
chose); every adjustment is a telemetry ``tune`` record.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

ADAPT_ENV = "PTT_TUNE_ADAPT"

MIN_DENSE = 2
MAX_DENSE = 16
# consecutive same-signal passes before a knob moves (damping)
HYSTERESIS = 2


def env_override() -> Optional[bool]:
    """``PTT_TUNE_ADAPT=0`` -> False (the ABSOLUTE kill switch),
    ``=1`` -> True (default-on), unset/other -> None."""
    v = os.environ.get(ADAPT_ENV)
    if v == "0":
        return False
    if v == "1":
        return True
    return None


def resolve_adapt(explicit: Optional[bool], profile_default: bool) -> bool:
    """Effective adaptation switch.  Asymmetric by design:
    ``PTT_TUNE_ADAPT=0`` kills adaptation absolutely (beats
    everything), but ``=1`` only fills in where nothing chose — an
    explicit ``adapt=False`` (a caller pinning its schedule, as the
    JAX daemon's checker pool does) must win over the env default-on."""
    env = env_override()
    if env is False:
        return False
    if explicit is not None:
        return bool(explicit)
    if env is True:
        return True
    return bool(profile_default)


class OnlineController:
    """Per-run controller; the engine calls :meth:`observe` after
    every fused pass and applies the returned adjustments before
    the next one (``device_bfs._apply_tune``)."""

    def __init__(
        self,
        rmax: int,
        dense_rounds: int,
        stages,
        probe_budget: Optional[int] = None,
    ):
        self.rmax = max(int(rmax), 1)
        self.fuse_cap = self.rmax
        self.dense = int(dense_rounds)
        self.stages = tuple(tuple(s) for s in stages)
        # the schedule's total probe budget (overflow aborts past it)
        self.probe_budget = int(
            probe_budget
            if probe_budget is not None
            else (self.stages[-1][1] if self.stages else 64)
        )
        self._short = 0  # consecutive ramp passes under the cap
        self._full = 0  # consecutive ramp passes at the cap
        self._calm = 0  # consecutive low-pressure observations
        self._pressured = False  # dense was raised; never lower again
        # the max-probe value the last pressure raise responded to:
        # the engine feeds the RUN-LIFETIME max (a monotone maximum),
        # so without this anchor one transient deep flush would
        # re-fire the pressure branch every pass and ratchet
        # dense straight to MAX_DENSE
        self._raised_at = -1
        self.adjustments: List[Dict] = []

    # ------------------------------------------------------------ core

    def observe(
        self,
        *,
        levels_closed: int,
        cap_asked: int,
        max_probe_rounds: int,
    ) -> List[Dict]:
        """Feedback from one fused pass -> knob adjustments
        (possibly empty).  Each adjustment: ``{knob, from, to,
        reason}``."""
        out: List[Dict] = []
        out += self._observe_ramp(levels_closed, cap_asked)
        out += self._observe_probe(max_probe_rounds)
        self.adjustments += out
        return out

    def _emit(self, knob: str, old, new, reason: str) -> Dict:
        return {"knob": knob, "from": old, "to": new, "reason": reason}

    def _observe_ramp(self, closed: int, asked: int) -> List[Dict]:
        if asked <= 1:
            # steady state (or a cap of 1): no ramp signal this
            # pass; leave the streaks alone
            return []
        if closed < asked:
            self._short += 1
            self._full = 0
        else:
            self._full += 1
            self._short = 0
        if self._short >= HYSTERESIS and self.fuse_cap > 2:
            old = self.fuse_cap
            # shrink floor is 2, not 1: at cap 1 every later pass
            # reads as "no ramp signal" (asked <= 1 above) and the
            # full-batch recovery streak could never fire again — the
            # cap would ratchet down for the whole run
            self.fuse_cap = max(2, min(self.fuse_cap, max(closed, 2)))
            self._short = 0
            if self.fuse_cap != old:
                return [
                    self._emit(
                        "fuse_cap", old, self.fuse_cap,
                        f"ramp early-exit x{HYSTERESIS} "
                        f"(closed {closed} of {asked})",
                    )
                ]
        elif self._full >= HYSTERESIS and self.fuse_cap < self.rmax:
            old = self.fuse_cap
            self.fuse_cap = min(self.rmax, self.fuse_cap * 2)
            self._full = 0
            return [
                self._emit(
                    "fuse_cap", old, self.fuse_cap,
                    f"ramp sustained x{HYSTERESIS}",
                )
            ]
        return []

    def _observe_probe(self, max_probe: int) -> List[Dict]:
        # pressure: the running max probe depth is eating the budget —
        # raise dense rounds pre-emptively (more full-width rounds
        # settle more keys before the staged shrink can overflow).
        # ONE raise per observed max: the signal is a run-lifetime
        # maximum, so only a NEW high (genuinely deeper probing) may
        # escalate again.
        if (
            max_probe >= self.probe_budget // 2
            and self.dense < MAX_DENSE
            and max_probe > self._raised_at
        ):
            old = self.dense
            self.dense = min(MAX_DENSE, self.dense * 2)
            self._pressured = True
            self._raised_at = max_probe
            self._calm = 0
            return [
                self._emit(
                    "fpset_dense_rounds", old, self.dense,
                    f"probe pressure (max {max_probe} of "
                    f"budget {self.probe_budget})",
                )
            ]
        # calm: the table never probes past a couple of rounds —
        # spending 4 full-width rounds presents lanes for nothing
        if (
            not self._pressured
            and max_probe <= max(2, self.dense // 2)
            and self.dense > MIN_DENSE
        ):
            self._calm += 1
            if self._calm >= HYSTERESIS:
                old = self.dense
                self.dense = max(MIN_DENSE, self.dense // 2)
                self._calm = 0
                return [
                    self._emit(
                        "fpset_dense_rounds", old, self.dense,
                        f"low probe pressure (max {max_probe})",
                    )
                ]
        else:
            self._calm = 0
        return []
