"""The cost-model-driven tuner of the port — the counterpart of
``pulsar_tlaplus_tpu/tune/``.

- **offline search** (``cli tune`` -> :mod:`tune.search` over
  :mod:`tune.space` and :mod:`tune.predict`): rank the knob space with
  the calibrated cost model, measure the top K with short interleaved
  runs, persist the winner as a profile;
- **profile loading** (:mod:`tune.profiles`): ``DeviceChecker``,
  ``LivenessChecker`` and the simulator resolve a profile by config
  signature at construction — explicit knobs win, and
  ``run_header.profile_sig`` attributes the run;
- **online adaptation** (:mod:`tune.online`): a controller at the fused
  level's pass boundaries moves the ramp cap and the probe schedule
  from what the pass's read brought back.

Every knob moves schedules and batching only, never the states found or
their order.
"""

from pulsar_tlaplus_tpu_torch.tune import online, predict, profiles, space

__all__ = ["online", "predict", "profiles", "space"]
