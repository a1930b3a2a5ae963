"""The tiered state store — the counterpart of ``pulsar_tlaplus_tpu/store``
(RAM tier only): the device can hold a budgeted hot tier while the
visited set, rows and trace logs outgrow it.

- :mod:`budget` — the ``-hbm-budget`` / ``PTT_HBM_BUDGET`` knob;
- :mod:`sieve` — the device-side ops (generation tagging, cold-key
  extraction with the sieve-mask kernel K3, miss-verdict unflagging);
- :mod:`compress` — delta-encoded sorted key planes and packed payloads;
- :mod:`tiers` — the host-side :class:`~tiers.TieredStore`: cold key
  runs and row/log segments in host RAM, batched miss resolution.
"""
