"""Run telemetry for the PyTorch port — the counterpart of
``pulsar_tlaplus_tpu/obs/``, the same stream schema record for record.

- :mod:`~pulsar_tlaplus_tpu_torch.obs.telemetry` — the emission side
  every engine (and ``ops/fpset.FPSet``) writes into: a versioned JSONL
  event stream, the progress heartbeat thread, and the round-trip probe;
- :mod:`~pulsar_tlaplus_tpu_torch.obs.schema` — the stream and
  bench-artifact validator;
- :mod:`~pulsar_tlaplus_tpu_torch.obs.report` — a stream back into the
  per-stage table and the BENCH keys, RTT-corrected;
- :mod:`~pulsar_tlaplus_tpu_torch.obs.attribution` — work units priced
  into per-stage seconds;
- :mod:`~pulsar_tlaplus_tpu_torch.obs.trace` — streams -> Chrome/Perfetto
  trace JSON;
- :mod:`~pulsar_tlaplus_tpu_torch.obs.metrics` — Prometheus text
  exposition from a stream;
- :mod:`~pulsar_tlaplus_tpu_torch.obs.top` — the ``cli.py top``
  renderer;
- :mod:`~pulsar_tlaplus_tpu_torch.obs.ledger` — the cross-run
  regression ledger.
"""
