"""TLA+ spec front end — the counterpart of ``pulsar_tlaplus_tpu/frontend``.

Pipeline: lexer -> parser (column-aware, TLA+ junction lists) -> AST ->
  * generic structural interpreter (host; the universal semantic oracle), and
  * finite-domain type inference -> packed layout -> batched PyTorch
    codegen (the device path), producing models with the same interface
    as the hand-written ones in :mod:`pulsar_tlaplus_tpu_torch.models`.
"""
