"""PyTorch/CUDA port of the compaction-spec model checker.

The counterpart of ``pulsar_tlaplus_tpu`` for an NVIDIA Hopper card: the
same packed-state BFS (init -> expand -> flush -> compact -> append) in
batched PyTorch, with the expand key plane and the flush membership probe
as hand-written CUDA kernels (``kernels/csrc``).  The package imports
nothing of the JAX package; the pure-Python modules it needs (the oracle,
the cfg parser, the trace renderer) are copied.

Words and fingerprint keys are uint32 values held as int32 bit patterns
(SENTINEL is -1), so a table or row store costs what it does in JAX.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
