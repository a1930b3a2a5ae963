"""The benchmark of the PyTorch and CUDA port (``pulsar_tlaplus_tpu_torch``):
``python3 tlcbench/run.py --workload NAME --seed N --seconds S --trace 0|1``."""
