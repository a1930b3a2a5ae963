"""Import guard: the PyTorch port and ``chip_smoke.py`` import neither
JAX nor anything of the JAX package, and importing them builds or loads
no kernel."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["pulsar_tlaplus_tpu"] = None
import pulsar_tlaplus_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from pulsar_tlaplus_tpu_torch.kernels import build
assert not build._libs, "a kernel library was loaded at import time"
bad = [m for m in sys.modules if m == "jaxlib" or m.startswith(("jax.", "jaxlib."))]
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_no_jax():
    p = subprocess.run(
        [sys.executable, "-c", GUARD], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert p.returncode == 0, p.stderr
    names = set(p.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 20
    for mod in ("budget", "compress", "sieve", "tiers"):
        assert f"pulsar_tlaplus_tpu_torch.store.{mod}" in names
    for mod in ("subscription", "bookkeeper", "georeplication"):
        assert f"pulsar_tlaplus_tpu_torch.models.{mod}" in names
    for mod in ("engine.liveness", "engine.simulate", "sim", "sim.engine",
                "sim.rng"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
    for mod in ("frontend", "frontend.tla_ast", "frontend.lexer",
                "frontend.parser", "frontend.interp", "frontend.loader",
                "frontend.codegen_ir", "frontend.codegen", "frontend.record",
                "engine.interp_check"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
