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
import importlib.util
for script in ("torch_calibrate", "torch_telemetry_report",
               "torch_check_telemetry_schema"):
    spec = importlib.util.spec_from_file_location(script, f"scripts/{script}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from pulsar_tlaplus_tpu_torch.kernels import build
assert not build._libs, "a kernel library was loaded at import time"
from pulsar_tlaplus_tpu_torch import native
assert native._lib is None, "the native log store was loaded at import time"
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
    for mod in ("utils.ckpt", "utils.faults", "utils.recovery"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
    for mod in ("parallel", "parallel.mesh", "engine.sharded_device"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
    for mod in ("native", "engine.statelog", "engine.sharded",
                "ops.hashtable", "utils.metrics"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
    for mod in ("obs", "obs.telemetry", "obs.schema", "obs.report",
                "obs.attribution", "obs.trace", "obs.metrics", "obs.top",
                "obs.ledger"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
    for mod in ("tune", "tune.space", "tune.profiles", "tune.predict",
                "tune.online", "tune.search"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
    for mod in ("warm", "warm.store", "warm.plan", "service",
                "service.jobs", "service.protocol", "service.auth",
                "service.admission", "service.scheduler", "service.server",
                "service.client"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
    for mod in ("fleet", "fleet.replicate", "fleet.registry",
                "fleet.dispatcher"):
        assert f"pulsar_tlaplus_tpu_torch.{mod}" in names
