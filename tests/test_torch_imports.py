"""Import guard: the PyTorch port, its ``scripts/torch_*.py`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package,
and importing them builds or loads no kernel; the fuzz harness and the
native baseline also run with both blocked."""

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
               "torch_check_telemetry_schema", "torch_fuzz", "torch_chaos"):
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


# the fuzz harness and the native baseline import their parts inside
# the functions that use them: run them, not only load them
RUN_GUARD = r"""
import importlib.util, sys
sys.modules["jax"] = None
sys.modules["pulsar_tlaplus_tpu"] = None
import torch
torch.set_num_threads(1)
spec = importlib.util.spec_from_file_location("torch_fuzz", "scripts/torch_fuzz.py")
fuzz = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fuzz)
records, failures = fuzz.run(seed=0, per_spec=1, log=lambda m: None,
                             device="cpu")
assert len(records) == 4 and not failures, failures
fuzz.DEVICE_KW = dict(sub_batch=64, visited_cap=1 << 10,
                      frontier_cap=1 << 8, max_states=1 << 18)
records, failures = fuzz.run_widen(seed=5, per_spec=1, specs=("bookkeeper",),
                                   log=lambda m: None, device="cpu")
assert records[0]["plan"]["mode"] == "reseed" and not failures, records
from pulsar_tlaplus_tpu_torch import native
r = native.run_baseline(2, 1, 1, 3, 1, False, True, 60.0, table_log2=16,
                        with_levels=True)
assert (r["distinct_states"], r["levels"]) == (992, 20), r
bad = [m for m in sys.modules if m == "jaxlib" or m.startswith(("jax.", "jaxlib.", "pulsar_tlaplus_tpu."))]
assert not bad, bad
print("ok")
"""


def test_fuzz_harness_and_baseline_run_without_jax():
    p = subprocess.run(
        [sys.executable, "-c", RUN_GUARD], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},
    )
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "ok"
