"""One run of one cell of the port's benchmark.

Everything that belongs to one configuration, traffic mix, metric,
layer or spec sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the binding (spec, CONSTANTS, invariants,
  the check's state cap) and the pins its verdict is held to;
- ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  general driver that reads them (``check`` or ``simulate``, below);
- ``metrics/<metric>.py``: ``read(ctx)``, the number or None;
- ``roofline/<layer>.py``: ``bytes_needed(counts)`` of a layer's work;
- ``reference/<spec>.py``: the spec's plain reference.

A run builds the model from the configuration through the port's own
parser and registry, warms the cell's binding once (``setup_s``), runs
the traffic for the window, reads the peak, frees the program's state,
and only then holds what the window produced against the reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may never be loaded (compared whole: the
# port's own name begins with the JAX package's)
BLOCKED = ("jax", "jaxlib", "flax", "pulsar_tlaplus_tpu")
# the port's environment switches that would reshape a run
PORT_ENV = ("PTT_HBM_BUDGET", "PTT_TUNE_ADAPT", "PTT_TUNE_DIR", "PTT_FAULT",
            "PTT_STAGE_TIMING")


class CellError(RuntimeError):
    """The run cannot produce a result (no card, a missing file, a
    module that may not load)."""


# ------------------------------------------------------------- lookup


def load_bench(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise CellError(f"{path} not found")
    return json.loads(path.read_text())


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise CellError(f"no workload {workload!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise CellError(f"{kind} {name!r}: {path} not found")
    return json.loads(path.read_text())


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise CellError(f"{kind} {name!r}: {path} not found")
    spec = importlib.util.spec_from_file_location(
        f"tlcbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """``metrics/<metric>.py``: ``read(ctx) -> float | None``."""
    return _module("metrics", metric)


def load_roofline(layer: str):
    """``roofline/<layer>.py``: ``bytes_needed(counts) -> int``."""
    return _module("roofline", layer)


def load_reference(spec: str):
    return importlib.import_module(f"tlcbench.reference.{spec}")


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics: those that list the cell, or list no cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def blocked_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BLOCKED)


def clean_env() -> None:
    """Keep the run's caches inside the checkout and switch off what
    would reshape the port's run from the environment."""
    for k in PORT_ENV:
        os.environ.pop(k, None)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


# -------------------------------------------------------------- model


def cfg_text(config: dict) -> str:
    """The binding as a TLC ``.cfg``, as a user writes it."""
    lines = ["CONSTANTS"]
    for k, v in config["constants"].items():
        if isinstance(v, bool):
            v = "TRUE" if v else "FALSE"
        elif isinstance(v, list):
            v = "{" + ", ".join(str(x) for x in v) + "}"
        lines.append(f"    {k} = {v}")
    lines += ["SPECIFICATION Spec", "INVARIANTS"]
    lines += [f"    {i}" for i in config["invariants"]]
    return "\n".join(lines) + "\n"


def build_model(config: dict):
    """The port's model of the binding, through its cfg parser and
    registry (what ``cli check SPEC -config CFG`` builds)."""
    from pulsar_tlaplus_tpu_torch.models import registry
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

    spec = Path(config["spec"]).stem
    model, _constants = registry.COMPILED[spec](cfgmod.parse_cfg(
        cfg_text(config)))
    return model


def card(chips: int):
    """The first card, or CellError when the machine has fewer cards
    than the cell asks for: the benchmark never runs on the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise CellError("no CUDA device: this benchmark runs only on a card")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell needs {chips} card(s), "
                        f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def device_info(dev, chips: int, peak: int) -> dict:
    import torch

    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                    count=chips, memory_peak_bytes=int(peak))
    return dict(platform="cpu", kind="cpu", count=1,
                memory_peak_bytes=int(peak))


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


# ------------------------------------------------------------ the run


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, require_card: bool = True, device=None,
             plant: Optional[Callable] = None, bench: Optional[dict] = None,
             overrides: Optional[dict] = None, out=None, err=None) -> dict:
    """Run ``workload`` once and return its result line (also printed:
    the compared numbers last on ``err``, the line last on ``out``).
    ``require_card=False`` with ``device`` runs the rest of a run
    elsewhere (the CPU tests); ``plant(driver)`` breaks the path under
    test before the window (the control and the fault tests);
    ``overrides`` replaces keys of the traffic file (the sweeps)."""
    from tlcbench import drivers

    out = out or sys.stdout
    err = err or sys.stderr
    bench = bench or load_bench()
    cell = cell_of(bench, workload)
    config = load_config(cell["config"])
    traffic = dict(load_traffic(cell["traffic"]), **(overrides or {}))
    import torch

    parts = {"import": time.perf_counter() - t0}
    if require_card:
        dev = card(int(cell["chips"]))
        torch.zeros(1, device=dev)  # the CUDA context
        parts["context"] = time.perf_counter() - t0
        from pulsar_tlaplus_tpu_torch.kernels import build as kernels

        kernels.load()  # built into build/torch_kernels/ on first use
        parts["kernels"] = time.perf_counter() - t0
    else:
        dev = torch.device(device or "cpu")
    ref = load_reference(config["reference"])
    driver = drivers.make(traffic["kind"], config, traffic, ref, dev, seed,
                          build_model(config))
    parts["model"] = time.perf_counter() - t0
    if plant is not None:
        plant(driver)
    driver.setup()
    setup_s = time.perf_counter() - t0
    parts["warm"] = setup_s
    with tempfile.TemporaryDirectory(prefix="tlcbench-") as tmp:
        window = driver.window(seconds, trace, tmp)
    peak = window["peak_bytes"]
    window.setdefault("log", {})["setup_s_at"] = {
        k: round(v, 3) for k, v in parts.items()}
    window["device_kind"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
    driver.release()
    t_ref = time.perf_counter()
    compared = driver.verify()
    window.setdefault("log", {})["reference_s"] = round(
        time.perf_counter() - t_ref, 3)
    bad = blocked_modules()
    if bad:
        raise CellError("modules that may not load were loaded: "
                        + ", ".join(bad))
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    ctx = SimpleNamespace(
        workload=workload, config=config, traffic=traffic, setup_s=setup_s,
        window=window, trace=window.get("trace"), roofline=load_roofline)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    chips = int(cell["chips"])
    dinfo = device_info(dev, chips, peak)
    tr = window.get("trace")
    if trace and tr is not None:
        dinfo.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    line = dict(correct=bool(correct), attempted=int(window["attempted"]),
                failed=int(window["failed"] + driver.failed), metrics=metrics,
                device=dinfo)
    if trace and tr is not None:
        line["breakdown"] = dict(device_ops=tr["device_ops"],
                                 idle_gaps=tr["idle_gaps"])
    line["notes"] = dict(window.get("notes", {}), power=power_limit()
                         if dev.type == "cuda" else None)
    line["compared"] = compared
    for k, v in window.get("log", {}).items():
        print(f"tlcbench: {k}: {v}", file=err)
    for name, v in compared.items():
        print(f"compared {name}: {v['value']} (limit {v['limit']})",
              file=err, flush=True)
    print(json.dumps(line), file=out, flush=True)
    return line
