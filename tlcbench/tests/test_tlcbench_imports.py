"""Nothing that ``tlcbench/run.py`` loads imports JAX or the JAX
package (top-level names compared whole: ``pulsar_tlaplus_tpu_torch``
begins with ``pulsar_tlaplus_tpu``)."""

import json
import subprocess
import sys

from tlcbench import harness

PROBE = r"""
import glob, importlib, json, os, sys
sys.path.insert(0, os.getcwd())
from tlcbench import harness, drivers, verify, tracing, control, pins
from tlcbench.reference import compaction, georeplication
for p in sorted(glob.glob("tlcbench/metrics/*.py")):
    name = os.path.basename(p)[:-3]
    if name != "__init__":
        harness.load_reader(name)
for p in sorted(glob.glob("tlcbench/roofline/*.py")):
    name = os.path.basename(p)[:-3]
    if name != "__init__":
        harness.load_roofline(name)
# what a run loads of the port
from pulsar_tlaplus_tpu_torch.kernels import build
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator
from pulsar_tlaplus_tpu_torch.ops import tiles
for name in ("compaction-scaled", "georeplication-scaled-exact"):
    harness.build_model(harness.load_config(name))
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in harness.BLOCKED)))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_run_py_loads_imports_jax():
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    blocked, tops = (json.loads(x) for x in p.stdout.splitlines()[-2:])
    assert blocked == []
    assert "pulsar_tlaplus_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "pulsar_tlaplus_tpu"} & set(tops)


def test_the_guard_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["pulsar_tlaplus_tpu_torch_x"] = sys
        sys.modules.pop("pulsar_tlaplus_tpu", None)
        assert "pulsar_tlaplus_tpu_torch_x" not in harness.blocked_modules()
        sys.modules["pulsar_tlaplus_tpu.ops"] = sys
        assert "pulsar_tlaplus_tpu.ops" in harness.blocked_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
