"""The port's chaos drills (``scripts/torch_chaos.py``) on the CPU, against
the JAX package's ``scripts/chaos.py`` and the JAX engine's solo runs:

- the seeded schedules: ``build_schedule`` and ``build_fleet_schedule``
  give the JAX script's for seeds 0-199;
- the solo pins: the JAX engine's and the port's solo runs of the two
  drill workloads equal ``SOLO_PINS`` (the card's chip_smoke phases hold
  the card to the same pins);
- the pinned service drill (seed 1, ``drop@conn:2,torn@line:5,
  enospc@persist:2``, 2 clients x 1 job), the failover drill and the
  pinned fleet survivability drill (seed 0), each on a port daemon on the
  CPU with every job's record held to the JAX engine's solo run (the
  drills raise on any difference), each report's key set equal to the
  JAX drill's;
- ``main``: ``--cpu`` exits 0, no card and no ``--cpu`` exits 2 with "no
  CUDA device", in subprocesses;
- slow: the randomized service drills (seeds 3 and 11, 3 clients x 2
  jobs) and the fleet soak (a fresh seed, 3 clients x 2 jobs).

Tolerance: exact equality."""

import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from pulsar_tlaplus_tpu.service.scheduler import CheckerPool as JPool
from pulsar_tlaplus_tpu.service.scheduler import ServiceConfig as JConfig
from pulsar_tlaplus_tpu_torch.service.scheduler import (
    CheckerPool,
    ServiceConfig,
)
from pulsar_tlaplus_tpu_torch.utils import faults

# one intra-op thread a process: the suite runs a process a core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the key sets of the JAX drills' reports (read once from
# scripts/chaos.py's run_chaos, run_fleet_chaos and run_fleet_chaos_v2
# at the pinned arguments below)
SERVICE_KEYS = {"seed", "schedule", "admitted", "rejected", "completed",
                "faults_fired", "warm_quarantined", "streams_validated"}
REJECTED_KEYS = {"auth", "quota", "capacity"}
FLEET_V1_KEYS = {"seed", "owner", "replicated_wire_bytes", "resubmitted",
                 "warm_mode", "streams_validated"}
FLEET_V2_KEYS = {"seed", "schedule", "recovered", "reconciled_jobs",
                 "partitions", "replicated_wire_bytes", "streams_validated",
                 "trace_chains"}
PINNED_SCHEDULE = "drop@conn:2,torn@line:5,enospc@persist:2"


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jchaos():
    return _load_script("chaos")


@pytest.fixture
def chaos():
    """A fresh load of the port's script a test."""
    return _load_script("torch_chaos")


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    """No stray tuned profile reshapes a run, and no fault is armed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PTT_TUNE_DIR", str(tmp_path_factory.mktemp("profiles")))
        mp.delenv("PTT_TUNE_ADAPT", raising=False)
        mp.delenv("PTT_FAULT", raising=False)
        yield


@pytest.fixture
def sdir():
    # unix socket paths are capped at 107 bytes: a short directory
    d = tempfile.mkdtemp(prefix="pttc")
    yield d
    shutil.rmtree(d, ignore_errors=True)
    assert "PTT_FAULT" not in os.environ
    faults.reset()


@pytest.fixture(scope="module")
def jax_solos(jchaos):
    """The JAX engine's solo runs of the drill workloads at the drills'
    geometry, through the JAX ``CheckerPool``."""
    d = tempfile.mkdtemp(prefix="pttj")
    try:
        paths = {}
        for name, text in (("compaction", jchaos.SMALL_COMPACTION_CFG),
                           ("bookkeeper", jchaos.BK_CRASH2_CFG)):
            paths[name] = os.path.join(d, f"{name}.cfg")
            with open(paths[name], "w") as f:
                f.write(text)
        pool = JPool(JConfig(state_dir=os.path.join(d, "s"),
                             **jchaos.GEOM_FAST))
        return jchaos._solo_results(
            pool, {n: (n, p) for n, p in paths.items()})
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _pool(chaos, sdir):
    """A port pool of its own on the CPU, at the drills' geometry."""
    return CheckerPool(ServiceConfig(
        state_dir=os.path.join(sdir, "pool"), cpu=True, **chaos.GEOM_FAST))


def test_schedules_equal_jax(chaos, jchaos):
    for seed in range(200):
        assert chaos.build_schedule(seed) == jchaos.build_schedule(seed)
        assert chaos.build_fleet_schedule(seed) == \
            jchaos.build_fleet_schedule(seed)
    assert chaos.build_schedule(7, n=9, lo=3, hi=30) == \
        jchaos.build_schedule(7, n=9, lo=3, hi=30)
    for b, p in ((0, 1), (1, 1), (0, 7), (1, 17)):
        assert chaos._global_poll_n(b, p) == jchaos._global_poll_n(b, p)


def test_solo_pins(chaos, jax_solos, sdir):
    pool = _pool(chaos, sdir)
    cfgs = chaos._write_cfgs(sdir, bookkeeper=True)
    mine = chaos._solo_results(pool, {n: (n, p) for n, p in cfgs.items()})
    for name, pin in chaos.SOLO_PINS.items():
        assert chaos.solo_summary(jax_solos[name]) == pin
        assert chaos.solo_summary(mine[name]) == pin


def test_service_drill_pinned(chaos, jax_solos, sdir):
    """The JAX tier-1 drill's arguments; every admitted job's record is
    held to the JAX engine's solo run inside the drill."""
    report = chaos.run_chaos(
        os.path.join(sdir, "d"), seed=1, schedule=PINNED_SCHEDULE,
        pool=_pool(chaos, sdir), clients=2, jobs_per_client=1,
        solos=jax_solos, timeout_s=300.0, log=lambda m: None, cpu=True)
    assert set(report) == SERVICE_KEYS
    assert set(report["rejected"]) == REJECTED_KEYS
    assert report["completed"] == len(report["admitted"]) >= 3
    assert report["rejected"]["auth"] == 1
    assert report["rejected"]["quota"] >= 1
    assert report["streams_validated"] >= 3
    assert report["warm_quarantined"] >= 1
    # every scheduled fault fired, and the warm phase's corruption
    assert report["faults_fired"] == [
        ("drop", "conn", 2), ("torn", "line", 5), ("enospc", "persist", 2),
        ("corrupt", "warm", 1)]


def test_fleet_failover_drill(chaos, jax_solos, sdir):
    report = chaos.run_fleet_chaos(
        os.path.join(sdir, "d"), pool=_pool(chaos, sdir),
        solo=jax_solos["compaction"], log=lambda m: None, cpu=True)
    assert set(report) == FLEET_V1_KEYS
    assert report["resubmitted"] == 1
    assert report["replicated_wire_bytes"] > 0
    assert report["warm_mode"] in ("continue", "reseed")
    assert report["streams_validated"] == 3


def test_fleet_chaos_v2_pinned(chaos, jax_solos, sdir):
    state = os.path.join(sdir, "d")
    report = chaos.run_fleet_chaos_v2(
        state, seed=0, pool=_pool(chaos, sdir),
        solo=jax_solos["compaction"], clients=2, jobs_per_client=1,
        log=lambda m: None, cpu=True)
    assert set(report) == FLEET_V2_KEYS
    assert report["schedule"] == chaos.build_fleet_schedule(0)
    assert report["recovered"] == 2
    assert report["reconciled_jobs"] >= 1
    assert report["partitions"] >= 1
    assert report["replicated_wire_bytes"] > 0
    assert report["streams_validated"] == 3
    assert report["trace_chains"] >= 1
    assert os.path.exists(os.path.join(state, "fleet_trace.json"))


def _main(*args, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_chaos.py"),
         *args], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})})


def test_main_on_the_cpu(sdir):
    p = _main("--cpu", "--fleet-v1", "--state-dir", os.path.join(sdir, "d"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert "chaos: PASS" in p.stderr


def test_main_without_a_card(sdir):
    # an empty device list: no card, whatever the machine has
    p = _main("--state-dir", os.path.join(sdir, "d"),
              env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2, p.stderr[-2000:]
    assert "no CUDA device" in p.stderr
    assert not os.path.exists(os.path.join(sdir, "d"))


@pytest.mark.slow
@pytest.mark.parametrize("seed", [3, 11])
def test_service_drill_randomized(chaos, jax_solos, sdir, seed):
    report = chaos.run_chaos(
        os.path.join(sdir, "d"), seed=seed, pool=_pool(chaos, sdir),
        clients=3, jobs_per_client=2, solos=jax_solos, timeout_s=540.0,
        log=lambda m: None, cpu=True)
    assert report["completed"] == len(report["admitted"])
    want = []
    for spec in chaos.build_schedule(seed).split(","):
        kind, rest = spec.split("@")
        site, n = rest.split(":")
        want.append((kind, site, int(n)))
    assert sorted(report["faults_fired"][:-1]) == sorted(want)
    assert report["faults_fired"][-1][:2] == ("corrupt", "warm")


@pytest.mark.slow
def test_fleet_chaos_v2_random_soak(chaos, jax_solos, sdir):
    seed = int.from_bytes(os.urandom(2), "big")
    print(f"fleet chaos v2 soak seed: {seed}")
    report = chaos.run_fleet_chaos_v2(
        os.path.join(sdir, "d"), seed=seed, pool=_pool(chaos, sdir),
        solo=jax_solos["compaction"], clients=3, jobs_per_client=2,
        log=lambda m: None, cpu=True)
    assert report["recovered"] == 6
    assert report["reconciled_jobs"] >= 1
