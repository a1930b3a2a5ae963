"""The port's differential fuzz harness (``scripts/torch_fuzz.py``) on the
CPU, against the JAX package's ``scripts/fuzz.py``:

- sampler parity: seeds 0-9 x the four specs x 3 draws give the JAX
  sampler's field values (and leave the RNG in the same state);
- the pinned drill: ``run(seed=0, per_spec=1)`` on the CPU has 4
  records, 0 failures and both verdict classes;
- record equality: seed 0's compaction and bookkeeper bindings give the
  JAX ``fuzz_one`` record's ``device`` and ``interp`` summaries;
- the widen drill: bookkeeper, seed 5, plans ``reseed`` with rows
  replayed and reused (the geometry of ``tests/test_warm.py``'s drill);
- planted faults (a device diameter off by one, a dropped trace step)
  give a failure record and exit code 1 from ``main``; no card and no
  ``--cpu`` is a usage error;
- the slow soak: ``run(20, 20)`` and ``run_widen(20, 20)``.

Tolerance: exact equality (integer counts, field values)."""

import dataclasses
import importlib.util
import os
import random

import pytest
import torch

# one intra-op thread a process: the suite runs a process a core, and
# torch's default of a thread a core in each process oversubscribes it
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ("compaction", "bookkeeper", "georeplication", "subscription")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fuzz():
    """A fresh load of the port's harness a test (a test may set its
    ``DEVICE_KW`` or patch its functions)."""
    return _load_script("torch_fuzz")


def _quiet(_msg):
    pass


def _seed_binding(mod, seed, want):
    """The binding of spec ``want`` in ``run(seed, per_spec=1)`` (one
    shared RNG over the specs in order, invalid draws resampled)."""
    rng = random.Random(seed)
    for spec in SPECS:
        while True:
            c = mod.sample_binding(spec, rng)
            try:
                c.validate()
            except ValueError:
                continue
            break
        if spec == want:
            return c


@pytest.mark.parametrize("spec", SPECS)
def test_sampler_draws_the_jax_bindings(fuzz, spec):
    jfuzz = _load_script("fuzz")
    for seed in range(10):
        rj, rt = random.Random(seed), random.Random(seed)
        for _ in range(3):
            cj, ct = jfuzz.sample_binding(spec, rj), fuzz.sample_binding(
                spec, rt)
            assert type(ct).__module__.startswith("pulsar_tlaplus_tpu_torch.")
            assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert rt.getstate() == rj.getstate()


def test_pinned_drill(fuzz):
    records, failures = fuzz.run(seed=0, per_spec=1, log=_quiet,
                                 device="cpu")
    assert len(records) == 4
    assert failures == [], failures
    verdicts = {r["device"]["violation"] for r in records}
    assert None in verdicts and len(verdicts) > 1


@pytest.mark.parametrize("spec", ["compaction", "bookkeeper"])
def test_record_equals_the_jax_harness(fuzz, spec):
    jfuzz = _load_script("fuzz")
    cj, ct = _seed_binding(jfuzz, 0, spec), _seed_binding(fuzz, 0, spec)
    want = jfuzz.fuzz_one(spec, cj)
    got = fuzz.fuzz_one(spec, ct, device="cpu")
    assert got["mismatches"] == want["mismatches"] == []
    for key in ("binding", "invariants", "device", "interp"):
        assert got[key] == want[key], key


def test_widen_drill(fuzz):
    fuzz.DEVICE_KW = dict(sub_batch=64, visited_cap=1 << 10,
                          frontier_cap=1 << 8, max_states=1 << 18)
    records, failures = fuzz.run_widen(seed=5, per_spec=1,
                                       specs=("bookkeeper",), log=_quiet,
                                       device="cpu")
    assert failures == []
    (rec,) = records
    assert (rec.get("plan") or {}).get("mode") == "reseed"
    assert rec["reseed"]["replay_rows"] >= 1
    assert rec["reseed"]["reused_rows"] >= 1
    assert rec["warm"]["violation"] == rec["cold"]["violation"]


def _diameter_plus_one(real):
    def device_result(*a, **k):
        r = real(*a, **k)
        r.diameter += 1
        return r
    return device_result


def _drop_a_step(real):
    def device_result(*a, **k):
        r = real(*a, **k)
        if r.trace:
            del r.trace[1], r.trace_actions[0]
        return r
    return device_result


@pytest.mark.parametrize("fault,spec,why", [
    (_diameter_plus_one, "georeplication", "diameter: device=15 interp=14"),
    (_drop_a_step, "bookkeeper", "trace length: device=5 interp=6"),
])
def test_planted_fault_fails_the_run(fuzz, fault, spec, why, capsys):
    fuzz.device_result = fault(fuzz.device_result)
    rc = fuzz.main(["--seed", "0", "--per-spec", "1", "--spec", spec,
                    "--cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    assert why in err and "1 binding(s), 1 mismatch(es)" in err
    if fault is _drop_a_step:
        assert "device trace replay: step" in err


def test_no_card_without_cpu_is_refused(fuzz, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness runs there")
    with pytest.raises(SystemExit) as e:
        fuzz.main(["--per-spec", "1"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.device_result("georeplication",
                           fuzz.sample_binding("georeplication",
                                               random.Random(0)), ())


@pytest.mark.slow
def test_fuzz_soak_slow_lane(fuzz):
    _records, failures = fuzz.run(20, 20, log=_quiet, device="cpu")
    assert failures == []
    _records, failures = fuzz.run_widen(20, 20, log=_quiet, device="cpu")
    assert failures == []
