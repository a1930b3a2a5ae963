"""``correct`` on small bindings on the CPU: true for the program as it
is, false for the control and for each fault a cell can have, with the
rest of a run driven as on the card (the card check skipped)."""

import io
import time

import pytest

from tlcbench import control
from tlcbench.tests.conftest import SMALL_BENCH

CHECKS = ["cs.check", "cc.check", "gs.check"]


def _run(harness, workload, plant, seconds=1.5, seed=2**31 + 12345):
    out, err = io.StringIO(), io.StringIO()
    line = harness.run_cell(workload, seed, seconds, False,
                            time.perf_counter(), require_card=False,
                            device="cpu", plant=control.plant(plant),
                            bench=SMALL_BENCH,
                            overrides=({"n_walkers": 512}
                                       if "simulate" in workload else None),
                            out=out, err=err)
    # the compared numbers are the last lines of standard error
    tail = err.getvalue().strip().splitlines()[-len(line["compared"]):]
    assert all(t.startswith("compared ") for t in tail)
    return line


@pytest.mark.parametrize("workload", CHECKS + ["cc.simulate"])
def test_sound_runs_are_correct(small, workload):
    line = _run(small, workload, "none")
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("workload", CHECKS + ["cc.simulate"])
def test_the_control_is_not_correct(small, workload):
    line = _run(small, workload, "control")
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CHECKS + ["cc.simulate"])
def test_each_fault_is_not_correct(small, workload, fault):
    line = _run(small, workload, fault)
    assert not line["correct"], line["compared"]


class _LateFault:
    """The model, sound through the window's first ``after`` calls of
    ``successors`` and with every lane returning its state unchanged
    from then on."""

    def __init__(self, model, after: int):
        self._inner, self._after, self._calls = model, after, 0
        self._bad = control._Faulty(model, "unchanged")

    def successors(self, states):
        self._calls += 1
        m = self._bad if self._calls > self._after else self._inner
        return m.successors(states)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_a_fault_after_the_first_round_is_not_correct(small):
    """Walks are held through rounds drawn from all those the window
    finished, so a fault that starts with the second round shows."""
    depth = 8

    def plant(driver):
        window = driver.window

        def late(*a, **k):
            driver.model = _LateFault(driver.model, depth)
            return window(*a, **k)

        driver.window = late

    line = small.run_cell("cc.simulate", 2**31 + 777, 1.5, False,
                          time.perf_counter(), require_card=False,
                          device="cpu", plant=plant, bench=SMALL_BENCH,
                          overrides={"n_walkers": 64, "depth": depth},
                          out=io.StringIO(), err=io.StringIO())
    assert line["notes"]["rounds_recorded"] >= 2
    assert line["notes"]["rounds_checked"] >= 2
    assert not line["correct"], line["compared"]
