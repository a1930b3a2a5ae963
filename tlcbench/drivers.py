"""The two general traffic drivers.  A traffic file's ``kind`` picks one;
its other keys are the driver's parameters.

``check``: one client, a closed loop of checks for the whole window,
each a fresh ``DeviceChecker(model, ...).run()`` with the defaults of
``cli check`` (fused level, the fpset visited set, no memory budget).
The check that runs when the window closes is stopped through
``time_budget_s`` and its states count.

``simulate``: one ``StreamingSimulator(model, n_walkers, depth,
seed=--seed, time_budget_s=--seconds).run()``.

The peak device memory is the program's: what the harness itself keeps
on the card for the verification (a kept check, the recorded walkers)
is left out of it (:class:`ProgramPeak`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tlcbench import tracing, verify


def make(kind: str, config, traffic, ref, dev, seed, model):
    try:
        cls = {"check": CheckDriver, "simulate": SimulateDriver}[kind]
    except KeyError:
        raise ValueError(f"unknown traffic kind {kind!r}") from None
    return cls(config, traffic, ref, dev, seed, model)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ProgramPeak:
    """The program's peak device memory over the window: the allocator's
    peak less the bytes the harness holds on the card.  The peak is read
    before and reset after each of the harness's own allocations, so
    each reading spans only a stretch over which the harness's bytes do
    not change."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.dev, self.held, self.peak = dev, 0, 0

    def start(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def read(self) -> int:
        if self.cuda:
            self.peak = max(self.peak, int(torch.cuda.max_memory_allocated(
                self.dev)) - self.held)
        return self.peak

    def hold(self, fn):
        """``fn()``, whose device allocations the harness keeps."""
        if not self.cuda:
            return fn()
        self.read()
        before = torch.cuda.memory_allocated(self.dev)
        out = fn()
        self.held += int(torch.cuda.memory_allocated(self.dev)) - before
        torch.cuda.reset_peak_memory_stats(self.dev)
        return out


def _read_trace(prof, tmp: str) -> Optional[dict]:
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    events = tracing.load_trace(path)
    os.unlink(path)
    return tracing.read_trace(events)


class _Driver:
    def __init__(self, config, traffic, ref, dev, seed, model):
        self.config, self.traffic, self.ref = config, traffic, ref
        self.dev, self.seed, self.model = dev, int(seed), model
        self.c = ref.consts(config["constants"])
        self.failed = 0  # outputs the verification found wrong

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


# -------------------------------------------------------------- check


# a traced check window holds this many checks
TRACE_CHECKS = 3


class CheckDriver(_Driver):
    def __init__(self, *a):
        super().__init__(*a)
        self.kw = dict(max_states=int(self.config.get("max_states")
                                      or 1 << 26),
                       invariants=tuple(self.config["invariants"]),
                       profile=None, device=self.dev)
        self.retained = None
        self.summaries: List[dict] = []

    def _run(self, model, budget=None):
        from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker

        ck = DeviceChecker(model, time_budget_s=budget, **self.kw)
        r = ck.run()
        return ck, r

    def setup(self) -> None:
        _ck, r = self._run(self.model)
        self.typical_s = r.wall_s

    def _summary(self, ck, r) -> dict:
        st = ck.last_stats
        return dict(distinct=r.distinct_states, level_sizes=list(r.level_sizes),
                    violation=r.violation, deadlock=bool(r.deadlock),
                    truncated=bool(r.truncated), stop_reason=r.stop_reason,
                    wall_s=r.wall_s, host_syncs=int(st.get("host_syncs", 0)),
                    expand_rows=int(st.get("work_expand_rows", 0)),
                    init_lanes=int(st.get("work_init_lanes", 0)),
                    append_rows=int(st.get("work_append_rows", 0)),
                    A=int(ck.A), W=int(ck.W), K=int(ck.K))

    def _retain(self, ck, r, peak: ProgramPeak) -> None:
        n, w = r.distinct_states, ck.W
        b = ck.last_bufs
        self.retained = peak.hold(lambda: dict(
            rows=b["rows"][: n * w].view(n, w).clone(),
            parent=b["parent"][:n].clone(), lane=b["lane"][:n].clone(),
            summary=self.summaries[-1]))

    def window(self, seconds: float, trace: bool, tmp: str) -> dict:
        # the kept check is drawn from those the window will finish, as
        # the warm check's wall (no shorter than a timed one) reckons them
        whole = max(1, int(seconds / self.typical_s) - 1)
        if trace:  # the traced window holds TRACE_CHECKS checks
            whole = min(whole, TRACE_CHECKS)
        keep = int(np.random.default_rng(self.seed).integers(whole))
        model = self.model
        if trace:
            model = tracing.TracedModel(model)
        prof = tracing.profiler() if trace else None
        win_rf = None
        ctx = tracing.patched_tiles() if trace else None
        if ctx is not None:
            ctx.__enter__()
        if prof is not None:
            prof.__enter__()
            win_rf = torch.profiler.record_function(tracing.WINDOW)
            win_rf.__enter__()
        _sync(self.dev)
        peak = ProgramPeak(self.dev)
        peak.start()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        done = 0
        last = None  # the last check, until the next one starts
        try:
            while True:
                left = deadline - time.perf_counter()
                if left <= 0 or (trace and done >= TRACE_CHECKS):
                    break
                budget = None if left > 2 * self.typical_s else left
                last = None
                ck, r = self._run(model, budget)
                self.summaries.append(self._summary(ck, r))
                self.typical_s = max(self.typical_s, r.wall_s)
                stopped = r.truncated and r.stop_reason == "time_budget"
                if not stopped:
                    done += 1
                    if done - 1 == keep:
                        self._retain(ck, r, peak)
                elif self.retained is None:  # fewer checks than ``keep``
                    self._retain(ck, r, peak)
                last = (ck, r)
                del ck
                if stopped:
                    break
            if self.retained is None and last is not None:
                self._retain(*last, peak)  # the window ended on a whole check
            last = None
            _sync(self.dev)
            elapsed = time.perf_counter() - t_start
        finally:
            if win_rf is not None:
                win_rf.__exit__(None, None, None)
            if prof is not None:
                prof.__exit__(None, None, None)
            if ctx is not None:
                ctx.__exit__(None, None, None)
        tr = _read_trace(prof, tmp) if prof is not None else None
        s = self.summaries
        return dict(
            elapsed_s=elapsed, peak_bytes=peak.read(), trace=tr,
            states=sum(x["distinct"] for x in s),
            checks=s, attempted=len(s), failed=0,
            notes=dict(checks=len(s), retained_check=s.index(
                self.retained["summary"]) if self.retained else None,
                check_walls_s=[round(x["wall_s"], 4) for x in s],
                harness_bytes=peak.held),
            log=dict(checks=f"{len(s)} checks, {sum(x['distinct'] for x in s)}"
                     f" states in {elapsed:.3f} s"))

    def verify(self) -> Dict[str, dict]:
        out = verify.check_window(self.ref, self.c, self.config,
                                  self.summaries, self.retained, self.seed)
        self.failed = out.pop("_failed_checks")
        self.retained = None
        return out


# ----------------------------------------------------------- simulate


# walkers held to the reference
WALKERS = 64


class _Recorder:
    """Keeps the sampled walkers' states at every step of every round:
    the inputs of ``successors``, ``depth`` calls a round, on the card
    and out of the program's peak."""

    def __init__(self, walkers: torch.Tensor, B: int, T: int,
                 peak: ProgramPeak):
        self.idx, self.B, self.T, self.peak = walkers, B, T, peak
        self.calls = 0
        self.snaps: List = []  # one state tuple of the walkers a call

    def __call__(self, states) -> None:
        from pulsar_tlaplus_tpu_torch.ops.packing import smap

        if states[0].shape[0] != self.B:
            return  # a replay of one walker
        self.calls += 1
        self.snaps.append(self.peak.hold(lambda: smap(
            lambda x: x.index_select(0, self.idx), states)))

    def walks(self, rounds: np.ndarray) -> List[dict]:
        """Walker ``i``'s states through round ``rounds[i]``, one dict
        of numpy fields (walkers first) a step.  A round the window did
        not finish gives the steps it recorded."""
        n = min(self.T, *(self.calls - r * self.T for r in rounds))
        out = []
        rows = torch.arange(len(rounds), device=self.idx.device)
        for j in range(n):
            calls = [self.snaps[int(r) * self.T + j] for r in rounds]
            out.append({k: torch.stack([getattr(c, k) for c in calls])[
                rows, rows].cpu().numpy() for k in calls[0]._fields})
        return out


class SimulateDriver(_Driver):
    def __init__(self, *a):
        super().__init__(*a)
        t = self.traffic
        self.B, self.T = int(t["n_walkers"]), int(t["depth"])
        self.result = None
        self.rec: Optional[_Recorder] = None

    def _sim(self, model, **kw):
        from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator

        return StreamingSimulator(model, n_walkers=self.B, depth=self.T, seed=self.seed,
                   profile=None, device=self.dev,
                   invariants=tuple(self.config["invariants"]), **kw)

    def setup(self) -> None:
        # one segment: the initial states and the step at full width
        self._sim(self.model, max_steps=1).run()

    def window(self, seconds: float, trace: bool, tmp: str) -> dict:
        rng = np.random.default_rng(self.seed)
        n = min(WALKERS, self.B)
        walkers = np.sort(rng.choice(self.B, size=n, replace=False))
        peak = ProgramPeak(self.dev)
        self.rec = _Recorder(torch.as_tensor(walkers, device=self.dev),
                             self.B, self.T, peak)
        model = tracing.TracedModel(self.model, ranges=trace,
                                    on_successors=self.rec)
        sim = self._sim(model, time_budget_s=seconds)
        prof = tracing.profiler() if trace else None
        win_rf = None
        if prof is not None:
            prof.__enter__()
            win_rf = torch.profiler.record_function(tracing.WINDOW)
            win_rf.__enter__()
        _sync(self.dev)
        peak.start()
        t_start = time.perf_counter()
        try:
            res = sim.run()
            _sync(self.dev)
            elapsed = time.perf_counter() - t_start
        finally:
            if win_rf is not None:
                win_rf.__exit__(None, None, None)
            if prof is not None:
                prof.__exit__(None, None, None)
        tr = _read_trace(prof, tmp) if prof is not None else None
        self.result = res
        # each sampled walker is held through a round drawn from the seed
        # among those the window finished (the first, if it finished none)
        whole = self.rec.calls // self.T
        self.rounds = rng.integers(max(1, whole), size=n)
        behaviors = self.B * -(-res.steps // (self.B * self.T))
        return dict(
            elapsed_s=elapsed, peak_bytes=peak.read(), trace=tr,
            steps=res.steps, walks=res.walks, attempted=behaviors, failed=0,
            notes=dict(n_walkers=self.B, depth=self.T, steps=res.steps,
                       segments=res.segments, stop_reason=res.stop_reason,
                       rounds_recorded=whole, sampled_walkers=n,
                       rounds_checked=len(set(self.rounds.tolist())),
                       harness_bytes=peak.held,
                       host_syncs=res.stats.get("host_syncs")),
            log=dict(sim=f"{res.steps} steps, {res.walks} walks in "
                     f"{elapsed:.3f} s, stop {res.stop_reason}"))

    def verify(self) -> Dict[str, dict]:
        snaps = self.rec.walks(self.rounds) if self.rec.calls else []
        out = verify.sim_window(self.ref, self.c, self.config, snaps,
                                self.result, self.T)
        self.failed = out.pop("_failed_walkers")
        self.rec = None
        return out
