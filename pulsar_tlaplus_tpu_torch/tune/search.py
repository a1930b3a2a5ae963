"""Offline search: predict -> measure -> persist (``cli tune``); the
counterpart of ``pulsar_tlaplus_tpu/tune/search.py``.

Enumerate the declared knob space, rank every candidate with the cost
model applied to predicted work counts (the prune), measure only the
top-K survivors with short real runs, interleaved min-of-N so drift
hits every candidate alike, and persist the winner as a tuned profile
keyed by config signature.  The all-default candidate is always
measured: it is the baseline the winner's margin is reported against,
and when the defaults win the profile records default knobs (margin 0).
A candidate whose run finds other states (or stops otherwise) than the
baseline's is dropped; one the engine refuses to build (a tiered budget
below its initial tiers, say) is skipped for the next prediction.

Device memory: the JAX loop keeps every candidate's checker, buffers
included, across the repetitions.  On the card one checker of the
bench's scaled binding peaks at tens of GiB, so here each checker's
device tensors are freed after its run (``DeviceChecker._free_buffers``)
and rebuilt by its next ``run()``: the search's peak stays near the
largest single run's.  On the card the provenance records both
(``tune_peak_bytes``, ``checker_peak_bytes``, from the caching
allocator's peak counters, which the search resets before each run).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

from pulsar_tlaplus_tpu_torch.obs import attribution
from pulsar_tlaplus_tpu_torch.tune import predict as tune_predict
from pulsar_tlaplus_tpu_torch.tune import profiles as tune_profiles
from pulsar_tlaplus_tpu_torch.tune import space as tune_space

# ctor-parameter knobs forwarded verbatim to DeviceChecker
_CTOR_KNOBS = (
    "sub_batch", "flush_factor", "group", "fuse_group",
    "fpset_dense_rounds", "fpset_stages", "compact_impl",
    "hbm_headroom", "spill_compress", "miss_batch",
)


class _Memory:
    """Peak device bytes of the measured runs on a card (inert on the
    CPU): the search's own peak above its start, and the largest peak of
    one run above what was allocated when it began."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.on = device is not None and device.type == "cuda"
        self.dev = device
        self.start = self.alloc() if self.on else 0
        self.tune_peak = self.checker_peak = 0

    def alloc(self) -> int:
        return self.torch.cuda.memory_allocated(self.dev)

    def run(self, fn):
        if not self.on:
            return fn()
        base = self.alloc()
        self.torch.cuda.reset_peak_memory_stats(self.dev)
        try:
            return fn()
        finally:
            peak = self.torch.cuda.max_memory_allocated(self.dev)
            self.tune_peak = max(self.tune_peak, peak - self.start)
            self.checker_peak = max(self.checker_peak, peak - base)

    def provenance(self) -> Dict:
        if not self.on:
            return {}
        return {"tune_peak_bytes": int(self.tune_peak),
                "checker_peak_bytes": int(self.checker_peak)}


def _mk_checker(model, invariants, cand: Dict, base_kw: Dict, **extra):
    from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker

    kw = dict(base_kw)
    kw.update({k: v for k, v in cand.items() if k in _CTOR_KNOBS})
    kw.update(extra)
    # the search measures knobs, never a stored profile
    return DeviceChecker(model, invariants=invariants, profile=None,
                         adapt=False, **kw)


def _winner(measured: Dict[str, float]) -> Tuple[str, Optional[float],
                                                 float]:
    base_s = measured.get("defaults")
    key = min(measured, key=lambda k: measured[k])
    margin = (base_s - measured[key]) / base_s * 100.0 if base_s else 0.0
    return key, base_s, margin


def _rows(order, by_key, measured, winner_key) -> List[Dict]:
    """Report rows: every measured candidate, then the head of the
    predicted ranking."""
    shown = [k for k in order if k in measured]
    shown += [k for k in order if k not in measured][:15]
    return [{"candidate": k, "est_s": by_key[k][1]["est_s"],
             "dispatches": by_key[k][1]["dispatches"],
             "measured_s": measured.get(k), "winner": k == winner_key}
            for k in shown]


def tune_device(
    model,
    *,
    invariants: Tuple[str, ...],
    spec_label: str = "?",
    base_kw: Optional[Dict] = None,
    sub_batch: Optional[int] = None,
    budget_s: Optional[float] = None,
    top_k: int = 4,
    repeat: int = 2,
    candidate_limit: Optional[int] = None,
    calibration: Optional[dict] = None,
    adapt: bool = False,
    stream_dir: Optional[str] = None,
    device=None,
    log=None,
) -> Tuple[dict, List[Dict]]:
    """One full search for the device engine.  Returns ``(profile,
    report_rows)``; the profile is already saved.  ``base_kw``: the
    workload's shape (``visited_cap``, ``frontier_cap``, ``max_states``,
    ``hbm_budget`` ...) shared by every run, naming no searched knob.
    ``sub_batch``: the base window the ``sub_batch`` multipliers scale
    and the defaults candidate runs at (default: the engine's); when
    given, the saved profile always carries the winner's window."""
    base_kw = dict(base_kw or {})
    clash = sorted(set(base_kw) & set(_CTOR_KNOBS))
    if clash:
        raise ValueError(f"base_kw pins searched knob(s) {clash} — drop "
                         "them or tune with a narrower space")
    _log = log or (lambda msg: None)
    if budget_s is not None:
        base_kw.setdefault("time_budget_s", budget_s)
    base_kw["device"] = device
    base = {"sub_batch": int(sub_batch)} if sub_batch else {}

    # ---- the reference run at default knobs (the baseline's first rep)
    t0 = time.perf_counter()
    ck = _mk_checker(model, invariants, base, base_kw,
                     telemetry=_stream(stream_dir, f"ref_{spec_label}"))
    mem = _Memory(ck.device)
    r0 = mem.run(ck.run)
    ref = tune_predict.reference_of(ck, r0)
    ck._free_buffers()
    _log(f"reference run: {r0.distinct_states} states in {r0.wall_s:.2f}s "
         "at default knobs")
    cal = calibration or attribution.default_calibration(ref["backend"])

    # ---- predict: rank the whole space, keep the top K.  Budgeted runs
    # also search the spill knobs
    cands = tune_space.candidates(model, base_sub_batch=ref["sub_batch"],
                                  limit=candidate_limit, spill=ck.tiered)
    ranked = tune_predict.rank(cands, ref, cal)
    by_key = {tune_space.describe(c): (c, p) for c, p in ranked}
    order = [tune_space.describe(c) for c, _p in ranked]
    # the measure set: the defaults and the K cheapest predictions the
    # engine accepts (a tiered budget refuses windows whose initial
    # tiers exceed it: the next prediction takes the slot)
    checkers: Dict[str, object] = {"defaults": ck}
    refused: List[str] = []
    for key in order:
        if len(checkers) > max(top_k, 0):
            break
        if key in checkers:
            continue
        try:
            checkers[key] = _mk_checker(
                model, invariants, {**base, **by_key[key][0]}, base_kw,
                telemetry=_stream(stream_dir, f"m_{spec_label}_{key}"))
        except ValueError as e:
            if not refused:
                _log(f"skipping {key}: the engine refuses it ({e})")
            refused.append(key)
    if len(refused) > 1:
        _log(f"skipped {len(refused)} refused candidate(s) in all")
    measure = list(checkers)
    _log(f"predicted {len(ranked)} candidate(s); measuring {len(measure)} "
         f"(top-{top_k} + baseline)")

    # ---- measure: interleaved min-of-N, one checker object a candidate,
    # its device tensors freed after every run
    walls: Dict[str, List[float]] = {k: [] for k in measure}
    results: Dict[str, object] = {}
    for rep in range(max(repeat, 1)):
        for key in measure:
            if rep == 0 and key == "defaults":
                walls[key].append(float(r0.wall_s))
                results[key] = r0
                continue
            mck = checkers[key]
            rr = mem.run(mck.run)
            mck._free_buffers()
            walls[key].append(float(rr.wall_s))
            results[key] = rr
    measured = {k: min(v) for k, v in walls.items() if v}
    # tuning must not change what was verified
    for key in list(measured):
        rr = results[key]
        if (rr.distinct_states != r0.distinct_states
                or rr.truncated != r0.truncated):
            _log(f"dropping {key}: run diverged from baseline "
                 f"({rr.distinct_states} vs {r0.distinct_states} states)")
            del measured[key]
    winner_key, base_s, margin = _winner(measured)
    winner = by_key[winner_key][0]
    _log(f"winner: {winner_key} at {measured[winner_key]:.3f}s "
         f"(baseline {base_s:.3f}s, margin {margin:+.1f}%)")

    # keyed by the engine's resolved invariants, so the profile resolves
    # for exactly the checkers this search measured
    sig = tune_profiles.profile_key(
        model=model, invariants=tuple(ck.invariant_names),
        engine="device_bfs", backend=ref["backend"], tiered=ck.tiered)
    knobs = {**base, **winner}
    if adapt:
        knobs["adapt"] = True
    profile = tune_profiles.build(
        sig=sig, engine="device_bfs", backend=ref["backend"], knobs=knobs,
        spec=spec_label,
        tuner={
            "winner": winner_key,
            "baseline_s": round(base_s, 4) if base_s else None,
            "winner_s": round(measured[winner_key], 4),
            "margin_pct": round(margin, 2),
            "candidates_predicted": len(ranked),
            "candidates_measured": len(measured),
            "dropped": sorted(set(measure) - set(measured)),
            "refused": refused,
            "measured_s": {k: round(v, 4) for k, v in measured.items()},
            "repeat": max(repeat, 1),
            "search_wall_s": round(time.perf_counter() - t0, 2),
            "distinct_states": int(r0.distinct_states),
            "calibration_source": cal.get("source"),
            **mem.provenance(),
        },
    )
    tune_profiles.save(profile)
    return profile, _rows(order, by_key, measured, winner_key)


def tune_sim(
    model,
    *,
    invariants: Tuple[str, ...],
    spec_label: str = "?",
    depth: int = 64,
    total_steps: Optional[int] = None,
    top_k: int = 3,
    repeat: int = 2,
    calibration: Optional[dict] = None,
    stream_dir: Optional[str] = None,
    device=None,
    log=None,
) -> Tuple[dict, List[Dict]]:
    """The simulation search (``cli tune --mode simulate``): predict the
    ``SIM_KNOBS`` space at a fixed swarm-total step budget, measure the
    top K interleaved min-of-N, persist the winner as an ``engine="sim"``
    profile the simulator resolves at construction.  The objective is
    wall seconds for the same step budget."""
    from pulsar_tlaplus_tpu_torch.sim.engine import StreamingSimulator

    _log = log or (lambda msg: None)
    t0 = time.perf_counter()
    total = int(total_steps or 1024 * depth * 4)

    def _mk(cand: Dict):
        return StreamingSimulator(
            model, invariants=tuple(invariants),
            n_walkers=cand.get("n_walkers", 1024), depth=depth,
            segment_len=cand.get("segment_len"), max_steps=total,
            device=device,
            telemetry=_stream(stream_dir, f"sim_{spec_label}_"
                              f"{tune_space.describe(cand)}"),
            profile=None,  # the search must not load what it writes
        )

    first = _mk({})
    backend = tune_profiles.default_backend(first.device)
    ref = {
        "backend": backend,
        "A": int(getattr(model, "A", 1)),
        "n_inv": len(tuple(invariants)
                     or tuple(getattr(model, "default_invariants", ()))),
        "depth": int(depth),
        "total_steps": total,
        "n_walkers": 1024,
        "segment_len": min(depth, 32),
    }
    cal = calibration or attribution.default_calibration(backend)
    ranked = tune_predict.rank_sim(tune_space.sim_candidates(), ref, cal)
    by_key = {tune_space.describe(c): (c, p) for c, p in ranked}
    order = [tune_space.describe(c) for c, _p in ranked]
    measure = ["defaults"] + [k for k in order
                              if k != "defaults"][: max(top_k, 0)]
    _log(f"sim predict: {len(ranked)} candidate(s); measuring "
         f"{len(measure)} (top-{top_k} + baseline)")
    sims = {k: (first if k == "defaults" else _mk(by_key[k][0]))
            for k in measure}
    walls: Dict[str, List[float]] = {k: [] for k in measure}
    steps_ps: Dict[str, float] = {}
    for _rep in range(max(repeat, 1)):
        for key in measure:
            rr = sims[key].run()
            walls[key].append(float(rr.wall_s))
            steps_ps[key] = max(steps_ps.get(key, 0.0),
                                float(rr.steps_per_sec))
    measured = {k: min(v) for k, v in walls.items() if v}
    winner_key, base_s, margin = _winner(measured)
    winner = by_key[winner_key][0]
    _log(f"sim winner: {winner_key} at {measured[winner_key]:.3f}s "
         f"(baseline {base_s:.3f}s, margin {margin:+.1f}%)")
    sig = tune_profiles.profile_key(
        model=model, invariants=tuple(first.invariant_names),
        engine="sim", backend=backend)
    profile = tune_profiles.build(
        sig=sig, engine="sim", backend=backend, knobs=dict(winner),
        spec=spec_label,
        tuner={
            "winner": winner_key,
            "baseline_s": round(base_s, 4) if base_s else None,
            "winner_s": round(measured[winner_key], 4),
            "margin_pct": round(margin, 2),
            "candidates_predicted": len(ranked),
            "candidates_measured": len(measured),
            "measured_s": {k: round(v, 4) for k, v in measured.items()},
            "repeat": max(repeat, 1),
            "total_steps": total,
            "depth": depth,
            "steps_per_sec": {k: round(v, 1) for k, v in steps_ps.items()},
            "search_wall_s": round(time.perf_counter() - t0, 2),
            "calibration_source": cal.get("source"),
        },
    )
    tune_profiles.save(profile)
    return profile, _rows(order, by_key, measured, winner_key)


def _stream(stream_dir: Optional[str], label: str) -> Optional[str]:
    if not stream_dir:
        return None
    os.makedirs(stream_dir, exist_ok=True)
    safe = "".join(c if c.isalnum() else "_" for c in label)[:60]
    return os.path.join(stream_dir, f"tune_{safe}.jsonl")


def render_report(profile: dict, rows: List[Dict]) -> str:
    """The tune report: predicted against measured (pruned candidates
    show a measured "—"), then the persisted winner."""
    t = profile.get("tuner", {})
    lines = [
        f"tuned profile {profile['sig']} ({profile.get('spec')}, "
        f"engine {profile['engine']}, backend {profile['backend']})",
        f"predicted {t.get('candidates_predicted')} candidate(s), "
        f"measured {t.get('candidates_measured')} "
        f"(interleaved min-of-{t.get('repeat')})",
        "",
        "| candidate | predicted s | dispatches | measured s |",
        "|---|---|---|---|",
    ]
    for r in rows:
        m = f"{r['measured_s']:.3f}" if r["measured_s"] is not None else "—"
        star = " *" if r.get("winner") else ""
        lines.append(f"| {r['candidate']}{star} | {r['est_s']:.4f} "
                     f"| {r['dispatches']} | {m} |")
    lines.append("")
    lines.append(
        f"winner: {t.get('winner')} — baseline {t.get('baseline_s')}s "
        f"-> {t.get('winner_s')}s ({t.get('margin_pct'):+.1f}%)")
    return "\n".join(lines)
