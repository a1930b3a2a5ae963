"""Candidate cost prediction — the prune stage of the tuner; the
counterpart of ``pulsar_tlaplus_tpu/tune/predict.py``.

The cost model (``obs/attribution.py``) prices a run's measured work
units with per-backend unit costs.  Prediction runs the same pricing
over *predicted* work counts: one reference run at default knobs
measures the workload's work units once, and each candidate's counts
follow from how its knobs reshape the schedule — never the state space
(tuning changes batching, not semantics):

- ``expand_rows`` / ``append_rows`` / ``compact_elems``: the same for
  every candidate (fixed by the spec and constants).
- ``probe_lanes``: priced for the port's tiled flush, whose membership
  kernel K1 presents every lane for ``max(TILE_R, dense)`` rounds and
  whose insert tail runs until every survivor settles.  A candidate's
  ``fpset_dense_rounds`` at or below ``TILE_R`` changes nothing; above
  it the flush's lane cost scales with K1's rounds,
  ``max(TILE_R, d_new) / max(TILE_R, d_ref)`` (a stated upper bound:
  the whole flush unit is charged, not K1's share).  The stage limits
  only cap the tail's budget, so they are not priced.
- dispatch overhead: the fused level pays about one host read a
  steady-state level and one a ramp batch, so the reference run's level
  sizes and a candidate's ``fuse_group``/``sub_batch`` predict the
  reads; each is priced at the calibration's ``rtt_s`` or
  :data:`DEFAULT_DISPATCH_S`.
- padded capacity: every level pays at least one full window and one
  full flush, so oversizing the batch costs real compute.
- tiered runs: the spilled bytes at the link rate (``link_bytes_per_s``
  or :data:`DEFAULT_LINK_BYTES_S`), the cold-miss batches at one read
  each.

Where it differs from the JAX pricing: the JAX model scales probe lanes
by its staged schedule's lane factor (``schedule_lane_factor``: full
width for ``dense`` rounds, then 1/div a stage) and prices three kernel
routes a stage (``_impl_factor``); the port has one route a device and
the tiled flush's dense rule above.  The JAX ``"tpu"`` defaults are
not carried over: ``"cuda"`` takes the card's own per-read overhead and
device-to-host byte rate, measured by ``chip_smoke.py`` phase 49
(:data:`CUDA_LINK_SOURCE`).

Absolute seconds inherit the calibration's tolerance; the tuner only
needs the ranking to prune, and the survivors are measured.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from pulsar_tlaplus_tpu_torch.obs import attribution

# per-read host overhead when no calibration measured it: ~0.2 ms a
# local dispatch on the CPU (the JAX package's CPU figure); "cuda": the
# best of five ``.item()`` round trips after a launch (14.11 us; 11.29 us
# in another call), as CUDA_LINK_SOURCE says
DEFAULT_DISPATCH_S = {"cpu": 2e-4, "cuda": 1.411e-5}
# device-to-host byte rate of the tiered store's spill when no
# calibration measured it: memcpy speed on the CPU (the JAX package's
# CPU figure); "cuda": the best of three pageable ``.cpu()`` copies of
# 256 MiB (11.20 GB/s; 2.459 GB/s in another call: the host's pageable
# copy varies), as CUDA_LINK_SOURCE says
DEFAULT_LINK_BYTES_S = {"cpu": 2e9, "cuda": 1.12e10}
CUDA_LINK_SOURCE = (
    "chip_smoke.py phase 49 on NVIDIA H100 80GB HBM3, 700.00 W "
    "(obs.telemetry.measure_rtt; a 256 MiB pageable .cpu() copy)"
)

# nominal delta+zlib ratio when the reference ran uncompressed
_NOMINAL_SPILL_RATIO = 0.4

# the default dense rounds and the tiled flush's membership height
# (ops/fpset.py, ops/tiles.py; mirrored so this module imports no torch)
_DENSE_DEFAULT = 4
TILE_R = 8


def tiled_lane_factor(d_new: int, d_ref: int) -> float:
    """The port's flush cost of a candidate's dense rounds against the
    reference's: K1 runs ``max(TILE_R, dense)`` rounds."""
    return max(TILE_R, int(d_new)) / max(TILE_R, int(d_ref))


def ramp_dispatches(
    level_sizes: List[int], sub_batch: int, fuse_group: int
) -> Tuple[int, int]:
    """(ramp_levels, reads): consecutive levels whose frontier fits one
    window batch up to ``fuse_group`` a read; every other level is one
    read."""
    fg = max(int(fuse_group), 1)
    ramp = 0
    for sz in level_sizes:
        if sz > sub_batch:
            break
        ramp += 1
    steady = len(level_sizes) - ramp
    return ramp, -(-ramp // fg) + steady


def _per_dispatch(cal: dict, backend: str) -> float:
    return float(cal.get("rtt_s")
                 or DEFAULT_DISPATCH_S.get(backend,
                                           DEFAULT_DISPATCH_S["cuda"]))


def predict_candidate(
    cand: Dict,
    ref: Dict,
    cal: Optional[dict] = None,
) -> Dict[str, object]:
    """Predicted cost of one sparse candidate against a reference
    measurement (:func:`reference_of`): ``{est_s, est_work, dispatches,
    overhead_s, spill_s}``."""
    backend = ref.get("backend", "cpu")
    if cal is None:
        cal = attribution.default_calibration(backend)
    units = cal.get("units", {})
    work = dict(ref.get("work", {}))
    d_ref = int(ref.get("dense_rounds") or _DENSE_DEFAULT)
    d_new = int(cand.get("fpset_dense_rounds") or d_ref)
    if "probe_lanes" in work and d_new != d_ref:
        work["probe_lanes"] = int(
            work["probe_lanes"] * tiled_lane_factor(d_new, d_ref))
    est = 0.0
    for _stage, wkey, ukey, _lbl in attribution.STAGE_WORK:
        w = work.get(wkey[len("work_"):])
        u = units.get(ukey)
        if w and u is not None:
            est += w * u * 1e-9
    # the sort compaction re-sorts instead of log-shifting: about twice
    # the element cost on the compact stage
    if cand.get("compact_impl") == "sort":
        w = work.get("compact_elems")
        u = units.get("compact_elem_ns")
        if w and u is not None:
            est += w * u * 1e-9
    g = int(cand.get("sub_batch") or ref.get("sub_batch") or 1 << 16)
    fg = int(cand.get("fuse_group") or ref.get("fuse_group") or 8)
    levels = list(ref.get("level_sizes", ()))
    _ramp, disp = ramp_dispatches(levels, g, fg)
    # growth headroom: a flush group ahead of ``group`` windows; model
    # the growth reads as extra reads a level beyond one a pass
    ff = int(cand.get("flush_factor") or ref.get("flush_factor") or 1)
    grp = int(cand.get("group") or ref.get("group") or 4)
    lanes = float(work.get("probe_lanes") or 0)
    a = float(ref.get("A") or 1)
    acap = g * a * ff
    extra_syncs = lanes / acap / max(grp, 1) if acap > 0 else 0.0
    # padded capacity: every level pays one full window and one flush
    n_levels = max(len(levels), 1)
    rows_live = float(work.get("expand_rows") or 0)
    cand_lanes = rows_live * a
    windows = max(-(-rows_live // g) if g else 0, n_levels)
    flushes = max(-(-cand_lanes // acap) if acap else 0, n_levels)
    pad_rows = max(windows * g - rows_live, 0.0)
    pad_lanes = max(flushes * acap - cand_lanes, 0.0)
    u_row = units.get("expand_row_ns")
    u_lane = units.get("probe_lane_ns")
    if u_row is not None:
        est += pad_rows * u_row * 1e-9
    if u_lane is not None:
        est += pad_lanes * u_lane * 1e-9
    per_disp = _per_dispatch(cal, backend)
    # tiered runs: the reference's spill traffic is knob-invariant at a
    # fixed budget; the encoding and the miss batch width move it
    spill_s = 0.0
    raw = float(ref.get("spill_bytes_raw") or 0)
    if raw > 0:
        rate = float(cal.get("link_bytes_per_s")
                     or DEFAULT_LINK_BYTES_S.get(
                         backend, DEFAULT_LINK_BYTES_S["cuda"]))
        comp_ref = float(ref.get("spill_bytes_comp") or raw)
        ratio = comp_ref / raw if comp_ref < raw else _NOMINAL_SPILL_RATIO
        compress = cand.get("spill_compress")
        if compress is None:
            compress = bool(ref.get("spill_compress", True))
        bytes_cross = raw * ratio if compress else raw
        spill_s = bytes_cross / max(rate, 1.0)
        mb = int(cand.get("miss_batch") or ref.get("miss_batch")
                 or (1 << 15))
        misses = float(ref.get("spill_misses_resolved") or 0)
        spill_s += (misses / max(mb, 1)) * per_disp
    overhead = (disp + extra_syncs) * per_disp + spill_s
    return {
        "est_s": round(est + overhead, 6),
        "est_work": work,
        "dispatches": int(disp),
        "overhead_s": round(overhead, 6),
        "spill_s": round(spill_s, 6),
    }


def reference_of(ck, result) -> Dict[str, object]:
    """The reference measurement the predictor scales from: one
    default-knob run of the port's ``DeviceChecker`` and its result."""
    stats = getattr(ck, "last_stats", {}) or {}
    work = {k[len("work_"):]: int(v) for k, v in stats.items()
            if k.startswith("work_") and isinstance(v, (int, float))}
    return {
        "backend": "cpu" if ck.device.type == "cpu" else "cuda",
        "work": work,
        "level_sizes": [int(x) for x in result.level_sizes],
        "distinct_states": int(result.distinct_states),
        "wall_s": float(result.wall_s),
        # the port's G is the rows of a whole flush (sub_batch windows
        # times flush_factor)
        "sub_batch": int(ck.G // ck.FLUSH),
        "fuse_group": int(ck.RMAX),
        "flush_factor": int(ck.FLUSH),
        "group": int(ck.group),
        "A": int(ck.A),
        "dense_rounds": int(ck.fps_dense),
        "stages": tuple(tuple(s) for s in ck.fps_stages),
        "avg_probe_rounds": float(stats.get("fpset_avg_probe_rounds")
                                  or 1.0),
        "spill_bytes_raw": int(stats.get("spill_bytes_raw") or 0),
        "spill_bytes_comp": int(stats.get("spill_bytes_comp") or 0),
        "spill_misses_resolved": int(stats.get("spill_misses_resolved")
                                     or 0),
        "spill_compress": bool(getattr(ck, "spill_compress", True)),
        "miss_batch": int(getattr(ck, "miss_batch", 1 << 15)),
    }


def rank(cands: List[Dict], ref: Dict,
         cal: Optional[dict] = None) -> List[Tuple[Dict, Dict]]:
    """Every candidate priced and sorted cheapest first."""
    priced = [(c, predict_candidate(c, ref, cal)) for c in cands]
    priced.sort(key=lambda cp: cp[1]["est_s"])
    return priced


# ------------------------------------------------------- simulation


def predict_sim_candidate(
    cand: Dict,
    ref: Dict,
    cal: Optional[dict] = None,
) -> Dict[str, object]:
    """Predicted wall of one simulation candidate for a fixed step
    budget (``ref["total_steps"]``): every walker-step evaluates ``A``
    successor lanes (``expand_row_ns`` a lane-row) and ``n_inv``
    invariants (``probe_lane_ns`` each), plus one read a segment.
    ``ref``: {"backend", "A", "n_inv", "depth", "total_steps",
    "n_walkers", "segment_len"}."""
    backend = ref.get("backend", "cpu")
    if cal is None:
        cal = attribution.default_calibration(backend)
    units = cal.get("units", {})
    b = int(cand.get("n_walkers") or ref.get("n_walkers") or 1024)
    depth = int(ref.get("depth") or 64)
    seg = int(cand.get("segment_len") or ref.get("segment_len") or 32)
    seg = max(1, min(seg, depth))
    while depth % seg:  # the engine's divisor clamp
        seg -= 1
    total = int(ref.get("total_steps") or b * depth)
    a = float(ref.get("A") or 1)
    n_inv = float(ref.get("n_inv") or 0)
    u_row = float(units.get("expand_row_ns") or 0.0)
    u_lane = float(units.get("probe_lane_ns") or 0.0)
    est = total * (a * u_row + n_inv * u_lane) * 1e-9
    segments = max(-(-total // (b * seg)), 1)
    overhead = segments * _per_dispatch(cal, backend)
    return {
        "est_s": round(est + overhead, 6),
        "est_work": {"steps": total},
        "dispatches": int(segments),
        "overhead_s": round(overhead, 6),
    }


def rank_sim(cands: List[Dict], ref: Dict,
             cal: Optional[dict] = None) -> List[Tuple[Dict, Dict]]:
    """Simulation candidates priced and sorted cheapest first."""
    priced = [(c, predict_sim_candidate(c, ref, cal)) for c in cands]
    priced.sort(key=lambda cp: cp[1]["est_s"])
    return priced
