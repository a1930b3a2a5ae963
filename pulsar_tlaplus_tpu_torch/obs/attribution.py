"""Cost attribution — work units -> estimated per-stage seconds — the
counterpart of ``pulsar_tlaplus_tpu/obs/attribution.py``.

The fused level runs a whole level's windows between two host reads,
so nothing times its stages.  Instead:

- the engines count per-stage **work units** (``ops/fpset.py``'s int64
  work vector, updated with tensor ops in the fused level and riding
  its reads; host-side in the stage loop), with the definitions of the
  JAX package;
- a **calibration** maps work units to seconds via per-backend unit
  costs (ns per row/lane/element), measured by
  ``scripts/torch_calibrate.py`` (a ``fuse="stage"`` +
  ``PTT_STAGE_TIMING=1`` run, RTT-corrected, divided by its own work
  counts);
- :func:`attribute` prices any run's work units with those costs, so a
  single default-mode fused run yields the per-stage table with no
  stage-loop rerun (``scripts/torch_telemetry_report.py
  --attribution``).

The liveness sweep gets the same treatment: merged-sort lanes,
gid-propagation pass-lanes and edge-compaction elements a chunk,
priced by one ``sweep_lane_ns`` unit (the split assumes equal cost a
lane — a stated approximation).

The backends are ``"cpu"`` and ``"cuda"``.  The ``"cpu"`` fallbacks
are the JAX package's order-of-magnitude anchors; the ``"cuda"``
fallbacks are what ``scripts/torch_calibrate.py`` printed on the card
named beside them.  A calibration file always wins, and the report
footnotes which source priced the table.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

from pulsar_tlaplus_tpu_torch.obs import report

CALIBRATION_VERSION = 1

# (stage, work key, unit-cost key, work-unit label) — the explorer's
# per-stage table rows, in the BASELINE stage order
STAGE_WORK: Tuple[Tuple[str, str, str, str], ...] = (
    ("expand", "work_expand_rows", "expand_row_ns", "rows"),
    ("flush", "work_probe_lanes", "probe_lane_ns", "lanes"),
    ("compact", "work_compact_elems", "compact_elem_ns", "elems"),
    ("append", "work_append_rows", "append_row_ns", "rows"),
    ("init", "work_init_lanes", "init_lane_ns", "lanes"),
)

# the sweep section's rows: (stage, cumulative-field on sweep records,
# unit-cost key, label).  One shared unit cost — see module docstring.
SWEEP_WORK: Tuple[Tuple[str, str, str, str], ...] = (
    ("sweep_sort", "sort_lanes", "sweep_lane_ns", "lanes"),
    ("sweep_prop", "prop_lanes", "sweep_lane_ns", "lanes"),
    ("sweep_compact", "compact_elems", "sweep_lane_ns", "elems"),
)

# Per-backend fallbacks (ns per unit).  "cpu": order-of-magnitude
# anchors (contiguous ~2-30 ns/elem, latency-bound ~17-480 ns/elem;
# expand rows carry a full unpack/successors/pack pipeline a row),
# uncalibrated.  "cuda": measured as CUDA_CALIBRATION_SOURCE says (the
# one initial state of that config carries a whole window's launches,
# hence init_lane_ns).
DEFAULT_UNIT_COSTS: Dict[str, Dict[str, float]] = {
    "cpu": {
        "expand_row_ns": 1500.0,
        "probe_lane_ns": 45.0,
        "compact_elem_ns": 12.0,
        "append_row_ns": 80.0,
        "init_lane_ns": 300.0,
        "sweep_lane_ns": 30.0,
    },
    "cuda": {
        "expand_row_ns": 637.829,
        "probe_lane_ns": 13.1699,
        "compact_elem_ns": 2.4177,
        "append_row_ns": 22.5015,
        "init_lane_ns": 2687000.0,
        "sweep_lane_ns": 3.3733,
    },
}
CUDA_CALIBRATION_SOURCE = (
    "scripts/torch_calibrate.py --sweep on the 253,361-state config, "
    "NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 47"
)
DEFAULT_SOURCES: Dict[str, str] = {
    "cpu": "defaults (uncalibrated — run scripts/torch_calibrate.py)",
    "cuda": f"defaults ({CUDA_CALIBRATION_SOURCE})",
}


def backend_of(events: List[dict]) -> str:
    """"cpu" or "cuda" from the run header's device string (unknown
    devices read as "cuda" — the accelerator defaults)."""
    hd = report.header(events) or {}
    dev = str(hd.get("device", "")).lower()
    return "cpu" if "cpu" in dev else "cuda"


def default_calibration(backend: str = "cpu") -> dict:
    return {
        "calibration_v": CALIBRATION_VERSION,
        "backend": backend,
        "source": DEFAULT_SOURCES.get(backend, DEFAULT_SOURCES["cuda"]),
        "units": dict(
            DEFAULT_UNIT_COSTS.get(backend, DEFAULT_UNIT_COSTS["cuda"])
        ),
    }


def save_calibration(path: str, cal: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cal, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_calibration(path: str) -> dict:
    with open(path) as f:
        cal = json.load(f)
    if not isinstance(cal, dict) or "units" not in cal:
        raise ValueError(
            f"{path}: not a calibration file (missing 'units')"
        )
    return cal


# ------------------------------------------------------- calibration


def _result_stats(events: List[dict]) -> dict:
    res = report.result(events) or {}
    return res.get("stats", {}) or {}


def work_units(events: List[dict]) -> Dict[str, int]:
    """The run's per-stage work-unit totals: the ``attribution``
    record(s) when present (v7) — MERGED across records, because a
    liveness stream carries the inner explorer's record AND the
    sweep's (sweep-only) record and neither may shadow the other —
    else the ``work_*`` keys of the result stats, else the summed
    per-dispatch ``fuse`` deltas — so a stream from a crashed run
    still attributes."""
    merged: Dict[str, int] = {}
    for e in events:
        if e.get("event") == "attribution" and isinstance(
            e.get("stages"), dict
        ):
            merged.update(
                {str(k): int(v) for k, v in e["stages"].items()}
            )
    if merged:
        return merged
    stats = _result_stats(events)
    out = {
        k[len("work_"):]: int(v)
        for k, v in stats.items()
        if k.startswith("work_") and isinstance(v, (int, float))
    }
    if out:
        return out
    acc: Dict[str, int] = {}
    for e in events:
        if e.get("event") != "fuse":
            continue
        for k in (
            "work_expand_rows", "work_probe_lanes",
            "work_compact_elems", "work_append_rows",
        ):
            if isinstance(e.get(k), (int, float)):
                acc[k[len("work_"):]] = acc.get(
                    k[len("work_"):], 0
                ) + int(e[k])
    return acc


def calibrate_from_events(
    events: List[dict], label: Optional[str] = None
) -> dict:
    """Unit costs from a ``fuse="stage"`` + ``PTT_STAGE_TIMING=1``
    reference run's stream: RTT-corrected measured stage seconds
    divided by the run's own work counts.  Stages whose work or timing
    is missing keep the backend default (footnoted in ``partial``)."""
    stats = _result_stats(events)
    work = work_units(events)
    split = report.stage_split(events)
    backend = backend_of(events)
    units = dict(
        DEFAULT_UNIT_COSTS.get(backend, DEFAULT_UNIT_COSTS["cuda"])
    )
    measured: List[str] = []
    missing: List[str] = []
    for stage, wkey, ukey, _lbl in STAGE_WORK:
        w = work.get(wkey[len("work_"):], 0)
        dev_s = (split.get(stage) or {}).get("device_s")
        if w and dev_s is not None and dev_s > 0:
            units[ukey] = round(dev_s * 1e9 / w, 4)
            measured.append(stage)
        else:
            missing.append(stage)
    hd = report.header(events) or {}
    return {
        "calibration_v": CALIBRATION_VERSION,
        "backend": backend,
        "device": hd.get("device"),
        "source": label or "calibrate_from_events",
        "rtt_s": stats.get("rtt_s"),
        "distinct_states": (report.result(events) or {}).get(
            "distinct_states"
        ),
        "measured_stages": measured,
        "defaulted_stages": missing,
        "calibrated_unix": round(time.time(), 1),
        "units": units,
    }


def sweep_calibrate_from_events(events: List[dict], cal: dict) -> dict:
    """Fold a liveness run's measured sweep wall into ``cal`` as
    ``sweep_lane_ns``: total sweep seconds (the span of its ``sweep``
    records) over total sweep work units."""
    sweeps = [e for e in events if e.get("event") == "sweep"]
    if not sweeps:
        return cal
    last = sweeps[-1]
    total = sum(
        int(last.get(f, 0) or 0)
        for _s, f, _u, _l in SWEEP_WORK
    )
    # the sweep's wall span on the stream's monotonic ``t`` axis (see
    # _sweep_span) — exploration time never inflates the unit cost
    span = _sweep_span(events) or 0.0
    if total and span > 0:
        cal = dict(cal)
        cal["units"] = dict(cal["units"])
        cal["units"]["sweep_lane_ns"] = round(span * 1e9 / total, 4)
        cal["sweep_source"] = (
            "sweep_calibrate_from_events (span from stream t axis, "
            "first-chunk table build included)"
        )
    return cal


# -------------------------------------------------------- attribution


def attribute(
    events: List[dict], cal: Optional[dict] = None
) -> List[Dict[str, object]]:
    """Per-stage attribution rows for one run's stream:
    ``[{stage, work, unit_label, unit_ns, est_s, measured_s}]``.
    ``measured_s`` is the RTT-corrected ``PTT_STAGE_TIMING`` figure
    when the stream carries one (the cross-check column) and None on
    zero-sync runs — which is the point: ``est_s`` needs no rerun."""
    if cal is None:
        cal = default_calibration(backend_of(events))
    units = cal.get("units", {})
    work = work_units(events)
    split = report.stage_split(events)
    rows: List[Dict[str, object]] = []
    for stage, wkey, ukey, lbl in STAGE_WORK:
        w = work.get(wkey[len("work_"):])
        if not w:
            continue
        unit = units.get(ukey)
        rows.append(
            {
                "stage": stage,
                "work": int(w),
                "unit_label": lbl,
                "unit_ns": unit,
                "est_s": (
                    round(w * unit * 1e-9, 4)
                    if unit is not None else None
                ),
                "measured_s": (split.get(stage) or {}).get("device_s"),
            }
        )
    return rows


def sweep_attribute(
    events: List[dict], cal: Optional[dict] = None
) -> List[Dict[str, object]]:
    """Sweep-section rows from the newest ``sweep`` record's
    cumulative work units (v7 streams)."""
    if cal is None:
        cal = default_calibration(backend_of(events))
    units = cal.get("units", {})
    sweeps = [e for e in events if e.get("event") == "sweep"]
    if not sweeps:
        return []
    last = sweeps[-1]
    rows: List[Dict[str, object]] = []
    for stage, field, ukey, lbl in SWEEP_WORK:
        w = last.get(field)
        if not isinstance(w, (int, float)) or not w:
            continue
        unit = units.get(ukey)
        rows.append(
            {
                "stage": stage,
                "work": int(w),
                "unit_label": lbl,
                "unit_ns": unit,
                "est_s": (
                    round(w * unit * 1e-9, 4)
                    if unit is not None else None
                ),
                "measured_s": None,
            }
        )
    if rows:
        span = _sweep_span(events)
        if span is not None:
            # one measured anchor for the whole sweep phase (span on
            # the stream's t axis — exploration time excluded)
            rows.append(
                {
                    "stage": "sweep (measured wall)",
                    "work": None, "unit_label": "", "unit_ns": None,
                    "est_s": None, "measured_s": round(span, 3),
                }
            )
    return rows


def _sweep_span(events: List[dict]) -> Optional[float]:
    """The sweep phase's wall span on the stream's monotonic ``t``
    axis: from the record preceding the first sweep chunk to the last
    chunk's record (the first chunk's table build rides in — stated
    approximation; exploration time is excluded)."""
    idx = [
        i for i, e in enumerate(events) if e.get("event") == "sweep"
    ]
    if not idx:
        return None
    first_i, last = idx[0], events[idx[-1]]
    t0 = float(
        events[first_i - 1].get("t", events[first_i].get("t", 0.0))
        if first_i else events[first_i].get("t", 0.0)
    )
    span = float(last.get("t", 0.0)) - t0
    return span if span > 0 else None


def render_attribution(
    streams: List[Tuple[str, List[dict]]], cal: Optional[dict] = None
) -> str:
    """Markdown attribution table over 1+ labelled streams — the
    BASELINE per-stage shape, priced from work units.  A stream that
    also carries ``PTT_STAGE_TIMING`` timings gets the measured
    cross-check column filled in."""
    lines: List[str] = []
    for lbl, events in streams:
        c = cal or default_calibration(backend_of(events))
        rows = attribute(events, c) + sweep_attribute(events, c)
        hd = report.header(events) or {}
        res = report.result(events) or {}
        lines.append(
            f"### {lbl} — {hd.get('engine', '?')} "
            f"(fuse={hd.get('fuse', '?')}, "
            f"{res.get('distinct_states', '?')} states, "
            f"wall {res.get('wall_s', '?')} s)"
        )
        lines.append("")
        if not rows:
            lines.append(
                "(no work-unit counters in this stream — pre-v7 run?)"
            )
            lines.append("")
            continue
        lines.append(
            "| Stage | work units | unit cost | est s | measured s |"
        )
        lines.append("|---|---|---|---|---|")
        tot_est = 0.0
        for r in rows:
            w = f"{r['work']:,} {r['unit_label']}" if r["work"] else "—"
            u = (
                f"{r['unit_ns']:.1f} ns"
                if r["unit_ns"] is not None else "—"
            )
            e = f"{r['est_s']:.3f}" if r["est_s"] is not None else "—"
            m = (
                f"{r['measured_s']:.3f}"
                if r["measured_s"] is not None else "—"
            )
            if r["est_s"]:
                tot_est += r["est_s"]
            lines.append(f"| {r['stage']} | {w} | {u} | {e} | {m} |")
        lines.append(
            f"| **total est** |  |  | **{tot_est:.3f}** |  |"
        )
        lines.append("")
        lines.append(
            f"(unit costs: {c.get('source', '?')}, backend "
            f"{c.get('backend', '?')}; estimates are device seconds — "
            "measured column appears only on PTT_STAGE_TIMING runs, "
            "RTT-corrected)"
        )
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"
