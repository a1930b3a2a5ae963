"""Flight deck: telemetry streams -> Chrome trace-event JSON (Perfetto).

Any telemetry stream this repo writes — a single engine run, the
liveness two-phase stream, a checker daemon's ``service.jsonl``, or the
per-job ``jobs/<id>/events.jsonl`` files — renders onto ONE unified
timeline viewable in https://ui.perfetto.dev (or ``chrome://tracing``):

- **BFS levels** as nested duration spans per engine run (a ``level``
  record closes the span the previous level record opened), with
  ``states_per_sec`` / ``distinct_states`` counter tracks beside them;
- **checkpoint-frame stalls** as spans of their measured ``stall_s``
  ending at the frame event (the run loop was blocked exactly there);
- **liveness sweep chunks** and **flush/compact dispatch deltas** as
  spans/counters on the same run track;
- **daemon job slices** (schema v4/v5 ``job_start``/``job_resume`` ->
  ``job_suspend``/``job_result``) as spans on a single "device" track —
  the mesh really is time-sliced, so the track IS the device; and
- **context-switch spans** filling every gap between two consecutive
  slices: the frame write of the suspending job plus the restore of the
  next (the ROADMAP's suspend/resume cost, measured — v5 streams
  annotate the gap with ``restore_s``/``slice_wall_s`` breakdowns); and
- **fleet dispatcher hops** (r22, schema v15): a dispatch stream's
  route/replicate/failover/partition/recover records render as spans
  of their measured ``ack_ms``/``wall_ms`` on a dedicated fleet track,
  reconcile/hold/shed/complete as instants, watch-relay legs as spans
  — and every v15 ``trace_id`` becomes a flow arrow (``ph`` s/t/f)
  from the routing decision through each backend's job slices to the
  terminal ``complete``, so a failover reads as ONE causal chain
  crossing two backend tracks.

Time alignment: every record's ``t`` is monotonic seconds since ITS
stream opened, and a per-job stream restarts the clock every slice
(one ``Telemetry`` per engine ``run()``).  Each run_id is therefore
anchored independently: the first record of a run_id carrying
``wall_unix`` (run headers since r8; the daemon's ``serve``/
``job_submit`` records since r12) fixes that run's offset on the
shared wall clock.  Runs with no anchor fall back to the earliest
anchor seen (offset 0 into the trace), so un-anchored legacy streams
still render — just left-aligned.

``cli.py trace STREAM... -o out.json`` and ``telemetry_report.py
--trace`` are the front-ends; ``scripts/check_telemetry_schema.py
--trace`` validates an exported file's event structure.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

# trace-event phases used here: X = complete (ts + dur), C = counter,
# i = instant, M = metadata (process/thread names)
_US = 1_000_000.0  # seconds -> microseconds (trace-event unit)


def _meta(pid: int, tid: int, name: str, what: str) -> dict:
    return {
        "ph": "M", "pid": pid, "tid": tid, "name": what,
        "args": {"name": name}, "ts": 0,
    }


def _span(pid, tid, name, ts_s, dur_s, args=None, cat="ptt") -> dict:
    e = {
        "ph": "X", "pid": pid, "tid": tid, "name": name, "cat": cat,
        "ts": round(ts_s * _US, 1),
        "dur": max(round(dur_s * _US, 1), 0.0),
    }
    if args:
        e["args"] = args
    return e


def _counter(pid, tid, name, ts_s, values: dict) -> dict:
    return {
        "ph": "C", "pid": pid, "tid": tid, "name": name, "cat": "ptt",
        "ts": round(ts_s * _US, 1), "args": values,
    }


def _instant(pid, tid, name, ts_s, args=None) -> dict:
    e = {
        "ph": "i", "pid": pid, "tid": tid, "name": name, "cat": "ptt",
        "ts": round(ts_s * _US, 1), "s": "t",
    }
    if args:
        e["args"] = args
    return e


def _flow(ph: str, pid, tid, ts_s, trace_id: str) -> dict:
    """One leg of a trace_id's flow arrow (``ph`` "s" start at the
    routing decision, "t" step at each backend job slice, "f" finish
    at the terminal ``complete``).  Chrome binds flow legs by
    (cat, name, id), so all three share them."""
    e = {
        "ph": ph, "pid": pid, "tid": tid, "name": "trace",
        "cat": "ptt.trace", "ts": round(ts_s * _US, 1),
        "id": trace_id,
    }
    if ph == "f":
        e["bp"] = "e"  # bind to the enclosing slice, not the next
    return e


def _run_anchors(events: List[dict]) -> Dict[str, float]:
    """run_id -> unix seconds of that run's t=0 (``wall_unix - t`` of
    the first anchored record), for per-run clock alignment."""
    anchors: Dict[str, float] = {}
    for e in events:
        rid = e.get("run_id")
        if rid is None or rid in anchors:
            continue
        w = e.get("wall_unix")
        if isinstance(w, (int, float)) and isinstance(
            e.get("t"), (int, float)
        ):
            anchors[rid] = float(w) - float(e["t"])
    return anchors


def job_slices(
    events: List[dict],
    offsets: Optional[Dict[str, float]] = None,
) -> List[dict]:
    """Device-occupancy slices from a daemon stream's ``job_*`` events,
    in start order: ``{job_id, spec, slice, start_t, end_t, end_event,
    restore_s?, slice_wall_s?, frame_write_s?, frame_stall_s?}``.

    A slice opens at ``job_start``/``job_resume`` and closes at the
    same job's next ``job_suspend``/``job_result`` **within the same
    run_id** — a daemon restart starts a new run_id with a fresh
    monotonic clock (telemetry.py documents restart-appended streams as
    legitimate), so pairing across run_ids would splice two clocks
    into one span.  A still-open slice at stream end (or at the
    restart boundary) is dropped: the daemon died mid-slice and there
    is no honest end.  ``offsets`` maps run_id -> seconds to add to
    that run's t values (the caller's wall-clock anchors), aligning
    restarts onto one timeline; an unmapped run_id renders at offset
    0 (stream-relative)."""
    out: List[dict] = []
    open_by_job: Dict[tuple, dict] = {}
    off = offsets or {}
    for e in events:
        ev = e.get("event")
        jid = e.get("job_id")
        rid = e.get("run_id")
        o = float(off.get(rid, 0.0))
        if ev in ("job_start", "job_resume") and jid is not None:
            s = {
                "job_id": jid,
                "spec": e.get("spec"),
                "slice": e.get("slice"),
                "start_t": float(e.get("t", 0.0)) + o,
                "end_t": None,
                "end_event": None,
            }
            if isinstance(e.get("restore_s"), (int, float)):
                s["restore_s"] = float(e["restore_s"])
            if isinstance(e.get("trace_id"), str):
                # v15: the slice joins its fleet-wide causal chain
                s["trace_id"] = e["trace_id"]
            open_by_job[(rid, jid)] = s
        elif ev in ("job_suspend", "job_result") and jid is not None:
            s = open_by_job.pop((rid, jid), None)
            if s is None:
                continue
            s["end_t"] = float(e.get("t", 0.0)) + o
            s["end_event"] = ev
            for k in ("slice_wall_s", "frame_write_s", "frame_stall_s"):
                if isinstance(e.get(k), (int, float)):
                    s[k] = float(e[k])
            out.append(s)
    out.sort(key=lambda s: s["start_t"])
    return out


def context_switches(slices: List[dict]) -> List[dict]:
    """The gaps between consecutive device slices: ``{start_t, end_t,
    from_job, to_job, restore_s?, frame_stall_s?}``.  Slices plus gaps
    tile the device's busy window exactly — their durations sum to the
    daemon wall clock between the first slice start and the last slice
    end (the acceptance criterion ``cli.py trace`` is held to).  A
    negative gap (overlapping slices — only possible when un-anchored
    restart clocks collide at offset 0) is dropped rather than
    rendered with an inverted extent."""
    out: List[dict] = []
    for prev, nxt in zip(slices, slices[1:]):
        if nxt["start_t"] < prev["end_t"]:
            continue
        gap = {
            "start_t": prev["end_t"],
            "end_t": nxt["start_t"],
            "from_job": prev["job_id"],
            "to_job": nxt["job_id"],
        }
        if "restore_s" in nxt:
            gap["restore_s"] = nxt["restore_s"]
        if "frame_stall_s" in prev:
            gap["frame_stall_s"] = prev["frame_stall_s"]
        out.append(gap)
    return out


def _engine_track_events(
    pid: int, tid: int, events: List[dict], off: float
) -> List[dict]:
    """Spans/counters for ONE run_id's engine records (level spans,
    ckpt stalls, sweep chunks, flush/compact counters, result)."""
    out: List[dict] = []
    prev_t: Optional[float] = None
    # spill transfers render as async spans on their OWN track (r16):
    # the cumulative transfer_s delta is the span width, ending at the
    # boundary that joined the async work — overlap with the level
    # spans above is exactly the overlap the store measures
    spill_tid = tid * 100
    prev_spill_s = 0.0
    n_spill = 0
    # (t, cumulative steps, cumulative walks) of the previous sim
    # record — the walker-throughput counters are per-segment deltas
    prev_sim: Optional[tuple] = None
    for e in events:
        ev = e.get("event")
        t = e.get("t")
        if not isinstance(t, (int, float)):
            continue
        t = float(t)
        if ev == "run_header":
            prev_t = t
            out.append(
                _instant(
                    pid, tid,
                    "resume" if e.get("resume") else "run start", t + off,
                    args={
                        k: e[k]
                        for k in (
                            "engine", "visited_impl", "compact_impl",
                            "resume_of", "restore_s",
                        )
                        if k in e
                    },
                )
            )
        elif ev == "level":
            start = prev_t if prev_t is not None else t
            out.append(
                _span(
                    pid, tid, f"level {e.get('level')}", start + off,
                    t - start,
                    args={
                        k: e[k]
                        for k in (
                            "new_states", "distinct_states", "frontier",
                            "states_per_sec",
                        )
                        if k in e
                    },
                )
            )
            prev_t = t
            out.append(
                _counter(
                    pid, tid, "states/s", t + off,
                    {"states_per_sec": e.get("states_per_sec", 0)},
                )
            )
            out.append(
                _counter(
                    pid, tid, "distinct states", t + off,
                    {"distinct_states": e.get("distinct_states", 0)},
                )
            )
        elif ev == "ckpt_frame":
            stall = float(e.get("stall_s", e.get("write_s", 0.0)) or 0.0)
            out.append(
                _span(
                    pid, tid, f"ckpt frame {e.get('frame_seq')}",
                    t - stall + off, stall,
                    args={
                        k: e[k]
                        for k in ("bytes", "write_s", "retries", "level")
                        if k in e
                    },
                )
            )
        elif ev == "sweep":
            start = prev_t if prev_t is not None else t
            out.append(
                _span(
                    pid, tid,
                    f"sweep chunk {e.get('chunk')}/{e.get('chunks')}",
                    start + off, t - start,
                    args={
                        k: e[k]
                        for k in ("swept", "edges", "group")
                        if k in e
                    },
                )
            )
            prev_t = t
        elif ev == "flush":
            out.append(
                _counter(
                    pid, tid, "fpset occupancy", t + off,
                    {"occupancy": e.get("occupancy", 0)},
                )
            )
            out.append(
                _counter(
                    pid, tid, "probe rounds/flush", t + off,
                    {"avg": e.get("avg_probe_rounds", 0)},
                )
            )
        elif ev == "compact":
            out.append(
                _counter(
                    pid, tid, "compact dispatches", t + off,
                    {"dispatches": e.get("dispatches", 0)},
                )
            )
        elif ev == "fuse":
            # attribution counter tracks (r14): the megakernel's
            # per-dispatch work-unit deltas render as stacked counters
            # beside the level spans, so Perfetto shows WHERE the work
            # inside the one dispatch went
            vals = {
                k[len("work_"):]: e[k]
                for k in (
                    "work_expand_rows", "work_probe_lanes",
                    "work_compact_elems", "work_append_rows",
                )
                if isinstance(e.get(k), (int, float))
            }
            if vals:
                out.append(
                    _counter(pid, tid, "fused work units", t + off, vals)
                )
        elif ev == "sim":
            # walker-throughput counter track (r18): each cumulative
            # ``sim`` record renders the segment's step/walk deltas as
            # stacked counters plus the engine's own recent steps/s —
            # the simulation analog of the "states/s" track
            dt = max(t - (prev_sim[0] if prev_sim else 0.0), 1e-9)
            steps = float(e.get("steps", 0) or 0)
            walks = float(e.get("walks", 0) or 0)
            d_steps = steps - (prev_sim[1] if prev_sim else 0.0)
            d_walks = walks - (prev_sim[2] if prev_sim else 0.0)
            prev_sim = (t, steps, walks)
            out.append(
                _counter(
                    pid, tid, "walker throughput", t + off,
                    {
                        "steps_per_sec": round(max(d_steps, 0) / dt, 1),
                        "walks_per_sec": round(max(d_walks, 0) / dt, 2),
                    },
                )
            )
            if e.get("dup_ratio_est") is not None:
                out.append(
                    _counter(
                        pid, tid, "sim duplicate est", t + off,
                        {"dup_ratio": e["dup_ratio_est"]},
                    )
                )
        elif ev == "spill":
            dur = max(
                float(e.get("transfer_s", 0.0) or 0.0) - prev_spill_s,
                0.0,
            )
            prev_spill_s = float(e.get("transfer_s", 0.0) or 0.0)
            if n_spill == 0:
                out.append(
                    _meta(
                        pid, spill_tid, "spill transfers",
                        "thread_name",
                    )
                )
            n_spill += 1
            out.append(
                _span(
                    pid, spill_tid,
                    f"spill -> {e.get('tier', '?')}",
                    t - dur + off, dur,
                    args={
                        k: e[k]
                        for k in (
                            "keys_evicted", "rows_evicted",
                            "bytes_raw", "bytes_comp",
                            "misses_resolved", "evictions", "level",
                        )
                        if k in e
                    },
                    cat="ptt.spill",
                )
            )
        elif ev == "hbm_recovery":
            out.append(
                _instant(
                    pid, tid, "HBM recovery", t + off,
                    args={"recovery_n": e.get("recovery_n")},
                )
            )
        elif ev == "fault":
            out.append(
                _instant(
                    pid, tid, f"fault: {e.get('kind')}", t + off,
                    args={"site": e.get("site"), "count": e.get("count")},
                )
            )
        elif ev == "result":
            out.append(
                _instant(
                    pid, tid, "result", t + off,
                    args={
                        k: e[k]
                        for k in (
                            "distinct_states", "diameter", "wall_s",
                            "truncated", "stop_reason", "violation",
                        )
                        if k in e
                    },
                )
            )
    return out


def _daemon_track_events(
    pid: int, events: List[dict], offsets: Dict[str, float]
) -> List[dict]:
    """The device-occupancy track of a daemon stream: job slices, the
    context-switch gaps between them, and submit/cancel instants.
    ``offsets`` is per-run_id (a restart-appended stream carries one
    run_id per daemon lifetime, each with its own clock)."""
    DEVICE_TID = 1
    out: List[dict] = [_meta(pid, DEVICE_TID, "device (time-sliced)",
                             "thread_name")]
    slices = job_slices(events, offsets=offsets)
    for s in slices:
        out.append(
            _span(
                pid, DEVICE_TID,
                f"{s.get('spec') or 'job'} {s['job_id'][:6]} "
                f"slice {s.get('slice')}",
                s["start_t"], s["end_t"] - s["start_t"],
                args={
                    k: s[k]
                    for k in (
                        "job_id", "slice", "end_event", "slice_wall_s",
                        "restore_s", "trace_id",
                    )
                    if k in s
                },
                cat="job-slice",
            )
        )
        if s.get("trace_id"):
            # flow step: the fleet chain passes through this slice
            out.append(
                _flow("t", pid, DEVICE_TID, s["start_t"],
                      s["trace_id"])
            )
    for g in context_switches(slices):
        out.append(
            _span(
                pid, DEVICE_TID, "context-switch",
                g["start_t"], g["end_t"] - g["start_t"],
                args={
                    k: g[k]
                    for k in (
                        "from_job", "to_job", "restore_s",
                        "frame_stall_s",
                    )
                    if k in g
                },
                cat="context-switch",
            )
        )
    for e in events:
        ev = e.get("event")
        t = e.get("t")
        if not isinstance(t, (int, float)):
            continue
        t = float(t) + float(offsets.get(e.get("run_id"), 0.0))
        if ev == "job_submit":
            out.append(
                _instant(
                    pid, DEVICE_TID, f"submit {e.get('job_id', '?')[:6]}",
                    t, args={"spec": e.get("spec")},
                )
            )
        elif ev == "job_cancel":
            out.append(
                _instant(
                    pid, DEVICE_TID, f"cancel {e.get('job_id', '?')[:6]}",
                    t,
                )
            )
        elif ev == "serve":
            out.append(
                _instant(
                    pid, DEVICE_TID, f"serve {e.get('action')}",
                    t, args={"pid": e.get("pid")},
                )
            )
    return out


# dispatcher-side hop events rendered on the fleet track (r22); kept
# OFF the engine-run threads so a dispatch stream's run_id doesn't
# masquerade as an engine
_FLEET_EVENTS = frozenset((
    "route", "replicate", "failover", "partition", "recover",
    "reconcile", "relay", "hold", "shed", "complete",
))
_FLEET_TID = 2


def _ms(v) -> float:
    return float(v) / 1000.0 if isinstance(v, (int, float)) else 0.0


def _fleet_track_events(
    pid: int, events: List[dict], offsets: Dict[str, float]
) -> List[dict]:
    """The dispatcher-hop track of a dispatch stream: routing
    decisions, replication transfers, failover/reconcile windows and
    watch-relay legs as spans of their measured durations (each hop
    event is emitted at its END, so the span runs backwards from
    ``t``), hold/shed/reconcile/complete as instants — plus the flow
    "s"/"f" legs that anchor each trace_id's cross-stream arrow."""
    out: List[dict] = [
        _meta(pid, _FLEET_TID, "fleet (dispatcher hops)",
              "thread_name")
    ]
    for e in events:
        ev = e.get("event")
        t = e.get("t")
        if ev not in _FLEET_EVENTS or not isinstance(
            t, (int, float)
        ):
            continue
        t = float(t) + float(offsets.get(e.get("run_id"), 0.0))
        jid6 = str(e.get("job_id") or "?")[:6]
        if ev == "route":
            # v15 ack_ms is the full arrival->ack path; pre-v15
            # streams fall back to route_ms so old traces still span
            dur = _ms(e.get("ack_ms", e.get("route_ms")))
            out.append(
                _span(
                    pid, _FLEET_TID,
                    f"route {jid6} -> {e.get('backend', '?')}",
                    t - dur, dur,
                    args={
                        k: e[k]
                        for k in (
                            "backend", "tenant", "reason", "job_id",
                            "route_ms", "ack_ms", "trace_id",
                        )
                        if k in e
                    },
                    cat="ptt.fleet",
                )
            )
            if isinstance(e.get("trace_id"), str):
                out.append(
                    _flow("s", pid, _FLEET_TID, t - dur,
                          e["trace_id"])
                )
        elif ev in ("replicate", "failover", "partition", "recover"):
            dur = _ms(e.get("wall_ms"))
            name = {
                "replicate": (
                    f"replicate {e.get('src', '?')} -> "
                    f"{e.get('dst', '?')}"
                ),
                "failover": f"failover {e.get('backend', '?')}",
                "partition": (
                    f"partition {e.get('backend', '?')} reconciled"
                ),
                "recover": "recover",
            }[ev]
            out.append(
                _span(
                    pid, _FLEET_TID, name, t - dur, dur,
                    args={
                        k: e[k]
                        for k in (
                            "backend", "src", "dst", "blobs",
                            "wire_bytes", "resubmitted", "trace_id",
                            "trace_ids", "lost_jobs", "reconciled",
                            "jobs", "confirmed", "adopted", "lost",
                        )
                        if k in e
                    },
                    cat="ptt.fleet",
                )
            )
        elif ev == "relay":
            dur = _ms(e.get("leg_ms"))
            out.append(
                _span(
                    pid, _FLEET_TID, f"relay {jid6}", t - dur, dur,
                    args={
                        k: e[k]
                        for k in ("job_id", "leg_ms", "trace_id")
                        if k in e
                    },
                    cat="ptt.fleet",
                )
            )
        elif ev == "complete":
            out.append(
                _instant(
                    pid, _FLEET_TID, f"complete {jid6}", t,
                    args={
                        k: e[k]
                        for k in (
                            "job_id", "backend", "state", "e2e_ms",
                            "trace_id",
                        )
                        if k in e
                    },
                )
            )
            if isinstance(e.get("trace_id"), str):
                out.append(
                    _flow("f", pid, _FLEET_TID, t, e["trace_id"])
                )
        else:  # reconcile / hold / shed
            out.append(
                _instant(
                    pid, _FLEET_TID, f"{ev} {jid6}", t,
                    args={
                        k: e[k]
                        for k in (
                            "backend", "job_id", "state", "tenant",
                            "held", "trace_id",
                        )
                        if k in e
                    },
                )
            )
    return out


def trace_chains(
    streams: List[Tuple[str, List[dict]]]
) -> Dict[str, dict]:
    """Join every stream's v15 ``trace_id`` stamps into per-chain
    summaries: trace_id -> ``{routes, backends, streams, job_events,
    run_headers, failovers, complete}``.  ``streams`` lists the
    labels the id appears in (a failed-over job spans the dispatch
    stream plus BOTH backend streams); ``backends`` the addrs its
    route records named.  The chaos drill's chain-completeness
    assertion and ``telemetry_report --jobs`` fleet columns both
    consume this join."""
    chains: Dict[str, dict] = {}

    def chain(tid: str) -> dict:
        return chains.setdefault(
            tid,
            {
                "routes": 0, "backends": [], "streams": [],
                "job_events": 0, "run_headers": 0, "failovers": 0,
                "complete": False,
            },
        )

    for label, events in streams:
        for e in events:
            ev = e.get("event") or ""
            tids = []
            if isinstance(e.get("trace_id"), str):
                tids = [e["trace_id"]]
            elif isinstance(e.get("trace_ids"), list):
                tids = [
                    t for t in e["trace_ids"] if isinstance(t, str)
                ]
            for tid in tids:
                c = chain(tid)
                if label not in c["streams"]:
                    c["streams"].append(label)
                if ev == "route":
                    c["routes"] += 1
                    b = e.get("backend")
                    if b and b not in c["backends"]:
                        c["backends"].append(b)
                elif ev == "failover":
                    c["failovers"] += 1
                elif ev == "complete":
                    c["complete"] = True
                elif ev == "run_header":
                    c["run_headers"] += 1
                elif ev.startswith("job_"):
                    c["job_events"] += 1
    return chains


def build_trace(
    streams: List[Tuple[str, List[dict]]]
) -> dict:
    """labelled streams -> one Chrome trace-event JSON object.

    Each stream becomes a trace "process"; each engine run_id within it
    becomes a "thread" of that process; a stream carrying ``job_*``
    events additionally gets the device-occupancy thread with slice +
    context-switch spans.  All clocks align through the per-run
    ``wall_unix`` anchors (module docstring)."""
    all_anchors: List[float] = []
    per_stream_anchors = []
    for _label, events in streams:
        a = _run_anchors(events)
        per_stream_anchors.append(a)
        all_anchors.extend(a.values())
    t0 = min(all_anchors) if all_anchors else 0.0

    trace_events: List[dict] = []
    for sidx, (label, events) in enumerate(streams):
        pid = sidx + 1
        anchors = per_stream_anchors[sidx]
        trace_events.append(_meta(pid, 0, label, "process_name"))

        # group engine records per run_id (daemon job_* events are
        # rendered on the device track instead)
        by_run: Dict[str, List[dict]] = {}
        run_order: List[str] = []
        has_jobs = False
        has_fleet = False
        for e in events:
            ev = e.get("event", "")
            if ev.startswith("job_") or ev == "serve":
                has_jobs = True
                continue
            if ev in _FLEET_EVENTS:
                # dispatcher hops render on the fleet track, not as
                # an engine-run thread
                has_fleet = True
                continue
            rid = e.get("run_id")
            if rid is None:
                continue
            if rid not in by_run:
                by_run[rid] = []
                run_order.append(rid)
            by_run[rid].append(e)

        if has_fleet:
            trace_events.extend(
                _fleet_track_events(
                    pid, events,
                    {rid: a - t0 for rid, a in anchors.items()},
                )
            )
        if has_jobs:
            # per-run_id daemon clocks: a restart-appended stream
            # carries one run_id per daemon lifetime, each with its
            # own monotonic t axis — every anchored run lands at its
            # true wall position (un-anchored legacy runs render at
            # offset 0)
            d_offsets = {
                rid: a - t0 for rid, a in anchors.items()
            }
            trace_events.extend(
                _daemon_track_events(pid, events, d_offsets)
            )
        for ridx, rid in enumerate(run_order):
            revs = by_run[rid]
            tid = 10 + ridx
            hdr = next(
                (e for e in revs if e.get("event") == "run_header"),
                {},
            )
            name = f"{hdr.get('engine', 'run')} {rid[:8]}"
            trace_events.append(_meta(pid, tid, name, "thread_name"))
            off = anchors.get(rid, 0.0) - (t0 if rid in anchors else 0.0)
            trace_events.extend(
                _engine_track_events(pid, tid, revs, off)
            )
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "pulsar_tlaplus_tpu_torch obs/trace.py",
            "streams": [label for label, _evs in streams],
        },
    }


def write_trace(
    streams: List[Tuple[str, List[dict]]], out_path: str
) -> dict:
    """Build + write; returns the trace dict (tests inspect it)."""
    tr = build_trace(streams)
    with open(out_path, "w") as f:
        json.dump(tr, f)
    return tr


def validate_trace(path_or_dict, label: str = "") -> List[str]:
    """Structural validation of an exported trace file (the
    ``check_telemetry_schema.py --trace`` mode): a JSON object with a
    ``traceEvents`` list whose members carry ``ph``/``pid``/``tid``/
    ``ts`` (and ``name`` except counters), known phases only, and
    non-negative ``dur`` on complete events.  Returns violations."""
    if isinstance(path_or_dict, dict):
        d = path_or_dict
        label = label or "<dict>"
    else:
        label = label or str(path_or_dict)
        try:
            with open(path_or_dict) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"{label}: unreadable ({e})"]
    errors: List[str] = []
    if not isinstance(d, dict) or not isinstance(
        d.get("traceEvents"), list
    ):
        return [f"{label}: not a trace object (no traceEvents list)"]
    known_ph = {"X", "B", "E", "C", "i", "I", "M", "s", "t", "f"}
    for i, e in enumerate(d["traceEvents"]):
        where = f"{label}: traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in known_ph:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        for k in ("pid", "tid", "ts"):
            if not isinstance(e.get(k), (int, float)):
                errors.append(f"{where}: non-numeric {k} {e.get(k)!r}")
        if ph != "C" and not e.get("name"):
            errors.append(f"{where}: missing name")
        if ph in ("s", "t", "f") and not e.get("id"):
            # flow legs bind by id: an id-less leg renders nothing
            errors.append(f"{where}: flow event missing id")
        if ph == "X":
            if (
                not isinstance(e.get("dur"), (int, float))
                or e["dur"] < 0
            ):
                errors.append(
                    f"{where}: complete event needs dur >= 0 "
                    f"(got {e.get('dur')!r})"
                )
    if not any(
        e.get("ph") not in ("M",) for e in d["traceEvents"]
        if isinstance(e, dict)
    ):
        errors.append(f"{label}: no non-metadata events")
    return errors
