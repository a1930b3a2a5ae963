"""Flight deck: the ``cli.py top`` dashboard (curses-free ANSI) — the
port's copy of ``pulsar_tlaplus_tpu/obs/top.py``.

One frame = a plain string: a header line (the stream path), the job
table, a per-job rate sparkline built from recent ``level`` records,
and the heartbeat-equivalent status line of whatever holds the device.
The renderer is a pure function over a :class:`TopModel`, so a frame
renders without a daemon, a terminal, or ANSI parsing.  Stream mode
tails telemetry JSONL files: ``level`` records feed the sparkline,
``job_*`` records the table.  Daemon mode (:func:`poll_daemon_frame`)
polls a running daemon: one ping, one status listing and one metrics
scrape a frame, all answered from host dicts.  Fleet mode
(:func:`poll_dispatch_frame`, ``cli.py top --dispatch``) polls a
dispatcher: one ``ping`` (each backend's health, score and stickiness)
and one ``metrics --aggregate`` scrape a frame — the backend table, the
fleet's job rollups, route/complete rate sparklines from successive
polls' counter deltas, and p50/p99 from the ``ptt_fleet_*_seconds``
histograms.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

SPARK_CHARS = "▁▂▃▄▅▆▇█"
CLEAR = "\x1b[2J\x1b[H"  # clear screen + home (the whole ANSI we need)


def sparkline(values: List[float], width: int = 24) -> str:
    """Last ``width`` values as unicode block bars, scaled to the
    window's own max (an empty/flat window renders floor bars)."""
    vals = [max(float(v), 0.0) for v in values][-width:]
    if not vals:
        return ""
    top = max(vals)
    if top <= 0:
        return SPARK_CHARS[0] * len(vals)
    out = []
    for v in vals:
        idx = int(v / top * (len(SPARK_CHARS) - 1) + 0.5)
        out.append(SPARK_CHARS[min(idx, len(SPARK_CHARS) - 1)])
    return "".join(out)


def fmt_si(n) -> str:
    """1234567 -> '1.2M' (table-width-friendly counts)."""
    if n is None:
        return "?"
    n = float(n)
    for div, suf in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(n) >= div:
            return f"{n / div:.1f}{suf}"
    return f"{int(n)}"


class TopModel:
    """Everything one frame renders, source-agnostic."""

    def __init__(self, source: str):
        self.source = source  # header: socket path or stream path
        self.daemon: Dict[str, object] = {}  # pid/uptime_s/warmed
        self.jobs: List[dict] = []  # job summaries (status-wire shape)
        self.rates: Dict[str, List[float]] = {}  # job/run -> st/s tail
        self.status_line: str = ""
        self.metrics_text: Optional[str] = None

    # ---------------------------------------------------- accumulation

    def note_rate(self, key: str, rate, keep: int = 48) -> None:
        if rate is None:
            return
        h = self.rates.setdefault(key, [])
        h.append(float(rate))
        del h[:-keep]

    def ingest_events(self, events: List[dict]) -> None:
        """Stream mode: fold telemetry records into the model (levels
        feed sparklines; job_* events feed the table; the newest
        level/progress record feeds the status line)."""
        from pulsar_tlaplus_tpu_torch.obs import report

        rows = report.job_table(events)
        if rows:
            self.jobs = [
                {
                    "job_id": r["job_id"],
                    "spec": r.get("spec") or "?",
                    "state": (
                        "cancelled" if r.get("cancelled")
                        else (r.get("status") or "in flight")
                    ),
                    "slices": r.get("slices", 0),
                    "suspends": r.get("suspends", 0),
                    # engine run ids (r12 engine_run_id on suspend/
                    # result events): the sparkline fallback joins
                    # these against level-record rate history when the
                    # per-job streams are ingested alongside
                    "run_ids": list(r.get("run_ids") or []),
                }
                for r in rows
            ]
        last = None
        for e in events:
            ev = e.get("event")
            if ev == "level":
                self.note_rate(
                    str(e.get("run_id", "run")), e.get("states_per_sec")
                )
                last = e
            elif ev == "progress":
                # newest record wins, whichever kind: the status line
                # must advance with a heartbeat-only tail too
                last = e
        if last is not None:
            self.status_line = (
                f"level {last.get('level', '?')}: "
                f"{fmt_si(last.get('distinct_states'))} distinct, "
                f"frontier {fmt_si(last.get('frontier'))}, "
                f"{fmt_si(last.get('states_per_sec'))} st/s"
                + (
                    f", occupancy {last['occupancy']:.1%}"
                    if isinstance(last.get("occupancy"), float)
                    else ""
                )
            )


def render_frame(model: TopModel, now: Optional[float] = None) -> str:
    """One dashboard frame (no clear codes — the CLI loop prepends
    :data:`CLEAR` when it repaints a terminal)."""
    now = time.time() if now is None else now
    lines: List[str] = []
    d = model.daemon
    head = f"tpu-tlc top — {model.source}"
    if d:
        head += (
            f"  (pid {d.get('pid', '?')}, up "
            f"{float(d.get('uptime_s', 0)):.0f}s, warmed: "
            f"{','.join(d.get('warmed', [])) or 'none'})"
        )
    lines.append(head)
    lines.append("=" * min(len(head), 78))
    if model.jobs:
        lines.append(
            f"{'JOB':<12} {'SPEC':<14} {'STATE':<10} {'SLICES':>6} "
            f"{'SUSP':>5} {'STATES':>8} {'RATE':<26}"
        )
        for j in model.jobs:
            key = j.get("job_id", "?")
            hist = model.rates.get(key) or []
            # per-slice engine run_ids also key rate history (stream
            # mode); fall back to the newest run of this job
            if not hist:
                for rid in reversed(j.get("run_ids") or []):
                    if model.rates.get(rid):
                        hist = model.rates[rid]
                        break
            spark = sparkline(hist)
            tail = f"{fmt_si(hist[-1])}/s" if hist else ""
            lines.append(
                f"{str(key)[:12]:<12} {str(j.get('spec', '?'))[:14]:<14} "
                f"{str(j.get('state', '?'))[:10]:<10} "
                f"{j.get('slices', 0):>6} {j.get('suspends', 0):>5} "
                f"{fmt_si(j.get('distinct_states')):>8} "
                f"{spark} {tail}"
            )
    elif model.rates:
        # no job table (a lone engine stream): render per-run rows so
        # the sparkline still shows
        lines.append(f"{'RUN':<14} {'RATE':<30}")
        for rid, hist in model.rates.items():
            lines.append(
                f"{str(rid)[:14]:<14} {sparkline(hist)} "
                f"{fmt_si(hist[-1])}/s"
            )
    else:
        lines.append("(no jobs)")
    if model.status_line:
        lines.append("")
        lines.append(model.status_line)
    lines.append("")
    lines.append(time.strftime("%H:%M:%S", time.localtime(now)))
    return "\n".join(lines)


# ------------------------------------------------------------ daemon mode


def poll_daemon_frame(client, model: TopModel) -> str:
    """One daemon poll -> updated model -> rendered frame.  ``client`` is
    a ``service.client.ServiceClient``; rates accumulate across polls
    from the metrics scrape's ``ptt_states_per_sec`` and the active
    job."""
    from pulsar_tlaplus_tpu_torch.obs import metrics as metrics_mod

    pong = client.ping()
    model.daemon = {k: pong.get(k) for k in ("pid", "uptime_s", "warmed")}
    model.jobs = client.status()
    text = client.metrics()
    model.metrics_text = text
    fams, _types = metrics_mod.parse_exposition(text)

    def val(name, default=None):
        samples = fams.get(name) or []
        return samples[0][1] if samples else default

    rate = val("ptt_states_per_sec")
    active = [
        (labels, v)
        for labels, v in fams.get("ptt_active_job", [])
        if v > 0 and labels.get("job_id")
    ]
    if active:
        model.note_rate(active[0][0]["job_id"], rate or 0.0)
    distinct = val("ptt_distinct_states")
    level = val("ptt_bfs_level")
    frontier = val("ptt_frontier_states")
    occ = val("ptt_fpset_occupancy")
    parts = []
    if active:
        parts.append(f"active {active[0][0]['job_id'][:8]}")
    if level is not None:
        parts.append(f"level {int(level)}")
    if distinct is not None:
        parts.append(f"{fmt_si(distinct)} distinct")
    if frontier is not None:
        parts.append(f"frontier {fmt_si(frontier)}")
    if rate is not None:
        parts.append(f"{fmt_si(rate)} st/s")
    if occ is not None:
        parts.append(f"occupancy {occ:.1%}")
    model.status_line = ", ".join(parts)
    return render_frame(model)


# ---------------------------------------------------- fleet flight deck


class FleetTopModel(TopModel):
    """Everything one dispatcher frame renders: the per-backend
    routing view, fleet job rollups, and histogram quantiles —
    accumulated rates ride the inherited :attr:`rates` table."""

    def __init__(self, source: str):
        super().__init__(source)
        self.backends: Dict[str, dict] = {}
        self.job_counts: Dict[str, object] = {}
        self.held = 0
        self.persist_failures = 0
        # [(family, p50_s, p99_s, count)] from the aggregate scrape
        self.quantiles: List[tuple] = []
        # (unix, {key: counter total}) of the previous poll, for the
        # rate sparkline deltas
        self._prev: Optional[tuple] = None


def _fmt_lat(v) -> str:
    """Seconds -> table cell ('3.2ms' / '1.4s' / '-')."""
    if v is None:
        return "-"
    v = float(v)
    if v < 1.0:
        return f"{v * 1000.0:.1f}ms"
    return f"{v:.2f}s"


def hist_quantiles(fams, types) -> List[tuple]:
    """(family, p50_s, p99_s, count) for every histogram family in a
    parsed exposition — the dispatcher's own rollup samples only
    (per-``backend``-labelled copies from an aggregate scrape are
    the SAME observations re-emitted, and double-counting them would
    skew every quantile)."""
    from pulsar_tlaplus_tpu_torch.obs import metrics as metrics_mod

    out: List[tuple] = []
    for name in sorted(types):
        if types[name] != "histogram":
            continue
        pairs = []
        for labels, v in fams.get(name + "_bucket", []):
            if labels.get("backend") or labels.get("le") is None:
                continue
            pairs.append((float(labels["le"]), v))
        count = 0.0
        for labels, v in fams.get(name + "_count", []):
            if not labels.get("backend"):
                count = v
        if not pairs or count <= 0:
            continue
        out.append(
            (
                name,
                metrics_mod.histogram_quantile(0.5, pairs),
                metrics_mod.histogram_quantile(0.99, pairs),
                int(count),
            )
        )
    return out


def render_fleet_frame(
    model: FleetTopModel, now: Optional[float] = None
) -> str:
    """One fleet dashboard frame (pure function over the model, like
    :func:`render_frame` — the smoke test renders without a
    dispatcher or a terminal)."""
    now = time.time() if now is None else now
    lines: List[str] = []
    d = model.daemon
    head = f"tpu-tlc top — fleet @ {model.source}"
    if d:
        head += (
            f"  (dispatcher pid {d.get('pid', '?')}, up "
            f"{float(d.get('uptime_s', 0)):.0f}s, "
            f"{len(model.backends)} backend(s))"
        )
    lines.append(head)
    lines.append("=" * min(len(head), 78))
    if model.backends:
        lines.append(
            f"{'BACKEND':<28} {'STATE':<6} {'SCORE':>7} {'QUEUE':>5} "
            f"{'RUN':>4} {'INFL':>4} {'SHED':>5} {'WARM':>4} "
            f"{'STICKY':>6}"
        )
        for addr in sorted(model.backends):
            b = model.backends[addr]
            lines.append(
                f"{addr[:28]:<28} {str(b.get('state', '?'))[:6]:<6} "
                f"{float(b.get('score', 0)):>7.1f} "
                f"{b.get('queue_depth', 0):>5} "
                f"{b.get('running', 0):>4} "
                f"{b.get('inflight', 0):>4} "
                f"{fmt_si(b.get('sheds', 0)):>5} "
                f"{b.get('warmed', 0):>4} "
                f"{b.get('sticky_tenants', 0):>6}"
            )
    else:
        lines.append("(no backends)")
    jc = model.job_counts or {}
    jobs_bit = ", ".join(
        f"{k} {jc[k]}" for k in sorted(jc)
    ) or "none"
    lines.append(
        f"jobs: {jobs_bit} | held {model.held} | "
        f"persist failures {model.persist_failures}"
    )
    rate_bits = []
    for key, title in (("routes", "routes"), ("completes", "done")):
        hist = model.rates.get(key) or []
        if hist:
            rate_bits.append(
                f"{title} {sparkline(hist)} {hist[-1]:.2f}/s"
            )
    if rate_bits:
        lines.append("  ".join(rate_bits))
    if model.quantiles:
        lines.append("")
        lines.append(
            f"{'LATENCY':<32} {'P50':>9} {'P99':>9} {'N':>7}"
        )
        for name, p50, p99, n in model.quantiles:
            short = name
            if short.startswith("ptt_fleet_"):
                short = short[len("ptt_fleet_"):]
            if short.endswith("_seconds"):
                short = short[: -len("_seconds")]
            lines.append(
                f"{short:<32} {_fmt_lat(p50):>9} {_fmt_lat(p99):>9} "
                f"{n:>7}"
            )
    lines.append("")
    lines.append(time.strftime("%H:%M:%S", time.localtime(now)))
    return "\n".join(lines)


def poll_dispatch_frame(client, model: FleetTopModel) -> str:
    """One dispatcher poll -> updated model -> rendered fleet frame:
    ``ping`` for the routing view, ``metrics(aggregate=True)`` for
    rollups + histograms; counter deltas between successive polls
    feed the rate sparklines."""
    from pulsar_tlaplus_tpu_torch.obs import metrics as metrics_mod

    pong = client.ping()
    model.daemon = {
        k: pong.get(k) for k in ("pid", "uptime_s", "warmed")
    }
    model.backends = pong.get("backends_detail") or {
        a: {"state": s}
        for a, s in (pong.get("backends") or {}).items()
    }
    model.job_counts = pong.get("jobs") or {}
    model.held = int(pong.get("held") or 0)
    model.persist_failures = int(pong.get("persist_failures") or 0)
    text = client.metrics(aggregate=True)
    model.metrics_text = text
    fams, types = metrics_mod.parse_exposition(text)
    model.quantiles = hist_quantiles(fams, types)

    def total(name: str) -> float:
        return sum(v for _labels, v in fams.get(name, []))

    now = time.time()
    totals = {
        "routes": total("ptt_fleet_routes_total"),
        "completes": total("ptt_fleet_job_e2e_seconds_count"),
    }
    if model._prev is not None:
        prev_t, prev_totals = model._prev
        dt = max(now - prev_t, 1e-9)
        for key, cur in totals.items():
            model.note_rate(
                key, max(cur - prev_totals.get(key, 0.0), 0.0) / dt
            )
    model._prev = (now, totals)
    return render_fleet_frame(model)


# ------------------------------------------------------------ stream mode


def tail_stream_frame(paths, model: TopModel) -> str:
    """One re-read of the stream(s) -> updated model -> rendered frame
    (files are small JSONL; a full re-read keeps resume/rotation
    simple).  Pass the daemon's ``service.jsonl`` together with
    ``jobs/*/events.jsonl`` and the job rows join their level-record
    sparklines via the r12 ``engine_run_id`` fields."""
    from pulsar_tlaplus_tpu_torch.obs import report

    if isinstance(paths, str):
        paths = [paths]
    events = []
    for p in paths:
        evs, _errors = report.load_events(p)
        events.extend(evs)
    model.ingest_events(events)
    return render_frame(model)
