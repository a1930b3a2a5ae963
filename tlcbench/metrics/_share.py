"""Shared arithmetic of the per-layer readers (no metric of its own)."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "roofline"
                    / "peaks.json").read_text())


def idle_pct(ctx):
    tr = ctx.trace
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def check_counts(ctx) -> dict:
    """The work of the traced checks as the engine reports it."""
    checks = list(ctx.window.get("checks", ()))
    if not checks:
        return {}
    first = checks[0]
    return dict(
        lanes=sum(c["expand_rows"] * c["A"] + c["init_lanes"]
                  for c in checks),
        new=sum(c["append_rows"] for c in checks),
        W=first["W"], K=first["K"])


def roofline_pct(ctx, layer: str, rng: str):
    """The layer's bytes at the card's memory rate over the device time
    under its range, in percent; None where nothing was read."""
    tr = ctx.trace
    peak = PEAKS.get(ctx.window.get("device_kind", ""), {}).get(
        "hbm_bytes_per_s")
    counts = check_counts(ctx)
    if tr is None or not peak or not counts:
        return None
    t = tr["range_device_s"].get(rng, 0.0)
    if t <= 0:
        return None
    nbytes = ctx.roofline(layer).bytes_needed(counts)
    return 100.0 * nbytes / peak / t


def rate(ctx, key: str):
    """Work of the whole window over its seconds (host clock)."""
    w = ctx.window
    if key not in w or w["elapsed_s"] <= 0:
        return None
    return w[key] / w["elapsed_s"]


def host_syncs_per_level(ctx):
    """The engine's host reads over the levels of the checks the window
    did not stop."""
    done = [c for c in ctx.window.get("checks", ())
            if c["stop_reason"] != "time_budget"]
    levels = sum(len(c["level_sizes"]) for c in done)
    if not levels:
        return None
    return sum(c["host_syncs"] for c in done) / levels


def expand_ms_per_mstate(ctx):
    """Device ms under ``expand`` per million states expanded."""
    tr, checks = ctx.trace, ctx.window.get("checks", ())
    rows = sum(c["expand_rows"] for c in checks)
    if tr is None or not rows or not tr["range_device_s"]["expand"]:
        return None
    return tr["range_device_s"]["expand"] * 1e3 / (rows / 1e6)
