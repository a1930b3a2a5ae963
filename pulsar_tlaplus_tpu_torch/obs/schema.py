"""The telemetry stream and bench-artifact validator — the counterpart
of ``scripts/check_telemetry_schema.py``'s ``validate_stream``,
``_check_fused_levels`` and ``validate_bench_artifact``, kept in the
package so a run on the card (where the JAX package is absent) can
validate its own streams.

Stream rules (:data:`~pulsar_tlaplus_tpu_torch.obs.telemetry.EVENTS` is
authoritative; a record is held only to the fields its own version
requires, :data:`~pulsar_tlaplus_tpu_torch.obs.telemetry.FIELD_SINCE`):
every line parses as an object carrying the base envelope; ``v`` is at
most the supported version; ``t`` never decreases and ``seq`` strictly
increases per ``run_id``; ``spill`` and ``sim`` records are cumulative
(never decreasing); a fused run's boundary ``level`` records rise
strictly and their sizes sum to the result's state count.

Tuned-profile files (``cli tune`` output) are held to the profile
schema of ``tune/profiles.py`` (:func:`validate_profile_file`: the
counterpart of ``check_telemetry_schema.py --profile``).
"""

from __future__ import annotations

import json
from typing import List

from pulsar_tlaplus_tpu_torch.obs.telemetry import (
    BASE_FIELDS,
    EVENTS,
    FIELD_SINCE,
    SCHEMA_VERSION,
)

# bench-artifact key requirements by bench_schema version (additive)
BENCH_KEYS_V2 = (
    "metric", "value", "unit", "vs_baseline", "vs_baseline_definition",
    "distinct_states", "levels", "compile_warmup_s",
)
BENCH_KEYS_V3 = BENCH_KEYS_V2 + (
    "stop_reason", "truncated", "hbm_recovered",
    "ckpt_frames", "ckpt_bytes", "ckpt_write_s",
    "fpset_flushes", "fpset_probe_rounds", "fpset_avg_probe_rounds",
    "fpset_failures", "fpset_occupancy",
    "fpset_valid_lanes", "fpset_max_probe_rounds",
    "visited_impl", "max_states", "stats_fetches",
)
# v4 (r9): the frame writer's transient-failure retry breadcrumb
BENCH_KEYS_V4 = BENCH_KEYS_V3 + ("ckpt_retries",)
# v5 (r10): the stream-compaction impl (logshift|sort differential)
BENCH_KEYS_V5 = BENCH_KEYS_V4 + ("compact_impl",)
# v6 (r13): the level-fusion mode and the run's dispatch economy (the
# fused-vs-stage differential headline)
BENCH_KEYS_V6 = BENCH_KEYS_V5 + ("fuse", "dispatches_per_level")
# v7 (r14): the in-kernel work-unit totals the cost-attribution model
# prices (docs/observability.md "Attribution")
BENCH_KEYS_V7 = BENCH_KEYS_V6 + (
    "work_expand_rows", "work_probe_lanes", "work_compact_elems",
    "work_append_rows", "work_groups",
)
# v8 (r16): the tiered-store budget + spill economy signals (null on
# untiered runs; the keys themselves are required)
BENCH_KEYS_V8 = BENCH_KEYS_V7 + (
    "hbm_budget", "spill_bytes_per_state", "spill_overlap_ratio",
)
# v9 (r18): the swarm-simulation throughput signals (null on
# check-mode runs; the keys themselves are required)
BENCH_KEYS_V9 = BENCH_KEYS_V8 + ("walks_per_sec", "steps_per_state")
# v10 (r20): the fleet-tier signals from `bench.py --fleet N` — how
# many backends served, end-to-end queue throughput through the
# dispatcher, mean route (placement) latency, and the replication
# sieve's total delta-compressed wire bytes (null on non-fleet runs;
# the keys themselves are required)
BENCH_KEYS_V10 = BENCH_KEYS_V9 + (
    "fleet_backends", "fleet_jobs_per_sec", "fleet_route_ms",
    "fleet_replicated_wire_bytes",
)
# v11 (r21): the fleet survivability latencies — mean time from a
# drain detected to its queued jobs landing elsewhere, and from a
# rejoin detected to its lost jobs answered for (null on non-fleet
# runs AND on fleet runs whose drill saw no drain/rejoin; the keys
# themselves are required)
BENCH_KEYS_V11 = BENCH_KEYS_V10 + (
    "fleet_failover_ms", "fleet_reconcile_ms",
)
# v12 (r23): the dense-tile kernel selection — the probe/expand/sieve
# impls the run actually executed under (null on engines without the
# ops/tiles.py knobs) and the flush-stage probe throughput the tiles
# ledger gate watches (null when no probe lanes were counted; the
# keys themselves are required)
BENCH_KEYS_V12 = BENCH_KEYS_V11 + (
    "probe_impl", "expand_impl", "sieve_impl", "probe_lanes_per_sec",
)


def _check_fused_levels(path: str, runs: dict) -> List[str]:
    """v6 fused-run cross-check: for every run whose header declares
    ``fuse: "level"``, the non-``partial`` (boundary) ``level`` records
    must carry strictly increasing levels whose ``new_states`` match
    the result's ``level_sizes`` entry for that level — and on a clean
    (non-truncated, non-violation) run the per-level sizes must sum to
    the result's distinct-state count.  This is what pins the fused
    megakernel's host-side per-level accounting replay: a batch that
    dropped, duplicated, or misordered a level record fails here."""
    errors: List[str] = []
    for rid, r in runs.items():
        hd, res, levels = r["header"], r["result"], r["levels"]
        if not hd or hd.get("fuse") != "level" or res is None:
            continue
        sizes = res.get("level_sizes")
        prev = 0
        for e in levels:
            lv = e.get("level")
            if not isinstance(lv, int):
                continue
            if lv <= prev:
                errors.append(
                    f"{path}: run {rid}: fused boundary level records "
                    f"not strictly increasing ({lv} after {prev})"
                )
            prev = lv
            if (
                isinstance(sizes, list)
                and 1 <= lv <= len(sizes)
                and e.get("new_states") != sizes[lv - 1]
            ):
                errors.append(
                    f"{path}: run {rid}: level {lv} record says "
                    f"+{e.get('new_states')} but result.level_sizes"
                    f"[{lv - 1}] is {sizes[lv - 1]}"
                )
        if (
            isinstance(sizes, list)
            and not res.get("truncated")
            and not res.get("violation")
            and sum(sizes) != res.get("distinct_states")
        ):
            errors.append(
                f"{path}: run {rid}: fused level_sizes sum "
                f"{sum(sizes)} != distinct_states "
                f"{res.get('distinct_states')}"
            )
    return errors


# the spill record's cumulative counters (v9): each must be
# monotone non-decreasing per run_id
SPILL_CUMULATIVE = (
    "keys_evicted", "rows_evicted", "bytes_raw", "bytes_comp",
    "transfer_s", "misses_resolved",
)

# the sim record's cumulative counters (v11): each must be monotone
# non-decreasing per run_id (the walk stream only moves forward)
SIM_CUMULATIVE = (
    "steps", "states", "walks", "violations", "stutter_steps",
    "enabled_lanes", "dup_attempts", "dup_hits",
)


def validate_stream(path: str) -> List[str]:
    """All schema violations in one stream (empty list = clean)."""
    errors: List[str] = []
    last_t: dict = {}
    last_seq: dict = {}
    fused_runs: dict = {}
    last_spill: dict = {}
    last_sim: dict = {}
    n = 0
    try:
        f = open(path)
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    with f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"{path}:{i}: unparseable JSON ({e})")
                continue
            if not isinstance(rec, dict):
                errors.append(f"{path}:{i}: not a JSON object")
                continue
            missing = [k for k in BASE_FIELDS if k not in rec]
            if missing:
                errors.append(
                    f"{path}:{i}: missing base fields {missing}"
                )
                continue
            if not isinstance(rec["v"], int) or rec["v"] < 1:
                errors.append(f"{path}:{i}: bad schema version {rec['v']!r}")
            elif rec["v"] > SCHEMA_VERSION:
                errors.append(
                    f"{path}:{i}: schema v{rec['v']} newer than "
                    f"supported v{SCHEMA_VERSION}"
                )
            if not isinstance(rec["t"], (int, float)):
                errors.append(f"{path}:{i}: non-numeric t {rec['t']!r}")
            else:
                rid = rec["run_id"]
                if rec["t"] < last_t.get(rid, float("-inf")):
                    errors.append(
                        f"{path}:{i}: t went backwards for run "
                        f"{rid} ({rec['t']} < {last_t[rid]})"
                    )
                last_t[rid] = rec["t"]
            if isinstance(rec.get("seq"), int):
                # per-run_id STRICT monotonicity: interleaved run_ids
                # (a daemon stream, per-slice job streams) are legal,
                # but one run's writer repeating or reordering seq is
                # a torn/duplicated stream
                rid = rec["run_id"]
                prev = last_seq.get(rid)
                if prev is not None and rec["seq"] <= prev:
                    errors.append(
                        f"{path}:{i}: seq not increasing for run "
                        f"{rid} ({rec['seq']} <= {prev})"
                    )
                last_seq[rid] = rec["seq"]
            else:
                errors.append(
                    f"{path}:{i}: non-integer seq {rec.get('seq')!r}"
                )
            req = EVENTS.get(rec["event"])
            if req:
                # a record is held only to the fields its OWN schema
                # version requires — pre-r9 (v1) streams stay valid
                # even though v2 added fields (FIELD_SINCE)
                v = rec["v"] if isinstance(rec["v"], int) else 1
                miss = [
                    k for k in req
                    if k not in rec
                    and FIELD_SINCE.get((rec["event"], k), 1) <= v
                ]
                if miss:
                    errors.append(
                        f"{path}:{i}: {rec['event']} missing {miss}"
                    )
            if rec["event"] == "sim" and isinstance(
                rec.get("v"), int
            ) and rec["v"] >= 11:
                # v11 cross-check: sim counters are CUMULATIVE per run
                # — a record whose steps/states go backwards is a torn
                # writer or a silently re-based walk stream
                prev = last_sim.setdefault(rec["run_id"], {})
                for k in SIM_CUMULATIVE:
                    cur = rec.get(k)
                    if not isinstance(cur, (int, float)):
                        continue
                    if cur < prev.get(k, float("-inf")):
                        errors.append(
                            f"{path}:{i}: sim.{k} went backwards "
                            f"for run {rec['run_id']} ({cur} < "
                            f"{prev[k]} — cumulative contract)"
                        )
                    prev[k] = cur
            if rec["event"] == "spill" and isinstance(
                rec.get("v"), int
            ) and rec["v"] >= 9:
                # v9 cross-check: spill counters are CUMULATIVE per
                # run — a record whose bytes/keys go backwards is a
                # torn writer or a silently re-based store
                prev = last_spill.setdefault(rec["run_id"], {})
                for k in SPILL_CUMULATIVE:
                    cur = rec.get(k)
                    if not isinstance(cur, (int, float)):
                        continue
                    if cur < prev.get(k, float("-inf")):
                        errors.append(
                            f"{path}:{i}: spill.{k} went backwards "
                            f"for run {rec['run_id']} ({cur} < "
                            f"{prev[k]} — cumulative contract)"
                        )
                    prev[k] = cur
            # collect per-run material for the v6 fused-run
            # cross-check (boundary level records vs result sizes)
            run = fused_runs.setdefault(
                rec["run_id"],
                {"header": None, "result": None, "levels": []},
            )
            if rec["event"] == "run_header":
                run["header"] = rec
            elif rec["event"] == "result":
                run["result"] = rec
            elif rec["event"] == "level" and not rec.get("partial"):
                run["levels"].append(rec)
    if n == 0:
        errors.append(f"{path}: empty stream")
    errors += _check_fused_levels(path, fused_runs)
    return errors


def validate_bench_artifact(path_or_dict, path: str = "") -> List[str]:
    """Violations in one bench artifact (file path or parsed dict).
    Wrapped artifacts (``{"parsed": {...}}``) unwrap automatically."""
    if isinstance(path_or_dict, dict):
        d = path_or_dict
        label = path or "<dict>"
    else:
        label = path_or_dict
        try:
            with open(path_or_dict) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"{path_or_dict}: unreadable ({e})"]
    if "parsed" in d and isinstance(d["parsed"], dict):
        d = d["parsed"]
    errors: List[str] = []
    schema = d.get("bench_schema")
    if schema is None:
        # pre-schema artifacts (r1-r3): only the headline keys existed
        for k in ("metric", "value", "unit"):
            if k not in d:
                errors.append(f"{label}: missing {k}")
        return errors
    if not isinstance(schema, int) or schema < 2:
        errors.append(f"{label}: bad bench_schema {schema!r}")
        return errors
    if schema >= 12:
        required = BENCH_KEYS_V12
    elif schema >= 11:
        required = BENCH_KEYS_V11
    elif schema >= 10:
        required = BENCH_KEYS_V10
    elif schema >= 9:
        required = BENCH_KEYS_V9
    elif schema >= 8:
        required = BENCH_KEYS_V8
    elif schema >= 7:
        required = BENCH_KEYS_V7
    elif schema >= 6:
        required = BENCH_KEYS_V6
    elif schema >= 5:
        required = BENCH_KEYS_V5
    elif schema >= 4:
        required = BENCH_KEYS_V4
    elif schema >= 3:
        required = BENCH_KEYS_V3
    else:
        required = BENCH_KEYS_V2
    for k in required:
        if k not in d:
            errors.append(
                f"{label}: bench_schema {schema} missing key {k!r}"
            )
    if not isinstance(d.get("value"), (int, float)):
        errors.append(f"{label}: non-numeric value {d.get('value')!r}")
    return errors


def validate_profile_file(path: str) -> List[str]:
    """Violations in one tuned-profile file: its structure, knob ranges
    and the filename/sig agreement the loader enforces
    (``tune.profiles.validate_file``)."""
    from pulsar_tlaplus_tpu_torch.tune.profiles import validate_file

    return validate_file(path)
