"""The cross-run regression ledger of the PyTorch port
(``obs/ledger.py``) and the CLI's ``ledger`` subcommand against the JAX
package: records from every committed ``BENCH_*.json`` artifact and
from port and JAX streams, keys, digests, append/load/resolve, the
renderers and the gate equal the JAX functions' output, and ``ledger
add|list|show|compare|gate`` print and exit as the JAX CLI does.
Tolerance: exact equality."""

import contextlib
import glob
import io
import json
import os

import pytest
import torch

from pulsar_tlaplus_tpu import cli as jcli
from pulsar_tlaplus_tpu.engine.device_bfs import DeviceChecker as JChecker
from pulsar_tlaplus_tpu.models.compaction import CompactionModel as JModel
from pulsar_tlaplus_tpu.obs import ledger as jledger
from pulsar_tlaplus_tpu_torch import cli
from pulsar_tlaplus_tpu_torch.engine.device_bfs import DeviceChecker
from pulsar_tlaplus_tpu_torch.models.compaction import CompactionModel
from pulsar_tlaplus_tpu_torch.obs import ledger, report
from tests.helpers import SMALL_CONFIGS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = sorted(glob.glob(os.path.join(ROOT, "BENCH_*.json")))


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Two port streams (fused, stage) and a JAX stream of one binding."""
    tmp = tmp_path_factory.mktemp("ledger")
    c = SMALL_CONFIGS["producer_on"]
    out = []
    for fuse in ("level", "stage"):
        p = str(tmp / f"port_{fuse}.jsonl")
        DeviceChecker(CompactionModel(c), invariants=(), sub_batch=256,
                      visited_cap=1 << 12, fuse=fuse, device="cpu",
                      telemetry=p).run()
        out.append(p)
    p = str(tmp / "jax.jsonl")
    JChecker(JModel(c), invariants=(), sub_batch=256, visited_cap=1 << 12,
             frontier_cap=1 << 12, telemetry=p).run()
    out.append(p)
    return out


def test_records_from_every_bench_artifact_equal_jax():
    assert BENCH
    for path in BENCH:
        assert ledger.record_from_file(path) == jledger.record_from_file(path)
        with open(path) as f:
            d = json.load(f)
        assert ledger.record_from_bench(d, source=path) == \
            jledger.record_from_bench(d, source=path)


def test_records_from_streams_equal_jax(streams):
    for p in streams:
        ev = report.load_events(p)[0]
        rec = ledger.record_from_stream(ev, source=p)
        assert rec == jledger.record_from_stream(ev, source=p)
        assert rec == ledger.record_from_file(p)
        assert ledger.config_key(rec["values"]) == rec["key"]


def test_ledger_file_and_renderers_equal_jax(streams, tmp_path):
    recs = [ledger.record_from_file(p) for p in BENCH + streams]
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    assert ledger.append(a, recs) == jledger.append(b, recs) == len(recs)
    assert ledger.append(a, recs[:2]) == jledger.append(b, recs[:2]) == 0
    got, want = ledger.load(a), jledger.load(b)
    assert got == want
    assert ledger.validate_ledger(a) == jledger.validate_ledger(b) == []
    assert ledger.render_list(got) == jledger.render_list(want)
    key = got[-1]["key"]
    assert ledger.render_list(got, key=key) == \
        jledger.render_list(want, key=key)
    for ref in ("1", got[-1]["digest"][:8], os.path.basename(streams[0])):
        assert ledger.resolve(got, ref) == jledger.resolve(want, ref)
        r = ledger.resolve(got, ref)
        assert ledger.render_show(r) == jledger.render_show(r)
    x, y = got[-3], got[-1]
    assert ledger.compare(x, y) == jledger.compare(x, y)
    assert ledger.render_compare(x, y) == jledger.render_compare(x, y)
    for th in (0.0, 0.1, 10.0):
        v = ledger.gate(x, y, threshold=th)
        assert v == jledger.gate(x, y, threshold=th)
        assert ledger.render_gate(v) == jledger.render_gate(v)
    for ctx in ("same", "none", "any"):
        assert [ledger.baseline_matches_profile(r, ctx, y) for r in got] \
            == [jledger.baseline_matches_profile(r, ctx, y) for r in got]
    assert [ledger.warm_of(r) for r in got] == \
        [jledger.warm_of(r) for r in got]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def test_cli_ledger_equals_jax(streams, tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    files = BENCH[-2:] + streams

    def both(*argv):
        got = _run(cli.main, ["ledger", "--ledger", a, *argv])
        want = _run(jcli.main, ["ledger", "--ledger", b, *argv])
        assert got[0] == want[0], argv
        assert got[1].replace(a, "L") == want[1].replace(b, "L"), argv
        assert got[2].replace(a, "L") == want[2].replace(b, "L"), argv
        return got[0]

    assert both("gate") == 2  # an empty ledger
    assert both("add", *files) == 0
    assert both("add", files[0]) == 0  # idempotent by digest
    assert both("list") == 0
    assert both("show", "2") == 0
    assert both("show", streams[1]) == 0
    assert both("compare", BENCH[-2], BENCH[-1]) == 0
    assert both("compare", streams[0], streams[2]) == 0
    both("gate")
    both("gate", "--baseline", streams[0], "--current", streams[1],
         "--threshold", "0.0")
    both("gate", "--baseline", streams[2], "--current", streams[0],
         "--keys", "dispatches_per_level", "work_units_per_state")
    assert both("show", "no-such-ref") == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert both("add", str(bad)) == 2
