"""The harness's arithmetic and lookups, without a card."""

import json
import os
import subprocess
import sys

import pytest

from tlcbench import harness, tracing
from tlcbench.reference import compaction as RC


def test_roofline_bytes_from_shapes():
    kp = harness.load_roofline("key_plane")
    fl = harness.load_roofline("flush")
    # the scaled flush: 65,536 rows x 34 lanes, W = 20, K = 2
    lanes = 65536 * 34
    assert kp.bytes_needed(dict(lanes=lanes, W=20, K=2, new=0)) == \
        lanes * (80 + 1 + 8)
    assert fl.bytes_needed(dict(lanes=lanes, W=20, K=2, new=1000)) == \
        lanes * (8 + 1 + 8 + 1) + 1000 * 8
    # exact K = 3 keys of W = 3 rows
    assert kp.bytes_needed(dict(lanes=10, W=3, K=3, new=0)) == 10 * 25
    assert fl.bytes_needed(dict(lanes=10, W=3, K=3, new=2)) == \
        10 * 26 + 2 * 12


def test_every_cell_resolves_its_files():
    bench = harness.load_bench()
    names = {c["name"] for c in bench["configs"]}
    for cell in bench["workloads"]:
        assert cell["config"] in names
        cfg = harness.load_config(cell["config"])
        assert cfg["name"] == cell["config"]
        harness.load_reference(cfg["reference"])
        traffic = harness.load_traffic(cell["traffic"])
        assert traffic["kind"] in ("check", "simulate")
        for trace in (False, True):
            for m in harness.metrics_of(bench, cell["name"], trace):
                assert callable(harness.load_reader(m["name"]).read)
    for m in bench["per_layer"]:
        if "_roofline." in m["name"]:
            layer = m["name"].split("_roofline")[0]
            assert callable(harness.load_roofline(layer).bytes_needed)
    for c in bench["configs"]:
        assert harness.load_config(c["name"])["source"] == c["source"]


def test_cfg_text_parses_to_the_binding():
    from pulsar_tlaplus_tpu_torch.utils import cfg as cfgmod

    cfg = harness.load_config("compaction-scaled")
    c = cfgmod.to_constants(cfgmod.parse_cfg(harness.cfg_text(cfg)))
    assert (c.message_sent_limit, c.num_keys, c.num_values,
            c.max_crash_times, c.model_producer) == (64, 8, 2, 3, True)
    model = harness.build_model(cfg)
    assert (model.layout.total_bits, model.layout.W, model.A) == (
        cfg["state_bits"], cfg["row_words"], cfg["actions"])
    ref = harness.load_reference(cfg["reference"])
    assert RC.row_words(ref.consts(cfg["constants"])) == cfg["row_words"]
    geo = harness.load_config("georeplication-scaled-exact")
    gm = harness.build_model(geo)
    assert (gm.layout.total_bits, gm.layout.W, gm.A) == (
        geo["state_bits"], geo["row_words"], geo["actions"])


def _run(args, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "tlcbench/run.py", *args],
                          cwd=harness.ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = _run(["--workload", "compaction-scaled.check", "--seed", "7",
              "--seconds", "1", "--trace", "0"])
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_a_run_without_the_program_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files
    cannot run a cell."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "tlcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "tlcbench/run.py", "--workload",
         "compaction-scaled.check", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid, pid=1)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reader_on_a_synthetic_trace():
    ev = [
        _ev(tracing.WINDOW, "user_annotation", 0, 100),
        _ev("expand", "user_annotation", 0, 20),
        _ev("cudaLaunchKernel", "cuda_runtime", 5, 1, corr=1),
        _ev("key_plane", "user_annotation", 30, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 31, 1, corr=2),
        _ev("aten::item", "cpu_op", 50, 30),
        _ev("k_expand", "kernel", 10, 20, tid=7, corr=1),
        _ev("k_key", "kernel", 35, 5, tid=7, corr=2),
        _ev("k_lost", "kernel", 60, 10, tid=7, corr=99),
    ]
    r = tracing.read_trace(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["range_device_s"]["expand"] == pytest.approx(20e-6)
    assert r["range_device_s"]["key_plane"] == pytest.approx(5e-6)
    assert r["range_device_s"]["flush"] == 0
    assert r["unmatched_launches"] == 1
    assert r["device_ops"][0] == ["k_expand", pytest.approx(20e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(20e-6)
    assert gaps["expand: cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["key_plane"] == pytest.approx(5e-6)
    assert gaps["host (no traced op)"] == pytest.approx(30e-6)
    assert tracing.read_trace(ev[1:]) is None


def test_metric_readers_leave_out_what_they_cannot_read():
    from types import SimpleNamespace

    ctx = SimpleNamespace(window=dict(checks=[], peak_bytes=0,
                                      elapsed_s=1.0), trace=None,
                          setup_s=1.0, roofline=harness.load_roofline)
    bench = harness.load_bench()
    for m in bench["per_layer"]:
        assert harness.load_reader(m["name"]).read(ctx) is None
    assert harness.load_reader("peak_device_gib").read(ctx) is None


def test_benchmark_json_names_every_file():
    bench = harness.load_bench()
    assert bench["command"] == ["python3", "tlcbench/run.py"]
    assert bench["paths"] == ["tlcbench"]
    for c in bench["configs"]:
        assert c["file"] == f"tlcbench/configs/{c['name']}.json"
        assert os.path.exists(harness.ROOT / c["file"])
    json.dumps(bench)


class _FakeAllocator:
    """``torch.cuda``'s allocated and peak counters, driven by hand."""

    def __init__(self):
        self.now = self.top = 0

    def alloc(self, n):
        self.now += n
        self.top = max(self.top, self.now)

    def memory_allocated(self, dev=None):
        return self.now

    def max_memory_allocated(self, dev=None):
        return self.top

    def reset_peak_memory_stats(self, dev=None):
        self.top = self.now


def test_program_peak_leaves_out_what_the_harness_holds(monkeypatch):
    import torch

    from tlcbench import drivers

    fake = _FakeAllocator()
    for name in ("memory_allocated", "max_memory_allocated",
                 "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    peak = drivers.ProgramPeak(torch.device("cuda", 0))
    fake.alloc(100)  # the program's model, before the window
    peak.start()
    fake.alloc(900)  # a check's buffers: the program at 1,000
    assert peak.hold(lambda: fake.alloc(300) or "kept") == "kept"
    fake.alloc(-900)  # the check ends; the harness keeps its 300
    fake.alloc(800)  # the next check: the program at 900
    assert peak.read() == 1000
    fake.alloc(200)  # the program at 1,100, the allocator at 1,400
    assert peak.read() == 1100
    assert peak.held == 300
