"""Spans around the port's layers, taken from outside the port, and the
reading of a ``torch.profiler`` trace.

The benchmark edits no file of the port.  It puts a named
``record_function`` range around each layer it can reach from outside:

- ``expand``: the model's ``successors`` and its layout's ``pack`` /
  ``unpack``, through a model object that wraps the port's model
  (:class:`TracedModel`);
- ``key_plane`` and ``flush``: ``ops.tiles.key_plane`` and
  ``ops.tiles.flush_tiles``, which the engine calls through the module's
  attributes, replaced for the traced run (:func:`patched_tiles`).

:func:`read_trace` turns a Chrome trace of the window into the device
seconds under each range, the device's busy seconds (the union of its
operations' intervals), the operations that took most time and the
longest idle gaps by what the host was doing then.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGES = ("expand", "key_plane", "flush")
WINDOW = "tlcbench.window"
NAME_CHARS = 200  # a device operation's name in the breakdown


def _ranged(name: str, fn):
    import torch

    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call


class _TracedLayout:
    """The model's layout with ``pack`` and ``unpack`` under ``expand``."""

    def __init__(self, layout):
        self._inner = layout
        self.pack = _ranged("expand", layout.pack)
        self.unpack = _ranged("expand", layout.unpack)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class TracedModel:
    """A model whose ``successors`` (and layout) run under ``expand``.
    ``on_successors(states)`` is called before each ``successors`` call
    (the simulate cell records sampled walkers there)."""

    def __init__(self, model, ranges: bool = True, on_successors=None):
        self._inner = model
        self._ranges = ranges
        self._hook = on_successors
        self.layout = _TracedLayout(model.layout) if ranges else model.layout
        self._succ = (_ranged("expand", model.successors) if ranges
                      else model.successors)

    def successors(self, states):
        if self._hook is not None:
            self._hook(states)
        return self._succ(states)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@contextlib.contextmanager
def patched_tiles():
    """``tiles.key_plane`` and ``tiles.flush_tiles`` under their ranges
    for the duration of the block."""
    from pulsar_tlaplus_tpu_torch.ops import tiles

    saved = tiles.key_plane, tiles.flush_tiles
    tiles.key_plane = _ranged("key_plane", saved[0])
    tiles.flush_tiles = _ranged("flush", saved[1])
    try:
        yield
    finally:
        tiles.key_plane, tiles.flush_tiles = saved


def profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


# ------------------------------------------------------- trace reading


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_trace(events: List[dict]) -> Optional[dict]:
    """The window's device time by range, busy and window seconds,
    top device operations and idle gaps, from Chrome trace events (the
    ``traceEvents`` of ``export_chrome_trace``).  None when the trace
    holds no window range or no device operation."""
    host, dev, launches = [], [], {}
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
            continue
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif e.get("name") == WINDOW and cat == "user_annotation":
            ts = float(e["ts"])
            window = (ts, ts + float(e.get("dur", 0.0)), e.get("tid"))
        host.append(e)
    if window is None or not dev:
        return None
    w0, w1, tid = window
    # the ranges on the window's thread, disjoint: found by bisection
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in host
                   if e.get("tid") == tid and e.get("name") in RANGES
                   and e.get("cat") == "user_annotation")
    starts = [a for a, _b, _n in spans]

    def range_of(launch) -> Optional[str]:
        if launch is None or launch.get("tid") != tid:
            return None
        t = float(launch["ts"])
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            return spans[i][2]
        return None

    dev.sort(key=lambda e: float(e["ts"]))
    labels = []
    unmatched = 0
    for e in dev:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        unmatched += launch is None
        labels.append(range_of(launch))
    # a device operation whose launch the trace lost takes the range of
    # its stream neighbours when both agree (stream order)
    for i in range(1, len(dev) - 1):
        if labels[i] is None and launches.get(
                (dev[i].get("args") or {}).get("correlation")) is None:
            if labels[i - 1] is not None and labels[i - 1] == labels[i + 1]:
                labels[i] = labels[i - 1]
    by_range = {name: 0.0 for name in RANGES}
    by_name: Dict[str, float] = {}
    busy_iv = []
    for e, lab in zip(dev, labels):
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        busy_iv.append((a, b))
        if lab is not None:
            by_range[lab] += b - a
        name = e.get("name", "?")[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy = _union(busy_iv)
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle_by: Dict[str, float] = {}
    mine = [e for e in host if e.get("tid") == tid and e.get("name") != WINDOW]
    for (a, b), lab in zip(gaps, _host_labels(mine, [(a + b) / 2
                                                     for a, b in gaps])):
        idle_by[lab] = idle_by.get(lab, 0.0) + (b - a)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        range_device_s={k: v / 1e6 for k, v in by_range.items()},
        device_ops=[[n, s / 1e6] for n, s in top_ops],
        idle_gaps=[[n, s / 1e6] for n, s in top_gaps],
        device_op_count=len(dev),
        unmatched_launches=unmatched,
    )


def _host_labels(host: List[dict], times: List[float]) -> List[str]:
    """For each time (in increasing order), the innermost host event of
    one thread running then, under the benchmark range it lies in: what
    the host was doing while the device idled.  Events of one thread
    nest, so the running event that ends first is the innermost."""
    evs = sorted(host, key=lambda e: float(e.get("ts", 0.0)))
    live, ranges, out, i = [], [], [], 0
    for t in times:
        while i < len(evs) and float(evs[i].get("ts", 0.0)) <= t:
            e = evs[i]
            end = float(e["ts"]) + float(e.get("dur", 0.0))
            heapq.heappush(live, (end, i, e.get("name", "?")))
            if e.get("name") in RANGES:
                heapq.heappush(ranges, (end, i, e["name"]))
            i += 1
        for h in (live, ranges):
            while h and h[0][0] < t:
                heapq.heappop(h)
        if not live:
            out.append("host (no traced op)")
            continue
        inner = live[0][2]
        rng = ranges[0][2] if ranges else None
        out.append(f"{rng}: {inner}" if rng and rng != inner else inner)
    return out


def load_trace(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])
