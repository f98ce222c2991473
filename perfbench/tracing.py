"""Spans, counters and the device trace of a traced run.

The benchmark puts its spans on from its own files: ``wrap`` replaces an
attribute of the program (a module function, an instance's method) by a
wrapper that opens a ``torch.profiler.record_function`` span named
``perfbench.<name>`` and records the host interval of each call in a
``Spans`` object. Counters are plain integers the drivers keep.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) inside the span ``perfbench.window``, with the device drained at
both ends, exports the Chrome trace to a temporary file and reduces it:

- ``window_s``: the length of the ``perfbench.window`` span;
- ``busy_s``: the union of the intervals in which a kernel, copy or memset
  ran on the device, inside the window (overlaps counted once);
- ``spans``: for each benchmark span, the device seconds of the kernels
  launched from inside it (a launch is found by its runtime or driver API
  event on the span's thread, its kernel by the correlation id);
- ``device_ops``: the ten kernels that took the most device time, summed by
  name; ``idle_gaps``: the ten longest intervals of the window with nothing
  on the device, named by what the host was doing as each began (the
  innermost benchmark span and the innermost operator open on any thread).
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


class Spans:
    """Host intervals (perf_counter seconds) of each named span."""

    def __init__(self):
        self.intervals: dict[str, list[tuple[float, float]]] = defaultdict(list)

    def total(self, name: str) -> float:
        return sum(b - a for a, b in self.intervals.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.intervals.get(name, ()))


def wrap(owner, attr: str, name: str, spans: Spans, on_call=None):
    """Replace ``owner.attr`` by a spanned wrapper; ``on_call(args, kwargs,
    result, t0, t1)`` sees each call. Returns a function that puts the
    original back."""
    original = getattr(owner, attr)
    label = f"perfbench.{name}"

    @functools.wraps(original)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        with torch.profiler.record_function(label):
            result = original(*args, **kwargs)
        t1 = time.perf_counter()
        spans.intervals[name].append((t0, t1))
        if on_call is not None:
            on_call(args, kwargs, result, t0, t1)
        return result

    setattr(owner, attr, wrapper)
    return lambda: setattr(owner, attr, original)


def _union(intervals):
    total = 0.0
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    for a, b in merged:
        total += b - a
    return total, merged


def reduce_trace(events: list[dict]) -> dict:
    """The numbers of the module docstring from a Chrome trace's events
    (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        return {}
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    inside = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
              for e in device if float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy_us, merged = _union([iv for iv in inside if iv[1] > iv[0]])

    by_corr = defaultdict(float)
    ops = defaultdict(float)
    for e in device:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] += float(e["dur"])
        if e.get("cat") == "kernel":
            ops[e["name"]] += float(e["dur"])
    launches = sorted(
        (float(e["ts"]), e.get("tid"), (e.get("args") or {}).get("correlation"))
        for e in xs if e.get("cat") in LAUNCH_CATS)
    launch_ts = [t for t, _, _ in launches]
    spans = defaultdict(lambda: {"count": 0, "device_s": 0.0})
    for e in xs:
        name = e.get("name", "")
        if e.get("cat") != "user_annotation" or not name.startswith("perfbench.") \
                or name == WINDOW:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        lo, hi = bisect.bisect_left(launch_ts, a), bisect.bisect_right(launch_ts, b)
        dev = sum(by_corr.get(c, 0.0) for _, tid, c in launches[lo:hi] if tid == e.get("tid"))
        s = spans[name[len("perfbench."):]]
        s["count"] += 1
        s["device_s"] += dev * 1e-6

    gaps = []
    prev = w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")]
    idle = []
    for a, b in gaps[:10]:
        covering = [e for e in host if float(e["ts"]) <= a <= float(e["ts"]) + float(e["dur"])]
        mark = [e["name"] for e in covering if e.get("cat") == "user_annotation"
                and e["name"] != WINDOW]
        op = [e["name"] for e in covering if e.get("cat") == "cpu_op"]
        inner_mark = min((e for e in covering if e["name"] in mark),
                         key=lambda e: float(e["dur"]), default=None)
        inner_op = min((e for e in covering if e["name"] in op),
                       key=lambda e: float(e["dur"]), default=None)
        label = " / ".join(x["name"] for x in (inner_mark, inner_op) if x is not None)
        idle.append([label or "host outside any operator", (b - a) * 1e-6])
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top = [(k if len(k) <= NAME_CHARS else k[: NAME_CHARS - 3] + "...", v) for k, v in top]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "spans": dict(spans),
        "device_ops": [[k, v * 1e-6] for k, v in top],
        "idle_gaps": idle,
    }


def profile(fn) -> dict:
    """Runs ``fn()`` under the profiler (see the module docstring) and
    returns the reduced trace; the trace file is removed."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return reduce_trace(events)


def idle_percent(trace: dict) -> float | None:
    """100 x (1 - busy / window) of a reduced trace; None without one or
    where nothing ran on the device."""
    if not trace or not trace.get("window_s") or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
