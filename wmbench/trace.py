"""A short profiled stretch of requests, read back from torch.profiler's
Chrome trace: the device's kernels, its busy time, and the breakdown.

Device activity is every kernel, copy and fill in the trace; `busy_s` is
the length of their union. An idle gap is a stretch of the device timeline
between two busy intervals; it is named by the benchmark's own span open on
the host at the gap's start (`wmbench.request` around each request, or
"between requests") and by the operator that launched the kernel after it.
The trace file lives in a temporary directory and is deleted once read.
"""

import json
import os
import shutil
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "wmbench.request"


class Trace(NamedTuple):
    kernels: List[Tuple[str, float, float]]   # (name, start us, duration us)
    busy_s: float
    window_s: float
    device_ops: List[List]                    # [[name, seconds], ...] top 10
    idle_gaps: List[List]                     # [[name, seconds], ...] top 10
    launches: int                             # kernels in the stretch


def profile(request: Callable[[int], None], first: int, n: int, cuda: bool) -> Trace:
    """Run request(first), ..., request(first + n - 1) under the profiler,
    each inside the span SPAN; `window_s` is their host-clock time."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="wmbench-trace-")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(first, first + n):
                with torch.profiler.record_function(SPAN):
                    request(i)
            window = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summarize(events, window)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: List[Dict], window_s: float) -> Trace:
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in dev
               if e.get("cat") == "kernel"]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"][:160]] += float(e["dur"]) * 1e-6
    device_ops = sorted(([k, v] for k, v in by_name.items()), key=lambda x: -x[1])[:10]

    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op" and "External id" in e.get("args", {}):
            ops[e["args"]["External id"]] = e["name"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("name") == SPAN
             and e.get("cat") in ("user_annotation", "cpu_op")]
    starts = {}
    for e in dev:
        starts.setdefault(float(e["ts"]), ops.get(e.get("args", {}).get("External id"), "?"))
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy[:-1], busy[1:]):
        open_span = SPAN if any(a <= e0 < b for a, b in spans) else "between requests"
        gaps[f"{open_span} > {starts.get(s1, '?')}"] += (s1 - e0) * 1e-6
    idle_gaps = sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:10]
    return Trace(kernels, busy_s, window_s, device_ops, idle_gaps, len(kernels))


def device_seconds(trace: Trace, *names: str) -> float:
    """Summed device time of the kernels whose name holds any of `names`."""
    return sum(d for n, _, d in trace.kernels if any(x in n for x in names)) * 1e-6
