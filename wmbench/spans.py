"""The device trace by the program's own spans, and a tool that reads one.

`summarize(events, window_s)` reads a torch.profiler Chrome trace whose
requests ran inside the program's `utils/profiling.recording()`, where each
program span is a `user_annotation` on the host timeline that the profiler
aligns the kernels to. It keeps trace.summarize's numbers (the same busy
time, gaps and launches) and adds:
- each idle gap named by the innermost program span open on the host at
  the gap's start, falling back to trace.SPAN or "between requests" as
  trace.summarize does, then by the operator that launched the kernel
  after it;
- each kernel, copy and fill put under the innermost span open when its
  runtime call ran, matched by the trace's correlation id: per span name
  its kernel launches, device-busy seconds (the union of its device
  intervals), idle seconds (the gaps it names) and top 3 kernels by
  device time.

    python3 -m wmbench.spans --workload <cell> --seed <n> [--cost-seconds S]

(card only) builds the cell and warms it up as wmbench.run does, then:
(1) over one request under torch.cuda.set_sync_debug_mode("warn"), the
synchronising calls torch reports from inside the program against the
program's own `host_syncs` count; (2) the traffic's trace_requests under
the profiler with recording on, one stderr line per span; (3) windows of
S seconds with recording off and on in turns (off, on, on, off, ...),
units a second each. The last line of standard output is one JSON object.
"""

import argparse
import collections
import contextlib
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

from wmbench import trace as tracing

PROGRAM = "hunyuanworld_mirror_tpu_torch"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class SpanTrace(NamedTuple):
    base: tracing.Trace         # trace.summarize on the same events
    idle_gaps: List[List]       # [[name, seconds], ...] top 10, by program span
    spans: Dict[str, Dict]      # span name -> launches, busy_s, idle_s, top


def _innermost(intervals: List[Tuple[float, float, str]],
               times: List[float]) -> List[Optional[str]]:
    """For each time the name of the innermost of the nested intervals
    (start, end, name) holding it, None where none does."""
    iv = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out: List[Optional[str]] = [None] * len(times)
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(iv) and iv[j][0] <= t:
            while stack and stack[-1][1] <= iv[j][0]:
                stack.pop()
            stack.append(iv[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def summarize(events: List[Dict], window_s: float) -> SpanTrace:
    base = tracing.summarize(events, window_s)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in tracing.DEVICE_CATS]
    busy = tracing._union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    annots = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    # the program runs on the thread that opens the requests
    tids = {e.get("tid") for e in annots if e["name"] == tracing.SPAN}
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in annots if not tids or e.get("tid") in tids]

    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op" and "External id" in e.get("args", {}):
            ops[e["args"]["External id"]] = e["name"]
    starts = {}
    for e in dev:
        starts.setdefault(float(e["ts"]), ops.get(e.get("args", {}).get("External id"), "?"))
    pairs = list(zip(busy[:-1], busy[1:]))
    names = _innermost(intervals, [e0 for (_, e0), _ in pairs])
    gaps: Dict[str, float] = collections.defaultdict(float)
    idle_by_span: Dict[str, float] = collections.defaultdict(float)
    for ((_, e0), (s1, _)), name in zip(pairs, names):
        name = name or "between requests"
        gaps[f"{name} > {starts.get(s1, '?')}"] += (s1 - e0) * 1e-6
        idle_by_span[name] += (s1 - e0) * 1e-6
    idle_gaps = sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:10]

    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    owned = [e for e in dev if e.get("args", {}).get("correlation") in launched]
    owners = _innermost(intervals, [launched[e["args"]["correlation"]] for e in owned])
    per: Dict[str, Dict] = collections.defaultdict(
        lambda: {"launches": 0, "intervals": [], "kernels": collections.defaultdict(float)})
    for e, name in zip(owned, owners):
        p = per[name or "between requests"]
        s = float(e["ts"])
        p["intervals"].append((s, s + float(e["dur"])))
        p["kernels"][e["name"][:120]] += float(e["dur"]) * 1e-6
        p["launches"] += e.get("cat") == "kernel"
    spans = {}
    for name in sorted(set(per) | set(idle_by_span)):
        p = per.get(name, {"launches": 0, "intervals": [], "kernels": {}})
        spans[name] = {
            "launches": p["launches"],
            "busy_s": sum(b - a for a, b in tracing._union(p["intervals"])) * 1e-6,
            "idle_s": idle_by_span.get(name, 0.0),
            "top": sorted(([k, v] for k, v in p["kernels"].items()), key=lambda x: -x[1])[:3]}
    return SpanTrace(base, idle_gaps, spans)


def profile_events(request, first: int, n: int) -> Tuple[List[Dict], float]:
    """request(first), ..., request(first + n - 1) under the profiler, each
    inside trace.SPAN and the program's recording -> (the Chrome trace's
    events, the host-clock seconds of the n requests)."""
    import torch
    from hunyuanworld_mirror_tpu_torch.utils import profiling
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tmp = tempfile.mkdtemp(prefix="wmbench-spans-")
    try:
        with torch.profiler.profile(activities=acts) as prof, profiling.recording():
            t0 = time.perf_counter()
            for i in range(first, first + n):
                with torch.profiler.record_function(tracing.SPAN):
                    request(i)
            window = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], window
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sync_sites(request, i: int) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Request i under torch.cuda.set_sync_debug_mode("warn") and the
    program's recording -> (each synchronising call torch reports from
    inside the program, by its innermost program file:line, with its
    count; the program's own host_syncs count by innermost span, "" for
    the request outside every span)."""
    import torch
    from hunyuanworld_mirror_tpu_torch.utils import profiling
    sites: Dict[str, int] = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1] if PROGRAM in f.filename]
        if frames:
            f = frames[-1]
            sites[f"{f.filename.split(PROGRAM + os.sep)[-1]}:{f.lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings(), profiling.recording() as rec:
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            request(i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    by_span: Dict[str, int] = collections.Counter()
    for r in rec.requests:
        by_span[""] += r.counts.get("host_syncs", 0)
        for sp in r.spans:
            n = sp.counts.get("host_syncs", 0)
            by_span[sp.name] += n
            by_span[""] -= n
    return dict(sites), {k: v for k, v in by_span.items() if v}


def rates(request, first: int, units: float, seconds: float,
          rounds: int) -> Dict[str, List[float]]:
    """Windows of `seconds` with recording off and on in turns (off, on,
    on, off per round) -> units a second of each window, by "off" / "on"."""
    from hunyuanworld_mirror_tpu_torch.utils import profiling
    out: Dict[str, List[float]] = {"off": [], "on": []}
    i = first
    for mode in ("off", "on", "on", "off") * rounds:
        rec = profiling.Recorder()
        with profiling.recording(rec) if mode == "on" else contextlib.nullcontext():
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                request(i)
                i, n = i + 1, n + 1
            out[mode].append(n * units / (time.perf_counter() - t0))
        rec.resolve()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from wmbench import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost-seconds", type=float, default=8.0)
    ap.add_argument("--cost-rounds", type=int, default=2)
    args = ap.parse_args(argv)
    run.cache_env(run.ROOT)
    parts = run.cell_parts(run.manifest(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("wmbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    from wmbench.frozen import peaks

    def log(text):
        print(text, file=sys.stderr, flush=True)

    traffic = parts.traffic
    gen = importlib.import_module(f"wmbench.traffic.{traffic['kind']}")
    system = importlib.import_module(f"wmbench.systems.{parts.cfg['system']}")
    card = peaks.card_line()
    log(f"card: {card}")
    cell = system.build(parts.cfg, traffic, args.seed, "cuda", gen)
    cell.log = log
    for i in range(traffic["warmup"]):
        cell.request(-1 - i, None)
    i = 0

    sites, by_span = sync_sites(cell.request, i)
    i += 1
    reported, counted = sum(sites.values()), sum(by_span.values())
    log(f"host syncs a request: torch reports {reported}, the program counts {counted}")
    for site, n in sorted(sites.items()):
        log(f"  sync {n} x {site}")
    for name, n in sorted(by_span.items()):
        log(f"  counted {n} in span {name or '(the request)'}")

    n_tr = traffic["trace_requests"]
    events, window = profile_events(cell.request, i, n_tr)
    i += n_tr
    st = summarize(events, window)
    log(f"traced {n_tr} requests: {st.base.launches / n_tr:.1f} launches a request, "
        f"busy {st.base.busy_s:.6f} of {window:.6f} s")
    for name, s in sorted(st.spans.items(), key=lambda kv: -kv[1]["busy_s"]):
        top = "; ".join(f"{k} {1e3 * v / n_tr:.3f} ms" for k, v in s["top"])
        log(f"span {name}: {s['launches'] / n_tr:.1f} launches, busy "
            f"{1e3 * s['busy_s'] / n_tr:.3f} ms, idle {1e3 * s['idle_s'] / n_tr:.3f} ms "
            f"a request; top: {top}")
    for name, sec in st.idle_gaps:
        log(f"gap {name}: {1e3 * sec / n_tr:.3f} ms a request")

    cost = rates(cell.request, i, cell.units_per_request, args.cost_seconds, args.cost_rounds)
    log(f"units a second, recording off {cost['off']}, on {cost['on']}")
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": card,
                      "host_syncs": counted, "torch_syncs": reported, "sync_sites": sites,
                      "host_syncs_by_span": by_span,
                      "launches": st.base.launches / n_tr,
                      "busy_s": st.base.busy_s, "window_s": window,
                      "spans": st.spans, "idle_gaps": st.idle_gaps, "cost": cost}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
