"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m wmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell's entry
there names a configuration (wmbench/configs/<config>.json, whose
`system` names wmbench/systems/<system>.py) and a traffic mix
(wmbench/traffic/<traffic>.json, whose `kind` names the generator
wmbench/traffic/<kind>.py); its check limits are wmbench/limits/
<workload>.json and each metric's reader is wmbench/metrics/<metric>.py.
Nothing here names a cell, a configuration or a metric.

A run: set-up (imports, the card, the cell's weights and data, `warmup`
requests), then a closed loop of one client for `--seconds`: a request
starts only before the time has passed, and the window runs from the first
request's start to the last one's end. Peak memory is the allocator's peak
over the window. With --trace 1 each request records the program's phase
marks (CUDA events) and, after the window, `trace_requests` more requests
run under torch.profiler. Then the program is freed and the check compares
the sampled requests' outputs with the plain reference. The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit.

Exit codes: 2 without a CUDA card (or with fewer than the cell asks for),
3 when a JAX module is loaded once the window has closed, 1 on an error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import ModuleType, SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hunyuanworld_mirror_tpu")


def cache_env(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout; no JAX through a
    library that would load it by itself."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(f"wmbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(man: dict, workload: str, here: Path = HERE) -> SimpleNamespace:
    """The workload's entry, configuration, traffic, limits and metrics."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    cfg = load_json(here.parent / conf["file"])
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")

    def applies(m):
        return workload in m.get("workloads", [workload])

    return SimpleNamespace(
        here=here, workload=w, cfg=cfg, traffic=traffic,
        limits=load_json(here / "limits" / f"{workload}.json"),
        end_to_end=[m for m in man["end_to_end"] if applies(m)],
        per_layer=[m for m in man["per_layer"] if applies(m)])


def forbidden_loaded() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _phases(marks: list) -> Dict[str, float]:
    """Each mark's ms since the one before it (the first: since "start")."""
    out = {}
    for (_, a), (name, b) in zip(marks[:-1], marks[1:]):
        out[name] = a.elapsed_time(b)
    return out


def run_cell(parts: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device: str, t_start: float = T_START, log=print) -> dict:
    """Set up, measure, trace and check one cell on `device`; -> the result
    dict (the check's numbers under "checks")."""
    import torch
    from wmbench import trace as tracing
    from wmbench.frozen import peaks

    cuda = device == "cuda"
    traffic = parts.traffic
    gen = importlib.import_module(f"wmbench.traffic.{traffic['kind']}")
    system = importlib.import_module(f"wmbench.systems.{parts.cfg['system']}")
    spec = None
    if cuda:
        name = torch.cuda.get_device_name(0)
        spec = peaks.spec_for(name)
        log(f"card: {peaks.card_line()}; peaks {spec.peak_flops_bf16:.3e} bf16, "
            f"{spec.peak_flops_f32:.3e} f32 FLOP/s, {spec.hbm_bytes_per_s:.3e} B/s "
            f"at {spec.power_limit_w} W")
    cell = system.build(parts.cfg, traffic, seed, device, gen)
    cell.log = log
    for i in range(traffic["warmup"]):
        cell.request(-1 - i, None)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; {cell.counters()} after {traffic['warmup']} warm-up requests")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lat, spans = [], []
    i = 0
    t0 = t_end = time.perf_counter()
    while True:
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
        marks = [] if (trace and cuda) else None
        cell.request(i, marks)
        t_end = time.perf_counter()
        lat.append(t_end - t)
        if marks:
            spans.append(_phases(marks))
        i += 1
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loaded = forbidden_loaded()
    if loaded:
        raise ForbiddenModules(loaded)
    log(f"window {window_s:.3f} s, {i} requests; {cell.counters()}")

    tr = None
    if trace:
        cell.keep_profiled = True
        n_tr = traffic["trace_requests"]
        tr = tracing.profile(cell.request, i, n_tr, cuda)
        i += n_tr
        log(f"traced {n_tr} requests: {tr.launches / n_tr:.1f} kernel launches a request, "
            f"device busy {tr.busy_s:.6f} of {tr.window_s:.6f} s")
    work = cell.work() if trace else {}
    if work.get("n_isects"):
        log(f"intersections a camera: {work['n_isects']}")
    cell.close()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_check = time.perf_counter()
    checks = cell.check()
    log(f"check {time.perf_counter() - t_check:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0:.3f} GB allocated")

    ctx = SimpleNamespace(cfg=parts.cfg, traffic=traffic,
                          units=len(lat) * cell.units_per_request, window_s=window_s,
                          latencies=lat,
                          setup_s=setup_s, peak_bytes=peak, spans=spans, trace=tr,
                          work=work, spec=spec)
    wanted = parts.per_layer if trace else parts.end_to_end
    metrics = {}
    for m in wanted:
        value = load_module(parts.here / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    limits = parts.limits
    missing = set(checks) ^ set(limits)
    if missing:
        raise ValueError(f"checks and limits disagree on {sorted(missing)}")
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in checks.items())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": parts.workload["chips"], "memory_peak_bytes": int(peak)}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": bool(ok), "attempted": i, "failed": 0, "metrics": metrics,
              "device": device_info}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = {k: {"value": float(v), "limit": float(limits[k])}
                        for k, v in checks.items()}
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names: List[str]):
        super().__init__(f"JAX modules loaded: {names}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    man = manifest()
    parts = cell_parts(man, args.workload)

    import torch
    need = parts.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"wmbench: the cell needs {need} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2

    def log(text):
        print(text, file=sys.stderr, flush=True)

    try:
        result = run_cell(parts, args.seed, args.seconds, bool(args.trace), "cuda", log=log)
    except ForbiddenModules as e:
        log(f"wmbench: {e}")
        return 3
    loaded = forbidden_loaded()
    if loaded:
        log(f"wmbench: JAX modules loaded: {loaded}")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
