"""Benchmark of the port: frames/s of 518 px WorldMirror inference on one card.

    python -m hunyuanworld_mirror_tpu_torch.bench [--seed 0]
    python -m hunyuanworld_mirror_tpu_torch.bench --row '{"stage": "headline"}'
    python -m hunyuanworld_mirror_tpu_torch.bench --device cpu --preset tiny --img 56

The twin of the root bench.py. The parent process never touches the card:
each row runs as `python -m hunyuanworld_mirror_tpu_torch.bench --row
'<json>'` in a subprocess of its own, prints one JSON line and exits, which
releases the card and the caching allocator before the next row. The parent
prints each row's line, tagged {"row": ...}, as soon as the row ends, then
the assembled line last. WM_BENCH_BUDGET_S bounds the whole run (default
BUDGET_S = 1200 s; the default run on an H100 takes well under half of it,
PERF.md §5): a row starts only with ROW_MIN_S left, runs at most until the
budget ends, and is listed under "skipped" otherwise. An error in a row,
out-of-memory included, is that row's "failed" with the error's text; no
row is retried at another size, and the run exits 1 if any row that ran
failed.

Rows:
- headline: the `large` model, B=1, S=4, 518 px, bf16 parameters, bf16
  trunk, f32 heads, the Gaussian render on the flat route (each camera's
  exact list of the live slots), the cameras the model's own predictions. One warm-up, then N_TIMED forwards through
  `infer.reconstruct`: `value` is S over the median host-clock time of a
  forward ending in torch.cuda.synchronize (e2e_wall_ms), `e2e_device_ms`
  the same forwards' median between the CUDA events the model records
  (min, max and count beside it), `phases_ms` each phase's median between
  those events (encoder, trunk, heads, gs_render) and `phases_sum_ms` their
  sum. `mfu` is model_flops' total per wall second over the card's bf16
  peak; `sol` holds the least time of the matmul phases (the encoder and
  trunk at the bf16 peak, the heads at the f32 peak: they run in f32 with
  TF32 off) and of the render (render_work_model's bytes at the HBM rate),
  and their sum's share of the wall time. `render_n_isects` (per camera)
  shows the render's load; `exact_repeat_max_delta` holds the last timed
  render against one more forward of the same weights and images (the
  voxel merge sums with float atomics on the card).
- long_seq (S=32) and long_seq64 (S=64), each a `fwd` row (no render),
  a `render` row (with render_n_dropped) and a `ba` row
  (`refine.ba.refine_cameras`, 12 iterations, landmark stride 16, 32 at
  S=64, on the predictions of a forward without the Gaussian head). The
  heads run over HEAD_CHUNK[S] frames at a time, fixed in advance.
- comm: comm_report(32, 518, 518, 8), analytic.

Departures from the root bench.py: the trunk's FLOPs count the 7 special
tokens it runs with under enable_cond (the root counts 5); the render's
bytes count each sort operand read once and written once (the root counts
the stages of a TPU bitonic sort), each camera's intersection sort over its
live rows (the root: a coverage pre-sort and the prefix rows) and the
blend's staged rows from this run's intersections (the root: 1024 a tile); no configuration ladder and
no head_chunk retries; the JAX in-jit repeat harness (repeat_jit, _leaf_tap)
and the relay floor (measure_floor) are not ported, since eager PyTorch on
a local card has neither XLA's dead-code elimination nor a relay;
vs_baseline and baseline_note are dropped (their 2.0 f/s was an estimate,
never measured).

Images are drawn from --seed uniform in [0, 1]; the weights are random,
from seed 0. Every line carries the card's name and power limit
(utils/profiling.detect_chip). --device cpu rehearses the rows on the CPU
at a preset the caller names: the lines then say "chip": "cpu" and carry
null for every device metric (value, mfu, sol, achieved_tflops_per_s,
e2e_device_ms, phases_ms, peak memory); e2e_wall_ms is the CPU's. Without
a card and without --device cpu a row exits non-zero.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

BUDGET_S = 1200.0
ROW_MIN_S = 60.0
N_TIMED = 7
N_TIMED_LONG = 3
HEAD_CHUNK = {32: 4, 64: 2}
BA_STRIDE = {32: 16, 64: 32}
METRIC = "frames_per_sec_per_chip_518px"
UNIT = "frames/s/chip"
ROWS = [{"stage": "headline"}] + [{"stage": st, "s": s} for s in (32, 64)
                                  for st in ("fwd", "render", "ba")]
# the keys of a headline row's line (and of the final line)
HEADLINE_KEYS = ("metric", "value", "unit", "config", "chip", "power_limit_w",
                 "model_tflops_per_frame", "achieved_tflops_per_s", "mfu",
                 "e2e_wall_ms", "e2e_device_ms", "e2e_device_min_ms",
                 "e2e_device_max_ms", "n_forwards", "phases_ms", "phases_sum_ms",
                 "peak_memory_gb", "render_n_isects", "render_n_dropped",
                 "exact_repeat_max_delta", "sol")


# ---------------------------------------------------------------------------
# analytic model FLOPs (forward, bf16 trunk / f32 heads): the root bench's
# ---------------------------------------------------------------------------

def _block_flops(tokens: float, C: float, n_seq: float, seq_len: float,
                 mlp_ratio: float = 4.0) -> float:
    """One pre-LN transformer block: qkv(3C)+proj(C)+mlp(2*ratio*C) GEMMs
    plus the two attention matmuls."""
    linear = 2.0 * tokens * C * (4 * C + 2 * mlp_ratio * C)
    attn = 4.0 * n_seq * seq_len * seq_len * C
    return linear + attn


def encoder_flops(BS: int, P: int, C: int = 1024, depth: int = 24) -> float:
    """DINOv2 ViT-L/14 over B*S frames (cls + 4 reg + P patch tokens)."""
    N = P + 5
    return depth * _block_flops(BS * N, C, BS, N) + 2.0 * BS * P * (14 * 14 * 3) * C


def trunk_flops(B: int, S: int, P: int, C: int = 1024, depth: int = 24,
                n_special: int = 5) -> float:
    """24x alternating (frame, global) blocks."""
    Nf = P + n_special
    T = B * S * Nf
    frame = _block_flops(T, C, B * S, Nf)
    glob = _block_flops(T, C, B, S * Nf)
    return depth * (frame + glob)


def dpt_flops(S: int, H: int, W: int, dim_in: int = 2048, f: int = 256,
              ocs=(256, 512, 1024, 1024), output_dim: int = 4) -> float:
    """One DPT head over S frames at (H, W), patch 14 (models/dpt.py)."""
    ph, pw = H // 14, W // 14
    p2 = ph * pw
    fl = 0.0
    # token projections (1x1) + resizes
    for oc in ocs:
        fl += 2.0 * p2 * dim_in * oc
    fl += 2.0 * p2 * 16 * ocs[0] * ocs[0]        # convT 4x4 s4
    fl += 2.0 * p2 * 4 * ocs[1] * ocs[1]         # convT 2x2 s2
    fl += 2.0 * (p2 / 4) * 9 * ocs[3] * ocs[3]   # conv 3x3 s2
    # scratch layer_rn 3x3 -> f at each level resolution
    res = [16 * p2, 4 * p2, p2, p2 / 4]
    for r, oc in zip(res, ocs):
        fl += 2.0 * r * 9 * oc * f
    # refinenets: residual units (2 convs 3x3 f->f) + 1x1 out conv at 2x res
    units = [1, 2, 2, 2]  # refine4 has no res1
    for r, u in zip(res[::-1], units):
        fl += u * 2 * 2.0 * r * 9 * f * f
        fl += 2.0 * (4 * r) * f * f
    # output head: conv1 3x3 f->f/2 at 2*highest res, then 3x3 f/2->32 and
    # 1x1 32->out at full H*W
    fl += 2.0 * (4 * res[0]) * 9 * f * (f // 2)
    fl += 2.0 * H * W * 9 * (f // 2) * 32 + 2.0 * H * W * 32 * output_dim
    return S * fl


def model_flops(B: int, S: int, H: int, W: int, C: int = 1024,
                gs_dim: int = 256, n_special: int = 5) -> dict:
    """Analytic forward FLOPs by phase (the render is counted in bytes by
    render_work_model). `n_special`: the trunk's special tokens a frame,
    the root bench's 5 by default; the trunk runs with its config's
    patch_start_idx (7 under enable_cond), which the rows pass."""
    P = (H // 14) * (W // 14)
    enc = encoder_flops(B * S, P, C)
    trk = trunk_flops(B, S, P, C, n_special=n_special)
    heads = (dpt_flops(B * S, H, W, 2 * C, 256, output_dim=4) * 2  # pts, norm
             + dpt_flops(B * S, H, W, 2 * C, 256, output_dim=2)    # depth
             + dpt_flops(B * S, H, W, 2 * C, gs_dim, output_dim=2))  # gs
    # camera head: 4 steps x 4 blocks on B*S tokens of dim 2C
    heads += 4 * 4 * _block_flops(B * S, 2 * C, B, S)
    # gs param head convs at full res
    heads += B * S * H * W * (2.0 * 9 * (gs_dim // 2) * gs_dim
                              + 2.0 * gs_dim * 14)
    return {"encoder": enc, "trunk": trk, "heads": heads,
            "total": enc + trk + heads}


def comm_report(S: int, H: int, W: int, n_view_shards: int, C: int = 1024,
                depth: int = 24, n_splats: int = None, d_col: int = 4) -> dict:
    """Bytes moved per forward by ring attention (parallel/ring.py: each
    global layer passes every K and V shard around the view ring) and by
    the distributed render (ops/distributed.py: one exchange of projected
    splat rows a camera) when the views are sharded n_view_shards ways."""
    P = (H // 14) * (W // 14)
    Nf = P + 5
    kv_shard = 2 * (S // max(n_view_shards, 1)) * Nf * C * 2
    ring_layer = (n_view_shards - 1) * kv_shard
    n_splats = n_splats if n_splats is not None else S * H * W // 2
    a2a_cam = (n_splats // max(n_view_shards, 1)) * (6 + d_col) * 4 \
        * (n_view_shards - 1) // max(n_view_shards, 1)
    return {
        "view_shards": n_view_shards,
        "ring_bytes_per_global_layer_per_dev": ring_layer,
        "ring_bytes_total_per_dev": ring_layer * depth,
        "raster_all2all_bytes_per_camera_per_dev": a2a_cam,
        "raster_all2all_bytes_total_per_dev": a2a_cam * S,
    }


def render_work_model(S: int, H: int, W: int, n_isects, compact_fraction: float = 0.5,
                      tile_size: int = 16, d_channels: int = 4) -> dict:
    """The bytes the render phase must move (it is bound by bytes, not
    FLOPs), at the root bench's phases: the voxel-prune sort
    (18 operands over S*H*W rows), the compaction sort (13) and each
    camera's intersection sort (8 over its live rows, `n_isects`, this
    run's intersections a camera), each operand read once and written once;
    the blend's staged rows and written pixels
    (utils/profiling.rasterizer_bytes) for those intersections; the
    projection (9 values in, 8 out a splat)."""
    from .utils.profiling import rasterizer_bytes

    def sort_bytes(rows, n_ops):
        return 2.0 * rows * n_ops * 4.0

    N0 = S * H * W
    N = int(N0 * compact_fraction)
    n_tiles = math.ceil(W / tile_size) * math.ceil(H / tile_size)
    prune = sort_bytes(N0, 18)
    compact = sort_bytes(N0, 13)
    isect = sum(sort_bytes(k, 8) for k in n_isects)
    blend = sum(rasterizer_bytes(N, H * W, k / n_tiles, n_tiles, d_channels)
                for k in n_isects)
    proj = S * N * (9 + 8) * 4.0
    return {"bytes_total": prune + compact + isect + blend + proj,
            "bytes_isect_sorts": isect, "bytes_prune_compact": prune + compact,
            "bytes_blend": blend, "n_splats_compact": N}


# ---------------------------------------------------------------------------
# rows (each runs in its own subprocess)
# ---------------------------------------------------------------------------

def _device(args):
    """(device, card name, power limit W, spec or None on the CPU)."""
    if args.device == "cpu":
        return "cpu", "cpu", None, None
    from .utils.profiling import detect_chip
    spec, card, watts = detect_chip()
    return "cuda", card, watts, spec


def _build(args, dev, S, **cfg_kw):
    from .infer import PRESETS, load_model
    from .models.worldmirror import WorldMirrorConfig
    cfg = WorldMirrorConfig(img_size=args.img, rasterizer_impl="pallas",
                            **{**PRESETS[args.preset], **cfg_kw})
    model = load_model(cfg, device=dev)
    imgs = np.random.default_rng(args.seed).uniform(
        size=(1, S, args.img, args.img, 3)).astype(np.float32)
    return cfg, model, imgs


def _sync(dev):
    if dev == "cuda":
        import torch
        torch.cuda.synchronize()


def _stats(ms: List[float]) -> Tuple[float, float, float]:
    return float(np.median(ms)), float(min(ms)), float(max(ms))


def _peak_gb(dev):
    if dev != "cuda":
        return None
    import torch
    return torch.cuda.max_memory_allocated() / 1e9


def _reset_peak(dev):
    if dev == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats()


def _timed(dev, fn, n):
    """One warm-up, then n calls of fn(marks) on the host clock (each ended
    by a sync) -> (wall ms list, per-call phase dicts of the CUDA events'
    ms or None on the CPU, the last output)."""
    fn(None)
    _sync(dev)
    _reset_peak(dev)
    wall, phases = [], []
    for _ in range(n):
        marks = [] if dev == "cuda" else None
        t0 = time.perf_counter()
        out = fn(marks)
        _sync(dev)
        wall.append(1e3 * (time.perf_counter() - t0))
        if marks is not None:
            phases.append({name: marks[j - 1][1].elapsed_time(ev)
                           for j, (name, ev) in enumerate(marks) if j})
    return wall, (phases or None), out


def row_headline(args) -> dict:
    from .infer import reconstruct
    dev, card, watts, spec = _device(args)
    S = 4
    cfg, model, imgs = _build(args, dev, S)
    wall, phases, preds = _timed(dev, lambda marks: reconstruct(model, imgs, marks=marks),
                                 N_TIMED)
    peak = _peak_gb(dev)
    wall_med = float(np.median(wall))
    n_isects = [int(v) for v in preds["render_n_isects"][0].tolist()]
    n_dropped = int(preds["render_n_dropped"].sum())
    exact = preds["rendered_colors"].float()
    del preds
    exact2 = reconstruct(model, imgs)["rendered_colors"].float()

    out = {"metric": METRIC, "value": None, "unit": UNIT, "chip": card,
           "power_limit_w": watts,
           "config": {"preset": args.preset, "batch": 1, "views": S, "img": args.img,
                      "param_dtype": "bfloat16", "trunk_dtype": "bfloat16",
                      "head_dtype": cfg.head_dtype, "rasterizer_impl": cfg.rasterizer_impl,
                      "head_chunk": cfg.head_chunk,
                      "seed": args.seed, "device": dev},
           "model_tflops_per_frame": None, "achieved_tflops_per_s": None, "mfu": None,
           "e2e_wall_ms": wall_med, "e2e_device_ms": None, "e2e_device_min_ms": None,
           "e2e_device_max_ms": None, "n_forwards": len(wall), "phases_ms": None,
           "phases_sum_ms": None, "peak_memory_gb": peak,
           "render_n_isects": n_isects, "render_n_dropped": n_dropped,
           "exact_repeat_max_delta": float((exact2 - exact).abs().max()),
           "sol": None}
    fl = None
    if args.preset == "large":
        fl = model_flops(1, S, args.img, args.img, C=cfg.embed_dim, gs_dim=cfg.gs_dim,
                         n_special=cfg.vgt.patch_start_idx)
        out["model_tflops_per_frame"] = fl["total"] / S / 1e12
    if phases is not None:
        totals = [sum(p.values()) for p in phases]
        out["e2e_device_ms"], out["e2e_device_min_ms"], out["e2e_device_max_ms"] = (
            _stats(totals))
        out["phases_ms"] = {k: float(np.median([p[k] for p in phases]))
                            for k in phases[0]}
        out["phases_sum_ms"] = sum(out["phases_ms"].values())
    if spec is not None:
        dt = wall_med / 1e3
        out["value"] = S / dt
        if fl is not None:
            out["achieved_tflops_per_s"] = fl["total"] / dt / 1e12
            out["mfu"] = fl["total"] / dt / spec.peak_flops_bf16
            rw = render_work_model(S, args.img, args.img, n_isects,
                                   tile_size=model.gs_renderer.cfg.tile_size)
            head_peak = (spec.peak_flops_f32 if cfg.head_dtype == "float32"
                         else spec.peak_flops_bf16)
            t_mm = (fl["encoder"] + fl["trunk"]) / spec.peak_flops_bf16 + fl["heads"] / head_peak
            t_render = rw["bytes_total"] / spec.hbm_bytes_per_s
            out["sol"] = {"matmul_sol_ms": 1e3 * t_mm, "render_sol_ms": 1e3 * t_render,
                          "render_model_gb": rw["bytes_total"] / 1e9,
                          "e2e_sol_fraction": (t_mm + t_render) / dt}
    return out


def row_long(args, s: int, stage: str) -> dict:
    import torch
    from .infer import reconstruct
    from .refine import ba
    dev, card, watts, spec = _device(args)
    hc = HEAD_CHUNK[s]
    out = {"chip": card, "power_limit_w": watts, "views": s, "img": args.img,
           "head_chunk": hc}
    if stage == "ba":
        cfg, model, imgs = _build(args, dev, s, head_chunk=hc, enable_gs=False)
        x = {"img": torch.as_tensor(imgs, device=dev)}
        preds = model(x, render=False)
        keep = ("pts3d", "pts3d_conf", "depth", "camera_poses", "camera_intrs")
        preds = {k: preds[k] for k in keep}
        del model
        stride = BA_STRIDE[s]
        wall, _, res = _timed(dev, lambda _: ba.refine_cameras(preds, stride=stride,
                                                               iters=12), N_TIMED_LONG)
        med, lo, hi = _stats(wall)
        out.update(ba_ms=med, ba_min_ms=lo, ba_max_ms=hi, n_calls=len(wall),
                   ba_iters=12, ba_landmark_stride=stride,
                   ba_cost0=float(res["ba_cost0"]), ba_cost=float(res["ba_cost"]),
                   peak_memory_gb=_peak_gb(dev))
        return out
    cfg, model, imgs = _build(args, dev, s, head_chunk=hc)
    if stage == "fwd":
        x = {"img": torch.as_tensor(imgs, device=dev)}
        wall, _, _ = _timed(dev, lambda _: model(x, render=False), N_TIMED_LONG)
    elif stage == "render":
        wall, _, preds = _timed(dev, lambda _: reconstruct(model, imgs), N_TIMED_LONG)
        out.update(render_n_dropped=int(preds["render_n_dropped"].sum()),
                   render_n_isects_mean=float(preds["render_n_isects"].float().mean()))
    else:
        raise ValueError(f"unknown stage {stage!r}")
    med, lo, hi = _stats(wall)
    out.update(ms_per_forward=med, ms_min=lo, ms_max=hi, n_forwards=len(wall),
               frames_per_sec=None if spec is None else s / (med / 1e3),
               peak_memory_gb=_peak_gb(dev))
    return out


def run_row(row: dict, args) -> dict:
    if row["stage"] == "headline":
        return row_headline(args)
    return row_long(args, row["s"], row["stage"])


# ---------------------------------------------------------------------------
# the parent: one subprocess a row, each line printed as the row ends
# ---------------------------------------------------------------------------

def _row_flags(args) -> List[str]:
    return ["--device", args.device, "--preset", args.preset, "--img", str(args.img),
            "--seed", str(args.seed)]


def spawn_row(row: dict, flags: List[str], timeout_s: float) -> dict:
    """Run one row in its own process -> its JSON line (a dict), or
    {"failed": ...} on a timeout, a non-zero exit or no JSON line."""
    cmd = [sys.executable, "-m", "hunyuanworld_mirror_tpu_torch.bench", "--row",
           json.dumps(row), *flags]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                           cwd=root)
    except subprocess.TimeoutExpired:
        return {"failed": f"timeout after {timeout_s:.0f} s"}
    for ln in r.stderr.strip().splitlines()[-6:]:
        print(f"  [row {json.dumps(row)}] {ln}"[:300], file=sys.stderr, flush=True)
    res = None
    for ln in reversed(r.stdout.strip().splitlines()):
        try:
            res = json.loads(ln)
            break
        except json.JSONDecodeError:
            continue
    if r.returncode != 0 and not (isinstance(res, dict) and "failed" in res):
        tail = r.stderr.strip().splitlines()[-1:] or [""]
        return {"failed": f"rc={r.returncode}: {tail[0][:240]}"}
    return res if isinstance(res, dict) else {"failed": "no JSON line"}


def _key(row: dict) -> str:
    return row["stage"] if row["stage"] == "headline" else f"{row['stage']}_s{row['s']}"


def run_all(runner: Callable[[dict, float], dict], budget_s: float,
            clock: Callable[[], float] = time.monotonic) -> Tuple[dict, int]:
    """Every row of ROWS through runner(row, timeout_s), its line printed as
    it ends, then the assembled line -> (that line, exit code)."""
    t0 = clock()
    results, skipped, failed = {}, [], []
    for row in ROWS:
        left = budget_s - (clock() - t0)
        if left < ROW_MIN_S:
            res = {"skipped": f"budget: {left:.0f} s left of {budget_s:.0f} s"}
            skipped.append(f"{_key(row)}: {res['skipped']}")
        else:
            res = runner(row, left)
            if "failed" in res:
                failed.append(f"{_key(row)}: {res['failed']}")
        print(json.dumps({"row": row, **res}), flush=True)
        results[_key(row)] = res
    head = results["headline"]
    final = {"metric": METRIC, "value": head.get("value"), "unit": UNIT,
             **{k: v for k, v in head.items() if k not in ("metric", "value", "unit")}}
    for name, s in (("long_seq", 32), ("long_seq64", 64)):
        final[name] = {"views": s, "head_chunk": HEAD_CHUNK[s],
                       **{st: results[f"{st}_s{s}"] for st in ("fwd", "render", "ba")}}
    final.update(comm=comm_report(32, 518, 518, n_view_shards=8), budget_s=budget_s,
                 wall_s=clock() - t0, skipped=skipped, failed=failed)
    print(json.dumps(final), flush=True)
    return final, (1 if failed else 0)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--row", default=None, help="run one row (JSON) in this process")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--preset", default="large")
    ap.add_argument("--img", type=int, default=518)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cpu" and args.preset == "large":
        ap.error("--device cpu rehearses at a smaller preset (--preset tiny)")
    if args.row is None:
        budget = float(os.environ.get("WM_BENCH_BUDGET_S", BUDGET_S))
        flags = _row_flags(args)
        return run_all(lambda row, left: spawn_row(row, flags, left), budget)[1]
    row = json.loads(args.row)
    try:
        res = run_row(row, args)
    except Exception as e:  # the row's boundary: report, exit non-zero
        traceback.print_exc()
        print(json.dumps({"failed": f"{type(e).__name__}: {e}"[:400]}), flush=True)
        return 1
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
