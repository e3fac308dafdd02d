"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: both CUDA kernels (csrc/*.cu) compiled from this checkout, the
     nvcc processes started together;
  3. K1 (attention_fwd) against its plain version at the shapes of the main
     path, plus a ragged N;
  4. K2 (rasterize_flat_fwd) against its plain version on a synthetic 518 px
     scene of ~500k splats, f32 and f16-pair payloads;
  5. the main path through the CLI's `run(...)`: the `large` preset (ViT-L
     trunk, width 1024, 24 + 24 blocks, all five heads, the Gaussian render)
     at B=1, S=4, 518 px, random weights from a seed, fixed cameras: one
     `run` with the kernels' launch counts (88 attention and 4 rasterizer
     launches) and the peak memory; then one model from `load_model`, one
     warm-up and 7 timed forwards through `reconstruct`, with the per-phase
     time; then K2 against its plain version on the main path's own
     intersection lists;
  6. the port on the card against the same port on the CPU (plain versions)
     for a small configuration whose heads are 64 wide;
then a `kernels` JSON line, the card line, and as the last line
{"ok": true, "device": {...}}.

Times are CUDA-event times after a warm-up. `bound_ms` is the larger of the
bytes the function must move over 3.35 TB/s and its operations over the
card's peak for their type (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32; the
H100 SXM data sheet). In the `kernels` line every number is per forward
of the main path: `launches` is the count from the one `run`, and `ms`,
`plain_ms`, `library_ms` and `bound_ms` are totals over that forward's
launches of the kernel, at its shapes.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
K2_FLOPS_PER_EVAL = 25      # dx, dy, sigma, exp, alpha, T, 4 colour FMAs, sum


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {name} (count {torch.cuda.device_count()})")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from hunyuanworld_mirror_tpu_torch.ops import _build
    t0 = time.time()
    seconds = _build.build(["attention_fwd", "rasterize_flat_fwd"])
    log(f"build: {time.time() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for name in seconds:
        report = (_build.BUILD_DIR / f"{name}.ptxas.txt").read_text()
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# --- K1 ---------------------------------------------------------------------

# (label, (B, N, H, D), dtype, launches per forward on the main path)
K1_SHAPES = [
    ("encoder", (4, 1374, 16, 64), torch.bfloat16, 24),
    ("frame", (4, 1376, 16, 64), torch.bfloat16, 24),
    ("global", (1, 5504, 16, 64), torch.bfloat16, 24),
    ("camera_head", (1, 4, 16, 128), torch.float32, 16),
    ("ragged", (2, 37, 16, 64), torch.bfloat16, 0),
    ("ragged_d128", (3, 130, 4, 128), torch.bfloat16, 0),
]
# max|kernel - plain| <= this share of max|plain|: 2^-6 is at most 4 ulps at
# the largest output for bf16, 2^-16 for f32 (ragged N and a skipped K/V
# tile move the output far more).
K1_REL_BAND = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -16}


def k1_bound_ms(shape, dtype):
    B, N, H, D = shape
    flops = 4.0 * B * H * N * N * D
    byts = 4.0 * B * N * H * D * (2 if dtype == torch.bfloat16 else 4)
    rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    return max(flops / rate, byts / HBM_BYTES_PER_S) * 1e3


def phase_k1():
    from hunyuanworld_mirror_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(1)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    for label, shape, dtype, per_fwd in K1_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        scale = shape[-1] ** -0.5
        out = A.attention(q, k, v, scale)
        torch.cuda.synchronize()
        ref = A.attention_plain(q, k, v, scale)
        err = float((out.float() - ref.float()).abs().max())
        band = K1_REL_BAND[dtype] * float(ref.float().abs().max())
        if not (err <= band) or not torch.isfinite(out).all():
            raise AssertionError(f"K1 {label} {shape}: max|d| {err} > {band}")
        ms = cuda_ms(lambda: A.attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: A.attention_plain(q, k, v, scale), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale))
        bound = k1_bound_ms(shape, dtype)
        log(f"K1 {label:12s} {str(tuple(shape)):22s} {str(dtype)[6:]:8s} "
            f"max|d| {err:.3e} (band {band:.3e})  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bound:.4f} ms")
        totals["err"] = max(totals["err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound)):
            totals[key] += per_fwd * val
        del q, k, v, ref, out, qt, kt, vt
        torch.cuda.empty_cache()
    return totals


# --- K2 ---------------------------------------------------------------------

K2_BAND = 2e-3


def blend_evaluations(packed, starts, counts, width, height, tile_size,
                      d_col, f16) -> int:
    """The (pixel, entry) evaluations a front-to-back blend with early stop
    needs on this list: per in-image pixel, its tile's entries up to and
    including the one that takes T to <= 1e-4 (the work that bounds K2)."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    tw = (width + tile_size - 1) // tile_size
    lin = torch.arange(tile_size * tile_size, device=packed.device)
    total = 0
    for g, _, _, t_before, live in R.blend_groups(packed, starts, counts, width,
                                                  height, tile_size, d_col, f16):
        inside = ((((g % tw) * tile_size)[:, None] + lin % tile_size < width)
                  & (((g // tw) * tile_size)[:, None] + lin // tile_size < height))
        needed = (t_before > R.T_EPS) & live[..., None] & inside[:, None, :]
        total += int(needed.sum())
    return total


def k2_check(label, bins, W, H, d_col, f16):
    """K2 vs its plain version on one sorted list -> (err, ms, plain_ms,
    bound_ms)."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    args = (bins.packed, bins.starts, bins.counts, W, H, 16, d_col, f16)
    img, alpha = R.rasterize_flat(*args)
    torch.cuda.synchronize()
    img_p, alpha_p = R.rasterize_flat_plain(*args)
    err = max(float((img - img_p).abs().max()), float((alpha - alpha_p).abs().max()))
    if not (err <= K2_BAND) or not torch.isfinite(img).all():
        raise AssertionError(f"K2 {label}: max|d| {err} > {K2_BAND}")
    ms = cuda_ms(lambda: R.rasterize_flat(*args))
    plain_ms = cuda_ms(lambda: R.rasterize_flat_plain(*args), reps=2, warmup=1)
    n_entries = int(bins.counts.sum())
    evals = blend_evaluations(*args)
    byts = (n_entries * bins.packed.shape[0] * 4 + 2 * bins.counts.numel() * 4
            + W * H * (d_col + 1) * 4)
    bound = max(byts / HBM_BYTES_PER_S, evals * K2_FLOPS_PER_EVAL / F32_FLOPS) * 1e3
    by = "bytes" if byts / HBM_BYTES_PER_S > evals * K2_FLOPS_PER_EVAL / F32_FLOPS \
        else "operations"
    log(f"K2 {label:24s} payload {'f16' if f16 else 'f32'}  entries {n_entries}  "
        f"evaluations {evals}  max|d| {err:.3e} (band {K2_BAND:.0e})  "
        f"kernel {ms:.4f} ms  plain {plain_ms:.2f} ms  bound {bound:.4f} ms ({by})")
    return err, ms, plain_ms, bound, by


def phase_k2_synthetic():
    from hunyuanworld_mirror_tpu_torch.ops import projection, rasterizer, tiles
    W = H = 518
    n = 500_000
    g = torch.Generator(device="cuda").manual_seed(2)
    means = torch.rand(n, 3, generator=g, device="cuda") * torch.tensor(
        [3.0, 3.0, 2.0], device="cuda") - torch.tensor([1.5, 1.5, -2.0], device="cuda")
    quats = torch.randn(n, 4, generator=g, device="cuda")
    scales = torch.rand(n, 3, generator=g, device="cuda") * 0.004 + 0.001
    opac = torch.rand(n, generator=g, device="cuda") * 0.9 + 0.1
    rgb = torch.rand(n, 3, generator=g, device="cuda")
    viewmat = torch.eye(4, device="cuda")
    f = 0.5 * W / math.tan(math.radians(30))
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], device="cuda")
    cov = projection.quat_scale_to_covar_planes(quats, scales)
    pj = projection.fully_fused_projection(means, cov, viewmat[None], K[None], W, H)
    rad = tiles.opacity_tight_radii(pj.radii[0], opac)
    col = torch.cat([rgb, pj.depths[0][:, None]], -1)
    for f16 in (False, True):
        bins = rasterizer.bin_splats(pj.means2d[0], pj.conics[0], col, opac, rad,
                                     pj.depths[0], 16, 33, 33, 4, 4096, f16)
        k2_check(f"synthetic 500k splats", bins, W, H, 4, f16)


# --- main path --------------------------------------------------------------

def fixed_cameras(S):
    """Identity-ish rotations, small translations, ~60 degree fov."""
    cams = np.zeros((1, S, 9), np.float32)
    for s in range(S):
        a = 0.05 * s
        cams[0, s, :3] = [0.05 * s, -0.02 * s, 0.03 * s]
        cams[0, s, 3:7] = [0.0, math.sin(a / 2), 0.0, math.cos(a / 2)]  # xyzw
        cams[0, s, 7:9] = math.radians(60)
    return cams


def phase_main_path():
    from hunyuanworld_mirror_tpu_torch.infer import (PRESETS, load_model,
                                                     reconstruct, run)
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer, rasterizer_flat
    from hunyuanworld_mirror_tpu_torch.ops.attention import attention

    cfg = WorldMirrorConfig(**PRESETS["large"])
    S, HW = 4, 518
    imgs = np.random.default_rng(0).uniform(size=(1, S, HW, HW, 3)).astype(np.float32)
    cams = fixed_cameras(S)
    torch.cuda.reset_peak_memory_stats()
    attention.launches = rasterizer_flat.rasterize_flat.launches = 0
    t0 = time.time()
    preds = run(imgs, cfg, camera_params=cams)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"attention_fwd": attention.launches,
                "rasterize_flat_fwd": rasterizer_flat.rasterize_flat.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path run: {wall:.2f} s wall incl. model build and first use; "
        f"peak memory {peak_gb:.2f} GB; launches {launches}")
    if launches != {"attention_fwd": 88, "rasterize_flat_fwd": 4}:
        raise AssertionError(f"expected 88 attention and 4 rasterizer launches "
                             f"per forward, got {launches}")

    # timing: one model, so no forward pays for a model build
    model = load_model(cfg, device="cuda")
    reconstruct(model, imgs, cams)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals = []
    for i in range(7):
        marks = []
        out = reconstruct(model, imgs, cams, marks=marks)
        torch.cuda.synchronize()
        ph = {name: marks[j - 1][1].elapsed_time(ev)
              for j, (name, ev) in enumerate(marks) if j}
        totals.append(sum(ph.values()))
        log(f"main path forward {i}: " + "  ".join(f"{k} {v:.2f} ms" for k, v in ph.items())
            + f"  total {totals[-1]:.2f} ms")
        del out
    log(f"main path forward total: median {float(np.median(totals)):.2f} ms, "
        f"min {min(totals):.2f}, max {max(totals):.2f} over {len(totals)}; "
        f"peak memory with the bf16 model resident "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model

    for k in ("camera_params", "depth", "pts3d", "normals", "gs_depth",
              "rendered_colors", "rendered_depths", "rendered_alphas"):
        v = preds[k]
        if not torch.isfinite(v).all():
            raise AssertionError(f"main path: {k} is not finite")
        log(f"  {k:16s} {tuple(v.shape)}  mean {float(v.float().mean()):.4f}")
    shapes = {"depth": (1, S, HW, HW, 1), "rendered_colors": (1, S, HW, HW, 3),
              "rendered_alphas": (1, S, HW, HW, 1), "camera_params": (1, S, 9)}
    for k, shp in shapes.items():
        if tuple(preds[k].shape) != shp:
            raise AssertionError(f"main path: {k} {tuple(preds[k].shape)} != {shp}")
    sp = preds["splats"]
    alpha_mean = float(preds["rendered_alphas"].mean())
    log(f"  splats {tuple(sp['means'].shape)}  live {int((sp['weights'] > 0).sum())}  "
        f"n_compact_dropped {sp['n_compact_dropped'].tolist()}  intersections "
        f"{preds['render_n_isects'].tolist()}  n_dropped "
        f"{preds['render_n_dropped'].tolist()}  mean alpha {alpha_mean:.4f}")
    if not alpha_mean > 0.05:
        raise AssertionError("main path: the render is empty")

    # K2 on the main path's own sorted lists (the same binning as the render)
    from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils
    ext, intr = cam_utils.vector_to_camera_matrices(preds["camera_params"][0], (HW, HW))
    w2c = cam_utils.to_homogeneous(ext)
    k2 = dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, by=set())
    quats_xyzw = sp["quats"][0][:, [1, 2, 3, 0]]
    for c in range(S):
        bins = rasterizer.bin_camera(sp["means"][0], quats_xyzw, sp["scales"][0],
                                     sp["opacities"][0], sp["sh"][0], w2c[c], intr[c],
                                     HW, HW, 16, 4096, 4, True)
        err, ms, plain_ms, bound, by = k2_check(f"main path camera {c}", bins,
                                                HW, HW, 4, True)
        k2["err"] = max(k2["err"], err)
        k2["ms"] += ms
        k2["plain_ms"] += plain_ms
        k2["bound_ms"] += bound
        k2["by"].add(by)
    return launches, k2


# --- the card against the CPU ------------------------------------------------

def phase_cpu_reference():
    """A 64-wide-head configuration, f32 trunk: the kernels on the card vs
    the plain versions on the CPU, same weights and inputs."""
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import (WorldMirror,
                                                                  WorldMirrorConfig)
    cfg = WorldMirrorConfig(img_size=112, embed_dim=512, trunk_heads=8,
                            patch_embed="conv", trunk_depth=2, gs_dim=32,
                            intermediate_idxs=(0, 1, 1, 1), dpt_features=32,
                            dpt_out_channels=(32, 48, 64, 64))
    cpu = WorldMirror(cfg, device="cpu", seed=3)
    gpu = WorldMirror(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    imgs = np.random.default_rng(1).uniform(size=(1, 2, 112, 112, 3)).astype(np.float32)
    cams = fixed_cameras(2)
    kw = dict(trunk_dtype=torch.float32, camera_params=torch.tensor(cams))
    ref = cpu({"img": torch.tensor(imgs)}, **kw)
    out = gpu({"img": torch.tensor(imgs, device="cuda")},
              **{**kw, "camera_params": kw["camera_params"].cuda()})
    worst = {}
    for k in ("camera_params_pred", "depth", "pts3d", "normals", "gs_depth"):
        a, b = out[k].float().cpu(), ref[k].float()
        d = float(((a - b).abs() / (1 + b.abs())).max())
        worst[k] = d
        if not d <= 5e-3:
            raise AssertionError(f"card vs CPU: {k} rel max|d| {d} > 5e-3")
    d = (out["rendered_colors"].cpu() - ref["rendered_colors"]).abs()
    worst["rendered_colors_median"] = float(d.median())
    worst["rendered_colors_frac_gt_5e-2"] = float((d > 5e-2).float().mean())
    if not (worst["rendered_colors_median"] < 5e-3
            and worst["rendered_colors_frac_gt_5e-2"] < 0.05):
        raise AssertionError(f"card vs CPU: renders differ {worst}")
    log(f"card vs CPU (plain versions), small config: {json.dumps(worst)}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    name, smi = phase_device()
    phase_build()
    k1 = phase_k1()
    phase_k2_synthetic()
    launches, k2 = phase_main_path()
    phase_cpu_reference()
    kernels = [
        {"name": "attention_fwd", "route": "cuda",
         "source": "hunyuanworld_mirror_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "hunyuanworld_mirror_tpu/ops/attn_onepass.py:57; "
                     "hunyuanworld_mirror_tpu/models/block.py:162",
         "launches": launches["attention_fwd"], "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "operations", "library_ms": k1["library_ms"]},
        {"name": "rasterize_flat_fwd", "route": "cuda",
         "source": "hunyuanworld_mirror_tpu_torch/csrc/rasterize_flat_fwd.cu",
         "replaces": "hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:337",
         "launches": launches["rasterize_flat_fwd"], "max_abs_err": k2["err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "operations" if "operations" in k2["by"] else "bytes",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
