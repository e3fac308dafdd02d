"""The Gaussian render (gs_render) on the card, split into its stages.

    python -m hunyuanworld_mirror_tpu_torch.render_profile [--views 4] [--img 518]
        [--iters 3] [--seed 0] [--cameras fixed|predicted] [--preset large]
    python -m hunyuanworld_mirror_tpu_torch.render_profile --device cpu --preset tiny --img 56

The port's twin of tools/render_profile.py. On the scene of
`utils/scenes.render_scene` (the `large` model's trunk and heads once, B=1,
S views, bf16 parameters, the fixed cameras by default) it times
`models/gaussians.render`'s stages, each alone on the previous one's output:
  A  GaussianSplatRenderer.head + prepare_splats;
  B  voxel_prune;
  C  compact_splats;
  D  rasterizer.rasterize of the compacted splats into the S cameras, as
     gaussians.render calls it (gaussians.rasterize_splats: the flat route,
     f16 payload, 4096 a tile, 4 tiles a splat);
and inside D, over all cameras:
  D1 projection (the covariance planes, rasterizer.prepare_camera);
  D2 binning (rasterizer.bin_splats: tiles.bin_gaussians_packed, kernel
     K7 on the card);
  D3 the blend alone (rasterizer.blend_flat: kernel K2, or K5 with
     WM_RASTER_GROUP > 1). The JAX tool has no D3.
D1 -> D2 -> D3 composed must equal D bit for bit (the tool raises
otherwise). Dm is the camera-batched route (rasterize(camera_batch=True):
one sort, one K2m launch, the f32 payload), printed with its max and
median |delta| in RGB against D. A + B + C + D is printed beside the
composed gaussians.render, and the intersections a camera beside the
times, so a reader can tell which load was measured. Then the four DPT
heads (depth, points, normals, GS), timed together at f32 and at bf16
compute dtype, with each output's max relative delta
|bf16 - f32| / (|f32| + 1e-3), as the JAX tool does.

Each time is `utils/profiling.time_fn`'s median of --iters calls after one
warm-up, each call ended by torch.cuda.synchronize; every line carries the
card's name and power limit, and the last line is one JSON object with all
the numbers. The JAX tool's in-jit repeat harness and relay floor have no
counterpart here, and it renders the model's predicted cameras (here
--cameras predicted: on random weights they leave the render nearly empty,
PERF.md §4). Runs on the card; without one it raises unless given --device
cpu, which rehearses the stages on the plain versions and prints every
time as null.
"""

import argparse
import contextlib
from dataclasses import replace
from typing import Dict, List, Optional

import torch

from .models import gaussians
from .ops import projection, rasterizer
from .utils.profiling import ToolRun, fmt_ms
from .utils.scenes import add_scene_args, scene_from_args

HEADS = ("depth_head", "pts_head", "norm_head", "gs_head")


def splat_stages(scene):
    """Stages A, B, C as functions: fused features -> splats -> merged ->
    compacted, each as gaussians.render runs it."""
    cfg = scene.cfg.gs_renderer
    renderer = scene.model.gs_renderer
    B, S, H, W, _ = scene.images.shape

    def head_prepare(gs_feat):
        raw = renderer.head(gs_feat.reshape(B * S, H, W, -1))
        return gaussians.prepare_splats(cfg, raw, scene.images, scene.preds)

    def prune(splats):
        return gaussians.voxel_prune(cfg, {k: splats[k] for k in gaussians.SPLAT_KEYS})

    def compact(merged):
        return gaussians.compact_splats(cfg, merged)

    return head_prepare, prune, compact


def camera_stages(cfg: gaussians.GSRendererConfig, splats: Dict, w2c, Ks,
                  W: int, H: int, device):
    """Stages D1, D2, D3 over one batch element's cameras as functions:
    () -> per-camera CameraSplats -> per-camera FlatBins -> (colors (S, H,
    W, 4), alphas (S, H, W, 1)) after the ED normalization: what
    rasterizer.rasterize computes on the flat route at inference."""
    if cfg.rasterizer_impl != "pallas":
        raise ValueError("the stages are the flat route's (rasterizer_impl='pallas')")
    means, quats, scales, opac, sh = (
        torch.as_tensor(splats[k], dtype=torch.float32, device=device)
        for k in ("means", "quats", "scales", "opacities", "sh"))
    quats = quats[..., [1, 2, 3, 0]]
    ts, tpg = cfg.tile_size, cfg.max_tiles_per_gauss
    tw, th = (W + ts - 1) // ts, (H + ts - 1) // ts
    mpt = rasterizer._capped(cfg.max_per_tile, means.shape[0], tpg)
    f16 = cfg.payload_f16

    def project():
        covars = projection.quat_scale_to_covar_planes(quats, scales)
        return [rasterizer.prepare_camera(means, covars, opac, sh, w2c[c], Ks[c],
                                          W, H) for c in range(w2c.shape[0])]

    def bin_all(cams):
        return [rasterizer.bin_splats(s.means2d, s.conics, s.colors, s.opacities,
                                      s.radii, s.depths, ts, tw, th, tpg, mpt, f16,
                                      exact_test=gaussians.exact_tile_test(cfg))
                for s in cams]

    def blend(bins):
        # RGB + depth: four blended channels
        outs = [rasterizer.blend_flat(b, W, H, ts, 4, f16, mpt)[0] for b in bins]
        img = torch.stack([o[0] for o in outs])
        alpha = torch.stack([o[1] for o in outs])
        return rasterizer.normalize_mode(img, alpha, "RGB+ED"), alpha

    return project, bin_all, blend


@contextlib.contextmanager
def heads_dtype(model, dtype: str):
    """The four DPT heads at compute dtype `dtype` inside the block."""
    saved = {h: getattr(model, h).cfg for h in HEADS}
    try:
        for h in HEADS:
            getattr(model, h).cfg = replace(saved[h], compute_dtype=dtype)
        yield
    finally:
        for h in HEADS:
            getattr(model, h).cfg = saved[h]


def heads_forward(model, token_list, images, start) -> Dict[str, torch.Tensor]:
    """The four DPT heads' predictions (the GS head's depth)."""
    return {"depth": model.depth_head(token_list, images, start)[0],
            "pts3d": model.pts_head(token_list, images, start)[0],
            "normals": model.norm_head(token_list, images, start)[0],
            "gs_depth": model.gs_head(token_list, images, start)[1]}


def main(argv: Optional[List[str]] = None, scene=None) -> Dict:
    """Run the profile -> its numbers (the last line's JSON). `scene` (a
    utils/scenes.RenderScene on the run's device) skips building one."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_scene_args(ap, iters=3)
    args = ap.parse_args(argv)
    run = ToolRun(args.device, args.iters)
    if scene is None:
        scene = scene_from_args(args, run.device)
    cfg = scene.cfg.gs_renderer
    B, S, H, W, _ = scene.images.shape
    w2c, Ks = gaussians.camera_matrices(scene.preds["camera_params"], B, S, H, W)
    w2c, Ks = w2c[0], Ks[0]
    ms: Dict[str, Optional[float]] = {}
    with torch.no_grad():
        head_prepare, prune, compact = splat_stages(scene)
        splats = head_prepare(scene.gs_feat)
        merged = prune(splats)
        comp = compact(merged)
        splats_b = {k: comp[k][0] for k in gaussians.SPLAT_KEYS}
        n = splats_b["means"].shape[0]
        run.log(f"splats after compact: {n}  live {int((comp['weights'] > 0).sum())}")
        ms["A"] = run.ms(head_prepare, scene.gs_feat)
        ms["B"] = run.ms(prune, splats)
        ms["C"] = run.ms(compact, merged)

        def stage_d():
            return gaussians.rasterize_splats(cfg, splats_b, w2c, Ks, W, H, run.device)

        d_colors, d_alpha, meta = stage_d()
        ms["D"] = run.ms(stage_d)
        project, bin_all, blend = camera_stages(cfg, splats_b, w2c, Ks, W, H, run.device)
        cams = project()
        bins = bin_all(cams)
        colors, alpha = blend(bins)
        stages_equal = bool(torch.equal(colors, d_colors) and torch.equal(alpha, d_alpha))
        if not stages_equal:
            raise AssertionError("render_profile: D1 -> D2 -> D3 differs from D")
        ms["D1"] = run.ms(project)
        ms["D2"] = run.ms(bin_all, cams)
        ms["D3"] = run.ms(blend, bins)

        def stage_dm():
            return rasterizer.rasterize(
                splats_b["means"], splats_b["quats"], splats_b["scales"],
                splats_b["opacities"], splats_b["sh"], w2c, Ks, W, H,
                tile_size=cfg.tile_size, max_per_tile=cfg.max_per_tile,
                max_tiles_per_gauss=cfg.max_tiles_per_gauss, quat_order="wxyz",
                camera_batch=True, device=run.device)

        dm_rgb = (stage_dm()[0] - d_colors)[..., :3].abs()
        dm_delta = {"max": float(dm_rgb.max()), "median": float(dm_rgb.median())}
        ms["Dm"] = run.ms(stage_dm)

        def composed():
            return gaussians.render(scene.model.gs_renderer, scene.gs_feat,
                                    scene.images, dict(scene.preds))["rendered_colors"]

        ms["render"] = run.ms(composed)
        ms["stages_sum"] = (None if not run.on_card
                            else ms["A"] + ms["B"] + ms["C"] + ms["D"])
        isects = meta["n_isects"].tolist()
        dropped = meta["n_dropped"].tolist()
        rows = [f"A head+prepare : {fmt_ms(ms['A'])} ms",
                f"B voxel_prune  : {fmt_ms(ms['B'])} ms",
                f"C compact      : {fmt_ms(ms['C'])} ms",
                f"D rasterize    : {fmt_ms(ms['D'])} ms  ({S} cameras, per camera; "
                f"intersections a camera {isects}, n_dropped {dropped})",
                f"  D1 projection: {fmt_ms(ms['D1'])} ms",
                f"  D2 binning   : {fmt_ms(ms['D2'])} ms",
                f"  D3 blend     : {fmt_ms(ms['D3'])} ms  (D1 -> D2 -> D3 equals D "
                f"bit for bit: {stages_equal})",
                f"Dm cam-batched : {fmt_ms(ms['Dm'])} ms  (|rgb delta| against D: max "
                f"{dm_delta['max']:.3e}, median {dm_delta['median']:.3e})",
                f"sum A+B+C+D    : {fmt_ms(ms['stages_sum'])} ms  against "
                f"gaussians.render composed {fmt_ms(ms['render'])} ms"]
        for row in rows:
            run.log(row)

        outs, heads_ms = {}, {}
        for dt in ("float32", "bfloat16"):
            with heads_dtype(scene.model, dt):
                heads_ms[dt] = run.ms(heads_forward, scene.model, scene.token_list,
                                      scene.images, scene.patch_start_idx)
                outs[dt] = heads_forward(scene.model, scene.token_list, scene.images,
                                         scene.patch_start_idx)
            run.log(f"heads {dt:8s}: {fmt_ms(heads_ms[dt])} ms  (depth, pts, "
                    f"norm, gs; S={S}, {W} px)")
        rel = {}
        for k, ref in outs["float32"].items():
            rel[k] = float(((outs["bfloat16"][k] - ref).abs()
                            / (ref.abs() + 1e-3)).max())
            run.log(f"  {k:10s} max rel delta bf16 against f32 {rel[k]:.3e}")
    return run.finish("render_profile", {
        "views": S, "img": W, "cameras": args.cameras, "splats": n, "ms": ms,
        "n_isects": isects, "n_dropped": dropped, "stages_equal": stages_equal,
        "dm_delta": dm_delta, "heads_ms": heads_ms, "heads_rel_delta": rel})


if __name__ == "__main__":
    main()
