"""WorldMirror inference CLI on one NVIDIA GPU (the port's twin of infer.py).

    python -m hunyuanworld_mirror_tpu_torch.infer <images dir | video | stack.npy>
        -o out [--preset large|base|small|tiny] [--size 518] [--ckpt params.npz]
        [--fps 1] [--mode crop|pad] [--cond 0,0,0] [--no-gs] [--conf-percent 20]
        [--rasterizer pallas|jax] [--fast-binning] [--ba] [--ba-iters 12]
        [--glb] [--glb-mesh] [--mask-sky] [--video] [--effect twister|rain|spread]

Runs the JAX package's CLI on the port: all heads (the Gaussian head off
with --no-gs), the Gaussians rendered back into the input views, bf16
parameters (as the JAX CLI casts them), bf16 trunk and f32 heads. A video
file is sampled at --fps frames a second (cv2). --rasterizer picks the
render's route: pallas, the flat lists blended by kernel K2 (the default),
or jax, the dense per-tile bins blended by kernel K4. --fast-binning is
accepted and changes nothing: the port always bins exactly, since kernel K7
sorts only the live slots, fewer rows than the coverage-scheduled prefixes
of the JAX CLI kept. --ba refines the predicted cameras by bundle adjustment
(refine/ba.py, --ba-iters LM steps) before the exports, which then carry
the refined poses. Writes points.ply, depth_XXX.png / .npy, normal_XXX.png,
camera_params.json, gaussians.ply and gaussians.splat, with --glb a GLB
scene (scene.glb: points, or with --glb-mesh a triangulated pointmap, and
the camera frusta; --mask-sky drops sky pixels by the HSV heuristic, as the
JAX CLI does: it passes no ONNX segmenter), with --video a novel-view
video along the interpolated trajectory (rendered.mp4, cv2; --effect
animates the splats), and a COLMAP model in sparse/. --cond sets the cond
flags as the JAX CLI does, which feeds the model the images only (a flag
without its prior gives the zero token); priors reach the model through the
Python API, `reconstruct(model, images, priors=...)`. --ckpt takes an npz
checkpoint of the JAX package; without it the weights are random, made from
a seed (layout and IO testing only).
"""

import argparse
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .convert import from_jax_params, load_npz
from .io import colmap as io_colmap
from .io import images as io_images
from .io import ply as io_ply
from .io import render as render_lib
from .io import scene as scene_lib
from .models.worldmirror import WorldMirror, WorldMirrorConfig
from .refine import ba
from .utils import geometry
from .utils import profiling

# views keys of the priors, in cond-flag order (pose, depth, rays)
PRIOR_KEYS = ("camera_pose", "depthmap", "camera_intrinsics")

PRESETS = {
    "large": {},
    "base": dict(embed_dim=768, patch_embed="dinov2_vitb14_reg"),
    "small": dict(embed_dim=384, patch_embed="dinov2_vits14_reg",
                  trunk_depth=12, trunk_heads=6, intermediate_idxs=(2, 5, 8, 11)),
    "tiny": dict(embed_dim=64, patch_embed="conv", trunk_depth=4,
                 trunk_heads=4, gs_dim=32, intermediate_idxs=(0, 1, 2, 3)),
}


def load_model(cfg: WorldMirrorConfig, params=None,
               device=None) -> WorldMirror:
    """The model on `device` with bf16 parameters: `params` (a JAX pytree
    of numpy arrays) if given, else random weights made from seed 0."""
    model = WorldMirror(cfg, device=device)
    if params is not None:
        model.load_state_dict(from_jax_params(params))
    return model.to(torch.bfloat16).eval()


def reconstruct(model: WorldMirror, images: np.ndarray,
                camera_params: Optional[np.ndarray] = None,
                marks: Optional[List] = None,
                priors: Optional[Dict[str, np.ndarray]] = None,
                cond_flags: Optional[Sequence[int]] = None
                ) -> Dict[str, torch.Tensor]:
    """One forward of `model` with the render on (1, S, H, W, 3) images in
    [0, 1], on the model's device -> the prediction dict.

    camera_params: optional (1, S, 9) camera vectors that replace the camera
    head's prediction for the splats and the render.
    priors: optional arrays under PRIOR_KEYS: camera_pose (1, S, 4, 4)
    camera-to-world, depthmap (1, S, H, W), camera_intrinsics (1, S, 3, 3)
    in the images' pixels. cond_flags: (pose, depth, rays); by default
    1 for each prior given.
    marks: a list to receive a CUDA event as the forward starts ("start")
    and after each phase (see models/worldmirror.py).
    """
    dev = next(model.parameters()).device
    with profiling.request(marks, start=True):
        views = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in {"img": images, **(priors or {})}.items()}
        profiling.count("host_syncs", len(views))
        if cond_flags is None:
            cond_flags = tuple(int(k in views) for k in PRIOR_KEYS)
        return model(views, cond_flags=cond_flags, render=True,
                     camera_params=camera_params, marks=marks)


def run(images: np.ndarray, cfg: WorldMirrorConfig, params=None, device=None,
        camera_params: Optional[np.ndarray] = None,
        priors: Optional[Dict[str, np.ndarray]] = None,
        cond_flags: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """Build the model and reconstruct (1, S, H, W, 3) images in [0, 1]:
    returns the prediction dict (tensors on the device). Runs on CUDA unless
    `device` names another; without a GPU, device=None raises."""
    model = load_model(cfg, params, resolve_device(device))
    return reconstruct(model, images, camera_params, priors=priors,
                       cond_flags=cond_flags)


def _quiet(*_):
    pass


def export(preds: Dict[str, torch.Tensor], images: np.ndarray, out_dir: Path,
           conf_percent: float = 20.0, log=_quiet) -> None:
    """Write points.ply, depth_XXX.png / .npy, normal_XXX.png,
    camera_params.json, gaussians.ply / .splat (with the Gaussian head) and
    the COLMAP model sparse/, as the JAX package's CLI writes them."""
    export_maps(preds, images, out_dir, conf_percent, log)
    export_colmap(preds, images, out_dir, conf_percent, log)


def numpy_preds(preds: Dict) -> Dict:
    """Predictions (tensors, and the splats' dict of tensors) -> numpy on
    the host, f32 for floating types."""
    out = {}
    for k, v in preds.items():
        if isinstance(v, dict):
            out[k] = numpy_preds(v)
        elif isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[k] = (v.float() if v.is_floating_point() else v).numpy()
    return out


def export_maps(preds: Dict[str, torch.Tensor], images: np.ndarray,
                out_dir: Path, conf_percent: float = 20.0, log=_quiet) -> None:
    """export's files before the COLMAP model (points.ply to gaussians.splat),
    each line logged as the JAX CLI prints it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    p = numpy_preds(preds)
    S = images.shape[1]
    pts = p["pts3d"][0].reshape(-1, 3)
    conf = p["pts3d_conf"][0].reshape(-1)
    thresh = np.percentile(conf, conf_percent)
    io_ply.save_points_ply(out_dir / "points.ply", pts,
                           images[0].reshape(-1, 3), conf >= thresh)
    log(f"  wrote points.ply ({int((conf >= thresh).sum())} pts)")
    for s in range(S):
        io_ply.save_depth_png(out_dir / f"depth_{s:03d}.png", p["depth"][0, s, ..., 0])
        io_ply.save_depth_npy(out_dir / f"depth_{s:03d}.npy",
                              p["depth"][0, s, ..., 0])
        if "normals" in p:
            io_ply.save_normal_png(out_dir / f"normal_{s:03d}.png", p["normals"][0, s])
    log("  wrote per-view depth/normal maps")
    io_ply.save_camera_params(p["camera_poses"][0], p["camera_intrs"][0], out_dir)
    if "splats" in p:
        n = export_gaussians(p["splats"], out_dir)
        log(f"  wrote gaussians.ply/.splat ({n} splats)")


def export_gaussians(splats: Dict[str, np.ndarray], out_dir: Path) -> int:
    """gaussians.ply and gaussians.splat of batch 0's live splats (opacity
    above 1e-4; numpy arrays) -> how many were written."""
    alive = splats["opacities"][0] > 1e-4
    op = np.clip(splats["opacities"][0], 1e-6, 1 - 1e-6)
    io_ply.save_gs_ply(out_dir / "gaussians.ply", splats["means"][0][alive],
                       splats["scales"][0][alive], splats["quats"][0][alive],
                       splats["sh"][0][:, 0][alive], np.log(op / (1 - op))[alive])
    io_ply.gs_ply_to_splat(out_dir / "gaussians.ply", out_dir / "gaussians.splat")
    return int(alive.sum())


def export_colmap(preds: Dict[str, torch.Tensor], images: np.ndarray,
                  out_dir: Path, conf_percent: float = 20.0, log=_quiet) -> None:
    """The COLMAP model sparse/: the point head's points at every 4th
    pixel, the bottom conf_percent left out."""
    p = numpy_preds(preds)
    S, H, W = images.shape[1:4]
    c2w, K = p["camera_poses"][0], p["camera_intrs"][0]
    stride = 4
    pix = geometry.create_pixel_coordinate_grid(S, H, W).numpy()[:, ::stride, ::stride]
    keep_conf = p["pts3d_conf"][0][:, ::stride, ::stride].reshape(-1)
    keep = keep_conf >= np.percentile(keep_conf, conf_percent)
    colors = (images[0][:, ::stride, ::stride].reshape(-1, 3) * 255).astype(np.uint8)
    io_colmap.export_reconstruction(
        str(out_dir / "sparse"),
        p["pts3d"][0][:, ::stride, ::stride].reshape(-1, 3)[keep],
        pix.reshape(-1, 3)[keep], colors[keep], np.linalg.inv(c2w), K, (W, H))
    log(f"  wrote COLMAP sparse model -> {out_dir / 'sparse'}")


def main(argv: Optional[List[str]] = None, device=None):
    """The CLI; `device` as for run() (CUDA unless named)."""
    ap = argparse.ArgumentParser(description="WorldMirror inference (GPU)")
    ap.add_argument("input_path",
                    help="image directory, video file or a .npy image stack")
    ap.add_argument("-o", "--output", default="outputs", help="output dir")
    ap.add_argument("--ckpt", default=None, help="npz checkpoint of the JAX package")
    ap.add_argument("--fps", type=float, default=1.0, help="video sampling fps")
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--mode", choices=["crop", "pad"], default="crop")
    ap.add_argument("--cond", default="0,0,0",
                    help="cond flags pose,depth,rays e.g. 1,0,1")
    ap.add_argument("--no-gs", action="store_true", help="skip gaussian head")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="large")
    ap.add_argument("--conf-percent", type=float, default=20.0,
                    help="drop bottom X%% confidence points in the point PLY")
    ap.add_argument("--rasterizer", choices=["jax", "pallas"], default="pallas",
                    help="render route: pallas = flat lists (kernel K2), "
                         "jax = dense per-tile bins (kernel K4)")
    ap.add_argument("--fast-binning", action="store_true",
                    help="accepted for the JAX CLI's flags; the port always "
                         "bins exactly, since kernel K7 sorts only the live "
                         "slots, fewer than the prefixes kept")
    ap.add_argument("--video", action="store_true",
                    help="render a slerp-interpolated novel-view video")
    ap.add_argument("--ba", action="store_true",
                    help="refine predicted cameras with Schur-complement "
                         "bundle adjustment (refine/ba.py)")
    ap.add_argument("--ba-iters", type=int, default=12)
    ap.add_argument("--glb", action="store_true",
                    help="export a GLB scene (point cloud + camera frusta)")
    ap.add_argument("--glb-mesh", action="store_true",
                    help="GLB as a triangulated pointmap mesh instead of points")
    ap.add_argument("--mask-sky", action="store_true",
                    help="drop sky pixels (HSV heuristic) from the GLB export")
    ap.add_argument("--effect", choices=["twister", "rain", "spread"],
                    default=None, help="animated splat effect for --video")
    args = ap.parse_args(argv)

    if io_images.is_video(args.input_path):
        render_lib.require_cv2("a video input")
    if args.video:
        render_lib.require_cv2("--video")
    imgs = io_images.load_inputs(args.input_path, fps=args.fps,
                                 target_size=args.size, strategy=args.mode)
    S, H, W = imgs.shape[1:4]
    cfg = WorldMirrorConfig(img_size=args.size, enable_gs=not args.no_gs,
                            rasterizer_impl=args.rasterizer,
                            **PRESETS[args.preset])
    params = load_npz(args.ckpt) if args.ckpt else None
    if params is None:
        print("WARNING: no --ckpt given; using random weights (IO test mode)")
    cond_flags = tuple(int(x) for x in args.cond.split(","))
    dev = resolve_device(device)
    model = load_model(cfg, params, dev)
    t0 = time.time()
    preds = reconstruct(model, imgs, cond_flags=cond_flags)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"{S} views at {H}x{W}: forward done in {time.time() - t0:.1f}s")
    if "splats" in preds:
        nd = int(preds["splats"]["n_compact_dropped"].max())
        if nd > 0:
            print(f"WARNING: static compaction cap dropped {nd} live splats")

    if args.ba:
        t0 = time.time()
        refined = ba.refine_cameras(
            {k: preds[k] for k in ("pts3d", "pts3d_conf", "depth", "camera_poses",
                                   "camera_intrs")}, iters=args.ba_iters)
        preds["camera_poses"] = refined["camera_poses"]
        print(f"  BA refinement: cost {float(refined['ba_cost0']):.3e} -> "
              f"{float(refined['ba_cost']):.3e} in {time.time() - t0:.1f}s")

    out_dir = Path(args.output)
    export_maps(preds, imgs, out_dir, args.conf_percent, print)
    if args.glb:
        gp = scene_lib.predictions_to_glb(
            {**preds, "images": imgs}, str(out_dir / "scene.glb"),
            conf_percent=args.conf_percent, mask_sky=args.mask_sky,
            as_mesh=args.glb_mesh)
        print(f"  wrote GLB scene -> {gp}")
    if args.video and "splats" in preds:
        vp = render_lib.render_interpolated_video(
            preds, W, H, str(out_dir / "rendered.mp4"), impl=args.rasterizer,
            effect=args.effect, device=dev)
        print(f"  wrote novel-view video -> {vp}")
    export_colmap(preds, imgs, out_dir, args.conf_percent, print)
    print("Done.")


if __name__ == "__main__":
    main()
