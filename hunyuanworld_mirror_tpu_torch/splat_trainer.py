"""Post-inference splat optimisation CLI on one NVIDIA GPU (the port's twin
of tools/splat_trainer.py).

    python -m hunyuanworld_mirror_tpu_torch.splat_trainer <infer_out_dir> <images_dir> [options]
    python -m hunyuanworld_mirror_tpu_torch.splat_trainer --colmap <colmap_dir> [--normalize] [options]

Reads what the inference CLI writes (gaussians.ply, camera_params.json and
depth_XXX.npy) with the source images (an image directory or a .npy
stack, as the inference CLI takes), or a COLMAP dataset (sparse/0 or
sparse, and images/; splats from its gaussians.ply, else from its points),
optimises the splats against the views (training/splat_opt.py: the
default or MCMC strategy, selective Adam, pose optimisation, the depth
loss, a random background, the regularisers, the bilateral grid) through
`--rasterizer pallas` (kernels K2 and K3, the default) or `jax` (K4), or as
2D surfels with --gs2d (ops/gs2d.py, plain PyTorch), and writes
gaussians_opt.ply, with cameras_opt.npz after --pose-opt,
compressed/ after --compress and optimized.mp4 after --video (cv2).
--test-every N holds every Nth view out and scores it (PSNR, SSIM) after
training, and every --eval-every steps; --tb writes TensorBoard events;
--viewer serves a live viewer while it trains.
"""

import argparse
import glob
import json
import os
from typing import Optional

import numpy as np

from . import resolve_device
from .io import images as io_images
from .io import ply as io_ply
from .io import render as render_lib
from .training import splat_opt
from .utils.sh import rgb_to_sh

def init_splats_from_points(points: np.ndarray, rgb: np.ndarray,
                            init_opacity: float = 0.1,
                            max_points: int = 500_000):
    """Splats from a point cloud (gsplat's trainer's init): means the points
    (at most `max_points`, drawn with seed 0), scales the mean distance to
    the 3 nearest neighbours, opacity 0.1, the SH DC from the RGB."""
    import torch
    from scipy.spatial import cKDTree

    if len(points) > max_points:
        sel = np.random.default_rng(0).choice(len(points), max_points,
                                              replace=False)
        points, rgb = points[sel], rgb[sel]
    n = len(points)
    d, _ = cKDTree(points).query(points, k=4)
    nn = np.clip(d[:, 1:].mean(axis=1), 1e-6, None)
    sh = rgb_to_sh(torch.as_tensor(rgb.astype(np.float32) / 255.0)).numpy()
    return {
        "means": points.astype(np.float32),
        "scales": np.repeat(nn[:, None], 3, axis=1).astype(np.float32),
        "quats": np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
        "opacities": np.full((n,), init_opacity, np.float32),
        "sh": sh[:, None, :],
    }


def _splats_from_ply(path: str):
    """gaussians.ply -> activated splats (quats wxyz, SH DC only)."""
    gs = io_ply.read_ply(path)
    return {
        "means": np.stack([gs["x"], gs["y"], gs["z"]], -1).astype(np.float32),
        "scales": np.exp(np.stack([gs[f"scale_{i}"] for i in range(3)], -1)
                         ).astype(np.float32),
        "quats": np.stack([gs[f"rot_{i}"] for i in range(4)], -1).astype(np.float32),
        "opacities": (1 / (1 + np.exp(-np.asarray(gs["opacity"])))).astype(np.float32),
        "sh": np.stack([gs[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :
                                                                ].astype(np.float32),
    }


def load_infer_dir(result_dir: str, images_dir: str, size: int, log_fn=print):
    """-> (splats (activated, quats wxyz, SH DC only), images (S, H, W, 3),
    c2w (S, 4, 4), Ks (S, 3, 3), depths (S, H, W) or None)."""
    splats = _splats_from_ply(os.path.join(result_dir, "gaussians.ply"))
    log_fn(f"loaded {len(splats['means'])} splats from {result_dir}/gaussians.ply")

    with open(os.path.join(result_dir, "camera_params.json")) as f:
        cams = json.load(f)
    c2w = np.asarray([c["matrix"] for c in cams["extrinsics"]], np.float32)
    Ks = np.asarray([c["matrix"] for c in cams["intrinsics"]], np.float32)

    imgs = io_images.load_inputs(images_dir, target_size=size)[0]
    if len(imgs) != len(c2w):
        raise ValueError(f"{len(imgs)} images vs {len(c2w)} cameras")

    # the per-view depth maps of the inference CLI enable the depth loss
    depths = None
    dps = sorted(glob.glob(os.path.join(result_dir, "depth_*.npy")))
    if len(dps) == len(imgs):
        d = np.stack([np.load(p) for p in dps])
        if d.shape[:3] == imgs.shape[:3]:
            depths = d
    return splats, imgs, c2w, Ks, depths


def load_colmap_dir(colmap_dir: str, size: int, normalize: bool,
                    result_dir: Optional[str] = None, log_fn=print):
    """A COLMAP dataset -> (splats, images, c2w, Ks, None). The splats come
    from gaussians.ply in `result_dir` (or the dataset), moved by the
    normalisation's similarity when `normalize`, else from the points."""
    from .training import colmap_dataset as cds

    scene = cds.parse_colmap(colmap_dir, normalize=normalize)
    imgs, Ks = cds.load_scene_arrays(scene, target_size=size)
    log_fn(f"COLMAP scene: {len(imgs)} images, {len(scene.points)} points, "
           f"scene_scale {scene.scene_scale:.3f}")

    ply_path = os.path.join(result_dir or colmap_dir, "gaussians.ply")
    if os.path.exists(ply_path):
        splats = _splats_from_ply(ply_path)
        if normalize:
            T = scene.transform
            s = float(np.cbrt(max(np.linalg.det(T[:3, :3]), 1e-12)))
            splats["means"] = cds.transform_points(T, splats["means"])
            splats["scales"] = splats["scales"] * s
        log_fn(f"init from {ply_path}: {len(splats['means'])} splats")
    else:
        if not len(scene.points):
            raise FileNotFoundError("no points3D.bin and no gaussians.ply")
        splats = init_splats_from_points(scene.points, scene.points_rgb)
        log_fn(f"init from COLMAP points: {len(splats['means'])} splats")
    return splats, imgs, scene.c2w, Ks, None


def run(result_dir: Optional[str] = None, images_dir: Optional[str] = None,
        iters: int = 1000, size: int = 518, max_per_tile: int = 4096,
        depth_loss: bool = False, depth_lambda: float = 1e-2,
        opacity_reg: float = 0.0, scale_reg: float = 0.0, *,
        colmap: Optional[str] = None, normalize: bool = False,
        rasterizer: str = "pallas", video: bool = False,
        strategy: str = "default", selective_adam: bool = False,
        gs2d: bool = False, pose_opt: bool = False, random_bkgd: bool = False,
        bilateral_grid: bool = False, tb: Optional[str] = None,
        test_every: int = 0, eval_every: int = 0, compress: bool = False,
        viewer: bool = False, viewer_port: int = 0, device=None,
        log_fn=print) -> dict:
    """The CLI's work with its options as keywords: optimise the splats of
    an inference directory (with `images_dir`) or of a COLMAP dataset
    (`colmap`), write gaussians_opt.ply (and the optional outputs) into
    `result_dir`, else the dataset, and return the optimised splats
    (numpy). Runs on CUDA unless `device` names another; without a GPU,
    device=None raises."""
    if video:
        render_lib.require_cv2("--video")
    dev = resolve_device(device)
    if colmap:
        out_dir = result_dir or colmap
        splats, imgs, c2w, Ks, depths = load_colmap_dir(
            colmap, size, normalize, result_dir, log_fn)
    else:
        if not (result_dir and images_dir):
            raise ValueError("need <infer_out_dir> <images_dir> or --colmap <dir>")
        out_dir = result_dir
        splats, imgs, c2w, Ks, depths = load_infer_dir(result_dir, images_dir,
                                                       size, log_fn)

    # train / test split: every test_every-th view is held out
    S = len(imgs)
    idx = np.arange(S)
    if test_every > 0 and S > test_every:
        test_idx = idx[idx % test_every == 0]
        train_idx = idx[idx % test_every != 0]
    else:
        train_idx, test_idx = idx, np.empty((0,), np.int64)

    cfg = splat_opt.SplatOptConfig(
        iters=iters, rasterizer_impl=rasterizer, max_per_tile=max_per_tile,
        strategy=strategy, use_selective_adam=selective_adam, pose_opt=pose_opt,
        mode="2dgs" if gs2d else "3dgs",
        depth_loss=depth_loss and depths is not None, depth_lambda=depth_lambda,
        random_bkgd=random_bkgd, opacity_reg=opacity_reg, scale_reg=scale_reg,
        use_bilateral_grid=bilateral_grid, tb_save_image=bool(tb),
        eval_every=eval_every)
    live = None
    if viewer:
        from .training.live_viewer import LiveViewer
        live = LiveViewer(os.path.join(out_dir, "live"), port=viewer_port)
        log_fn(f"live viewer: {live.url}")
    eval_data = ((imgs[test_idx], c2w[test_idx], Ks[test_idx])
                 if (eval_every > 0 and len(test_idx)) else None)
    try:
        out = splat_opt.optimize_splats(
            splats, imgs[train_idx], c2w[train_idx], Ks[train_idx], cfg,
            log_fn=log_fn,
            depths=depths[train_idx] if depths is not None else None,
            device=dev, tb_logdir=tb, eval_data=eval_data, viewer=live)
    finally:
        if live is not None:
            live.close()
    log_fn(f"optimized: {len(out['means'])} splats alive")

    if len(test_idx):
        from .utils.metrics import nvs_metrics
        frames, _ = render_lib.render_trajectory(
            out, c2w[test_idx], Ks[test_idx], imgs.shape[2], imgs.shape[1],
            impl=rasterizer, device=dev)
        m = nvs_metrics(np.clip(frames[..., :3], 0, 1), imgs[test_idx])
        log_fn(f"eval on {len(test_idx)} held-out views: "
               f"PSNR {m['psnr']:.2f} SSIM {m['ssim']:.4f}")

    op = np.clip(out["opacities"], 1e-6, 1 - 1e-6)
    path = os.path.join(out_dir, "gaussians_opt.ply")
    io_ply.save_gs_ply(path, out["means"], out["scales"], out["quats"],
                       out["sh"][:, 0], np.log(op / (1 - op)),
                       scale_percentile=1.0)
    log_fn(f"wrote {path}")
    if "c2w_opt" in out:
        np.savez(os.path.join(out_dir, "cameras_opt.npz"), c2w=out["c2w_opt"],
                 Ks=Ks[train_idx])
        log_fn(f"wrote {out_dir}/cameras_opt.npz (pose-optimized cameras)")

    if compress:
        # pre-activation values compress best
        from .io import compression
        cdir = os.path.join(out_dir, "compressed")
        meta = compression.compress(cdir, {
            "means": out["means"],
            "scales": np.log(np.maximum(out["scales"], 1e-12)),
            "quats": out["quats"],
            "opacities": np.log(op / (1 - op)),
            "sh": out["sh"]})
        sz = sum(os.path.getsize(os.path.join(cdir, f)) for f in os.listdir(cdir))
        log_fn(f"wrote {cdir}: {meta['count']} splats, {sz / 1e6:.2f} MB")

    if video:
        H, W = imgs.shape[1:3]
        traj, traj_K = render_lib.interpolate_trajectory(c2w, Ks)
        frames, _ = render_lib.render_trajectory(out, traj, traj_K, W, H,
                                                 impl=rasterizer, device=dev)
        vp = render_lib.save_video(os.path.join(out_dir, "optimized.mp4"), frames)
        log_fn(f"wrote {vp}")
    return out


def main(argv: Optional[list] = None, device=None):
    p = argparse.ArgumentParser(description="splat post-optimisation (GPU)")
    p.add_argument("result_dir", nargs="?", help="inference output dir")
    p.add_argument("images_dir", nargs="?", help="source images dir or .npy stack")
    p.add_argument("--colmap", help="COLMAP dataset dir (sparse/0 + images/)")
    p.add_argument("--normalize", action="store_true",
                   help="COLMAP scene normalisation (cameras, then the "
                        "points' principal axes)")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--rasterizer", choices=["jax", "pallas"], default="pallas",
                   help="pallas: flat lists, kernels K2 and K3; jax: dense "
                        "bins, kernel K4 with the plain backward")
    p.add_argument("--video", action="store_true",
                   help="render the interpolated trajectory after training "
                        "into optimized.mp4 (cv2)")
    p.add_argument("--max-per-tile", type=int, default=4096)
    p.add_argument("--strategy", choices=["default", "mcmc"], default="default",
                   help="densification: gsplat DefaultStrategy or MCMC "
                        "(teleport + growth + position noise)")
    p.add_argument("--selective-adam", action="store_true",
                   help="visibility-masked Adam (gsplat SelectiveAdam)")
    p.add_argument("--gs2d", action="store_true",
                   help="optimise as 2D Gaussian surfels (ops/gs2d.py) instead of 3DGS")
    p.add_argument("--pose-opt", action="store_true",
                   help="optimise per-camera SE(3) deltas")
    p.add_argument("--depth-loss", action="store_true",
                   help="disparity-space depth supervision")
    p.add_argument("--depth-lambda", type=float, default=1e-2)
    p.add_argument("--random-bkgd", action="store_true",
                   help="composite over a random background each step")
    p.add_argument("--opacity-reg", type=float, default=0.0)
    p.add_argument("--scale-reg", type=float, default=0.0)
    p.add_argument("--bilateral-grid", action="store_true",
                   help="per-view bilateral-grid appearance compensation")
    p.add_argument("--tb", metavar="LOGDIR",
                   help="write TensorBoard events (loss / num_GS scalars, "
                        "render-vs-GT images)")
    p.add_argument("--test-every", type=int, default=0,
                   help="hold out every Nth view for PSNR/SSIM eval; 0 "
                        "trains on all")
    p.add_argument("--eval-every", type=int, default=0,
                   help="in-loop eval cadence on the held-out split; needs "
                        "--test-every")
    p.add_argument("--compress", action="store_true",
                   help="PNG-compress the optimised splats into compressed/")
    p.add_argument("--viewer", action="store_true",
                   help="serve a live WebGL viewer while training")
    p.add_argument("--viewer-port", type=int, default=0)
    args = p.parse_args(argv)
    return run(args.result_dir, args.images_dir, iters=args.iters, size=args.size,
               max_per_tile=args.max_per_tile, depth_loss=args.depth_loss,
               depth_lambda=args.depth_lambda, opacity_reg=args.opacity_reg,
               scale_reg=args.scale_reg, colmap=args.colmap,
               normalize=args.normalize, rasterizer=args.rasterizer,
               video=args.video, strategy=args.strategy,
               selective_adam=args.selective_adam, gs2d=args.gs2d,
               pose_opt=args.pose_opt, random_bkgd=args.random_bkgd,
               bilateral_grid=args.bilateral_grid, tb=args.tb,
               test_every=args.test_every, eval_every=args.eval_every,
               compress=args.compress, viewer=args.viewer,
               viewer_port=args.viewer_port, device=device)


if __name__ == "__main__":
    main()
