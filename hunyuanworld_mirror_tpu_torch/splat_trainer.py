"""Post-inference splat optimisation CLI on one NVIDIA GPU (the port's twin
of tools/splat_trainer.py).

    python -m hunyuanworld_mirror_tpu_torch.splat_trainer <infer_out_dir> <images_dir>
        [--iters 1000] [--size 518] [--max-per-tile 4096]
        [--depth-loss] [--depth-lambda 1e-2] [--opacity-reg 0] [--scale-reg 0]

Reads what the inference CLI writes (gaussians.ply, camera_params.json and
depth_XXX.npy), optimises the splats against the source images at the
default strategy (training/splat_opt.py, backward kernel K3) and writes
gaussians_opt.ply into <infer_out_dir>. <images_dir> is an image directory
or a .npy stack, as the inference CLI takes. The port has one rasterizer
route, so there is no --rasterizer flag; the JAX CLI's other flags raise
NotImplementedError naming the ROADMAP item that ports them.
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
from .training import splat_opt

# flag -> the ROADMAP queue item that ports it
UNPORTED = {
    "--selective-adam": "Queue 1 item 8 (selective Adam, training/mcmc.py)",
    "--gs2d": "Queue 1 items 7-8 (2DGS training, ops/gs2d.py)",
    "--pose-opt": "Queue 1 item 8 (pose optimisation)",
    "--random-bkgd": "Queue 1 item 8 (random background)",
    "--bilateral-grid": "Queue 1 item 8 (bilateral grid, training/bilagrid.py)",
    "--tb": "Queue 1 item 8 (TensorBoard logging)",
    "--test-every": "Queue 1 item 8 (held-out eval, utils/metrics.py)",
    "--eval-every": "Queue 1 item 8 (held-out eval, utils/metrics.py)",
    "--viewer": "Queue 1 item 8 (live viewer)",
    "--compress": "Queue 1 item 8 (compression, io/compression.py)",
    "--video": "Queue 1 item 4 (io/render.py)",
    "--colmap": "Queue 1 item 8 (COLMAP input, training/colmap_dataset.py)",
}


def load_infer_dir(result_dir: str, images_dir: str, size: int, log_fn=print):
    """-> (splats (activated, quats wxyz, SH DC only), images (S, H, W, 3),
    c2w (S, 4, 4), Ks (S, 3, 3), depths (S, H, W) or None)."""
    gs = io_ply.read_ply(os.path.join(result_dir, "gaussians.ply"))
    splats = {
        "means": np.stack([gs["x"], gs["y"], gs["z"]], -1).astype(np.float32),
        "scales": np.exp(np.stack([gs[f"scale_{i}"] for i in range(3)], -1)
                         ).astype(np.float32),
        "quats": np.stack([gs[f"rot_{i}"] for i in range(4)], -1).astype(np.float32),
        "opacities": (1 / (1 + np.exp(-np.asarray(gs["opacity"])))).astype(np.float32),
        "sh": np.stack([gs[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :
                                                                ].astype(np.float32),
    }
    log_fn(f"loaded {len(gs['x'])} splats from {result_dir}/gaussians.ply")

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


def run(result_dir: str, images_dir: str, iters: int = 1000, size: int = 518,
        max_per_tile: int = 4096, depth_loss: bool = False,
        depth_lambda: float = 1e-2, opacity_reg: float = 0.0,
        scale_reg: float = 0.0, device=None, log_fn=print) -> dict:
    """Optimise an inference output directory's splats and write
    gaussians_opt.ply there; returns the optimised splats (numpy). Runs on
    CUDA unless `device` names another; without a GPU, device=None raises."""
    dev = resolve_device(device)
    splats, imgs, c2w, Ks, depths = load_infer_dir(result_dir, images_dir, size,
                                                   log_fn)
    cfg = splat_opt.SplatOptConfig(iters=iters, max_per_tile=max_per_tile,
                                   depth_loss=depth_loss and depths is not None,
                                   depth_lambda=depth_lambda,
                                   opacity_reg=opacity_reg, scale_reg=scale_reg)
    out = splat_opt.optimize_splats(splats, imgs, c2w, Ks, cfg, log_fn=log_fn,
                                    depths=depths, device=dev)
    log_fn(f"optimized: {len(out['means'])} splats alive")
    op = np.clip(out["opacities"], 1e-6, 1 - 1e-6)
    path = os.path.join(result_dir, "gaussians_opt.ply")
    io_ply.save_gs_ply(path, out["means"], out["scales"], out["quats"],
                       out["sh"][:, 0], np.log(op / (1 - op)),
                       scale_percentile=1.0)
    log_fn(f"wrote {path}")
    return out


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description="splat post-optimisation (GPU)")
    p.add_argument("result_dir", nargs="?", help="inference output dir")
    p.add_argument("images_dir", nargs="?", help="source images dir or .npy stack")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--max-per-tile", type=int, default=4096)
    p.add_argument("--depth-loss", action="store_true",
                   help="disparity-space depth supervision")
    p.add_argument("--depth-lambda", type=float, default=1e-2)
    p.add_argument("--opacity-reg", type=float, default=0.0)
    p.add_argument("--scale-reg", type=float, default=0.0)
    p.add_argument("--strategy", choices=["default", "mcmc"], default="default")
    for flag in UNPORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP {item}")
    if args.strategy != "default":
        raise NotImplementedError("--strategy mcmc is not ported yet: ROADMAP "
                                  "Queue 1 item 8 (training/mcmc.py)")
    if not (args.result_dir and args.images_dir):
        p.error("need <infer_out_dir> <images_dir>")
    run(args.result_dir, args.images_dir, iters=args.iters, size=args.size,
        max_per_tile=args.max_per_tile, depth_loss=args.depth_loss,
        depth_lambda=args.depth_lambda, opacity_reg=args.opacity_reg,
        scale_reg=args.scale_reg)


if __name__ == "__main__":
    main()
