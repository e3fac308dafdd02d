"""Evaluation CLI on one NVIDIA GPU (the port's twin of tools/eval.py).

Point-recon Acc/Comp, camera ATE/RPE, NVS PSNR/SSIM (+ LPIPS). Modes:

  # point clouds (PLY or .npy (N,3)):
  python -m hunyuanworld_mirror_tpu_torch.eval points --pred pred.ply --gt gt.ply [--align] [--median]

  # camera trajectories (.npz with key c2w (S,4,4), or .npy):
  python -m hunyuanworld_mirror_tpu_torch.eval cameras --pred pred.npz --gt gt.npz

  # novel-view renders vs GT frames (two directories of same-named images):
  python -m hunyuanworld_mirror_tpu_torch.eval nvs --pred pred_dir/ --gt gt_dir/

  # keyframe subsetting matching the reference protocol: --keyframe N takes
  # every Nth frame (e.g. 7-Scenes kf40/kf200, NRGBD kf100/kf500, DTU kf5).

Prints one JSON dict of metrics (main() also returns it). The nearest-
neighbour reduction of `points` and the image metrics of `nvs` run on CUDA
unless main() is given another device; without a GPU, device=None raises.
LPIPS is in the `nvs` dict when $WM_LPIPS_WEIGHTS names converted weights
(utils/lpips.py), else from the `lpips` package where it is installed.
"""

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from . import resolve_device
from .io import ply as io_ply
from .utils import metrics


def _load_points(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).reshape(-1, 3)
    if path.endswith((".ply", ".PLY")):
        rec = io_ply.read_ply(path)
        return np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    raise ValueError(f"unsupported point file {path}")


def _load_cams(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        z = np.load(path)
        for k in ("c2w", "poses", "camera_poses", "extrinsic"):
            if k in z:
                return z[k].reshape(-1, 4, 4)
        raise KeyError(f"no camera key in {path}: {list(z.keys())}")
    return np.load(path).reshape(-1, 4, 4)


def _read_rgb(path: str) -> np.ndarray:
    """One image file -> (H, W, 3) uint8 RGB: cv2 where it is installed
    (as the JAX tool reads it), else PIL. A file neither decodes raises."""
    try:
        import cv2
    except ImportError:
        from PIL import Image
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    im = cv2.imread(path, cv2.IMREAD_COLOR)
    if im is None:
        raise ValueError(f"cv2 cannot decode {path}")
    return im[..., ::-1]


def _load_image_dir(path: str) -> np.ndarray:
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    return np.stack([_read_rgb(os.path.join(path, f)).astype(np.float32) / 255.0
                     for f in files])


def main(argv: Optional[List[str]] = None, device=None) -> dict:
    """The CLI; `device` is where the metrics run (CUDA unless named)."""
    ap = argparse.ArgumentParser(description="WorldMirror evaluation (GPU)")
    ap.add_argument("mode", choices=["points", "cameras", "nvs"])
    ap.add_argument("--pred", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--align", action="store_true",
                    help="Umeyama sim(3) alignment before point metrics")
    ap.add_argument("--median", action="store_true",
                    help="median instead of mean for Acc/Comp")
    ap.add_argument("--max-points", type=int, default=65536)
    ap.add_argument("--keyframe", type=int, default=1,
                    help="take every Nth camera/frame (seq-id-map protocol)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    if args.mode == "points":
        pred = _load_points(args.pred)
        gt = _load_points(args.gt)
        acc, comp = metrics.accuracy_completeness(
            pred, gt, align=args.align, max_points=args.max_points,
            statistic="median" if args.median else "mean", device=dev)
        out = {"accuracy": acc, "completeness": comp,
               "chamfer": 0.5 * (acc + comp),
               "n_pred": len(pred), "n_gt": len(gt)}
    elif args.mode == "cameras":
        pred = _load_cams(args.pred)[::args.keyframe]
        gt = _load_cams(args.gt)[::args.keyframe]
        n = min(len(pred), len(gt))
        rot_e, t_e = metrics.rpe(pred[:n], gt[:n])
        out = {"ate_rmse": metrics.ate_rmse(pred[:n], gt[:n]),
               "rpe_rot_deg": rot_e, "rpe_trans": t_e, "n_frames": n}
    else:
        pred = _load_image_dir(args.pred)[::args.keyframe]
        gt = _load_image_dir(args.gt)[::args.keyframe]
        n = min(len(pred), len(gt))
        # nvs_metrics includes LPIPS (utils/lpips.py) when $WM_LPIPS_WEIGHTS
        # points at converted calibrated weights
        out = metrics.nvs_metrics(torch.as_tensor(pred[:n], device=dev), gt[:n])
        out["n_frames"] = n
        if "lpips" not in out:
            try:  # fall back to the torch lpips package if importable
                import lpips  # noqa: F401
                net = lpips.LPIPS(net="alex")
                a = torch.from_numpy(pred[:n].transpose(0, 3, 1, 2)) * 2 - 1
                b = torch.from_numpy(gt[:n].transpose(0, 3, 1, 2)) * 2 - 1
                with torch.no_grad():
                    out["lpips"] = float(net(a, b).mean())
            except Exception:
                pass

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
