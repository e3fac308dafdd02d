"""Training losses.

Port of hunyuanworld_mirror_tpu/training/losses.py. The CenterSnap loss:
100 MSE(heatmap) + masked L1(pose map), the pose mask the GT heatmap
> 0.3 sampled at the pose map's stride, the pose term split into its rot6d
and translation + size halves. The photometric losses of splat
optimisation (gsplat's example trainer: (1 - lambda) L1 + lambda
(1 - SSIM)). Images stay NHWC at the public functions, as in the JAX
package.
"""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   heatmap_gt: torch.Tensor, centroid_threshold: float = 0.3,
                   downscale_factor: int = 2) -> torch.Tensor:
    """pred/target (B, h, w, C); heatmap_gt (B, H, W) at full resolution.
    The L1 summed over channels and over the valid pixels, over their count
    (the plain sum, which is 0, when none is valid)."""
    valid = heatmap_gt[:, ::downscale_factor, ::downscale_factor] > centroid_threshold
    per_px = torch.sum(torch.abs(pred - target), dim=-1)
    per_px = torch.where(valid, per_px, torch.zeros_like(per_px))
    n = torch.sum(valid)
    total = torch.sum(per_px)
    return torch.where(n == 0, total, total / torch.clamp_min(n, 1))


def centersnap_loss(preds: Dict, batch: Dict, heat_weight: float = 100.0,
                    pose_weight: float = 1.0, centroid_threshold: float = 0.3
                    ) -> Tuple[torch.Tensor, Dict]:
    """preds: heatmap (B,H,W,1), pose_map (B,h,w,12); batch: heatmap (B,H,W),
    pose_map (B,h,w,12)."""
    heat_gt = batch["heatmap"]
    heatmap_loss = mse_loss(preds["heatmap"][..., 0], heat_gt)
    pose_pred, pose_gt = preds["pose_map"], batch["pose_map"]
    dr = heat_gt.shape[-1] // pose_pred.shape[-2]
    abs_rot = masked_l1_loss(pose_pred[..., :6], pose_gt[..., :6], heat_gt,
                             centroid_threshold, dr)
    tran_size = masked_l1_loss(pose_pred[..., 6:], pose_gt[..., 6:], heat_gt,
                               centroid_threshold, dr)
    pose_loss = abs_rot + tran_size
    total = heat_weight * heatmap_loss + pose_weight * pose_loss
    return total, {"heatmap_loss": heatmap_loss, "abs_rot_loss": abs_rot,
                   "tran_size_loss": tran_size, "pose_loss": pose_loss}


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-x ** 2 / (2 * sigma ** 2))
    return g / torch.sum(g)


def ssim(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """SSIM over (..., H, W, C) images in [0, 1]: an 11x11 separable
    Gaussian window as two depthwise convolutions (groups=C) with zero
    padding 5, which is what JAX's SAME padding does."""
    C = a.shape[-1]
    k = _gaussian_kernel1d(device=a.device).to(a.dtype)
    ky = k.view(1, 1, 11, 1).repeat(C, 1, 1, 1)
    kx = k.view(1, 1, 1, 11).repeat(C, 1, 1, 1)

    def blur(x):
        shape = x.shape
        x4 = x.reshape((-1,) + tuple(shape[-3:])).permute(0, 3, 1, 2)
        x4 = F.conv2d(x4, ky, padding=(5, 0), groups=C)
        x4 = F.conv2d(x4, kx, padding=(0, 5), groups=C)
        return x4.permute(0, 2, 3, 1).reshape(shape)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     ssim_lambda: float = 0.2) -> torch.Tensor:
    l1 = torch.mean(torch.abs(pred - target))
    return (1.0 - ssim_lambda) * l1 + ssim_lambda * (1.0 - ssim(pred, target))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
