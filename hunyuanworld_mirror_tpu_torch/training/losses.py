"""Photometric losses for splat optimisation.

Port of the NVS losses of hunyuanworld_mirror_tpu/training/losses.py
(gsplat's example trainer: (1 - lambda) L1 + lambda (1 - SSIM)). Images
stay NHWC at the public functions, as in the JAX package.
"""

import torch
import torch.nn.functional as F


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
