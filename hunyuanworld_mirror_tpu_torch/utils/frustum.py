"""Cross-view visibility: bilinear sampling, reprojection, and the mask of
a target view's pixels that some context view also sees.

Port of hunyuanworld_mirror_tpu/utils/frustum.py: unproject the target's
depth into the world, reproject into each context view, and keep the pixels
that land in bounds with positive depth consistent with that view's
(bilinearly sampled) depth map. Bundle adjustment's data association
(refine/ba.build_tracks) uses the same gate.
"""

from typing import Tuple

import torch

from . import geometry
from .camera import se3_inverse


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample (H, W) or (H, W, C) at continuous pixel coords uv (..., 2) =
    (x, y), clamped to the image."""
    H, W = img.shape[:2]
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    x = torch.clamp(uv[..., 0], 0.0, W - 1.0)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    v = (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
         + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)
    return v[..., 0] if squeeze else v


def project_points(points_w: torch.Tensor, w2c: torch.Tensor,
                   K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points (..., 3) -> pixel coords (..., 2) and camera depth (...)."""
    p_cam = torch.einsum("ij,...j->...i", w2c[:3, :3], points_w) + w2c[:3, 3]
    z = p_cam[..., 2]
    uv = (p_cam[..., :2] / torch.clamp_min(torch.abs(z[..., None]), 1e-8)
          * torch.sign(z[..., None]))
    u = uv[..., 0] * K[0, 0] + K[0, 2]
    v = uv[..., 1] * K[1, 1] + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def calculate_unprojected_mask(target_depth: torch.Tensor,
                               target_c2w: torch.Tensor,
                               target_K: torch.Tensor,
                               context_depths: torch.Tensor,
                               context_c2w: torch.Tensor,
                               context_K: torch.Tensor,
                               depth_tolerance: float = 0.05) -> torch.Tensor:
    """(H, W) bool mask of the target's pixels (depth (H, W), c2w (4, 4),
    K (3, 3)) that reproject into at least one context view (depths
    (S, H, W), c2w (S, 4, 4), K (S, 3, 3)) in bounds, in front, and at a
    depth within `depth_tolerance` (relative) of that view's depth map."""
    H, W = target_depth.shape
    world, _, valid = geometry.depth_to_world_coords_points(
        target_depth[None], target_c2w[None], target_K[None])
    world = world[0]
    covered = torch.zeros((H, W), dtype=torch.bool, device=target_depth.device)
    for s in range(context_depths.shape[0]):
        uv, z = project_points(world, se3_inverse(context_c2w[s]), context_K[s])
        in_bounds = ((uv[..., 0] >= 0) & (uv[..., 0] <= W - 1)
                     & (uv[..., 1] >= 0) & (uv[..., 1] <= H - 1) & (z > 0))
        sampled = bilinear_sample(context_depths[s], uv)
        consistent = (torch.abs(sampled - z)
                      <= depth_tolerance * torch.clamp_min(sampled, 1e-6))
        covered = covered | (in_bounds & consistent)
    return covered & valid[0]
