"""Pinhole unprojection. Port of hunyuanworld_mirror_tpu/utils/geometry.py."""

from typing import Tuple

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v) integer pixel-coordinate grids of shape (H, W)."""
    v = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return u, v


def depth_to_camera_coords(depthmap: torch.Tensor, intrinsics: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) depth + (B, 3, 3) K -> camera points (B, H, W, 3), mask."""
    B, H, W = depthmap.shape
    fx = intrinsics[:, 0, 0, None, None]
    fy = intrinsics[:, 1, 1, None, None]
    cx = intrinsics[:, 0, 2, None, None]
    cy = intrinsics[:, 1, 2, None, None]
    u, v = pixel_grid(H, W, depthmap.dtype, depthmap.device)
    z = depthmap
    x = (u[None] - cx) * z / fx
    y = (v[None] - cy) * z / fy
    return torch.stack([x, y, z], dim=-1), depthmap > 0.0


def depth_to_world_coords_points(depth_map: torch.Tensor,
                                 extrinsic: torch.Tensor,
                                 intrinsic: torch.Tensor, eps: float = 1e-8):
    """Unproject (B, H, W) depths through (B, 4, 4) camera-to-world poses.

    Returns (world points (B,H,W,3), camera points (B,H,W,3), mask (B,H,W)).
    """
    point_mask = depth_map > eps
    cam_pts, _ = depth_to_camera_coords(depth_map, intrinsic)
    R = extrinsic[:, :3, :3]
    t = extrinsic[:, :3, 3]
    world = torch.einsum("bhwi,bji->bhwj", cam_pts, R) + t[:, None, None, :]
    return world, cam_pts, point_mask


def create_pixel_coordinate_grid(num_frames: int, height: int, width: int
                                 ) -> torch.Tensor:
    """(S, H, W, 3) grid of (x, y, frame index) per pixel, f32."""
    u, v = pixel_grid(height, width)
    f = torch.arange(num_frames, dtype=torch.float32)
    return torch.stack([u[None].expand(num_frames, height, width),
                        v[None].expand(num_frames, height, width),
                        f[:, None, None].expand(num_frames, height, width)], dim=-1)
