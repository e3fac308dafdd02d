"""Training-time visuals: heatmap grids and 3D bbox / pose-axes overlays.

A copy of hunyuanworld_mirror_tpu/training/visualize.py (the port imports
nothing of the JAX package), in numpy: GT-vs-predicted heatmap grids
through the turbo colormap, and RGB overlays with each decoded heatmap
peak's projected 3D bounding box and pose axes (Bresenham lines), as the
reference's training loop logs them; the images go to TBWriter.image.
"""

from typing import Dict, Optional

import numpy as np

from .. import preprocessing as prep
from ..io.render import turbo_colormap

# bbox wireframe edges over the 8 corners (z-minor bit order)
_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
          (0, 4), (1, 5), (2, 6), (3, 7)]
_AXIS_COLORS = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]  # x, y, z


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """In-place Bresenham segment on (H, W, 3) uint8; clips to bounds."""
    h, w = img.shape[:2]
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    if max(abs(x0), abs(x1), abs(y0), abs(y1)) > 10 * max(h, w):
        return  # wildly out-of-frame projection; skip rather than loop 10k px
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err = dx + dy
    while True:
        if 0 <= y0 < h and 0 <= x0 < w:
            img[y0, x0] = color
        if x0 == x1 and y0 == y1:
            return
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def project(pts_cam: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(N, 3) camera-frame points -> (N, 2) pixel (u, v)."""
    z = np.maximum(pts_cam[:, 2:3], 1e-6)
    xy = pts_cam[:, :2] / z
    return xy @ K[:2, :2].T + K[:2, 2]


def bbox_corners(size: np.ndarray) -> np.ndarray:
    """(3,) full extents -> (8, 3) corners about the origin."""
    s = np.asarray(size, np.float32) / 2.0
    signs = np.array([[(i >> 2 & 1) * 2 - 1, (i >> 1 & 1) * 2 - 1,
                       (i & 1) * 2 - 1] for i in range(8)], np.float32)
    return signs * s


def draw_3d_bbox(img: np.ndarray, pose: np.ndarray, size: np.ndarray,
                 K: np.ndarray, color=(255, 210, 0)) -> None:
    """Project an object-frame bbox through a 4x4 cam-frame pose and draw."""
    corners = bbox_corners(size) @ pose[:3, :3].T + pose[:3, 3]
    if np.any(corners[:, 2] <= 1e-4):
        return  # behind the camera; projection is meaningless
    uv = project(corners, K)
    for a, b in _EDGES:
        draw_line(img, uv[a], uv[b], color)


def draw_pose_axes(img: np.ndarray, pose: np.ndarray, K: np.ndarray,
                   length: float = 0.05) -> None:
    origin = pose[:3, 3]
    if origin[2] <= 1e-4:
        return
    o_uv = project(origin[None], K)[0]
    for i in range(3):
        tip = origin + pose[:3, i] * length
        if tip[2] <= 1e-4:
            continue
        draw_line(img, o_uv, project(tip[None], K)[0], _AXIS_COLORS[i])


def _to_uint8(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a.copy()
    return np.clip(np.nan_to_num(a) * 255.0, 0, 255).astype(np.uint8)


def _heat_rgb(heat: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h', w') scalar map -> (h, w, 3) turbo uint8 (nearest upsample)."""
    hm = np.asarray(heat, np.float32)
    rng = hm.max() - hm.min()
    hm = (hm - hm.min()) / (rng + 1e-8)
    rgb = _to_uint8(turbo_colormap(hm))
    if rgb.shape[:2] != (h, w):
        yi = (np.arange(h) * rgb.shape[0] // h).clip(0, rgb.shape[0] - 1)
        xi = (np.arange(w) * rgb.shape[1] // w).clip(0, rgb.shape[1] - 1)
        rgb = rgb[yi][:, xi]
    return rgb


def heatmap_grid(rgb: np.ndarray, gt_heat: np.ndarray, pred_heat: np.ndarray,
                 max_samples: int = 4) -> np.ndarray:
    """Rows = samples, cols = [RGB | turbo(GT heat) | turbo(pred heat)].

    Matches the reference's wandb grid of GT-vs-pred heatmaps
    (train.py:244-262). All inputs are batched; floats in [0, 1].
    """
    n = min(len(rgb), max_samples)
    h, w = rgb.shape[1:3]
    rows = []
    for i in range(n):
        row = [_to_uint8(rgb[i]),
               _heat_rgb(np.squeeze(gt_heat[i]), h, w),
               _heat_rgb(np.squeeze(pred_heat[i]), h, w)]
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def default_intrinsics(h: int, w: int, focal_scale: float = 0.8) -> np.ndarray:
    f = focal_scale * max(h, w)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def bbox_overlay(rgb: np.ndarray, pred_heat: np.ndarray,
                 pred_pose_map: np.ndarray, K: Optional[np.ndarray] = None,
                 min_confidence: float = 0.3,
                 scale_factor: int = 2) -> np.ndarray:
    """RGB with projected 3D bboxes + pose axes at decoded heatmap peaks.

    Single image: rgb (H, W, 3), pred_heat (H, W), pose map
    (H/scale, W/scale, 12). Reference: train.py:263-282 (cutoop drawings at
    peaks decoded by training/data/datasets/utils.py:203-295).
    """
    img = _to_uint8(rgb)
    h, w = img.shape[:2]
    if K is None:
        K = default_intrinsics(h, w)
    peaks = prep.extract_peaks(np.squeeze(pred_heat),
                               min_confidence=min_confidence)
    poses, sizes = prep.extract_poses_at_peaks(peaks, pred_pose_map,
                                               scale_factor=scale_factor)
    for pose, size in zip(poses, sizes):
        draw_3d_bbox(img, pose, size, K)
        draw_pose_axes(img, pose, K, length=float(np.max(size)) * 0.6 + 1e-3)
    return img


def training_visuals(batch: Dict, preds: Dict, K: Optional[np.ndarray] = None,
                     max_samples: int = 4) -> Dict[str, np.ndarray]:
    """Build the reference's training visualizations from a batch + preds.

    Returns {tag: uint8 image} for TBWriter.image. `preds` uses the
    centersnap head outputs: "heatmap" (B, H, W, 1) and "pose_map"
    (B, h, w, 12).
    """
    rgb = np.asarray(batch["rgb"])
    gt = np.asarray(batch["heatmap"])
    ph = np.asarray(preds["heatmap"])
    pm = np.asarray(preds["pose_map"])
    out = {"vis/heatmaps": heatmap_grid(rgb, gt, ph, max_samples)}
    n = min(len(rgb), max_samples)
    overlays = [bbox_overlay(rgb[i], np.squeeze(ph[i]), pm[i], K=K)
                for i in range(n)]
    out["vis/bbox_overlay"] = np.concatenate(overlays, axis=1)
    return out
