"""COLMAP-reconstruction input for the splat trainer.

A copy of hunyuanworld_mirror_tpu/training/colmap_dataset.py (the port
imports nothing of the JAX package) on the port's io/colmap.py readers,
numpy only: `parse_colmap` reads cameras.bin / images.bin / points3D.bin
into per-image c2w, K and image paths, sorted by name, with the optional
scene normalisation (`similarity_from_cameras`, then `align_principal_axes`
of the point cloud: gsplat's datasets/normalize.py); `load_scene_arrays`
loads the images through PIL.
"""

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io import colmap as colmap_io


def _qvec_wxyz_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP WXYZ quaternion -> 3x3 rotation."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _camera_K(cam: Dict) -> np.ndarray:
    model, p = cam["model"], cam["params"]
    if model == "SIMPLE_PINHOLE":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    elif model == "PINHOLE":
        fx, fy, cx, cy = p[:4]
    elif model in ("SIMPLE_RADIAL", "RADIAL"):
        # distortion dropped, as the JAX function drops it (the inference
        # CLI's COLMAP export is SIMPLE_PINHOLE)
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    elif model == "OPENCV":
        fx, fy, cx, cy = p[:4]
    else:
        raise ValueError(f"unsupported COLMAP camera model {model}")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


# ---------------------------------------------------------------------------
# scene normalization
# ---------------------------------------------------------------------------

def similarity_from_cameras(c2w: np.ndarray,
                            strict_scaling: bool = False) -> np.ndarray:
    """4x4 similarity aligning the average camera "up" to +z, centering on
    the median camera focus point, scaling median camera distance to 1."""
    t, R = c2w[:, :3, 3], c2w[:, :3, :3]

    # world up = mean of camera -y axes (OpenCV convention: y points down)
    up = R @ np.array([0.0, -1.0, 0.0])
    world_up = up.mean(axis=0)
    world_up /= np.linalg.norm(world_up)
    # rotation bringing world_up onto [0, -1, 0], closed form
    target = np.array([0.0, -1.0, 0.0])
    c = float(world_up @ target)
    v = np.cross(world_up, target)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    if c > -1 + 1e-8:
        R_align = np.eye(3) + K + K @ K / (1.0 + c)
    else:
        R_align = np.diag([-1.0, 1.0, 1.0])

    R2 = R_align @ R
    t2 = t @ R_align.T
    fwd = R2 @ np.array([0.0, 0.0, 1.0])

    # center: median of each camera ray's closest point to the origin
    nearest = t2 + ((fwd * -t2).sum(-1))[:, None] * fwd
    translate = -np.median(nearest, axis=0)

    T = np.eye(4)
    T[:3, :3] = R_align
    T[:3, 3] = translate
    scale_fn = np.max if strict_scaling else np.median
    scale = 1.0 / max(float(scale_fn(np.linalg.norm(t2 + translate, axis=-1))),
                      1e-8)
    T[:3, :] *= scale
    return T


def align_principal_axes(points: np.ndarray) -> np.ndarray:
    """4x4 rotating the point cloud's principal axes onto x/y/z (z = least
    variance), centered on the median point."""
    centroid = np.median(points, axis=0)
    cov = np.cov(points - centroid, rowvar=False)
    evals, evecs = np.linalg.eigh(cov)
    evecs = evecs[:, evals.argsort()[::-1]]
    if np.linalg.det(evecs) < 0:
        evecs[:, 0] *= -1
    T = np.eye(4)
    T[:3, :3] = evecs.T
    T[:3, 3] = -evecs.T @ centroid
    return T


def transform_points(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def transform_cameras(T: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    out = np.einsum("ij,njk->nik", T, c2w)
    # renormalize rotation rows (similarity transforms carry scale)
    scaling = np.linalg.norm(out[:, 0, :3], axis=1)
    out[:, :3, :3] = out[:, :3, :3] / scaling[:, None, None]
    return out


def normalize_scene(c2w: np.ndarray, points: Optional[np.ndarray] = None):
    """Similarity from the cameras, then principal-axis alignment of the
    point cloud. Returns (c2w', points', T_total)."""
    T1 = similarity_from_cameras(c2w)
    c2w = transform_cameras(T1, c2w)
    if points is not None and len(points) >= 3:
        points = transform_points(T1, points)
        T2 = align_principal_axes(points)
        c2w = transform_cameras(T2, c2w)
        points = transform_points(T2, points)
        return c2w, points, T2 @ T1
    return c2w, points, T1


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

@dataclass
class ColmapScene:
    image_names: List[str]
    image_paths: List[str]
    c2w: np.ndarray              # (N, 4, 4) float32
    Ks: np.ndarray               # (N, 3, 3) float32
    sizes: np.ndarray            # (N, 2) int — (width, height)
    points: np.ndarray           # (P, 3) float32
    points_rgb: np.ndarray       # (P, 3) uint8
    scene_scale: float = 1.0
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))



def parse_colmap(data_dir: str, factor: int = 1,
                 normalize: bool = False) -> ColmapScene:
    """Load a COLMAP reconstruction dir (sparse/0 or sparse) + images."""
    sparse = os.path.join(data_dir, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(data_dir, "sparse")
    if not os.path.isdir(sparse):
        raise FileNotFoundError(f"no COLMAP sparse dir under {data_dir}")

    cams = colmap_io.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    imgs = colmap_io.read_images_bin(os.path.join(sparse, "images.bin"))
    pts_path = os.path.join(sparse, "points3D.bin")
    pts = (colmap_io.read_points3d_bin(pts_path)
           if os.path.exists(pts_path) else {})

    img_dir = os.path.join(data_dir,
                           "images" if factor == 1 else f"images_{factor}")
    if not os.path.isdir(img_dir):
        img_dir = os.path.join(data_dir, "images")

    recs = sorted(imgs.values(), key=lambda im: im["name"])
    c2w_list, K_list, names, paths, sizes = [], [], [], [], []
    for im in recs:
        R = _qvec_wxyz_to_rotmat(im["qvec"])
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im["tvec"]
        c2w_list.append(np.linalg.inv(w2c))
        cam = cams[im["camera_id"]]
        K = _camera_K(cam)
        K[:2, :] /= factor
        K_list.append(K)
        names.append(im["name"])
        paths.append(os.path.join(img_dir, im["name"]))
        sizes.append((cam["width"] // factor, cam["height"] // factor))

    c2w = np.stack(c2w_list).astype(np.float64)
    Ks = np.stack(K_list)
    points = (np.stack([p["xyz"] for p in pts.values()])
              if pts else np.zeros((0, 3)))
    rgb = (np.stack([p["rgb"] for p in pts.values()]).astype(np.uint8)
           if pts else np.zeros((0, 3), np.uint8))

    T = np.eye(4)
    if normalize:
        c2w, points2, T = normalize_scene(c2w, points if len(points) else None)
        if points2 is not None:
            points = points2

    # the largest camera distance from the cameras' mean
    locs = c2w[:, :3, 3]
    scene_scale = float(np.max(np.linalg.norm(locs - locs.mean(0), axis=1)))

    return ColmapScene(names, paths, c2w.astype(np.float32),
                       Ks.astype(np.float32),
                       np.asarray(sizes, np.int64),
                       points.astype(np.float32), rgb,
                       scene_scale=scene_scale, transform=T)


def load_scene_arrays(scene: ColmapScene, target_size: int = 518):
    """Load the scene's images resized so the longer side == target_size
    (no crop: the splat trainer has no patch-size constraint), rescaling
    each K to match. Returns (images (N, H, W, 3) f32 in [0, 1], Ks').

    All images must share one post-resize shape (single-camera COLMAP runs,
    as the inference CLI's export writes them).
    """
    from PIL import Image

    arrs, Ks = [], []
    for path, K in zip(scene.image_paths, scene.Ks):
        img = Image.open(path).convert("RGB")
        w0, h0 = img.size
        s = target_size / max(w0, h0)
        w1, h1 = max(1, round(w0 * s)), max(1, round(h0 * s))
        img = img.resize((w1, h1), Image.Resampling.BICUBIC)
        K2 = K.copy()
        K2[0, :] *= w1 / w0
        K2[1, :] *= h1 / h0
        arrs.append(np.asarray(img, np.float32) / 255.0)
        Ks.append(K2)
    shapes = {a.shape for a in arrs}
    if len(shapes) != 1:
        raise ValueError(f"mixed image shapes after resize: {shapes}")
    return np.stack(arrs), np.stack(Ks).astype(np.float32)
