"""CenterSnap target generation and peak decoding (host side, numpy).

A copy of hunyuanworld_mirror_tpu/preprocessing.py (the port imports
nothing of the JAX package):
  * per-object Gaussian heatmaps from instance masks (the mask pixels'
    covariance scaled by 0.8, the centre the mean of the mask centroid and
    the projected 3D object centre), and the 12-channel absolute-pose field
    (rot6d = the first two columns of R, translation, bbox size) assigned
    per pixel by heatmap argmax, then 2x downscaled;
  * peak extraction (local maxima within a radius above a confidence
    floor, sorted by x) and pose decoding at the peaks with Gram-Schmidt
    rot6d -> R.

Dataset preparation and evaluation glue: it stays in numpy on the host
(scipy.ndimage's maximum filter for the peaks).
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

PEAK_CONCENTRATION = 0.8
DOWNSCALE_VALUE = 2


def resize_intrinsics(K: np.ndarray, new_h: int, new_w: int,
                      orig_h: int, orig_w: int) -> np.ndarray:
    """Scale fx/cx by w-ratio and fy/cy by h-ratio (reference :78-86)."""
    out = np.array(K, np.float32).copy()
    out[0, 0] *= new_w / orig_w
    out[0, 2] *= new_w / orig_w
    out[1, 1] *= new_h / orig_h
    out[1, 2] *= new_h / orig_h
    return out


def compute_heatmap_from_mask(mask: np.ndarray,
                              translation: Optional[np.ndarray] = None,
                              intrinsics: Optional[np.ndarray] = None,
                              min_pixels: int = 8) -> np.ndarray:
    """(H, W) Gaussian heatmap in [0,1] for one instance mask.

    Center = mask centroid, averaged with the projected 3D center when
    translation+intrinsics are given; covariance = mask pixel scatter * 0.8
    (reference :91-166). Intrinsics must already match the mask resolution.
    """
    H, W = mask.shape
    mask = mask.astype(bool)
    if mask.sum() < min_pixels:
        return np.zeros((H, W), np.float32)

    coords = np.column_stack(np.nonzero(mask)).astype(np.float64)  # (n, 2) yx
    mean = np.floor(coords.mean(axis=0))

    if translation is not None and intrinsics is not None:
        px = np.asarray(intrinsics, np.float64) @ np.asarray(translation, np.float64).reshape(3)
        if px[2] > 1e-6:
            mean = 0.5 * (mean + (px[:2] / px[2])[::-1])  # (y, x)

    cov = np.cov((coords - mean).T)
    if not np.isfinite(cov).all() or np.linalg.det(cov) <= 1e-8:
        cov = np.eye(2) * 4.0
    cov = cov * PEAK_CONCENTRATION

    # multivariate normal pdf evaluated on the pixel grid (direct math —
    # scipy.stats not needed)
    yy, xx = np.mgrid[0:H, 0:W]
    d = np.stack([yy, xx], -1).reshape(-1, 2).astype(np.float64) - mean
    cov_inv = np.linalg.pinv(cov)
    m2 = np.einsum("ni,ij,nj->n", d, cov_inv, d)
    heat = np.exp(-0.5 * m2).reshape(H, W).astype(np.float32)
    mx = heat.max()
    return heat / mx if mx > 0 else heat


def compute_heatmaps_from_masks(masks: Sequence[np.ndarray],
                                translations: Optional[Sequence] = None,
                                intrinsics: Optional[np.ndarray] = None
                                ) -> List[np.ndarray]:
    out = []
    for i, m in enumerate(masks):
        t = translations[i] if translations is not None else None
        out.append(compute_heatmap_from_mask(m, t, intrinsics))
    return out


def compute_abspose_field(rotations: Sequence[np.ndarray],
                          translations: Sequence[np.ndarray],
                          bbox_sizes: Sequence[np.ndarray],
                          heatmaps: Sequence[np.ndarray]) -> np.ndarray:
    """12-channel abs-pose target (reference :18-38).

    Per pixel, the object whose heatmap is maximal owns the pixel; its
    [R[:, :2].reshape(-1) (6), t (3), size (3)] fills the channel vector.
    Returned at 1/DOWNSCALE_VALUE resolution.
    """
    H, W = heatmaps[0].shape
    n = len(heatmaps)
    field = np.zeros((n, H, W, 12), np.float32)
    owner = np.argmax(np.stack(heatmaps), axis=0)
    for i in range(n):
        R = np.asarray(rotations[i], np.float32)
        vec = np.concatenate([
            R[:, :2].reshape(-1),
            np.asarray(translations[i], np.float32).reshape(3),
            np.asarray(bbox_sizes[i], np.float32).reshape(3)])
        field[i, owner == i] = vec
    return field.sum(axis=0)[::DOWNSCALE_VALUE, ::DOWNSCALE_VALUE].copy()


def make_targets(masks, rotations, translations, bbox_sizes,
                 intrinsics: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Full target pair for one frame: (heatmap (H,W), pose field (H/2,W/2,12)).

    The training heatmap is the per-pixel max over object heatmaps."""
    heatmaps = compute_heatmaps_from_masks(masks, translations, intrinsics)
    field = compute_abspose_field(rotations, translations, bbox_sizes, heatmaps)
    heat = np.max(np.stack(heatmaps), axis=0) if heatmaps else None
    return heat, field


def save_targets(prefix: str, heatmap: np.ndarray, abs_pose: np.ndarray):
    """npz writers matching the WDS sample keys (reference :5-11)."""
    np.savez_compressed(prefix + "heatmap.npz", heatmap=heatmap)
    np.savez_compressed(prefix + "pose_map.npz", abs_pose=abs_pose)


def extract_peaks(heatmap: np.ndarray, min_distance: int = 10,
                  min_confidence: float = 0.20) -> np.ndarray:
    """Local maxima (y, x), sorted by x (reference utils.py:203-224).

    skimage.peak_local_max replaced by a scipy maximum filter: a pixel is a
    peak iff it equals the local max in a (2r+1) window and clears the
    confidence floor."""
    from scipy.ndimage import maximum_filter

    h = np.asarray(heatmap, np.float32)
    if h.ndim != 2:
        h = np.squeeze(h)
    local_max = maximum_filter(h, size=2 * min_distance + 1, mode="constant")
    is_peak = (h == local_max) & (h > min_confidence)
    peaks = np.column_stack(np.nonzero(is_peak))
    if peaks.size:
        peaks = peaks[peaks[:, 1].argsort()]
    return peaks


def rot6d_to_matrix(rot6d: np.ndarray) -> np.ndarray:
    """Gram-Schmidt rot6d (3,2 column-major halves) -> R (3,3)
    (reference utils.py:277-287)."""
    m = rot6d.reshape(3, 2)
    a1, a2 = m[:, 0], m[:, 1]
    b1 = a1 / (np.linalg.norm(a1) + 1e-8)
    b2 = a2 - np.dot(b1, a2) * b1
    b2 = b2 / (np.linalg.norm(b2) + 1e-8)
    b3 = np.cross(b1, b2)
    return np.stack((b1, b2, b3), axis=1)


def extract_poses_at_peaks(peaks: np.ndarray, pose_field: np.ndarray,
                           scale_factor: int = 2
                           ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Decode 4x4 poses + bbox sizes at heatmap peaks (reference :226-295)."""
    assert pose_field.shape[-1] == 12
    poses, sizes = [], []
    for y, x in peaks:
        v = min(int(y) // scale_factor, pose_field.shape[0] - 1)
        u = min(int(x) // scale_factor, pose_field.shape[1] - 1)
        vals = pose_field[v, u]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = rot6d_to_matrix(vals[:6])
        T[:3, 3] = vals[6:9]
        poses.append(T)
        sizes.append(vals[9:12].copy())
    return poses, sizes
