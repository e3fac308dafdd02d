"""Image loading and preprocessing for the CLI (numpy; PIL only when reading
image files).

A copy of hunyuanworld_mirror_tpu/io/images.py's loader (the port imports
nothing of the JAX package): RGBA composited onto white, bicubic resize to
width `target_size` keeping aspect (height rounded to a patch multiple),
center-crop or white-pad to square, mixed sizes padded to one size. A `.npy`
file of (S, H, W, 3) or (1, S, H, W, 3) floats in [0, 1] is accepted as
is, for machines without PIL. A video file (VIDEO_EXTS) is sampled at
`fps` frames a second into PNGs beside it (cv2), which are then loaded as
images.
`crop_with_intrinsics` / `rescale_with_intrinsics` bring a caller's
intrinsics along with its own crop or resize of an image (cv2 for the
resize), for the intrinsics prior.

Output is NHWC float32 in [0, 1], shape (1, S, H, W, 3).
"""

import glob
import os
from typing import List, Sequence, Tuple

import numpy as np

IMAGE_EXTS = ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.webp", "*.JPG", "*.PNG")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def _resize_dims(w: int, h: int, max_dim: int, strategy: str,
                 patch_size: int = 14) -> Tuple[int, int]:
    if strategy == "pad":
        if w >= h:
            new_w = max_dim
            new_h = round(h * (new_w / w) / patch_size) * patch_size
        else:
            new_h = max_dim
            new_w = round(w * (new_h / h) / patch_size) * patch_size
    else:  # crop
        new_w = max_dim
        new_h = round(h * (new_w / w) / patch_size) * patch_size
    return new_w, new_h


def _pad_to_square(arr: np.ndarray, target: int) -> np.ndarray:
    h, w = arr.shape[:2]
    ph, pw = target - h, target - w
    if ph > 0 or pw > 0:
        top, left = max(ph, 0) // 2, max(pw, 0) // 2
        arr = np.pad(arr, ((top, max(ph, 0) - top), (left, max(pw, 0) - left), (0, 0)),
                     constant_values=1.0)
    return arr


def load_image(path: str, target_size: int = 518, strategy: str = "crop") -> np.ndarray:
    """One image -> (H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(path)
    if img.mode == "RGBA":
        white = Image.new("RGBA", img.size, (255, 255, 255, 255))
        img = Image.alpha_composite(white, img)
    img = img.convert("RGB")
    w, h = img.size
    new_w, new_h = _resize_dims(w, h, target_size, strategy)
    img = img.resize((new_w, new_h), Image.Resampling.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0

    if strategy == "crop" and new_h > target_size:
        start = (new_h - target_size) // 2
        arr = arr[start:start + target_size]
    if strategy == "pad":
        arr = _pad_to_square(arr, target_size)
    return arr


def prepare_images(paths: Sequence[str], target_size: int = 518,
                   strategy: str = "crop") -> np.ndarray:
    """Image files -> (1, S, H, W, 3) float32 batch; mixed sizes get padded."""
    if not paths:
        raise ValueError("At least 1 image is required")
    if strategy not in ("crop", "pad"):
        raise ValueError("Strategy must be 'crop' or 'pad'")

    arrs = [load_image(p, target_size, strategy) for p in paths]
    dims = {a.shape[:2] for a in arrs}
    if len(dims) > 1:
        mh = max(d[0] for d in dims)
        mw = max(d[1] for d in dims)
        arrs = [_pad_to_square(a, max(mh, mw)) if a.shape[:2] != (mh, mw) else a
                for a in arrs]
    return np.stack(arrs)[None]


def is_video(path: str) -> bool:
    """Whether `path` is a video file load_inputs samples into frames."""
    return os.path.isfile(path) and os.path.splitext(path)[1].lower() in VIDEO_EXTS


def video_to_frames(path: str, fps: float = 1.0, out_dir: str = None) -> List[str]:
    """Sample a video at `fps` frames a second (every round(native fps /
    fps)-th frame) into numbered PNGs in `out_dir`, by default a
    frames_<name> directory beside the video; returns their paths."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {path}")
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    step = max(1, round(native_fps / fps))

    out_dir = out_dir or os.path.join(os.path.dirname(path) or ".",
                                      "frames_" + os.path.basename(path).split(".")[0])
    os.makedirs(out_dir, exist_ok=True)
    paths, i = [], 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % step == 0:
            p = os.path.join(out_dir, f"frame_{i:06d}.png")
            cv2.imwrite(p, frame)
            paths.append(p)
        i += 1
    cap.release()
    return paths


def load_inputs(path: str, fps: float = 1.0, target_size: int = 518,
                strategy: str = "crop") -> np.ndarray:
    """Directory of images, a video file sampled at `fps`, or a .npy image
    stack -> (1, S, H, W, 3)."""
    if os.path.isfile(path) and path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 4:
            arr = arr[None]
        if arr.ndim != 5 or arr.shape[0] != 1 or arr.shape[-1] != 3:
            raise ValueError(f"{path}: expected (S, H, W, 3) or (1, S, H, W, 3), "
                             f"got {arr.shape}")
        return arr
    if is_video(path):
        return prepare_images(sorted(video_to_frames(path, fps)), target_size,
                              strategy)
    frame_paths = []
    for ext in IMAGE_EXTS:
        frame_paths.extend(glob.glob(os.path.join(path, ext)))
    return prepare_images(sorted(set(frame_paths)), target_size, strategy)


def crop_with_intrinsics(image: np.ndarray, K: np.ndarray,
                         crop_box) -> Tuple[np.ndarray, np.ndarray]:
    """Crop (y0, x0, y1, x1) and shift the principal point accordingly."""
    y0, x0, y1, x1 = crop_box
    out = image[y0:y1, x0:x1]
    K2 = np.array(K, np.float64).copy()
    K2[0, 2] -= x0
    K2[1, 2] -= y0
    return out, K2.astype(K.dtype if hasattr(K, "dtype") else np.float32)


def rescale_with_intrinsics(image: np.ndarray, K: np.ndarray,
                            new_hw) -> Tuple[np.ndarray, np.ndarray]:
    """Resize to (H', W') (area when shrinking, cubic when growing) and
    scale the focal lengths and principal point."""
    import cv2

    H, W = image.shape[:2]
    nh, nw = new_hw
    out = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_AREA
                     if nw < W else cv2.INTER_CUBIC)
    K2 = np.array(K, np.float64).copy()
    K2[0] *= nw / W
    K2[1] *= nh / H
    return out, K2.astype(np.float32)
