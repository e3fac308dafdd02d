"""Crop / rescale images with consistent intrinsics updates (host-side numpy).

A copy of hunyuanworld_mirror_tpu/io/cropping.py (the port imports nothing
of the JAX package): the DUSt3R-style rescale-then-crop pipeline of the
reference's ``src/utils/cropping.py:108-387`` (Lanczos downscale / bicubic
upscale for RGB, nearest for depth and label maps, the principal point
tracked through the COLMAP pixel-centre convention) and the intrinsics
convention converters of its ``src/utils/geometry.py``.

Plain numpy + cv2 on (H, W, C) arrays, run on the host before any tensor
reaches the device. The resizes need cv2 and raise ImportError without it.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


Array = np.ndarray


def opencv_to_colmap_intrinsics(K: Array) -> Array:
    """OpenCV pixel centers are (0, 0); COLMAP's are (0.5, 0.5)."""
    K = np.array(K, dtype=np.float64, copy=True)
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def colmap_to_opencv_intrinsics(K: Array) -> Array:
    K = np.array(K, dtype=np.float64, copy=True)
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def _resize_image(image: Array, out_wh: Tuple[int, int], upscale: bool) -> Array:
    if cv2 is None:
        raise ImportError("cv2 required for image resizing")
    interp = cv2.INTER_CUBIC if upscale else cv2.INTER_LANCZOS4
    return cv2.resize(image, tuple(int(v) for v in out_wh), interpolation=interp)


def _resize_nearest(arr: Array, out_wh: Tuple[int, int]) -> Array:
    if cv2 is None:
        raise ImportError("cv2 required for resizing")
    return cv2.resize(arr, tuple(int(v) for v in out_wh),
                      interpolation=cv2.INTER_NEAREST)


def camera_matrix_of_crop(K: Array,
                          input_resolution: Sequence[float],
                          output_resolution: Sequence[float],
                          scaling: float = 1.0,
                          offset_factor: float = 0.5,
                          offset: Optional[Sequence[float]] = None) -> Array:
    """Intrinsics after scaling the image by `scaling` then cropping to
    `output_resolution` with the crop origin at `offset` (default centered).

    Matches reference cropping.py:203-238: the scale and principal-point
    shift are applied in the COLMAP (pixel-center 0.5) convention.
    """
    margins = np.asarray(input_resolution, np.float64) * scaling - \
        np.asarray(output_resolution, np.float64)
    if np.any(margins < 0):
        raise ValueError(f"crop larger than scaled image: margins={margins}")
    if offset is None:
        offset = offset_factor * margins

    Kc = opencv_to_colmap_intrinsics(K)
    Kc[:2, :] *= scaling
    Kc[:2, 2] -= np.asarray(offset, np.float64)
    return colmap_to_opencv_intrinsics(Kc)


def rescale_with_intrinsics(image: Array,
                            output_resolution: Sequence[int],
                            depthmap: Optional[Array] = None,
                            intrinsics: Optional[Array] = None,
                            force: bool = True,
                            nearest_extras: Optional[List[Array]] = None):
    """Scale (image, depth, K, extras) so the image *contains* an
    `output_resolution` (W, H) crop: scale = max(out / in).

    Larger inputs are Lanczos-downscaled, smaller ones bicubic-upscaled
    (skipped entirely when `force` is False and the image is already smaller),
    depth/extras use nearest. Reference cropping.py:108-201.
    """
    in_wh = np.array([image.shape[1], image.shape[0]], np.float64)
    out_wh = np.asarray(output_resolution, np.float64)
    scale = float(np.max(out_wh / in_wh)) + 1e-8
    if scale >= 1.0 and not force:
        return image, depthmap, intrinsics, nearest_extras
    new_wh = np.floor(in_wh * scale).astype(int)

    image = _resize_image(image, new_wh, upscale=scale >= 1.0)
    if depthmap is not None:
        depthmap = _resize_nearest(depthmap, new_wh)
    if nearest_extras is not None:
        nearest_extras = [_resize_nearest(q, new_wh) for q in nearest_extras]
    if intrinsics is not None:
        intrinsics = camera_matrix_of_crop(intrinsics, in_wh, new_wh,
                                           scaling=scale)
    return image, depthmap, intrinsics, nearest_extras


def crop_with_intrinsics(image: Array,
                         crop_bbox: Tuple[int, int, int, int],
                         depthmap: Optional[Array] = None,
                         intrinsics: Optional[Array] = None,
                         extras: Optional[List[Array]] = None):
    """Crop (left, top, right, bottom) out of image/depth/extras and shift the
    principal point. Reference cropping.py:240-281."""
    left, top, right, bottom = crop_bbox
    image = image[top:bottom, left:right]
    if depthmap is not None:
        depthmap = depthmap[top:bottom, left:right]
    if extras is not None:
        extras = [q[top:bottom, left:right] for q in extras]
    if intrinsics is not None:
        intrinsics = np.array(intrinsics, np.float64, copy=True)
        intrinsics[0, 2] -= left
        intrinsics[1, 2] -= top
    return image, depthmap, intrinsics, extras


def bbox_from_intrinsics_in_out(K_in: Array, K_out: Array,
                                output_resolution: Sequence[int]
                                ) -> Tuple[int, int, int, int]:
    """Crop bbox whose top-left aligns the two principal points.
    Reference cropping.py:283-302."""
    out_w, out_h = (int(v) for v in output_resolution)
    left, top = np.int32(np.round(K_in[:2, 2] - K_out[:2, 2]))
    return int(left), int(top), int(left) + out_w, int(top) + out_h


def crop_resize_if_necessary(image: Array,
                             resolution: Sequence[int],
                             depthmap: Optional[Array] = None,
                             intrinsics: Optional[Array] = None,
                             extras: Optional[List[Array]] = None):
    """Lanczos rescale to contain `resolution` (W, H), then center crop, with
    intrinsics tracked throughout. Reference cropping.py:305-387.

    Returns (image, depthmap?, intrinsics?, extras?) — optional outputs are
    included only when the corresponding input was given, matching the
    reference's variadic return.
    """
    image, depthmap, intrinsics, extras = rescale_with_intrinsics(
        image, resolution, depthmap, intrinsics, nearest_extras=extras)

    wh = (image.shape[1], image.shape[0])
    if intrinsics is not None:
        K_new = camera_matrix_of_crop(intrinsics, wh, resolution,
                                      offset_factor=0.5)
        bbox = bbox_from_intrinsics_in_out(intrinsics, K_new, resolution)
    else:
        w, h = wh
        tw, th = (int(v) for v in resolution)
        left, top = (w - tw) // 2, (h - th) // 2
        bbox = (left, top, left + tw, top + th)

    image, depthmap, intrinsics, extras = crop_with_intrinsics(
        image, bbox, depthmap, intrinsics, extras)

    out = (image,)
    if depthmap is not None:
        out += (depthmap,)
    if intrinsics is not None:
        out += (intrinsics,)
    if extras is not None:
        out += (extras,)
    return out
