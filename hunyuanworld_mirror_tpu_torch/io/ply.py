"""Binary-PLY, .splat, PNG, depth and camera exporters of the CLI, and the
PLY reader of the splat trainer (numpy; PIL for the PNGs).

A copy of the writers the CLI uses, and of `read_ply`, from
hunyuanworld_mirror_tpu/io/ply.py
(the port imports nothing of the JAX package), writing the same bytes:
point clouds as x/y/z f4 + red/green/blue u1; 3DGS splats as
x/y/z/nx/ny/nz/f_dc_0..2/opacity (logit)/scale_0..2 (log)/rot_0..3 (wxyz),
all f4, after the 95th-percentile max-scale filter; .splat records of 32
bytes (pos f32 x3, scale f32 x3, rgba u8, rot u8 wxyz), largest first.
"""

import json
import os
from typing import Optional

import numpy as np

SH_C0 = 0.28209479177387814


def _write_ply(path, arrays, names, types):
    """Write a binary_little_endian PLY with one vertex element."""
    n = arrays[0].shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    np_types = {"f4": "<f4", "u1": "u1"}
    ply_types = {"f4": "float", "u1": "uchar"}
    dtype = []
    for name, t in zip(names, types):
        header.append(f"property {ply_types[t]} {name}")
        dtype.append((name, np_types[t]))
    header.append("end_header\n")

    rec = np.empty(n, dtype=dtype)
    for arr, name in zip(arrays, names):
        rec[name] = arr.astype(rec.dtype[name])
    with open(str(path), "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def save_points_ply(path, pts: np.ndarray, colors: np.ndarray,
                    valid_mask: Optional[np.ndarray] = None) -> None:
    """Point cloud -> PLY. pts (N, 3) float, colors (N, 3) uint8 or [0,1] float."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    colors = np.asarray(colors).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)

    if valid_mask is None:
        valid_mask = np.isfinite(pts).all(axis=1)
    else:
        valid_mask = np.asarray(valid_mask).reshape(-1) & np.isfinite(pts).all(axis=1)
    pts, colors = pts[valid_mask], colors[valid_mask]
    if len(pts) == 0:
        pts = np.zeros((1, 3), np.float32)
        colors = np.full((1, 3), 255, np.uint8)

    _write_ply(path,
               [pts[:, 0], pts[:, 1], pts[:, 2],
                colors[:, 0], colors[:, 1], colors[:, 2]],
               ["x", "y", "z", "red", "green", "blue"],
               ["f4", "f4", "f4", "u1", "u1", "u1"])


def save_gs_ply(path, means: np.ndarray, scales: np.ndarray,
                rotations: np.ndarray, sh_dc: np.ndarray,
                opacity_logits: np.ndarray,
                scale_percentile: float = 0.95) -> None:
    """3DGS splats -> standard PLY layout.

    Args:
      means (N,3); scales (N,3) LINEAR; rotations (N,4) wxyz; sh_dc (N,3) SH DC
      coefficients; opacity_logits (N,) pre-sigmoid.
    """
    means = np.asarray(means, np.float32).reshape(-1, 3)
    scales = np.asarray(scales, np.float32).reshape(-1, 3)
    rotations = np.asarray(rotations, np.float32).reshape(-1, 4)
    sh_dc = np.asarray(sh_dc, np.float32).reshape(-1, 3)
    op = np.asarray(opacity_logits, np.float32).reshape(-1)

    smax = scales.max(axis=-1)
    thresh = np.quantile(smax, scale_percentile)
    keep = (smax <= thresh) & np.isfinite(means).all(axis=1)
    means, scales, rotations, sh_dc, op = (
        means[keep], scales[keep], rotations[keep], sh_dc[keep], op[keep])

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    zeros = np.zeros_like(means)
    log_scales = np.log(np.maximum(scales, 1e-12))
    cols = ([means[:, i] for i in range(3)] + [zeros[:, i] for i in range(3)]
            + [sh_dc[:, i] for i in range(3)] + [op]
            + [log_scales[:, i] for i in range(3)]
            + [rotations[:, i] for i in range(4)])
    _write_ply(path, cols, names, ["f4"] * len(names))


def _splat_records(means, scales, rgba8, rot8) -> bytes:
    """(N, 32) .splat records: pos f32 x3 | scale f32 x3 | rgba u8 | rot u8."""
    rec = np.empty((len(means), 32), np.uint8)
    rec[:, 0:12] = np.ascontiguousarray(means, "<f4").view(np.uint8).reshape(-1, 12)
    rec[:, 12:24] = np.ascontiguousarray(scales, "<f4").view(np.uint8).reshape(-1, 12)
    rec[:, 24:28] = rgba8
    rec[:, 28:32] = rot8
    return rec.tobytes()


def save_splat(path, means: np.ndarray, scales: np.ndarray,
               quats_wxyz: np.ndarray, opacities: np.ndarray,
               sh_dc: np.ndarray) -> str:
    """ACTIVATED splats (linear scales, opacities in [0, 1], SH degree-0
    coefficients) -> a .splat file, non-finite splats dropped, sorted by
    scale volume x opacity, largest first."""
    means = np.asarray(means, np.float32).reshape(-1, 3)
    scales = np.asarray(scales, np.float32).reshape(-1, 3)
    quats = np.asarray(quats_wxyz, np.float32).reshape(-1, 4)
    op = np.asarray(opacities, np.float32).reshape(-1)
    sh_dc = np.asarray(sh_dc, np.float32).reshape(-1, 3)
    ok = np.isfinite(means).all(1) & np.isfinite(scales).all(1)
    means, scales, quats, op, sh_dc = (means[ok], scales[ok], quats[ok],
                                       op[ok], sh_dc[ok])
    order = np.argsort(-(scales.prod(axis=-1) * op))
    means, scales, quats, op, sh_dc = (means[order], scales[order],
                                       quats[order], op[order], sh_dc[order])
    quats = quats / np.maximum(
        np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    rgba = np.concatenate([0.5 + SH_C0 * sh_dc, op[:, None]], -1)
    rgba8 = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
    rot8 = np.clip(quats * 128 + 128, 0, 255).astype(np.uint8)
    with open(str(path), "wb") as f:
        f.write(_splat_records(means, scales, rgba8, rot8))
    return str(path)


def gs_ply_to_splat(ply_path, splat_path) -> str:
    """A 3DGS PLY (as save_gs_ply writes it) -> a .splat file, sorted by
    scale volume x opacity, largest first."""
    data = read_ply(ply_path)
    order = np.argsort(
        -np.exp(data["scale_0"] + data["scale_1"] + data["scale_2"])
        / (1 + np.exp(-data["opacity"])))
    pos = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)[order]
    scale = np.exp(np.stack([data[f"scale_{i}"] for i in range(3)], -1)
                   ).astype(np.float32)[order]
    rot = np.stack([data[f"rot_{i}"] for i in range(4)], -1).astype(np.float32)[order]
    color = np.stack([0.5 + SH_C0 * data[f"f_dc_{i}"] for i in range(3)]
                     + [1 / (1 + np.exp(-data["opacity"]))], -1)[order]
    rot = rot / np.linalg.norm(rot, axis=-1, keepdims=True)
    rgba = (color * 255).clip(0, 255).astype(np.uint8)
    rot8 = (rot * 128 + 128).clip(0, 255).astype(np.uint8)
    with open(str(splat_path), "wb") as f:
        f.write(_splat_records(pos, scale, rgba, rot8))
    return str(splat_path)


def save_image_png(path, image: np.ndarray) -> None:
    from PIL import Image
    img = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(img).save(str(path))


def save_depth_png(path, depth: np.ndarray) -> None:
    """A depth map min-max scaled to 8-bit grey."""
    from PIL import Image
    d = np.asarray(depth, np.float32)
    d = d - d.min()
    d = d / (d.max() + 1e-9)
    Image.fromarray((np.clip(d, 0, 1) * 255).astype(np.uint8), mode="L").save(str(path))


def save_normal_png(path, normal_hwc: np.ndarray) -> None:
    """Unit normals in [-1, 1] -> 8-bit RGB."""
    from PIL import Image
    n = (np.asarray(normal_hwc) + 1.0) * 0.5
    Image.fromarray((np.clip(n, 0, 1) * 255).astype(np.uint8)).save(str(path))


def save_depth_npy(path, depth: np.ndarray) -> None:
    np.save(str(path), np.asarray(depth))


def save_camera_params(extrinsics: np.ndarray, intrinsics: np.ndarray,
                       target_dir) -> str:
    data = {"num_cameras": int(extrinsics.shape[0]), "extrinsics": [], "intrinsics": []}
    for i in range(extrinsics.shape[0]):
        data["extrinsics"].append({"camera_id": i, "matrix": extrinsics[i].tolist()})
        data["intrinsics"].append({"camera_id": i, "matrix": intrinsics[i].tolist()})
    path = os.path.join(str(target_dir), "camera_params.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
    return path


def read_ply(path):
    """Minimal binary-little-endian PLY reader -> dict of property arrays."""
    with open(str(path), "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        n = 0
        props = []
        tmap = {b"float": "<f4", b"uchar": "u1", b"double": "<f8", b"int": "<i4"}
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"property"):
                _, t, name = line.split()
                props.append((name.decode(), tmap[t]))
            elif line == b"end_header":
                break
        rec = np.frombuffer(f.read(), dtype=props, count=n)
    return {name: rec[name] for name, _ in props}
