"""Native COLMAP binary-format writer and readers (numpy; torch for the
rotations).

A copy of hunyuanworld_mirror_tpu/io/colmap.py (the port imports nothing
of the JAX package), writing the same bytes; the rotations go through the
port's utils/rotation.rotmat_to_quat on an f32 CPU tensor, as the JAX
package computes them in f32. Produces `cameras.bin` / `images.bin` /
`points3D.bin` readable by COLMAP and downstream 3DGS trainers. Semantic parity with the reference's pycolmap
reconstruction (reference src/utils/build_pycolmap_recon.py:54-116 +
infer.py:269-360): SIMPLE_PINHOLE (focal = (fx+fy)/2, principal point from K),
world-to-camera poses, per-frame 2D observations with 2D<->3D track stubs.

Binary layout follows COLMAP's scripts/python/read_write_model.py conventions:
  cameras.bin:  u64 n; per cam: i32 id, i32 model_id, u64 w, u64 h, f64 params
  images.bin:   u64 n; per img: i32 id, 4xf64 qvec(wxyz), 3xf64 tvec, i32 cam,
                name\\0, u64 n_pts2d, (f64 x, f64 y, i64 p3d_id)*
  points3D.bin: u64 n; per pt: u64 id, 3xf64 xyz, 3xu8 rgb, f64 err,
                u64 track_len, (i32 image_id, i32 p2d_idx)*
"""

import os
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import rotation as rot_utils

CAMERA_MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2}
CAMERA_MODEL_NPARAMS = {"SIMPLE_PINHOLE": 3, "PINHOLE": 4, "SIMPLE_RADIAL": 4}


def _rotmat_to_qvec_wxyz(R: np.ndarray) -> np.ndarray:
    q_xyzw = rot_utils.rotmat_to_quat(torch.as_tensor(np.asarray(R, np.float32)[None]))[0].numpy()
    return np.array([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]])


def write_cameras_bin(path: str, cameras: List[Dict]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras:
            mid = CAMERA_MODEL_IDS[cam["model"]]
            f.write(struct.pack("<iiQQ", cam["camera_id"], mid,
                                cam["width"], cam["height"]))
            f.write(struct.pack(f"<{len(cam['params'])}d", *cam["params"]))


def write_images_bin(path: str, images: List[Dict]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i", im["image_id"]))
            f.write(struct.pack("<4d", *im["qvec"]))
            f.write(struct.pack("<3d", *im["tvec"]))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(im["name"].encode() + b"\x00")
            xys = im.get("xys", np.zeros((0, 2)))
            p3d = im.get("point3D_ids", np.zeros((0,), np.int64))
            f.write(struct.pack("<Q", len(xys)))
            for (x, y), pid in zip(xys, p3d):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))


def write_points3d_bin(path: str, points: List[Dict]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points:
            f.write(struct.pack("<Q", pt["id"]))
            f.write(struct.pack("<3d", *pt["xyz"]))
            f.write(struct.pack("<3B", *pt["rgb"]))
            f.write(struct.pack("<d", pt.get("error", 0.0)))
            track = pt.get("track", [])
            f.write(struct.pack("<Q", len(track)))
            for image_id, p2d_idx in track:
                f.write(struct.pack("<ii", image_id, p2d_idx))


def export_reconstruction(
    out_dir: str,
    points: np.ndarray,          # (N, 3) world points
    pixel_coords: np.ndarray,    # (N, 3) [x, y, frame_idx]
    point_colors: np.ndarray,    # (N, 3) uint8
    poses_w2c: np.ndarray,       # (S, 4, 4) or (S, 3, 4) world->cam
    intrinsics: np.ndarray,      # (S, 3, 3)
    image_size,                  # (W, H)
    camera_model: str = "SIMPLE_PINHOLE",
    shared_camera: bool = False,
) -> str:
    """Write a COLMAP sparse model from predicted geometry."""
    os.makedirs(out_dir, exist_ok=True)
    W, H = int(image_size[0]), int(image_size[1])
    S = len(poses_w2c)
    N = len(points)

    cameras = []
    for i in range(S):
        if shared_camera and i > 0:
            break
        K = intrinsics[i]
        if camera_model == "SIMPLE_PINHOLE":
            params = [(K[0, 0] + K[1, 1]) / 2.0, K[0, 2], K[1, 2]]
        elif camera_model == "PINHOLE":
            params = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
        else:
            raise ValueError(camera_model)
        cameras.append({"camera_id": i + 1, "model": camera_model,
                        "width": W, "height": H, "params": params})

    # point3D id = index + 1; build tracks as we scan frames
    tracks = [[] for _ in range(N)]
    frame_of_pt = pixel_coords[:, 2].astype(np.int64)

    images = []
    for i in range(S):
        sel = np.nonzero(frame_of_pt == i)[0]
        xys = pixel_coords[sel, :2]
        p3d_ids = sel + 1
        for local_idx, pt_idx in enumerate(sel):
            tracks[pt_idx].append((i + 1, local_idx))
        R = poses_w2c[i][:3, :3]
        t = poses_w2c[i][:3, 3]
        images.append({
            "image_id": i + 1,
            "qvec": _rotmat_to_qvec_wxyz(R),
            "tvec": t,
            "camera_id": 1 if shared_camera else i + 1,
            "name": f"frame_{i + 1}",
            "xys": xys,
            "point3D_ids": p3d_ids,
        })

    pts = [{"id": i + 1, "xyz": points[i], "rgb": point_colors[i].astype(np.uint8),
            "error": 0.0, "track": tracks[i]} for i in range(N)]

    write_cameras_bin(os.path.join(out_dir, "cameras.bin"), cameras)
    write_images_bin(os.path.join(out_dir, "images.bin"), images)
    write_points3d_bin(os.path.join(out_dir, "points3D.bin"), pts)
    return out_dir


# ---------------------------------------------------------------------------
# Readers (round-trip validation + ingestion for the splat post-optimizer)
# ---------------------------------------------------------------------------

def read_cameras_bin(path: str) -> Dict[int, Dict]:
    out = {}
    inv_ids = {v: k for k, v in CAMERA_MODEL_IDS.items()}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            model = inv_ids[mid]
            np_ = CAMERA_MODEL_NPARAMS[model]
            params = struct.unpack(f"<{np_}d", f.read(8 * np_))
            out[cid] = {"camera_id": cid, "model": model, "width": w,
                        "height": h, "params": list(params)}
    return out


def read_images_bin(path: str) -> Dict[int, Dict]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = struct.unpack("<4d", f.read(32))
            tvec = struct.unpack("<3d", f.read(24))
            cid = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            xys = np.zeros((n2d, 2))
            p3d = np.zeros((n2d,), np.int64)
            for k in range(n2d):
                x, y, pid = struct.unpack("<ddq", f.read(24))
                xys[k] = (x, y)
                p3d[k] = pid
            out[iid] = {"image_id": iid, "qvec": np.array(qvec),
                        "tvec": np.array(tvec), "camera_id": cid,
                        "name": name.decode(), "xys": xys, "point3D_ids": p3d}
    return out


def read_points3d_bin(path: str) -> Dict[int, Dict]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = struct.unpack("<3d", f.read(24))
            rgb = struct.unpack("<3B", f.read(3))
            err = struct.unpack("<d", f.read(8))[0]
            tl = struct.unpack("<Q", f.read(8))[0]
            track = [struct.unpack("<ii", f.read(8)) for _ in range(tl)]
            out[pid] = {"id": pid, "xyz": np.array(xyz), "rgb": np.array(rgb),
                        "error": err, "track": track}
    return out
