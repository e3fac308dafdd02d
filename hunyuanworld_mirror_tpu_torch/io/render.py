"""Novel-view trajectory rendering and video export.

Port of hunyuanworld_mirror_tpu/io/render.py: a slerp-interpolated camera
path through the predicted views (15 steps a pair; a small circular wobble
when there is one view), the splats rasterized along it in chunks of
cameras through the port's `rasterize` (kernel K2 on the flat route, K4 on
impl="jax"), optionally animated per frame by io/effects.py, the depth
shown through the turbo colour map under the RGB, and an mp4 at 30 fps
written by cv2 (imported only where a video is written).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import rasterizer
from ..utils import camera as cam_utils
from ..utils import rotation as rot_utils

SPLAT_KEYS = ("means", "quats", "scales", "opacities", "sh")


def slerp(q0: np.ndarray, q1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spherical interpolation between XYZW quaternions; t (T,) -> (T, 4)."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        out = q0[None] + t[:, None] * (q1 - q0)[None]
        return out / np.linalg.norm(out, axis=-1, keepdims=True)
    theta = np.arccos(np.clip(dot, -1, 1))
    s0 = np.sin((1 - t) * theta) / np.sin(theta)
    s1 = np.sin(t * theta) / np.sin(theta)
    return s0[:, None] * q0[None] + s1[:, None] * q1[None]


def interpolate_trajectory(c2w: np.ndarray, Ks: np.ndarray,
                           steps_per_pair: int = 15) -> Tuple[np.ndarray, np.ndarray]:
    """A smooth camera path through the views: c2w (S, 4, 4), Ks (S, 3, 3)
    -> (T, 4, 4) camera-to-world poses and (T, 3, 3) intrinsics, T =
    steps_per_pair (S - 1) + 1 (the wobble's 60 frames when S = 1)."""
    c2w, Ks = np.asarray(c2w), np.asarray(Ks)
    S = len(c2w)
    if S == 1:
        return wobble_trajectory(c2w[0], Ks[0])

    quats = rot_utils.rotmat_to_quat(
        torch.as_tensor(c2w[:, :3, :3], dtype=torch.float32)).numpy()
    out_poses, out_Ks = [], []
    for i in range(S - 1):
        t = np.linspace(0, 1, steps_per_pair, endpoint=False)
        qs = slerp(quats[i], quats[i + 1], t)
        trans = (1 - t)[:, None] * c2w[i, :3, 3][None] + t[:, None] * c2w[i + 1, :3, 3][None]
        Rm = rot_utils.quat_to_rotmat(torch.as_tensor(qs, dtype=torch.float32)).numpy()
        for k in range(steps_per_pair):
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = Rm[k]
            m[:3, 3] = trans[k]
            out_poses.append(m)
            out_Ks.append((1 - t[k]) * Ks[i] + t[k] * Ks[i + 1])
    out_poses.append(c2w[-1].astype(np.float32))
    out_Ks.append(Ks[-1])
    return np.stack(out_poses), np.stack(out_Ks).astype(np.float32)


def wobble_trajectory(c2w: np.ndarray, K: np.ndarray, n_frames: int = 60,
                      radius: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """A small circular orbit around one camera."""
    angles = np.linspace(0, 2 * np.pi, n_frames)
    poses = []
    for a in angles:
        m = c2w.copy().astype(np.float32)
        offset = c2w[:3, :3] @ np.array([np.cos(a), np.sin(a), 0.0]) * radius
        m[:3, 3] = c2w[:3, 3] + offset
        poses.append(m)
    return np.stack(poses), np.tile(K[None], (n_frames, 1, 1)).astype(np.float32)


def render_trajectory(splats: Dict, c2w_traj: np.ndarray, Ks_traj: np.ndarray,
                      width: int, height: int, chunk: int = 40,
                      impl: str = "pallas", max_per_tile: int = 4096,
                      device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize one scene's splats (means, quats WXYZ, scales, opacities,
    SH (N, K, 3); tensors or arrays) along a trajectory, `chunk` cameras a
    `rasterize` call, on `device` (CUDA unless named) -> RGB (T, H, W, 3)
    and expected depth (T, H, W), numpy."""
    frames, depths = [], []
    for i in range(0, len(c2w_traj), chunk):
        c2w = torch.as_tensor(np.asarray(c2w_traj[i:i + chunk]), dtype=torch.float32)
        out, _, _ = rasterizer.rasterize(
            splats["means"], splats["quats"], splats["scales"],
            splats["opacities"], splats["sh"], cam_utils.se3_inverse(c2w),
            np.asarray(Ks_traj[i:i + chunk]), width, height, impl=impl,
            quat_order="wxyz", max_per_tile=max_per_tile, device=device)
        out = out.cpu().numpy()
        frames.append(out[..., :3])
        depths.append(out[..., 3])
    return np.concatenate(frames), np.concatenate(depths)


def turbo_colormap(x: np.ndarray) -> np.ndarray:
    """Normalized scalar map -> turbo RGB (polynomial approximation)."""
    x = np.clip(x, 0, 1)
    # Google's turbo polynomial approximation coefficients
    r = np.clip(0.13572138 + x * (4.61539260 + x * (-42.66032258 + x * (132.13108234 + x * (-152.94239396 + x * 59.28637943)))), 0, 1)
    g = np.clip(0.09140261 + x * (2.19418839 + x * (4.84296658 + x * (-14.18503333 + x * (4.27729857 + x * 2.82956604)))), 0, 1)
    b = np.clip(0.10667330 + x * (12.64194608 + x * (-60.58204836 + x * (110.36276771 + x * (-89.90310912 + x * 27.34824973)))), 0, 1)
    return np.stack([r, g, b], axis=-1)


def require_cv2(what: str) -> None:
    """Exit with a message naming `what` unless cv2 imports."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"{what} needs OpenCV (the cv2 module), which is not "
                         "installed") from e


def save_video(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """(T, H, W, 3) float [0, 1] -> mp4 (mp4v) via cv2."""
    import cv2
    T, H, W, _ = frames.shape
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for f in frames:
        bgr = cv2.cvtColor((np.clip(f, 0, 1) * 255).astype(np.uint8),
                           cv2.COLOR_RGB2BGR)
        vw.write(bgr)
    vw.release()
    return str(path)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def render_interpolated_video(predictions: Dict, width: int, height: int,
                              out_path: str, batch_index: int = 0,
                              steps_per_pair: int = 15, fps: int = 30,
                              impl: str = "pallas", effect: Optional[str] = None,
                              device=None) -> str:
    """Predicted splats and cameras -> a novel-view mp4 along the
    interpolated trajectory, RGB above the turbo-mapped depth.

    `effect` ("twister" | "rain" | "spread") animates the splats over the
    trajectory (io/effects.py, one numpy pass and one render a frame, the
    effect's time 10 i / (T - 1)). `impl` is rasterize's route; the default
    is the flat route (the JAX function defaults to "jax", which its CLI
    overrides with --rasterizer, "pallas" by default)."""
    c2w = _np(predictions["camera_poses"][batch_index])
    Ks = _np(predictions["camera_intrs"][batch_index])
    splats = {k: v[batch_index] for k, v in predictions["splats"].items()
              if k in SPLAT_KEYS}

    traj, traj_K = interpolate_trajectory(c2w, Ks, steps_per_pair)
    if effect:
        from . import effects as fx
        splats = {k: _np(v) for k, v in splats.items()}
        n = len(traj)
        frames_l, depths_l = [], []
        rng = np.random.default_rng(0)
        for i in range(n):
            t = 10.0 * i / max(n - 1, 1)
            sp = fx.apply_effect(splats, t, effect, rng)
            f, d = render_trajectory(sp, traj[i:i + 1], traj_K[i:i + 1],
                                     width, height, impl=impl, device=device)
            frames_l.append(f[0])
            depths_l.append(d[0])
        frames, depths = np.stack(frames_l), np.stack(depths_l)
    else:
        frames, depths = render_trajectory(splats, traj, traj_K, width, height,
                                           impl=impl, device=device)

    d = depths - depths.min()
    d = d / (d.max() + 1e-9)
    panel = np.concatenate([frames, turbo_colormap(d)], axis=1)
    return save_video(out_path, panel, fps)
