"""Port vs JAX on the novel-view video (--video, --effect) and on video
input (--fps): the trajectory (slerp, interpolation, wobble) within 1e-6,
the effects and the turbo colour map equal, render_trajectory against the
JAX one (impl="jax" on the CPU) within 1e-4 for both port routes, the mp4
writer's frame count, render_interpolated_video's 15 (S - 1) + 1 frames
with an effect, and video_to_frames / load_inputs(fps=...) equal to JAX's
on a short mp4 written by cv2."""

import os

import cv2
import numpy as np
import pytest
import torch

from torch_port_helpers import close, normal, uniform
from hunyuanworld_mirror_tpu.io import effects as jfx
from hunyuanworld_mirror_tpu.io import images as jimages
from hunyuanworld_mirror_tpu.io import render as jrender
from hunyuanworld_mirror_tpu_torch.io import effects as pfx
from hunyuanworld_mirror_tpu_torch.io import images as pimages
from hunyuanworld_mirror_tpu_torch.io import render as prender

W, H = 40, 32


def _cameras(S, seed=0):
    """S camera-to-world poses around identity (rotations about y and x,
    small translations) and their intrinsics."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    for s in range(S):
        a, b = 0.2 * s + rng.uniform(-0.05, 0.05), 0.1 * s
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
        c2w[s, :3, :3] = ry @ rx
        c2w[s, :3, 3] = [0.1 * s, -0.05 * s, 0.02 * s]
    K = np.tile(np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32),
                (S, 1, 1))
    K[:, 0, 0] += np.arange(S, dtype=np.float32)
    return c2w, K


def _splats(n=300, seed=1):
    """Activated splats in front of the cameras: quats WXYZ, SH degree 0."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * [0.6, 0.5, 0.3]
    means[:, 2] += 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return {"means": means.astype(np.float32), "quats": quats,
            "scales": rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32),
            "opacities": rng.uniform(0.3, 1.0, n).astype(np.float32),
            "sh": normal(seed + 1, (n, 1, 3))}


def test_slerp_and_trajectories():
    q0, q1 = normal(2, (4,)), normal(3, (4,))
    t = np.linspace(0, 1, 7)
    for a, b in ((q0, q1), (q0, -q1), (q0, q0 + 1e-4)):   # both branches, a flip
        close(prender.slerp(a, b, t), jrender.slerp(a, b, t), 1e-6)
    c2w, K = _cameras(4)
    for steps in (15, 4):
        ours = prender.interpolate_trajectory(c2w, K, steps)
        want = jrender.interpolate_trajectory(c2w, K, steps)
        assert ours[0].shape == (steps * 3 + 1, 4, 4)
        for a, b in zip(ours, want):
            assert a.dtype == b.dtype
            close(a, b, 1e-6)
    for a, b in zip(prender.interpolate_trajectory(c2w[:1], K[:1]),
                    jrender.interpolate_trajectory(c2w[:1], K[:1])):
        close(a, b, 1e-6)


@pytest.mark.parametrize("effect", ["twister", "rain", "spread"])
def test_effects_equal(effect):
    sp = {k: v.reshape(len(v), -1) if k == "sh" else v for k, v in _splats().items()}
    sp["colors"] = uniform(4, (300, 3))
    for t in (0.0, 2.5, 7.0):
        ours = pfx.apply_effect(sp, t, effect, np.random.default_rng(0))
        want = jfx.apply_effect(sp, t, effect, np.random.default_rng(0))
        assert ours.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(ours[k], want[k], err_msg=f"{effect} {k}")
    with pytest.raises(ValueError, match="unknown effect"):
        pfx.apply_effect(sp, 1.0, "smoke")


def test_turbo_colormap_equal():
    x = np.linspace(-0.2, 1.2, 101).reshape(1, 101)
    np.testing.assert_array_equal(prender.turbo_colormap(x), jrender.turbo_colormap(x))


@pytest.mark.parametrize("impl", ["pallas", "jax"])
def test_render_trajectory_matches_jax(impl):
    """Both port routes against the JAX render_trajectory (its "pallas"
    falls back to "jax" off the TPU), chunks of 4 cameras, atol 1e-4."""
    c2w, K = _cameras(3)
    traj, traj_K = prender.interpolate_trajectory(c2w, K, steps_per_pair=3)
    sp = _splats()
    frames, depths = prender.render_trajectory(sp, traj, traj_K, W, H, chunk=4,
                                               impl=impl, device="cpu")
    want_f, want_d = jrender.render_trajectory(sp, traj, traj_K, W, H, chunk=4,
                                               impl="jax")
    assert frames.shape == (7, H, W, 3) and depths.shape == (7, H, W)
    assert float(frames.std()) > 0.01
    close(frames, want_f, 1e-4)
    close(depths, want_d, 1e-4)
    # tensors as input give the same frames
    tens = {k: torch.tensor(v) for k, v in sp.items()}
    again, _ = prender.render_trajectory(tens, traj, traj_K, W, H, chunk=4,
                                         impl=impl, device="cpu")
    np.testing.assert_array_equal(again, frames)


def _frame_count(path):
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def test_save_video_roundtrip(tmp_path):
    frames = uniform(5, (5, 32, 48, 3))
    path = prender.save_video(str(tmp_path / "v.mp4"), frames, fps=10)
    assert os.path.getsize(path) > 0 and _frame_count(path) == 5
    jrender.save_video(str(tmp_path / "j.mp4"), frames, fps=10)
    assert (tmp_path / "v.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()


def test_render_interpolated_video_with_effect(tmp_path):
    """S = 2 views -> 15 (S - 1) + 1 = 16 frames, RGB over depth (2H rows),
    as the JAX function writes from the same predictions."""
    c2w, K = _cameras(2)
    sp = _splats(200)
    preds = {"camera_poses": torch.tensor(c2w)[None], "camera_intrs": torch.tensor(K)[None],
             "splats": {k: torch.tensor(v)[None] for k, v in sp.items()}}
    path = prender.render_interpolated_video(preds, W, H, str(tmp_path / "p.mp4"),
                                             effect="twister", device="cpu")
    assert _frame_count(path) == 16
    cap = cv2.VideoCapture(path)
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (2 * H, W, 3)
    jpreds = {"camera_poses": c2w[None], "camera_intrs": K[None],
              "splats": {k: v[None] for k, v in sp.items()}}
    jrender.render_interpolated_video(jpreds, W, H, str(tmp_path / "j.mp4"),
                                      effect="twister")
    assert _frame_count(str(tmp_path / "j.mp4")) == 16


def _write_video(path, n=10, fps=10):
    rng = np.random.default_rng(9)
    base = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (64, 48))
    for i in range(n):
        vw.write(np.roll(base, 3 * i, axis=1))
    vw.release()


def test_video_input_matches_jax(tmp_path):
    """video_to_frames at 5 fps of a 10 fps clip keeps every 2nd frame, the
    same PNGs as JAX's; load_inputs(fps=...) gives JAX's array."""
    clip = tmp_path / "clip.mp4"
    _write_video(clip)
    assert pimages.is_video(str(clip)) and not pimages.is_video(str(tmp_path))
    ours = pimages.video_to_frames(str(clip), 5.0, out_dir=str(tmp_path / "p"))
    want = jimages.video_to_frames(str(clip), 5.0, out_dir=str(tmp_path / "j"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in want]
    assert len(ours) == 5
    for a, b in zip(ours, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    arr = pimages.load_inputs(str(clip), fps=5.0, target_size=56)
    ref = jimages.load_inputs(str(clip), fps=5.0, target_size=56)
    assert arr.shape == ref.shape == (1, 5, 42, 56, 3)
    np.testing.assert_array_equal(arr, ref)
