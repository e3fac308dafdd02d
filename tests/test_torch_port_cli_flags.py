"""The CLI twin's remaining flags on the CPU at the tiny preset: every new
flag at once on a .npy stack writes scene.glb, rendered.mp4 and the
exports, and its scene.glb is byte for byte what the JAX package's
predictions_to_glb writes from the port's own (BA-refined) predictions;
--fast-binning builds the default's config and renders its bits (the port
always bins exactly); --rasterizer jax with --video on an mp4 input sampled
at --fps renders through the dense-bin route; --help lists every flag of
the JAX CLI."""

import os
import subprocess
import sys

import cv2
import numpy as np

from test_torch_port_video import _frame_count, _write_video
from torch_port_helpers import np_, uniform
from hunyuanworld_mirror_tpu.io import scene as jscene
from hunyuanworld_mirror_tpu_torch import infer
from hunyuanworld_mirror_tpu_torch.models import worldmirror as pwm
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as pbin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FLAGS = ("--output", "--ckpt", "--fps", "--size", "--mode", "--cond", "--no-gs",
             "--preset", "--conf-percent", "--rasterizer", "--fast-binning", "--video",
             "--ba", "--ba-iters", "--glb", "--glb-mesh", "--mask-sky", "--effect")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_every_new_flag(tmp_path, monkeypatch, capsys):
    np.save(tmp_path / "views.npy", uniform(31, (2, 56, 56, 3)))
    seen = {}
    to_glb = infer.scene_lib.predictions_to_glb

    def spy(preds, path, **kw):
        seen.update(preds=preds, kw=kw)
        return to_glb(preds, path, **kw)

    monkeypatch.setattr(infer.scene_lib, "predictions_to_glb", spy)
    out = tmp_path / "out"
    infer.main([str(tmp_path / "views.npy"), "-o", str(out), "--preset", "tiny",
                "--size", "56", "--glb", "--glb-mesh", "--mask-sky", "--ba",
                "--ba-iters", "3", "--fast-binning", "--video", "--effect", "rain"],
               device="cpu")
    names = set(_files(out))
    assert {"scene.glb", "rendered.mp4", "points.ply", "camera_params.json",
            "depth_000.png", "depth_001.npy", "normal_001.png", "gaussians.ply",
            "gaussians.splat", "sparse/cameras.bin", "sparse/images.bin",
            "sparse/points3D.bin"} <= names
    assert _frame_count(str(out / "rendered.mp4")) == 16
    printed = capsys.readouterr().out
    assert "BA refinement: cost" in printed and "wrote GLB scene" in printed
    assert "wrote novel-view video" in printed and printed.rstrip().endswith("Done.")

    preds = seen["preds"]
    assert seen["kw"] == dict(conf_percent=20.0, mask_sky=True, as_mesh=True)
    ref = {k: np_(v) if not isinstance(v, np.ndarray) else v
           for k, v in preds.items() if k != "splats"}
    jscene.predictions_to_glb(ref, str(tmp_path / "jax.glb"), **seen["kw"])
    assert (out / "scene.glb").read_bytes() == (tmp_path / "jax.glb").read_bytes()
    glb = (out / "scene.glb").read_bytes()
    assert glb[:4] == b"glTF" and int.from_bytes(glb[8:12], "little") == len(glb)


def test_cli_fast_binning_renders_the_default(tmp_path, monkeypatch):
    """--fast-binning binds nothing: the same WorldMirrorConfig and the same
    render, bit for bit, as the default flags."""
    np.save(tmp_path / "views.npy", uniform(32, (2, 56, 56, 3)))
    runs = []
    forward = pwm.WorldMirror.forward

    def spy(self, views, **kw):
        preds = forward(self, views, **kw)
        runs.append((self.cfg, {k: np_(preds[k]) for k in (
            "rendered_colors", "rendered_alphas", "render_n_isects", "render_n_dropped")}))
        return preds

    monkeypatch.setattr(pwm.WorldMirror, "forward", spy)
    for name, extra in (("default", []), ("fast", ["--fast-binning"])):
        infer.main([str(tmp_path / "views.npy"), "-o", str(tmp_path / name),
                    "--preset", "tiny", "--size", "56"] + extra, device="cpu")
    (cfg, ref), (cfg_fast, got) = runs
    assert cfg_fast == cfg
    assert float(ref["rendered_alphas"].max()) > 0
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].view(np.uint8), v.view(np.uint8), err_msg=k)


def test_cli_jax_route_video_input(tmp_path, monkeypatch):
    clip = tmp_path / "clip.mp4"
    _write_video(clip, n=6, fps=6)
    seen, calls = {}, []
    forward = pwm.WorldMirror.forward
    apply = pbin.RasterizeBinned.apply

    def spy(self, views, **kw):
        seen.update(impl=self.cfg.rasterizer_impl, shape=tuple(views["img"].shape))
        return forward(self, views, **kw)

    def count(*a):
        calls.append(1)
        return apply(*a)

    monkeypatch.setattr(pwm.WorldMirror, "forward", spy)
    monkeypatch.setattr(pbin.RasterizeBinned, "apply", count)
    out = tmp_path / "out"
    infer.main([str(clip), "-o", str(out), "--preset", "tiny", "--size", "56",
                "--fps", "2", "--rasterizer", "jax", "--video"], device="cpu")
    # 6 frames at 6 fps sampled at 2 fps: frames 0 and 3, 56 x 42 crops
    assert seen == dict(impl="jax", shape=(1, 2, 42, 56, 3))
    # the forward's render (2 cameras) and the 16 video frames, one a call
    assert len(calls) == 2 + 16
    assert _frame_count(str(out / "rendered.mp4")) == 16
    cap = cv2.VideoCapture(str(out / "rendered.mp4"))
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (84, 56, 3)
    assert not (out / "scene.glb").exists()


def test_cli_help_lists_every_flag():
    res = subprocess.run([sys.executable, "-m", "hunyuanworld_mirror_tpu_torch.infer",
                          "--help"], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in JAX_FLAGS:
        assert flag in res.stdout, flag
