"""The eval twin (`python -m hunyuanworld_mirror_tpu_torch.eval`) against
the JAX package's tools/eval.py, each mode on the same files, on the CPU:
the same JSON keys, counts equal, values within 1e-5 relative (the camera
metrics, host f64 on both sides, within 1e-12; PSNR within 1e-4 dB).
"""

import importlib.util
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hunyuanworld_mirror_tpu_torch import eval as peval
from hunyuanworld_mirror_tpu_torch.io import ply as pply
from hunyuanworld_mirror_tpu_torch.utils import lpips as plpips
from hunyuanworld_mirror_tpu_torch import convert

REPO = Path(__file__).resolve().parents[1]


def _jax_tool():
    name = "wm_jax_eval_tool"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REPO / "tools" / "eval.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _both(argv, monkeypatch, capsys):
    """(JAX tool's dict, the twin's dict) for the same arguments."""
    monkeypatch.setattr(sys, "argv", ["eval.py", *argv])
    _jax_tool().main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = peval.main(argv, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ours
    assert set(ours) == set(ref)
    return ref, ours


def _close(ours, ref, rtol):
    for k, v in ref.items():
        if isinstance(v, int):
            assert ours[k] == v, k
        else:
            np.testing.assert_allclose(ours[k], v, rtol=rtol, err_msg=k)


def test_points_npy_and_ply(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(700, 3)).astype(np.float32)
    gt = (pred + rng.normal(size=pred.shape) * 0.05).astype(np.float32)
    np.save(tmp_path / "pred.npy", pred)
    np.save(tmp_path / "gt.npy", gt)
    pply.save_points_ply(tmp_path / "pred.ply", pred, np.full_like(pred, 0.5),
                         np.ones(len(pred), bool))
    for argv in (["points", "--pred", str(tmp_path / "pred.npy"), "--gt",
                  str(tmp_path / "gt.npy")],
                 ["points", "--pred", str(tmp_path / "pred.ply"), "--gt",
                  str(tmp_path / "gt.npy"), "--align", "--median", "--max-points", "500"]):
        ref, ours = _both(argv, monkeypatch, capsys)
        assert ours["n_pred"] == ours["n_gt"] == 700
        _close(ours, ref, 1e-5)


def _poses(seed, n):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.normal(size=3)
    return out


@pytest.mark.parametrize("keyframe", [1, 2])
def test_cameras_npz_and_npy(tmp_path, monkeypatch, capsys, keyframe):
    np.savez(tmp_path / "pred.npz", c2w=_poses(1, 9))
    np.savez(tmp_path / "gt.npz", camera_poses=_poses(2, 8))
    np.save(tmp_path / "gt.npy", _poses(2, 8))
    for gt in ("gt.npz", "gt.npy"):
        ref, ours = _both(["cameras", "--pred", str(tmp_path / "pred.npz"), "--gt",
                           str(tmp_path / gt), "--keyframe", str(keyframe)],
                          monkeypatch, capsys)
        assert ours["n_frames"] == len(range(0, 8, keyframe))
        _close(ours, ref, 1e-12)
    np.savez(tmp_path / "bad.npz", other=_poses(3, 2))
    with pytest.raises(KeyError, match="no camera key"):
        peval.main(["cameras", "--pred", str(tmp_path / "bad.npz"), "--gt",
                    str(tmp_path / "gt.npz")], device="cpu")


def _image_dirs(tmp_path):
    rng = np.random.default_rng(3)
    for name in ("pred", "gt"):
        (tmp_path / name).mkdir()
    for i in range(4):
        a = (rng.uniform(size=(48, 40, 3)) * 255).astype(np.uint8)
        b = np.clip(a.astype(np.int32) + rng.integers(-20, 21, a.shape), 0, 255)
        cv2.imwrite(str(tmp_path / "gt" / f"{i:03d}.png"), a)
        cv2.imwrite(str(tmp_path / "pred" / f"{i:03d}.png"), b.astype(np.uint8))
    (tmp_path / "pred" / "notes.txt").write_text("not an image")
    return ["nvs", "--pred", str(tmp_path / "pred"), "--gt", str(tmp_path / "gt")]


@pytest.mark.parametrize("weights", [False, True])
def test_nvs_dirs(tmp_path, monkeypatch, capsys, weights):
    """PNG directories; with $WM_LPIPS_WEIGHTS naming converted weights
    both add the same "lpips"."""
    argv = _image_dirs(tmp_path)
    if weights:
        net = plpips.init_random(torch.Generator().manual_seed(0))
        from hunyuanworld_mirror_tpu.training import checkpoint as jckpt
        jckpt.save_params(str(tmp_path / "lpips.npz"), convert.lpips_to_jax_params(net))
        monkeypatch.setenv("WM_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    else:
        monkeypatch.delenv("WM_LPIPS_WEIGHTS", raising=False)
    ref, ours = _both(argv + ["--keyframe", "2"], monkeypatch, capsys)
    assert ours["n_frames"] == 2 and ("lpips" in ours) == weights
    np.testing.assert_allclose(ours["psnr"], ref["psnr"], atol=1e-4)
    _close({k: v for k, v in ours.items() if k != "psnr"},
           {k: v for k, v in ref.items() if k != "psnr"}, 1e-5)


def test_images_read_by_pil_without_cv2(tmp_path, monkeypatch):
    """Where cv2 is absent PIL decodes the same pixels; a file neither can
    decode raises instead of being skipped."""
    _image_dirs(tmp_path)
    with_cv2 = peval._load_image_dir(str(tmp_path / "pred"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(peval._load_image_dir(str(tmp_path / "pred")), with_cv2)
    (tmp_path / "pred" / "zz.png").write_bytes(b"no image")
    with pytest.raises(Exception, match="zz.png"):
        peval._load_image_dir(str(tmp_path / "pred"))
    monkeypatch.delitem(sys.modules, "cv2")
    with pytest.raises(ValueError, match="zz.png"):
        peval._load_image_dir(str(tmp_path / "pred"))


def test_needs_a_gpu_unless_told(tmp_path, monkeypatch):
    np.save(tmp_path / "p.npy", np.zeros((4, 3), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.main(["points", "--pred", str(tmp_path / "p.npy"), "--gt",
                    str(tmp_path / "p.npy")])
    with pytest.raises(SystemExit):
        peval.main(["volumes", "--pred", "a", "--gt", "b"], device="cpu")
