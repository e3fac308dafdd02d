"""The splat trainer twin's inputs and outputs on the CPU: compression
(PNGs and meta.json byte for byte the JAX package's, npz arrays equal,
both decompressors agreeing), TensorBoard events read by both packages'
readers, COLMAP parsing with and without normalisation and the splat
init from points and from gaussians.ply against the JAX functions
(1e-6), the live viewer's endpoints (its page byte for byte the JAX
viewer's), and the CLI's main(): every flag on a COLMAP dataset, the
inference-directory path on --rasterizer jax with --depth-loss and
--video, --help listing every flag of tools/splat_trainer.py, --gs2d
taken like every other flag, --video refused without cv2."""

import importlib.util
import json
import os
import re
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from test_torch_port_video import _frame_count
from torch_port_helpers import close
from hunyuanworld_mirror_tpu.io import compression as jcomp
from hunyuanworld_mirror_tpu.training import colmap_dataset as jcds
from hunyuanworld_mirror_tpu.training import live_viewer as jlive
from hunyuanworld_mirror_tpu.training import tb_writer as jtb
from hunyuanworld_mirror_tpu_torch import splat_trainer
from hunyuanworld_mirror_tpu_torch.io import colmap as pcolmap
from hunyuanworld_mirror_tpu_torch.io import compression as pcomp
from hunyuanworld_mirror_tpu_torch.io import ply as pply
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as pbin
from hunyuanworld_mirror_tpu_torch.training import colmap_dataset as pcds
from hunyuanworld_mirror_tpu_torch.training import live_viewer as plive
from hunyuanworld_mirror_tpu_torch.training import tb_writer as ptb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32


def _jax_cli():
    """tools/splat_trainer.py, the JAX CLI, as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_splat_trainer", os.path.join(REPO, "tools", "splat_trainer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _splats(rng, n, sh_k=1):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    means = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    means[:, 2] += 2.0
    return {"means": means, "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
            "scales": rng.uniform(0.02, 0.08, (n, 3)).astype(np.float32),
            "opacities": rng.uniform(0.3, 0.9, n).astype(np.float32),
            "sh": (rng.normal(size=(n, sh_k, 3)) * 0.3).astype(np.float32)}


def _cameras(S=4):
    c2w = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    c2w[:, 0, 3] = np.linspace(-0.1, 0.1, S)
    c2w[:, 1, 3] = np.linspace(0.05, -0.05, S)
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32),
                (S, 1, 1))
    return c2w, K


def _save_ply(path, sp):
    op = sp["opacities"]
    pply.save_gs_ply(path, sp["means"], sp["scales"], sp["quats"], sp["sh"][:, 0],
                     np.log(op / (1 - op)), scale_percentile=1.0)


def _colmap_dir(root, with_ply=True, S=4, n=60):
    """A COLMAP dataset of S views 32 px wide, written by the port's
    export_reconstruction: sparse/ (a point per splat, seen in one view),
    images/frame_<i> PNGs, gaussians.ply beside them."""
    rng = np.random.default_rng(0)
    sp = _splats(rng, n)
    c2w, K = _cameras(S)
    pix = np.stack([rng.uniform(0, HW, n), rng.uniform(0, HW, n),
                    np.arange(n) % S], -1)
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    pcolmap.export_reconstruction(str(root / "sparse"), sp["means"], pix, cols,
                                  np.linalg.inv(c2w), K, (HW, HW))
    (root / "images").mkdir()
    for i in range(S):
        img = rng.integers(0, 256, (HW, HW, 3)).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"frame_{i + 1}", format="PNG")
    if with_ply:
        _save_ply(root / "gaussians.ply", sp)
    return sp


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_compression_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    sp = _splats(rng, 300, sh_k=4)          # 17 x 17 after the crop, shN k-means
    sp = dict(sp, scales=np.log(sp["scales"]), extra=rng.normal(size=(300, 2)))
    meta_j = jcomp.compress(str(tmp_path / "j"), sp)
    meta_p = pcomp.compress(str(tmp_path / "p"), sp)
    assert meta_p == meta_j and meta_p["count"] == 289
    names = _files(tmp_path / "p")
    assert names == _files(tmp_path / "j")
    for name in names:
        a, b = (tmp_path / d / name for d in ("p", "j"))
        if name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za) == sorted(zb)
            for k in za:
                np.testing.assert_array_equal(za[k], zb[k])
        else:
            assert a.read_bytes() == b.read_bytes(), name
    out_p = pcomp.decompress(str(tmp_path / "p"))
    out_j = jcomp.decompress(str(tmp_path / "j"))
    assert sorted(out_p) == sorted(out_j)
    for k in out_p:
        np.testing.assert_array_equal(out_p[k], out_j[k])


def test_tb_events_read_by_both(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(6, 10, 3)).astype(np.float32)
    for writer, d in ((ptb.TBWriter, "p"), (jtb.TBWriter, "j")):
        w = writer(str(tmp_path / d))
        w.scalars({"a": 0.5}, 1)
        w.scalars({"train/loss": 0.25, "train/num_GS": 1234.0, "skip": "x"}, 2)
        w.image("pair", img, 3)
        w.close()
    want_s = [(1, {"a": 0.5}), (2, {"train/loss": 0.25, "train/num_GS": 1234.0})]
    want_img = (np.clip(img * 255.0, 0, 255)).astype(np.uint8)
    for d in ("p", "j"):
        [path] = [str(p) for p in (tmp_path / d).iterdir()]
        for reader in (ptb, jtb):
            assert reader.read_scalars(path) == want_s
            [(step, tag, back)] = reader.read_images(path)
            assert (step, tag) == (3, "pair")
            np.testing.assert_array_equal(back, want_img)
    assert ptb.png_encode(want_img) == jtb.png_encode(want_img)


@pytest.mark.parametrize("normalize", [False, True])
def test_parse_colmap_matches_jax(tmp_path, normalize):
    _colmap_dir(tmp_path)
    sj = jcds.parse_colmap(str(tmp_path), normalize=normalize)
    sp = pcds.parse_colmap(str(tmp_path), normalize=normalize)
    assert sp.image_names == sj.image_names == [f"frame_{i + 1}" for i in range(4)]
    assert sp.image_paths == sj.image_paths
    for k in ("c2w", "Ks", "sizes", "points", "points_rgb", "transform"):
        close(getattr(sp, k), getattr(sj, k), 1e-6, err_msg=k)
    close(sp.scene_scale, sj.scene_scale, 1e-6)
    ij, Kj = jcds.load_scene_arrays(sj, target_size=24)
    ip, Kp = pcds.load_scene_arrays(sp, target_size=24)
    np.testing.assert_array_equal(ip, ij)
    close(Kp, Kj, 1e-6)


@pytest.mark.parametrize("with_ply", [True, False])
def test_load_colmap_dir_and_point_init_match_jax(tmp_path, capsys, with_ply):
    """The splats from gaussians.ply moved by the normalisation, or from the
    COLMAP points (3-NN scales, SH DC from the colours)."""
    _colmap_dir(tmp_path, with_ply=with_ply)
    out_j = _jax_cli().load_colmap_dir(str(tmp_path), HW, True)
    printed_j = capsys.readouterr().out
    lines = []
    out_p = splat_trainer.load_colmap_dir(str(tmp_path), HW, True, log_fn=lines.append)
    assert "\n".join(lines) + "\n" == printed_j
    for k in out_j[0]:
        close(out_p[0][k], out_j[0][k], 1e-6, rtol=1e-6, err_msg=k)
    for a, b in zip(out_p[1:4], out_j[1:4]):
        close(a, b, 1e-6)
    assert out_p[4] is out_j[4] is None


def test_live_viewer_endpoints(tmp_path):
    """Both viewers serve the same page; the port's serves its snapshot,
    its status, and 404 elsewhere."""
    pv = plive.LiveViewer(str(tmp_path / "p"))
    jv = jlive.LiveViewer(str(tmp_path / "j"))
    try:
        def get(v, path):
            return urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}",
                                          timeout=10).read()

        page = get(pv, "/")
        assert page == get(jv, "/") == get(pv, "/viewer?run=live")
        assert b'PARAMS.get("mode") || "live"' in page
        assert pv.url == f"http://127.0.0.1:{pv.port}/viewer?run=live"
        status = json.loads(get(pv, "/out/live/live_status.json"))
        assert status == {"version": 0, "step": 0, "loss": None, "num_gs": 0}
        sp = _splats(np.random.default_rng(3), 20)
        pv.update(sp, 7, 0.5)
        status = json.loads(get(pv, "/out/live/live_status.json"))
        assert status == {"version": 1, "step": 7, "loss": 0.5, "num_gs": 20}
        pply.save_splat(tmp_path / "ref.splat", sp["means"], sp["scales"],
                        sp["quats"], sp["opacities"], sp["sh"][:, 0])
        assert get(pv, "/out/any/live.splat") == (tmp_path / "ref.splat").read_bytes()
        for path in ("/out/x/gaussians.ply", "/nope"):
            with pytest.raises(urllib.error.HTTPError):
                get(pv, path)
    finally:
        pv.close()
        jv.close()


def test_cli_colmap_every_flag(tmp_path, capsys):
    """--colmap --normalize with every option of the twin at once."""
    _colmap_dir(tmp_path / "data")
    tb = tmp_path / "tb"
    out = splat_trainer.main(
        ["--colmap", str(tmp_path / "data"), "--normalize", "--iters", "4",
         "--size", str(HW), "--max-per-tile", "512", "--strategy", "mcmc",
         "--selective-adam", "--pose-opt", "--random-bkgd", "--bilateral-grid",
         "--test-every", "2", "--eval-every", "2", "--tb", str(tb), "--compress",
         "--viewer", "--video"], device="cpu")
    d = tmp_path / "data"
    names = set(_files(d))
    assert {"gaussians_opt.ply", "cameras_opt.npz", "compressed/meta.json",
            "optimized.mp4", "live/live.splat", "live/live_status.json"} <= names
    assert len(pply.read_ply(d / "gaussians_opt.ply")["x"]) == len(out["means"])
    cams = np.load(d / "cameras_opt.npz")
    assert cams["c2w"].shape == (2, 4, 4) and np.isfinite(cams["c2w"]).all()
    assert _frame_count(str(d / "optimized.mp4")) == 46
    [events] = [str(p) for p in tb.iterdir()]
    assert [s for s, v in ptb.read_scalars(events) if "eval/psnr" in v] == [2, 4]
    assert out["eval_history"].shape == (2, 3)
    printed = capsys.readouterr().out.splitlines()
    want = ["COLMAP scene: 4 images, 60 points, scene_scale ", "init from ",
            "live viewer: http://127.0.0.1:", "splat-opt eval @2: PSNR ",
            "splat-opt eval @4: PSNR ", "optimized: ",
            "eval on 2 held-out views: PSNR ", f"wrote {d}/gaussians_opt.ply",
            f"wrote {d}/cameras_opt.npz (pose-optimized cameras)",
            f"wrote {d}/compressed: ", f"wrote {d}/optimized.mp4"]
    at = [next((i for i, line in enumerate(printed) if line.startswith(w)), -1)
          for w in want]
    assert -1 not in at and at == sorted(at), printed


def test_cli_infer_dir_jax_route(tmp_path, monkeypatch):
    """An inference directory on --rasterizer jax with --depth-loss and
    --video: every render goes through the dense-bin route."""
    rng = np.random.default_rng(4)
    sp = _splats(rng, 50)
    c2w, K = _cameras(2)
    d = tmp_path / "infer"
    d.mkdir()
    _save_ply(d / "gaussians.ply", sp)
    pply.save_camera_params(c2w, K, d)
    for s in range(2):
        pply.save_depth_npy(d / f"depth_{s:03d}.npy",
                            rng.uniform(1.5, 2.5, (HW, HW)).astype(np.float32))
    np.save(tmp_path / "images.npy", rng.uniform(size=(2, HW, HW, 3)).astype(np.float32))
    calls = {"binned": 0, "flat": 0}
    binned, flat = pbin.RasterizeBinned.apply, prast.RasterizeFlat.apply

    def count(name, fn):
        def f(*a):
            calls[name] += 1
            return fn(*a)
        return f

    monkeypatch.setattr(pbin.RasterizeBinned, "apply", count("binned", binned))
    monkeypatch.setattr(prast.RasterizeFlat, "apply", count("flat", flat))
    out = splat_trainer.main([str(d), str(tmp_path / "images.npy"), "--iters", "2",
                              "--size", str(HW), "--max-per-tile", "512",
                              "--rasterizer", "jax", "--depth-loss", "--video"],
                             device="cpu")
    assert calls == {"binned": 2 * 2 + 16, "flat": 0}   # 2 steps x 2 views, 16 frames
    assert _frame_count(str(d / "optimized.mp4")) == 16
    assert len(pply.read_ply(d / "gaussians_opt.ply")["x"]) == len(out["means"]) == 50


def test_cli_flags_gs2d_and_cv2(tmp_path, monkeypatch, capsys):
    src = open(os.path.join(REPO, "tools", "splat_trainer.py")).read()
    jax_flags = re.findall(r'p\.add_argument\("(--[a-z0-9-]+)"', src)
    assert len(jax_flags) == 23
    with pytest.raises(SystemExit):
        splat_trainer.main(["--help"])
    helptext = capsys.readouterr().out
    for flag in jax_flags:
        assert flag in helptext, flag
    assert not hasattr(splat_trainer, "UNPORTED")
    # --gs2d reaches the dataset: an empty directory fails on its files
    with pytest.raises(FileNotFoundError):
        splat_trainer.main(["--colmap", str(tmp_path), "--gs2d"], device="cpu")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="--video needs OpenCV"):
        splat_trainer.main(["--colmap", str(tmp_path), "--video"], device="cpu")
    with pytest.raises(ValueError, match="--colmap"):
        splat_trainer.main([], device="cpu")
