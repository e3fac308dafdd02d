"""Port vs JAX: the model's switches and the CLI twin's exports.

- each head switched off in turn (`enable_cam/pts/depth/norm/gs`): the
  prediction keys of the JAX forward of that config, and the values of the
  full JAX forward (the heads are independent); the port's state dict and
  the converters without the absent head;
- the Gaussian renderer's `position_from` (all four sources),
  `predict_offset`, `predict_residual_sh=False`, `enable_prune=False` and
  `enable_conf_filter` against JAX gaussians.render;
- `head_chunk` and `fuse_parallel_heads` against the JAX forward of each
  config (its `lax.map` over frame groups, its vmapped pts + normals
  decode) and against the port's own unchunked / unfused forward, and
  `head_dtype="bfloat16"` against the JAX DPT head in bf16;
- `crop_with_intrinsics` and `rescale_with_intrinsics` (shrinking and
  growing) equal to the JAX package's on the same image and K;
- the CLI twin with `--cond 1,1,1 --no-gs --mode pad`, and its exports
  (PNGs, .splat, COLMAP) byte-identical to the JAX package's writers on the
  same arrays, the COLMAP model read back through the port's readers.

Bands: cameras 2e-3 and the dense heads at compare_heads' 5e-3 / 5e-3
(tests/test_full_model_parity.py); splats 1e-5 (from a whole JAX forward,
all but the voxel-edge flips, at most 0.2 % of the rows); chunked heads 2e-5 of the
port's own unchunked forward, fused heads equal to the unfused; bf16 heads
within twice the JAX head's own bf16-vs-f32 distance of JAX's bf16 head and
more than half that distance from JAX's f32 head.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_full_model_parity as tp
from torch_port_helpers import (close, close_splat_sets, normal, np_, state_dict_np,
                                t, tree_np, uniform)
from hunyuanworld_mirror_tpu.io import colmap as jcolmap
from hunyuanworld_mirror_tpu.io import images as jimages
from hunyuanworld_mirror_tpu.io import ply as jply
from hunyuanworld_mirror_tpu.models import dpt as jdpt
from hunyuanworld_mirror_tpu.models import gaussians as jgs
from hunyuanworld_mirror_tpu.models import worldmirror as jwm
from hunyuanworld_mirror_tpu.utils import geometry as jgeo
from hunyuanworld_mirror_tpu_torch import convert, infer
from hunyuanworld_mirror_tpu_torch.io import colmap as pcolmap
from hunyuanworld_mirror_tpu_torch.io import images as pimages
from hunyuanworld_mirror_tpu_torch.io import ply as pply
from hunyuanworld_mirror_tpu_torch.models import dpt as pdpt
from hunyuanworld_mirror_tpu_torch.models import gaussians as pgs
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.models import worldmirror as pwm
from tools import convert_weights as cw

TINY = dict(img_size=56, patch_size=14, embed_dim=64, gs_dim=32,
            patch_embed="conv", trunk_depth=2, trunk_heads=4,
            intermediate_idxs=(0, 0, 1, 1), dpt_features=32,
            dpt_out_channels=(32, 48, 64, 64))
HEADS = {"cam": ("cam_head",), "pts": ("pts_head",), "depth": ("depth_head",),
         "norm": ("norm_head",), "gs": ("gs_head", "gs_renderer")}
SPLAT_BAND = 1e-5


def _np_tree(x):
    return {k: (_np_tree(v) if isinstance(v, dict) else np_(v)) for k, v in x.items()}


def _port(cfg_kw, params):
    model = pwm.WorldMirror(pwm.WorldMirrorConfig(**cfg_kw), device="cpu")
    model.load_state_dict(convert.from_jax_params(params))
    return model


@pytest.fixture(scope="module")
def full():
    """The full tiny model's JAX params (from the port's init, the fov bias
    raised so no focal is infinite) and the JAX forward without render."""
    model = pwm.WorldMirror(pwm.WorldMirrorConfig(**TINY), device="cpu", seed=4)
    with torch.no_grad():
        model.cam_head.param_predictor.fc2.bias[7:] += 0.4
    params = cw.convert_worldmirror(state_dict_np(model))
    imgs = uniform(20, (1, 2, 56, 56, 3))
    ref = jax.jit(lambda p, v: jwm.forward(p, jwm.WorldMirrorConfig(**TINY), v,
                                           render=False, trunk_dtype=jnp.float32))(
        params, {"img": jnp.asarray(imgs)})
    return params, imgs, tree_np(ref)


def _keys(tree):
    return {k: (_keys(v) if isinstance(v, dict) else None) for k, v in tree.items()}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_switched_off(full, head):
    """The head's module and parameters are absent, the converters skip it,
    the prediction keys are the JAX forward's for that config and the
    values those of the full forward. Without the camera head the splat
    means come from the point head (the default source needs cameras)."""
    params, imgs, ref = full
    kw = dict(TINY, **{f"enable_{head}": False})
    if head == "cam":
        kw["gs_position_from"] = "pts3d"
    sub = {k: v for k, v in params.items() if k not in HEADS[head]}
    model = _port(kw, sub)
    assert not any(hasattr(model, m) for m in HEADS[head])
    sd = state_dict_np(model)
    assert _keys(cw.convert_worldmirror(dict(sd))) == _keys(sub)
    back = convert.from_jax_params(cw.convert_worldmirror(dict(sd)))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    ours = _np_tree(model({"img": torch.tensor(imgs)}, trunk_dtype=torch.float32,
                          render=False))
    shapes = jax.eval_shape(lambda p, v: jwm.forward(
        p, jwm.WorldMirrorConfig(**kw), v, render=False, trunk_dtype=jnp.float32),
        sub, {"img": jax.ShapeDtypeStruct(imgs.shape, jnp.float32)})
    assert _keys(ours) == _keys(shapes)
    if head != "cam":
        tp.compare_cameras(ours, ref, atol=2e-3)
    for k in ("depth", "depth_conf", "pts3d", "pts3d_conf", "normals",
              "normals_conf", "gs_depth", "gs_depth_conf"):
        if k in ours:
            close(ours[k], ref[k], atol=5e-3, rtol=5e-3, err_msg=k)
    if head not in ("cam", "gs"):
        close_splat_sets(ours["splats"], ref["splats"], SPLAT_BAND, SPLAT_BAND)


GS_CASES = {
    "pts3d": dict(position_from="pts3d"),
    "preddepth+predcamera": dict(position_from="preddepth+predcamera"),
    "gsdepth+predcamera": dict(position_from="gsdepth+predcamera"),
    "gsdepth+gtcamera": dict(position_from="gsdepth+gtcamera"),
    "predict_offset": dict(predict_offset=True),
    "no_residual_sh": dict(predict_residual_sh=False),
    "no_prune": dict(enable_prune=False),
    "conf_filter": dict(enable_conf_filter=True),
    "conf_filter_no_prune": dict(enable_conf_filter=True, enable_prune=False),
}


@pytest.mark.parametrize("case", sorted(GS_CASES))
def test_gaussian_renderer_options(case):
    """prepare_splats' four mean sources and the offsets, then the filter,
    merge and compaction stages as each config runs them (compaction only
    after a prune or a filter), against JAX gaussians.render."""
    cfg = pgs.GSRendererConfig(feature_dim=32, **GS_CASES[case])
    renderer = pgs.GaussianSplatRenderer(cfg)
    pnn.init_weights(renderer, torch.Generator().manual_seed(2))
    jparams = cw.convert_gs_renderer(state_dict_np(renderer))
    B, S, H, W = 1, 2, 32, 32
    cams = np.zeros((B, S, 9), np.float32)
    cams[..., 6], cams[..., 7:] = 1.0, 0.9
    cams[0, 1, :3] = [0.2, -0.1, 0.05]
    pose = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    pose[0, 1, :3, 3] = [0.3, 0.1, -0.2]
    K = np.tile(np.array([[30, 0, 16], [0, 28, 16], [0, 0, 1]], np.float32), (B, S, 1, 1))
    inputs = dict(
        feats=normal(30, (B, S, H, W, 16)), imgs=uniform(31, (B, S, H, W, 3)),
        preds={"camera_params": cams, "pts3d": normal(32, (B, S, H, W, 3)),
               "depth": uniform(33, (B, S, H, W, 1), 1.0, 4.0),
               "gs_depth": uniform(34, (B, S, H, W, 1), 1.0, 4.0),
               "gs_depth_conf": uniform(35, (B, S, H, W), 1.0, 3.0)},
        views={"camera_pose": pose, "camera_intrinsics": K})
    ours = pgs.render(renderer, t(inputs["feats"]), t(inputs["imgs"]),
                      {k: t(v) for k, v in inputs["preds"].items()}, do_render=False,
                      views={k: t(v) for k, v in inputs["views"].items()})["splats"]
    jcfg = jgs.GSRendererConfig(feature_dim=32, **GS_CASES[case])
    ref = jgs.render(jparams, jcfg, jnp.asarray(inputs["feats"]), jnp.asarray(inputs["imgs"]),
                     {k: jnp.asarray(v) for k, v in inputs["preds"].items()},
                     do_render=False,
                     views={k: jnp.asarray(v) for k, v in inputs["views"].items()})["splats"]
    ref = tree_np(ref)
    assert set(ours) == set(ref)
    if "n_compact_dropped" in ref:
        np.testing.assert_array_equal(np_(ours["n_compact_dropped"]), ref["n_compact_dropped"])
    close_splat_sets(ours, ref, SPLAT_BAND, SPLAT_BAND)
    if case == "no_prune":            # no merge, no compaction: slot for slot
        for k in ref:
            close(ours[k], ref[k], SPLAT_BAND, SPLAT_BAND, err_msg=k)


def test_predict_offset_converter_roundtrip():
    """The wider gs-param conv (3 offset channels, bias 1e-3) maps to the
    JAX init's shapes and back exactly, inside a whole model's pytree."""
    model = pwm.WorldMirror(pwm.WorldMirrorConfig(**TINY), device="cpu")
    cfg = dataclasses.replace(model.cfg.gs_renderer, predict_offset=True)
    model.gs_renderer = pgs.GaussianSplatRenderer(cfg)
    pnn.init_weights(model.gs_renderer, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(np_(model.gs_renderer.gs_head[2].bias)[-3:],
                                  np.float32(1e-3))
    sd = state_dict_np(model)
    params = cw.convert_worldmirror(dict(sd))
    init = jax.eval_shape(lambda: jgs.init(jax.random.PRNGKey(0), jgs.GSRendererConfig(
        feature_dim=TINY["gs_dim"], predict_offset=True)))
    assert jax.tree.map(np.shape, params["gs_renderer"]) == jax.tree.map(
        lambda a: a.shape, init)
    back = convert.from_jax_params(params)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def _jax_forward(cfg_kw, params, imgs, **kw):
    """The JAX package's forward of that config, one jit, f32 trunk, no
    render."""
    cfg = jwm.WorldMirrorConfig(**cfg_kw)
    return tree_np(jax.jit(lambda p, v: jwm.forward(
        p, cfg, v, render=False, trunk_dtype=jnp.float32, **kw))(
        params, {"img": jnp.asarray(imgs)}))


def _close_to_jax(ours, ref):
    """Cameras at 2e-3, the dense heads at compare_heads' 5e-3 / 5e-3, the
    splats as sets at 1e-5 but for voxel-edge flips (at most 0.2 % of the
    rows: the means come from two forwards)."""
    tp.compare_cameras(ours, ref, atol=2e-3)
    if "camera_params_pred" in ref:
        close(ours["camera_params_pred"], ref["camera_params_pred"], 2e-3)
    tp.compare_heads(ours, ref)
    close_splat_sets(ours["splats"], ref["splats"], SPLAT_BAND, SPLAT_BAND, flip_frac=2e-3)


def test_head_chunk_matches_unchunked(full):
    """S = 4 in frame groups of 2 (the gs-param conv inside each group)
    against the JAX package's chunked forward (lax.map over the groups) on
    the same params, and against the port's own unchunked forward; S = 3
    does not divide and runs unchunked."""
    params = full[0]
    kw = dict(TINY, head_chunk=2)
    model, chunked = _port(TINY, params), _port(kw, params)
    assert pwm.frame_chunks(chunked.cfg, 4) == 2 and pwm.frame_chunks(chunked.cfg, 3) is None
    imgs = uniform(21, (1, 4, 56, 56, 3))
    cams = np.tile(np.r_[np.zeros(6), 1.0, 0.9, 0.9].astype(np.float32), (1, 4, 1))
    views = {"img": t(imgs)}
    fkw = dict(trunk_dtype=torch.float32, camera_params=t(cams))
    a, b = _np_tree(model(views, **fkw)), _np_tree(chunked(views, **fkw))
    assert set(a) == set(b)
    for k in a:
        if k == "splats":
            close_splat_sets(b[k], a[k], 2e-5, 2e-5)
        else:
            close(b[k], a[k], 2e-5, 2e-5, err_msg=k)
    _close_to_jax(b, _jax_forward(kw, params, imgs, camera_params=jnp.asarray(cams)))


def test_fused_parallel_heads_match_unfused(full):
    """fuse_parallel_heads: the port decodes the points and normals heads
    in turn, equal to the unfused forward, and within the bands of the JAX
    package's one vmapped decode of the two (its fuse condition holds for
    this config) on the same params."""
    params = full[0]
    kw = dict(TINY, fuse_parallel_heads=True)
    jcfg = jwm.WorldMirrorConfig(**kw)
    assert jcfg.pts_head.with_conf and (dataclasses.replace(jcfg.pts_head, activation="")
                                        == dataclasses.replace(jcfg.norm_head, activation=""))
    imgs = uniform(22, (1, 3, 56, 56, 3))
    views = {"img": t(imgs)}
    a = _np_tree(_port(TINY, params)(views, trunk_dtype=torch.float32, render=False))
    b = _np_tree(_port(kw, params)(views, trunk_dtype=torch.float32, render=False))
    for k in ("pts3d", "pts3d_conf", "normals", "normals_conf", "depth"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    _close_to_jax(b, _jax_forward(kw, params, imgs))


@pytest.mark.parametrize("is_gsdpt", [False, True], ids=["pts", "gs"])
def test_bf16_heads(is_gsdpt):
    """head_dtype="bfloat16" reaches the DPT heads, whose decoder then
    computes in bf16 (the gs head's fused map comes out bf16) with f32
    final activations; each output lies within twice the JAX head's own
    bf16-vs-f32 distance of the JAX bf16 head, and more than half that
    distance from the JAX f32 head (an f32 decode would sit on it)."""
    assert pwm.WorldMirrorConfig(**TINY, head_dtype="bfloat16").gs_head.compute_dtype == "bfloat16"
    kw = dict(dim_in=128, features=32, out_channels=(32, 48, 64, 64), is_gsdpt=is_gsdpt,
              output_dim=2 if is_gsdpt else 4,
              activation="exp+expp1" if is_gsdpt else "inv_log+expp1")
    head = pdpt.DPTHead(pdpt.DPTConfig(**kw, compute_dtype="bfloat16"))
    pnn.init_weights(head, torch.Generator().manual_seed(1))
    params = cw.convert_dpt(state_dict_np(head), is_gsdpt=is_gsdpt)
    toks = [normal(40 + i, (1, 2, 7 + 4, 128)) for i in range(4)]
    imgs = uniform(44, (1, 2, 28, 28, 3))
    with torch.no_grad():
        ours = head([t(x) for x in toks], t(imgs), 7)
    ref = {d: jdpt.forward(params, jdpt.DPTConfig(**kw, compute_dtype=d),
                           [jnp.asarray(x) for x in toks], jnp.asarray(imgs), 7)
           for d in ("bfloat16", "float32")}
    for i, (o, r16, r32) in enumerate(zip(ours, ref["bfloat16"], ref["float32"])):
        r16, r32 = np.asarray(r16, np.float32), np.asarray(r32)
        if i == len(ours) - 2 or i == len(ours) - 1:       # preds and conf: f32
            assert o.dtype == torch.float32
        else:                                               # the gs fused map
            assert o.dtype == torch.bfloat16
        own = np.abs(r16 - r32).max()
        o = np_(o)
        assert 0 < own and np.abs(o - r16).max() <= 2 * own, (i, own)
        assert np.abs(o - r32).max() > 0.5 * own, (i, own)


@pytest.mark.parametrize("op", ["crop", "shrink", "grow"])
def test_crop_rescale_with_intrinsics(op):
    """The image and K a caller brings to the model's crop: the same
    arrays, dtype included, as the JAX package's io.images."""
    img = (uniform(25, (60, 80, 3)) * 255).astype(np.uint8)
    K = np.array([[70.0, 0, 41.5], [0, 68.0, 29.0], [0, 0, 1]], np.float32)
    if op == "crop":
        fn, arg = "crop_with_intrinsics", (5, 7, 53, 71)
    else:
        fn, arg = "rescale_with_intrinsics", (30, 40) if op == "shrink" else (90, 120)
    ours, ref = getattr(pimages, fn)(img, K, arg), getattr(jimages, fn)(img, K, arg)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        np.testing.assert_array_equal(o, r)


def _jax_exports(preds, images, out, conf_percent=20.0):
    """The exports of infer.py written with the JAX package's writers on
    the same arrays (infer.py's own statements)."""
    S, H, W = images.shape[1:4]
    pts = preds["pts3d"][0].reshape(-1, 3)
    conf = preds["pts3d_conf"][0].reshape(-1)
    thresh = np.percentile(conf, conf_percent)
    jply.save_points_ply(out / "points.ply", pts, images[0].reshape(-1, 3), conf >= thresh)
    for s in range(S):
        jply.save_depth_png(out / f"depth_{s:03d}.png", preds["depth"][0, s, ..., 0])
        jply.save_depth_npy(out / f"depth_{s:03d}.npy", preds["depth"][0, s, ..., 0])
        if "normals" in preds:
            jply.save_normal_png(out / f"normal_{s:03d}.png", preds["normals"][0, s])
    c2w, K = preds["camera_poses"][0], preds["camera_intrs"][0]
    jply.save_camera_params(c2w, K, out)
    if "splats" in preds:
        sp = preds["splats"]
        alive = sp["opacities"][0] > 1e-4
        op = np.clip(sp["opacities"][0], 1e-6, 1 - 1e-6)
        jply.save_gs_ply(out / "gaussians.ply", sp["means"][0][alive],
                         sp["scales"][0][alive], sp["quats"][0][alive],
                         sp["sh"][0][:, 0][alive], np.log(op / (1 - op))[alive])
        jply.gs_ply_to_splat(out / "gaussians.ply", out / "gaussians.splat")
    stride = 4
    pix = np.asarray(jgeo.create_pixel_coordinate_grid(S, H, W))[:, ::stride, ::stride]
    pts_frames = preds["pts3d"][0][:, ::stride, ::stride].reshape(-1, 3)
    col = (images[0][:, ::stride, ::stride].reshape(-1, 3) * 255).astype(np.uint8)
    conf_flat = preds["pts3d_conf"][0][:, ::stride, ::stride].reshape(-1)
    keep = conf_flat >= np.percentile(conf_flat, conf_percent)
    jcolmap.export_reconstruction(str(out / "sparse"), pts_frames[keep],
                                  pix.reshape(-1, 3)[keep], col[keep],
                                  np.linalg.inv(c2w), K, (W, H))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_exports_byte_identical(tmp_path):
    """Every file infer.export writes equals, byte for byte, what the JAX
    package's writers make of the same predictions; the .splat and PNG
    writers alone too, and the COLMAP model reads back through the port's
    readers as through the JAX package's."""
    imgs = uniform(23, (1, 2, 56, 56, 3))
    cfg = pwm.WorldMirrorConfig(img_size=56, **infer.PRESETS["tiny"])
    preds = infer.run(imgs, cfg, device="cpu", camera_params=np.tile(
        np.r_[np.zeros(6), 1.0, 0.9, 0.9].astype(np.float32), (1, 2, 1)))
    infer.export(preds, imgs, tmp_path / "port")
    (tmp_path / "jax").mkdir()
    _jax_exports(_np_tree(preds), imgs, tmp_path / "jax")
    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "jax")
    assert {"gaussians.splat", "depth_001.png", "normal_001.png",
            "sparse/points3D.bin"} <= set(names)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n

    sp = _np_tree(preds["splats"])
    for mod, d in ((pply, "port"), (jply, "jax")):
        mod.save_splat(tmp_path / d / "direct.splat", sp["means"][0], sp["scales"][0],
                       sp["quats"][0], sp["opacities"][0], sp["sh"][0][:, 0])
        mod.save_image_png(tmp_path / d / "rgb.png", imgs[0, 1])
    for n in ("direct.splat", "rgb.png"):
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n

    sparse = tmp_path / "port" / "sparse"
    for reader in ("read_cameras_bin", "read_images_bin", "read_points3d_bin"):
        fname = {"read_cameras_bin": "cameras.bin", "read_images_bin": "images.bin",
                 "read_points3d_bin": "points3D.bin"}[reader]
        ours = getattr(pcolmap, reader)(str(sparse / fname))
        ref = getattr(jcolmap, reader)(str(sparse / fname))
        assert ours.keys() == ref.keys() and len(ours) > 0
        for key in ours:
            for field, v in ref[key].items():
                np.testing.assert_array_equal(np.asarray(ours[key][field]), np.asarray(v))
    images = pcolmap.read_images_bin(str(sparse / "images.bin"))
    assert [im["name"] for im in images.values()] == ["frame_1", "frame_2"]


def test_cli_cond_no_gs_pad(tmp_path, monkeypatch):
    """`--cond 1,1,1 --no-gs --mode pad` on 4:3 PNGs: the images padded to
    56 x 56, no Gaussian head, the cond flags reach the model with the
    images only (as the JAX CLI feeds them), and the exports without the
    splats are written."""
    from PIL import Image
    (tmp_path / "views").mkdir()
    rgb = (uniform(24, (60, 80, 3)) * 255).astype(np.uint8)
    for i in range(2):
        Image.fromarray(np.roll(rgb, 5 * i, axis=1)).save(tmp_path / "views" / f"{i}.png")
    seen = {}
    forward = pwm.WorldMirror.forward

    def spy(self, views, cond_flags=(0, 0, 0), **kw):
        seen.update(keys=set(views), cond=tuple(cond_flags), shape=tuple(views["img"].shape),
                    gs=self.cfg.enable_gs)
        return forward(self, views, cond_flags=cond_flags, **kw)

    monkeypatch.setattr(pwm.WorldMirror, "forward", spy)
    infer.main([str(tmp_path / "views"), "-o", str(tmp_path / "out"), "--preset", "tiny",
                "--size", "56", "--cond", "1,1,1", "--no-gs", "--mode", "pad"], device="cpu")
    assert seen == dict(keys={"img"}, cond=(1, 1, 1), shape=(1, 2, 56, 56, 3), gs=False)
    names = _files(tmp_path / "out")
    assert not any(n.startswith("gaussians") for n in names)
    assert {"points.ply", "camera_params.json", "depth_000.png", "depth_001.npy",
            "normal_001.png", "sparse/cameras.bin", "sparse/images.bin",
            "sparse/points3D.bin"} <= set(names)
    cams = pcolmap.read_cameras_bin(str(tmp_path / "out" / "sparse" / "cameras.bin"))
    assert [(c["width"], c["height"], c["model"]) for c in cams.values()] == [
        (56, 56, "SIMPLE_PINHOLE")] * 2
    depth = np.load(tmp_path / "out" / "depth_000.npy")
    jply.save_depth_png(tmp_path / "ref.png", depth)
    assert (tmp_path / "ref.png").read_bytes() == (tmp_path / "out" / "depth_000.png").read_bytes()
