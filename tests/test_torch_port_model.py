"""The assembled port: WorldMirror.forward vs the JAX model, the weight
converters, the golden fixture, import hygiene and device selection.

- tiny config, f32 trunk, the port's random init converted for JAX by
  tools/convert_weights: cameras, heads, splats (canonical sets) and
  renders at the full-model parity bands (test_full_model_parity.compare_*);
- tools/convert_weights.convert_worldmirror(port state dict) has the JAX
  init's exact tree and shapes, and from_jax_params inverts it exactly;
- the committed golden fixtures `no_priors` and `all_priors` (pose, depth
  and intrinsics priors) with the two-pass protocol of
  tests/test_golden_fixture.py;
- the package imports with JAX unavailable and loads nothing of the JAX
  package; entry points without a device raise on a machine with no GPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_full_model_parity as tp
from torch_port_helpers import np_, state_dict_np, tree_np, uniform
from hunyuanworld_mirror_tpu.models import worldmirror as jwm
from hunyuanworld_mirror_tpu_torch import convert, infer
from hunyuanworld_mirror_tpu_torch.io import images as io_images
from hunyuanworld_mirror_tpu_torch.models import worldmirror as pwm
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from tools import convert_weights as cw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=56, patch_size=14, embed_dim=64, gs_dim=32,
            patch_embed="conv", trunk_depth=4, trunk_heads=4,
            intermediate_idxs=(0, 1, 2, 3), dpt_features=32,
            dpt_out_channels=(32, 48, 64, 64))
# TINY with the DINOv2 ViT-S/14 encoder, whose pos embed is resampled to a
# patch grid other than the configured 4 x 4
TINY_DINO = dict(TINY, patch_embed="dinov2_vits14_reg", embed_dim=384,
                 trunk_heads=6)


def _port_model(cfg_kw, params):
    model = pwm.WorldMirror(pwm.WorldMirrorConfig(**cfg_kw), device="cpu")
    model.load_state_dict(convert.from_jax_params(params))
    return model


def _numpy_preds(preds):
    return {k: ({kk: np_(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else np_(v)) for k, v in preds.items()}


def _ragged_splats(preds):
    """Static-shape splats -> per-batch lists of live splats (the form
    compare_geometry takes for its reference side)."""
    sp = preds["splats"]
    live = [np.asarray(sp["weights"][b]) > 0 for b in range(sp["weights"].shape[0])]
    return {k: [np.asarray(sp[k][b])[m] for b, m in enumerate(live)]
            for k in ("means", "quats", "scales", "opacities", "sh")}


@pytest.mark.parametrize("cfg_kw,hw", [(TINY, (56, 56)), (TINY_DINO, (42, 56))],
                         ids=["conv", "dinov2_42x56"])
def test_forward_matches_jax(cfg_kw, hw):
    """The whole tiny forward, render included; the DINOv2 case runs a
    landscape 42 x 56 image (3 x 4 patches: a resampled pos embed, RoPE on
    a non-square grid, W != H in the DPT heads and the render)."""
    model = pwm.WorldMirror(pwm.WorldMirrorConfig(**cfg_kw), device="cpu")
    # random init can relu the fov to 0 (an inf focal): bias it positive, as
    # test_full_model_parity does for the reference
    with torch.no_grad():
        model.cam_head.param_predictor.fc2.bias[7:] += 0.4
    params = cw.convert_worldmirror(state_dict_np(model))
    cfg_j = jwm.WorldMirrorConfig(**cfg_kw)
    imgs = uniform(0, (1, 2, *hw, 3))
    ref = jax.jit(lambda p, v: jwm.forward(p, cfg_j, v, render=True,
                                           trunk_dtype=jnp.float32))(
        params, {"img": jnp.asarray(imgs)})
    ref = {k: (tree_np(v) if isinstance(v, dict) else np.asarray(v))
           for k, v in ref.items()}
    ours = _numpy_preds(model({"img": torch.tensor(imgs)}, trunk_dtype=torch.float32))
    tp.compare_cameras(ours, ref, atol=2e-3)
    tp.compare_heads(ours, ref)
    np.testing.assert_array_equal(ours["splats"]["n_compact_dropped"],
                                  ref["splats"]["n_compact_dropped"])
    tp.compare_geometry(ours, {**ref, "splats": _ragged_splats(ref)})
    np.testing.assert_array_equal(ours["render_n_dropped"], ref["render_n_dropped"])


def _flat_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((f"#{i}", v) for i, v in enumerate(tree))
    else:
        return {prefix: (tuple(tree.shape), np.dtype(tree.dtype))}
    out = {}
    for k, v in items:
        out.update(_flat_shapes(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("cfg_kw", [TINY, TINY_DINO], ids=["conv", "dinov2"])
def test_converter_roundtrip(cfg_kw):
    port = pwm.WorldMirror(pwm.WorldMirrorConfig(**cfg_kw), device="cpu")
    sd = state_dict_np(port)
    params = cw.convert_worldmirror(dict(sd))
    init = jax.eval_shape(lambda: jwm.init(jax.random.PRNGKey(0),
                                           jwm.WorldMirrorConfig(**cfg_kw)))
    assert _flat_shapes(params) == _flat_shapes(init)
    back = convert.from_jax_params(params)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_init_follows_the_jax_distributions():
    """Seeded init: the gs-head's per-segment biases (quats 0, scales -7,
    opacity -2, SH 0, weights -2) survive the child convs' default init, and
    LayerScale / special-token scales are the JAX package's."""
    model = pwm.WorldMirror(pwm.WorldMirrorConfig(**TINY), device="cpu", seed=5)
    bias = np_(model.gs_renderer.gs_head[2].bias)
    np.testing.assert_array_equal(bias, [0] * 4 + [-7] * 3 + [-2] + [0] * 3 + [-2])
    vgt = model.visual_geometry_transformer
    assert float(np_(vgt.frame_blocks[0].ls1.gamma).max()) == pytest.approx(0.01)
    assert float(abs(np_(vgt.cam_token)).max()) <= 2e-6
    w = np_(vgt.frame_blocks[0].attn.qkv.weight)
    assert abs(w).max() <= 0.04 and 0.015 < w.std() < 0.02   # trunc-normal 0.02
    again = pwm.WorldMirror(pwm.WorldMirrorConfig(**TINY), device="cpu", seed=5)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def _golden_fixture(name):
    """The committed fixture `name` with the two-pass protocol of
    tests/test_golden_fixture.py: its views (the image, and the priors where
    the fixture has them) and its cond flags (meta/cond)."""
    from tools.make_golden_fixtures import load_fixture_tree, unflatten_tree
    path = os.path.join(REPO, "tests", "fixtures", f"full_model_{name}.npz")
    z = np.load(path)
    flat = load_fixture_tree({k: z[k] for k in z.files})
    params = unflatten_tree({k[len("params/"):]: v for k, v in flat.items()
                             if k.startswith("params/")})
    ref = unflatten_tree({k[len("ref/"):]: v for k, v in flat.items()
                          if k.startswith("ref/")})
    views = {k[len("views/"):]: torch.tensor(v) for k, v in flat.items()
             if k.startswith("views/")}
    views["img"] = views["img"].permute(0, 1, 3, 4, 2)           # NCHW -> NHWC
    cond = tuple(int(c) for c in z["meta/cond"])
    model = _port_model(dict(img_size=tp.IMG, patch_size=tp.PATCH,
                             embed_dim=tp.EMBED, gs_dim=tp.GSD, patch_embed="conv",
                             gs_compact=False, dpt_features=tp.DPT_F,
                             dpt_out_channels=tp.DPT_OC), params)
    # pass 1: cameras at the fixture band, heads at the tight band
    ours = _numpy_preds(model(views, cond_flags=cond, trunk_dtype=torch.float32))
    tp.compare_full(ours, ref, fixture_mode=True)
    # pass 2: the reference's cameras substituted, splats and renders tight
    ours = _numpy_preds(model(views, cond_flags=cond, trunk_dtype=torch.float32,
                              camera_params=ref["camera_params"]))
    tp.compare_geometry(ours, ref, nn_tol=1e-3, row_tol=5e-3, row_med=5e-4)
    return cond, views


def test_golden_fixture_no_priors():
    cond, views = _golden_fixture("no_priors")
    assert cond == (0, 0, 0) and set(views) == {"img"}


def test_golden_fixture_all_priors():
    """Camera poses, intrinsics and depth maps as prior tokens, cond (1, 1, 1)."""
    cond, views = _golden_fixture("all_priors")
    assert cond == (1, 1, 1)
    assert set(views) == {"img", "camera_pose", "camera_intrinsics", "depthmap"}


def test_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import hunyuanworld_mirror_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'hunyuanworld_mirror_tpu']\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_cli_run_and_export(tmp_path):
    """The CLI's run + export at the tiny preset on the CPU: a .npy stack in,
    points.ply / depth_XXX.npy / camera_params.json / gaussians.ply out."""
    np.save(tmp_path / "views.npy", uniform(2, (2, 56, 56, 3)))
    imgs = io_images.load_inputs(str(tmp_path / "views.npy"))
    cfg = pwm.WorldMirrorConfig(img_size=56, **infer.PRESETS["tiny"])
    preds = infer.run(imgs, cfg, device="cpu")
    assert preds["rendered_colors"].shape == (1, 2, 56, 56, 3)
    assert all(bool(torch.isfinite(preds[k]).all())
               for k in ("depth", "pts3d", "rendered_colors"))
    out = tmp_path / "out"
    infer.export(preds, imgs, out)
    assert np.load(out / "depth_001.npy").shape == (56, 56)
    assert (out / "camera_params.json").exists()
    for name in ("points.ply", "gaussians.ply"):
        assert (out / name).read_bytes().startswith(b"ply\nformat binary_little_endian")


def test_cli_run_landscape_png(tmp_path):
    """A 4:3 photo through the CLI's loader (crop mode, 56 px: 56 x 42, a
    3 x 4 patch grid) and run + export on the CPU with a DINOv2 encoder,
    whose pos embed is resampled to that grid."""
    from PIL import Image
    rgb = (uniform(6, (60, 80, 3)) * 255).astype(np.uint8)
    (tmp_path / "views").mkdir()
    for i in range(2):
        Image.fromarray(np.roll(rgb, 7 * i, axis=1)).save(tmp_path / "views" / f"{i}.png")
    imgs = io_images.load_inputs(str(tmp_path / "views"), target_size=56)
    assert imgs.shape == (1, 2, 42, 56, 3)
    preds = infer.run(imgs, pwm.WorldMirrorConfig(**TINY_DINO), device="cpu")
    assert preds["rendered_colors"].shape == (1, 2, 42, 56, 3)
    assert preds["depth"].shape == (1, 2, 42, 56, 1)
    assert all(bool(torch.isfinite(preds[k]).all())
               for k in ("depth", "pts3d", "rendered_colors"))
    infer.export(preds, imgs, tmp_path / "out")
    assert np.load(tmp_path / "out" / "depth_001.npy").shape == (42, 56)


def test_entry_points_without_device_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pwm.WorldMirrorConfig(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pwm.WorldMirror(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.run(uniform(1, (1, 2, 56, 56, 3)), cfg)
    z = torch.zeros
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prast.rasterize(z(4, 3), z(4, 4), z(4, 3), z(4), z(4, 3),
                        torch.eye(4)[None], torch.eye(3)[None], 16, 16)
