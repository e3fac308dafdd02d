"""Port vs JAX on the render's switches: the dense-bin route
(`impl="jax"`, the CLI's --rasterizer jax, kernel K4's plain version on the
CPU), the per-tile cap and `exact_tile_test`, alone and through the tiny
model.

- rasterize(impl="jax") against the JAX rasterize(impl="jax"): RGB and SH
  colours, the exact test on and off, atol 1e-5, n_dropped equal;
- the tiny model with rasterizer_impl="jax" against the JAX forward at the
  full-model bands; under a small max_per_tile its render_n_isects and
  render_n_dropped equal the JAX exact binning's counts on the render's own
  lists; the ellipse test off bins more entries and renders the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_full_model_parity as tp
from test_rasterizer import _random_scene
from test_torch_port_model import TINY, _numpy_preds, _ragged_splats
from test_torch_port_render import H, TILE, W
from torch_port_helpers import close, np_, state_dict_np, t, tree_np, uniform
from hunyuanworld_mirror_tpu.models import worldmirror as jwm
from hunyuanworld_mirror_tpu.ops import rasterizer as jrast
from hunyuanworld_mirror_tpu.ops import tiles as jtiles
from hunyuanworld_mirror_tpu_torch.models import worldmirror as pwm
from hunyuanworld_mirror_tpu_torch.ops import projection as pproj
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.utils import camera as pcam
from tools import convert_weights as cw

@pytest.mark.parametrize("exact", [True, False], ids=["conic", "aabb"])
@pytest.mark.parametrize("sh", [False, True], ids=["rgb", "sh"])
def test_rasterize_jax_impl_matches_jax(sh, exact):
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(7), n=300, c=2)
    if sh:
        colors = ((colors - 0.5) / 0.28209479177387814)[:, None, :]
    kw = dict(max_per_tile=1024, max_tiles_per_gauss=4, exact_tile_test=exact)
    out, alpha, meta = prast.rasterize(
        t(means), t(quats), t(scales), t(opac), t(colors), t(viewmats), t(Ks),
        W, H, impl="jax", device="cpu", **kw)
    out_j, alpha_j, meta_j = jrast.rasterize(
        *(jnp.asarray(a) for a in (means, quats, scales, opac, colors, viewmats, Ks)),
        W, H, impl="jax", render_mode="RGB+ED", **kw)
    close(out, out_j, 1e-5)
    close(alpha, alpha_j, 1e-5)
    np.testing.assert_array_equal(np_(meta["n_dropped"]), np.asarray(meta_j["n_dropped"]))
    close(meta["radii"], meta_j["radii"], 0)
    # the flat route renders the same scene within the same band
    out_f, alpha_f, meta_f = prast.rasterize(
        t(means), t(quats), t(scales), t(opac), t(colors), t(viewmats), t(Ks),
        W, H, device="cpu", **kw)
    close(out_f, out_j, 1e-4)
    np.testing.assert_array_equal(np_(meta_f["n_isects"]), np_(meta["n_isects"]))


def test_rasterize_jax_impl_grads_and_guards():
    """The dense-bin route is differentiable (RasterizeBinned's replay of
    the plain version) and takes no camera_batch or abs_tap."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(3), n=120, c=1)
    m = t(means).requires_grad_(True)
    out, alpha, _ = prast.rasterize(m, t(quats), t(scales), t(opac), t(colors),
                                    t(viewmats), t(Ks), W, H, impl="jax", device="cpu")
    (out.sum() + alpha.sum()).backward()
    assert torch.isfinite(m.grad).all() and float(m.grad.abs().sum()) > 0
    args = tuple(t(a) for a in (means, quats, scales, opac, colors, viewmats, Ks))
    with pytest.raises(ValueError, match="camera_batch"):
        prast.rasterize(*args, W, H, impl="jax", camera_batch=True, device="cpu")
    with pytest.raises(ValueError, match="abs_tap"):
        prast.rasterize(*args, W, H, impl="jax", abs_tap=torch.zeros(120, 2),
                        device="cpu")
    with pytest.raises(ValueError, match="impl"):
        prast.rasterize(*args, W, H, impl="cuda", device="cpu")


def _tiny_model(**cfg_kw):
    model = pwm.WorldMirror(pwm.WorldMirrorConfig(**TINY, **cfg_kw), device="cpu")
    with torch.no_grad():
        model.cam_head.param_predictor.fc2.bias[7:] += 0.4
    return model


def _with_cfg(model, **cfg_kw):
    other = pwm.WorldMirror(pwm.WorldMirrorConfig(**TINY, **cfg_kw), device="cpu")
    other.load_state_dict(model.state_dict())
    return other


def test_model_jax_route_matches_jax():
    """rasterizer_impl="jax" through the tiny model against the JAX forward
    (whose CPU default is the same route) at the full-model bands."""
    model = _tiny_model(rasterizer_impl="jax")
    params = cw.convert_worldmirror(state_dict_np(model))
    imgs = uniform(0, (1, 2, 56, 56, 3))
    ref = jax.jit(lambda p, v: jwm.forward(
        p, jwm.WorldMirrorConfig(**TINY, rasterizer_impl="jax"), v, render=True,
        trunk_dtype=jnp.float32))(params, {"img": jnp.asarray(imgs)})
    ref = {k: (tree_np(v) if isinstance(v, dict) else np.asarray(v))
           for k, v in ref.items()}
    ours = _numpy_preds(model({"img": torch.tensor(imgs)}, trunk_dtype=torch.float32))
    tp.compare_cameras(ours, ref, atol=2e-3)
    tp.compare_geometry(ours, {**ref, "splats": _ragged_splats(ref)})
    np.testing.assert_array_equal(ours["render_n_dropped"], ref["render_n_dropped"])


def _render_lists(preds, H_img, W_img):
    """The model render's per-camera projected planes, as the render bins
    them (gaussians.render -> rasterize, quats WXYZ -> XYZW)."""
    sp = preds["splats"]
    ext, intr = pcam.vector_to_camera_matrices(preds["camera_params"][0],
                                               (H_img, W_img))
    w2c = pcam.to_homogeneous(ext)
    quats = sp["quats"][0][:, [1, 2, 3, 0]]
    covars = pproj.quat_scale_to_covar_planes(quats, sp["scales"][0])
    for c in range(w2c.shape[0]):
        yield prast.project_camera(sp["means"][0], covars, sp["opacities"][0],
                                   sp["sh"][0], w2c[c], intr[c], W_img, H_img)


def test_model_counts_equal_jax_under_a_small_cap():
    """The tiny model under max_per_tile=32: render_n_isects and
    render_n_dropped of each camera are what JAX's exact
    bin_gaussians_packed counts on the render's own lists."""
    from dataclasses import replace
    model = _tiny_model()
    model.gs_renderer.cfg = replace(model.gs_renderer.cfg, max_per_tile=32)
    imgs = torch.tensor(uniform(5, (1, 2, 56, 56, 3)))
    isects, dropped = [], []
    with torch.no_grad():
        preds = model({"img": imgs})
        for m2d, con, col, rad, dep in _render_lists(preds, 56, 56):
            op = preds["splats"]["opacities"][0]
            tw = th = (56 + TILE - 1) // TILE
            args = [jnp.asarray(np_(x)) for x in (m2d, rad, dep)]
            values = [jnp.asarray(np_(v)) for v in
                      (m2d[:, 0], m2d[:, 1], con[:, 0], con[:, 1], con[:, 2], op)]
            ct = jtiles.conic_test_planes(jnp.asarray(np_(con)), jnp.asarray(np_(op)))
            ref = jtiles.bin_gaussians_packed(*args, values, TILE, tw, th, 4, 32,
                                              conic_test=ct)
            isects.append(int(np.asarray(ref.counts).sum()))
            dropped.append(int(ref.n_dropped))
    assert np_(preds["render_n_isects"])[0].tolist() == isects
    assert np_(preds["render_n_dropped"])[0].tolist() == dropped
    assert sum(dropped) > 0, dropped


def test_model_exact_tile_test_switch(monkeypatch):
    """GSRendererConfig.exact_tile_test=False and WM_EXACT_TILE=0 each bin
    without the ellipse test: more entries, the same render within 1e-5."""
    from dataclasses import replace
    model = _tiny_model()
    imgs = torch.tensor(uniform(6, (1, 2, 56, 56, 3)))
    with torch.no_grad():
        exact = model({"img": imgs})
        aabb = _with_cfg(model)
        aabb.gs_renderer.cfg = replace(aabb.gs_renderer.cfg, exact_tile_test=False)
        runs = [aabb({"img": imgs})]
        monkeypatch.setenv("WM_EXACT_TILE", "0")
        runs.append(model({"img": imgs}))
    for out in runs:
        assert (np_(out["render_n_isects"]) >= np_(exact["render_n_isects"])).all()
        assert int(out["render_n_isects"].sum()) > int(exact["render_n_isects"].sum())
        for k in ("rendered_colors", "rendered_alphas"):
            close(out[k], exact[k], 1e-5, err_msg=k)
