"""Port vs JAX on the render's switches: coverage-scheduled prefix binning
(`slot_fracs`, the CLI's --fast-binning), the dense-bin route
(`impl="jax"`, the CLI's --rasterizer jax, kernel K4's plain version on the
CPU) and `exact_tile_test`, alone and through the tiny model.

- prefix bins against tiles.bin_gaussians_packed_prefix: f32 and f16-pair
  payloads, the conic test on and off, "auto" and a tuple that drops;
  starts, counts, n_dropped and the packed rows within each tile's count
  EQUAL;
- the flat blend of the "auto" lists (K2's plain version) against the Pallas
  flat kernel in interpret mode with slot_fracs="auto", atol 1e-4;
- rasterize(impl="jax") against the JAX rasterize(impl="jax"): RGB and SH
  colours, the exact test on and off, atol 1e-5, n_dropped equal;
- the tiny model with rasterizer_impl="jax" against the JAX forward at the
  full-model bands; gs_slot_fracs="auto" against the exact render where
  nothing is dropped, and a dropping tuple raises render_n_dropped by the
  JAX binning's count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_full_model_parity as tp
from test_rasterizer import _random_scene
from test_torch_port_model import TINY, _numpy_preds, _ragged_splats
from test_torch_port_render import H, TH, TILE, TW, W, _project, _value_planes
from torch_port_helpers import close, np_, state_dict_np, t, tree_np, uniform
from hunyuanworld_mirror_tpu.models import worldmirror as jwm
from hunyuanworld_mirror_tpu.ops import rasterizer as jrast
from hunyuanworld_mirror_tpu.ops import tiles as jtiles
from hunyuanworld_mirror_tpu.ops.rasterizer_pallas import rasterize_flat_pallas
from hunyuanworld_mirror_tpu_torch.models import worldmirror as pwm
from hunyuanworld_mirror_tpu_torch.ops import projection as pproj
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat
from hunyuanworld_mirror_tpu_torch.ops import tiles as ptiles
from hunyuanworld_mirror_tpu_torch.utils import camera as pcam
from tools import convert_weights as cw

# 1200 splats: "auto" keeps (1200, 1024, 512, 512) rows; DROP cuts planes
DROP = (1.0, 0.25, 0.0, 0.0)


def _jax_prefix(s, values, slot_fracs, conic, tpg=4, mpt=1024):
    ct = (jtiles.conic_test_planes(jnp.asarray(s["con"]), jnp.asarray(s["op"]))
          if conic else None)
    return jax.jit(lambda m, r, d, v, c: jtiles.bin_gaussians_packed_prefix(
        m, r, d, v, TILE, TW, TH, tpg, mpt, slot_fracs=slot_fracs, conic_test=c))(
        jnp.asarray(s["m2d"]), jnp.asarray(s["rad"]), jnp.asarray(s["dep"]),
        [jnp.asarray(np_(v)) for v in values], ct)


def _assert_same_lists(bins, ref):
    starts, counts = np_(bins.starts), np_(bins.counts)
    np.testing.assert_array_equal(starts, np.asarray(ref.starts))
    np.testing.assert_array_equal(counts, np.asarray(ref.counts))
    assert int(bins.n_dropped) == int(ref.n_dropped)
    assert bins.packed.shape == ref.packed.shape
    ours = np_(bins.packed).view(np.int32)
    want = np.asarray(ref.packed).view(np.int32)
    for s0, n in zip(starts, counts):
        np.testing.assert_array_equal(ours[:, s0:s0 + n], want[:, s0:s0 + n])


@pytest.mark.parametrize("slot_fracs", ["auto", DROP], ids=["auto", "drop"])
@pytest.mark.parametrize("conic", [True, False], ids=["conic", "aabb"])
@pytest.mark.parametrize("payload_f16", [False, True], ids=["f32", "f16"])
def test_prefix_bins_equal_jax(payload_f16, conic, slot_fracs):
    s = _project(1200)
    values = _value_planes(s, payload_f16)
    bins = ptiles.bin_gaussians_packed_prefix(
        t(s["m2d"]), torch.tensor(s["rad"]), t(s["dep"]), values, TILE, TW, TH,
        4, 1024, slot_fracs=slot_fracs,
        conic_test=ptiles.conic_test_planes(t(s["con"]), t(s["op"])) if conic else None)
    ref = _jax_prefix(s, values, slot_fracs, conic)
    _assert_same_lists(bins, ref)
    exact = ptiles.bin_gaussians_packed(
        t(s["m2d"]), torch.tensor(s["rad"]), t(s["dep"]), values, TILE, TW, TH,
        4, 1024,
        conic_test=ptiles.conic_test_planes(t(s["con"]), t(s["op"])) if conic else None)
    if slot_fracs == "auto":
        # nothing lost here: the same lists as the exact binning, fewer rows
        assert int(bins.n_dropped) == int(exact.n_dropped)
        assert bins.packed.shape[1] < exact.packed.shape[1]
        np.testing.assert_array_equal(np_(bins.counts), np_(exact.counts))
    else:
        assert int(bins.n_dropped) > int(exact.n_dropped)


def test_prefix_bins_reject_bad_fracs():
    s = _project(50)
    args = (t(s["m2d"]), torch.tensor(s["rad"]), t(s["dep"]),
            _value_planes(s, False), TILE, TW, TH, 4, 1024)
    with pytest.raises(ValueError, match="slot_fracs"):
        ptiles.bin_gaussians_packed_prefix(*args, slot_fracs=(1.0, 0.5))
    assert ptiles._auto_slot_fracs(4) == jtiles._auto_slot_fracs(4)
    assert ptiles._auto_slot_fracs(12) == jtiles._auto_slot_fracs(12)


@pytest.mark.parametrize("payload_f16", [False, True], ids=["f32", "f16"])
def test_plain_k2_on_prefix_lists_matches_pallas_interpret(payload_f16):
    """The flat route's forward with slot_fracs="auto" (bin_splats ->
    K2's plain version) against rasterize_flat_pallas(interpret=True,
    slot_fracs="auto"), atol 1e-4, n_dropped equal."""
    s, mpt = _project(1200), 1024
    bins = prast.bin_splats(t(s["m2d"]), t(s["con"]), t(s["col"]), t(s["op"]),
                            torch.tensor(s["rad"]), t(s["dep"]), TILE, TW, TH,
                            4, mpt, payload_f16, slot_fracs="auto")
    img, alpha = pflat.rasterize_flat(bins.packed, bins.starts, bins.counts, W, H,
                                      TILE, 4, payload_f16)
    img_j, a_j, drop_j = jax.jit(
        lambda m, c, col, op, r, d: rasterize_flat_pallas(
            m, c, col, op, r, d, jnp.zeros_like(m), W, H, TILE, 4, mpt, True,
            payload_f16, "auto"))(
        *(jnp.asarray(s[k]) for k in ("m2d", "con", "col", "op", "rad", "dep")))
    assert int(bins.n_dropped) == int(drop_j)
    close(img, img_j, 1e-4)
    close(alpha, a_j, 1e-4)


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


def test_model_slot_fracs():
    """gs_slot_fracs="auto" renders what the exact binning renders where it
    drops nothing; a dropping tuple raises render_n_dropped by exactly what
    the JAX prefix binning counts on the render's own lists."""
    model = _tiny_model()
    imgs = torch.tensor(uniform(5, (1, 2, 56, 56, 3)))
    with torch.no_grad():
        exact = model({"img": imgs})
        auto = _with_cfg(model, gs_slot_fracs="auto")({"img": imgs})
        drop = _with_cfg(model, gs_slot_fracs=DROP)({"img": imgs})
    np.testing.assert_array_equal(np_(auto["render_n_dropped"]),
                                  np_(exact["render_n_dropped"]))
    assert int(exact["render_n_dropped"].sum()) == 0
    for k in ("rendered_colors", "rendered_alphas", "rendered_depths"):
        close(auto[k], exact[k], 1e-6, err_msg=k)
    extra = []
    with torch.no_grad():
        for m2d, con, col, rad, dep in _render_lists(exact, 56, 56):
            op = exact["splats"]["opacities"][0]
            tw = th = (56 + TILE - 1) // TILE
            args = [jnp.asarray(np_(x)) for x in (m2d, rad, dep)]
            values = [jnp.asarray(np_(v)) for v in
                      (m2d[:, 0], m2d[:, 1], con[:, 0], con[:, 1], con[:, 2], op)]
            ct = jtiles.conic_test_planes(jnp.asarray(np_(con)), jnp.asarray(np_(op)))
            mpt = prast._capped(4096, m2d.shape[0], 4)
            pre = jtiles.bin_gaussians_packed_prefix(*args, values, TILE, tw, th, 4,
                                                     mpt, slot_fracs=DROP,
                                                     conic_test=ct)
            full = jtiles.bin_gaussians_packed(*args, values, TILE, tw, th, 4, mpt,
                                               conic_test=ct)
            extra.append(int(pre.n_dropped) - int(full.n_dropped))
    got = np_(drop["render_n_dropped"] - exact["render_n_dropped"])[0]
    assert got.tolist() == extra and sum(extra) > 0, (got, extra)


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
