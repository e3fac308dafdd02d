"""Port vs JAX on the rest of `rasterize`'s signature: the render modes, the
projection's knobs, the camera models through the unscented transform,
world-space eval3d, and `rasterize_to_indices`. On the CPU every kernel
wrapper takes its plain version (K2, K2m, K3, K4); the JAX reference runs
its dense-bin route (`impl="jax"`, which is what its `impl="pallas"` turns
into off a TPU).

- each render mode (RGB, D, ED, RGB+D, RGB+ED) with calc_compensations,
  radius_clip, eps2d and the near/far planes, on the flat route (K2's plain
  version), the dense route (K4's) and the camera batch (K2m's), against
  one JAX render in RGB+D (the other modes are its channels): atol 1e-4,
  ED the port's own D over alpha; tight_radius=False renders the same;
- each UT route (fisheye, OpenCV, f-theta, rolling shutter): the port's
  flat and dense blends on the JAX UT projection's own lists against the
  JAX dense blend of them, atol 1e-4 (the band of the pinhole render
  tests); end to end, port against JAX, 99% of pixels within 1e-3 and
  every pixel within 5e-2: the UT mean weighs its sigma points -99 and
  16.7, so f32 rounding moves a projected mean by ~1e-3 px on either side
  (held to JAX's own f32 error in test_torch_port_cameras.py), a pixel
  whose alpha sits at the 1/255 keep threshold flips by up to ~1/255 of a
  colour, and under a rolling shutter a sigma point whose solve lands on
  the next row (the shutter time floors v) moves by that row's motion;
- the gradient through the UT projection and the flat blend's backward
  (K3's plain version) against jax.grad of the JAX render, fisheye and
  OpenCV: atol 1e-3 x max |grad| per parameter (measured: at most
  2.5e-4 x, one element in 360);
- eval3d (fisheye, rolling shutter) against JAX, atol 1e-4, and its
  gradient at 1e-3 x max |grad|. JAX's scan pads the tile axis with zero
  rays, whose direction norm has a NaN gradient at 0: its quats and scales
  rows of splat 0 come out NaN. The port pads nothing: it is held on the
  rows where JAX is finite and must be finite everywhere;
- rasterize_to_indices: ids equal (-1 where the weight is 0), weights 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ftheta import FTHETA
from test_rasterizer import _random_scene
from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.ops import cameras as jc
from hunyuanworld_mirror_tpu.ops import projection as jp
from hunyuanworld_mirror_tpu.ops import rasterizer as jrast
from hunyuanworld_mirror_tpu.ops import tiles as jtiles
from hunyuanworld_mirror_tpu_torch.ops import cameras as pc
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as pbin
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat
from hunyuanworld_mirror_tpu_torch.ops import tiles as ptiles

W, H, TILE, MPT, TPG = 64, 48, 16, 512, 9
TW, TH = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
KNOBS = dict(calc_compensations=True, radius_clip=1.0, eps2d=0.2, near_plane=3.0,
             far_plane=5.5)


def _scene(seed=1, n=120, c=2):
    return _random_scene(np.random.default_rng(seed), n=n, c=c)


def _jax(a):
    return [jnp.asarray(x) for x in a]


def _port(a):
    return [t(x) for x in a]


@functools.lru_cache(maxsize=None)
def _modes_reference():
    """One JAX render in RGB+D with every knob -> (colours, alpha)."""
    out, alpha, _ = jrast.rasterize(*_jax(_scene()), W, H, render_mode="RGB+D",
                                    impl="jax", max_per_tile=MPT, **KNOBS)
    return np.asarray(out), np.asarray(alpha)


@pytest.mark.parametrize("route", ["flat", "dense", "camera_batch"])
def test_render_modes_match_jax(route):
    ref, ref_alpha = _modes_reference()
    kw = dict(impl="jax" if route == "dense" else "pallas",
              camera_batch=route == "camera_batch", max_per_tile=MPT, device="cpu",
              **KNOBS)
    want = {"RGB": ref[..., :3], "D": ref[..., 3:], "RGB+D": ref}
    for mode in prast.RENDER_MODES:
        out, alpha, meta = prast.rasterize(*_port(_scene()), W, H, render_mode=mode, **kw)
        close(alpha, ref_alpha, 1e-4, err_msg=mode)
        if mode in want:
            close(out, want[mode], 1e-4, err_msg=mode)
        else:                                    # ED: the accumulated depth / alpha
            d, _, _ = prast.rasterize(*_port(_scene()), W, H,
                                      render_mode=mode.replace("ED", "D"), **kw)
            close(out, prast.depth_by_alpha(d, alpha), 0)
            close(out[..., :-1], want[mode.replace("ED", "D")][..., :-1], 1e-4)
        assert out.shape[-1] == {"RGB": 3, "D": 1, "ED": 1}.get(mode, 4)
    loose, _, meta_l = prast.rasterize(*_port(_scene()), W, H, render_mode="RGB+D",
                                       tight_radius=False, **kw)
    close(loose, ref, 1e-4)
    assert int((meta_l["radii"] > 0).sum()) >= int((meta["radii"] > 0).sum()) > 0


UT_ROUTES = {
    "fisheye": dict(camera_model=jc.FISHEYE,
                    radial_coeffs=np.array([[0.05, -0.01]] * 2, np.float32)),
    "opencv": dict(radial_coeffs=np.array([[0.1, 0.02, 0.0]] * 2, np.float32),
                   tangential_coeffs=np.array([[0.01, -0.005]] * 2, np.float32)),
    "ftheta": dict(camera_model=jc.FTHETA, ftheta_coeffs=FTHETA),
    "rolling_shutter": dict(rolling_shutter=jc.SHUTTER_TOP_TO_BOTTOM),
}


def _ut_kw(name, side, viewmats):
    kw = dict(UT_ROUTES[name])
    if name == "rolling_shutter":
        vm_rs = viewmats.copy()
        vm_rs[:, 0, 3] += 0.3
        kw["viewmats_rs"] = vm_rs
    out = {}
    for k, v in kw.items():
        if k == "ftheta_coeffs":
            out[k] = v if side == "j" else pc.FThetaParams(*v)
        elif isinstance(v, np.ndarray):
            out[k] = jnp.asarray(v) if side == "j" else t(v)
        else:
            out[k] = v
    return out


def _ut_scene(name):
    scene = list(_scene(2))
    if name == "ftheta":
        scene[6] = scene[6].copy()
        scene[6][:, 0, 0] = scene[6][:, 1, 1] = 1.0
    return scene


@pytest.mark.parametrize("name", list(UT_ROUTES))
def test_ut_routes_match_jax(name):
    scene = _ut_scene(name)
    means, quats, scales, opac, colors, viewmats, Ks = scene
    jkw = _ut_kw(name, "j", viewmats)
    ut = {k: v for k, v in jkw.items() if k != "radial_coeffs" and k != "tangential_coeffs"
          and k != "viewmats_rs"}
    per = {k: jkw[k][:1] for k in ("radial_coeffs", "tangential_coeffs", "viewmats_rs")
           if k in jkw}

    @jax.jit
    def jax_lists(m, q, sc, op, colr, vm, K):
        # camera 0's JAX UT projection, binned and blended by JAX's dense route
        proj = jc.fully_fused_projection_ut(m, jp.quat_scale_to_covar(q, sc), vm, K,
                                            W, H, **ut, **per)
        m2d, con, dep = proj.means2d[0], proj.conics[0], proj.depths[0]
        rad = jtiles.opacity_tight_radii(proj.radii[0], op)
        col = jnp.concatenate([colr, dep[:, None]], -1)
        bins = jtiles.bin_gaussians(m2d, rad, dep, TILE, TW, TH, TPG, MPT,
                                    conic_test=jtiles.conic_test_planes(con, op))
        return (m2d, con, dep, rad, col, bins.counts,
                *jrast.rasterize_binned_jax(m2d, con, col, op, bins, W, H, TILE))

    m2d, con, dep, rad, col, counts, ref, ref_a = jax_lists(
        *_jax((means, quats, scales, opac, colors, viewmats[:1], Ks[:1])))
    # the port's flat and dense routes on the same lists
    pm, pcn, pcol, pop, pdep = (t(x) for x in (m2d, con, col, opac, dep))
    prad = torch.tensor(np.asarray(rad))
    fb = prast.bin_splats(pm, pcn, pcol, pop, prad, pdep, TILE, TW, TH, TPG, MPT, False)
    img, alpha = pflat.rasterize_flat(fb.packed, fb.starts, fb.counts, W, H, TILE, 4, False)
    close(img, ref, 1e-4, err_msg="flat")
    close(alpha, ref_a, 1e-4)
    db = ptiles.bin_gaussians(pm, prad, pdep, TILE, TW, TH, TPG, MPT,
                              conic_test=ptiles.conic_test_planes(pcn, pop))
    img_d, alpha_d = pbin.rasterize_binned(pm, pcn, pcol, pop, db, W, H, TILE)
    close(img_d, ref, 1e-4, err_msg="dense")
    close(alpha_d, ref_a, 1e-4)
    np.testing.assert_array_equal(np_(db.counts), np.asarray(counts))
    assert int(fb.counts.sum()) == int(np.asarray(counts).sum()) > 0
    # end to end, both routes, against the JAX render
    out_j, alpha_j, meta_j = jrast.rasterize(*_jax(scene), W, H, impl="jax",
                                             max_per_tile=MPT, **jkw)
    for impl in ("pallas", "jax"):
        out, alpha, meta = prast.rasterize(*_port(scene), W, H, impl=impl,
                                           max_per_tile=MPT, device="cpu",
                                           **_ut_kw(name, "p", viewmats))
        d = np.abs(np.concatenate([np_(out) - np.asarray(out_j),
                                   np_(alpha) - np.asarray(alpha_j)], -1)).max(-1)
        assert np.isfinite(np_(out)).all()
        assert d.max() <= 5e-2 and np.mean(d > 1e-3) <= 0.01, (impl, d.max(),
                                                               np.mean(d > 1e-3))
        assert float(alpha.max()) > 0.1
        np.testing.assert_array_equal(np_(meta["n_dropped"]), np.asarray(meta_j["n_dropped"]))


def _weights(out):
    return torch.linspace(0, 1, out.numel()).reshape(out.shape)


def _jax_grads(scene, **kw):
    means, quats, scales, opac, colors, viewmats, Ks = _jax(scene)

    def loss(m, q, s, o, c):
        out, alpha, _ = jrast.rasterize(m, q, s, o, c, viewmats, Ks, W, H, impl="jax",
                                        max_per_tile=MPT, render_mode="RGB", **kw)
        w = jnp.linspace(0, 1, out.size).reshape(out.shape)
        return jnp.sum(out * w) + jnp.sum(alpha)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        means, quats, scales, opac, colors)]


def _port_grads(scene, **kw):
    params = [t(x).requires_grad_(True) for x in scene[:5]]
    out, alpha, _ = prast.rasterize(*params, *_port(scene[5:]), W, H, max_per_tile=MPT,
                                    render_mode="RGB", device="cpu", **kw)
    (torch.sum(out * _weights(out)) + alpha.sum()).backward()
    return [p.grad.numpy() for p in params]


def _close_grads(ours, ref, skip_rows=None):
    for name, g, r in zip(("means", "quats", "scales", "opacities", "colors"), ours, ref):
        assert np.isfinite(g).all(), name
        keep = np.ones(len(r), bool) if skip_rows is None else ~skip_rows
        assert np.abs(r[keep]).max() > 0, name
        close(g[keep], r[keep], 1e-3 * np.abs(r[keep]).max(), err_msg=name)


@pytest.mark.parametrize("name", ["fisheye", "opencv"])
def test_ut_gradient_matches_jax(name):
    scene = _ut_scene(name)
    scene = scene[:5] + [x[:1] for x in scene[5:]]
    one = {k: (v[:1] if k in ("radial_coeffs", "tangential_coeffs") else v)
           for k, v in UT_ROUTES[name].items()}
    _close_grads(_port_grads(scene, **{k: t(v) if isinstance(v, np.ndarray) else v
                                       for k, v in one.items()}),
                 _jax_grads(scene, **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                      else v for k, v in one.items()}))


@pytest.mark.parametrize("name", ["fisheye", "rolling_shutter"])
def test_eval3d_matches_jax(name):
    scene = _scene(3)
    out_j, alpha_j, _ = jrast.rasterize(*_jax(scene), W, H, impl="jax", max_per_tile=MPT,
                                        with_eval3d=True, **_ut_kw(name, "j", scene[5]))
    out, alpha, meta = prast.rasterize(*_port(scene), W, H, max_per_tile=MPT,
                                       with_eval3d=True, device="cpu",
                                       **_ut_kw(name, "p", scene[5]))
    close(out, out_j, 1e-4)
    close(alpha, alpha_j, 1e-4)
    assert float(alpha.max()) > 0.1 and int(meta["n_isects"].sum()) > 0
    if name == "fisheye":
        one = list(scene[:5]) + [x[:1] for x in scene[5:]]
        kw = dict(camera_model=jc.FISHEYE, with_eval3d=True)
        ref = _jax_grads(one, **kw)
        nan_rows = ~np.isfinite(ref[1]).all(-1) | ~np.isfinite(ref[2]).all(-1)
        assert nan_rows.sum() <= 1
        _close_grads(_port_grads(one, **kw), ref, skip_rows=nan_rows)
    with pytest.raises(ValueError, match="abs_tap"):
        prast.rasterize(*_port(scene), W, H, with_eval3d=True, device="cpu",
                        abs_tap=torch.zeros(len(scene[0]), 2, requires_grad=True))
    with pytest.raises(ValueError, match="render_mode"):
        prast.rasterize(*_port(scene), W, H, render_mode="RGBD", device="cpu")


def test_rasterize_to_indices_matches_jax():
    means, quats, scales, opac, _, viewmats, Ks = _scene(4)
    args = (means, quats, scales, opac, viewmats, Ks)
    kw = dict(k=5, max_per_tile=MPT, eps2d=0.25, near_plane=2.0)
    ids_j, w_j = jrast.rasterize_to_indices(*_jax(args), W, H, **kw)
    ids, w = prast.rasterize_to_indices(*_port(args), W, H, device="cpu", **kw)
    np.testing.assert_array_equal(np_(ids), np.asarray(ids_j))
    close(w, w_j, 1e-5)
    ids, w = np_(ids), np_(w)
    assert ids.dtype == np.int32 and ids.shape == (2, H, W, 5)
    assert ((ids == -1) == (w == 0)).all() and (ids < len(means)).all()
    assert (w >= 0).all() and (w <= 1).all() and (ids >= 0).any()
