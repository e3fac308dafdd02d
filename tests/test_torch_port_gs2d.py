"""Port vs JAX on 2D Gaussian splatting (ops/gs2d.py) and its training
(`SplatOptConfig(mode="2dgs")`, the trainer's --gs2d), the same seeded
numpy inputs on both sides. The JAX functions are plain XLA; so are the
port's, in plain PyTorch.

- fully_fused_projection_2dgs, XYZW and WXYZ quats: radii equal, means2d
  1e-4 px, ray transforms and normals 1e-5 (rtol 1e-5);
- rasterize_2dgs on a pinhole (RGB+ED, SH colours), a fisheye and an
  OpenCV camera (RGB+D): colours, alphas and normals within 1e-4;
- its gradient on the pinhole camera against jax.grad: 1e-3 x max |grad|
  per parameter;
- rasterize_to_indices_2dgs (pinhole, fisheye): ids equal (-1 where the
  weight is 0), weights atol 1e-5, rtol 1e-4 (the homography's cross
  product and divisions round differently: 4.5e-5 relative measured);
- one mode="2dgs" training step against the JAX step from the same raw
  dict: loss 1e-5, the updated parameters 1e-5, the densify signal (mean3d,
  as in JAX) 1e-5 / rtol 1e-3; with pose_opt (camera 0 at the dead slots'
  origin) the same loss and a finite camera step;
- the trainer CLI with --gs2d end to end on the CPU on the tiny preset's
  inference directory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import _random_scene
from torch_port_helpers import close, np_, t, uniform
from hunyuanworld_mirror_tpu.ops import gs2d as jg
from hunyuanworld_mirror_tpu.training import splat_opt as jopt
from hunyuanworld_mirror_tpu.utils import camera as jcam
from hunyuanworld_mirror_tpu_torch import infer, splat_trainer
from hunyuanworld_mirror_tpu_torch.io import ply as pply
from hunyuanworld_mirror_tpu_torch.ops import gs2d as pg
from hunyuanworld_mirror_tpu_torch.training import splat_opt as popt

W, H, MPT = 64, 48, 512
RAD = np.array([[0.05, -0.01]] * 2, np.float32)
TANG = np.array([[0.01, -0.005]] * 2, np.float32)


def _scene(seed=1, n=120, c=2):
    return _random_scene(np.random.default_rng(seed), n=n, c=c)


def _jax(a):
    return [jnp.asarray(x) for x in a]


def _port(a):
    return [t(x) for x in a]


@pytest.mark.parametrize("quat_order", ["xyzw", "wxyz"])
def test_projection_2dgs_matches_jax(quat_order):
    means, quats, scales, _, _, viewmats, Ks = _scene(0)
    args = (means, quats, scales, viewmats, Ks)
    a = jg.fully_fused_projection_2dgs(*_jax(args), W, H, quat_order=quat_order)
    b = pg.fully_fused_projection_2dgs(*_port(args), W, H, quat_order=quat_order)
    np.testing.assert_array_equal(np_(b.radii), np.asarray(a.radii))
    assert int((np_(b.radii) > 0).all(-1).sum()) > 100
    close(b.means2d, a.means2d, 1e-4, rtol=1e-5)
    close(b.depths, a.depths, 1e-6)
    close(b.ray_transforms, a.ray_transforms, 1e-5, rtol=1e-5)
    close(b.normals, a.normals, 1e-5, rtol=1e-5)


CASES = {
    "pinhole_sh": dict(render_mode="RGB+ED", sh=True),
    "fisheye": dict(render_mode="RGB", camera_model="fisheye", radial_coeffs=RAD),
    "opencv": dict(render_mode="RGB+D", radial_coeffs=RAD, tangential_coeffs=TANG),
}


def _case_kw(name, side):
    kw = dict(CASES[name])
    kw.pop("sh", None)
    return {k: (v if not isinstance(v, np.ndarray) else
                (jnp.asarray(v) if side == "j" else t(v))) for k, v in kw.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_rasterize_2dgs_matches_jax(name):
    scene = list(_scene(2))
    extra = {}
    if CASES[name].get("sh"):
        scene[4] = ((scene[4] - 0.5) / 0.28209479177387814)[:, None, :]
        extra = dict(sh_degree=0)
    out_j, a_j, n_j = jg.rasterize_2dgs(*_jax(scene), W, H, max_per_tile=MPT,
                                        **_case_kw(name, "j"), **extra)
    out_p, a_p, n_p = pg.rasterize_2dgs(*_port(scene), W, H, max_per_tile=MPT,
                                        device="cpu", **_case_kw(name, "p"), **extra)
    assert out_p.shape == out_j.shape and n_p.shape == (2, H, W, 3)
    close(out_p, out_j, 1e-4)
    close(a_p, a_j, 1e-4)
    close(n_p, n_j, 1e-4)
    assert float(a_p.max()) > 0.1


def test_rasterize_2dgs_gradient_matches_jax():
    scene = _scene(3, c=1)
    vm, K = _jax(scene[5:])

    def loss(m, q, s, o, c):
        out, alpha, nrm = jg.rasterize_2dgs(m, q, s, o, c, vm, K, W, H, max_per_tile=MPT,
                                            render_mode="RGB")
        return (jnp.sum(out * jnp.linspace(0, 1, out.size).reshape(out.shape))
                + jnp.sum(alpha) + jnp.sum(nrm))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*_jax(scene[:5]))
    params = [t(x).requires_grad_(True) for x in scene[:5]]
    out, alpha, nrm = pg.rasterize_2dgs(*params, *_port(scene[5:]), W, H, max_per_tile=MPT,
                                        render_mode="RGB", device="cpu")
    (torch.sum(out * torch.linspace(0, 1, out.numel()).reshape(out.shape))
     + alpha.sum() + nrm.sum()).backward()
    for name, p, r in zip(("means", "quats", "scales", "opacities", "colors"), params, ref):
        r = np.asarray(r)
        assert torch.isfinite(p.grad).all() and np.abs(r).max() > 0, name
        close(p.grad, r, 1e-3 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("name", ["pinhole", "fisheye"])
def test_rasterize_to_indices_2dgs_matches_jax(name):
    means, quats, scales, opac, _, viewmats, Ks = _scene(4)
    args = (means, quats, scales, opac, viewmats, Ks)
    kw = {} if name == "pinhole" else dict(camera_model="fisheye")
    rad = {} if name == "pinhole" else dict(radial_coeffs=RAD)
    ids_j, w_j = jg.rasterize_to_indices_2dgs(*_jax(args), W, H, k=4, max_per_tile=MPT,
                                              **kw, **{k: jnp.asarray(v) for k, v in rad.items()})
    ids, w = pg.rasterize_to_indices_2dgs(*_port(args), W, H, k=4, max_per_tile=MPT,
                                          device="cpu", **kw,
                                          **{k: t(v) for k, v in rad.items()})
    np.testing.assert_array_equal(np_(ids), np.asarray(ids_j))
    close(w, w_j, 1e-5, rtol=1e-4)
    ids, w = np_(ids), np_(w)
    assert ((ids == -1) == (w == 0)).all() and (ids < len(means)).all()
    assert (w >= 0).all() and (w <= 1).all() and (ids >= 0).any()


KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh", "alive")


def test_train_step_2dgs_matches_jax():
    rng = np.random.default_rng(5)
    n, S, HW = 60, 2, 32
    means = (rng.normal(size=(n, 3)) * 0.3 + [0, 0, 2.0]).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    splats = {"means": means, "quats": quats,
              "scales": rng.uniform(0.02, 0.08, size=(n, 3)).astype(np.float32),
              "opacities": rng.uniform(0.3, 0.9, size=n).astype(np.float32),
              "sh": (rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32)}
    c2w = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    c2w[1, 0, 3] = 0.1
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32), (S, 1, 1))
    imgs = rng.uniform(size=(S, HW, HW, 3)).astype(np.float32)
    cfg_j = jopt.SplatOptConfig(max_per_tile=512, mode="2dgs", opacity_reg=0.01)
    cfg_p = popt.SplatOptConfig(max_per_tile=512, mode="2dgs", opacity_reg=0.01)
    assert cfg_p.resolved_signal("cuda") == cfg_j.resolved_signal() == "mean3d"
    cap, scene_scale = 80, 0.05
    raw_j = jopt._raw_from_splats({k: jnp.asarray(v) for k, v in splats.items()}, cap)
    tx = jopt.make_optimizer(cfg_j, scene_scale)
    step_j = jopt.make_train_step(cfg_j, tx, HW, HW, scene_scale)
    vm = jcam.se3_inverse(jnp.asarray(c2w))
    raw_j2, _, loss_j, g2d_j = step_j(raw_j, tx.init(raw_j), vm, jnp.asarray(K),
                                      jnp.asarray(imgs))
    raw_p = {k: t(np.asarray(raw_j[k])) for k in KEYS}
    opt = popt.make_optimizer(cfg_p, raw_p, scene_scale)
    step_p = popt.make_train_step(cfg_p, HW, HW, scene_scale, device="cpu")
    loss_p, g2d_p, meta = step_p(raw_p, opt, t(np.asarray(vm)), t(K), t(imgs))
    assert meta["normals"].shape == (S, HW, HW, 3)
    close(loss_p, loss_j, 1e-5)
    close(g2d_p, g2d_j, 1e-5, rtol=1e-3)
    for k in KEYS:
        close(raw_p[k], raw_j2[k], 1e-5, err_msg=k)
    # with pose_opt the dead slots (at the origin, camera 0's centre) render
    # at a live splat's mean on the 2DGS route too: the cameras' step is finite
    cfg_pose = popt.SplatOptConfig(max_per_tile=512, mode="2dgs", pose_opt=True,
                                   opacity_reg=0.01)
    raw_q = {k: t(np.asarray(raw_j[k])) for k in KEYS}
    raw_q["cam_deltas"] = torch.zeros(S, 9)
    opt = popt.make_optimizer(cfg_pose, raw_q, scene_scale)
    aux = popt.make_aux_optimizers(cfg_pose, raw_q)
    loss_q, _, _ = popt.make_train_step(cfg_pose, HW, HW, scene_scale, device="cpu")(
        raw_q, opt, t(np.asarray(vm)), t(K), t(imgs), aux=aux)
    close(loss_q, loss_j, 1e-5)
    deltas = raw_q["cam_deltas"].detach()
    assert torch.isfinite(deltas).all() and float(deltas.abs().sum()) > 0


def test_splat_trainer_gs2d_end_to_end(tmp_path):
    np.save(tmp_path / "views.npy", uniform(7, (2, 56, 56, 3)))
    out = tmp_path / "out"
    infer.main([str(tmp_path / "views.npy"), "-o", str(out), "--preset", "tiny",
                "--size", "56"], device="cpu")
    res = splat_trainer.run(str(out), str(tmp_path / "views.npy"), iters=2, size=56,
                            max_per_tile=512, gs2d=True, device="cpu",
                            log_fn=lambda s: None)
    back = pply.read_ply(out / "gaussians_opt.ply")
    assert len(back["x"]) == len(res["means"]) > 0
    assert np.isfinite(res["means"]).all() and np.isfinite(res["opacities"]).all()
