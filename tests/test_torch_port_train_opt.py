"""Port vs JAX on splat optimisation: the NVS losses (atol 1e-5), Adam
(torch.optim.Adam against optax.adam over a few steps on the same grads,
atol 1e-6), one train step with depth loss and both regularisers (loss,
updated raw dict, Adam moments and densify signal), refine with the same
normal draws (exact up to f32 rounding), a short optimize_splats, and the
CLI twin on a small inference directory."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.training import losses as jlosses
from hunyuanworld_mirror_tpu.training import splat_opt as jopt
from hunyuanworld_mirror_tpu.utils import camera as jcam
from hunyuanworld_mirror_tpu_torch import splat_trainer
from hunyuanworld_mirror_tpu_torch.io import ply as pply
from hunyuanworld_mirror_tpu_torch.training import losses as plosses
from hunyuanworld_mirror_tpu_torch.training import splat_opt as popt

W = H = 32
KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh", "alive")


def _scene(seed=0, n=60):
    """Splats in front of two cameras 32 px wide (quats wxyz)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    means[:, 2] += 2.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    splats = {"means": means, "quats": quats,
              "scales": rng.uniform(0.02, 0.08, size=(n, 3)).astype(np.float32),
              "opacities": rng.uniform(0.3, 0.9, size=n).astype(np.float32),
              "sh": (rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32)}
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2w[1, 0, 3] = 0.1
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32),
                (2, 1, 1))
    imgs = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    depths = rng.uniform(1.5, 2.5, size=(2, H, W)).astype(np.float32)
    return splats, c2w, K, imgs, depths


def _raw_np(raw):
    return {k: np_(raw[k]) for k in KEYS}


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(2, 20, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    close(plosses.ssim(t(a), t(b)), jlosses.ssim(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    close(plosses.photometric_loss(t(a), t(b), 0.2),
          jlosses.photometric_loss(jnp.asarray(a), jnp.asarray(b), 0.2), 1e-5)
    close(plosses.psnr(t(a), t(b)), jlosses.psnr(jnp.asarray(a), jnp.asarray(b)), 1e-4)


def test_adam_matches_optax():
    """torch.optim.Adam's bias-corrected step is optax.adam's
    m_hat / (sqrt(v_hat) + eps) on the same grads."""
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(50, 3)).astype(np.float32)
    grads = rng.normal(size=(4, 50, 3)).astype(np.float32) * 10.0 ** rng.uniform(
        -4, 1, size=(4, 1, 1))
    tx = optax.adam(5e-3)
    xj = jnp.asarray(x0)
    state = tx.init(xj)
    xt = t(x0).requires_grad_(True)
    opt = torch.optim.Adam([xt], lr=5e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        up, state = tx.update(jnp.asarray(g), state, xj)
        xj = optax.apply_updates(xj, up)
        xt.grad = t(g)
        opt.step()
    close(xt, xj, 1e-6)
    close(opt.state[xt]["exp_avg_sq"], state[0].nu, 1e-6, rtol=1e-5)


def test_train_step_matches_jax():
    """One step from the same raw dict, depth loss and both regularisers on,
    with dead slots in the array."""
    splats, c2w, K, imgs, depths = _scene(n=60)
    cfg_j = jopt.SplatOptConfig(max_per_tile=512, depth_loss=True,
                                opacity_reg=0.01, scale_reg=0.01)
    cfg_p = popt.SplatOptConfig(max_per_tile=512, depth_loss=True,
                                opacity_reg=0.01, scale_reg=0.01)
    cap, scene_scale = 80, 0.05
    raw_j = jopt._raw_from_splats({k: jnp.asarray(v) for k, v in splats.items()}, cap)
    tx = jopt.make_optimizer(cfg_j, scene_scale)
    state = tx.init(raw_j)
    step_j = jopt.make_train_step(cfg_j, tx, W, H, scene_scale)
    vm = jcam.se3_inverse(jnp.asarray(c2w))
    raw_j2, state, loss_j, g2d_j = step_j(raw_j, state, vm, jnp.asarray(K),
                                          jnp.asarray(imgs), jnp.asarray(depths))

    raw_p = {k: t(v) for k, v in _raw_np(raw_j).items()}
    opt = popt.make_optimizer(cfg_p, raw_p, scene_scale)
    step_p = popt.make_train_step(cfg_p, W, H, scene_scale, device="cpu")
    loss_p, g2d_p, meta = step_p(raw_p, opt, t(np.asarray(vm)), t(K), t(imgs),
                                 t(depths))
    assert cfg_p.resolved_signal("cpu") == jopt.SplatOptConfig().resolved_signal()
    close(loss_p, loss_j, 1e-5)
    close(g2d_p, g2d_j, 1e-5, rtol=1e-3)
    assert meta["n_dropped"].shape == (2,)
    for k in KEYS:
        close(raw_p[k], raw_j2[k], 1e-5, err_msg=k)
    for k in popt.PARAM_KEYS:
        adam = state.inner_states[k].inner_state[0]
        st = opt.state[raw_p[k]]
        close(st["exp_avg"], adam.mu[k], 1e-6, rtol=1e-3, err_msg=k)
        close(st["exp_avg_sq"], adam.nu[k], 1e-9, rtol=1e-3, err_msg=k)


def test_train_step_absgrad_signal():
    """The card's densify signal, absgrad: per splat, the norm of K3's AbsGS
    rows summed over cameras, in half-image units, zero on dead rows; the
    update is the mean3d step's."""
    splats, c2w, K, imgs, _ = _scene(n=60)
    vm = popt.cam_utils.se3_inverse(t(c2w))
    out = {}
    for signal in ("absgrad", "mean3d"):
        cfg = popt.SplatOptConfig(max_per_tile=512, densify_signal=signal)
        raw = popt._raw_from_splats({k: t(v) for k, v in splats.items()}, 80)
        opt = popt.make_optimizer(cfg, raw, 1.0)
        step = popt.make_train_step(cfg, W, H, 1.0, device="cpu")
        loss, g2d, _ = step(raw, opt, vm, t(K), t(imgs))
        out[signal] = (loss, g2d, raw["means"].detach())
    close(out["absgrad"][0], out["mean3d"][0], 0.0)
    close(out["absgrad"][2], out["mean3d"][2], 0.0)
    g2d = out["absgrad"][1]
    assert bool((g2d[60:] == 0).all()) and bool((g2d[:60] > 0).any())
    raw0 = popt._raw_from_splats({k: t(v) for k, v in splats.items()}, 80)
    tap = torch.zeros(80, 2, requires_grad=True)
    colors, _, _ = popt.rasterizer.rasterize(
        *popt._activate(raw0), vm, t(K), W, H, max_per_tile=512,
        quat_order="wxyz", abs_tap=tap, device="cpu")
    plosses.photometric_loss(colors[..., :3], t(imgs), 0.2).backward()
    ref = torch.linalg.norm(tap.grad * torch.tensor([W / 2, H / 2]), dim=-1)
    close(g2d[:60], ref[:60], 1e-6, rtol=1e-6)


def _refine_raw(cap=64, n=40):
    """Live splats of mixed scale and opacity (splits, duplicates, prunes)
    in a larger array (free slots)."""
    rng = np.random.default_rng(4)
    splats = {"means": rng.normal(size=(n, 3)).astype(np.float32),
              "quats": rng.normal(size=(n, 4)).astype(np.float32),
              "scales": rng.uniform(0.002, 0.03, size=(n, 3)).astype(np.float32),
              "opacities": rng.uniform(0.0, 0.05, size=n).astype(np.float32),
              "sh": rng.normal(size=(n, 4, 3)).astype(np.float32)}
    grads = rng.uniform(0, 0.0004, size=cap).astype(np.float32)
    grads[:5] = grads[5]            # ties among the candidates
    return splats, grads


@pytest.mark.parametrize("cap", [64, 48])
def test_refine_matches_jax(cap):
    splats, grads = _refine_raw(cap)
    cfg = jopt.SplatOptConfig()
    raw_j = jopt._raw_from_splats({k: jnp.asarray(v) for k, v in splats.items()}, cap)
    key = jax.random.PRNGKey(7)
    out_j = jopt.refine(raw_j, jnp.asarray(grads), cfg, key)
    noise = np.asarray(jax.random.normal(key, (cap, 3)))
    out_p = popt.refine({k: t(v) for k, v in _raw_np(raw_j).items()}, t(grads),
                        popt.SplatOptConfig(), t(noise))
    n_pruned = int((splats["opacities"] <= cfg.prune_opacity).sum())
    n_alive = int(np.asarray(out_j["alive"]).sum())
    assert n_pruned > 0 and n_alive > len(splats["means"]) - n_pruned  # clones
    np.testing.assert_array_equal(np_(out_p["alive"]), np.asarray(out_j["alive"]))
    for k in KEYS:
        assert out_p[k].shape == tuple(out_j[k].shape)
        close(out_p[k], out_j[k], 1e-6, rtol=1e-6, err_msg=k)


def test_optimize_splats_matches_jax_without_refine():
    splats, c2w, K, imgs, _ = _scene(n=60)
    kw = dict(iters=3, refine_start=1000, max_per_tile=512)
    out_j = jopt.optimize_splats(splats, imgs, c2w, K, jopt.SplatOptConfig(**kw),
                                 log_fn=lambda s: None)
    out_p = popt.optimize_splats(splats, imgs, c2w, K, popt.SplatOptConfig(**kw),
                                 log_fn=lambda s: None, device="cpu")
    for k in ("means", "quats", "scales", "opacities", "sh"):
        close(out_p[k], out_j[k], 1e-5, err_msg=k)


def test_optimize_splats_with_refine():
    """Three refines: the loss falls and the arrays keep their capacity.
    On the CPU the signal is mean3d, whose units are not grow_grad2d's:
    the threshold is raised so that a few splats, not all, are cloned."""
    splats, c2w, K, _, _ = _scene(n=60)
    target = dict(splats, sh=splats["sh"] + 0.4)
    raw_t = popt._raw_from_splats({k: t(v) for k, v in target.items()}, 60)
    with torch.no_grad():
        gt, _, _ = popt.render_splats(raw_t, popt.cam_utils.se3_inverse(t(c2w)),
                                      t(K), W, H, popt.SplatOptConfig(max_per_tile=512))
    cfg = popt.SplatOptConfig(iters=16, refine_start=3, refine_every=5,
                              refine_stop=16, max_per_tile=512,
                              grow_grad2d=0.02, lr_sh=1e-2)
    steps = []
    out = popt.optimize_splats(splats, np_(gt[..., :3]), c2w, K, cfg,
                               log_fn=lambda s: None, device="cpu",
                               on_step=steps.append)
    losses = [float(s["loss"]) for s in steps]
    assert [s["it"] for s in steps if s["refined"]] == [4, 9, 14]
    assert all(s["raw"]["means"].shape == (120, 3) for s in steps)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert len(out["means"]) > 60          # grew into free slots


def test_splat_trainer_run_writes_ply(tmp_path):
    splats, c2w, K, imgs, depths = _scene(n=50)
    d = tmp_path / "infer"
    d.mkdir()
    op = splats["opacities"]
    pply.save_gs_ply(d / "gaussians.ply", splats["means"], splats["scales"],
                     splats["quats"], splats["sh"][:, 0], np.log(op / (1 - op)),
                     scale_percentile=1.0)
    pply.save_camera_params(c2w, K, d)
    for s in range(2):
        pply.save_depth_npy(d / f"depth_{s:03d}.npy", depths[s])
    np.save(tmp_path / "images.npy", imgs)
    out = splat_trainer.run(str(d), str(tmp_path / "images.npy"), iters=2,
                            size=W, max_per_tile=512, depth_loss=True,
                            device="cpu", log_fn=lambda s: None)
    back = pply.read_ply(d / "gaussians_opt.ply")
    assert len(back["x"]) == len(out["means"]) == 50
    np.testing.assert_allclose(back["x"], out["means"][:, 0], atol=1e-6)
    # --gs2d trains the same directory as surfels
    out2 = splat_trainer.main([str(d), str(tmp_path / "images.npy"), "--iters", "1",
                               "--size", str(W), "--max-per-tile", "512", "--gs2d"],
                              device="cpu")
    assert len(pply.read_ply(d / "gaussians_opt.ply")["x"]) == len(out2["means"]) == 50
