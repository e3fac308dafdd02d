"""Port vs JAX on the splat trainer's options (training/splat_opt.py,
training/bilagrid.py, utils/rotation.py, utils/metrics.py):
rot6d_to_matrix and apply_cam_deltas (1e-6), the pose AdamW with its lr
decay against optax.adamw(optax.exponential_decay(...)) over 10 updates
(1e-6), the bilateral grid's slice and TV loss with their gradients
(1e-6), one train step with pose deltas, bilateral grids and an injected
background, and one on rasterizer_impl="jax" (loss, updated parameters and
Adam moments in test_torch_port_train_opt.py's bands), selective Adam
leaving the rows no pixel touched bit for bit as they were, the cameras'
gradient with dead slots parked on a camera (finite, where
the JAX step's is NaN), optimize_splats with pose, grids, in-loop eval and
TensorBoard, the cameras' and grids' moments and lr step kept across a
refine, and nvs_metrics (1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_train_opt import KEYS, W, H, _raw_np, _scene
from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.training import bilagrid as jbil
from hunyuanworld_mirror_tpu.training import splat_opt as jopt
from hunyuanworld_mirror_tpu.utils import camera as jcam
from hunyuanworld_mirror_tpu.training import checkpoint as jckpt
from hunyuanworld_mirror_tpu.utils import lpips as jlpips
from hunyuanworld_mirror_tpu.utils import metrics as jmetrics
from hunyuanworld_mirror_tpu.utils import rotation as jrot
from hunyuanworld_mirror_tpu_torch.training import bilagrid as pbil
from hunyuanworld_mirror_tpu_torch.training import splat_opt as popt
from hunyuanworld_mirror_tpu_torch.utils import metrics as pmetrics
from hunyuanworld_mirror_tpu_torch.utils import rotation as prot


def test_rot6d_and_cam_deltas_match_jax():
    rng = np.random.default_rng(0)
    d6 = rng.normal(size=(5, 6)).astype(np.float32)
    close(prot.rot6d_to_matrix(t(d6)), jrot.rot6d_to_matrix(jnp.asarray(d6)), 1e-6)
    _, c2w, _, _, _ = _scene()
    vm = np.asarray(jcam.se3_inverse(jnp.asarray(c2w)))
    deltas = (rng.normal(size=(2, 9)) * 0.05).astype(np.float32)
    close(popt.apply_cam_deltas(t(vm), t(deltas)),
          jopt.apply_cam_deltas(jnp.asarray(vm), jnp.asarray(deltas)), 1e-6)
    close(popt.apply_cam_deltas(t(vm), torch.zeros(2, 9)), vm, 1e-6)


def test_pose_adamw_schedule_matches_optax():
    """lr 1e-2 * 0.01^(t / 10) at update t (counted from 0), decoupled
    weight decay 0.1, over 10 updates."""
    cfg = popt.SplatOptConfig(iters=10, pose_opt=True, pose_opt_lr=1e-2,
                              pose_opt_reg=0.1)
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(3, 9)).astype(np.float32)
    raw = {"cam_deltas": t(x0)}
    [(opt, sched)] = popt.make_aux_optimizers(cfg, raw)
    sched_j = optax.exponential_decay(1e-2, 10, decay_rate=0.01)
    tx = optax.adamw(sched_j, weight_decay=0.1)
    xj = jnp.asarray(x0)
    state = tx.init(xj)
    for step in range(10):
        close(opt.param_groups[0]["lr"], sched_j(step), 0.0, rtol=1e-6)
        g = rng.normal(size=(3, 9)).astype(np.float32)
        up, state = tx.update(jnp.asarray(g), state, xj)
        xj = optax.apply_updates(xj, up)
        raw["cam_deltas"].grad = t(g)
        opt.step()
        sched.step()
        close(raw["cam_deltas"], xj, 1e-6, err_msg=f"update {step}")


def test_bilagrid_slice_and_tv_match_jax():
    """Values and gradients (in the grids and the colours) of
    slice_image_grids, slice_grids at one grid and at per-row grids, and
    the TV loss."""
    rng = np.random.default_rng(2)
    g = (np.asarray(jbil.init_bilateral_grids(3, 5, 4, 3))
         + rng.normal(size=(3, 12, 3, 4, 5)) * 0.1).astype(np.float32)
    img = rng.uniform(-0.1, 1.1, size=(3, 9, 11, 3)).astype(np.float32)
    xy = rng.uniform(size=(3, 7, 2)).astype(np.float32)
    close(pbil.init_bilateral_grids(3, 5, 4, 3), jbil.init_bilateral_grids(3, 5, 4, 3), 0.0)

    def jax_f(G, I):
        a = jbil.slice_image_grids(G, I)
        b, m = jbil.slice_grids(G, jnp.asarray(xy[0]), I[0, 0, :7], 1)
        c, _ = jbil.slice_grids(G, jnp.asarray(xy), I[:, 0, :7],
                                jnp.arange(3)[:, None])
        return (jnp.sum(a ** 2) + jnp.sum(b * m[..., 0]) + jnp.sum(c ** 3)
                + jbil.total_variation_loss(G)), (a, b, c)

    (val_j, outs_j), grads_j = jax.jit(jax.value_and_grad(
        jax_f, argnums=(0, 1), has_aux=True))(jnp.asarray(g), jnp.asarray(img))
    G = t(g).requires_grad_(True)
    I = t(img).requires_grad_(True)
    a = pbil.slice_image_grids(G, I)
    b, m = pbil.slice_grids(G, t(xy[0]), I[0, 0, :7], 1)
    c, _ = pbil.slice_grids(G, t(xy), I[:, 0, :7], torch.arange(3)[:, None])
    val = torch.sum(a ** 2) + torch.sum(b * m[..., 0]) + torch.sum(c ** 3) \
        + pbil.total_variation_loss(G)
    val.backward()
    for o, oj in zip((a, b, c), outs_j):
        close(o, oj, 1e-6)
    close(pbil.total_variation_loss(G), jbil.total_variation_loss(jnp.asarray(g)), 1e-7)
    close(val, val_j, 1e-4, rtol=1e-6)
    close(G.grad, grads_j[0], 1e-5, rtol=1e-5)
    close(I.grad, grads_j[1], 1e-5, rtol=1e-5)


def _step_pair(cfg_kw, bkgd_key=None, cap=80, scene_scale=0.05):
    """One step from the same raw dict on both sides -> (JAX raw, state,
    loss), (port raw, optimizers, loss)."""
    splats, c2w, K, imgs, _ = _scene(n=60)
    cfg_j = jopt.SplatOptConfig(max_per_tile=512, **cfg_kw)
    cfg_p = popt.SplatOptConfig(max_per_tile=512, **cfg_kw)
    raw_j = jopt._raw_from_splats({k: jnp.asarray(v) for k, v in splats.items()}, cap)
    rng = np.random.default_rng(3)
    if cfg_p.pose_opt:
        raw_j["cam_deltas"] = jnp.asarray((rng.normal(size=(2, 9)) * 0.01).astype(np.float32))
    if cfg_p.use_bilateral_grid:
        raw_j["bil_grids"] = jbil.init_bilateral_grids(2, *cfg_p.bilateral_grid_shape) \
            + jnp.asarray((rng.normal(size=(2, 12, 2, 4, 4)) * 0.05).astype(np.float32))
    tx = jopt.make_optimizer(cfg_j, scene_scale)
    state = tx.init(raw_j)
    vm = jcam.se3_inverse(jnp.asarray(c2w))
    step_j = jopt.make_train_step(cfg_j, tx, W, H, scene_scale)
    out_j = step_j(raw_j, state, vm, jnp.asarray(K), jnp.asarray(imgs), None, bkgd_key)

    raw_p = {k: t(np.asarray(v)) for k, v in raw_j.items()}
    opt = popt.make_optimizer(cfg_p, raw_p, scene_scale)
    aux = popt.make_aux_optimizers(cfg_p, raw_p)
    bkgd = (t(np.asarray(jax.random.uniform(bkgd_key, (1, 1, 1, 3))))
            if bkgd_key is not None else None)
    step_p = popt.make_train_step(cfg_p, W, H, scene_scale, device="cpu")
    loss_p, _, _ = step_p(raw_p, opt, t(np.asarray(vm)), t(K), t(imgs), aux=aux,
                          bkgd=bkgd)
    return out_j, (raw_p, opt, aux, loss_p)


def _adam_mu(state, k):
    return state.inner_states[k].inner_state[0].mu[k]


@pytest.mark.parametrize("cfg_kw", [
    dict(pose_opt=True, use_bilateral_grid=True, random_bkgd=True,
         bilateral_grid_shape=(4, 4, 2)),
    dict(rasterizer_impl="jax"),
], ids=["pose_grid_bkgd", "impl_jax"])
def test_train_step_matches_jax(cfg_kw):
    """Loss, every updated parameter (cam_deltas and bil_grids too) and the
    first moments, i.e. 0.1 x the gradients, of every group."""
    key = jax.random.PRNGKey(4) if cfg_kw.get("random_bkgd") else None
    (raw_j, state, loss_j, _), (raw_p, opt, aux, loss_p) = _step_pair(cfg_kw, key)
    close(loss_p, loss_j, 1e-5)
    extra = [k for k in ("cam_deltas", "bil_grids") if k in raw_p]
    assert all(np.isfinite(np.asarray(raw_j[k])).all() for k in KEYS + tuple(extra))
    for k in KEYS + tuple(extra):
        close(raw_p[k], raw_j[k], 1e-5, err_msg=k)
    for k in popt.PARAM_KEYS:
        close(opt.state[raw_p[k]]["exp_avg"], _adam_mu(state, k), 1e-6, rtol=1e-3,
              err_msg=k)
    for (o, _), k in zip(aux, extra):
        close(o.state[raw_p[k]]["exp_avg"], _adam_mu(state, k), 1e-6, rtol=1e-3,
              err_msg=k)
    if extra:
        assert float(torch.abs(raw_p["bil_grids"].grad).sum()) > 0
        assert float(torch.abs(raw_p["cam_deltas"].grad).sum()) > 0


def test_selective_adam_keeps_untouched_rows():
    """With no regulariser, rows whose splats no pixel blends (behind both
    cameras, and the dead slots) keep their values bit for bit through a
    step; the rows in view move."""
    splats, c2w, K, imgs, _ = _scene(n=60)
    splats["means"][:10, 2] = -3.0
    cfg = popt.SplatOptConfig(max_per_tile=512, use_selective_adam=True)
    raw = popt._raw_from_splats({k: t(v) for k, v in splats.items()}, 80)
    before = {k: np_(raw[k]).copy() for k in popt.PARAM_KEYS}
    opt = popt.make_optimizer(cfg, raw)
    step = popt.make_train_step(cfg, W, H, device="cpu")
    step(raw, opt, popt.cam_utils.se3_inverse(t(c2w)), t(K), t(imgs))
    hidden = np.r_[0:10, 60:80]
    for k in popt.PARAM_KEYS:
        np.testing.assert_array_equal(np_(raw[k])[hidden], before[k][hidden], err_msg=k)
    assert np.abs(np_(raw["sh"])[10:60] - before["sh"][10:60]).max() > 0


def test_pose_opt_with_dead_slots_on_a_camera():
    """Camera 0 sits at the origin, where the dead slots are parked (the
    inference CLI's first camera does): the JAX step's camera gradient is
    NaN there (0/0 in the dead slots' projection). The port's is finite and
    equal to the one without dead slots (1e-6)."""
    splats, c2w, K, imgs, _ = _scene(n=60)
    vm = popt.cam_utils.se3_inverse(t(c2w))
    cfg = popt.SplatOptConfig(max_per_tile=512, pose_opt=True)
    grads = []
    for cap in (60, 80):
        raw = popt._raw_from_splats({k: t(v) for k, v in splats.items()}, cap)
        raw["cam_deltas"] = torch.zeros(2, 9)
        opt = popt.make_optimizer(cfg, raw)
        aux = popt.make_aux_optimizers(cfg, raw)
        popt.make_train_step(cfg, W, H, device="cpu")(raw, opt, vm, t(K), t(imgs),
                                                      aux=aux)
        grads.append(raw["cam_deltas"].grad)
    assert bool(torch.isfinite(grads[1]).all()) and float(grads[1].abs().max()) > 0
    close(grads[1], grads[0], 1e-6, rtol=1e-5)


def test_optimize_splats_pose_grid_eval(tmp_path):
    """3 steps with pose deltas, bilateral grids, the eval every step on the
    training views and TensorBoard every step: finite splats, c2w_opt the
    cameras after the final deltas, eval rows (step, PSNR, SSIM), the
    events; a held-out set at another resolution is refused."""
    from hunyuanworld_mirror_tpu_torch.training.tb_writer import read_scalars
    splats, c2w, K, imgs, _ = _scene(n=60)
    cfg = popt.SplatOptConfig(iters=3, refine_start=1000, max_per_tile=512,
                              pose_opt=True, use_bilateral_grid=True,
                              bilateral_grid_shape=(4, 4, 2), eval_every=1,
                              tb_every=1, tb_save_image=True)
    steps = []
    out = popt.optimize_splats(splats, imgs, c2w, K, cfg, log_fn=lambda s: None,
                               device="cpu", eval_data=(imgs, c2w, K),
                               tb_logdir=str(tmp_path), on_step=steps.append)
    assert all(np.isfinite(v).all() for v in out.values())
    deltas = steps[-1]["raw"]["cam_deltas"].detach()
    vm = popt.cam_utils.se3_inverse(t(c2w))
    close(out["c2w_opt"], popt.cam_utils.se3_inverse(
        popt.apply_cam_deltas(vm, deltas)), 1e-6)
    assert float(deltas.abs().max()) > 0
    np.testing.assert_array_equal(out["eval_history"][:, 0], [1, 2, 3])
    assert (out["eval_history"][:, 1] > 5).all() and (out["eval_history"][:, 2] > 0).all()
    [events] = list(tmp_path.glob("events.out.tfevents.*"))
    tags = [set(v) for _, v in read_scalars(str(events))]
    assert tags.count({"eval/psnr", "eval/ssim"}) == 3
    assert tags.count({"train/loss", "train/num_GS"}) == 3
    with pytest.raises(ValueError, match="resolution"):
        popt.optimize_splats(splats, imgs, c2w, K, cfg, device="cpu",
                             eval_data=(imgs[:, :16], c2w, K))


def test_refine_keeps_camera_and_grid_moments(monkeypatch):
    """Across two refines (MCMC at 1 and 3), the pose and grid optimizers
    are the ones made at the start, still holding raw's tensors, with 5
    updates' state and the lr schedule at step 5."""
    made = []
    make = popt.make_aux_optimizers
    monkeypatch.setattr(popt, "make_aux_optimizers",
                        lambda cfg, raw: made.append(make(cfg, raw)) or made[-1])
    splats, c2w, K, imgs, _ = _scene(n=60)
    cfg = popt.SplatOptConfig(iters=5, refine_start=0, refine_every=2,
                              max_per_tile=512, strategy="mcmc", pose_opt=True,
                              use_bilateral_grid=True, bilateral_grid_shape=(4, 4, 2))
    steps = []
    popt.optimize_splats(splats, imgs, c2w, K, cfg, log_fn=lambda s: None,
                         device="cpu", on_step=steps.append)
    assert [s["it"] for s in steps if s["refined"]] == [1, 3]
    [[(cam_opt, sched), (grid_opt, _)]] = made
    raw = steps[-1]["raw"]
    assert cam_opt.param_groups[0]["params"][0] is raw["cam_deltas"]
    assert grid_opt.param_groups[0]["params"][0] is raw["bil_grids"]
    assert int(cam_opt.state[raw["cam_deltas"]]["step"]) == 5
    assert int(grid_opt.state[raw["bil_grids"]]["step"]) == 5
    close(cam_opt.param_groups[0]["lr"], 1e-3 * 0.01 ** (5 / 5), 0.0, rtol=1e-6)


def test_nvs_metrics_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    a = rng.uniform(size=(2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    monkeypatch.delenv("WM_LPIPS_WEIGHTS", raising=False)
    for pa, pb in ((a, b), (a[0], b[0])):
        mj, mp = jmetrics.nvs_metrics(pa, pb), pmetrics.nvs_metrics(pa, pb)
        assert set(mp) == set(mj) == {"psnr", "ssim"}
        close(mp["psnr"], mj["psnr"], 1e-4)
        close(mp["ssim"], mj["ssim"], 1e-5)
    close(pmetrics.nvs_metrics(t(a), t(b))["psnr"], jmetrics.nvs_metrics(a, b)["psnr"],
          1e-4)
    # with LPIPS weights (JAX-saved, named by $WM_LPIPS_WEIGHTS) both add it
    jckpt.save_params(str(tmp_path / "w.npz"), jlpips.init_random(jax.random.PRNGKey(0)))
    monkeypatch.setenv("WM_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    mj, mp = jmetrics.nvs_metrics(a, b), pmetrics.nvs_metrics(a, b)
    assert set(mp) == set(mj) == {"psnr", "ssim", "lpips"}
    close(mp["lpips"], mj["lpips"], 0.0, rtol=1e-5)


def test_config_rejects_2dgs_and_unknown_values():
    # 2DGS trains (ops/gs2d.py) but has no absgrad tap: "auto" is mean3d
    with pytest.raises(ValueError, match="absgrad"):
        popt.SplatOptConfig(mode="2dgs", densify_signal="absgrad")
    assert popt.SplatOptConfig(mode="2dgs").resolved_signal("cuda") == "mean3d"
    for kw in (dict(strategy="x"), dict(rasterizer_impl="x"), dict(mode="x")):
        with pytest.raises(ValueError):
            popt.SplatOptConfig(**kw)
    assert popt.SplatOptConfig(rasterizer_impl="jax").resolved_signal("cuda") == "mean3d"
    assert popt.SplatOptConfig().resolved_signal("cuda") == "absgrad"
    assert popt.SplatOptConfig().resolved_signal("cpu") == "mean3d"
