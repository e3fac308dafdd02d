"""Port vs JAX on the MCMC strategy and selective Adam (training/mcmc.py):
compute_relocation (rtol 1e-6), mcmc_refine handed JAX's own source draw
(masks exact, rows within 1e-6), the source draw's distribution,
inject_position_noise handed JAX's normal draws (1e-6), SelectiveAdam over
5 updates with zeroed rows against the JAX transform (parameters and
moments within 1e-6), and a short MCMC run held by its invariants: each
refine grows the live count by exactly min(floor(0.05 n_alive), free
slots), the slot count stays, the loss falls."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_train_opt import W, H, _scene
from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.training import mcmc as jm
from hunyuanworld_mirror_tpu_torch.training import mcmc as pm
from hunyuanworld_mirror_tpu_torch.training import splat_opt as popt

KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh", "alive")


def _raw(seed, N=64, n_alive=40, sh_k=1):
    """A fixed-capacity raw dict: n_alive live slots of mixed opacity
    (some at or below 0.005, so dying), the rest free."""
    rng = np.random.default_rng(seed)
    alive = np.zeros(N, np.float32)
    alive[:n_alive] = 1.0
    op = rng.uniform(0.001, 0.9, N).astype(np.float32)
    op[:6] = rng.uniform(0.001, 0.004, 6)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    return {"means": rng.normal(size=(N, 3)).astype(np.float32),
            "log_scales": rng.uniform(-5, -2, (N, 3)).astype(np.float32),
            "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
            "opacity_logits": np.log(op / (1 - op)).astype(np.float32),
            "sh": rng.normal(size=(N, sh_k, 3)).astype(np.float32),
            "alive": alive}


def test_compute_relocation_matches_jax():
    rng = np.random.default_rng(0)
    op = rng.uniform(0.01, 0.99, 64).astype(np.float32)
    scales = rng.uniform(0.001, 0.1, (64, 3)).astype(np.float32)
    ratios = rng.integers(1, 60, 64).astype(np.int32)      # past n_max too
    op_j, sc_j = jm.compute_relocation(jnp.asarray(op), jnp.asarray(scales),
                                       jnp.asarray(ratios))
    op_p, sc_p = pm.compute_relocation(t(op), t(scales), torch.tensor(ratios))
    close(op_p, op_j, 0.0, rtol=1e-6)
    close(sc_p, sc_j, 1e-9, rtol=1e-6)


def _jax_sampled(raw, key, min_opacity=0.005):
    """The source ids jm.mcmc_refine draws with `key` (its own expression)."""
    opac = jax.nn.sigmoid(jnp.asarray(raw["opacity_logits"]))
    healthy = (jnp.asarray(raw["alive"]) > 0.5) & (opac > min_opacity)
    logits = jnp.log(jnp.maximum(jnp.where(healthy, opac, 0.0), 1e-30))
    return np.array(jax.random.categorical(key, logits, shape=(len(opac),)))


@pytest.mark.parametrize("n_alive", [40, 62])     # growth by 5%, or all free slots
def test_mcmc_refine_matches_jax_given_its_draw(n_alive):
    raw = _raw(1, n_alive=n_alive, sh_k=4)
    key = jax.random.PRNGKey(3)
    out_j = jm.mcmc_refine({k: jnp.asarray(v) for k, v in raw.items()}, key)
    sampled = _jax_sampled(raw, key)
    out_p = pm.mcmc_refine({k: t(v) for k, v in raw.items()},
                           torch.as_tensor(sampled, dtype=torch.long))
    alive0 = raw["alive"] > 0.5
    grow = min(int(np.floor(np.float32(alive0.sum()) * np.float32(0.05))),
               int((~alive0).sum()))
    np.testing.assert_array_equal(np_(out_p["alive"]), np.asarray(out_j["alive"]))
    assert int(np_(out_p["alive"]).sum()) == int(alive0.sum()) + grow
    for k in KEYS:
        close(out_p[k], out_j[k], 1e-6, rtol=1e-6, err_msg=k)


def test_sample_sources_draws_by_opacity():
    """Only live splats above min_opacity are drawn, in proportion to
    opacity (2e-2 absolute on the frequencies over 25,600 draws); with none
    such every slot is drawn."""
    raw = {k: t(v) for k, v in _raw(2).items()}
    gen = torch.Generator().manual_seed(0)
    ids = torch.cat([pm.sample_sources(raw, 0.005, gen) for _ in range(400)])
    op = torch.sigmoid(raw["opacity_logits"])
    p = torch.where((raw["alive"] > 0.5) & (op > 0.005), op, 0.0)
    freq = torch.bincount(ids, minlength=64).float() / len(ids)
    assert bool((freq[p == 0] == 0).all())
    close(freq, p / p.sum(), 2e-2)
    raw["alive"].zero_()
    assert len(torch.unique(pm.sample_sources(raw, 0.005, gen))) > 32


def test_inject_position_noise_matches_jax_given_its_draws():
    raw = _raw(4)
    raw["opacity_logits"][::3] = -6.0                  # near-dead: they move
    key = jax.random.PRNGKey(5)
    out_j = jm.inject_position_noise({k: jnp.asarray(v) for k, v in raw.items()},
                                     key, 0.7)
    noise = np.asarray(jax.random.normal(key, raw["means"].shape))
    raw_p = {k: t(v) for k, v in raw.items()}
    means = raw_p["means"]
    out_p = pm.inject_position_noise(raw_p, 0.7, noise=t(noise))
    assert out_p["means"] is means                     # in place
    moved = np.abs(np_(out_p["means"]) - raw["means"]).max(-1) > 1e-4
    assert moved.any() and not moved[raw["alive"] < 0.5].any()
    close(out_p["means"], out_j["means"], 1e-6, rtol=1e-6)


def test_selective_adam_matches_jax():
    """5 updates of three parameter shapes, some rows' gradients zero each
    step (invisible: values and moments kept)."""
    rng = np.random.default_rng(6)
    shapes = {"a": (20, 3), "b": (20,), "c": (20, 4, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jm.selective_adam(5e-3)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(pj)
    pt = {k: t(v).requires_grad_(True) for k, v in params.items()}
    opt = pm.SelectiveAdam([{"params": [pt[k]]} for k in shapes], lr=5e-3)
    for step in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** rng.uniform(-4, 1)
                 for k, s in shapes.items()}
        for g in grads.values():
            g[rng.uniform(size=20) < 0.4] = 0.0
            g[step] = 0.0
        up, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, pj)
        pj = optax.apply_updates(pj, up)
        for k in shapes:
            pt[k].grad = t(grads[k])
        before = {k: np_(v).copy() for k, v in pt.items()}
        opt.step()
        for k, g in grads.items():
            hidden = ~(g != 0).reshape(20, -1).any(1)
            np.testing.assert_array_equal(np_(pt[k])[hidden], before[k][hidden])
    for k in shapes:
        close(pt[k], pj[k], 1e-6, err_msg=k)
        close(opt.state[pt[k]]["exp_avg"], state.mu[k], 1e-7, rtol=1e-5, err_msg=k)
        close(opt.state[pt[k]]["exp_avg_sq"], state.nu[k], 1e-9, rtol=1e-5, err_msg=k)


def test_mcmc_optimize_splats_invariants():
    """16 steps, refines at 4, 9 and 14: the live count grows by exactly
    min(floor(0.05 n_alive), free) at each refine and not otherwise, the
    slots stay, every loss is finite and the last is below the first."""
    splats, c2w, K, _, _ = _scene(n=60)
    target = dict(splats, sh=splats["sh"] + 0.4)
    raw_t = popt._raw_from_splats({k: t(v) for k, v in target.items()}, 60)
    with torch.no_grad():
        gt, _, _ = popt.render_splats(raw_t, popt.cam_utils.se3_inverse(t(c2w)),
                                      t(K), W, H, popt.SplatOptConfig(max_per_tile=512))
    cfg = popt.SplatOptConfig(iters=16, refine_start=3, refine_every=5,
                              refine_stop=16, max_per_tile=512, strategy="mcmc",
                              use_selective_adam=True, lr_sh=1e-2, noise_lr=5e3)
    steps = []
    popt.optimize_splats(splats, np_(gt[..., :3]), c2w, K, cfg, log_fn=lambda s: None,
                         device="cpu", on_step=steps.append)
    alive = [60] + [int((s["raw"]["alive"] > 0.5).sum()) for s in steps]
    for i, s in enumerate(steps):
        want = min(int(np.floor(np.float32(alive[i]) * np.float32(0.05))),
                   120 - alive[i]) if s["refined"] else 0
        assert alive[i + 1] - alive[i] == want, (s["it"], alive)
    assert [s["it"] for s in steps if s["refined"]] == [4, 9, 14]
    assert all(s["raw"]["means"].shape == (120, 3) for s in steps)
    losses = [float(s["loss"]) for s in steps]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
