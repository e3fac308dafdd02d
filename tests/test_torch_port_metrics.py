"""The port's utils/metrics.py against the JAX package's, on the CPU.

Bands: the host half (Umeyama, sim(3), ATE, RPE) is the same numpy f64 on
both sides and is held at 1e-12. The nearest-neighbour reduction evaluates
|q|^2 + |r|^2 - 2 q·r in f32 on both sides, but XLA sums |q|^2 with FMAs:
each squared distance is held within 8 f32 ulps of |q|^2 + max |r|^2 of
JAX's. That cancellation, not the port, sets how far accuracy /
completeness sit from the exact answer (about 3e-5 relative for the
aligned clouds here), so they are held to JAX's own f32 error: no further
from the f64 brute-force statistic than three times JAX's distance from
it, or 1e-5 relative. The median is jnp.median's exactly, the midpoint of
an even count included; nvs_metrics' PSNR at 1e-4 absolute, SSIM and LPIPS
at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.training import checkpoint as jckpt
from hunyuanworld_mirror_tpu.utils import metrics as jm
from hunyuanworld_mirror_tpu_torch import convert
from hunyuanworld_mirror_tpu_torch.utils import lpips as plpips
from hunyuanworld_mirror_tpu_torch.utils import metrics as pm

EPS = float(np.finfo(np.float32).eps)


def _poses(seed, n):
    """n camera-to-world poses: random rotations (QR), translations."""
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = q * np.sign(np.diag(r))[None] * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.normal(size=3)
    return out


def _clouds(seed, n, m, noise=0.01):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(n, 3)).astype(np.float32)
    gt = (pred[:m] if m <= n else rng.normal(size=(m, 3)))
    gt = (gt + rng.normal(size=gt.shape) * noise).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_and_sim3_match_jax(with_scale):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(50, 3))
    dst = 1.7 * src @ _poses(2, 1)[0, :3, :3].T + 0.3 + rng.normal(size=src.shape) * 1e-3
    sj, Rj, tj = jm.umeyama_alignment(src, dst, with_scale)
    sp, Rp, tp = pm.umeyama_alignment(src, dst, with_scale)
    np.testing.assert_allclose([sp], [sj], rtol=1e-12)
    np.testing.assert_allclose(Rp, Rj, atol=1e-12)
    np.testing.assert_allclose(tp, tj, atol=1e-12)
    np.testing.assert_allclose(pm.apply_sim3(src, sp, Rp, tp),
                               jm.apply_sim3(src, sj, Rj, tj), atol=1e-12)
    with pytest.raises(ValueError):
        pm.umeyama_alignment(src, dst[:-1])


@pytest.mark.parametrize("n,align", [(6, True), (6, False), (2, True)])
def test_ate_rmse_matches_jax(n, align):
    pred, gt = _poses(3, n), _poses(4, n)
    np.testing.assert_allclose(pm.ate_rmse(pred, gt, align), jm.ate_rmse(pred, gt, align),
                               rtol=1e-12)


@pytest.mark.parametrize("delta", [1, 2])
def test_rpe_matches_jax(delta):
    pred, gt = _poses(5, 7), _poses(6, 7)
    np.testing.assert_allclose(pm.rpe(pred, gt, delta), jm.rpe(pred, gt, delta),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,chunk", [(1000, 256), (300, 4096)])
def test_nn_dist_chunked_matches_jax(m, chunk):
    q, r = _clouds(7, m, 700, noise=0.05)
    dj = np_(jm._nn_dist_chunked(jnp.asarray(q), jnp.asarray(r), chunk=chunk))
    dp = np_(pm._nn_dist_chunked(t(q), t(r), chunk=chunk))
    assert dp.shape == (m,)
    scale = (q ** 2).sum(-1) + (r ** 2).sum(-1).max()
    assert np.all(np.abs(dp ** 2 - dj ** 2) <= 8 * EPS * scale)


@pytest.mark.parametrize("x", [[1.0, 2.0, 3.0, 4.0], [3.0, 1.0, 2.0],
                               np.random.default_rng(8).normal(size=1000),
                               np.random.default_rng(9).normal(size=1001)])
def test_median_is_jnp_median(x):
    x = np.asarray(x, np.float32)
    assert float(pm._median(torch.from_numpy(x))) == float(jnp.median(jnp.asarray(x)))


def _reduction_inputs(pred, gt, align, max_points, seed):
    """The two clouds the JAX function hands its reduction: aligned (equal
    shapes only), then subsampled by its draws."""
    pred = np.asarray(pred, np.float32).reshape(-1, 3)
    gt = np.asarray(gt, np.float32).reshape(-1, 3)
    if align and pred.shape == gt.shape:
        pred = jm.apply_sim3(pred, *jm.umeyama_alignment(pred, gt)).astype(np.float32)
    rng = np.random.default_rng(seed)
    if len(pred) > max_points:
        pred = pred[rng.choice(len(pred), max_points, replace=False)]
    if len(gt) > max_points:
        gt = gt[rng.choice(len(gt), max_points, replace=False)]
    return pred, gt


def _exact(q, r, statistic):
    """The f64 statistic of q's nearest-neighbour distances to r."""
    q, r = q.astype(np.float64), r.astype(np.float64)
    d = np.sqrt(((q[:, None] - r[None]) ** 2).sum(-1).min(1))
    return {"mean": np.mean, "median": np.median}[statistic](d)


@pytest.mark.parametrize("statistic", ["mean", "median"])
@pytest.mark.parametrize("n,m,align,max_points", [
    (900, 900, False, 600), (900, 900, True, 601), (900, 900, True, 65536),
    (500, 800, True, 400)])
def test_accuracy_completeness_matches_jax(statistic, n, m, align, max_points):
    """Equal shapes (so --align aligns) subsampled to an even and an odd
    count and not subsampled; unequal shapes (no alignment)."""
    pred, gt = _clouds(10, n, m)
    pred = pred * 1.3 + 0.2          # a sim(3) away, for the alignment
    kw = dict(align=align, max_points=max_points, statistic=statistic, seed=3)
    q, r = _reduction_inputs(pred, gt, align, max_points, seed=3)
    exact = np.array([_exact(q, r, statistic), _exact(r, q, statistic)])
    err_jax = np.abs(np.array(jm.accuracy_completeness(pred, gt, **kw)) - exact)
    err = np.abs(np.array(pm.accuracy_completeness(pred, gt, **kw)) - exact)
    assert np.all(err <= np.maximum(3 * err_jax, 1e-5 * exact)), (err, err_jax, exact)


def _images(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(2, 40, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    return a, b


def _lpips_params(seed):
    """Random LPIPS weights as the JAX pytree (numpy leaves)."""
    return convert.lpips_to_jax_params(plpips.init_random(torch.Generator().manual_seed(seed)))


def test_nvs_metrics_lpips_from_params_or_module(monkeypatch):
    """With the JAX pytree (numpy leaves) or the port's module, "lpips" is
    added and equals JAX's; without weights it is absent on both sides."""
    monkeypatch.delenv("WM_LPIPS_WEIGHTS", raising=False)
    a, b = _images(12)
    params = _lpips_params(1)
    mj = jm.nvs_metrics(a, b, lpips_params=params)
    assert set(mj) == {"psnr", "ssim", "lpips"}
    for lp in (params, plpips.as_module(params)):
        mp = pm.nvs_metrics(a, b, lpips_params=lp)
        assert set(mp) == set(mj)
        close(mp["psnr"], mj["psnr"], 1e-4)
        close(mp["ssim"], mj["ssim"], 1e-5)
        close(mp["lpips"], mj["lpips"], 0.0, rtol=1e-5)
    assert set(pm.nvs_metrics(t(a[0]), t(b[0]))) == set(jm.nvs_metrics(a[0], b[0])) \
        == {"psnr", "ssim"}


def test_nvs_metrics_lpips_from_env_weights(tmp_path, monkeypatch):
    """$WM_LPIPS_WEIGHTS naming an npz the JAX package saved: both sides add
    the same "lpips"; a name of no file keeps the gate closed on both."""
    a, b = _images(13)
    params = _lpips_params(2)
    jckpt.save_params(str(tmp_path / "lpips.npz"), params)
    monkeypatch.setenv("WM_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    mj, mp = jm.nvs_metrics(a, b), pm.nvs_metrics(a, b)
    assert set(mp) == set(mj) == {"psnr", "ssim", "lpips"}
    close(mp["lpips"], mj["lpips"], 0.0, rtol=1e-5)
    monkeypatch.setenv("WM_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert set(pm.nvs_metrics(a, b)) == set(jm.nvs_metrics(a, b)) == {"psnr", "ssim"}


def test_nvs_metrics_under_grad_builds_no_graph():
    """The metrics run under no_grad whatever the caller's grad mode, so an
    image that requires grad leaves no graph behind in the floats."""
    a, b = _images(14)
    pa = t(a).requires_grad_()
    params = _lpips_params(3)
    out = pm.nvs_metrics(pa, b, lpips_params=params)
    assert all(isinstance(v, float) for v in out.values())
    assert np.isfinite(np_(torch.tensor(list(out.values())))).all()
