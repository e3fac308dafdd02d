"""Port vs JAX on the training render path: the entry -> splat ids of the
flat binning (bit-equal), K2's training planes and K3's row layout, the
whole rasterizer's gradients against jax.grad of the JAX rasterize
(atol = rtol = 1e-3, the JAX suite's own band), and the repaired defaults
of the port's rasterize. K3 against the JAX package's own K3 is in
test_torch_port_train_k3.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import _random_scene
from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.ops import projection as jproj
from hunyuanworld_mirror_tpu.ops import rasterizer as jrast
from hunyuanworld_mirror_tpu.ops import tiles as jtiles
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat
from hunyuanworld_mirror_tpu_torch.ops import tiles as ptiles

W, H, TILE = 64, 48, 16
GRAD_TOL = 1e-3


def _projected(n, seed=42):
    """A random scene projected by the JAX package, as numpy planes."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(seed), n=n, c=1)
    cov = jproj.quat_scale_to_covar_planes(jnp.asarray(quats), jnp.asarray(scales))
    pj = jproj.fully_fused_projection(jnp.asarray(means), cov, jnp.asarray(viewmats),
                                      jnp.asarray(Ks), W, H)
    rad = np.asarray(jtiles.opacity_tight_radii(pj.radii[0], jnp.asarray(opac)))
    col = np.concatenate([colors, np.asarray(pj.depths[0])[:, None]], -1)
    return dict(m2d=np.asarray(pj.means2d[0]), con=np.asarray(pj.conics[0]),
                col=col, op=opac, rad=rad, dep=np.asarray(pj.depths[0]))


def test_bin_gaussians_packed_with_ids_exact():
    s = _projected(400)
    values = [t(s["m2d"][:, 0]), t(s["m2d"][:, 1]), t(s["op"])]
    bins = ptiles.bin_gaussians_packed(
        t(s["m2d"]), torch.tensor(s["rad"]), t(s["dep"]), values, TILE, 4, 3,
        9, 1024, with_ids=True,
        conic_test=ptiles.conic_test_planes(t(s["con"]), t(s["op"])))
    ref = jtiles.bin_gaussians_packed(
        jnp.asarray(s["m2d"]), jnp.asarray(s["rad"]), jnp.asarray(s["dep"]),
        [jnp.asarray(np_(v)) for v in values], TILE, 4, 3, 9, 1024,
        with_ids=True, conic_test=jtiles.conic_test_planes(
            jnp.asarray(s["con"]), jnp.asarray(s["op"])))
    assert bins.gauss_ids.dtype == torch.int32
    np.testing.assert_array_equal(np_(bins.gauss_ids), np.asarray(ref.gauss_ids))
    np.testing.assert_array_equal(np_(bins.starts), np.asarray(ref.starts))
    np.testing.assert_array_equal(np_(bins.counts), np.asarray(ref.counts))


def test_k2_state_planes_and_k3_entry_rows():
    """K2's training planes (final T, last kept entry) agree with a direct
    replay, and K3's per-entry rows scatter to its per-splat rows."""
    s = _projected(150)
    bins = prast.bin_splats(t(s["m2d"]), t(s["con"]), t(s["col"]), t(s["op"]),
                            torch.tensor(s["rad"]), t(s["dep"]), TILE, 4, 3,
                            9, 1024, False, with_ids=True)
    img, alpha, t_fin, last = pflat.rasterize_flat(
        bins.packed, bins.starts, bins.counts, W, H, TILE, 4, False,
        with_state=True)
    assert t_fin.shape == (H, W) and last.dtype == torch.int32
    # alpha = 1 - T_final up to rounding; last is -1 exactly where nothing blended
    close(alpha[..., 0], 1.0 - t_fin, 1e-5)
    assert torch.equal(last < 0, alpha[..., 0] == 0)
    rng = np.random.default_rng(1)
    entry, splat = pflat.rasterize_flat_bwd(
        bins.packed, bins.starts, bins.counts, bins.gauss_ids, 150,
        t(rng.normal(size=(H, W, 4))), t(rng.normal(size=(H, W, 1))), t_fin,
        last, W, H, TILE, 4)
    assert entry.shape == (12, bins.packed.shape[1]) and splat.shape == (12, 150)
    ref = np.zeros((12, 150), np.float32)
    np.add.at(ref.T, np_(bins.gauss_ids), np_(entry).T)
    close(splat, ref, 1e-5)
    # absgrad dominates the signed mean grads, row by row
    assert bool((splat[10:12] >= splat[0:2].abs() - 1e-5).all())


@pytest.mark.parametrize("sh", [False, True])
def test_rasterize_grads_match_jax(sh):
    """d(loss)/d(means, wxyz quats, scales, opacities, colours or SH) of the
    port's rasterize against jax.grad of the JAX rasterize (impl="jax")."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(11), n=100, c=2)
    if sh:
        colors = ((colors - 0.5) / 0.28209479177387814)[:, None, :]
    rng = np.random.default_rng(3)
    v_col = rng.normal(size=(2, H, W, 4)).astype(np.float32)
    v_alpha = rng.normal(size=(2, H, W, 1)).astype(np.float32)
    kw = dict(max_per_tile=512, max_tiles_per_gauss=9, quat_order="wxyz")

    def loss_j(m, q, sc, op, col):
        out, a, _ = jrast.rasterize(m, q, sc, op, col, jnp.asarray(viewmats),
                                    jnp.asarray(Ks), W, H, impl="jax",
                                    render_mode="RGB+ED", **kw)
        return jnp.sum(out * v_col) + jnp.sum(a * v_alpha)

    arrs = (means, quats, scales, opac, colors)
    ref = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in arrs))
    ins = [t(a).requires_grad_(True) for a in arrs]
    out, alpha, meta = prast.rasterize(*ins, t(viewmats), t(Ks), W, H,
                                       device="cpu", **kw)
    ((out * t(v_col)).sum() + (alpha * t(v_alpha)).sum()).backward()
    for name, x, want in zip(("means", "quats", "scales", "opacities", "colors"),
                             ins, ref):
        assert torch.isfinite(x.grad).all(), name
        close(x.grad, want, GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
    assert meta["radii"].shape == (2, 100, 2) and meta["depths"].shape == (2, 100)
    assert meta["means2d"].shape == (2, 100, 2)


def test_rasterize_defaults_match_jax():
    """With defaults only, the port's rasterize bins with the JAX function's
    caps (max_per_tile 1024, max_tiles_per_gauss 9): on a scene whose splats
    cover more than 4 tiles, n_dropped and the render agree."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(8), n=120, c=2)
    scales = np.random.default_rng(9).uniform(0.25, 0.45, size=(120, 3)
                                              ).astype(np.float32)
    arrs = (means, quats, scales, opac, colors, viewmats, Ks)
    out, alpha, meta = prast.rasterize(*(t(a) for a in arrs), W, H, device="cpu")
    out_j, alpha_j, meta_j = jrast.rasterize(*(jnp.asarray(a) for a in arrs), W, H,
                                             impl="pallas", render_mode="RGB+ED")
    _, _, meta_4 = prast.rasterize(*(t(a) for a in arrs), W, H, device="cpu",
                                   max_tiles_per_gauss=4)
    # the scene does exercise the fault: 4 tiles per splat drop more
    assert int(meta_4["n_dropped"].sum()) > int(np.asarray(meta_j["n_dropped"]).sum())
    np.testing.assert_array_equal(np_(meta["n_dropped"]),
                                  np.asarray(meta_j["n_dropped"]))
    close(out, out_j, 1e-4)
    close(alpha, alpha_j, 1e-4)


def test_entry_points_refuse_cpu_without_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    from hunyuanworld_mirror_tpu_torch import splat_trainer
    z = torch.zeros(1, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prast.rasterize(z, torch.zeros(1, 4), z, torch.zeros(1), z,
                        torch.eye(4)[None], torch.eye(3)[None], 16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        splat_trainer.run("missing", "missing")
