"""Port vs JAX on the three rasterizer variants: the camera-batched flat
forward (K2m: bin_gaussians_packed_multi, its plain blend, the
`camera_batch` route), the grouped flat forward (K5: group_windows, its
plain blend, the WM_RASTER_GROUP switch and its gradients) and the dense-bin
forward (K4: bin_gaussians, rasterize_binned_plain and its gradient, the
per-rank render of ops/distributed). The JAX Pallas kernels run in
interpret mode under jax.jit. Bands are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import _random_scene
from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.ops import distributed as jdist
from hunyuanworld_mirror_tpu.ops import projection as jproj
from hunyuanworld_mirror_tpu.ops import rasterizer as jrast
from hunyuanworld_mirror_tpu.ops import rasterizer_pallas as jrp
from hunyuanworld_mirror_tpu.ops import tiles as jtiles
from hunyuanworld_mirror_tpu_torch.ops import distributed as pdist
from hunyuanworld_mirror_tpu_torch.ops import projection as pproj
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as pbin
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat
from hunyuanworld_mirror_tpu_torch.ops import tiles as ptiles

W, H, TILE = 64, 48, 16
TW, TH = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
MPT = 512


def _projected(n, c, seed=42):
    """A random scene of n splats projected by the JAX package into c
    cameras, as numpy planes (C, N, ...), tight radii, colours + depth."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(seed), n=n, c=c)
    cov = jproj.quat_scale_to_covar_planes(jnp.asarray(quats), jnp.asarray(scales))
    pj = jproj.fully_fused_projection(jnp.asarray(means), cov, jnp.asarray(viewmats),
                                      jnp.asarray(Ks), W, H)
    op = np.broadcast_to(opac, (c, n)).copy()
    dep = np.asarray(pj.depths)
    return dict(m2d=np.asarray(pj.means2d), con=np.asarray(pj.conics),
                col=np.concatenate([np.broadcast_to(colors, (c, n, 3)), dep[..., None]], -1),
                op=op, rad=np.asarray(jtiles.opacity_tight_radii(pj.radii, jnp.asarray(op))),
                dep=dep)


def _saturated():
    """3000 near-opaque splats on one spot covering tiles 0, 1, 4 and 5:
    each of those tiles holds far more than MPT entries, so the window of
    tile 0's group ends before tile 1's segment starts."""
    n = 3000
    return dict(m2d=np.tile([[16.0, 16.0]], (1, n, 1)).astype(np.float32),
                con=np.tile([[0.05, 0.0, 0.05]], (1, n, 1)).astype(np.float32),
                col=np.concatenate([np.linspace(0, 1, n)[:, None] * np.ones((1, 3)),
                                    np.linspace(1, 2, n)[:, None]], -1
                                   ).astype(np.float32)[None],
                op=np.full((1, n), 0.05, np.float32),
                rad=np.full((1, n, 2), 12, np.int32),
                dep=np.linspace(1.0, 2.0, n).astype(np.float32)[None])


def _values(s, c=None, f16=False):
    """The f32 or f16-pair payload planes, of camera c or (C, N) for all."""
    m2d, con, col, op = (t(s[k] if c is None else s[k][c])
                         for k in ("m2d", "con", "col", "op"))
    if f16:
        pk = pflat.pack_f16_pairs
        return [m2d[..., 0], m2d[..., 1], pk(con[..., 0], con[..., 1]),
                pk(con[..., 2], op), pk(col[..., 0], col[..., 1]),
                pk(col[..., 2], col[..., 3])]
    return ([m2d[..., 0], m2d[..., 1], con[..., 0], con[..., 1], con[..., 2], op]
            + [col[..., i] for i in range(col.shape[-1])])


def _flat_bins(s, c, f16=False, mpt=MPT, tpg=9):
    """The port's flat list of camera c (bit-equal to the JAX binning,
    tests/test_torch_port_render.py)."""
    return ptiles.bin_gaussians_packed(
        t(s["m2d"][c]), torch.tensor(s["rad"][c]), t(s["dep"][c]),
        _values(s, c, f16), TILE, TW, TH, tpg, mpt,
        conic_test=ptiles.conic_test_planes(t(s["con"][c]), t(s["op"][c])))


# --- K2m: one sort and one launch for all cameras --------------------------------

def test_bin_gaussians_packed_multi_exact():
    """starts, counts, n_dropped and every packed row bit-equal."""
    s = _projected(300, 3)
    values = _values(s)
    bins = ptiles.bin_gaussians_packed_multi(
        t(s["m2d"]), torch.tensor(s["rad"]), t(s["dep"]), values, TILE, TW, TH,
        4, MPT, conic_test=ptiles.conic_test_planes(t(s["con"]), t(s["op"])))
    ref = jtiles.bin_gaussians_packed_multi(
        jnp.asarray(s["m2d"]), jnp.asarray(s["rad"]), jnp.asarray(s["dep"]),
        [jnp.asarray(np_(v)) for v in values], TILE, TW, TH, 4, MPT,
        conic_test=jtiles.conic_test_planes(jnp.asarray(s["con"]),
                                            jnp.asarray(s["op"])))
    for name in ("starts", "counts"):
        np.testing.assert_array_equal(np_(getattr(bins, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert int(bins.n_dropped) == int(ref.n_dropped) > 0
    np.testing.assert_array_equal(np_(bins.packed).view(np.int32),
                                  np.asarray(ref.packed).view(np.int32))
    # the full-size render's 4 cameras of 1089 tiles get 18 depth bits
    assert ptiles.multi_camera_depth_bits(4, 1089) == 18
    assert jtiles.multi_camera_depth_bits(4, 1089) == 18


def test_plain_k2m_matches_pallas_interpret():
    """rasterize_flat_multi (its plain version on the CPU) against the
    Pallas K2m, atol 1e-5 (the plain blend multiplies T out, the TPU kernel
    sums logs)."""
    s = _projected(300, 3)
    bins = ptiles.bin_gaussians_packed_multi(
        t(s["m2d"]), torch.tensor(s["rad"]), t(s["dep"]), _values(s), TILE, TW,
        TH, 9, MPT, conic_test=ptiles.conic_test_planes(t(s["con"]), t(s["op"])))
    img, alpha = pflat.rasterize_flat_multi(bins.packed, bins.starts, bins.counts,
                                            3, W, H, TILE, 4)
    fwd = jax.jit(lambda p, st, ct: jrp._forward_flat_multi(
        p, st, ct, 3, W, H, TILE, 4, MPT, interpret=True))
    img_j, a_j = fwd(*(jnp.asarray(np_(x)) for x in (bins.packed, bins.starts,
                                                      bins.counts)))
    assert img.shape == (3, H, W, 4) and alpha.shape == (3, H, W, 1)
    close(img, img_j, 1e-5)
    close(alpha, a_j, 1e-5)


@pytest.mark.parametrize("sh", [False, True])
def test_camera_batch_matches_per_camera(sh):
    """rasterize(camera_batch=True) against the per-camera route at the f32
    payload, atol 1e-5: at 12 tiles both keys keep 20 depth bits, so the
    blend order is the same; meta as the JAX branch returns it."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(5), n=300, c=3)
    if sh:
        colors = ((colors - 0.5) / 0.28209479177387814)[:, None, :]
    arrs = [t(a) for a in (means, quats, scales, opac, colors, viewmats, Ks)]
    kw = dict(max_per_tile=MPT, max_tiles_per_gauss=4, device="cpu")
    out, alpha, meta = prast.rasterize(*arrs, W, H, camera_batch=True, **kw)
    out_c, alpha_c, meta_c = prast.rasterize(*arrs, W, H, **kw)
    close(out, out_c, 1e-5)
    close(alpha, alpha_c, 1e-5)
    np.testing.assert_array_equal(np_(meta["n_isects"]), np_(meta_c["n_isects"]))
    np.testing.assert_array_equal(np_(meta["n_dropped"]),
                                  [int(meta_c["n_dropped"].sum())] * 3)
    with pytest.raises(ValueError, match="forward only"):
        prast.rasterize(arrs[0].clone().requires_grad_(True), *arrs[1:], W, H,
                        camera_batch=True, **kw)


# --- K5: G tiles to a block, segments clamped to the group windows ---------------

@pytest.mark.parametrize("case, group, chunk", [
    ("scene", 4, 512), ("scene", 5, 512), ("saturated", 4, 512),
    ("saturated", 5, 256)])
def test_group_windows_matches_jax(case, group, chunk, monkeypatch):
    """Clamped starts, counts and extra_dropped equal to _group_windows on
    the list as _forward_flat_grouped pads it; 5 does not divide 12 tiles;
    the saturated scene overflows a window."""
    monkeypatch.setenv("WM_RASTER_CHUNK", str(chunk))
    s = _projected(300, 1) if case == "scene" else _saturated()
    bins = _flat_bins(s, 0)
    M = bins.packed.shape[1]
    starts, counts, extra = pflat.group_windows(bins.starts, bins.counts, group,
                                                MPT, M)
    assert pflat.raster_chunk() == jrp._raster_chunk() == chunk
    Wc = group * (-(-MPT // chunk)) + 1
    M_pad = M + (-M) % chunk + max(0, Wc * chunk - M)
    s_j, c_j, _, e_j = jrp._group_windows(
        jnp.asarray(np_(bins.starts)), jnp.asarray(np_(bins.counts)), TW * TH,
        group, chunk, Wc, M_pad)
    np.testing.assert_array_equal(np_(starts), np.asarray(s_j)[:TW * TH])
    np.testing.assert_array_equal(np_(counts), np.asarray(c_j)[:TW * TH])
    assert int(extra) == int(e_j)
    assert (int(extra) > 0) == (case == "saturated")


@pytest.mark.parametrize("case", ["scene", "saturated"])
@pytest.mark.parametrize("payload_f16", [False, True])
def test_plain_k5_matches_pallas_interpret(case, payload_f16):
    """rasterize_flat_grouped (its plain version on the CPU) at G=4 against
    the Pallas K5, atol 1e-5, extra_dropped equal; where no window clamps
    it equals K2 on the same list exactly."""
    s = _projected(300, 1) if case == "scene" else _saturated()
    bins = _flat_bins(s, 0, payload_f16)
    starts, counts, extra = pflat.group_windows(bins.starts, bins.counts, 4, MPT,
                                                bins.packed.shape[1])
    img, alpha = pflat.rasterize_flat_grouped(bins.packed, starts, counts, W, H,
                                              TILE, 4, payload_f16, 4)
    fwd = jax.jit(lambda p, st, ct: jrp._forward_flat_grouped(
        p, st, ct, W, H, TILE, 4, MPT, G=4, interpret=True,
        f16_payload=payload_f16))
    img_j, a_j, e_j = fwd(*(jnp.asarray(np_(x)) for x in (bins.packed, bins.starts,
                                                           bins.counts)))
    close(img, img_j, 1e-5)
    close(alpha, a_j, 1e-5)
    assert int(extra) == int(e_j)
    img_k2, alpha_k2 = pflat.rasterize_flat(bins.packed, bins.starts, bins.counts,
                                            W, H, TILE, 4, payload_f16)
    if case == "scene":
        assert torch.equal(img, img_k2) and torch.equal(alpha, alpha_k2)
    else:  # the clamp cut tile 1's entries
        assert int(extra) > 0 and not torch.equal(img, img_k2)


def test_grouped_route_grads_match_ungrouped(monkeypatch):
    """rasterize's renders, n_dropped and gradients with WM_RASTER_GROUP=4
    equal to G=1 (no window overflows here: atol 0); on the saturated
    scene n_dropped gains the window clamp's entries."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(11), n=100, c=2)
    rng = np.random.default_rng(3)
    v_col = t(rng.normal(size=(2, H, W, 4)))
    v_alpha = t(rng.normal(size=(2, H, W, 1)))
    results = []
    for group in ("1", "4"):
        monkeypatch.setenv("WM_RASTER_GROUP", group)
        ins = [t(a).requires_grad_(True) for a in (means, quats, scales, opac, colors)]
        out, alpha, meta = prast.rasterize(*ins, t(viewmats), t(Ks), W, H,
                                           max_per_tile=MPT, quat_order="wxyz",
                                           device="cpu")
        ((out * v_col).sum() + (alpha * v_alpha).sum()).backward()
        results.append((out, alpha, meta["n_dropped"], [x.grad for x in ins]))
    (o1, a1, d1, g1), (o4, a4, d4, g4) = results
    assert torch.equal(o1, o4) and torch.equal(a1, a4) and torch.equal(d1, d4)
    for a, b in zip(g1, g4):
        close(a, b, 0.0)

    monkeypatch.setenv("WM_RASTER_GROUP", "4")
    s = _saturated()
    bins = _flat_bins(s, 0)
    _, _, extra = pflat.group_windows(bins.starts, bins.counts, 4, MPT,
                                      bins.packed.shape[1])
    (_, _), _, _, n_drop = prast.blend_flat(bins, W, H, TILE, 4, False, MPT)
    assert int(n_drop) == int(bins.n_dropped) + int(extra) > int(bins.n_dropped)


# --- K4: dense bins --------------------------------------------------------------

def _opaque_stack():
    """600 near-opaque splats on one spot: early stop must engage."""
    n = 600
    return dict(m2d=np.tile([[16.0, 16.0]], (n, 1)).astype(np.float32),
                con=np.tile([[0.5, 0.0, 0.5]], (n, 1)).astype(np.float32),
                col=np.concatenate([np.linspace(0, 1, n)[:, None] * np.ones((1, 3)),
                                    np.linspace(1, 2, n)[:, None]], -1).astype(np.float32),
                op=np.full((n,), 0.9, np.float32),
                rad=np.full((n, 2), 5, np.int32),
                dep=np.linspace(1.0, 2.0, n).astype(np.float32))


def _dense_case(case):
    """(camera planes, (w, h), max_per_tile) of one K4 test scene."""
    if case == "opaque":
        return _opaque_stack(), (32, 32), MPT
    n, mpt = (150, MPT) if case == "scene" else (400, 1024)
    s = _projected(n, 1)
    return {k: v[0] for k, v in s.items()}, (W, H), mpt


def _bins_both(s, w, h, mpt, tpg=9, conic=True):
    tw, th = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    bins = ptiles.bin_gaussians(
        t(s["m2d"]), torch.tensor(s["rad"]), t(s["dep"]), TILE, tw, th, tpg, mpt,
        conic_test=ptiles.conic_test_planes(t(s["con"]), t(s["op"])) if conic else None)
    ref = jtiles.bin_gaussians(
        jnp.asarray(s["m2d"]), jnp.asarray(s["rad"]), jnp.asarray(s["dep"]), TILE,
        tw, th, tpg, mpt, conic_test=jtiles.conic_test_planes(
            jnp.asarray(s["con"]), jnp.asarray(s["op"])) if conic else None)
    return bins, ref


@pytest.mark.parametrize("conic", [True, False])
@pytest.mark.parametrize("case", ["scene", "opaque"])
def test_bin_gaussians_dense_exact(case, conic):
    """The dense id table (padding slots included), counts and n_dropped
    bit-equal."""
    s, (w, h), mpt = _dense_case(case)
    bins, ref = _bins_both(s, w, h, mpt, conic=conic)
    assert bins.gauss_ids.dtype == torch.int32 and bins.gauss_ids.shape[1] == mpt
    np.testing.assert_array_equal(np_(bins.gauss_ids), np.asarray(ref.gauss_ids))
    np.testing.assert_array_equal(np_(bins.counts), np.asarray(ref.counts))
    assert int(bins.n_dropped) == int(ref.n_dropped)


def _params(s):
    return tuple(s[k] for k in ("m2d", "con", "col", "op"))


@pytest.mark.parametrize("case", ["scene", "multi_chunk", "opaque"])
def test_plain_k4_matches_jax(case):
    """rasterize_binned (its plain version on the CPU) against the Pallas K4
    in interpret mode and against rasterize_binned_jax, atol 1e-5."""
    s, (w, h), mpt = _dense_case(case)
    bins, ref = _bins_both(s, w, h, mpt)
    img, alpha = pbin.rasterize_binned(*(t(a) for a in _params(s)), bins, w, h, TILE)
    args = tuple(jnp.asarray(a) for a in _params(s))
    img_p, a_p = jax.jit(lambda m, c, col, op, b: jrp.rasterize_binned_pallas(
        m, c, col, op, b, w, h, TILE, True))(*args, ref)
    img_j, a_j = jrast.rasterize_binned_jax(*args, ref, w, h, TILE)
    for want_img, want_a in ((img_p, a_p), (img_j, a_j)):
        close(img, want_img, 1e-5)
        close(alpha, want_a, 1e-5)
    if case == "opaque":
        assert 0.999 < float(alpha.max()) <= 1.0


def test_rasterize_binned_grads_match_jax():
    """RasterizeBinned's gradients (a replay of the plain version) against
    jax.grad through rasterize_binned_pallas, atol 1e-4, rtol 1e-3."""
    s, (w, h), mpt = _dense_case("scene")
    bins, ref = _bins_both(s, w, h, mpt)
    rng = np.random.default_rng(4)
    v_img = rng.normal(size=(h, w, 4)).astype(np.float32)
    v_alpha = rng.normal(size=(h, w, 1)).astype(np.float32)

    def loss_j(m, c, col, op):
        img, a = jrp.rasterize_binned_pallas(m, c, col, op, ref, w, h, TILE, True)
        return jnp.sum(img * v_img) + jnp.sum(a * v_alpha)

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in _params(s)))
    ins = [t(a).requires_grad_(True) for a in _params(s)]
    img, alpha = pbin.RasterizeBinned.apply(*ins, bins.gauss_ids, bins.counts,
                                            w, h, TILE)
    ((img * t(v_img)).sum() + (alpha * t(v_alpha)).sum()).backward()
    for name, x, g in zip(("means2d", "conics", "colors", "opacities"), ins, want):
        assert torch.isfinite(x.grad).all(), name
        close(x.grad, g, 1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("sh", [False, True])
def test_render_local_cameras_matches_jax(sh):
    """project_for_cameras + render_local_cameras (K4's plain version on the
    CPU) in RGB+ED against the JAX per-rank body with impl="jax", atol 1e-5;
    RGB colours, or SH coloured toward each camera."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(9), n=200, c=2)
    sh_degree = 0 if sh else None
    if sh:
        colors = ((colors - 0.5) / 0.28209479177387814)[:, None, :]
    cov_j = jproj.quat_scale_to_covar_planes(jnp.asarray(quats), jnp.asarray(scales))
    proj_j = jdist._project_for_cameras(
        jnp.asarray(means), cov_j, jnp.asarray(opac), jnp.asarray(colors),
        jnp.asarray(viewmats), jnp.asarray(Ks), W, H, 0.3, 0.01, 1e10, sh_degree)
    out_j, alpha_j = jdist._render_local_cameras(*proj_j, W, H, TILE, "RGB+ED",
                                                 MPT, 4, "jax")
    cov = pproj.quat_scale_to_covar_planes(t(quats), t(scales))
    proj = pdist.project_for_cameras(t(means), cov, t(opac), t(colors),
                                     t(viewmats), t(Ks), W, H)
    for a, b in zip(proj, proj_j):
        close(a, b, 1e-4, rtol=1e-5)
    out, alpha = pdist.render_local_cameras(*proj, W, H, TILE, MPT, 4)
    assert out.shape == (2, H, W, 4) and alpha.shape == (2, H, W, 1)
    close(out, out_j, 1e-5)
    close(alpha, alpha_j, 1e-5)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A kernel's library name changes when a csrc header it includes
    (directly or through another header) changes, so an edited header is
    never served from a stale build; the shipped rasterizer sources all
    include raster_common.cuh."""
    from hunyuanworld_mirror_tpu_torch.ops import _build
    for name in ("rasterize_flat_fwd", "rasterize_flat_bwd", "rasterize_binned_fwd"):
        assert _build.CSRC / "raster_common.cuh" in _build._sources(name), name
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#define A B\n')
    (tmp_path / "b.cuh").write_text("#define B 1\n")
    before = _build.library_path("k")
    (tmp_path / "b.cuh").write_text("#define B 2\n")
    assert _build.library_path("k") != before
