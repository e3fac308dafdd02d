"""Port vs JAX on the render path: EWA projection, flat tile binning (exact:
starts, counts, n_dropped and every packed row equal; f32 and f16-pair
payloads, the ellipse test on and off, 400 splats and 1,200 under a per-tile
cap that overflows), the plain version of kernel K2 against the Pallas flat
kernel in interpret mode (f32 and f16-pair payloads, atol 1e-4; the capped
scene among them: lists whose tiles lost entries), and the whole per-camera
`rasterize` (atol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import _random_scene
from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.ops import projection as jproj
from hunyuanworld_mirror_tpu.ops import rasterizer as jrast
from hunyuanworld_mirror_tpu.ops import tiles as jtiles
from hunyuanworld_mirror_tpu.ops.rasterizer_pallas import pack_f16_pairs as jpack
from hunyuanworld_mirror_tpu.ops.rasterizer_pallas import rasterize_flat_pallas
from hunyuanworld_mirror_tpu_torch.ops import projection as pproj
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat
from hunyuanworld_mirror_tpu_torch.ops import tiles as ptiles

W, H, TILE = 64, 48, 16
TW, TH = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE


def _project(n, seed=42):
    """The JAX projection of a random scene, as numpy planes."""
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(seed), n=n, c=1)
    cov = jproj.quat_scale_to_covar_planes(jnp.asarray(quats), jnp.asarray(scales))
    pj = jproj.fully_fused_projection(jnp.asarray(means), cov, jnp.asarray(viewmats),
                                      jnp.asarray(Ks), W, H)
    rad = np.asarray(jtiles.opacity_tight_radii(pj.radii[0], jnp.asarray(opac)))
    col = np.concatenate([colors, np.asarray(pj.depths[0])[:, None]], -1)
    return dict(m2d=np.asarray(pj.means2d[0]), con=np.asarray(pj.conics[0]),
                col=col, op=opac, rad=rad, dep=np.asarray(pj.depths[0]))


def test_projection():
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(0), n=300, c=3)
    cov_j = jproj.quat_scale_to_covar_planes(jnp.asarray(quats), jnp.asarray(scales))
    cov_p = pproj.quat_scale_to_covar_planes(t(quats), t(scales))
    for a, b in zip(cov_p, cov_j):
        close(a, b, 1e-6)
    pj = jproj.fully_fused_projection(jnp.asarray(means), cov_j, jnp.asarray(viewmats),
                                      jnp.asarray(Ks), W, H)
    pp = pproj.fully_fused_projection(t(means), cov_p, t(viewmats), t(Ks), W, H)
    close(pp.means2d, pj.means2d, 1e-4, rtol=1e-5)
    close(pp.depths, pj.depths, 1e-5)
    close(pp.conics, pj.conics, 1e-4, rtol=1e-4)
    np.testing.assert_array_equal(np_(pp.radii), np.asarray(pj.radii))


def _value_planes(s, payload_f16):
    """The per-splat payload planes (N,) both binnings sort."""
    m2d, con, col, op = (t(s[k]) for k in ("m2d", "con", "col", "op"))
    if not payload_f16:
        return [m2d[:, 0], m2d[:, 1], con[:, 0], con[:, 1], con[:, 2], op] + [
            col[:, i] for i in range(col.shape[1])]
    pk = pflat.pack_f16_pairs
    return [m2d[:, 0], m2d[:, 1], pk(con[:, 0], con[:, 1]), pk(con[:, 2], op),
            pk(col[:, 0], col[:, 1]), pk(col[:, 2], col[:, 3])]


def test_pack_f16_pairs_bits():
    a = np.linspace(-70000, 70000, 101, dtype=np.float32)
    b = np.linspace(1e-8, 3.0, 101, dtype=np.float32)
    np.testing.assert_array_equal(
        np_(pflat.pack_f16_pairs(t(a), t(b))).view(np.int32),
        np.asarray(jpack(jnp.asarray(a), jnp.asarray(b))).view(np.int32))


# (splats, max_per_tile): 1,200 splats overflow a 256 cap on the busiest
# tiles with the ellipse test on or off
LOADS = {"scene": (400, 1024), "capped": (1200, 256)}
# the first two cases keep the names they had before the other loads came
BIN_CASES = [pytest.param(load, conic, f16, id=str(f16) if (load, conic) == ("scene", True)
                          else f"{load}-{'conic' if conic else 'aabb'}-{f16}")
             for load in LOADS for conic in (True, False) for f16 in (False, True)]


@pytest.mark.parametrize("load,conic,payload_f16", BIN_CASES)
def test_bin_gaussians_packed_exact(load, conic, payload_f16):
    n, mpt = LOADS[load]
    s = _project(n)
    values = _value_planes(s, payload_f16)
    bins = ptiles.bin_gaussians_packed(
        t(s["m2d"]), torch.tensor(s["rad"]), t(s["dep"]), values, TILE, TW, TH,
        4, mpt,
        conic_test=ptiles.conic_test_planes(t(s["con"]), t(s["op"])) if conic else None)
    ref = jtiles.bin_gaussians_packed(
        jnp.asarray(s["m2d"]), jnp.asarray(s["rad"]), jnp.asarray(s["dep"]),
        [jnp.asarray(np_(v)) for v in values], TILE, TW, TH, 4, mpt,
        conic_test=(jtiles.conic_test_planes(jnp.asarray(s["con"]), jnp.asarray(s["op"]))
                    if conic else None))
    np.testing.assert_array_equal(np_(bins.starts), np.asarray(ref.starts))
    np.testing.assert_array_equal(np_(bins.counts), np.asarray(ref.counts))
    assert int(bins.n_dropped) == int(ref.n_dropped)
    np.testing.assert_array_equal(np_(bins.packed).view(np.int32),
                                  np.asarray(ref.packed).view(np.int32))
    if load == "capped":
        assert int(np_(bins.counts).max()) == mpt and int(bins.n_dropped) > 0


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


@pytest.mark.parametrize("payload_f16", [False, True])
@pytest.mark.parametrize("case", ["scene", "multi_chunk", "opaque", "capped"])
def test_plain_k2_matches_pallas_interpret(case, payload_f16):
    """`capped`: K2 on lists whose busiest tiles lost entries to the cap."""
    if case == "opaque":
        s, (w, h), mpt = _opaque_stack(), (32, 32), 1024
    else:
        n, mpt = {"scene": (150, 512), "multi_chunk": (400, 1024),
                  "capped": LOADS["capped"]}[case]
        s, (w, h) = _project(n), (W, H)
    tw, th = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    bins = prast.bin_splats(t(s["m2d"]), t(s["con"]), t(s["col"]), t(s["op"]),
                            torch.tensor(s["rad"]), t(s["dep"]), TILE, tw, th,
                            4, mpt, payload_f16)
    img, alpha = pflat.rasterize_flat(bins.packed, bins.starts, bins.counts, w, h,
                                      TILE, 4, payload_f16)
    img_j, a_j, drop_j = rasterize_flat_pallas(
        *(jnp.asarray(s[k]) for k in ("m2d", "con", "col", "op", "rad", "dep")),
        jnp.zeros((len(s["op"]), 2), jnp.float32), w, h, TILE, 4, mpt, True,
        payload_f16)
    assert int(bins.n_dropped) == int(drop_j)
    close(img, img_j, 1e-4)
    close(alpha, a_j, 1e-4)
    if case == "opaque":
        assert 0.999 < float(alpha.max()) <= 1.0
    if case == "capped":
        assert int(np_(bins.counts).max()) == mpt


@pytest.mark.parametrize("sh", [False, True])
def test_rasterize_matches_jax(sh):
    means, quats, scales, opac, colors, viewmats, Ks = _random_scene(
        np.random.default_rng(7), n=300, c=2)
    if sh:  # SH degree-0 colours, as the Gaussian head produces them
        colors = ((colors - 0.5) / 0.28209479177387814)[:, None, :]
    kw = dict(max_per_tile=1024, max_tiles_per_gauss=4)
    out, alpha, meta = prast.rasterize(
        t(means), t(quats), t(scales), t(opac), t(colors), t(viewmats), t(Ks),
        W, H, device="cpu", **kw)
    out_j, alpha_j, meta_j = jrast.rasterize(
        *(jnp.asarray(a) for a in (means, quats, scales, opac, colors, viewmats, Ks)),
        W, H, impl="pallas", render_mode="RGB+ED", **kw)
    close(out, out_j, 1e-4)
    close(alpha, alpha_j, 1e-4)
    np.testing.assert_array_equal(np_(meta["n_dropped"]),
                                  np.asarray(meta_j["n_dropped"]))
