"""The port's dense oracle and the last public functions without a twin, on
the CPU: ops/rasterizer_ref.rasterize_reference against the JAX oracle
(atol 1e-5: tests/test_rasterizer.py's scene of 150 splats, 2 cameras,
64 x 48, colour widths 3 and 4, with and without a background), the port's
plain `rasterize` on both routes against the port's oracle (atol 1e-4, the
JAX test's own band), tiles.tile_ranges exactly, sh_to_rgb and scale2x
within 1e-6 of JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import _random_scene
from torch_port_helpers import close, normal, t, uniform
from hunyuanworld_mirror_tpu.ops import interpolate as jinterp
from hunyuanworld_mirror_tpu.ops import projection as jproj
from hunyuanworld_mirror_tpu.ops import tiles as jtiles
from hunyuanworld_mirror_tpu.ops.rasterizer_ref import rasterize_reference as jref
from hunyuanworld_mirror_tpu.utils import sh as jsh
from hunyuanworld_mirror_tpu_torch.ops import interpolate as pinterp
from hunyuanworld_mirror_tpu_torch.ops import projection as pproj
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import tiles as ptiles
from hunyuanworld_mirror_tpu_torch.ops.rasterizer_ref import rasterize_reference as pref
from hunyuanworld_mirror_tpu_torch.utils import sh as psh

W, H = 64, 48


def _scene():
    return _random_scene(np.random.default_rng(42), n=150, c=2)


@pytest.mark.parametrize("d_col", [3, 4])
@pytest.mark.parametrize("with_bg", [False, True])
def test_reference_equals_jax(d_col, with_bg):
    means, quats, scales, opac, colors, viewmats, Ks = _scene()
    if d_col == 4:
        colors = np.concatenate([colors, uniform(7, (150, 1))], -1)
    bg = uniform(8, (d_col,)) if with_bg else None
    cov = jproj.quat_scale_to_covar(jnp.asarray(quats), jnp.asarray(scales))
    pj = jproj.fully_fused_projection(jnp.asarray(means), cov, jnp.asarray(viewmats),
                                      jnp.asarray(Ks), W, H)
    for c in range(2):
        m2d, con, dep, rad = (np.asarray(x[c]) for x in (pj.means2d, pj.conics,
                                                           pj.depths, pj.radii))
        ref = jref(jnp.asarray(m2d), jnp.asarray(con), jnp.asarray(colors),
                   jnp.asarray(opac), jnp.asarray(dep), jnp.asarray(rad), W, H,
                   backgrounds=None if bg is None else jnp.asarray(bg))
        ours = pref(t(m2d), t(con), t(colors), t(opac), t(dep), torch.tensor(rad), W, H,
                    backgrounds=None if bg is None else t(bg))
        assert ours[0].shape == (H, W, d_col) and ours[1].shape == (H, W, 1)
        assert float(ours[1].max()) > 0.5        # the scene is not empty
        close(ours[0], ref[0], 1e-5)
        close(ours[1], ref[1], 1e-5)


@pytest.mark.parametrize("impl", ["pallas", "jax"])
def test_plain_rasterize_matches_the_oracle(impl):
    """tests/test_rasterizer.py::test_tiled_matches_reference on the port:
    the flat route's and the dense-bin route's plain blends (K2's and K4's
    plain versions) on the port's own binning, against the oracle, which
    does no binning."""
    means, quats, scales, opac, colors, viewmats, Ks = (t(a) for a in _scene())
    img, alpha, meta = prast.rasterize(means, quats, scales, opac, colors, viewmats, Ks,
                                       W, H, render_mode="RGB", max_per_tile=2048,
                                       max_tiles_per_gauss=12, impl=impl, device="cpu")
    assert int(meta["n_dropped"].sum()) == 0
    cov = pproj.quat_scale_to_covar_planes(quats, scales)
    pj = pproj.fully_fused_projection(means, cov, viewmats, Ks, W, H)
    for c in range(2):
        ref_img, ref_alpha = pref(pj.means2d[c], pj.conics[c], colors, opac,
                                  pj.depths[c], pj.radii[c], W, H)
        close(img[c], ref_img, 1e-4)
        close(alpha[c], ref_alpha, 1e-4)


def test_tile_ranges_exact():
    rng = np.random.default_rng(5)
    m2d = rng.uniform(-40, 110, size=(400, 2)).astype(np.float32)
    m2d[:8] = [[0, 0], [16, 16], [63.99, 47.99], [64, 48], [-16, 5], [8, 200],
               [31.5, 15.5], [-1e9, 1e9]]
    rad = rng.integers(0, 40, size=(400, 2)).astype(np.int32)
    rad[8:16] = 0
    ours = ptiles.tile_ranges(t(m2d), torch.tensor(rad), 16, 4, 3)
    ref = jtiles.tile_ranges(jnp.asarray(m2d), jnp.asarray(rad), 16, 4, 3)
    for o, r in zip(ours, ref):
        assert o.dtype == (torch.bool if r.dtype == bool else torch.int32)
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_sh_to_rgb():
    sh = normal(3, (50, 16, 3))
    close(psh.sh_to_rgb(t(sh)), jsh.sh_to_rgb(jnp.asarray(sh)), 1e-6)
    close(psh.rgb_to_sh(psh.sh_to_rgb(t(sh))), sh, 1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_scale2x(align_corners):
    x = normal(4, (2, 7, 5, 3))
    ours = pinterp.scale2x(t(x), align_corners=align_corners)
    ref = jinterp.scale2x(jnp.asarray(x), align_corners=align_corners)
    assert ours.shape == (2, 14, 10, 3)
    close(ours, ref, 1e-6)
