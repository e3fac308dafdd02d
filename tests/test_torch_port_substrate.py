"""Port vs JAX: utils (rotation, camera, geometry, grid, gs_act, sh), the nn
layer primitives (conv_transpose included) and 2D RoPE. f32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import close, normal, state_dict_np, t, uniform
from hunyuanworld_mirror_tpu.models import nn as jnn
from hunyuanworld_mirror_tpu.models import rope as jrope
from hunyuanworld_mirror_tpu.utils import camera as jcam
from hunyuanworld_mirror_tpu.utils import geometry as jgeo
from hunyuanworld_mirror_tpu.utils import grid as jgrid
from hunyuanworld_mirror_tpu.utils import gs_act as jact
from hunyuanworld_mirror_tpu.utils import rotation as jrot
from hunyuanworld_mirror_tpu.utils import sh as jsh
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.models import rope as prope
from hunyuanworld_mirror_tpu_torch.utils import camera as pcam
from hunyuanworld_mirror_tpu_torch.utils import geometry as pgeo
from hunyuanworld_mirror_tpu_torch.utils import grid as pgrid
from hunyuanworld_mirror_tpu_torch.utils import gs_act as pact
from hunyuanworld_mirror_tpu_torch.utils import rotation as prot
from hunyuanworld_mirror_tpu_torch.utils import sh as psh
from tools import convert_weights as cw

ATOL = 1e-5


def _cam_vectors(seed, n=6):
    q = normal(seed, (n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tr = normal(seed + 1, (n, 3), 0.5)
    fov = uniform(seed + 2, (n, 2), 0.6, 1.4)
    return np.concatenate([tr, q, fov], -1).astype(np.float32)


def test_quat_to_rotmat():
    q = normal(0, (32, 4))
    close(prot.quat_to_rotmat(t(q)), jrot.quat_to_rotmat(jnp.asarray(q)), ATOL)


def test_camera_codec():
    vec = _cam_vectors(1)
    ext_j, intr_j = jcam.vector_to_camera_matrices(jnp.asarray(vec), (48, 64))
    ext_p, intr_p = pcam.vector_to_camera_matrices(t(vec), (48, 64))
    close(ext_p, ext_j, ATOL)
    close(intr_p, intr_j, 1e-4, rtol=1e-6)
    w2c_j = jcam.to_homogeneous(ext_j)
    close(pcam.se3_inverse(pcam.to_homogeneous(ext_p)), jcam.se3_inverse(w2c_j), ATOL)


def test_depth_to_world():
    vec = _cam_vectors(2, n=3)
    ext_j, intr_j = jcam.vector_to_camera_matrices(jnp.asarray(vec), (12, 16))
    c2w_j = jcam.se3_inverse(jcam.to_homogeneous(ext_j))
    depth = uniform(3, (3, 12, 16), 0.5, 3.0)
    ref = jgeo.depth_to_world_coords_points(jnp.asarray(depth), c2w_j, intr_j)
    out = pgeo.depth_to_world_coords_points(t(depth), t(c2w_j), t(intr_j))
    for a, b in zip(out, ref):
        close(a, b, 1e-4, rtol=1e-6)


def test_grid_embed():
    uv_j = jgrid.create_uv_grid(9, 7, aspect_ratio=9 / 7)
    uv_p = pgrid.create_uv_grid(9, 7, aspect_ratio=9 / 7)
    close(uv_p, uv_j, ATOL)
    close(pgrid.position_grid_to_embed(uv_p, 32),
          jgrid.position_grid_to_embed(uv_j, 32), ATOL)


def test_gs_act_and_sh():
    x = normal(4, (50, 4))
    close(pact.reg_dense_rotation(t(x)), jact.reg_dense_rotation(jnp.asarray(x)), ATOL)
    close(pact.reg_dense_scales(t(x)), jact.reg_dense_scales(jnp.asarray(x)), ATOL)
    close(pact.reg_dense_opacities(t(x)), jact.reg_dense_opacities(jnp.asarray(x)), ATOL)
    rgb = uniform(5, (50, 3))
    close(psh.rgb_to_sh(t(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)), ATOL)
    dirs = normal(6, (50, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for deg in range(5):
        coef = normal(7 + deg, (50, 3, (deg + 1) ** 2))
        close(psh.eval_sh(deg, t(coef), t(dirs)[:, None]),
              jsh.eval_sh(deg, jnp.asarray(coef), jnp.asarray(dirs)[:, None]),
              ATOL, rtol=1e-5)


def test_nn_layers():
    gen = torch.Generator().manual_seed(0)
    x = normal(8, (2, 5, 24))
    lin = pnn.Linear(24, 40)
    mlp = pnn.Mlp(24, 48, 16)
    ln = pnn.LayerNorm(24, 1e-5)
    for m in (lin, mlp, ln):
        pnn.init_weights(m, gen)
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5, generator=gen)
        ln.bias.uniform_(-0.5, 0.5, generator=gen)
    sd = {**{f"lin.{k}": v for k, v in state_dict_np(lin).items()},
          **{f"mlp.{k}": v for k, v in state_dict_np(mlp).items()},
          **{f"ln.{k}": v for k, v in state_dict_np(ln).items()}}
    xj = jnp.asarray(x)
    with torch.no_grad():
        close(lin(t(x)), jnn.linear(cw._linear(sd, "lin"), xj), ATOL)
        close(mlp(t(x)), jnn.mlp(cw._mlp(sd, "mlp"), xj), ATOL)
        close(ln(t(x)), jnn.layer_norm(cw._ln(sd, "ln"), xj, eps=1e-5), ATOL)


@pytest.mark.parametrize("kind", ["conv3x3", "conv_s2", "patchify", "deconv4", "deconv2"])
def test_conv_layers(kind):
    gen = torch.Generator().manual_seed(1)
    x = normal(9, (2, 12, 12, 6))
    if kind == "conv3x3":
        m, apply = pnn.Conv2d(6, 10, 3, padding=1), dict(padding=1)
    elif kind == "conv_s2":
        m, apply = pnn.Conv2d(6, 10, 3, stride=2, padding=1), dict(stride=2, padding=1)
    elif kind == "patchify":
        m, apply = pnn.Conv2d(6, 10, 4, stride=4), dict(stride=4, padding="VALID")
    else:
        k = 4 if kind == "deconv4" else 2
        m, apply = pnn.ConvTranspose2d(6, 6, k, stride=k), dict(stride=k)
    pnn.init_weights(m, gen)
    sd = state_dict_np(m)
    with torch.no_grad():
        out = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    sd = {f"m.{k}": v for k, v in sd.items()}
    if kind.startswith("deconv"):
        ref = jnn.conv_transpose(cw._conv_t(sd, "m"), jnp.asarray(x), **apply)
    else:
        ref = jnn.conv(cw._conv(sd, "m"), jnp.asarray(x), **apply)
    close(out, ref, ATOL)


def test_rope():
    pos = prope.grid_positions(3, 4, 5)
    np.testing.assert_array_equal(pos, jrope.grid_positions(3, 4, 5))
    tab_p = prope.make_rope_tables(pos, 16)
    tab_j = jrope.make_rope_tables(pos, 16)
    for a, b in zip(tab_p, tab_j):
        close(a, b, ATOL)
    tab_p2, tab_j2 = prope.tile_tables(tab_p, 2), jrope.tile_tables(tab_j, 2)
    x = normal(10, (2, 2 * len(pos), 3, 16))
    close(prope.apply_rope2d(t(x), tab_p2), jrope.apply_rope2d(jnp.asarray(x), tab_j2),
          ATOL)
