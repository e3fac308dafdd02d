"""Port vs JAX: the pre-LN block, the DINOv2 encoder and the alternating
frame/global trunk (aggregator), all at f32, atol 2e-4 (the band of
tests/test_torch_parity.py). JAX parameters come from the port's random
init through tools/convert_weights.py, so the reference state-dict names
are checked on the way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import close, state_dict_np, t, uniform, normal
from hunyuanworld_mirror_tpu.models import aggregator as jagg
from hunyuanworld_mirror_tpu.models import block as jblock
from hunyuanworld_mirror_tpu.models import dinov2 as jdino
from hunyuanworld_mirror_tpu.models import rope as jrope
from hunyuanworld_mirror_tpu_torch.models import aggregator as pagg
from hunyuanworld_mirror_tpu_torch.models import block as pblock
from hunyuanworld_mirror_tpu_torch.models import dinov2 as pdino
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.models import rope as prope
from tools import convert_weights as cw

ATOL = 2e-4


def _init(module, seed=0):
    pnn.init_weights(module, torch.Generator().manual_seed(seed))
    return module


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_block(eps):
    dim, heads = 64, 4
    blk = _init(pblock.Block(dim, heads, init_values=0.5, qk_norm=True,
                             norm_eps=eps))
    p = cw._block({f"b.{k}": v for k, v in state_dict_np(blk).items()}, "b",
                  qk_norm=True)
    pos = prope.grid_positions(3, 3, 5)
    x = normal(0, (2, len(pos), dim))
    with torch.no_grad():
        out = blk(t(x), prope.make_rope_tables(pos, dim // heads))
    ref = jblock.block(p, jnp.asarray(x), heads,
                       rope=jrope.make_rope_tables(pos, dim // heads),
                       norm_eps=eps)
    close(out, ref, ATOL)


def test_dinov2_forward_features():
    cfg_p = pdino.DinoViTConfig(img_size=56, embed_dim=96, depth=2, num_heads=3)
    cfg_j = jdino.DinoViTConfig(img_size=56, embed_dim=96, depth=2, num_heads=3)
    vit = _init(pdino.DinoVisionTransformer(cfg_p), 1)
    params = cw.convert_dinov2(state_dict_np(vit))
    x = normal(1, (2, 56, 56, 3))
    with torch.no_grad():
        out = vit.forward_features(t(x))
    ref = jdino.forward_features(params, cfg_j, jnp.asarray(x), dtype=jnp.float32)
    close(out, ref, ATOL)


# (m, (h0, w0)): the pos embed's m x m grid -> an h0 x w0 patch grid, up and
# down, square and not; 37 -> 28 x 37 is a 4:3 photo at 518 px
RESAMPLE_GRIDS = [(4, (3, 4)), (4, (5, 3)), (4, (6, 6)), (37, (28, 37))]


@pytest.mark.parametrize("m,grid", RESAMPLE_GRIDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interpolate_pos_embed_matches_jax(m, grid, dtype):
    """The hand-written antialiased Keys bicubic against jax.image.resize
    through the JAX interpolate_pos_embed, D = 8: f32 within 1e-5; bf16
    parameters (both sides resample in f32 and cast back) within one bf16
    ulp of the reference value."""
    p = 14
    h, w = grid[0] * p, grid[1] * p
    pe = normal(4, (1, m * m + 1, 8), 0.5)
    ref = jdino.interpolate_pos_embed(jnp.asarray(pe, dtype=dtype),
                                      jdino.DinoViTConfig(patch_size=p), h, w)
    out = pdino.interpolate_pos_embed(t(pe).to(getattr(torch, dtype)), p, h, w)
    assert out.shape == ref.shape == (1, grid[0] * grid[1] + 1, 8)
    assert out.dtype == getattr(torch, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        close(out, ref, 1e-5)
    else:
        np.testing.assert_array_less(np.abs(out.float().numpy() - ref),
                                     2.0 ** -7 * np.abs(ref) + 1e-30)


@pytest.mark.parametrize("hw", [(70, 70), (42, 56)])
def test_dinov2_forward_features_resampled(hw):
    """forward_features on an image whose patch grid is not the configured
    4 x 4 one (5 x 5, and 3 x 4 from a landscape image) against the JAX
    forward_features, which resamples the pos embed."""
    cfg_p = pdino.DinoViTConfig(img_size=56, embed_dim=96, depth=2, num_heads=3)
    cfg_j = jdino.DinoViTConfig(img_size=56, embed_dim=96, depth=2, num_heads=3)
    vit = _init(pdino.DinoVisionTransformer(cfg_p), 1)
    params = cw.convert_dinov2(state_dict_np(vit))
    x = normal(2, (2, *hw, 3))
    with torch.no_grad():
        out = vit.forward_features(t(x))
    ref = jdino.forward_features(params, cfg_j, jnp.asarray(x), dtype=jnp.float32)
    assert out.shape == (2, (hw[0] // 14) * (hw[1] // 14), 96)
    close(out, ref, ATOL)


@pytest.mark.parametrize("patch_embed,dim,heads", [
    ("conv", 64, 4), ("dinov2_vits14_reg", 384, 6)])
def test_aggregator(patch_embed, dim, heads):
    kw = dict(img_size=56, embed_dim=dim, depth=4, num_heads=heads,
              patch_embed=patch_embed, enable_cond=True,
              intermediate_idxs=(0, 1, 2, 3))
    agg = _init(pagg.VisualGeometryTransformer(pagg.VGTConfig(**kw)), 2)
    sd = state_dict_np(agg)
    if patch_embed != "conv":
        # the DINOv2 factory runs 12 blocks; keep two to stay small
        agg.patch_embed.blocks = agg.patch_embed.blocks[:2]
        sd = {k: v for k, v in sd.items()
              if not k.startswith("patch_embed.blocks.")
              or int(k.split(".")[2]) < 2}
    params = cw.convert_vgt(sd)
    imgs = uniform(3, (1, 3, 56, 56, 3))
    with torch.no_grad():
        outs, start = agg(t(imgs), dtype=torch.float32)
    refs, start_j = jagg.forward(params, jagg.VGTConfig(**kw), jnp.asarray(imgs),
                                 dtype=jnp.float32)
    assert start == start_j == 7
    assert len(outs) == len(refs) == 4
    for o, r in zip(outs, refs):
        assert o.shape == r.shape
        close(o, r, ATOL)
