"""Port vs JAX: the pre-LN block, the DINOv2 encoder and the alternating
frame/global trunk (aggregator), all at f32, atol 2e-4 (the band of
tests/test_torch_parity.py). JAX parameters come from the port's random
init through tools/convert_weights.py, so the reference state-dict names
are checked on the way."""

import jax.numpy as jnp
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


def test_dinov2_rejects_pos_embed_resampling():
    vit = pdino.DinoVisionTransformer(
        pdino.DinoViTConfig(img_size=56, embed_dim=96, depth=1, num_heads=3))
    with pytest.raises(NotImplementedError):
        vit.forward_features(torch.zeros(1, 70, 70, 3))


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
