"""DINOv2-style ViT encoder (patch-feature extractor).

Port of hunyuanworld_mirror_tpu/models/dinov2.py `forward_features`: conv
patchify, cls + register tokens, learned pos embed (resampled to the image's patch
grid as `interpolate_pos_embed` does), pre-LN blocks (no QK-norm,
LayerScale, LayerNorm eps 1e-6), final LayerNorm; returns the normalized
patch tokens. State-dict names follow the reference DINOv2
(`patch_embed.proj`, `cls_token`, `register_tokens`, `pos_embed`,
`mask_token`, `blocks.{i}`, `norm`).

The factories add giant2 (fused SwiGLU FFN) and the DINOv3-style ViTs
(patch 16, 2D RoPE inside the blocks over the patch grid with the cls and
register tokens pinned at the origin, no learned pos embed: `pos_embed` is
kept as a parameter, unused, as the JAX package keeps it).
"""

import functools
from dataclasses import dataclass

import torch
from torch import nn

from .block import Block
from .nn import Conv2d, LayerNorm, trunc_normal_
from .rope import grid_positions, make_rope_tables


@dataclass(frozen=True)
class DinoViTConfig:
    img_size: int = 518
    patch_size: int = 14
    in_chans: int = 3
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    init_values: float = 1.0
    norm_eps: float = 1e-6
    ffn_layer: str = "mlp"
    use_rope: bool = False
    rope_freq: float = 100.0
    use_pos_embed: bool = True


VIT_FACTORIES = {
    "dinov2_vits14_reg": DinoViTConfig(embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14_reg": DinoViTConfig(embed_dim=768, depth=12, num_heads=12),
    "dinov2_vitl14_reg": DinoViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "dinov2_vitg2_reg": DinoViTConfig(embed_dim=1536, depth=40, num_heads=24,
                                      ffn_layer="swiglufused"),
    "dinov3_vits16": DinoViTConfig(img_size=592, patch_size=16, embed_dim=384,
                                   depth=12, num_heads=6, use_rope=True,
                                   use_pos_embed=False),
    "dinov3_vitb16": DinoViTConfig(img_size=592, patch_size=16, embed_dim=768,
                                   depth=12, num_heads=12, use_rope=True,
                                   use_pos_embed=False),
}


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel at a = -0.5 (jax.image's "bicubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) f32 weights of jax.image.resize(..., "bicubic",
    antialias=True) along one axis, in its own f32 arithmetic
    (jax.image.scale.compute_weight_mat at translation 0): sample centres at
    (i + 0.5) / scale - 0.5, the kernel widened by 1 / scale when
    downsampling, each output's weights normalised, and zero for a sample
    centre outside the input."""
    f32 = torch.float32
    inv = 1.0 / torch.tensor(n_out / n_in, dtype=f32)
    kernel_scale = torch.clamp_min(inv, 1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(f32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@functools.lru_cache(maxsize=16)
def _resize_weights_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """resize_weights on `device`, built once per (sizes, device): the CLI's
    crop makes every photo of one aspect the same grid."""
    return resize_weights(n_in, n_out).to(device)


def interpolate_pos_embed(pos_embed: torch.Tensor, patch_size: int, h: int,
                          w: int) -> torch.Tensor:
    """The (1, N + 1, D) pos embed for an (h / p, w / p) patch grid: the
    (m, m) grid of N = m^2 positions resampled in f32 with
    jax.image.resize's antialiased bicubic, one (in, out) weight matrix per
    axis that changes size, then cast back to the embed's dtype behind the
    unchanged cls row. Port of hunyuanworld_mirror_tpu/models/dinov2.py
    `interpolate_pos_embed`; torch's own bicubic (a = -0.75, another
    antialias) computes another function."""
    n = pos_embed.shape[1] - 1
    h0, w0 = h // patch_size, w // patch_size
    if n == h0 * w0 and h == w:
        return pos_embed
    m = int(round(n ** 0.5))
    grid = pos_embed[0, 1:].reshape(m, m, -1).float()
    dev = pos_embed.device
    if h0 != m:
        grid = torch.einsum("hwd,ho->owd", grid, _resize_weights_on(m, h0, dev))
    if w0 != m:
        grid = torch.einsum("hwd,wo->hod", grid, _resize_weights_on(m, w0, dev))
    patch = grid.reshape(1, h0 * w0, -1).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], patch], dim=1)


class PatchEmbed(nn.Module):
    """Conv patchify: (B, H, W, C) NHWC -> (B, h*w, D)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        y = self.proj(x.permute(0, 3, 1, 2))
        return y.flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: DinoViTConfig):
        super().__init__()
        self.cfg = cfg
        n_patches = (cfg.img_size // cfg.patch_size) ** 2
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, cfg.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, cfg.embed_dim))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, cfg.embed_dim))
        # DINOv2's masked-image-modeling token: never used at inference, kept
        # so the public state dict loads strictly
        self.mask_token = nn.Parameter(torch.zeros(1, cfg.embed_dim))
        self.blocks = nn.ModuleList([
            Block(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio,
                  init_values=cfg.init_values, norm_eps=cfg.norm_eps,
                  ffn_layer=cfg.ffn_layer)
            for _ in range(cfg.depth)])
        self.norm = LayerNorm(cfg.embed_dim, cfg.norm_eps)

    def init_own(self, gen):
        trunc_normal_(self.cls_token, 1e-6, gen)
        trunc_normal_(self.register_tokens, 1e-6, gen)
        trunc_normal_(self.pos_embed, 0.02, gen)
        nn.init.zeros_(self.mask_token)

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) ImageNet-normalized images -> (B, h*w, D) tokens."""
        cfg = self.cfg
        B, H, W, _ = images.shape
        dtype = images.dtype
        x = self.patch_embed(images)
        cls = self.cls_token.to(dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1)
        if cfg.use_pos_embed:
            pos = interpolate_pos_embed(self.pos_embed, cfg.patch_size, H, W)
            x = x + pos.to(dtype)
        regs = self.register_tokens.to(dtype).expand(B, -1, -1)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        rope = None
        if cfg.use_rope:
            grid = grid_positions(H // cfg.patch_size, W // cfg.patch_size,
                                  1 + cfg.num_register_tokens)
            rope = make_rope_tables(grid, cfg.embed_dim // cfg.num_heads,
                                    cfg.rope_freq, device=images.device)
        for blk in self.blocks:
            x = blk(x, rope)
        x = self.norm(x)
        return x[:, 1 + cfg.num_register_tokens:]
