"""DINOv2-style ViT encoder (patch-feature extractor).

Port of hunyuanworld_mirror_tpu/models/dinov2.py `forward_features`: conv
patchify, cls + register tokens, learned pos embed, pre-LN blocks (no
QK-norm, LayerScale, LayerNorm eps 1e-6), final LayerNorm; returns the
normalized patch tokens. State-dict names follow the reference DINOv2
(`patch_embed.proj`, `cls_token`, `register_tokens`, `pos_embed`,
`mask_token`, `blocks.{i}`, `norm`).
"""

from dataclasses import dataclass

import torch
from torch import nn

from .block import Block
from .nn import Conv2d, LayerNorm, trunc_normal_


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


VIT_FACTORIES = {
    "dinov2_vits14_reg": DinoViTConfig(embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14_reg": DinoViTConfig(embed_dim=768, depth=12, num_heads=12),
    "dinov2_vitl14_reg": DinoViTConfig(embed_dim=1024, depth=24, num_heads=16),
}


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
                  init_values=cfg.init_values, norm_eps=cfg.norm_eps)
            for _ in range(cfg.depth)])
        self.norm = LayerNorm(cfg.embed_dim, cfg.norm_eps)

    def init_own(self, gen):
        trunc_normal_(self.cls_token, 1e-6, gen)
        trunc_normal_(self.register_tokens, 1e-6, gen)
        trunc_normal_(self.pos_embed, 0.02, gen)
        nn.init.zeros_(self.mask_token)

    def _pos_embed(self, h: int, w: int):
        n = self.pos_embed.shape[1] - 1
        p = self.cfg.patch_size
        if n == (h // p) * (w // p) and h == w:
            return self.pos_embed
        # the JAX package resamples with jax.image.resize bicubic + antialias
        # (Keys a = -0.5); torch's bicubic uses a = -0.75, so it is not ported
        raise NotImplementedError(
            f"pos-embed resampling from {n} positions to a {h // p}x{w // p} "
            "grid is not ported; use the configured img_size")

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) ImageNet-normalized images -> (B, h*w, D) tokens."""
        B, H, W, _ = images.shape
        dtype = images.dtype
        x = self.patch_embed(images)
        cls = self.cls_token.to(dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self._pos_embed(H, W).to(dtype)
        regs = self.register_tokens.to(dtype).expand(B, -1, -1)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1 + self.cfg.num_register_tokens:]
