"""CenterSnap-style 6D object-pose model (the fork's training workload).

Port of hunyuanworld_mirror_tpu/models/centersnap.py: a single-frame
frame-only trunk (depth 4, width 384, 6 heads) with the optional depth prior
as the trunk's depth condition, feeding two DPT heads: a 1-channel sigmoid
heatmap at full resolution and a 12-channel linear pose map (rot6d,
translation, bbox size) at 1 / `pose_down_ratio`. The trunk computes in
bf16, so its softmax cores are kernel K1 on the card (forward, and the JAX
VJP's einsum replay backward); the heads in f32.

A DINO backbone (`patch_embed` naming a `dinov*` factory) is frozen, as
the fork's wrapper (models/models/visual_transformer.py) always freezes
it: its parameters take no gradient, so autograd saves nothing for it and
its attention takes K1's inference route; only the trunk's layers replay.
The JAX twin trains it; its checkpoint layout is kept (the frozen leaves
are saved, with zero optimizer moments). The spans "heads.heatmap" and
"heads.pose" time the two heads.

The module names follow the JAX pytree (`encoder`, `heatmap_head`,
`pose_head`); convert.to_jax_tree / from_jax_tree map the two.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..utils import profiling
from .aggregator import VGTConfig, VisualGeometryTransformer
from .dpt import DPTConfig, DPTHead


@dataclass(frozen=True)
class CenterSnapConfig:
    img_size: int = 512
    patch_size: int = 16
    embed_dim: int = 384
    trunk_depth: int = 4
    trunk_heads: int = 6
    patch_embed: str = "conv"
    use_depth_condition: bool = True
    heatmap_features: int = 128
    pose_down_ratio: int = 2

    @property
    def vgt(self) -> VGTConfig:
        d = self.trunk_depth
        return VGTConfig(
            img_size=self.img_size, patch_size=self.patch_size,
            embed_dim=self.embed_dim, depth=d, num_heads=self.trunk_heads,
            patch_embed=self.patch_embed, enable_cond=self.use_depth_condition,
            frame_only=True,
            intermediate_idxs=tuple(min(i, d - 1)
                                    for i in (0, d // 3, 2 * d // 3, d - 1)))

    @property
    def heatmap_head(self) -> DPTConfig:
        return DPTConfig(dim_in=self.embed_dim, patch_size=self.patch_size,
                         output_dim=1, activation="sigmoid",
                         features=self.heatmap_features,
                         out_channels=(128, 256, 256, 256), with_conf=False)

    @property
    def pose_head(self) -> DPTConfig:
        return DPTConfig(dim_in=self.embed_dim, patch_size=self.patch_size,
                         output_dim=12, activation="linear",
                         features=self.heatmap_features,
                         out_channels=(128, 256, 256, 256),
                         down_ratio=self.pose_down_ratio, with_conf=False)


class CenterSnap(nn.Module):
    def __init__(self, cfg: CenterSnapConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = VisualGeometryTransformer(cfg.vgt)
        self.heatmap_head = DPTHead(cfg.heatmap_head)
        self.pose_head = DPTHead(cfg.pose_head)
        if self.backbone_frozen:
            self.encoder.patch_embed.requires_grad_(False)

    @property
    def backbone_frozen(self) -> bool:
        return self.cfg.patch_embed.startswith("dinov")

    def forward(self, rgb: torch.Tensor, depth: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """rgb (B, H, W, 3) in [0, 1]; depth (B, H, W) normalized, used only
        with `use_depth_condition` (cond (0, 1, 0)).

        Returns heatmap (B, H, W, 1) and pose_map (B, H/dr, W/dr, 12)."""
        imgs = rgb[:, None]
        if self.cfg.use_depth_condition and depth is not None:
            priors, cond = (depth[:, None], None, None), (0, 1, 0)
        else:
            priors, cond = None, (0, 0, 0)
        tokens, start = self.encoder(imgs, priors=priors, cond_flags=cond)
        with profiling.span("heads.heatmap"):
            heat, _ = self.heatmap_head(tokens, imgs, start)
        with profiling.span("heads.pose"):
            pose, _ = self.pose_head(tokens, imgs, start)
        return {"heatmap": heat[:, 0], "pose_map": pose[:, 0]}
