"""CenterSnap "panoptic" ResNet-FPN baseline (`--arch res_fpn`).

Port of hunyuanworld_mirror_tpu/models/panoptic.py: an RGBD stem (a 7x7/s2
conv + GroupNorm + maxpool stem on RGB (3 -> 32) and on depth (1 -> 1), a
dilation-5 pre-activation block lifting the depth to 32 channels, concat
-> 64 at stride 4), a ResNet-50-shape bottleneck trunk with GroupNorm and
the stride in the 1x1, an FPN (1x1 laterals, 3x3 outputs, nearest 2x
top-down, sums) and two scale heads (conv + GN + relu chains with
bilinear 2x ups to a common stride, summed, a 1x1 predictor): the heatmap
at stride 4 resized to full resolution under a sigmoid, the 12-channel pose
map at stride 2.

No attention and no kernel: PyTorch convolutions and GroupNorm (f32
statistics, the JAX package's group clamp and eps) in NCHW; inputs and
outputs keep the JAX layout (NHWC). Module names follow the JAX pytree
(`rgb_stem.conv`, `stages.{i}.{j}.conv1.gn`, `heatmap_head.scale_heads.{i}.{j}`,
...); convert.to_jax_tree / from_jax_tree map the two.
"""

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolate import resize_bilinear
from .nn import Conv2d, GroupNorm


@dataclass(frozen=True)
class PanopticConfig:
    num_filters_scale: int = 4
    blocks_per_stage: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50 shape
    stem_out: int = 64
    gn_groups: int = 16
    heatmap_classes: int = 1
    pose_classes: int = 12
    sem_common_stride: int = 4
    pose_common_stride: int = 2

    @property
    def fpn_channels(self) -> int:
        return 256 // self.num_filters_scale

    @property
    def head_dims(self) -> int:
        return 128 // self.num_filters_scale

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        c = 256 // self.num_filters_scale
        return tuple(c * (2 ** i) for i in range(4))

    @property
    def bottleneck_channels(self) -> Tuple[int, ...]:
        w = max(64 // self.num_filters_scale, 32)
        return tuple(w * (2 ** i) for i in range(4))


class ConvGN(nn.Module):
    """Bias-free conv (padding (k // 2) * dilation) -> GroupNorm [-> relu]."""

    def __init__(self, cin: int, cout: int, kernel: int, groups: int,
                 stride: int = 1, dilation: int = 1, relu: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride,
                           padding=(kernel // 2) * dilation, dilation=dilation,
                           bias=False)
        self.gn = GroupNorm(cout, groups)
        self.relu = relu

    def forward(self, x):
        y = self.gn(self.conv(x))
        return F.relu(y) if self.relu else y


class BasicStem(ConvGN):
    """7x7/s2 conv + GN + relu, then a 3x3/s2 max pool (padding 1)."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__(cin, cout, 7, groups, stride=2)

    def forward(self, x):
        return F.max_pool2d(super().forward(x), 3, 2, padding=1)


class PreactBlock(nn.Module):
    """GN -> relu -> dilated ConvGN -> dilated conv, plus a 1x1 shortcut
    when the width changes."""

    def __init__(self, cin: int, cout: int, groups: int, dilation: int = 5):
        super().__init__()
        self.pre_gn = GroupNorm(cin, groups)
        self.conv1 = ConvGN(cin, cout, 3, groups, dilation=dilation)
        self.conv2 = Conv2d(cout, cout, 3, padding=dilation, dilation=dilation,
                            bias=False)
        self.shortcut = Conv2d(cin, cout, 1, bias=False) if cin != cout else None

    def forward(self, x):
        short = x if self.shortcut is None else self.shortcut(x)
        h = self.conv1(F.relu(self.pre_gn(x)))
        return self.conv2(h) + short


class Bottleneck(nn.Module):
    """1x1 (stride) -> 3x3 -> 1x1 ConvGNs, the last without relu, plus the
    (ConvGN 1x1) shortcut, then relu."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int, groups: int):
        super().__init__()
        self.conv1 = ConvGN(cin, cmid, 1, groups, stride=stride)
        self.conv2 = ConvGN(cmid, cmid, 3, groups)
        self.conv3 = ConvGN(cmid, cout, 1, groups, relu=False)
        self.shortcut = (ConvGN(cin, cout, 1, groups, stride=stride, relu=False)
                         if cin != cout else None)

    def forward(self, x):
        h = self.conv3(self.conv2(self.conv1(x)))
        short = x if self.shortcut is None else self.shortcut(x)
        return F.relu(h + short)


class ScaleHead(nn.Module):
    """Per level (log2 stride) a chain of ConvGNs, each followed by a
    bilinear 2x up until the common stride, summed; a 1x1 predictor."""

    def __init__(self, cfg: PanopticConfig, in_levels: Sequence[int],
                 common_stride: int, classes: int):
        super().__init__()
        fc, hd, g = cfg.fpn_channels, cfg.head_dims, cfg.gn_groups
        self.in_levels, self.common_stride = tuple(in_levels), common_stride
        self.scale_heads = nn.ModuleList()
        for lvl in in_levels:
            n = max(1, lvl - common_stride.bit_length() + 1)
            self.scale_heads.append(nn.ModuleList(
                [ConvGN(fc if k == 0 else hd, hd, 3, g) for k in range(n)]))
        self.predictor = Conv2d(hd, classes, 1)

    def forward(self, pyramid: Dict[int, torch.Tensor]) -> torch.Tensor:
        acc = None
        for chain, lvl in zip(self.scale_heads, self.in_levels):
            x = F.relu(pyramid[lvl])
            stride = 1 << lvl
            for conv in chain:
                x = conv(x)
                if stride != self.common_stride:
                    x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2),
                                        nchw=True, align_corners=False)
                    stride //= 2
            acc = x if acc is None else acc + x
        return self.predictor(acc)


class Panoptic(nn.Module):
    def __init__(self, cfg: PanopticConfig):
        super().__init__()
        self.cfg = cfg
        g = cfg.gn_groups
        self.rgb_stem = BasicStem(3, cfg.stem_out // 2, g)
        self.depth_stem = BasicStem(1, 1, g)
        self.disp_feat = PreactBlock(1, cfg.stem_out // 2, g)
        self.stages = nn.ModuleList()
        cin = cfg.stem_out
        for si, nblocks in enumerate(cfg.blocks_per_stage):
            cout, cmid = cfg.stage_channels[si], cfg.bottleneck_channels[si]
            blocks = nn.ModuleList()
            for bi in range(nblocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(cin, cout, cmid, stride, g))
                cin = cout
            self.stages.append(blocks)
        fc = cfg.fpn_channels
        self.lateral = nn.ModuleList([ConvGN(c, fc, 1, g, relu=False)
                                      for c in cfg.stage_channels])
        self.fpn_out = nn.ModuleList([ConvGN(fc, fc, 3, g, relu=False)
                                      for _ in cfg.stage_channels])
        self.heatmap_head = ScaleHead(cfg, (2, 3, 4, 5), cfg.sem_common_stride,
                                      cfg.heatmap_classes)
        self.pose_head = ScaleHead(cfg, (3, 4, 5), cfg.pose_common_stride,
                                   cfg.pose_classes)

    def _fpn(self, feats):
        """res2..res5 -> p2..p5 (nearest 2x top-down, sum fusion)."""
        prev = self.lateral[-1](feats[-1])
        outs = [self.fpn_out[-1](prev)]
        for i in range(len(feats) - 2, -1, -1):
            up = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            prev = self.lateral[i](feats[i]) + up
            outs.insert(0, self.fpn_out[i](prev))
        return outs

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """rgb (B, H, W, 3) ImageNet-normalized; depth (B, H, W) or
        (B, H, W, 1). Returns heatmap (B, H, W, 1) in [0, 1], pose_map
        (B, H/2, W/2, 12) and small_disp (B, H/4, W/4, 1), NHWC."""
        if depth.dim() == 3:
            depth = depth[..., None]
        rgb_f = self.rgb_stem(rgb.permute(0, 3, 1, 2))
        small_disp = self.depth_stem(depth.permute(0, 3, 1, 2))
        x = torch.cat([self.disp_feat(small_disp), rgb_f], dim=1)
        feats = []
        for blocks in self.stages:
            for blk in blocks:
                x = blk(x)
            feats.append(x)
        pyramid = dict(zip((2, 3, 4, 5), self._fpn(feats)))
        cs = self.cfg.sem_common_stride
        heat = self.heatmap_head(pyramid)
        heat = resize_bilinear(heat, (heat.shape[-2] * cs, heat.shape[-1] * cs),
                               nchw=True, align_corners=False)
        pose = self.pose_head(pyramid)
        return {"heatmap": torch.sigmoid(heat).permute(0, 2, 3, 1),
                "pose_map": pose.permute(0, 2, 3, 1),
                "small_disp": small_disp.permute(0, 2, 3, 1)}
