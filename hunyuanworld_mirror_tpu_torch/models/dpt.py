"""DPT dense prediction head (points / depth / normals / Gaussian features).

Port of hunyuanworld_mirror_tpu/models/dpt.py: token LayerNorm, 1x1
projections, multi-scale resize (x4 deconv, x2 deconv, identity, stride-2
conv), 3x3 scratch convs, four top-down fusion blocks with residual conv
units (align-corners bilinear ups), the 2-conv output head with sinusoidal
UV pos-embeds, and the activation zoo. The GS variant also returns the
fused feature map plus a 7x7 RGB `input_merger` injection. The decoder
computes in `compute_dtype` (f32 by default, as the reference's heads;
"bfloat16" halves its memory traffic); the final activations are f32
either way.

The 6D-pose fork's heads switch off the UV pos-embeds (`pos_embed`),
resize the fused map to `patch * grid / down_ratio` (`down_ratio`), and
with `with_conf=False` take every output channel as the attribute under one
activation (`sigmoid`, `linear`), with no confidence.

The decoder runs NCHW internally; inputs and outputs keep the JAX layout
(NHWC). State-dict names follow the reference DPTHead (`projects`,
`resize_layers`, `scratch.layer*_rn`, `scratch.refinenet*`, ...).
"""

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..utils.grid import create_uv_grid, position_grid_to_embed
from .nn import Conv2d, ConvTranspose2d, LayerNorm


@dataclass(frozen=True)
class DPTConfig:
    dim_in: int = 2048
    patch_size: int = 14
    output_dim: int = 4
    activation: str = "inv_log+expp1"
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    pos_embed: bool = True
    down_ratio: int = 1
    is_gsdpt: bool = False
    with_conf: bool = True
    compute_dtype: str = "float32"


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = Conv2d(f, f, 3, padding=1)
        self.conv2 = Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        # the reference's inplace ReLU aliases x, so the skip adds relu(x)
        a = F.relu(x)
        return self.conv2(F.relu(self.conv1(a))) + a


class FeatureFusionBlock(nn.Module):
    def __init__(self, f: int, has_residual: bool = True):
        super().__init__()
        self.out_conv = Conv2d(f, f, 1)
        self.resConfUnit1 = ResidualConvUnit(f) if has_residual else None
        self.resConfUnit2 = ResidualConvUnit(f)

    def forward(self, x, residual=None, size=None):
        if residual is not None:
            x = x + self.resConfUnit1(residual)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[-2] * 2, x.shape[-1] * 2)
        # the 1x1 conv commutes with the bilinear resize: run it first, on
        # the 4x smaller map (same math as the reference's order)
        return resize_bilinear(self.out_conv(x), size, nchw=True)


class _Scratch(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.features
        for i, oc in enumerate(cfg.out_channels):
            setattr(self, f"layer{i + 1}_rn", Conv2d(oc, f, 3, padding=1, bias=False))
        self.refinenet1 = FeatureFusionBlock(f)
        self.refinenet2 = FeatureFusionBlock(f)
        self.refinenet3 = FeatureFusionBlock(f)
        self.refinenet4 = FeatureFusionBlock(f, has_residual=False)
        self.output_conv1 = Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            Conv2d(32, cfg.output_dim, 1))


def _inv_log(x):
    return torch.sign(x) * torch.expm1(torch.abs(x))


_ATTR_ACT = {
    "norm": lambda x: x / torch.linalg.norm(x, dim=-1, keepdim=True),
    "exp": torch.exp,
    "inv_log": _inv_log,
    "sigmoid": torch.sigmoid,
    "linear": lambda x: x,
}
_CONF_ACT = {"expp1": lambda c: 1 + torch.exp(c)}


def activate_head(out: torch.Tensor, activation: str = "inv_log+expp1"):
    """(..., C) NHWC head output -> (attr (..., C-1), conf (...))."""
    act_attr, act_conf = activation.split("+")
    return _ATTR_ACT[act_attr](out[..., :-1]), _CONF_ACT[act_conf](out[..., -1])


def _pos_embed(x: torch.Tensor, w_img: int, h_img: int, ratio: float = 0.1):
    """x (B, C, H, W) + sinusoidal embedding of the UV grid (the grid in
    x's dtype, as the JAX package builds it)."""
    C, ph, pw = x.shape[-3:]
    uv = create_uv_grid(pw, ph, aspect_ratio=w_img / h_img, dtype=x.dtype,
                        device=x.device)
    emb = position_grid_to_embed(uv, C) * ratio
    return x + emb.permute(2, 0, 1)[None].to(x.dtype)


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        oc = cfg.out_channels
        self.norm = LayerNorm(cfg.dim_in, 1e-5)
        self.projects = nn.ModuleList([Conv2d(cfg.dim_in, c, 1) for c in oc])
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(cfg)
        if cfg.is_gsdpt:
            self.input_merger = nn.Sequential(
                Conv2d(3, cfg.features // 2, 7, padding=3), nn.ReLU())

    def tokens_stage(self, token_list: List[torch.Tensor], images: torch.Tensor,
                     patch_start_idx: int) -> List[torch.Tensor]:
        """The first of the decoder's three stages: each level's patch
        tokens normed, projected (1x1), pos-embedded and resized -> four
        NCHW maps at 4x, 2x, 1x and 1/2x the patch grid."""
        cfg = self.cfg
        cdtype = getattr(torch, cfg.compute_dtype)
        B, S, H, W, _ = images.shape
        ph, pw = H // cfg.patch_size, W // cfg.patch_size
        feats = []
        for lvl in range(4):
            t = token_list[lvl][:, :, patch_start_idx:].to(cdtype)
            t = self.norm(t.reshape(B * S, ph * pw, t.shape[-1]))
            f = self.projects[lvl](t.transpose(1, 2).reshape(B * S, -1, ph, pw))
            if cfg.pos_embed:
                f = _pos_embed(f, W, H)
            feats.append(self.resize_layers[lvl](f))
        return feats

    def fusion_stage(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """The second: the scratch 3x3 convs, the four fusion blocks and
        output_conv1 -> (B*S, f/2, 8x grid) NCHW."""
        sc = self.scratch
        l1, l2, l3, l4 = (getattr(sc, f"layer{i + 1}_rn")(feats[i]) for i in range(4))
        out = sc.refinenet4(l4, size=l3.shape[-2:])
        out = sc.refinenet3(out, l3, size=l2.shape[-2:])
        out = sc.refinenet2(out, l2, size=l1.shape[-2:])
        out = sc.refinenet1(out, l1)
        return sc.output_conv1(out)

    def fullres_stage(self, out: torch.Tensor, images: torch.Tensor):
        """The third: the resize to the output size, the pos-embed and the
        full-resolution output convs -> the f32 pre-activation head map
        (B*S, H, W, output_dim) NHWC (plus the fused feature map for gsdpt,
        see forward_raw)."""
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        ph, pw = H // cfg.patch_size, W // cfg.patch_size
        target = (int(ph * cfg.patch_size / cfg.down_ratio),
                  int(pw * cfg.patch_size / cfg.down_ratio))
        fused = resize_bilinear(out, target, nchw=True)
        if cfg.pos_embed:
            fused = _pos_embed(fused, W, H)
        head = self.scratch.output_conv2(fused).float().permute(0, 2, 3, 1)
        if cfg.is_gsdpt:
            img = images.reshape(B * S, H, W, 3).to(getattr(torch, cfg.compute_dtype))
            img = img.permute(0, 3, 1, 2)
            fused = fused + self.input_merger(img)
            return head, fused.permute(0, 2, 3, 1)
        return head

    def forward_raw(self, token_list: List[torch.Tensor], images: torch.Tensor,
                    patch_start_idx: int):
        """Decode to the f32 pre-activation head map (B*S, H, W, output_dim)
        (plus the fused feature map (B*S, H, W, f/2), in the compute dtype,
        for gsdpt), NHWC: the three stages in turn."""
        feats = self.tokens_stage(token_list, images, patch_start_idx)
        return self.fullres_stage(self.fusion_stage(feats), images)

    def forward(self, token_list, images, patch_start_idx: int):
        """-> (preds (B,S,H,W,C-1), conf (B,S,H,W)), plus the fused map
        (B,S,H,W,f/2) first for gsdpt; with `with_conf=False`, preds
        (B,S,H',W',C) and conf None."""
        cfg = self.cfg
        B, S = images.shape[:2]
        out = self.forward_raw(token_list, images, patch_start_idx)
        head = out[0] if cfg.is_gsdpt else out
        if cfg.with_conf:
            preds, conf = activate_head(head, cfg.activation)
            conf = conf.reshape(B, S, *conf.shape[1:])
        else:
            preds, conf = _ATTR_ACT[cfg.activation.split("+")[0]](head), None
        preds = preds.reshape(B, S, *preds.shape[1:])
        if cfg.is_gsdpt:
            return out[1].reshape(B, S, *out[1].shape[1:]), preds, conf
        return preds, conf
