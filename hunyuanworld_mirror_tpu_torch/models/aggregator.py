"""Visual geometry transformer: alternating frame/global attention over views.

Port of hunyuanworld_mirror_tpu/models/aggregator.py. DINOv2 (or conv)
patch encoder, per-frame special tokens (camera + registers, frame 0
distinct), prior prompting under `enable_cond` (a pose token and a ray
token, zero when their flag is off or their prior absent, and depth-prior
tokens added to the patch tokens), 2D RoPE, `depth` pairs of (frame,
global) blocks run as a Python loop over two ModuleLists, and capture of
concat(frame_out, global_out) at `intermediate_idxs`. With `frame_only`
(the 6D-pose fork's trunk) no global block is built and the capture is the
frame output itself. The patch embed is the DINOv2 encoder named by
`patch_embed`, or for a name holding "conv" a conv patchify ("conv…mlp":
the PixelUnshuffle + Mlp patchify).
"""

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import dinov2
from .block import Block
from .nn import Mlp, silu_mlp, trunc_normal_
from ..utils.profiling import mark
from .rope import grid_positions, make_rope_tables, tile_tables

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class VGTConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    patch_embed: str = "dinov2_vitl14_reg"
    qk_norm: bool = True
    rope_freq: float = 100.0
    init_values: float = 0.01
    enable_cond: bool = False
    intermediate_idxs: Tuple[int, ...] = (4, 11, 17, 23)
    frame_only: bool = False

    @property
    def patch_start_idx(self) -> int:
        # [cam | registers | (pose | ray |)] patches
        return 1 + self.num_register_tokens + (2 if self.enable_cond else 0)

    @property
    def vit_config(self) -> dinov2.DinoViTConfig:
        return replace(dinov2.VIT_FACTORIES[self.patch_embed],
                       img_size=self.img_size, patch_size=self.patch_size,
                       num_register_tokens=self.num_register_tokens)


class _Permute(nn.Module):
    def __init__(self, *dims):
        super().__init__()
        self.dims = dims

    def forward(self, x):
        return x.permute(*self.dims)


class PatchEmbedMlp(nn.Module):
    """PixelUnshuffle -> Mlp patchify (the depth-prior encoder); state-dict
    names `proj.2.fc1` / `proj.2.fc2` as in the reference."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Sequential(
            nn.PixelUnshuffle(patch_size), _Permute(0, 2, 3, 1),
            Mlp(in_chans * patch_size ** 2, 4 * embed_dim, embed_dim),
            _Permute(0, 3, 1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, h*w, embed_dim); the channel order of
        F.pixel_unshuffle, as the JAX patch_embed_mlp lays it out."""
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class VisualGeometryTransformer(nn.Module):
    def __init__(self, cfg: VGTConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        if "conv" in cfg.patch_embed:
            if "mlp" in cfg.patch_embed:
                self.patch_embed = PatchEmbedMlp(cfg.patch_size, 3, C)
            else:
                self.patch_embed = dinov2.PatchEmbed(cfg.patch_size, 3, C)
        elif cfg.patch_embed in dinov2.VIT_FACTORIES:
            self.patch_embed = dinov2.DinoVisionTransformer(cfg.vit_config)
        else:
            raise ValueError(f"unknown patch_embed {cfg.patch_embed!r}")
        # (1, 2, X, C): slot 0 is frame 0's token, slot 1 every other frame's
        self.cam_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.reg_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, C))

        def blocks():
            return nn.ModuleList([
                Block(C, cfg.num_heads, cfg.mlp_ratio, init_values=cfg.init_values,
                      qk_norm=cfg.qk_norm, norm_eps=1e-5)
                for _ in range(cfg.depth)])

        self.frame_blocks = blocks()
        self.global_blocks = None if cfg.frame_only else blocks()
        if cfg.enable_cond:
            self.pose_embed = silu_mlp(7, C, C)
            self.depth_embed = PatchEmbedMlp(cfg.patch_size, 1, C)
            self.ray_embed = silu_mlp(4, C, C)

    def init_own(self, gen):
        trunc_normal_(self.cam_token, 1e-6, gen)
        trunc_normal_(self.reg_token, 1e-6, gen)

    def _special(self, token, b: int, s: int, dtype, first: bool = True):
        """(1, 2, X, C) -> (B*S, X, C): slot 0 for frame 0, slot 1 the rest.
        first=False: the frames hold no global frame 0 (a view rank past the
        first), slot 1 for all of them."""
        n0 = 1 if first else 0
        t = torch.cat([token[:, 0:1].expand(b, n0, *token.shape[2:]),
                       token[:, 1:2].expand(b, s - n0, *token.shape[2:])], dim=1)
        return t.reshape(b * s, *token.shape[2:]).to(dtype)

    def forward(self, images: torch.Tensor, priors: Optional[Tuple] = None,
                cond_flags: Sequence[int] = (0, 0, 0),
                dtype=torch.bfloat16, marks: Optional[List] = None,
                mesh=None) -> Tuple[List[torch.Tensor], int]:
        """(B, S, H, W, 3) images in [0, 1] -> (4 intermediates, each
        (B, S, N, 2C), or (B, S, N, C) with `frame_only`; patch_start_idx).

        priors: optional (depth maps (B,S,H,W), rays (B,S,4), poses
        (B,S,7)), any of them None; cond_flags: (pose, depth, rays) switches.
        `marks`: see utils/profiling.py.

        mesh: B and S are this rank's shard (parallel/mesh.py); the global
        layers then run ring attention over the mesh's view axis, and only
        the first view rank holds global frame 0. The encoder and the frame
        layers stay on the rank's own frames."""
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        C = cfg.embed_dim
        h0, w0 = H // cfg.patch_size, W // cfg.patch_size
        dev = images.device

        mean = torch.tensor(_RESNET_MEAN, device=dev).to(dtype)
        std = torch.tensor(_RESNET_STD, device=dev).to(dtype)
        imgs = (images.reshape(B * S, H, W, 3).to(dtype) - mean) / std
        if "conv" in cfg.patch_embed:
            patch_tokens = self.patch_embed(imgs)
        else:
            patch_tokens = self.patch_embed.forward_features(imgs)
        mark(marks, "encoder")

        first = mesh is None or mesh.index("view") == 0
        parts = [self._special(self.cam_token, B, S, dtype, first),
                 self._special(self.reg_token, B, S, dtype, first)]
        if cfg.enable_cond:
            depths, rays, poses = priors if priors is not None else (None,) * 3
            zero = torch.zeros(B * S, 1, C, dtype=dtype, device=dev)
            pose_tok = ray_tok = zero
            if cond_flags[0] and poses is not None:
                pose_tok = self.pose_embed(poses.reshape(B * S, 7).to(dtype))[:, None]
            if cond_flags[1] and depths is not None:
                patch_tokens = patch_tokens + self.depth_embed(
                    depths.reshape(B * S, H, W, 1).to(dtype))
            if cond_flags[2] and rays is not None:
                ray_tok = self.ray_embed(rays.reshape(B * S, 4).to(dtype))[:, None]
            parts += [pose_tok, ray_tok]
        tokens = torch.cat(parts + [patch_tokens], dim=1)
        N = tokens.shape[1]

        rope_frame = rope_global = None
        if cfg.rope_freq > 0:
            pos = grid_positions(h0, w0, cfg.patch_start_idx)
            rope_frame = make_rope_tables(pos, C // cfg.num_heads,
                                          cfg.rope_freq, device=dev)
            rope_global = None if cfg.frame_only else tile_tables(rope_frame, S)

        x = tokens
        captured = {}
        capture = set(cfg.intermediate_idxs)
        for i in range(cfg.depth):
            xf = self.frame_blocks[i](x.reshape(B * S, N, C), rope_frame)
            if cfg.frame_only:
                x = xf
                if i in capture:
                    captured[i] = xf.reshape(B, S, N, C)
                continue
            x = self.global_blocks[i](xf.reshape(B, S * N, C), rope_global, mesh)
            if i in capture:
                captured[i] = torch.cat([xf.reshape(B, S, N, C),
                                         x.reshape(B, S, N, C)], dim=-1)
        return [captured[i] for i in cfg.intermediate_idxs], cfg.patch_start_idx
