"""Iterative camera regression head.

Port of hunyuanworld_mirror_tpu/models/camera_head.py: the per-view camera
token (dim 2C) goes through `steps` refinements of adaptive LayerNorm
modulation (shift/scale/gate from the current estimate) -> the 4-block
`refine_net` (tokens attend across views; f32, 16 heads of 128) -> an MLP
delta, activated per step (trans, quat linear; fov relu).
"""

from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm
from .block import Block
from .nn import LayerNorm, Linear, Mlp


@dataclass(frozen=True)
class CameraHeadConfig:
    dim_in: int = 2048
    trunk_depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 0.01
    out_dim: int = 9


def activate(params: torch.Tensor) -> torch.Tensor:
    """trans: linear, quat: linear, fov: relu."""
    return torch.cat([params[..., :7], F.relu(params[..., 7:])], dim=-1)


class CameraHead(nn.Module):
    def __init__(self, cfg: CameraHeadConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim_in
        self.refine_net = nn.ModuleList([
            Block(D, cfg.num_heads, cfg.mlp_ratio, init_values=cfg.init_values,
                  norm_eps=1e-5) for _ in range(cfg.trunk_depth)])
        self.token_norm = LayerNorm(D, 1e-5)
        self.out_norm = LayerNorm(D, 1e-5)
        self.adaptive_norm = LayerNorm(D, 1e-6, affine=False)
        self.init_token = nn.Parameter(torch.zeros(1, 1, cfg.out_dim))
        self.param_embed = Linear(cfg.out_dim, D)
        self.adapt_norm_gen = nn.Sequential(nn.SiLU(), Linear(D, 3 * D))
        self.param_predictor = Mlp(D, D // 2, cfg.out_dim)

    def init_own(self, gen):
        nn.init.zeros_(self.init_token)

    def forward(self, feat_seq: List[torch.Tensor], steps: int = 4,
                mesh=None) -> List[torch.Tensor]:
        """Intermediates (B, S, N, 2C) -> list of (B, S, 9), one per step.

        mesh: S is this rank's views; the trunk attends across all views, so
        the camera tokens are gathered over the view axis (a differentiable
        all_gather), the head runs on every view and the rank keeps its own."""
        tok = feat_seq[-1][:, :, 0]
        s_local = tok.shape[1]
        if mesh is not None:
            tok = comm.all_gather(tok, mesh.group("view"), dim=1)
        cam = self.token_norm(tok.float())                       # (B, S, D)
        B, S, _ = cam.shape
        preds, curr = [], None
        for _ in range(steps):
            inp = (self.init_token.expand(B, S, -1) if curr is None
                   else curr.detach())
            shift, scale, gate = self.adapt_norm_gen(
                self.param_embed(inp)).chunk(3, dim=-1)
            feat = gate * (self.adaptive_norm(cam) * (1 + scale) + shift) + cam
            for blk in self.refine_net:
                feat = blk(feat)
            delta = self.param_predictor(self.out_norm(feat))
            curr = delta if curr is None else curr + delta
            preds.append(activate(curr))
        if mesh is not None:
            v = mesh.index("view")
            preds = [p[:, v * s_local:(v + 1) * s_local] for p in preds]
        return preds
