"""Transformer blocks: MHA (optional QK-norm + 2D RoPE) and the pre-LN block.

Port of hunyuanworld_mirror_tpu/models/block.py. The softmax core goes
through one seam, ops.attention.attention(q, k, v, scale), in the JAX
package's (B, N, H, D) layout: kernel K1 on the card, its plain version on
the CPU. The QK-norm and RoPE go through ops.trunk_norm.qk_norm_rope, one
launch of kernel K8 for a bf16 q and k on the card. The LayerNorm eps is
the call site's: 1e-5 for the trunk and camera-head blocks, 1e-6 inside
DINOv2.
"""

from typing import Optional

from torch import nn

from ..ops.attention import attention, attention_replay
from ..ops.trunk_norm import qk_norm_rope
from ..parallel import comm
from ..parallel.ring import ring_self_attention
from .nn import (LayerNorm, LayerScale, Linear, Mlp, SwiGLUFFN, row_parallel,
                 swiglu_hidden_fused)
from .rope import RopeTables


def _norm(m: Optional[LayerNorm]):
    """A LayerNorm's (weight, bias, eps), None without one."""
    return None if m is None else (m.weight, m.bias, m.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False,
                 norm_eps: float = 1e-5):
        super().__init__()
        self.num_heads = num_heads          # this rank's heads under TP
        self.head_dim = dim // num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        if qk_norm:
            self.q_norm = LayerNorm(self.head_dim, norm_eps)
            self.k_norm = LayerNorm(self.head_dim, norm_eps)
        else:
            self.q_norm = self.k_norm = None
        self.tp = None

    def forward(self, x, rope: Optional[RopeTables] = None, mesh=None):
        B, N, _ = x.shape
        H, D = self.num_heads, self.head_dim
        if self.tp is not None:
            x = comm.copy_to_tp(x, self.tp)
        qkv = self.qkv(x).reshape(B, N, 3, H, D)
        q, k, v = qkv.unbind(2)                    # (B, N, H, D) views
        if self.q_norm is not None or rope is not None:
            q, k = qk_norm_rope(q, k, _norm(self.q_norm), _norm(self.k_norm), rope)
        scale = D ** -0.5
        if mesh is not None:
            out = ring_self_attention(q, k, v, mesh, scale)
        elif q.is_cuda and D % 64:
            out = attention_replay(q, k, v, scale)
        else:
            out = attention(q, k, v, scale)
        return row_parallel(self.proj, out.reshape(B, N, H * D), self.tp)


class Block(nn.Module):
    """Pre-LN transformer block with optional LayerScale. `ffn_layer`:
    "mlp" (fc1, GELU, fc2) or "swiglu" / "swiglufused", which both take the
    fused SwiGLU at its 2/3-rounded width, as the reference does."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = None, qk_norm: bool = False,
                 norm_eps: float = 1e-5, ffn_layer: str = "mlp"):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps)
        self.attn = Attention(dim, num_heads, qk_norm=qk_norm, norm_eps=norm_eps)
        self.ls1 = LayerScale(dim, init_values) if init_values else None
        self.norm2 = LayerNorm(dim, norm_eps)
        if ffn_layer == "mlp":
            self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        elif ffn_layer in ("swiglu", "swiglufused"):
            self.mlp = SwiGLUFFN(dim, swiglu_hidden_fused(int(dim * mlp_ratio)), dim)
        else:
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}")
        self.ls2 = LayerScale(dim, init_values) if init_values else None

    def forward(self, x, rope: Optional[RopeTables] = None, mesh=None):
        h = self.attn(self.norm1(x), rope, mesh)
        x = x + (self.ls1(h) if self.ls1 is not None else h)
        h = self.mlp(self.norm2(x))
        return x + (self.ls2(h) if self.ls2 is not None else h)
