"""Layer primitives: the JAX package's models/nn.py as nn.Modules.

Parameters keep the reference torch layouts and names (Linear (out, in),
Conv2d OIHW, ConvTranspose2d IOHW), so a reference state dict loads as is.
Computation follows the JAX package: a layer casts its parameters to the
input's dtype (the bf16 trunk keeps f32 or bf16 parameters alike), and
LayerNorm always takes its statistics and affine in f32.

`init_weights(module, generator)` fills every parameter from the JAX
package's distributions (truncated normal 0.02 for linears, torch-default
kaiming-uniform for convs, ...) with an explicit torch.Generator; the values
differ from JAX's for the same seed, the distributions do not.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import trunk_norm
from ..parallel import comm


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """N(0, 1) truncated to [-2, 2], times std (jax.random.truncated_normal)."""
    with torch.no_grad():
        t.normal_(generator=gen)
        bad = t.abs() > 2.0
        while bool(bad.any()):
            t[bad] = torch.randn(int(bad.sum()), generator=gen,
                                 device=t.device, dtype=t.dtype)
            bad = t.abs() > 2.0
        t.mul_(std)
    return t


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


class Linear(nn.Linear):
    """x @ W^T + b in the input's dtype (JAX nn.linear)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

    def init_own(self, gen):
        trunc_normal_(self.weight, 0.02, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and affine, output in the input dtype:
    ops/trunk_norm.layer_norm (on the card, one launch of PyTorch's bf16
    LayerNorm for a bf16 input with bf16 parameters)."""

    def __init__(self, dim: int, eps: float, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if affine else None
        self.bias = nn.Parameter(torch.zeros(dim)) if affine else None

    def forward(self, x):
        return trunk_norm.layer_norm(x, self.weight, self.bias, self.eps)

    def init_own(self, gen):
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)

    def init_own(self, gen):
        nn.init.constant_(self.gamma, self.init_value)


def row_parallel(layer: Linear, x, tp):
    """A row-parallel linear layer (parallel/sharding.py): this rank's
    partial product summed over the model group `tp`, then the bias, once.
    Without a group, the layer itself."""
    if tp is None:
        return layer(x)
    y = comm.reduce_from_tp(F.linear(x, layer.weight.to(x.dtype)), tp)
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact (erf) GELU -> fc2. Under tensor parallelism (`tp`, the
    model group, set by parallel.sharding.shard_model) fc1 holds this
    rank's hidden units (column parallel) and fc2 the matching inputs (row
    parallel)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim)
        self.tp = None

    def forward(self, x):
        if self.tp is not None:
            x = comm.copy_to_tp(x, self.tp)
        return row_parallel(self.fc2, F.gelu(self.fc1(x), approximate="none"), self.tp)


def swiglu_hidden_fused(hidden_dim: int) -> int:
    """The fused SwiGLU's hidden width: 2/3 of the MLP width, rounded up to
    a multiple of 8."""
    return (int(hidden_dim * 2 / 3) + 7) // 8 * 8


class SwiGLUFFN(nn.Module):
    """One projection to 2 * hidden, silu(x1) * x2, then back (the reference
    SwiGLUFFNFused of DINOv2's giant2; state-dict names `w12`, `w3`)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.w12 = Linear(in_dim, 2 * hidden_dim)
        self.w3 = Linear(hidden_dim, out_dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


def silu_mlp(in_dim: int, hidden_dim: int, out_dim: int) -> nn.Sequential:
    """Linear -> SiLU -> Linear (state-dict names .0 / .2)."""
    return nn.Sequential(Linear(in_dim, hidden_dim), nn.SiLU(),
                         Linear(hidden_dim, out_dim))


class Conv2d(nn.Conv2d):
    """NCHW conv in the input's dtype; kaiming-uniform init (a = sqrt 5)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation)

    def init_own(self, gen):
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        uniform_(self.weight, 1.0 / math.sqrt(fan_in), gen)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(fan_in), gen)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW with f32 statistics and affine, output in the
    input dtype. The group count clamps to the largest divisor of the
    channel count not above `num_groups` (one channel: instance norm), as
    the JAX package's group_norm does."""

    def __init__(self, dim: int, num_groups: int = 16, eps: float = 1e-5):
        super().__init__()
        g = min(num_groups, dim)
        while dim % g:
            g -= 1
        self.groups, self.eps = g, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)

    def init_own(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Stride == kernel deconv (the DPT resize layers).

    The weight is the reference IOHW tensor used as is: the spatial flip that
    the JAX package applies at run time lives only in convert.py.
    """

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride)

    def init_own(self, gen):
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        uniform_(self.weight, 1.0 / math.sqrt(fan_in), gen)
        uniform_(self.bias, 1.0 / math.sqrt(fan_in), gen)


def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Fill every parameter of `module`: each submodule with an `init_own`
    initializes the parameters it owns. Children run before their parents,
    so a parent's init (the gs-head's per-segment conv) overrides a child's
    default."""
    for m in reversed(list(module.modules())):
        if hasattr(m, "init_own"):
            m.init_own(gen)
