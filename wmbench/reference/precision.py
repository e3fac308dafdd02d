"""The precision the reference computes in, and the control's lower one.

The reference computes every stage in float32 with TF32 off. The control
is the same reference, each stage one step below what the configuration
states (the step a later change would be tempted to take): the bf16 trunk
in fp8 (e4m3, one scale a tensor), the f32 heads in TF32, the f32 render
in bf16. Each rounding is applied explicitly to what enters a matrix
product, a convolution or the blend, so the control computes the same
numbers on the CPU as on the card.
"""

from typing import Callable, NamedTuple, Optional

import torch


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round to float8 e4m3 under one scale that maps `amax` to 448: |x|'s
    max, or that of the whole tensor `x` is a block of."""
    if amax is None:
        amax = x.detach().abs().amax()
    s = torch.clamp_min(amax, 1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10 mantissa bits, to nearest, ties away."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class Precision(NamedTuple):
    trunk: Callable   # applied to the encoder's and trunk's matmul inputs
    heads: Callable   # to the heads' matmul and convolution inputs
    render: Callable  # to the splats' projected rows the blend reads


REFERENCE = Precision(_same, _same, _same)
CONTROL = Precision(fp8, tf32, bf16)


def f32_exact() -> None:
    """TF32 off for matmuls and cuDNN, so float32 means float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
