"""Activations mapping raw Gaussian-head outputs to splat parameters.

Port of hunyuanworld_mirror_tpu/utils/gs_act.py.
"""

import math

import torch


def reg_dense_offsets(xyz: torch.Tensor, shift: float = 6.0) -> torch.Tensor:
    """Direction-preserving bounded offsets: dir * (e^(|d|-shift) - e^-shift)."""
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    return xyz / torch.clamp_min(d, 1e-8) * (torch.exp(d - shift) - math.exp(-shift))


def reg_dense_scales(scales: torch.Tensor) -> torch.Tensor:
    return torch.exp(scales)


def reg_dense_rotation(rotations: torch.Tensor, eps: float = 1e-8
                       ) -> torch.Tensor:
    return rotations / (torch.linalg.norm(rotations, dim=-1, keepdim=True) + eps)


def reg_dense_sh(sh: torch.Tensor) -> torch.Tensor:
    """(..., nums_sh * 3) -> (..., nums_sh, 3)."""
    return sh.reshape(sh.shape[:-1] + (-1, 3))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + e^-x), spelled as the JAX package spells it."""
    return 1.0 / (1.0 + torch.exp(-x))


reg_dense_opacities = sigmoid
reg_dense_weights = sigmoid
