"""UV grids and sinusoidal 2D position embeddings for the dense heads.

Port of hunyuanworld_mirror_tpu/utils/grid.py (omega base 100,
aspect-ratio diagonal normalization).
"""

import numpy as np
import torch


def create_uv_grid(width: int, height: int, aspect_ratio: float = None,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized UV grid of shape (H, W, 2) spanning +-span/diagonal."""
    if aspect_ratio is None:
        aspect_ratio = float(width) / float(height)
    diag_factor = (aspect_ratio ** 2 + 1.0) ** 0.5
    span_x = aspect_ratio / diag_factor
    span_y = 1.0 / diag_factor
    x = np.linspace(-span_x * (width - 1) / width,
                    span_x * (width - 1) / width, width)
    y = np.linspace(-span_y * (height - 1) / height,
                    span_y * (height - 1) / height, height)
    uu, vv = np.meshgrid(x, y)
    return torch.as_tensor(np.stack([uu, vv], axis=-1), dtype=dtype,
                           device=device)


def position_grid_to_embed(pos_grid: torch.Tensor, embed_dim: int,
                           omega_0: float = 100.0) -> torch.Tensor:
    """(H, W, 2) positions -> (H, W, embed_dim) sinusoidal embedding."""
    H, W, _ = pos_grid.shape
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 4, dtype=np.float64) / (embed_dim / 4.0)
    omega = torch.as_tensor(1.0 / omega_0 ** omega, dtype=torch.float32,
                            device=pos_grid.device)
    pos = pos_grid.reshape(-1, 2)
    out_x = pos[:, 0:1] * omega[None, :]
    out_y = pos[:, 1:2] * omega[None, :]
    emb = torch.cat([torch.sin(out_x), torch.cos(out_x),
                     torch.sin(out_y), torch.cos(out_y)], dim=-1)
    return emb.reshape(H, W, embed_dim)
