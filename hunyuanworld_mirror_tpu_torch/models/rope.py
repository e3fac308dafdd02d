"""2D axial rotary position embedding with precomputed tables.

Port of hunyuanworld_mirror_tpu/models/rope.py: frequency base 100, head dim
split into y/x halves, each half rotated 1-D; special tokens pinned at
(0, 0), patch grid shifted by +1. The rotation itself, apply_rope2d, is
the plain version of kernel K8's RoPE stage and lives beside it in
ops/trunk_norm.py; it is re-exported here.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops.trunk_norm import apply_rope2d  # noqa: F401
from ..utils import profiling


class RopeTables(NamedTuple):
    """Per-token rotation tables, each (N, head_dim // 2)."""
    cos_y: torch.Tensor
    sin_y: torch.Tensor
    cos_x: torch.Tensor
    sin_x: torch.Tensor


def grid_positions(h: int, w: int, n_special: int) -> np.ndarray:
    """(n_special + h*w, 2) integer (y, x) positions."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([ys.reshape(-1), xs.reshape(-1)], axis=-1) + 1
    return np.concatenate([np.zeros((n_special, 2), np.int64), pos], axis=0)


def make_rope_tables(positions: np.ndarray, head_dim: int,
                     frequency: float = 100.0, device=None) -> RopeTables:
    """cos/sin tables (f32, computed in f64) for integer (N, 2) positions."""
    half = head_dim // 2
    inv_freq = 1.0 / (frequency ** (np.arange(0, half, 2, dtype=np.float64)
                                    / half))

    def tables(p):
        ang = p[:, None].astype(np.float64) * inv_freq[None, :]
        ang = np.concatenate([ang, ang], axis=-1)
        profiling.count("host_syncs", 2)    # two uploads from pageable memory
        return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
                torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))

    cos_y, sin_y = tables(positions[:, 0])
    cos_x, sin_x = tables(positions[:, 1])
    return RopeTables(cos_y, sin_y, cos_x, sin_x)


def tile_tables(tables: RopeTables, reps: int) -> RopeTables:
    """Repeat the per-frame tables `reps` times along N (global attention)."""
    return RopeTables(*(t.repeat(reps, 1) for t in tables))
