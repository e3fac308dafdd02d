"""Prior-input normalization (camera poses and depth maps), batched.

Port of hunyuanworld_mirror_tpu/utils/priors.py. The quantiles are linear
as jnp.quantile / jnp.nanquantile compute them. The depth quantiles come
from one sort of the (B*S, H*W) stack with the linear interpolation written
out, on the tensor's own device: torch.nanquantile refuses an input of
more than 2^24 elements, which that stack passes from B*S = 63 at 518 px.
"""

import torch


def sorted_nanquantile(x: torch.Tensor, qs) -> torch.Tensor:
    """Linear quantiles `qs` of each row of (R, N) `x`, NaNs left out (NaN
    for a row with none valid) -> (len(qs), R): one sort, ascending, which
    puts NaNs last."""
    v = torch.sort(x, dim=-1).values
    n = (~torch.isnan(x)).sum(dim=-1)
    pos = torch.tensor(qs, dtype=x.dtype, device=x.device)[:, None] * (
        n - 1).clamp_min(0).to(x.dtype)                            # (Q, R)
    lo = torch.floor(pos)
    w_hi = pos - lo
    v_lo = torch.gather(v, -1, lo.long().T).T
    v_hi = torch.gather(v, -1, torch.ceil(pos).long().T).T
    out = v_lo * (1.0 - w_hi) + v_hi * w_hi
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


def normalize_poses(extrinsics: torch.Tensor, padding: float = 0.1
                    ) -> torch.Tensor:
    """(B, S, 3, 4) extrinsics -> the same with the translations (camera
    centres) normalised into the unit cube per batch element: bounds from
    the 5/95 percentiles when S > 10, else min/max; rotations unchanged."""
    S = extrinsics.shape[1]
    ext = torch.nan_to_num(extrinsics, nan=0.0, posinf=1e6, neginf=-1e6)
    positions = ext[:, :, :3, 3]                                  # (B, S, 3)
    if S > 10:
        min_pos = torch.quantile(positions, 0.05, dim=1, interpolation="linear")
        max_pos = torch.quantile(positions, 0.95, dim=1, interpolation="linear")
    else:
        min_pos = positions.amin(dim=1)
        max_pos = positions.amax(dim=1)
    eps = torch.clamp_min(max_pos.abs() * 1e-6, 1e-6)
    pos_range = torch.maximum(max_pos - min_pos, eps)
    scale = torch.clamp(pos_range.amax(dim=-1), 1e-6, 1e6)        # (B,)
    center = (min_pos + max_pos) / 2.0
    actual_scale = scale / (1.0 - 2.0 * padding)
    normalized = (positions - center[:, None, :]) / actual_scale[:, None, None] + 0.5
    out = ext.clone()
    out[:, :, :3, 3] = torch.clamp(normalized, 0.0, 1.0)
    return out


def normalize_depth(depth: torch.Tensor, eps: float = 1e-6,
                    min_percentile: float = 1, max_percentile: float = 99
                    ) -> torch.Tensor:
    """(B, S, H, W) depth -> [0, 1] per image. Zero pixels are left out of
    the bounds: the 1st/99th percentiles with more than 100 valid pixels,
    else the non-zero min/max, else the min/max of all; a constant image
    gets a unit range."""
    B, S, H, W = depth.shape
    flat = torch.nan_to_num(depth, nan=0.0, posinf=1e6, neginf=0.0).reshape(
        B * S, H * W)
    mask = flat > 0
    n_valid = mask.sum(dim=-1)
    masked = torch.where(mask, flat, torch.full_like(flat, float("nan")))
    q_lo, q_hi = sorted_nanquantile(masked, (min_percentile / 100.0,
                                             max_percentile / 100.0))
    inf = torch.full_like(flat, float("inf"))
    mn_nz = torch.where(mask, flat, inf).amin(dim=-1)
    mx_nz = torch.where(mask, flat, -inf).amax(dim=-1)
    mn_all = flat.amin(dim=-1)
    mx_all = flat.amax(dim=-1)
    use_q, has_nz = n_valid > 100, n_valid > 0
    d_min = torch.where(use_q, q_lo, torch.where(has_nz, mn_nz, mn_all))
    d_max = torch.where(use_q, q_hi, torch.where(has_nz, mx_nz, mx_all))
    d_max = torch.where(d_max == d_min, d_min + 1.0, d_max)
    eps_val = torch.clamp_min(torch.abs(d_max - d_min) * eps, eps)
    out = (flat - d_min[:, None]) / (d_max - d_min + eps_val)[:, None]
    return torch.clamp(out, 0.0, 1.0).reshape(B, S, H, W)


def normalize_depth_fixed(depth: torch.Tensor, max_depth: float = 25.0
                          ) -> torch.Tensor:
    """Fixed-range depth normalization (the 6D-pose training fork's)."""
    return torch.clamp(depth, 0.0, max_depth) / max_depth
