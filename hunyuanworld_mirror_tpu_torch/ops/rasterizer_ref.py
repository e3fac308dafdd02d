"""Dense per-pixel oracle of the front-to-back blend, with no binning.

Port of hunyuanworld_mirror_tpu/ops/rasterizer_ref.py (gsplat's
RasterizeToPixels3DGSFwd.cu semantics):
  * pixel centre at +0.5; sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, rounded
    op by op in that order, as the kernels' conic_sigma and the plain
    blends round it (csrc/raster_common.cuh);
  * alpha = min(0.999, opacity e^-sigma); skipped if sigma < 0 or
    alpha < 1/255;
  * front-to-back transmittance; a splat that would push T to 1e-4 or
    below is itself not blended (exclusive early stop) and blending ends;
  * a splat reaches only the tiles its radius box overlaps.

The splats are ordered by an argsort of their depths, not by the binning's
quantized keys, and the early stop is computed in closed form over the
sorted alphas (an exclusive cumprod), which equals the sequential loop
because the alphas are non-negative and T falls monotonically. So a fault
in ops/tiles.py cannot hide here, as it could in a kernel's plain version,
which walks the binning's own lists.

O(H W N) in memory and time (each intermediate holds N H W values): a
tool for tests and small scenes only; no user path calls it.
"""

from typing import Optional, Tuple

import torch

from .rasterizer_flat import ALPHA_THRESHOLD, T_EPS
from .tiles import tile_ranges


def rasterize_reference(
    means2d: torch.Tensor,    # (N, 2)
    conics: torch.Tensor,     # (N, 3)
    colors: torch.Tensor,     # (N, D)
    opacities: torch.Tensor,  # (N,)
    depths: torch.Tensor,     # (N,)
    radii: torch.Tensor,      # (N, 2) int, 0 marks culled
    width: int, height: int, tile_size: int = 16,
    backgrounds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize one camera -> (colors (H, W, D), alphas (H, W, 1))."""
    dev = means2d.device
    order = torch.argsort(depths, stable=True)
    means2d, conics, colors = means2d[order], conics[order], colors[order]
    opacities, radii = opacities[order], radii[order]

    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    tmin, tmax, live = tile_ranges(means2d, radii, tile_size, tw, th)
    tile_x = (torch.arange(width, device=dev) // tile_size)[None, None, :]
    tile_y = (torch.arange(height, device=dev) // tile_size)[None, :, None]
    in_tile = ((tile_x >= tmin[:, 0, None, None]) & (tile_x < tmax[:, 0, None, None])
               & (tile_y >= tmin[:, 1, None, None]) & (tile_y < tmax[:, 1, None, None]))

    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    dx = xs - means2d[:, 0, None, None]                     # (N, 1, W)
    dy = ys - means2d[:, 1, None, None]                     # (N, H, 1)
    ca, cb, cc = (conics[:, i, None, None] for i in range(3))
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy   # (N, H, W)
    alpha = torch.clamp_max(opacities[:, None, None] * torch.exp(-sigma), 0.999)
    keep = (sigma >= 0) & (alpha >= ALPHA_THRESHOLD) & in_tile & live[:, None, None]
    alphas = torch.where(keep, alpha, torch.zeros_like(alpha))
    del sigma, alpha, keep, in_tile

    # the transmittance before each splat (exclusive cumprod)
    one_minus = 1.0 - alphas
    T_before = torch.cat([torch.ones_like(alphas[:1]),
                          torch.cumprod(one_minus, dim=0)[:-1]])
    # exclusive early stop: splat i is blended iff no j <= i tripped the bound
    tripped = (T_before * one_minus <= T_EPS) & (alphas > 0)
    stopped_before = torch.cat([torch.zeros_like(tripped[:1]),
                                torch.cumsum(tripped, dim=0)[:-1] > 0])
    blend = ~(tripped | stopped_before)
    weights = torch.where(blend, alphas * T_before, torch.zeros_like(alphas))

    out = torch.einsum("nhw,nd->hwd", weights, colors.float())
    alpha_out = weights.sum(dim=0)[..., None]
    if backgrounds is not None:
        out = out + backgrounds[None, None, :] * (1.0 - alpha_out)
    return out, alpha_out
