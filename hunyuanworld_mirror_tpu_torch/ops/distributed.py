"""The per-rank body of the distributed Gaussian render.

Port of hunyuanworld_mirror_tpu/ops/distributed.py `_project_for_cameras`
and `_render_local_cameras`: project a splat shard for every camera, then
tile-bin (dense bins, ops/tiles.bin_gaussians) and blend each local camera
over all splats with kernel K4 (ops/rasterizer_binned.py). The collective
protocol around them, `rasterize_distributed`'s all_gather and all_to_all,
is not ported yet (ROADMAP Queue 1 item 9).

This path keeps the JAX path's own choices: the projection's radii (not
opacity-tight), `max_per_tile` as given (no cap to the splat count), the
exact ellipse-tile test, and colours and alpha only (no meta). It renders
RGB+ED, the only mode the port's renders use.
"""

import torch

from . import projection, tiles
from .rasterizer import _colors, depth_by_alpha
from .rasterizer_binned import RasterizeBinned


def project_for_cameras(means: torch.Tensor, covars, opacities: torch.Tensor,
                        colors: torch.Tensor, viewmats: torch.Tensor,
                        Ks: torch.Tensor, width: int, height: int):
    """Project N splats (covars: the six planes) for all C cameras ->
    (means2d (C, N, 2), conics (C, N, 3), depths (C, N), radii (C, N, 2),
    colours (C, N, D), opacities (C, N)). colors are (N, D), or SH
    (N, K, 3) coloured toward each camera as the render does."""
    proj = projection.fully_fused_projection(means, covars, viewmats, Ks,
                                             width, height)
    col = torch.stack([_colors(colors, means, viewmats[c])
                       for c in range(viewmats.shape[0])])
    op = opacities[None].expand(viewmats.shape[0], *opacities.shape)
    return proj.means2d, proj.conics, proj.depths, proj.radii, col, op


def bin_local_camera(m2d, con, dep, rad, col, op, width: int, height: int,
                     tile_size: int = 16, max_per_tile: int = 1024,
                     max_tiles_per_gauss: int = 9):
    """One camera's blend inputs (each (N, ...)) -> (colours + depth
    (N, D + 1), dense bins with the exact ellipse-tile test)."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    bins = tiles.bin_gaussians(m2d, rad, dep, tile_size, tw, th,
                               max_tiles_per_gauss, max_per_tile,
                               conic_test=tiles.conic_test_planes(con, op))
    return torch.cat([col, dep[:, None]], dim=-1), bins


def render_local_cameras(m2d, con, dep, rad, col, op, width: int, height: int,
                         tile_size: int = 16, max_per_tile: int = 1024,
                         max_tiles_per_gauss: int = 9):
    """Bin (bin_local_camera) and blend each local camera over all splats in
    RGB+ED with kernel K4 (RasterizeBinned: its plain version on the CPU);
    every input (C_local, N, ...) as project_for_cameras returns them ->
    (colours with the depth over alpha last (C, H, W, D + 1), alphas
    (C, H, W, 1))."""
    outs, alphas = [], []
    for c in range(m2d.shape[0]):
        colors, bins = bin_local_camera(m2d[c], con[c], dep[c], rad[c], col[c],
                                        op[c], width, height, tile_size,
                                        max_per_tile, max_tiles_per_gauss)
        img, alpha = RasterizeBinned.apply(m2d[c], con[c], colors, op[c],
                                           bins.gauss_ids, bins.counts,
                                           width, height, tile_size)
        outs.append(img)
        alphas.append(alpha)
    alpha = torch.stack(alphas)
    return depth_by_alpha(torch.stack(outs), alpha), alpha
