"""Distributed Gaussian rasterization: splats and cameras sharded over a
mesh axis.

Port of hunyuanworld_mirror_tpu/ops/distributed.py (gsplat's multi-GPU
protocol): every rank projects its splat shard for ALL cameras
(`project_for_cameras`), an all_to_all sends each camera's projected splats
to the rank that owns that camera, and every rank tile-bins (dense bins,
ops/tiles.bin_gaussians) and blends its own cameras over all splats with
kernel K4 (`render_local_cameras`, ops/rasterizer_binned.py). The
collectives are parallel/comm.py's autograd Functions, so the splats'
gradients come back from the ranks that rendered them as JAX's autodiff
sends them.

This path keeps the JAX path's own choices: the projection's radii (not
opacity-tight), `max_per_tile` as given (no cap to the splat count), the
exact ellipse-tile test, and colours and alpha only (no meta).
"""

import torch

from typing import Optional, Tuple

from ..parallel import comm
from . import projection, tiles
from .rasterizer import RENDER_MODES, mode_channels, normalize_mode, rasterize
from .rasterizer_binned import RasterizeBinned


def project_for_cameras(means: torch.Tensor, covars, opacities: torch.Tensor,
                        colors: torch.Tensor, viewmats: torch.Tensor,
                        Ks: torch.Tensor, width: int, height: int,
                        eps2d: float = projection.EPS2D,
                        near_plane: float = projection.NEAR_PLANE,
                        far_plane: float = projection.FAR_PLANE):
    """Project N splats (covars: the six planes) for all C cameras ->
    (means2d (C, N, 2), conics (C, N, 3), depths (C, N), radii (C, N, 2),
    colours (C, N, D), opacities (C, N)). colors are (N, D), or SH
    (N, K, 3) coloured toward each camera as the render does."""
    proj = projection.fully_fused_projection(means, covars, viewmats, Ks,
                                             width, height, eps2d=eps2d,
                                             near_plane=near_plane,
                                             far_plane=far_plane)
    col = torch.stack([projection.sh_colors(colors, means, viewmats[c])
                       for c in range(viewmats.shape[0])])
    op = opacities[None].expand(viewmats.shape[0], *opacities.shape)
    return proj.means2d, proj.conics, proj.depths, proj.radii, col, op


def bin_local_camera(m2d, con, dep, rad, col, op, width: int, height: int,
                     tile_size: int = 16, max_per_tile: int = 1024,
                     max_tiles_per_gauss: int = 9, render_mode: str = "RGB+ED"):
    """One camera's blend inputs (each (N, ...)) -> (the render mode's
    channels (N, D'), dense bins with the exact ellipse-tile test)."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    bins = tiles.bin_gaussians(m2d, rad, dep, tile_size, tw, th,
                               max_tiles_per_gauss, max_per_tile,
                               conic_test=tiles.conic_test_planes(con, op))
    return mode_channels(render_mode, lambda: col, dep), bins


def render_local_cameras(m2d, con, dep, rad, col, op, width: int, height: int,
                         tile_size: int = 16, max_per_tile: int = 1024,
                         max_tiles_per_gauss: int = 9, render_mode: str = "RGB+ED"):
    """Bin (bin_local_camera) and blend each local camera over all splats in
    the render mode with kernel K4 (RasterizeBinned: its plain version on
    the CPU); every input (C_local, N, ...) as project_for_cameras returns
    them -> (the mode's channels, the expected depth over alpha in the ED
    modes (C, H, W, D'), alphas (C, H, W, 1))."""
    outs, alphas = [], []
    for c in range(m2d.shape[0]):
        colors, bins = bin_local_camera(m2d[c], con[c], dep[c], rad[c], col[c],
                                        op[c], width, height, tile_size,
                                        max_per_tile, max_tiles_per_gauss,
                                        render_mode)
        img, alpha = RasterizeBinned.apply(m2d[c], con[c], colors, op[c],
                                           bins.gauss_ids, bins.counts,
                                           width, height, tile_size)
        outs.append(img)
        alphas.append(alpha)
    alpha = torch.stack(alphas)
    return normalize_mode(torch.stack(outs), alpha, render_mode), alpha


def rasterize_distributed(means: torch.Tensor, quats: torch.Tensor,
                          scales: torch.Tensor, opacities: torch.Tensor,
                          colors: torch.Tensor, viewmats: torch.Tensor,
                          Ks: torch.Tensor, width: int, height: int, mesh,
                          axis: str = "view", tile_size: int = 16,
                          render_mode: str = "RGB+ED",
                          eps2d: float = projection.EPS2D,
                          near_plane: float = projection.NEAR_PLANE,
                          far_plane: float = projection.FAR_PLANE,
                          max_per_tile: int = 1024, max_tiles_per_gauss: int = 9,
                          impl: str = "jax", sh_degree: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's splat shard (means (n, 3), quats (n, 4) XYZW, scales
    (n, 3), opacities (n,), colors (n, D), or SH (n, K, 3) with
    `sh_degree`) and its cameras (viewmats (c, 4, 4) world->cam, Ks
    (c, 3, 3)) -> (the render mode's channels (c, H, W, D'), alphas
    (c, H, W, 1)) of its cameras over the splats of every rank of the
    mesh's `axis`. Every rank holds as many splats and as many cameras.

    With one rank on the axis this is ops.rasterizer.rasterize (route
    `impl`), as in JAX; otherwise the blend is K4 on every route."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode must be one of {RENDER_MODES}, got {render_mode!r}")
    if sh_degree is None and colors.dim() != 2:
        raise ValueError("colors must be (N, D) without sh_degree")
    if sh_degree is not None and colors.shape[-2] != (sh_degree + 1) ** 2:
        raise ValueError(f"SH colours of degree {sh_degree} need "
                         f"{(sh_degree + 1) ** 2} coefficients, got {colors.shape[-2]}")
    if mesh.size(axis) == 1:
        out, alpha, _ = rasterize(
            means, quats, scales, opacities, colors, viewmats, Ks, width, height,
            tile_size=tile_size, render_mode=render_mode, eps2d=eps2d,
            near_plane=near_plane, far_plane=far_plane, max_per_tile=max_per_tile,
            max_tiles_per_gauss=max_tiles_per_gauss, impl=impl,
            device=means.device)
        return out, alpha
    group = mesh.group(axis)
    covars = projection.quat_scale_to_covar_planes(quats, scales)
    # 1) every rank's cameras to every rank
    all_view = comm.all_gather(viewmats, group, 0)
    all_K = comm.all_gather(Ks, group, 0)
    # 2) this rank's splats projected for every camera: (C, n, ...)
    proj = project_for_cameras(means, covars, opacities, colors, all_view, all_K,
                               width, height, eps2d, near_plane, far_plane)
    # 3) the camera axis scatters, the splat axis gathers: (c, N, ...)
    proj = [comm.all_to_all(x, group, 0, 1) for x in proj]
    # 4) this rank's cameras over every splat
    return render_local_cameras(*proj, width, height, tile_size, max_per_tile,
                                max_tiles_per_gauss, render_mode)
