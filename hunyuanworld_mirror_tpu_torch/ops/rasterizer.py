"""Tile-based 3D Gaussian rasterization of pinhole cameras, one camera at a time.

Port of hunyuanworld_mirror_tpu/ops/rasterizer.py `rasterize` on its
`impl="pallas"` per-camera path in RGB+ED mode: projection
(ops/projection.py) -> opacity-tight radii -> SH colours + depth -> flat
binning with the exact ellipse-tile test (ops/tiles.py, f32 or f16-pair
payload) -> the flat blend (ops/rasterizer_flat.py, kernel K2) -> expected
depth normalized by alpha.
"""

from typing import Dict

import torch

from .. import resolve_device
from ..utils import sh as sh_utils
from . import projection, tiles
from .rasterizer_flat import pack_f16_pairs, rasterize_flat


def _colors(colors, means, viewmat):
    """(N, D) colours as given, or SH (N, K, 3) evaluated toward the camera."""
    if colors.dim() == 2:
        return colors
    cam_t = -torch.einsum("ij,i->j", viewmat[:3, :3], viewmat[:3, 3])
    dirs = means - cam_t[None, :]
    dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
    deg = int(round(colors.shape[-2] ** 0.5)) - 1
    col = sh_utils.eval_sh(deg, colors.transpose(-1, -2), dirs)
    return torch.clamp_min(col + 0.5, 0.0)


def bin_splats(means2d, conics, colors, opacities, radii, depths,
               tile_size: int, tile_width: int, tile_height: int,
               max_tiles_per_gauss: int, max_per_tile: int,
               payload_f16: bool) -> tiles.FlatBins:
    """One camera's projected splats -> the sorted flat list kernel K2
    blends: payload [mx, my, ca, cb, cc, op, colours...] in f32, or with
    `payload_f16` [mx, my, ca|cb, cc|op, colour pairs...] as f16 pairs."""
    d = colors.shape[-1]
    if payload_f16:
        cols = [colors[:, i] for i in range(d)]
        if d % 2:
            cols.append(torch.zeros_like(cols[0]))
        values = ([means2d[:, 0], means2d[:, 1],
                   pack_f16_pairs(conics[:, 0], conics[:, 1]),
                   pack_f16_pairs(conics[:, 2], opacities)]
                  + [pack_f16_pairs(cols[j], cols[j + 1])
                     for j in range(0, len(cols), 2)])
    else:
        values = ([means2d[:, 0], means2d[:, 1], conics[:, 0], conics[:, 1],
                   conics[:, 2], opacities] + [colors[:, i] for i in range(d)])
    return tiles.bin_gaussians_packed(
        means2d, radii, depths, values, tile_size, tile_width, tile_height,
        max_tiles_per_gauss, max_per_tile,
        conic_test=tiles.conic_test_planes(conics, opacities))


def bin_camera(means, quats_xyzw, scales, opacities, colors, viewmat, K,
               width: int, height: int, tile_size: int, max_per_tile: int,
               max_tiles_per_gauss: int, payload_f16: bool) -> tiles.FlatBins:
    """Project, colour (RGB + depth) and bin one camera (viewmat (4, 4)
    world->cam, K (3, 3)); the list's colour width is colors.shape[-1] + 1."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    # a tile never holds more than every (splat, tile) pair: small scenes do
    # not pay the full static cap (rounded up to 512 as the JAX package does)
    n_pairs = means.shape[0] * max_tiles_per_gauss
    max_per_tile = min(max_per_tile, -(-n_pairs // 512) * 512)

    covars = projection.quat_scale_to_covar_planes(quats_xyzw, scales)
    proj = projection.fully_fused_projection(means, covars, viewmat[None],
                                             K[None], width, height)
    m2d, con, dep = proj.means2d[0], proj.conics[0], proj.depths[0]
    rad = tiles.opacity_tight_radii(proj.radii[0], opacities)
    col = torch.cat([_colors(colors, means, viewmat), dep[:, None]], dim=-1)
    return bin_splats(m2d, con, col, opacities, rad, dep, tile_size, tw, th,
                      max_tiles_per_gauss, max_per_tile, payload_f16)


def rasterize(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
              opacities: torch.Tensor, colors: torch.Tensor,
              viewmats: torch.Tensor, Ks: torch.Tensor, width: int, height: int,
              tile_size: int = 16, max_per_tile: int = 4096,
              max_tiles_per_gauss: int = 4, quat_order: str = "xyzw",
              payload_f16: bool = False, device=None):
    """Render N splats into C pinhole cameras in RGB+ED (gsplat.rasterization's
    dense single-batch form). colors: (N, D) or SH (N, K, 3); viewmats
    (C, 4, 4) world->cam; Ks (C, 3, 3).

    Runs on `device`: CUDA unless the caller passes one (on a machine
    without a GPU, device=None raises). Returns (colors (C, H, W, D + 1)
    with the alpha-normalized expected depth last, alphas (C, H, W, 1),
    meta) with meta["n_dropped"] (C,) intersections lost to the static caps
    and meta["n_isects"] (C,) sorted entries.
    """
    dev = resolve_device(device)
    means, quats, scales, opacities, colors, viewmats, Ks = (
        torch.as_tensor(t, dtype=torch.float32, device=dev)
        for t in (means, quats, scales, opacities, colors, viewmats, Ks))
    if quat_order == "wxyz":
        quats = quats[..., [1, 2, 3, 0]]
    elif quat_order != "xyzw":
        raise ValueError(f"unknown quat_order {quat_order!r}")

    imgs, alphas, drops, isects = [], [], [], []
    for c in range(viewmats.shape[0]):
        bins = bin_camera(means, quats, scales, opacities, colors, viewmats[c],
                          Ks[c], width, height, tile_size, max_per_tile,
                          max_tiles_per_gauss, payload_f16)
        img, alpha = rasterize_flat(bins.packed, bins.starts, bins.counts,
                                    width, height, tile_size,
                                    colors.shape[-1] + 1, payload_f16)
        imgs.append(img)
        alphas.append(alpha)
        drops.append(bins.n_dropped)
        isects.append(bins.counts.sum())
    render_colors = torch.stack(imgs)
    render_alphas = torch.stack(alphas)
    render_colors = torch.cat([
        render_colors[..., :-1],
        render_colors[..., -1:] / torch.clamp_min(render_alphas, 1e-10)], dim=-1)
    meta: Dict[str, torch.Tensor] = {
        "n_dropped": torch.stack(drops), "n_isects": torch.stack(isects)}
    return render_colors, render_alphas, meta
