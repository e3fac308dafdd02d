"""Dense-bin tile-rasterizer: forward kernel K4, its plain version, the
autograd Function whose backward replays the plain version, and the plain
world-space (eval3d) blend of the same bins.

K4 replaces hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py `_kernel` (via
`_forward_pallas` / `rasterize_binned_pallas`); the plain version is the JAX
package's own pure route, ops/rasterizer.py `_blend_tile` /
`rasterize_binned_jax`. Input is one camera's dense bins from
ops/tiles.bin_gaussians: tile t blends splats gauss_ids[t, :counts[t]]
front to back. The CUDA kernel is csrc/rasterize_binned_fwd.cu.
`rasterize_binned_world` is the port of rasterizer.py
`rasterize_binned_world_jax` / `_blend_tile_world`, plain XLA in the JAX
package and plain PyTorch here.
"""

import ctypes

import torch
from torch.utils.checkpoint import checkpoint

from . import tiles
from ._launch import check_device, launch
from .rasterizer_flat import (ALPHA_THRESHOLD, T_EPS, _from_tiles, _to_tiles,
                              check_kernel_dims, forward_outputs, tile_groups)

# the C entry's arguments before the trailing stream
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
         + [ctypes.c_int] * 7)


def row_floats(d_col: int) -> int:
    """Floats a row of splat_table: the 6 + d_col fields, unpadded (K4 reads
    a row with 4-byte loads)."""
    return 6 + d_col


def splat_table(means2d, conics, colors, opacities) -> torch.Tensor:
    """(N, row_floats(D)) f32 rows [mx, my, ca, cb, cc, op, colours]: the
    JAX route's (N, 6 + D) staging table, before its per-tile gather, which
    K4's C entry packs on the card itself (this is its plain version)."""
    return torch.cat([means2d, conics, opacities[:, None], colors],
                     dim=-1).float().contiguous()


def tile_pixels(t0: int, t1: int, width: int, tile_size: int, device):
    """Pixel centres (G, P) x and y of tiles t0 .. t1 - 1, row-major."""
    tw = (width + tile_size - 1) // tile_size
    g = torch.arange(t0, t1, device=device)
    lin = torch.arange(tile_size * tile_size, device=device)
    px = ((g % tw) * tile_size).float()[:, None] + (lin % tile_size).float()[None] + 0.5
    py = ((g // tw) * tile_size).float()[:, None] + (lin // tile_size).float()[None] + 0.5
    return px, py


def group_entries(bins: tiles.TileBins, t0: int, t1: int, K: int):
    """Tiles t0 .. t1 - 1 of dense bins over their first K slots -> (ids
    (G, K) int64, live (G, K): the slot lies within its tile's count)."""
    ids = bins.gauss_ids[t0:t1, :K].long()
    live = torch.arange(K, device=ids.device)[None, :] < bins.counts[t0:t1, None]
    return ids, live


def monotone_weights(alpha: torch.Tensor) -> torch.Tensor:
    """Blend weights of kept alphas (G, K, P) in depth order along K: w =
    alpha T with T in log space (exclusive cumsum of log1p(-alpha)), 0 from
    the entry whose T after is <= 1e-4 on (T only falls, so that entry's
    own test stops the blend: the JAX package's monotone-T rule)."""
    lg = torch.log1p(-alpha)
    t_before = torch.exp(torch.cumsum(lg, dim=1) - lg)
    t_after = t_before * (1.0 - alpha)
    return torch.where(t_after > T_EPS, alpha * t_before, torch.zeros_like(alpha))


def dense_weights(means2d, conics, opacities, ids, live, px, py) -> torch.Tensor:
    """The JAX package's `_tile_weights` for a group of tiles: ids, live
    (G, K), pixel centres px, py (G, P) -> w (G, K, P), alpha = min(0.999,
    op e^-sigma) kept iff sigma >= 0 and alpha >= 1/255."""
    dx = px[:, None, :] - means2d[ids, 0][..., None]                   # (G, K, P)
    dy = py[:, None, :] - means2d[ids, 1][..., None]
    ca, cb, cc = (conics[ids, i][..., None] for i in range(3))
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha = torch.clamp_max(opacities[ids][..., None] * torch.exp(-sigma), 0.999)
    keep = (sigma >= 0) & (alpha >= ALPHA_THRESHOLD) & live[..., None]
    return monotone_weights(torch.where(keep, alpha, torch.zeros_like(alpha)))


def checkpointed(fn, *args):
    """fn(*args), recomputed in the backward instead of keeping its
    intermediates when autograd records it: a plain blend's (G, K, P)
    planes, kept for every group of a full-size camera, would not fit."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def rasterize_binned_plain(means2d: torch.Tensor, conics: torch.Tensor,
                           colors: torch.Tensor, opacities: torch.Tensor,
                           bins: tiles.TileBins, width: int, height: int,
                           tile_size: int):
    """The JAX package's dense-bin blend (rasterizer.py `_blend_tile`) ->
    (img (H, W, D), alpha (H, W, 1)), differentiable in every input
    (dense_weights, then w^T colours). Tiles are blended in groups of at
    most PLAIN_BUDGET plane elements, over the group's longest count (slots
    past a tile's count have alpha 0 and change nothing)."""
    P, D, dev = tile_size * tile_size, colors.shape[-1], means2d.device
    outs, alphas = [], []
    for t0, t1, K in tile_groups(bins.counts, P):
        if K == 0:
            outs.append(means2d.new_zeros(t1 - t0, P, D))
            alphas.append(means2d.new_zeros(t1 - t0, P))
            continue
        ids, live = group_entries(bins, t0, t1, K)
        w = dense_weights(means2d, conics, opacities, ids, live,
                          *tile_pixels(t0, t1, width, tile_size, dev))
        outs.append(torch.einsum("gkp,gkd->gpd", w, colors[ids]))
        alphas.append(w.sum(dim=1))
    img = _from_tiles(torch.cat(outs), width, height, tile_size)
    alpha = _from_tiles(torch.cat(alphas), width, height, tile_size)
    return img, alpha[..., None]


def _blend_world(means, iscl_rots, colors, opacities, live, ray_o, ray_d):
    """One group's world-space blend (rasterizer.py `_blend_tile_world`):
    each splat is evaluated at its closest approach to the pixel's ray in
    its own normalised frame. means (G, K, 3), iscl_rots (G, K, 3, 3) =
    diag(1/s) R^T, colors (G, K, D), opacities, live (G, K), ray_o (3,) or
    per pixel (G, P, 3), ray_d (G, P, 3) -> (out (G, P, D), alpha (G, P))."""
    if ray_o.dim() == 1:
        gro = torch.einsum("gkij,gkj->gki", iscl_rots, ray_o - means)[:, :, None]
    else:
        gro = torch.einsum("gkij,gkpj->gkpi", iscl_rots,
                           ray_o[:, None] - means[:, :, None])
    grd = torch.einsum("gkij,gpj->gkpi", iscl_rots, ray_d)            # (G, K, P, 3)
    grd = grd / torch.clamp_min(torch.linalg.norm(grd, dim=-1, keepdim=True), 1e-12)
    cr = torch.linalg.cross(*torch.broadcast_tensors(grd, gro))
    gray_dist = torch.sum(cr * cr, dim=-1)                             # (G, K, P)
    alpha = torch.clamp_max(opacities[..., None] * torch.exp(-0.5 * gray_dist), 0.999)
    keep = (alpha >= ALPHA_THRESHOLD) & live[..., None]
    w = monotone_weights(torch.where(keep, alpha, torch.zeros_like(alpha)))
    return torch.einsum("gkp,gkd->gpd", w, colors), w.sum(dim=1)


def rasterize_binned_world(means: torch.Tensor, iscl_rots: torch.Tensor,
                           colors: torch.Tensor, opacities: torch.Tensor,
                           bins: tiles.TileBins, ray_o: torch.Tensor,
                           ray_dirs: torch.Tensor, width: int, height: int,
                           tile_size: int):
    """World-space (eval3d) blend of one camera's dense bins -> (img
    (H, W, D), alpha (H, W, 1)), differentiable in means, iscl_rots, colors
    and opacities. ray_dirs (th ts, tw ts, 3) are the unit world directions
    of the padded pixel grid, ray_o the camera origin (3,) or per pixel
    (th ts, tw ts, 3) under a rolling shutter. Tiles are blended in groups
    of at most PLAIN_BUDGET elements of (tiles, entries, pixels, 3) planes,
    each recomputed in the backward (`checkpointed`)."""
    P, D = tile_size * tile_size, colors.shape[-1]
    rays = _to_tiles(ray_dirs, tile_size)
    origs = _to_tiles(ray_o, tile_size) if ray_o.dim() == 3 else None
    outs, alphas = [], []
    for t0, t1, K in tile_groups(bins.counts, 3 * P):
        if K == 0:
            outs.append(means.new_zeros(t1 - t0, P, D))
            alphas.append(means.new_zeros(t1 - t0, P))
            continue
        ids, live = group_entries(bins, t0, t1, K)
        o = ray_o if origs is None else origs[t0:t1]
        out, a = checkpointed(_blend_world, means[ids], iscl_rots[ids], colors[ids],
                              opacities[ids], live, o, rays[t0:t1])
        outs.append(out)
        alphas.append(a)
    img = _from_tiles(torch.cat(outs), width, height, tile_size)
    alpha = _from_tiles(torch.cat(alphas), width, height, tile_size)
    return img, alpha[..., None]


def _check_bins(params, bins, width, height, tile_size, d_col):
    """Raise unless K4 takes these f32 (means2d, conics, colors, opacities)
    and dense bins -> (tiles_x, tiles_y)."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    n, dev = params[0].shape[0], params[0].device
    for name, x, shape in zip(("means2d", "conics", "colors", "opacities"), params,
                              ((n, 2), (n, 3), (n, d_col), (n,))):
        if x.shape != shape or x.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(x.shape)} on {x.device}")
    ids, counts = bins.gauss_ids, bins.counts
    if ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[0] != tw * th:
        raise ValueError(f"gauss_ids must be int32 ({tw * th}, max_per_tile), got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if counts.dtype != torch.int32 or counts.shape != (tw * th,):
        raise ValueError(f"counts must be int32 ({tw * th},), got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if ids.device != dev or counts.device != dev:
        raise ValueError(f"the bins must lie on {dev}")
    check_kernel_dims(tile_size, d_col)
    return tw, th


def rasterize_binned(means2d: torch.Tensor, conics: torch.Tensor,
                     colors: torch.Tensor, opacities: torch.Tensor,
                     bins: tiles.TileBins, width: int, height: int,
                     tile_size: int):
    """Blend one camera from its dense bins -> (img (H, W, D), alpha
    (H, W, 1)), both f32; not differentiable (RasterizeBinned is).

    A CPU tensor takes rasterize_binned_plain; a CUDA tensor launches kernel
    K4 (counted in `rasterize_binned.launches`) or raises. K4's C entry
    packs the splats' rows (splat_table's layout) into a scratch table and
    sorts the tiles longest first into a scratch order before the blend.
    """
    if check_device(means2d, "rasterize_binned"):
        return rasterize_binned_plain(means2d, conics, colors, opacities, bins,
                                      width, height, tile_size)
    d_col = colors.shape[-1]
    params = [x.float().contiguous() for x in (means2d, conics, colors, opacities)]
    tw, th = _check_bins(params, bins, width, height, tile_size, d_col)
    m2d, con, col, op = params
    ids, counts = bins.gauss_ids.contiguous(), bins.counts.contiguous()
    img, alpha, _, _ = forward_outputs((), height, width, d_col, m2d.device)
    # K4's scratch: the packed rows (splat_table's) and the tile order
    table = m2d.new_empty(m2d.shape[0], row_floats(d_col))
    order = torch.empty(counts.shape, dtype=torch.int64, device=counts.device)
    launch("rasterize_binned_fwd", "rasterize_binned_fwd", _ARGS, m2d.device,
           m2d.data_ptr(), con.data_ptr(), op.data_ptr(), col.data_ptr(), m2d.shape[0],
           table.data_ptr(), ids.data_ptr(), counts.data_ptr(), order.data_ptr(),
           img.data_ptr(), alpha.data_ptr(), width, height, tile_size, tw, tw * th,
           d_col, ids.shape[1])
    rasterize_binned.launches += 1
    return img, alpha


rasterize_binned.launches = 0


class RasterizeBinned(torch.autograd.Function):
    """rasterize_binned with a gradient (the port of rasterizer_pallas's
    custom VJP of rasterize_binned_pallas): forward is K4 (or the plain
    version on the CPU); backward replays rasterize_binned_plain under
    autograd, as the JAX backward replays rasterize_binned_jax through
    jax.vjp. The JAX package has no backward kernel for this route, so
    neither has the port. Differentiable in means2d (N, 2), conics (N, 3),
    colors (N, D) and opacities (N,)."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, gauss_ids, counts,
                width, height, tile_size):
        bins = tiles.TileBins(gauss_ids, counts, None)
        ctx.save_for_backward(means2d, conics, colors, opacities, gauss_ids,
                              counts)
        ctx.dims = (width, height, tile_size)
        return rasterize_binned(means2d, conics, colors, opacities, bins,
                                width, height, tile_size)

    @staticmethod
    def backward(ctx, v_img, v_alpha):
        *params, gauss_ids, counts = ctx.saved_tensors
        params = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            img, alpha = rasterize_binned_plain(
                *params, tiles.TileBins(gauss_ids, counts, None), *ctx.dims)
            grads = torch.autograd.grad((img, alpha), params, (v_img, v_alpha))
        return (*grads, None, None, None, None, None)
