"""Tile binning: one camera's splats -> a (tile | depth)-sorted flat list.

Port of hunyuanworld_mirror_tpu/ops/tiles.py (the flat-list path). Every
splat owns `max_tiles_per_gauss` (tile, splat) slots over its clamped tile
box; slots outside the exact alpha >= 1/255 ellipse go to a sentinel tile.
The blend order is the JAX package's, reproduced exactly: the i32 key
`tile_id << depth_bits | depth_q` (depth quantized against the live
[min, max]) with the flat slot index breaking ties. Here the two ride one
int64 sort key, `key32 << 32 | flat_idx`, and the payload is gathered by the
sorted index instead of riding the sort.
"""

import math
from typing import NamedTuple, Optional, Sequence

import torch

DEPTH_BITS = 20
_CONIC_TEST_EPS = 1e-3


class FlatBins(NamedTuple):
    packed: torch.Tensor     # (V, N*TPG) f32 payload, sorted
    starts: torch.Tensor     # (n_tiles,) int32
    counts: torch.Tensor     # (n_tiles,) int32, clamped to max_per_tile
    n_dropped: torch.Tensor  # () int64 - intersections beyond the caps
    gauss_ids: Optional[torch.Tensor] = None  # (N*TPG,) int32 entry -> splat


def opacity_tight_radii(radii: torch.Tensor, opacities: torch.Tensor,
                        radius_factor: float = 3.33) -> torch.Tensor:
    """Shrink radii to the alpha >= 1/255 level set (exact: the blend masks
    everything outside it). op <= 1/255 culls the splat (radius 0)."""
    lvl = 2.0 * torch.log(torch.clamp_min(opacities, 1e-12) * 255.0)
    f = torch.clamp_max(torch.sqrt(torch.clamp_min(lvl, 0.0)) / radius_factor, 1.0)
    r = torch.ceil(radii.float() * f[..., None]).to(torch.int32)
    return torch.where((lvl > 0.0)[..., None], r, torch.zeros_like(r))


def conic_test_planes(conics: torch.Tensor, opacities: torch.Tensor):
    """(ca, cb, cc, level = ln(255 op)) for the exact ellipse-tile test."""
    return (conics[..., 0], conics[..., 1], conics[..., 2],
            torch.log(torch.clamp_min(opacities, 1e-12) * 255.0))


def _rect_sigma_min(u, v, ca, cb, cc, x0, x1, y0, y1):
    """Exact min of the (convex) conic quadratic over a pixel-centre rect."""
    inside = (u >= x0) & (u <= x1) & (v >= y0) & (v <= y1)

    def edge_x(xe):
        dx = xe - u
        t = torch.minimum(torch.maximum(-cb * dx / torch.clamp_min(cc, 1e-12),
                                        y0 - v), y1 - v)
        return 0.5 * (ca * dx * dx + cc * t * t) + cb * dx * t

    def edge_y(ye):
        dy = ye - v
        t = torch.minimum(torch.maximum(-cb * dy / torch.clamp_min(ca, 1e-12),
                                        x0 - u), x1 - u)
        return 0.5 * (ca * t * t + cc * dy * dy) + cb * t * dy

    m = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                      torch.minimum(edge_y(y0), edge_y(y1)))
    return torch.where(inside, torch.zeros_like(m), m)


def _conic_slot_mask(conic_test, tx, ty, u, v, tile_size):
    ca, cb, cc, lvl = conic_test
    x0 = tx.float() * tile_size + 0.5
    y0 = ty.float() * tile_size + 0.5
    smin = _rect_sigma_min(u, v, ca, cb, cc, x0, x0 + (tile_size - 1),
                           y0, y0 + (tile_size - 1))
    return smin <= lvl + _CONIC_TEST_EPS


def depth_bits_for(n_tiles: int) -> int:
    """Depth-quantization bits so (tile_id << db | depth_q) fits int31."""
    db = min(DEPTH_BITS, int(math.floor(math.log2((2 ** 31 - 1) / (n_tiles + 1)))))
    if db < 10:
        raise ValueError(f"{n_tiles} tiles leaves {db} depth bits (<10); "
                         "use a larger tile_size")
    return db


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    # saturate first: an out-of-range float -> int cast is undefined
    return torch.clamp(x, -2.0 ** 30, 2.0 ** 30).to(torch.int32)


def _isect_keys(means2d, radii, depths, tile_size, tile_width, tile_height,
                TPG, depth_bits, conic_test=None):
    """Packed 31-bit keys (TPG, N) int32, per-splat cover counts, validity."""
    n_tiles = tile_width * tile_height
    if n_tiles >= (1 << (31 - depth_bits)):
        raise ValueError("tile id overflows the packed key")
    u, v = means2d[:, 0], means2d[:, 1]
    rx, ry = radii[:, 0].to(means2d.dtype), radii[:, 1].to(means2d.dtype)
    txmin = torch.clamp(_to_i32(torch.floor((u - rx) / tile_size)), 0, tile_width)
    txmax = torch.clamp(_to_i32(torch.ceil((u + rx) / tile_size)), 0, tile_width)
    tymin = torch.clamp(_to_i32(torch.floor((v - ry) / tile_size)), 0, tile_height)
    tymax = torch.clamp(_to_i32(torch.ceil((v + ry) / tile_size)), 0, tile_height)
    valid = (radii[:, 0] > 0) & (radii[:, 1] > 0)
    bw = txmax - txmin
    n_cover = bw * (tymax - tymin)

    k = torch.arange(TPG, dtype=torch.int32, device=means2d.device)[:, None]
    bw_safe = torch.clamp_min(bw, 1)[None, :]
    tx = txmin[None, :] + k % bw_safe
    ty = tymin[None, :] + torch.div(k, bw_safe, rounding_mode="floor")
    slot_valid = (k < n_cover[None, :]) & valid[None, :]
    if conic_test is not None:
        slot_valid &= _conic_slot_mask(conic_test, tx, ty, u, v, tile_size)
    tile_id = torch.where(slot_valid, ty * tile_width + tx,
                          torch.full_like(tx, n_tiles))

    inf = torch.tensor(float("inf"), device=depths.device)
    dmin = torch.min(torch.where(valid, depths, inf))
    dmax = torch.max(torch.where(valid, depths, -inf))
    scale = ((1 << depth_bits) - 1) / torch.clamp_min(dmax - dmin, 1e-12)
    depth_q = torch.clamp(torch.nan_to_num((depths - dmin) * scale),
                          0, (1 << depth_bits) - 1).to(torch.int32)
    return (tile_id << depth_bits) | depth_q[None, :], n_cover, valid


def bin_gaussians_packed(means2d: torch.Tensor, radii: torch.Tensor,
                         depths: torch.Tensor, values: Sequence[torch.Tensor],
                         tile_size: int, tile_width: int, tile_height: int,
                         max_tiles_per_gauss: int = 9,
                         max_per_tile: int = 1024,
                         conic_test=None, with_ids: bool = False) -> FlatBins:
    """Bin one camera's N projected splats into the sorted flat list; the V
    payload planes `values` (each (N,), f32 or f16-pair bit patterns) come
    out gathered in blend order as packed (V, N*TPG). `with_ids` also
    returns the entry -> splat map the backward scatters by."""
    N = means2d.shape[0]
    n_tiles = tile_width * tile_height
    TPG = max_tiles_per_gauss
    db = depth_bits_for(n_tiles)
    key, n_cover, valid = _isect_keys(means2d, radii, depths, tile_size,
                                      tile_width, tile_height, TPG, db,
                                      conic_test)
    flat_idx = torch.arange(N * TPG, dtype=torch.int64, device=means2d.device)
    sort_key, _ = torch.sort((key.reshape(-1).to(torch.int64) << 32) | flat_idx)
    key32 = sort_key >> 32
    gauss = (sort_key & 0xFFFFFFFF) % N

    queries = torch.arange(n_tiles + 1, dtype=torch.int64,
                           device=means2d.device) << db
    edges = torch.searchsorted(key32, queries)
    starts = edges[:-1]
    counts_full = edges[1:] - starts
    counts = torch.clamp_max(counts_full, max_per_tile)
    n_dropped = (torch.sum(counts_full - counts)
                 + torch.sum(torch.clamp_min(n_cover - TPG, 0) * valid))
    # gather bit patterns as int32 so packed f16 pairs pass through untouched
    planes = torch.stack(list(values)).contiguous().view(torch.int32)
    packed = planes[:, gauss].view(torch.float32)
    return FlatBins(packed, starts.to(torch.int32), counts.to(torch.int32),
                    n_dropped, gauss.to(torch.int32) if with_ids else None)
