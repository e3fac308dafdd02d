"""Tile binning: splats -> (tile | depth)-sorted intersection lists.

Port of hunyuanworld_mirror_tpu/ops/tiles.py: the flat list of one camera
(bin_gaussians_packed), of C cameras in one sort
(bin_gaussians_packed_multi), and the dense per-tile id table
(bin_gaussians). Every splat owns `max_tiles_per_gauss` (tile, splat) slots
over its clamped tile box; slots outside the exact alpha >= 1/255 ellipse
go to a sentinel tile. The blend order is the JAX package's, reproduced
exactly: the i32 key `tile_id << depth_bits | depth_q` (depth quantized
against the live [min, max]) with the flat slot index breaking ties. Here
the two ride one int64 sort key, `key32 << 32 | flat_idx`, and the payload
is gathered by the sorted index instead of riding the sort.
"""

import math
from typing import NamedTuple, Optional, Sequence

import torch

from ..utils import profiling

DEPTH_BITS = 20
_CONIC_TEST_EPS = 1e-3


class TileBins(NamedTuple):
    gauss_ids: torch.Tensor  # (n_tiles, max_per_tile) int32 splat ids
    counts: torch.Tensor     # (n_tiles,) int32 live slots per tile
    n_dropped: torch.Tensor  # () int64 - intersections beyond the caps


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


def tile_ranges(means2d: torch.Tensor, radii: torch.Tensor, tile_size: int,
                tile_width: int, tile_height: int):
    """Per-splat clamped tile boxes: (tmin, tmax) each (N, 2) int32, and
    valid (N,) bool (both radii > 0)."""
    tm = means2d / tile_size
    tr = radii.to(means2d.dtype) / tile_size
    lim = torch.tensor([tile_width, tile_height], dtype=torch.int32,
                       device=means2d.device)
    zero = torch.zeros_like(lim)
    tmin = torch.clamp(_to_i32(torch.floor(tm - tr)), zero, lim)
    tmax = torch.clamp(_to_i32(torch.ceil(tm + tr)), zero, lim)
    return tmin, tmax, (radii > 0).all(dim=-1)


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


def _tile_boxes(means2d, radii, tile_size, tile_width, tile_height):
    """Each splat's clamped tile box: (txmin, tymin, width >= 1, tiles
    covered, valid), each (N,)."""
    u, v = means2d[:, 0], means2d[:, 1]
    rx, ry = radii[:, 0].to(means2d.dtype), radii[:, 1].to(means2d.dtype)
    txmin = torch.clamp(_to_i32(torch.floor((u - rx) / tile_size)), 0, tile_width)
    txmax = torch.clamp(_to_i32(torch.ceil((u + rx) / tile_size)), 0, tile_width)
    tymin = torch.clamp(_to_i32(torch.floor((v - ry) / tile_size)), 0, tile_height)
    tymax = torch.clamp(_to_i32(torch.ceil((v + ry) / tile_size)), 0, tile_height)
    valid = (radii[:, 0] > 0) & (radii[:, 1] > 0)
    bw = txmax - txmin
    return txmin, tymin, torch.clamp_min(bw, 1), bw * (tymax - tymin), valid


def _depth_q(depths, valid, depth_bits):
    """Depths quantized to depth_bits against the valid splats' [min, max]."""
    inf = torch.tensor(float("inf"), device=depths.device)
    profiling.count("host_syncs")       # the scalar's upload
    dmin = torch.min(torch.where(valid, depths, inf))
    dmax = torch.max(torch.where(valid, depths, -inf))
    # a tensor quotient, rounded once as JAX's is: torch computes a Python
    # number over a tensor as number * (1 / tensor), one ulp off it at times
    levels = torch.full_like(dmax, (1 << depth_bits) - 1)
    scale = levels / torch.clamp_min(dmax - dmin, 1e-12)
    return torch.clamp(torch.nan_to_num((depths - dmin) * scale),
                       0, (1 << depth_bits) - 1).to(torch.int32)


def _slot_tiles(k, txmin, tymin, bw, n_cover, tile_width, n_tiles, u, v,
                tile_size, conic_test):
    """Slot plane(s) k of the splats' boxes, row-major -> tile ids, the
    sentinel n_tiles where the slot is past the cover or fails the conic
    test."""
    tx = txmin + k % bw
    ty = tymin + torch.div(k, bw, rounding_mode="floor")
    slot_ok = k < n_cover
    if conic_test is not None:
        slot_ok &= _conic_slot_mask(conic_test, tx, ty, u, v, tile_size)
    return torch.where(slot_ok, ty * tile_width + tx, torch.full_like(tx, n_tiles))


def _isect_keys(means2d, radii, depths, tile_size, tile_width, tile_height,
                TPG, depth_bits, conic_test=None):
    """Packed 31-bit keys (TPG, N) int32, per-splat cover counts, validity."""
    n_tiles = tile_width * tile_height
    if n_tiles >= (1 << (31 - depth_bits)):
        raise ValueError("tile id overflows the packed key")
    txmin, tymin, bw, n_cover, valid = _tile_boxes(means2d, radii, tile_size,
                                                   tile_width, tile_height)
    k = torch.arange(TPG, dtype=torch.int32, device=means2d.device)[:, None]
    tile_id = _slot_tiles(k, txmin[None], tymin[None], bw[None],
                          torch.where(valid, n_cover, torch.zeros_like(n_cover))[None],
                          tile_width, n_tiles, means2d[:, 0], means2d[:, 1],
                          tile_size, conic_test)
    depth_q = _depth_q(depths, valid, depth_bits)
    return (tile_id << depth_bits) | depth_q[None, :], n_cover, valid


def _sort_slots(key: torch.Tensor):
    """Sort the slots' i32 keys, the flat slot index breaking ties ->
    (sorted keys int64, sorted slot indices int64)."""
    flat_idx = torch.arange(key.numel(), dtype=torch.int64, device=key.device)
    sort_key, _ = torch.sort((key.reshape(-1).to(torch.int64) << 32) | flat_idx)
    return sort_key >> 32, sort_key & 0xFFFFFFFF


def _segments(key32: torch.Tensor, cells: torch.Tensor, db: int,
              max_per_tile: int, keep=None):
    """Each cell's segment of the sorted keys: cells (Q,) int64 are key
    prefixes, the segment of cell q running from the first key >= cells[q]
    << db to the first >= cells[q + 1] << db. `keep` (Q - 1,) bool selects
    segments -> (starts, counts clamped to max_per_tile, entries the clamp
    cut), int64."""
    edges = torch.searchsorted(key32, cells << db)
    starts, counts_full = edges[:-1], edges[1:] - edges[:-1]
    if keep is not None:
        starts, counts_full = starts[keep], counts_full[keep]
    counts = torch.clamp_max(counts_full, max_per_tile)
    return starts, counts, torch.sum(counts_full - counts)


def _lost_to_tpg(n_cover, valid, TPG):
    """Intersections beyond the max_tiles_per_gauss slots of each splat."""
    return torch.sum(torch.clamp_min(n_cover - TPG, 0) * valid)


def _gather(values: Sequence[torch.Tensor], index: torch.Tensor) -> torch.Tensor:
    """(V, len(index)) payload: the planes' bit patterns gathered as int32,
    so packed f16 pairs pass through untouched."""
    planes = torch.stack([v.reshape(-1) for v in values]).contiguous()
    return planes.view(torch.int32)[:, index].view(torch.float32)


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
    key32, slot = _sort_slots(key)
    gauss = slot % N
    cells = torch.arange(n_tiles + 1, dtype=torch.int64, device=means2d.device)
    starts, counts, clamped = _segments(key32, cells, db, max_per_tile)
    n_dropped = clamped + _lost_to_tpg(n_cover, valid, TPG)
    return FlatBins(_gather(values, gauss), starts.to(torch.int32),
                    counts.to(torch.int32), n_dropped,
                    gauss.to(torch.int32) if with_ids else None)


def multi_camera_depth_bits(n_cams: int, n_tiles: int) -> int:
    """Depth bits so (cam * (n_tiles + 1) + tile) << db | depth_q fits
    int31: 20 while it fits, fewer as cameras multiply the tile ids (18 at
    4 cameras of 1089 tiles)."""
    db = min(DEPTH_BITS, int(math.floor(math.log2(
        (2 ** 31 - 1) / (n_cams * (n_tiles + 1))))))
    if db < 10:
        raise ValueError(f"{n_cams} cameras x {n_tiles} tiles leaves {db} depth "
                         "bits (<10); batch fewer cameras")
    return db


def bin_gaussians_packed_multi(means2d: torch.Tensor, radii: torch.Tensor,
                               depths: torch.Tensor,
                               values: Sequence[torch.Tensor], tile_size: int,
                               tile_width: int, tile_height: int,
                               max_tiles_per_gauss: int = 9,
                               max_per_tile: int = 1024,
                               conic_test=None) -> FlatBins:
    """bin_gaussians_packed for C cameras in one sort: means2d (C, N, 2),
    radii (C, N, 2), depths (C, N), V payload planes (C, N), conic_test
    planes (C, N). Keys are (cam (n_tiles + 1) + tile) << db | depth_q, each
    camera's depth quantized against its own live [min, max].

    Returns one packed (V, C*TPG*N) list; starts and counts are camera-major
    (camera c's tile t at c * n_tiles + t), n_dropped is one total over the
    cameras.
    With only db = multi_camera_depth_bits(C, n_tiles) depth bits (18 at 4
    cameras of 1089 tiles, against 20 for one camera) splats whose depths
    tie at db bits may blend in another order than the per-camera list's.
    """
    C, N = depths.shape
    n_tiles = tile_width * tile_height
    TPG = max_tiles_per_gauss
    db = multi_camera_depth_bits(C, n_tiles)
    keys, lost = [], 0
    for c in range(C):
        ct = None if conic_test is None else tuple(p[c] for p in conic_test)
        key, n_cover, valid = _isect_keys(means2d[c], radii[c], depths[c],
                                          tile_size, tile_width, tile_height,
                                          TPG, db, ct)
        keys.append(key + ((c * (n_tiles + 1)) << db))
        lost = lost + _lost_to_tpg(n_cover, valid, TPG)
    key32, slot = _sort_slots(torch.stack(keys))        # slots (C, TPG, N)
    # camera c's tile t is cell c (n_tiles + 1) + t; its sentinel cell
    # closes its last tile and has no segment of its own
    cells = torch.arange(C * (n_tiles + 1), dtype=torch.int64,
                         device=means2d.device)
    starts, counts, clamped = _segments(key32, cells, db, max_per_tile,
                                        keep=cells[:-1] % (n_tiles + 1) != n_tiles)
    n_dropped = clamped + lost
    # slot (c, k, n) carries camera c's payload of splat n
    return FlatBins(_gather(values, slot // (TPG * N) * N + slot % N),
                    starts.to(torch.int32), counts.to(torch.int32), n_dropped)


def bin_gaussians(means2d: torch.Tensor, radii: torch.Tensor,
                  depths: torch.Tensor, tile_size: int, tile_width: int,
                  tile_height: int, max_tiles_per_gauss: int = 9,
                  max_per_tile: int = 1024, conic_test=None) -> TileBins:
    """Bin one camera's N projected splats into the dense per-tile table:
    gauss_ids (n_tiles, max_per_tile), tile t's first counts[t] slots its
    splats front to back. Slot k of tile t reads sorted entry
    min(starts[t] + k, N*TPG - 1), so the slots past the count hold ids of
    later tiles, masked by `counts`, as in the JAX table."""
    N = means2d.shape[0]
    n_tiles = tile_width * tile_height
    TPG = max_tiles_per_gauss
    db = depth_bits_for(n_tiles)
    key, n_cover, valid = _isect_keys(means2d, radii, depths, tile_size,
                                      tile_width, tile_height, TPG, db,
                                      conic_test)
    key32, slot = _sort_slots(key)
    cells = torch.arange(n_tiles + 1, dtype=torch.int64, device=means2d.device)
    starts, counts, clamped = _segments(key32, cells, db, max_per_tile)
    idx = torch.clamp_max(starts[:, None] + torch.arange(
        max_per_tile, device=means2d.device)[None, :], N * TPG - 1)
    return TileBins((slot % N).to(torch.int32)[idx], counts.to(torch.int32),
                    clamped + _lost_to_tpg(n_cover, valid, TPG))


# Per-slot-plane prefix fractions for coverage-scheduled binning ("auto"):
# after a descending pre-sort by tile coverage, slot plane k enumerates only
# the first ceil(frac_k N) splats, each prefix rounded up to `align` rows.
# The JAX package's calibration (518 px scenes: mean cover 1.67 tiles).
AUTO_SLOT_FRACS = (1.0, 0.75, 0.25, 0.25, 0.125, 0.0625, 0.0625,
                   0.03125, 0.03125)


def _auto_slot_fracs(TPG: int):
    if TPG <= len(AUTO_SLOT_FRACS):
        return AUTO_SLOT_FRACS[:TPG]
    return AUTO_SLOT_FRACS + (AUTO_SLOT_FRACS[-1],) * (TPG - len(AUTO_SLOT_FRACS))


def bin_gaussians_packed_prefix(means2d: torch.Tensor, radii: torch.Tensor,
                                depths: torch.Tensor,
                                values: Sequence[torch.Tensor], tile_size: int,
                                tile_width: int, tile_height: int,
                                max_tiles_per_gauss: int = 9,
                                max_per_tile: int = 1024, slot_fracs="auto",
                                align: int = 512, conic_test=None) -> FlatBins:
    """Coverage-scheduled bin_gaussians_packed (inference only): fewer
    sorted rows than N*TPG, the same FlatBins without gauss_ids.

    The splats are pre-sorted by clamped tile coverage, descending (ties by
    splat id), and slot plane k enumerates only the first P_k =
    ceil(N slot_fracs[k] / align) align rows of that order. Splats that need
    a k-th slot form a prefix of it, so a plane loses slots only where
    #(cover > k) > P_k; those are counted in n_dropped, as are the per-tile
    cap and the coverage past TPG. The rows are sorted on the classic key
    and the classic flat index k N + splat id, so within the surviving
    prefixes the blend order is bin_gaussians_packed's, bit for bit. The
    conic test reads its own f32 planes (u, v, conic, level) through the
    pre-sort: `values` may hold f16 pairs. The row count is padded to a
    multiple of `align` with sentinel keys (zero payload) that sort last.
    """
    N = means2d.shape[0]
    n_tiles = tile_width * tile_height
    TPG = max_tiles_per_gauss
    if slot_fracs == "auto":
        slot_fracs = _auto_slot_fracs(TPG)
    if len(slot_fracs) != TPG:
        raise ValueError(f"slot_fracs has {len(slot_fracs)} entries, need "
                         f"max_tiles_per_gauss={TPG}")
    db = depth_bits_for(n_tiles)
    txmin, tymin, bw, n_cover, valid = _tile_boxes(means2d, radii, tile_size,
                                                   tile_width, tile_height)
    n_cover = torch.where(valid, n_cover, torch.zeros_like(n_cover))
    dq = _depth_q(depths, valid, db)

    # the coverage pre-sort: descending clamped cover, ties by splat id
    order = torch.sort(-torch.clamp_max(n_cover, TPG), stable=True).indices
    cover_s = n_cover[order]
    u_s, v_s = means2d[order, 0], means2d[order, 1]
    ct_s = None if conic_test is None else tuple(p[order] for p in conic_test)
    txm, tym, bws, dq_s = txmin[order], tymin[order], bw[order], dq[order]

    P = [min(N, -(-int(N * f) // align) * align) for f in slot_fracs]
    keys, rows = [], []
    for k in range(TPG):
        pk = P[k]
        if pk <= 0:
            continue
        tile = _slot_tiles(k, txm[:pk], tym[:pk], bws[:pk], cover_s[:pk],
                           tile_width, n_tiles, u_s[:pk], v_s[:pk], tile_size,
                           None if ct_s is None else tuple(p[:pk] for p in ct_s))
        key32 = ((tile << db) | dq_s[:pk]).to(torch.int64)
        # the classic flat index k N + splat id breaks depth ties
        keys.append((key32 << 32) | (k * N + order[:pk]))
        rows.append(order[:pk])
    sort_key, perm = torch.sort(torch.cat(keys))
    gauss = torch.cat(rows)[perm]
    key32 = sort_key >> 32
    cells = torch.arange(n_tiles + 1, dtype=torch.int64, device=means2d.device)
    starts, counts, clamped = _segments(key32, cells, db, max_per_tile)

    # drops: the per-tile cap, coverage past TPG, and the prefix exclusions
    # (#(cover > k) beyond P_k, exact since cover_s falls)
    n_dropped = clamped + torch.sum(torch.clamp_min(n_cover - TPG, 0))
    for k in range(TPG):
        if P[k] < N:
            n_dropped = n_dropped + torch.sum(cover_s[P[k]:] > k)
    packed = _gather(values, gauss)
    pad = (-packed.shape[1]) % align
    if pad:
        packed = torch.nn.functional.pad(packed, (0, pad))
    return FlatBins(packed, starts.to(torch.int32), counts.to(torch.int32),
                    n_dropped)
