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

One camera's flat list has two routes. The plain code
(bin_gaussians_packed_plain, the JAX function's steps) sorts every one of
the N*TPG slots, the dead ones to the sentinel tile after the live ones,
so its list holds M = N*TPG rows. On the card, bin_gaussians_packed runs
kernel K7 (csrc/bin_flat.cu): it emits only the n_live slots that hold an
intersection, sorts them, and gathers them into a list of M = n_live rows,
the plain list's live prefix bit for bit (starts, counts, n_dropped and
every row the tiles' segments hold). The blend and its backward read only
[starts[t], starts[t] + counts[t]) and take M as a plane stride, so the
two lists render the same. The camera batch (bin_gaussians_packed_multi,
all cameras in one sort) and the dense table (bin_gaussians) run the plain
code on every device.
"""

import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import torch

from ..utils import profiling
from . import _build
from ._launch import check_device, launch

DEPTH_BITS = 20
_CONIC_TEST_EPS = 1e-3


class TileBins(NamedTuple):
    gauss_ids: torch.Tensor  # (n_tiles, max_per_tile) int32 splat ids
    counts: torch.Tensor     # (n_tiles,) int32 live slots per tile
    n_dropped: torch.Tensor  # () int64 - intersections beyond the caps


class FlatBins(NamedTuple):
    packed: torch.Tensor     # (V, M) f32 payload, sorted (M: see the module)
    starts: torch.Tensor     # (n_tiles,) int32
    counts: torch.Tensor     # (n_tiles,) int32, clamped to max_per_tile
    n_dropped: torch.Tensor  # () int64 - intersections beyond the caps
    gauss_ids: Optional[torch.Tensor] = None  # (M,) int32 entry -> splat


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


def bin_gaussians_packed_plain(means2d: torch.Tensor, radii: torch.Tensor,
                               depths: torch.Tensor, values: Sequence[torch.Tensor],
                               tile_size: int, tile_width: int, tile_height: int,
                               max_tiles_per_gauss: int = 9,
                               max_per_tile: int = 1024,
                               conic_test=None, with_ids: bool = False) -> FlatBins:
    """Bin one camera's N projected splats into the sorted flat list; the V
    payload planes `values` (each (N,), f32 or f16-pair bit patterns) come
    out gathered in blend order as packed (V, N*TPG), the dead slots last.
    `with_ids` also returns the entry -> splat map the backward scatters
    by."""
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


def bin_gaussians_packed(means2d: torch.Tensor, radii: torch.Tensor,
                         depths: torch.Tensor, values: Sequence[torch.Tensor],
                         tile_size: int, tile_width: int, tile_height: int,
                         max_tiles_per_gauss: int = 9,
                         max_per_tile: int = 1024,
                         conic_test=None, with_ids: bool = False) -> FlatBins:
    """bin_gaussians_packed_plain's list, counted in profiling's counters
    "bin_fused" (once a camera) and "bin_rows" (the rows sorted). A CPU
    tensor runs the plain code (N*TPG rows); a CUDA tensor runs kernel K7
    (counted in `bin_gaussians_packed.launches`), whose list holds only the
    n_live live rows: the plain list's live prefix, bit for bit. Reading
    n_live back is the camera's one host sync."""
    profiling.count("bin_fused")
    if check_device(means2d, "bin_gaussians_packed"):
        bins = bin_gaussians_packed_plain(means2d, radii, depths, values, tile_size,
                                          tile_width, tile_height, max_tiles_per_gauss,
                                          max_per_tile, conic_test, with_ids)
        profiling.count("bin_rows", bins.packed.shape[1])
        return bins
    return _bin_flat(means2d, radii, depths, values, tile_size, tile_width, tile_height,
                     max_tiles_per_gauss, max_per_tile, conic_test, with_ids)


bin_gaussians_packed.launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each C entry's arguments before the trailing stream
_KEYS_ARGS = [_P] * 7 + [_LL] * 4 + [_P, _P, _LL] + [_I] * 7
_EMIT_ARGS = [_P] * 3 + [_LL, _I] + [_P] * 7 + [_LL, _LL] + [_I] * 5
# the depth range's blocks (two a streaming multiprocessor); each block of
# bin_keys reduces their (min, max) pairs
_RANGE_BLOCKS = 264
# the payload planes bin_flat_emit reads where they lie
_MAX_PLANES = 16


def _sort_bytes(n: int, end_bit: int) -> int:
    """The scratch bytes (at least 1) of bin_flat_emit's sort of n keys."""
    f = _build.load("bin_flat").bin_flat_sort_bytes
    f.restype, f.argtypes = _LL, [_LL, _I]
    bytes_ = f(n, end_bit)
    if bytes_ < 0:
        raise RuntimeError(f"cub's radix sort refused {n} keys of {end_bit} bits")
    return max(bytes_, 1)


def _f32_planes(planes, N, what):
    if any(p.dim() != 1 or p.shape[0] != N or p.dtype != torch.float32 for p in planes):
        raise ValueError(f"{what} must be f32 (N,) planes, N = {N}")


def _bin_flat(means2d, radii, depths, values, tile_size, tile_width, tile_height,
              TPG, max_per_tile, conic_test, with_ids) -> FlatBins:
    """Kernel K7's route of bin_gaussians_packed (csrc/bin_flat.cu): the
    live slots' keys, their count read back, their sort, the gather and
    the tiles' segments. The key is (tile << db | depth_q) << sb | slot
    with sb the bits of N*TPG - 1: the plain key's order, sorted over
    fewer bits."""
    N, dev = means2d.shape[0], means2d.device
    n_tiles = tile_width * tile_height
    db = depth_bits_for(n_tiles)
    if n_tiles >= (1 << (31 - db)):
        raise ValueError("tile id overflows the packed key")
    if N * TPG > 1 << 32:
        raise ValueError(f"{N} splats x {TPG} slots overflow the key's 32-bit slot index")
    if (radii.dtype != torch.int32 or means2d.dtype != torch.float32
            or tuple(means2d.shape) != (N, 2) or tuple(radii.shape) != (N, 2)):
        raise ValueError(f"means2d must be f32 (N, 2) and radii int32 (N, 2), got "
                         f"{means2d.dtype} {tuple(means2d.shape)}, {radii.dtype} "
                         f"{tuple(radii.shape)}")
    ct = [None] * 4 if conic_test is None else list(conic_test)
    _f32_planes([p for p in ct if p is not None], N, "the conic test planes")
    _f32_planes(values, N, "the payload planes")
    V = len(values)
    if V > _MAX_PLANES:
        raise ValueError(f"K7 gathers at most {_MAX_PLANES} payload planes, got {V}")
    sb = max(N * TPG - 1, 0).bit_length()
    end_bit = sb + ((n_tiles << db) - 1).bit_length()
    n_part = max(1, min(_RANGE_BLOCKS, -(-N // 256)))
    # the live count, the drop count, the depth range's (min, max) pairs
    aux = torch.empty(2 + n_part, dtype=torch.int64, device=dev)
    keys = torch.empty(N * TPG, dtype=torch.int64, device=dev)
    m2d, rad, dep = (t.contiguous() for t in (means2d, radii, depths))
    launch("bin_flat", "bin_flat_keys", _KEYS_ARGS, dev, m2d.data_ptr(), rad.data_ptr(),
           dep.data_ptr(), *(None if p is None else p.data_ptr() for p in ct),
           *(0 if p is None else p.stride(0) for p in ct), keys.data_ptr(),
           aux.data_ptr(), N, n_part, tile_size, tile_width, tile_height, TPG, db, sb)
    profiling.count("host_syncs")       # the live count's readback
    n_live = int(aux[0])
    profiling.count("bin_rows", n_live)
    packed = torch.empty(V, n_live, dtype=torch.int32, device=dev)
    ids = torch.empty(n_live, dtype=torch.int32, device=dev) if with_ids else None
    starts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    if n_live:
        temp = torch.empty(_sort_bytes(n_live, end_bit), dtype=torch.uint8, device=dev)
        sorted_keys = torch.empty_like(keys[:n_live])
        launch("bin_flat", "bin_flat_emit", _EMIT_ARGS, dev, keys.data_ptr(),
               sorted_keys.data_ptr(), temp.data_ptr(), temp.numel(),
               end_bit, (_P * V)(*(v.data_ptr() for v in values)),
               (_LL * V)(*(v.stride(0) for v in values)), packed.data_ptr(),
               None if ids is None else ids.data_ptr(), starts.data_ptr(),
               counts.data_ptr(), aux.data_ptr(), n_live, N, V, db, sb, n_tiles,
               max_per_tile)
    else:                               # no intersection: every tile empty
        starts.zero_()
        counts.zero_()
    bin_gaussians_packed.launches += 1
    return FlatBins(packed.view(torch.float32), starts, counts, aux[1], ids)


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

