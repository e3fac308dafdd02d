"""Flat tile-rasterizer: forward kernels K2, K2m and K5, backward kernel K3,
their plain versions, f16 packing.

All of them replace hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py
kernels. K2 replaces `_kernel_flat` (via `_forward_flat` /
`rasterize_flat_pallas`, flat forward); K2m the same kernel launched over C
cameras (`_forward_flat_multi` / `rasterize_flat_pallas_multi`); K5
`_kernel_flat_grouped` (`_forward_flat_grouped`, WM_RASTER_GROUP > 1); K3
`_kernel_flat_bwd` (via `_backward_flat`, the custom VJP's backward). Input
is the globally sorted, component-major intersection list of
ops/tiles.bin_gaussians_packed (or bin_gaussians_packed_multi): tile t
blends entries [starts[t], starts[t] + counts[t]) of `packed` (V, M) front
to back. The CUDA kernels are csrc/rasterize_flat_fwd.cu (K2, K2m, and K5:
K2's entry on the window-clamped segments) and csrc/rasterize_flat_bwd.cu
(K3).
"""

import ctypes
import os
from typing import NamedTuple, Tuple

import torch

from ._launch import check_device, launch

ALPHA_THRESHOLD = 1.0 / 255.0
T_EPS = 1e-4
# the plain version blends groups of tiles whose (tiles, entries, pixels)
# planes hold at most this many elements
PLAIN_BUDGET = 1 << 24

# --- f16-pair payload ------------------------------------------------------

def pack_f16_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 planes -> one f32 plane whose BITS are (f16(a) << 16) | f16(b)."""
    ah = a.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    bh = b.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    return ((ah << 16) | bh).view(torch.float32)


def _f16_bits_to_f32(h: torch.Tensor) -> torch.Tensor:
    """int32 holding f16 bits in its low 16 -> f32, subnormals flushed to 0
    (the JAX decode, rasterizer_pallas._f16_bits_to_f32)."""
    s = (h & 0x8000) << 16
    e = (h >> 10) & 0x1F
    m = h & 0x3FF
    mag = torch.where(e == 0, torch.zeros_like(h), ((e + 112) << 23) | (m << 13))
    return (s | mag).view(torch.float32)


def _unpack_f16_row(row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    u = row.contiguous().view(torch.int32)
    return _f16_bits_to_f32((u >> 16) & 0xFFFF), _f16_bits_to_f32(u & 0xFFFF)


def payload_rows(d_col: int, f16: bool) -> int:
    return 4 + (d_col + 1) // 2 if f16 else 6 + d_col


def decode_payload(packed: torch.Tensor, d_col: int, f16: bool):
    """(V, M) payload -> (mx, my, ca, cb, cc, op, col (d_col, M)) f32 rows."""
    if not f16:
        return (packed[0], packed[1], packed[2], packed[3], packed[4],
                packed[5], packed[6:6 + d_col])
    ca, cb = _unpack_f16_row(packed[2])
    cc, op = _unpack_f16_row(packed[3])
    cols = []
    for j in range((d_col + 1) // 2):
        cols.extend(_unpack_f16_row(packed[4 + j]))
    return packed[0], packed[1], ca, cb, cc, op, torch.stack(cols[:d_col])


# --- the keep box ------------------------------------------------------------

def keep_box(mx, my, ca, cb, cc, op):
    """Each entry's keep box as the kernels compute it in f32
    (csrc/raster_common.cuh keep_box) -> (x0, x1, y0, y1): every pixel
    centre where op e^-sigma >= 1/255 lies inside it (1% margin on sigma,
    0.01 px); infinite where det C < ca cc / 100 or C is not positive. The
    forward kernels skip, for a whole warp, the entries whose box misses
    the warp's pixels, and K3 does the same."""
    lim = torch.log(255.0 * op) + 1e-3
    det = ca * cc - cb * cb
    ok = (ca > 0) & (cc > 0) & (det >= 0.01 * ca * cc)
    s2 = 2.02 * torch.clamp_min(torch.where(torch.isnan(lim), 0.0, lim), 0.0)
    inf = torch.full_like(mx, float("inf"))
    rx = torch.where(ok, torch.sqrt(s2 * cc / det) + 0.01, inf)
    ry = torch.where(ok, torch.sqrt(s2 * ca / det) + 0.01, inf)
    return mx - rx, mx + rx, my - ry, my + ry


WARP_W, WARP_H = 8, 4   # the forward kernels' warp: 8 x 4 pixels


def warp_rects(tile_size: int, device=None):
    """The centres of the corner pixels of each pixel's warp, for the pixels
    of a tile in row-major order -> (x0, x1, y0, y1) (tile_size^2,) f32
    offsets within the tile."""
    lin = torch.arange(tile_size * tile_size, device=device)
    x0 = ((lin % tile_size) // WARP_W * WARP_W).float() + 0.5
    y0 = ((lin // tile_size) // WARP_H * WARP_H).float() + 0.5
    return x0, x0 + (WARP_W - 1), y0, y0 + (WARP_H - 1)


# --- plain version ----------------------------------------------------------

class Blend(NamedTuple):
    """One group of tiles as blend_groups yields it. Planes are (G, K, P):
    G tiles, K entries (the group's longest list), P pixels per tile."""
    g: torch.Tensor         # (G,) tile ids
    idx: torch.Tensor       # (G, K) entry index into the list (clamped)
    live: torch.Tensor      # (G, K) entry lies inside its tile's segment
    params: Tuple           # (ca, cb, cc, op), each (G, K, 1)
    col: torch.Tensor       # (D, G, K) colours
    dx: torch.Tensor        # pixel centre - mean, x
    dy: torch.Tensor
    sigma: torch.Tensor
    alpha: torch.Tensor     # min(0.999, op e^-sigma), 0 where not kept
    t_before: torch.Tensor  # transmittance before each entry
    w: torch.Tensor         # alpha T for the entries the blend keeps, else 0


def tile_groups(counts: torch.Tensor, P: int):
    """Consecutive tile ranges [t0, t1) whose (tiles, entries, pixels)
    planes hold at most PLAIN_BUDGET elements, with their longest count."""
    cnt = counts.tolist()
    t0 = 0
    while t0 < len(cnt):
        t1, k = t0 + 1, cnt[t0]
        while t1 < len(cnt) and (t1 - t0 + 1) * max(k, cnt[t1]) * P <= PLAIN_BUDGET:
            k = max(k, cnt[t1])
            t1 += 1
        yield t0, t1, k
        t0 = t1


def blend_groups(packed, starts, counts, width, height, tile_size, d_col,
                 f16):
    """Yield a Blend for each group of tiles of at most PLAIN_BUDGET plane
    elements. w = alpha T for the entries a front-to-back blend keeps
    (sigma >= 0, alpha >= 1/255, T after the entry > 1e-4), else 0;
    transmittance is an exclusive cumprod."""
    dev = packed.device
    tw = (width + tile_size - 1) // tile_size
    P, M = tile_size * tile_size, packed.shape[1]
    mx, my, ca, cb, cc, op, col = decode_payload(packed, d_col, f16)
    lin = torch.arange(P, device=dev)
    lx = (lin % tile_size).float() + 0.5
    ly = (lin // tile_size).float() + 0.5

    def blend(t0, t1, K):
        g = torch.arange(t0, t1, device=dev)
        ar = torch.arange(K, device=dev)
        live = ar[None, :] < counts[g].long()[:, None]                 # (G, K)
        idx = (starts[g].long()[:, None] + ar[None, :]).clamp(0, M - 1)
        px = ((g % tw) * tile_size).float()[:, None] + lx[None, :]     # (G, P)
        py = ((g // tw) * tile_size).float()[:, None] + ly[None, :]
        dx = px[:, None, :] - mx[idx][:, :, None]                      # (G, K, P)
        dy = py[:, None, :] - my[idx][:, :, None]
        params = tuple(v[idx][..., None] for v in (ca, cb, cc, op))
        pa, pb, pc, po = params
        # the kernels round sigma op by op in this order (conic_sigma)
        sigma = 0.5 * (pa * dx * dx + pc * dy * dy) + pb * dx * dy
        alpha = torch.clamp_max(po * torch.exp(-sigma), 0.999)
        keep = (sigma >= 0) & (alpha >= ALPHA_THRESHOLD) & live[..., None]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        t_after = torch.cumprod(1.0 - alpha, dim=1)
        t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], 1)
        w = alpha * t_before * (t_after > T_EPS)
        return Blend(g, idx, live, params, col[:, idx], dx, dy, sigma, alpha,
                     t_before, w)

    for t0, t1, K in tile_groups(counts, P):
        if K:
            yield blend(t0, t1, K)


def _from_tiles(x: torch.Tensor, width: int, height: int, tile_size: int):
    """(n_tiles, P, ...) tile-major planes -> (H, W, ...) image."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    rest = x.shape[2:]
    img = x.reshape(th, tw, tile_size, tile_size, *rest).transpose(1, 2)
    return img.reshape(th * tile_size, tw * tile_size, *rest)[:height, :width]


def _to_tiles(img: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(H, W, D) image -> (n_tiles, P, D) tile-major, zero on the pad."""
    height, width, d = img.shape
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    img = torch.nn.functional.pad(img.float(), (0, 0, 0, tw * tile_size - width,
                                                0, th * tile_size - height))
    img = img.reshape(th, tile_size, tw, tile_size, d).transpose(1, 2)
    return img.reshape(tw * th, tile_size * tile_size, d)


def rasterize_flat_plain(packed: torch.Tensor, starts: torch.Tensor,
                         counts: torch.Tensor, width: int, height: int,
                         tile_size: int, d_col: int, f16: bool,
                         with_state: bool = False):
    """Per-tile vectorized front-to-back blend with the kernel's keep and
    stop rules -> (img (H, W, d_col), alpha (H, W, 1)), both f32; with
    `with_state` also the final transmittance (H, W) f32 and the tile-local
    index of the last kept entry (H, W) int32, -1 where none."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    n_tiles, P, dev = tw * th, tile_size * tile_size, packed.device
    out = torch.zeros(n_tiles, P, d_col, device=dev)
    asum = torch.zeros(n_tiles, P, device=dev)
    t_fin = torch.ones(n_tiles, P, device=dev)
    last = torch.full((n_tiles, P), -1, dtype=torch.int32, device=dev)
    for b in blend_groups(packed, starts, counts, width, height, tile_size,
                          d_col, f16):
        out[b.g] = torch.einsum("gkp,dgk->gpd", b.w, b.col)
        asum[b.g] = b.w.sum(dim=1)
        if with_state:
            kept = b.w > 0
            t_fin[b.g] = torch.where(kept, 1.0 - b.alpha, 1.0).prod(dim=1)
            k = torch.arange(kept.shape[1], device=dev)[None, :, None]
            last[b.g] = torch.where(kept, k, -1).amax(dim=1).to(torch.int32)
    img = _from_tiles(out, width, height, tile_size).contiguous()
    alpha = _from_tiles(asum, width, height, tile_size)[..., None].contiguous()
    if not with_state:
        return img, alpha
    return (img, alpha, _from_tiles(t_fin, width, height, tile_size).contiguous(),
            _from_tiles(last, width, height, tile_size).contiguous())


def grad_rows(d_col: int) -> int:
    """Rows of K3's per-entry output: mx, my, ca, cb, cc, op, d_col colours,
    |mx|, |my|."""
    return 8 + d_col


def splat_cols(d_col: int) -> int:
    """Columns of the kernel's per-splat output (n_gauss, splat_cols): the
    grad_rows rounded up to 4, one 16-byte reduction per 4 rows."""
    return -(-grad_rows(d_col) // 4) * 4


def rasterize_flat_bwd_plain(packed: torch.Tensor, starts: torch.Tensor,
                             counts: torch.Tensor, gauss_ids: torch.Tensor,
                             n_gauss: int, v_img: torch.Tensor,
                             v_alpha: torch.Tensor, width: int, height: int,
                             tile_size: int, d_col: int,
                             with_entries: bool = True):
    """Gradient of rasterize_flat (f32 payload) for the cotangents v_img
    (H, W, d_col) and v_alpha (H, W, 1) -> (per-entry rows (8 + d_col, M),
    or None without `with_entries`, per-splat rows (8 + d_col, n_gauss)),
    rows as grad_rows names them; the last two are the AbsGS absgrad, sum
    over pixels of |d means2d|. An entry's rows are zero unless a pixel of
    its tile keeps it, so the splat rows are the scatter of each tile's
    walked entries alone.

    The blend is replayed per tile group; S_i = sum_{j>i} w_j g_j is a
    reversed exclusive cumulative sum over each tile's entries."""
    dev = packed.device
    M = packed.shape[1]
    entry = torch.zeros(grad_rows(d_col), M, device=dev)
    vout_t = _to_tiles(v_img, tile_size)                    # (T, P, D)
    va_t = _to_tiles(v_alpha, tile_size)[..., 0]            # (T, P)
    for b in blend_groups(packed, starts, counts, width, height, tile_size,
                          d_col, False):
        vo, va = vout_t[b.g], va_t[b.g]
        g = torch.einsum("dgk,gpd->gkp", b.col, vo) + va[:, None, :]
        wg = b.w * g
        rev = torch.flip(wg, [1])
        S = torch.flip(torch.cumsum(torch.cat(
            [torch.zeros_like(rev[:, :1]), rev[:, :-1]], 1), 1), [1])
        kept = b.w > 0
        zero = torch.zeros_like(g)
        dalpha = torch.where(
            kept, b.t_before * g - S / torch.clamp_min(1.0 - b.alpha, 1e-3), zero)
        not_cl = b.alpha < 0.999
        dsig = torch.where(not_cl, -dalpha * b.alpha, zero)
        dop = torch.where(not_cl & kept,
                          dalpha * torch.exp(-torch.clamp_min(b.sigma, 0.0)), zero)
        ca, cb, cc, _ = b.params
        dmx = -dsig * (ca * b.dx + cb * b.dy)
        dmy = -dsig * (cc * b.dy + cb * b.dx)
        rows = torch.stack(
            [dmx.sum(-1), dmy.sum(-1), (dsig * 0.5 * b.dx * b.dx).sum(-1),
             (dsig * b.dx * b.dy).sum(-1), (dsig * 0.5 * b.dy * b.dy).sum(-1),
             dop.sum(-1)]
            + list(torch.einsum("gkp,gpd->dgk", b.w, vo))
            + [dmx.abs().sum(-1), dmy.abs().sum(-1)])       # (rows, G, K)
        entry[:, b.idx[b.live]] = rows[:, b.live]
    splat = torch.zeros(grad_rows(d_col), n_gauss, device=dev)
    splat.index_add_(1, gauss_ids.long(), entry)
    return (entry if with_entries else None), splat


# --- camera-batched and grouped lists (K2m, K5) ----------------------------

def rasterize_flat_multi_plain(packed: torch.Tensor, starts: torch.Tensor,
                               counts: torch.Tensor, n_cams: int, width: int,
                               height: int, tile_size: int, d_col: int):
    """rasterize_flat_plain for each camera of one camera-batched f32 list
    (ops/tiles.bin_gaussians_packed_multi: camera c's tiles are segments
    c * n_tiles .. (c + 1) * n_tiles - 1) -> (img (C, H, W, d_col),
    alpha (C, H, W, 1))."""
    n_tiles = starts.shape[0] // n_cams
    outs = [rasterize_flat_plain(packed, starts[c * n_tiles:(c + 1) * n_tiles],
                                 counts[c * n_tiles:(c + 1) * n_tiles], width,
                                 height, tile_size, d_col, False)
            for c in range(n_cams)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def raster_chunk() -> int:
    """The TPU blend's chunk width, which sets the grouped windows:
    WM_RASTER_CHUNK (512 unless set) rounded down to a multiple of 128, at
    least 128 (rasterizer_pallas._raster_chunk)."""
    c = int(os.environ.get("WM_RASTER_CHUNK", "512"))
    return max(128, (c // 128) * 128)


def group_windows(starts: torch.Tensor, counts: torch.Tensor, group: int,
                  max_per_tile: int, M: int):
    """Clamp each tile's segment to its group's window, as the TPU's grouped
    forward does (rasterizer_pallas._group_windows on the list padded by
    _forward_flat_grouped) -> (starts, counts) int32 (n_tiles,), and
    extra_dropped () int64, the entries the clamp cut.

    A group of `group` consecutive tiles reads one window of Wc chunks from
    the chunk-aligned start of its first tile; a tile's entries past the
    window are dropped, like the max_per_tile cap drops a saturated tile's
    furthest splats. Only a saturated group overflows its window."""
    chunk = raster_chunk()
    n_tiles = starts.shape[0]
    n_groups = -(-n_tiles // group)
    win = (group * -(-max_per_tile // chunk) + 1) * chunk
    M = M + (-M) % chunk + max(0, win - M)        # the padded list length
    pad = n_groups * group - n_tiles
    s = torch.cat([starts.long(), starts.new_full((pad,), M, dtype=torch.long)])
    c = torch.cat([counts.long(), counts.new_zeros((pad,), dtype=torch.long)])
    wbase = torch.clamp_max((s[::group] // chunk) * chunk, max(M - win, 0))
    wbase_t = wbase.repeat_interleave(group)
    wend_t = wbase_t + win
    counts_w = torch.minimum(torch.clamp_min(wend_t - s, 0), c)
    # tiles that start beyond their window (only after an overflow) read none
    starts_w = torch.minimum(torch.maximum(s, wbase_t), wend_t)
    extra = (c - counts_w).sum()
    return (starts_w[:n_tiles].to(torch.int32), counts_w[:n_tiles].to(torch.int32),
            extra)


# K5's plain version (and the wrapper's on a CPU tensor): the group shapes
# only the windows, so it is rasterize_flat_plain on the window-clamped list.
rasterize_flat_grouped_plain = rasterize_flat_plain


# --- kernel wrappers --------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each C entry's arguments before the trailing stream
_FWD_ARGS = [_P] * 8 + [_I] * 6 + [_LL, _I]
_MULTI_ARGS = [_P] * 6 + [_I] * 7 + [_LL]
_BWD_ARGS = [_P] * 11 + [_I] * 6 + [_LL]


def _check_list(packed, starts, counts, width, height, tile_size, d_col, V,
                n_cams=1):
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != V:
        raise ValueError(f"packed must be f32 ({V}, M), got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or t.shape != (n_cams * tw * th,):
            raise ValueError(f"{name} must be int32 ({n_cams * tw * th},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != packed.device:
            raise ValueError(f"{name} must lie on {packed.device}")
    check_kernel_dims(tile_size, d_col)
    return tw, th


# the tiles the forward kernels take: whole warps of WARP_W x WARP_H pixels,
# one thread a pixel, at most 256 threads a block (K2's bound)
KERNEL_TILE_SIZES = (8, 16)


def check_kernel_dims(tile_size: int, d_col: int) -> None:
    """Raise unless the rasterizer kernels take this tile size and colour
    width."""
    if not 1 <= d_col <= 8:
        raise ValueError(f"the rasterizer kernels take d_col 1..8, got {d_col}")
    if tile_size not in KERNEL_TILE_SIZES:
        raise ValueError(f"the rasterizer kernels take tile_size "
                         f"{' or '.join(map(str, KERNEL_TILE_SIZES))} (whole "
                         f"{WARP_W} x {WARP_H}-pixel warps, at most 256 threads a "
                         f"block), got {tile_size}")


def forward_outputs(lead: Tuple[int, ...], height: int, width: int, d_col: int,
                    dev: torch.device, with_state: bool = False):
    """Uninitialised outputs of a forward kernel: img (*lead, H, W, d_col),
    alpha (*lead, H, W, 1), and with `with_state` the training planes
    (final T f32, last kept entry int32, both (*lead, H, W)), else None."""
    img = torch.empty(*lead, height, width, d_col, dtype=torch.float32, device=dev)
    alpha = torch.empty(*lead, height, width, 1, dtype=torch.float32, device=dev)
    if not with_state:
        return img, alpha, None, None
    return (img, alpha,
            torch.empty(*lead, height, width, dtype=torch.float32, device=dev),
            torch.empty(*lead, height, width, dtype=torch.int32, device=dev))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_order(order: torch.Tensor, counts: torch.Tensor) -> None:
    if (order.dtype != torch.int64 or order.shape != counts.shape
            or order.device != counts.device or not order.is_contiguous()):
        raise ValueError(f"order must be contiguous int64 {tuple(counts.shape)} on "
                         f"{counts.device}, got {order.dtype} {tuple(order.shape)} on "
                         f"{order.device}")


def _flat_forward(fn, packed, starts, counts, width, height, tile_size, d_col,
                  f16, with_state, order_out):
    """rasterize_flat's body for `fn` (rasterize_flat or
    rasterize_flat_grouped): the plain version on a CPU tensor, else one
    launch of K2's C entry, counted in fn.launches."""
    if order_out is not None:
        _check_order(order_out, counts)
    if check_device(packed, fn.__name__):
        if order_out is not None:
            order_out.copy_(longest_first(counts))
        return rasterize_flat_plain(packed, starts, counts, width, height,
                                    tile_size, d_col, f16, with_state)
    tw, th = _check_list(packed, starts, counts, width, height, tile_size,
                         d_col, payload_rows(d_col, f16))
    packed, starts, counts = (x.contiguous() for x in (packed, starts, counts))
    order = (torch.empty(counts.shape, dtype=torch.int64, device=counts.device)
             if order_out is None else order_out)
    img, alpha, t_fin, last = forward_outputs((), height, width, d_col,
                                              packed.device, with_state)
    launch("rasterize_flat_fwd", "rasterize_flat_fwd", _FWD_ARGS, packed.device,
           packed.data_ptr(), starts.data_ptr(), counts.data_ptr(), order.data_ptr(),
           img.data_ptr(), alpha.data_ptr(), _ptr(t_fin), _ptr(last), width,
           height, tile_size, tw, tw * th, d_col, packed.shape[1], int(f16))
    fn.launches += 1
    return (img, alpha, t_fin, last) if with_state else (img, alpha)


def rasterize_flat(packed: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, width: int, height: int,
                   tile_size: int, d_col: int, f16: bool,
                   with_state: bool = False, order_out=None):
    """Blend one camera's sorted intersection list -> (img (H, W, d_col),
    alpha (H, W, 1)), both f32; `with_state` adds the final transmittance
    (H, W) and last kept entry (H, W) int32 that the backward reads.

    A CPU tensor takes rasterize_flat_plain; a CUDA tensor launches kernel
    K2 (counted in `rasterize_flat.launches`) or raises. K2's blocks take
    the tiles longest first, in an order its C entry sorts (by count, in
    bins); `order_out`, an (n_tiles,) int64 tensor, receives that order
    (on the CPU: longest_first(counts)), so that K3 can take the same one.
    Tiles must be 16 x 16 on the card.
    """
    return _flat_forward(rasterize_flat, packed, starts, counts, width, height,
                         tile_size, d_col, f16, with_state, order_out)


rasterize_flat.launches = 0


def rasterize_flat_multi(packed: torch.Tensor, starts: torch.Tensor,
                         counts: torch.Tensor, n_cams: int, width: int,
                         height: int, tile_size: int, d_col: int):
    """Blend C cameras' tiles from one camera-batched f32 list in one launch
    -> (img (C, H, W, d_col), alpha (C, H, W, 1)), both f32.

    A CPU tensor takes rasterize_flat_multi_plain; a CUDA tensor launches
    kernel K2m (counted in `rasterize_flat_multi.launches`), its blocks
    taking all cameras' tiles longest first as K2's do, or raises.
    """
    if check_device(packed, "rasterize_flat_multi"):
        return rasterize_flat_multi_plain(packed, starts, counts, n_cams, width,
                                          height, tile_size, d_col)
    tw, th = _check_list(packed, starts, counts, width, height, tile_size,
                         d_col, payload_rows(d_col, False), n_cams)
    packed, starts, counts = (x.contiguous() for x in (packed, starts, counts))
    order = torch.empty(counts.shape, dtype=torch.int64, device=counts.device)
    img, alpha, _, _ = forward_outputs((n_cams,), height, width, d_col,
                                       packed.device)
    launch("rasterize_flat_fwd", "rasterize_flat_multi_fwd", _MULTI_ARGS,
           packed.device, packed.data_ptr(), starts.data_ptr(),
           counts.data_ptr(), order.data_ptr(), img.data_ptr(), alpha.data_ptr(),
           width, height, tile_size, tw, tw * th, n_cams, d_col, packed.shape[1])
    rasterize_flat_multi.launches += 1
    return img, alpha


rasterize_flat_multi.launches = 0


def rasterize_flat_grouped(packed: torch.Tensor, starts: torch.Tensor,
                           counts: torch.Tensor, width: int, height: int,
                           tile_size: int, d_col: int, f16: bool, group: int,
                           with_state: bool = False, order_out=None):
    """rasterize_flat on segments clamped to the windows of `group`
    consecutive tiles (group_windows' starts and counts); same outputs and
    `order_out` as rasterize_flat. `group` shapes only the windows.

    A CPU tensor takes rasterize_flat_grouped_plain (order_out receives
    longest_first(counts)); a CUDA tensor launches kernel K5 (counted in
    `rasterize_flat_grouped.launches`, not in rasterize_flat's) or raises.
    K5 is K2's kernel through K2's C entry: one block a clamped tile, the
    tiles longest first by the clamped counts (csrc/rasterize_flat_fwd.cu
    says why it has no body of its own).
    """
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    return _flat_forward(rasterize_flat_grouped, packed, starts, counts, width,
                         height, tile_size, d_col, f16, with_state, order_out)


rasterize_flat_grouped.launches = 0


def longest_first(counts: torch.Tensor) -> torch.Tensor:
    """The tiles by falling count (int64): the blocks of K2, K2m, K5 and K3
    take the longest lists first, so that the last ones to start are short
    (K2, K2m and K5 sort the counts themselves, in bins; this is their plain
    version and K3's order where none is given)."""
    return torch.argsort(counts, descending=True)


# bins of the kernels' counting sort of the tiles (csrc/raster_order.cuh)
ORDER_BINS = 1024


def order_bins(counts: torch.Tensor) -> torch.Tensor:
    """Each tile's bin in the kernels' longest-first sort: bin 0 the
    longest, bins max(counts) / (ORDER_BINS - 1) wide (int64)."""
    top = max(int(counts.max()) if counts.numel() else 0, 1)
    return ORDER_BINS - 1 - counts.long().clamp_min(0) * (ORDER_BINS - 1) // top


def longest_first_bins(counts: torch.Tensor) -> torch.Tensor:
    """The order raster_order.cuh's longest_first_kernel gives K2, K2m, K5
    and K4 (its plain version): the tiles by bin (order_bins), longest first. The
    kernel leaves the order within a bin to its atomics; this takes index
    order there. No tile blends differently in either order."""
    return torch.sort(order_bins(counts), stable=True).indices


def rasterize_flat_bwd_launch(packed, starts, counts, gauss_ids, v_img, v_alpha,
                              t_final, last, splat, entry, width: int,
                              height: int, tile_size: int, d_col: int,
                              order=None) -> None:
    """Launch K3's C entry on the outputs the caller allocated and zeroed:
    splat (n_gauss, splat_cols(d_col)) and entry (8 + d_col, M) or None.
    `order` (n_tiles,) int64, or None, is the order in which the blocks take
    the tiles. Every tensor must be contiguous on one card; rasterize_flat_bwd
    checks them."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    launch("rasterize_flat_bwd", "rasterize_flat_bwd", _BWD_ARGS, packed.device,
           packed.data_ptr(), starts.data_ptr(), counts.data_ptr(),
           gauss_ids.data_ptr(), v_img.data_ptr(), v_alpha.data_ptr(),
           t_final.data_ptr(), last.data_ptr(), _ptr(order), splat.data_ptr(),
           _ptr(entry), width, height, tile_size, tw, tw * th, d_col,
           packed.shape[1])


def rasterize_flat_bwd(packed: torch.Tensor, starts: torch.Tensor,
                       counts: torch.Tensor, gauss_ids: torch.Tensor,
                       n_gauss: int, v_img: torch.Tensor, v_alpha: torch.Tensor,
                       t_final: torch.Tensor, last: torch.Tensor, width: int,
                       height: int, tile_size: int, d_col: int,
                       with_entries: bool = True, order=None):
    """Gradient of rasterize_flat on an f32 list -> (per-entry rows
    (8 + d_col, M) or None without `with_entries`, per-splat rows
    (8 + d_col, n_gauss)); see rasterize_flat_bwd_plain. t_final and last
    are the forward's `with_state` planes.

    A CPU tensor takes rasterize_flat_bwd_plain (which replays the blend and
    needs neither plane); a CUDA tensor launches kernel K3 (counted in
    `rasterize_flat_bwd.launches`), which adds each tile's rows into the
    splats' rows itself, or raises. On the card the splat rows are a view
    of the kernel's (n_gauss, splat_cols) output, and the per-entry rows
    (for finding where a fault lies) cost a zeroed (8 + d_col, M) buffer.
    `order` (n_tiles,) int64 is the order in which K3's blocks take the
    tiles: the forward's (rasterize_flat's `order_out`), or None to sort the
    counts here. f16-pair payloads and tiles other than 16 x 16 are refused.
    """
    if check_device(packed, "rasterize_flat_bwd"):
        return rasterize_flat_bwd_plain(packed, starts, counts, gauss_ids,
                                        n_gauss, v_img, v_alpha, width, height,
                                        tile_size, d_col, with_entries)
    _check_list(packed, starts, counts, width, height, tile_size, d_col,
                payload_rows(d_col, False))
    if tile_size != 16:
        raise ValueError(f"K3 takes 16 x 16 tiles, got tile_size={tile_size}")
    M, dev = packed.shape[1], packed.device
    planes = (("gauss_ids", gauss_ids, torch.int32, (M,)),
              ("v_img", v_img, torch.float32, (height, width, d_col)),
              ("v_alpha", v_alpha, torch.float32, (height, width, 1)),
              ("t_final", t_final, torch.float32, (height, width)),
              ("last", last, torch.int32, (height, width)))
    for name, x, dtype, shape in planes:
        if x is None or x.dtype != dtype or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}")
    tensors = [x.contiguous() for x in (packed, starts, counts, gauss_ids, v_img,
                                        v_alpha, t_final, last)]
    splat = torch.zeros(n_gauss, splat_cols(d_col), dtype=torch.float32, device=dev)
    entry = (torch.zeros(grad_rows(d_col), M, dtype=torch.float32, device=dev)
             if with_entries else None)
    if order is None:
        order = longest_first(counts)
    _check_order(order, counts)
    rasterize_flat_bwd_launch(*tensors, splat, entry, width, height, tile_size,
                              d_col, order)
    rasterize_flat_bwd.launches += 1
    return entry, splat[:, :grad_rows(d_col)].T


rasterize_flat_bwd.launches = 0
