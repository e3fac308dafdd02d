"""Flat tile-rasterizer forward: kernel K2, its plain version, f16 packing.

Replaces hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py `_kernel_flat`
(via `_forward_flat` / `rasterize_flat_pallas`, flat forward only). Input is
the globally sorted, component-major intersection list of
ops/tiles.bin_gaussians_packed: tile t blends entries
[starts[t], starts[t] + counts[t]) of `packed` (V, M) front to back.
The CUDA kernel is csrc/rasterize_flat_fwd.cu.
"""

import ctypes
from typing import Tuple

import torch

from . import _build

ALPHA_THRESHOLD = 1.0 / 255.0
T_EPS = 1e-4
# the plain version blends groups of tiles whose (tiles, entries, pixels)
# planes hold at most this many elements
PLAIN_BUDGET = 1 << 24

_SIGNATURE_SET = False


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


# --- plain version ----------------------------------------------------------

def blend_groups(packed, starts, counts, width, height, tile_size, d_col,
                 f16):
    """Yield (tile ids, blend weights w (G, K, P), colours (D, G, K),
    transmittance before each entry (G, K, P), live entries (G, K)) for
    groups of tiles of at most PLAIN_BUDGET plane elements. w = alpha T for
    the entries a front-to-back blend keeps (sigma >= 0, alpha >= 1/255,
    T after the entry > 1e-4), else 0; transmittance is an exclusive
    cumprod."""
    dev = packed.device
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    n_tiles, P, M = tw * th, tile_size * tile_size, packed.shape[1]
    mx, my, ca, cb, cc, op, col = decode_payload(packed, d_col, f16)
    lin = torch.arange(P, device=dev)
    lx = (lin % tile_size).float() + 0.5
    ly = (lin // tile_size).float() + 0.5
    cnt = counts.tolist()

    def blend(group):
        K = max(cnt[t] for t in group)
        g = torch.as_tensor(group, device=dev)
        ar = torch.arange(K, device=dev)
        live = ar[None, :] < counts[g].long()[:, None]                 # (G, K)
        idx = (starts[g].long()[:, None] + ar[None, :]).clamp(0, M - 1)
        px = ((g % tw) * tile_size).float()[:, None] + lx[None, :]     # (G, P)
        py = ((g // tw) * tile_size).float()[:, None] + ly[None, :]
        dx = px[:, None, :] - mx[idx][:, :, None]                      # (G, K, P)
        dy = py[:, None, :] - my[idx][:, :, None]
        sigma = (0.5 * (ca[idx][..., None] * dx * dx + cc[idx][..., None] * dy * dy)
                 + cb[idx][..., None] * dx * dy)
        alpha = torch.clamp_max(op[idx][..., None] * torch.exp(-sigma), 0.999)
        keep = (sigma >= 0) & (alpha >= ALPHA_THRESHOLD) & live[..., None]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        t_after = torch.cumprod(1.0 - alpha, dim=1)
        t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], 1)
        w = alpha * t_before * (t_after > T_EPS)
        return g, w, col[:, idx], t_before, live

    group, kmax = [], 0
    for t in range(n_tiles):
        k = max(kmax, cnt[t])
        if group and (len(group) + 1) * k * P > PLAIN_BUDGET:
            if kmax:
                yield blend(group)
            group, k = [], cnt[t]
        group.append(t)
        kmax = k
    if group and kmax:
        yield blend(group)


def rasterize_flat_plain(packed: torch.Tensor, starts: torch.Tensor,
                         counts: torch.Tensor, width: int, height: int,
                         tile_size: int, d_col: int, f16: bool):
    """Per-tile vectorized front-to-back blend with the kernel's keep and
    stop rules -> (img (H, W, d_col), alpha (H, W, 1)), both f32."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    P = tile_size * tile_size
    out = torch.zeros(tw * th, P, d_col, device=packed.device)
    asum = torch.zeros(tw * th, P, device=packed.device)
    for g, w, col, _, _ in blend_groups(packed, starts, counts, width, height,
                                        tile_size, d_col, f16):
        out[g] = torch.einsum("gkp,dgk->gpd", w, col)
        asum[g] = w.sum(dim=1)
    img = out.reshape(th, tw, tile_size, tile_size, d_col).permute(0, 2, 1, 3, 4)
    img = img.reshape(th * tile_size, tw * tile_size, d_col)[:height, :width]
    a = asum.reshape(th, tw, tile_size, tile_size).permute(0, 2, 1, 3)
    a = a.reshape(th * tile_size, tw * tile_size)[:height, :width, None]
    return img.contiguous(), a.contiguous()


# --- kernel wrapper ---------------------------------------------------------

def _library():
    global _SIGNATURE_SET
    lib = _build.load("rasterize_flat_fwd")
    if not _SIGNATURE_SET:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_flat_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           ctypes.c_longlong, i, p]
        lib.rasterize_flat_fwd.restype = ctypes.c_int
        _SIGNATURE_SET = True
    return lib


def rasterize_flat(packed: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, width: int, height: int,
                   tile_size: int, d_col: int, f16: bool):
    """Blend one camera's sorted intersection list -> (img (H, W, d_col),
    alpha (H, W, 1)), both f32.

    A CPU tensor takes rasterize_flat_plain; a CUDA tensor launches the
    kernel (counted in `rasterize_flat.launches`) or raises.
    """
    if packed.device.type == "cpu":
        return rasterize_flat_plain(packed, starts, counts, width, height,
                                    tile_size, d_col, f16)
    if packed.device.type != "cuda":
        raise ValueError(f"rasterize_flat runs on cuda or cpu, not {packed.device}")
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    V = payload_rows(d_col, f16)
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != V:
        raise ValueError(f"packed must be f32 ({V}, M), got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or t.shape != (tw * th,):
            raise ValueError(f"{name} must be int32 ({tw * th},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != packed.device:
            raise ValueError(f"{name} must lie on {packed.device}")
    if not (1 <= d_col <= 8) or tile_size * tile_size > 1024:
        raise ValueError(f"unsupported d_col={d_col} / tile_size={tile_size}")
    packed, starts, counts = (packed.contiguous(), starts.contiguous(),
                              counts.contiguous())
    img = torch.empty(height, width, d_col, dtype=torch.float32, device=packed.device)
    alpha = torch.empty(height, width, 1, dtype=torch.float32, device=packed.device)
    lib = _library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = lib.rasterize_flat_fwd(
            packed.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            img.data_ptr(), alpha.data_ptr(), width, height, tile_size, tw,
            tw * th, d_col, packed.shape[1], int(f16), stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_flat_fwd kernel launch failed: CUDA error {rc}")
    rasterize_flat.launches += 1
    return img, alpha


rasterize_flat.launches = 0
