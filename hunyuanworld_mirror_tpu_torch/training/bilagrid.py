"""Bilateral-grid appearance compensation for the splat trainer.

Port of hunyuanworld_mirror_tpu/training/bilagrid.py (gsplat's
lib_bilagrid): per-view (12, L, H, W) grids of 3 x 4 colour affines, each
cell the identity at start, sliced trilinearly at (x, y, BT.601 gray) with
align-corners coordinates and the border clamped, applied as
rgb' = A[:, :3] rgb + A[:, 3]; and the grids' total-variation loss.

Plain torch, differentiable through autograd in the grids and the colours:
the slice is eight gathers of the flattened grid, summed in the JAX
function's order.
"""

from typing import Tuple

import torch

_BT601 = (0.299, 0.587, 0.114)


def init_bilateral_grids(num: int, grid_x: int = 16, grid_y: int = 16,
                         grid_w: int = 8, device=None) -> torch.Tensor:
    """(num, 12, L, H, W) = (num, 12, grid_w, grid_y, grid_x) grids, every
    cell the identity 3 x 4 affine."""
    ident = torch.tensor([1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0],
                         device=device)
    return ident[None, :, None, None, None].expand(
        num, 12, grid_w, grid_y, grid_x).contiguous()


def _trilinear(grids: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Sample B grids (B, 12, L, H, W) at continuous index coordinates
    u -> W, v -> H, w -> L, each (B, ...), clamped to the grid -> (B, ..., 12)."""
    B, C, L, H, W = grids.shape
    shape = u.shape

    def axis(c, n):
        c = torch.clamp(c.reshape(B, -1), 0.0, n - 1.0)
        lo = torch.clamp(torch.floor(c).long(), 0, n - 1)
        hi = torch.clamp(lo + 1, 0, n - 1)
        return lo, hi, c - lo.to(c.dtype)

    ul, uh, uf = axis(u, W)
    vl, vh, vf = axis(v, H)
    wl, wh, wf = axis(w, L)
    flat = grids.reshape(B, C, L * H * W)
    out = 0.0
    for wi, wwt in ((wl, 1 - wf), (wh, wf)):
        for vi, vwt in ((vl, 1 - vf), (vh, vf)):
            for ui, uwt in ((ul, 1 - uf), (uh, uf)):
                idx = (wi * H + vi) * W + ui                            # (B, P)
                g = torch.gather(flat, 2, idx[:, None, :].expand(B, C, -1))
                out = out + g * (wwt * vwt * uwt)[:, None, :]
    return out.movedim(1, -1).reshape(shape + (C,))


def slice_grids(grids: torch.Tensor, xy: torch.Tensor, rgb: torch.Tensor,
                idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slice per-view grids and apply the colour affine.

    grids (num, 12, L, H, W); xy (..., 2) in [0, 1]; rgb (..., 3) in [0, 1];
    idx an int view index, or a (B, 1) tensor whose [:, 0] picks one grid
    for each leading row of xy and rgb. Returns (rgb_out (..., 3),
    affine_mats (..., 3, 4))."""
    L, H, W = grids.shape[2:]
    scalar = not isinstance(idx, torch.Tensor) or idx.dim() == 0
    g = grids[idx][None] if scalar else grids[idx[..., 0]]
    # align_corners: [0, 1] maps to [0, size - 1]
    gx = (xy[..., 0] * 2.0 - 1.0 + 1.0) * 0.5 * (W - 1)
    gy = (xy[..., 1] * 2.0 - 1.0 + 1.0) * 0.5 * (H - 1)
    bt = torch.tensor(_BT601, dtype=rgb.dtype, device=rgb.device)
    gray = rgb @ bt * 2.0 - 1.0                                    # [-1, 1]
    gz = (gray + 1.0) * 0.5 * (L - 1)
    if scalar:
        aff = _trilinear(g, gx[None], gy[None], gz[None])[0]
    else:
        aff = _trilinear(g, gx, gy, gz)
    aff = aff.reshape(aff.shape[:-1] + (3, 4))
    out = torch.einsum("...ij,...j->...i", aff[..., :3], rgb) + aff[..., 3]
    return out, aff


def slice_image_grids(grids: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """Apply per-view grids to (C, H, W, 3) rendered images, grid i to
    image i."""
    C, H, W, _ = images.shape
    dev = images.device
    ys, xs = torch.meshgrid((torch.arange(H, device=dev) + 0.5) / H,
                            (torch.arange(W, device=dev) + 0.5) / W, indexing="ij")
    xy = torch.stack([xs, ys], -1)[None].expand(C, H, W, 2)
    out, _ = slice_grids(grids, xy, images, torch.arange(C, device=dev)[:, None])
    return out


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared difference along each of the L, H and W axes, summed and
    divided by the number of grids."""
    B = grids.shape[0]
    tv = 0.0
    for axis in range(2, grids.dim()):
        d = torch.diff(grids, dim=axis) ** 2
        tv = tv + torch.sum(d) / max(d.numel() // B, 1)
    return tv / B
