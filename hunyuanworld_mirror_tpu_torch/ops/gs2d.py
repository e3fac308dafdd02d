"""2D Gaussian Splatting (surfels): projection and tile rasterization.

Port of hunyuanworld_mirror_tpu/ops/gs2d.py (gsplat's _torch_impl_2dgs
oracle; Huang et al., SIGGRAPH 2024). Each splat is a planar disk: tangent
frame R diag(s_u, s_v), normal R e_z flipped toward the camera. Projection
builds the 3 x 3 ray transform that maps pixel homogeneous coordinates into
the splat's (u, v) plane; the blend intersects each pixel's ray with that
plane (two homography rows, h_u x h_v), evaluates exp(-(u^2 + v^2) / 2)
against a 2 px screen-space low-pass floor and composites front to back,
the normals riding as the last three channels.

Plain PyTorch, as the JAX package's is plain XLA: no kernel. The blend runs
over groups of tiles of dense bins (tiles.bin_gaussians), each group over
its longest count, recomputed in the backward (rasterizer_binned.
checkpointed). Its stop rule is the 2DGS one: weights are zero from the
first entry at which the blend has tripped (T after <= 1e-4 where alpha >
0), not the monotone-T test of the 3DGS blends.
"""

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..utils import sh as sh_utils
from ..utils.rotation import quat_to_rotmat
from . import cameras, tiles
from .projection import FAR_PLANE, NEAR_PLANE
from .rasterizer import _capped, indices_image, mode_channels, normalize_mode, top_k_ids
from .rasterizer_binned import checkpointed, group_entries, tile_pixels
from .rasterizer_flat import ALPHA_THRESHOLD, T_EPS, _from_tiles, _to_tiles, tile_groups


class Projection2D(NamedTuple):
    radii: torch.Tensor           # (C, N, 2) int32 screen extents (0 = culled)
    means2d: torch.Tensor         # (C, N, 2)
    depths: torch.Tensor          # (C, N)
    ray_transforms: torch.Tensor  # (C, N, 3, 3)
    normals: torch.Tensor         # (C, N, 3) camera space, facing the camera


def fully_fused_projection_2dgs(means: torch.Tensor, quats: torch.Tensor,
                                scales: torch.Tensor, viewmats: torch.Tensor,
                                Ks: torch.Tensor, width: int, height: int,
                                near_plane: float = NEAR_PLANE,
                                far_plane: float = FAR_PLANE, eps: float = 1e-6,
                                quat_order: str = "xyzw") -> Projection2D:
    """Project N surfels into C cameras (viewmats (C, 4, 4) world->cam, Ks
    (C, 3, 3)); the screen box comes from the conic of the projected disk."""
    if quat_order == "wxyz":
        quats = quats[..., [1, 2, 3, 0]]
    R_cw = viewmats[:, :3, :3]
    t_cw = viewmats[:, :3, 3]
    means_c = torch.einsum("cij,nj->cni", R_cw, means) + t_cw[:, None, :]
    RS_wl = quat_to_rotmat(quats) * scales[:, None, :]        # columns scaled
    RS_cl = torch.einsum("cij,njk->cnik", R_cw, RS_wl)         # (C, N, 3, 3)
    normals = RS_cl[..., 2]
    cos = -torch.sum(normals * means_c, dim=-1, keepdim=True)
    normals = normals * torch.where(cos > 0, 1.0, -1.0)
    # T maps local (u, v, 1) to pixel homogeneous coordinates; M = T^T
    T_cl = torch.cat([RS_cl[..., :2], means_c[..., None]], dim=-1)
    T_sl = torch.einsum("cij,cnjk->cnik", Ks[:, :3, :3], T_cl)
    M = T_sl.transpose(-1, -2)
    test = torch.tensor([1.0, 1.0, -1.0], dtype=means.dtype, device=means.device)
    d = torch.sum(M[..., 2] * M[..., 2] * test, dim=-1, keepdim=True)
    valid = torch.abs(d) > eps
    # both guards: the inner one keeps the division's gradient finite
    f = torch.where(valid, test / torch.where(valid, d, torch.ones_like(d)),
                    torch.zeros_like(d))[..., None]
    means2d = torch.sum(M[..., :2] * M[..., 2:3] * f, dim=-2)
    extents = torch.sqrt(torch.clamp_min(
        means2d ** 2 - torch.sum(M[..., :2] * M[..., :2] * f, dim=-2), 1e-4))
    depths = means_c[..., 2]
    radius = torch.ceil(3.33 * extents)
    ok = valid[..., 0] & (depths > near_plane) & (depths < far_plane)
    inside = ((means2d[..., 0] + radius[..., 0] > 0)
              & (means2d[..., 0] - radius[..., 0] < width)
              & (means2d[..., 1] + radius[..., 1] > 0)
              & (means2d[..., 1] - radius[..., 1] < height))
    radius = torch.where((ok & inside)[..., None], radius, torch.zeros_like(radius))
    # the blend indexes the ROWS of T (h_u = -M[0] + M[2] x over rows of T)
    return Projection2D(torch.clamp_max(radius, 2.0 ** 30).to(torch.int32), means2d,
                        depths, T_sl, normals)


def tile_weights_2dgs(M, means2d, opacities, live, px, py) -> torch.Tensor:
    """Blend weights (G, K, P) of a group of tiles: M (G, K, 3, 3) ray
    transforms, means2d (G, K, 2) conic centres, opacities, live (G, K),
    pixel centres px, py (G, P) in the PINHOLE frame (a distorted camera
    passes each pixel's undistorted coordinate, so the homography and the
    2 px floor live in one frame)."""
    h_u = -M[:, :, None, 0, :] + M[:, :, None, 2, :] * px[:, None, :, None]  # (G, K, P, 3)
    h_v = -M[:, :, None, 1, :] + M[:, :, None, 2, :] * py[:, None, :, None]
    tmp = torch.linalg.cross(h_u, h_v)
    denom = torch.where(torch.abs(tmp[..., 2]) > 1e-12, tmp[..., 2],
                        torch.full_like(tmp[..., 2], 1e-12))
    us = tmp[..., 0] / denom
    vs = tmp[..., 1] / denom
    sigma3d = us ** 2 + vs ** 2
    dx = px[:, None, :] - means2d[..., 0:1]
    dy = py[:, None, :] - means2d[..., 1:2]
    sigma2d = 2.0 * (dx ** 2 + dy ** 2)
    sigma = 0.5 * torch.minimum(sigma3d, sigma2d)
    alpha = torch.clamp_max(opacities[..., None] * torch.exp(-sigma), 0.999)
    keep = (alpha >= ALPHA_THRESHOLD) & live[..., None]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    lg = torch.log1p(-alpha)
    t_before = torch.exp(torch.cumsum(lg, dim=1) - lg)
    tripped = (t_before * (1.0 - alpha) <= T_EPS) & (alpha > 0)
    stopped = torch.cumsum(tripped.int(), dim=1) > 0
    return torch.where(stopped, torch.zeros_like(alpha), alpha * t_before)


def _blend_2dgs(M, means2d, colors, opacities, live, px, py):
    """One group's blend -> (out (G, P, D), alpha (G, P))."""
    w = tile_weights_2dgs(M, means2d, opacities, live, px, py)
    return torch.einsum("gkp,gkd->gpd", w, colors), w.sum(dim=1)


def _undistort_pixel_map(K, width_pad: int, height_pad: int, camera_model: str,
                         radial, tangential) -> torch.Tensor:
    """The pinhole-equivalent coordinate (Hp, Wp, 2) of every padded pixel
    centre: the ray through a distorted pixel is the pinhole ray through
    its undistorted coordinate, so the surfel homography (built for the
    pinhole K) is exact there."""
    dev = K.device
    gy, gx = torch.meshgrid(torch.arange(height_pad, device=dev).float() + 0.5,
                            torch.arange(width_pad, device=dev).float() + 0.5,
                            indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xy_d = torch.stack([(gx - cx) / fx, (gy - cy) / fy], -1)
    if camera_model == cameras.FISHEYE:
        rd = torch.clamp_min(torch.linalg.norm(xy_d, dim=-1), 1e-12)
        theta = cameras._invert_fisheye_theta(rd, radial)
        xy_u = xy_d * (torch.tan(theta) / rd)[..., None]
    else:  # OpenCV pinhole distortion
        rad = radial if radial is not None else xy_d.new_zeros(1)
        xy_u = cameras.undistort_opencv(xy_d, rad, tangential)
    return torch.stack([fx * xy_u[..., 0] + cx, fy * xy_u[..., 1] + cy], -1)


class Camera2D(NamedTuple):
    means2d: torch.Tensor    # pinhole conic centres (the evaluation frame)
    depths: torch.Tensor
    ray_transforms: torch.Tensor
    normals: torch.Tensor
    radii: torch.Tensor
    colors: Optional[torch.Tensor]
    und_map: Optional[torch.Tensor]  # (Hp, Wp, 2), None for a pinhole camera
    means2d_bin: torch.Tensor        # the centres to bin around


def _prep_camera_2dgs(means, quats, scales, colors, viewmat, K, width, height,
                      near_plane, far_plane, quat_order, camera_model, radial,
                      tangential, sh_degree, tile_size, tw, th) -> Camera2D:
    """One camera's projection, colours and undistortion for the render
    and the indices. A distorted camera bins around the conic centre
    shifted by the distortion's displacement of the 3D mean (exact at zero
    coefficients, first order under mild distortion: binning only; the
    per-pixel evaluation stays exact through the undistortion map)."""
    proj = fully_fused_projection_2dgs(means, quats, scales, viewmat[None], K[None],
                                       width, height, near_plane=near_plane,
                                       far_plane=far_plane, quat_order=quat_order)
    m2d = proj.means2d[0]
    und_map, m2d_bin = None, m2d
    if camera_model != cameras.PINHOLE or radial is not None or tangential is not None:
        means_c = torch.einsum("ij,nj->ni", viewmat[:3, :3], means) + viewmat[:3, 3][None]
        m2d_d = cameras.camera_project(means_c, K, camera_model=camera_model,
                                       radial=radial, tangential=tangential)
        z = torch.clamp_min(means_c[..., 2], 1e-8)
        xy = means_c[..., :2] / z[..., None]
        u_pin = torch.stack([K[0, 0] * xy[..., 0] + K[0, 2],
                             K[1, 1] * xy[..., 1] + K[1, 2]], -1)
        delta = m2d_d - u_pin
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        m2d_bin = m2d + delta
        und_map = _undistort_pixel_map(K, tw * tile_size, th * tile_size,
                                       camera_model, radial, tangential)
    col = colors
    if sh_degree is not None:
        cam_t = -torch.einsum("ij,i->j", viewmat[:3, :3], viewmat[:3, 3])
        dirs = means - cam_t[None, :]
        dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
        col = torch.clamp_min(
            sh_utils.eval_sh(sh_degree, colors.transpose(-1, -2), dirs) + 0.5, 0.0)
    return Camera2D(m2d, proj.depths[0], proj.ray_transforms[0], proj.normals[0],
                    proj.radii[0], col, und_map, m2d_bin)


def _group_pixels(cam: Camera2D, und_t, t0, t1, width, tile_size):
    """Pixel centres (G, P) x, y of tiles t0 .. t1 - 1 in the evaluation
    frame: the undistortion map's tiles, or the pixel grid."""
    if und_t is None:
        return tile_pixels(t0, t1, width, tile_size, cam.means2d.device)
    return und_t[t0:t1, :, 0], und_t[t0:t1, :, 1]


def _bin_2dgs(cam: Camera2D, width, height, tile_size, max_tiles_per_gauss,
              max_per_tile):
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    bins = tiles.bin_gaussians(cam.means2d_bin, cam.radii, cam.depths, tile_size,
                               tw, th, max_tiles_per_gauss, max_per_tile)
    und_t = None if cam.und_map is None else _to_tiles(cam.und_map, tile_size)
    return bins, und_t


def _inputs(means, quats, scales, opacities, viewmats, Ks, radial, tangential, dev):
    f32 = [None if x is None else torch.as_tensor(x, dtype=torch.float32, device=dev)
           for x in (means, quats, scales, opacities, viewmats, Ks, radial, tangential)]
    return f32


def rasterize_2dgs(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
                   opacities: torch.Tensor, colors: torch.Tensor,
                   viewmats: torch.Tensor, Ks: torch.Tensor, width: int, height: int,
                   tile_size: int = 16, render_mode: str = "RGB+ED",
                   near_plane: float = NEAR_PLANE, far_plane: float = FAR_PLANE,
                   max_per_tile: int = 1024, max_tiles_per_gauss: int = 9,
                   quat_order: str = "xyzw", camera_model: str = cameras.PINHOLE,
                   radial_coeffs=None, tangential_coeffs=None, sh_degree=None,
                   device=None):
    """2DGS rasterization (the JAX function's signature) -> (colours
    (C, H, W, D') in the render mode's channels, alphas (C, H, W, 1),
    normals (C, H, W, 3)). colors (N, D), or SH (N, K, 3) with `sh_degree`.

    A distorted camera (camera_model "fisheye" or OpenCV radial (C, k) /
    tangential (C, 2) coefficients) evaluates the surfel homography at each
    pixel's pinhole-equivalent (undistorted) coordinate and bins around the
    distorted centres. Differentiable in means, quats, scales, opacities
    and colours (autograd; each group of tiles recomputed in the backward).
    Runs on `device`: CUDA unless the caller passes one."""
    dev = resolve_device(device)
    means, quats, scales, opacities, viewmats, Ks, radial, tangential = _inputs(
        means, quats, scales, opacities, viewmats, Ks, radial_coeffs,
        tangential_coeffs, dev)
    colors = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    P = tile_size * tile_size
    max_per_tile = _capped(max_per_tile, means.shape[0], max_tiles_per_gauss)
    outs, alphas = [], []
    for c in range(viewmats.shape[0]):
        cam = _prep_camera_2dgs(
            means, quats, scales, colors, viewmats[c], Ks[c], width, height,
            near_plane, far_plane, quat_order, camera_model,
            None if radial is None else radial[c],
            None if tangential is None else tangential[c], sh_degree, tile_size, tw, th)
        col = torch.cat([mode_channels(render_mode, lambda: cam.colors, cam.depths),
                         cam.normals], dim=-1)                 # normals ride last
        bins, und_t = _bin_2dgs(cam, width, height, tile_size, max_tiles_per_gauss,
                                max_per_tile)
        out_t, a_t = [], []
        for t0, t1, K in tile_groups(bins.counts, 3 * P):
            if K == 0:
                out_t.append(means.new_zeros(t1 - t0, P, col.shape[-1]))
                a_t.append(means.new_zeros(t1 - t0, P))
                continue
            ids, live = group_entries(bins, t0, t1, K)
            px, py = _group_pixels(cam, und_t, t0, t1, width, tile_size)
            o, a = checkpointed(_blend_2dgs, cam.ray_transforms[ids], cam.means2d[ids],
                                col[ids], opacities[ids], live, px, py)
            out_t.append(o)
            a_t.append(a)
        outs.append(_from_tiles(torch.cat(out_t), width, height, tile_size))
        alphas.append(_from_tiles(torch.cat(a_t), width, height, tile_size)[..., None])
    out, alphas = torch.stack(outs), torch.stack(alphas)
    return normalize_mode(out[..., :-3], alphas, render_mode), alphas, out[..., -3:]


@torch.no_grad()
def rasterize_to_indices_2dgs(means: torch.Tensor, quats: torch.Tensor,
                              scales: torch.Tensor, opacities: torch.Tensor,
                              viewmats: torch.Tensor, Ks: torch.Tensor, width: int,
                              height: int, k: int = 8, tile_size: int = 16,
                              near_plane: float = NEAR_PLANE,
                              far_plane: float = FAR_PLANE,
                              max_per_tile: int = 1024, max_tiles_per_gauss: int = 9,
                              quat_order: str = "xyzw",
                              camera_model: str = cameras.PINHOLE,
                              radial_coeffs=None, tangential_coeffs=None, device=None):
    """Per pixel its top-`k` contributing surfels by blend weight (gsplat's
    rasterize_to_indices_in_range_2dgs in static-shape form) -> (ids
    (C, H, W, k) int32, -1 where the weight is 0, weights (C, H, W, k))."""
    dev = resolve_device(device)
    means, quats, scales, opacities, viewmats, Ks, radial, tangential = _inputs(
        means, quats, scales, opacities, viewmats, Ks, radial_coeffs,
        tangential_coeffs, dev)
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    P = tile_size * tile_size
    max_per_tile = _capped(max_per_tile, means.shape[0], max_tiles_per_gauss)
    outs = []
    for c in range(viewmats.shape[0]):
        cam = _prep_camera_2dgs(
            means, quats, scales, None, viewmats[c], Ks[c], width, height,
            near_plane, far_plane, quat_order, camera_model,
            None if radial is None else radial[c],
            None if tangential is None else tangential[c], None, tile_size, tw, th)
        bins, und_t = _bin_2dgs(cam, width, height, tile_size, max_tiles_per_gauss,
                                max_per_tile)
        blocks = []
        for t0, t1, K in tile_groups(bins.counts, 3 * P):
            ids, live = group_entries(bins, t0, t1, K)
            px, py = _group_pixels(cam, und_t, t0, t1, width, tile_size)
            w = tile_weights_2dgs(cam.ray_transforms[ids], cam.means2d[ids],
                                  opacities[ids], live, px, py)
            blocks.append(top_k_ids(w, ids, k))
        outs.append(indices_image(blocks, width, height, tile_size))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(2))
