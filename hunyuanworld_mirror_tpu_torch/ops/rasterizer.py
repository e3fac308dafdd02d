"""Tile-based 3D Gaussian rasterization.

Port of hunyuanworld_mirror_tpu/ops/rasterizer.py `rasterize` with its
whole signature, and `rasterize_to_indices`. Per camera: projection
(ops/projection.py, the pinhole EWA; ops/cameras.py, the unscented
transform, for fisheye, f-theta, orthographic, OpenCV distortion and
rolling shutters) -> opacities times the anti-aliasing compensation
(`calc_compensations`) -> opacity-tight radii -> SH colours and the render
mode's channels (RGB, D, ED, RGB+D, RGB+ED) -> flat binning with the exact
ellipse-tile test (ops/tiles.py, f32 or f16-pair payload, exact or
coverage-scheduled prefixes) -> the flat blend (ops/rasterizer_flat.py:
kernel K2, or K5 when WM_RASTER_GROUP > 1) -> expected depth normalized by
alpha in the ED modes. `impl="jax"` takes the JAX package's dense-bin
route instead: the per-tile id table (tiles.bin_gaussians) blended by
kernel K4 (ops/rasterizer_binned.py). `with_eval3d=True` blends the same
dense bins in world space (rasterizer_binned.rasterize_binned_world, plain
PyTorch as in the JAX package). With `camera_batch=True` (inference only,
pinhole) all cameras share one projection call, one sort and one launch of
kernel K2m.

Differentiable in means, quats, scales, opacities and colours: autograd runs
through the projection and the SH evaluation, and `RasterizeFlat` (the port
of the custom VJP of rasterizer_pallas.rasterize_flat_pallas) takes the
blend's gradient with kernel K3.
"""

import os
from typing import Dict, NamedTuple, Optional

import torch

from .. import resolve_device
from ..utils import profiling
from ..utils import sh as sh_utils
from ..utils.rotation import quat_to_rotmat
from . import cameras, projection, tiles
from .rasterizer_binned import (RasterizeBinned, dense_weights, group_entries,
                                rasterize_binned_world, tile_pixels)
from .rasterizer_flat import (_from_tiles, group_windows, pack_f16_pairs,
                              rasterize_flat, rasterize_flat_bwd,
                              rasterize_flat_grouped, rasterize_flat_multi,
                              tile_groups)

RENDER_MODES = ("RGB", "D", "ED", "RGB+D", "RGB+ED")


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


def mode_channels(render_mode: str, rgb, depths: torch.Tensor) -> torch.Tensor:
    """The blended channels of a render mode: colours (RGB), the depth
    (D, ED) or both, depth last (RGB+D, RGB+ED). `rgb` is a callable giving
    the colours (not evaluated in the depth-only modes)."""
    if render_mode in ("D", "ED"):
        return depths[..., None]
    if render_mode in ("RGB+D", "RGB+ED"):
        return torch.cat([rgb(), depths[..., None]], dim=-1)
    return rgb()


def depth_by_alpha(colors: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """The expected depth: the accumulated depth (last channel) over alpha."""
    return torch.cat([colors[..., :-1],
                      colors[..., -1:] / torch.clamp_min(alphas, 1e-10)], dim=-1)


def normalize_mode(colors: torch.Tensor, alphas: torch.Tensor,
                   render_mode: str) -> torch.Tensor:
    """depth_by_alpha in the ED modes; the other modes as blended."""
    return depth_by_alpha(colors, alphas) if render_mode in ("ED", "RGB+ED") else colors


def bin_splats(means2d, conics, colors, opacities, radii, depths,
               tile_size: int, tile_width: int, tile_height: int,
               max_tiles_per_gauss: int, max_per_tile: int,
               payload_f16: bool, with_ids: bool = False, slot_fracs=None,
               exact_test: bool = True) -> tiles.FlatBins:
    """One camera's projected splats -> the sorted flat list kernel K2
    blends: payload [mx, my, ca, cb, cc, op, colours...] in f32, or with
    `payload_f16` [mx, my, ca|cb, cc|op, colour pairs...] as f16 pairs.
    `slot_fracs` ("auto" or one fraction a slot plane) bins through the
    coverage-scheduled prefixes (tiles.bin_gaussians_packed_prefix, no
    ids); `exact_test=False` drops the ellipse-tile test."""
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
    conic_test = tiles.conic_test_planes(conics, opacities) if exact_test else None
    if slot_fracs is not None:
        if with_ids:
            raise ValueError("prefix binning (slot_fracs) returns no entry ids")
        return tiles.bin_gaussians_packed_prefix(
            means2d, radii, depths, values, tile_size, tile_width, tile_height,
            max_tiles_per_gauss, max_per_tile, slot_fracs=slot_fracs,
            conic_test=conic_test)
    return tiles.bin_gaussians_packed(
        means2d, radii, depths, values, tile_size, tile_width, tile_height,
        max_tiles_per_gauss, max_per_tile, conic_test=conic_test,
        with_ids=with_ids)


def _capped(max_per_tile: int, n_splats: int, max_tiles_per_gauss: int) -> int:
    """A tile never holds more than every (splat, tile) pair: small scenes do
    not pay the full static cap (rounded up to 512 as the JAX package does)."""
    n_pairs = n_splats * max_tiles_per_gauss
    return min(max_per_tile, -(-n_pairs // 512) * 512)


class CameraSplats(NamedTuple):
    """One camera's splats as the blend takes them (each (N, ...))."""
    means2d: torch.Tensor
    conics: torch.Tensor
    colors: torch.Tensor     # the render mode's channels
    opacities: torch.Tensor  # times the compensation with calc_compensations
    radii: torch.Tensor      # opacity-tight unless tight_radius=False
    depths: torch.Tensor


def prepare_camera(means, covars, opacities, colors, viewmat, K, width: int,
                   height: int, render_mode: str = "RGB+ED",
                   eps2d: float = projection.EPS2D,
                   near_plane: float = projection.NEAR_PLANE,
                   far_plane: float = projection.FAR_PLANE,
                   calc_compensations: bool = False, radius_clip: float = 0.0,
                   tight_radius: bool = True, ut: Optional[Dict] = None) -> CameraSplats:
    """Project and colour one camera (viewmat (4, 4) world->cam, K (3, 3)),
    differentiable in everything but the radii: the pinhole EWA projection
    of `covars` (six planes or (N, 3, 3)), or with `ut` (the keywords of
    cameras.fully_fused_projection_ut for this camera, its coefficient
    arrays (1, k)) the unscented transform of `covars` (N, 3, 3)."""
    knobs = dict(eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
                 calc_compensations=calc_compensations, radius_clip=radius_clip)
    if ut is None:
        proj = projection.fully_fused_projection(means, covars, viewmat[None],
                                                 K[None], width, height, **knobs)
    else:
        proj = cameras.fully_fused_projection_ut(means, covars, viewmat[None],
                                                 K[None], width, height, **ut, **knobs)
    m2d, con, dep, rad = proj.means2d[0], proj.conics[0], proj.depths[0], proj.radii[0]
    op = opacities if proj.compensations is None else opacities * proj.compensations[0]
    if tight_radius:
        rad = tiles.opacity_tight_radii(rad, op)
    col = mode_channels(render_mode, lambda: _colors(colors, means, viewmat), dep)
    return CameraSplats(m2d, con, col, op, rad, dep)


def project_camera(means, covars, opacities, colors, viewmat, K, width: int,
                   height: int):
    """One pinhole camera's (means2d, conics, colours + depth, tight radii,
    depths) for the binning (prepare_camera in RGB+ED at the defaults)."""
    s = prepare_camera(means, covars, opacities, colors, viewmat, K, width, height)
    return s.means2d, s.conics, s.colors, s.radii, s.depths


def bin_camera(means, quats_xyzw, scales, opacities, colors, viewmat, K,
               width: int, height: int, tile_size: int, max_per_tile: int,
               max_tiles_per_gauss: int, payload_f16: bool,
               with_ids: bool = False, slot_fracs=None) -> tiles.FlatBins:
    """Project, colour (RGB + depth) and bin one pinhole camera (viewmat
    (4, 4) world->cam, K (3, 3)) as the flat route does; the list's colour
    width is colors.shape[-1] + 1."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    covars = projection.quat_scale_to_covar_planes(quats_xyzw, scales)
    m2d, con, col, rad, dep = project_camera(means, covars, opacities, colors,
                                             viewmat, K, width, height)
    return bin_splats(m2d, con, col, opacities, rad, dep, tile_size, tw, th,
                      max_tiles_per_gauss,
                      _capped(max_per_tile, means.shape[0], max_tiles_per_gauss),
                      payload_f16, with_ids, slot_fracs)


def blend_flat(bins: tiles.FlatBins, width: int, height: int, tile_size: int,
               d_col: int, f16: bool, max_per_tile: int,
               with_state: bool = False, order_out=None):
    """The flat forward of one camera's list, K2 or, with WM_RASTER_GROUP =
    G > 1, K5 on the segments clamped to their group windows ->
    (rasterize_flat's outputs, the starts and counts blended, n_dropped
    including the entries the windows cut). `order_out` receives the order
    in which the kernel's blocks took the tiles, longest first by the counts
    blended (the clamped ones on the K5 route). WM_RASTER_GROUP is read at
    every call, as rasterizer_pallas._flat_fwd reads it."""
    group = int(os.environ.get("WM_RASTER_GROUP", "1"))
    if group <= 1:
        outs = rasterize_flat(bins.packed, bins.starts, bins.counts, width,
                              height, tile_size, d_col, f16, with_state, order_out)
        return outs, bins.starts, bins.counts, bins.n_dropped
    starts, counts, extra = group_windows(bins.starts, bins.counts, group,
                                          max_per_tile, bins.packed.shape[1])
    outs = rasterize_flat_grouped(bins.packed, starts, counts, width, height,
                                  tile_size, d_col, f16, group, with_state,
                                  order_out)
    return outs, starts, counts, bins.n_dropped + extra


class RasterizeFlat(torch.autograd.Function):
    """Bin + blend one camera with a hand-written backward (kernel K3).

    Port of rasterizer_pallas.rasterize_flat_pallas's custom VJP with the
    f32 payload. Differentiable inputs: means2d (N, 2), conics (N, 3),
    colours (N, D), opacities (N,) and abs_tap (N, 2), whose gradient is the
    per-splat AbsGS absgrad, sum over pixels of |d means2d|; radii and depths
    are not. Binning and the exact ellipse test run inside forward, as in
    the JAX VJP.

    forward SAVES its sorted list and entry -> splat ids for backward
    instead of re-binning as the JAX VJP does: it spends memory (about
    (6 + D) f32 rows plus one int32 id per entry, 0.39 GB per camera at 9.67M
    entries) to save backward a second sort of the whole list. With
    WM_RASTER_GROUP > 1 the forward is K5 and the saved starts and counts
    are the window-clamped ones, so K3 differentiates what K5 blended; the
    JAX backward re-bins with the unclamped counts, so the two agree only
    where no group overflows its window.

    K2 (and K5, by the clamped counts) sorts the tiles by falling count and
    its blocks take them in that order; forward saves the order, and K3's
    blocks take the tiles in it too.

    backward holds no per-entry buffer: K3 walks each tile back to front
    (its pixels over 4 blocks, a warp to 8 x 4 pixels, the tiles longest
    first), skips for a whole warp the entries whose alpha >= 1/255 ellipse
    misses its pixels, sums each entry's 8 + D terms over a warp in one
    16-shuffle butterfly and over the block in shared memory, and adds them
    into the splats' rows with 16-byte global reductions. Its bytes are the
    saved list, its ids and the pixel planes read once and the splat rows
    written. A tile is not cut into chunks: on the training lists every tile
    walks its whole list, and the longest is ~1.5x the mean.

    `exact_test=False` bins without the ellipse-tile test.

    Returns (img (H, W, D), alpha (H, W, 1), n_dropped (), n_isects ()).
    """

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, abs_tap, radii,
                depths, width, height, tile_size, max_tiles_per_gauss,
                max_per_tile, exact_test=True):
        tw = (width + tile_size - 1) // tile_size
        th = (height + tile_size - 1) // tile_size
        with profiling.span("render.bin"):
            bins = bin_splats(means2d, conics, colors, opacities, radii, depths,
                              tile_size, tw, th, max_tiles_per_gauss, max_per_tile,
                              False, with_ids=True, exact_test=exact_test)
        d = colors.shape[-1]
        with profiling.span("render.blend"):
            order = torch.empty(bins.counts.shape, dtype=torch.int64,
                                device=bins.counts.device)
            (img, alpha, t_fin, last), starts, counts, n_dropped = blend_flat(
                bins, width, height, tile_size, d, False, max_per_tile,
                with_state=True, order_out=order)
        ctx.save_for_backward(bins.packed, starts, counts, bins.gauss_ids,
                              t_fin, last, order)
        ctx.dims = (width, height, tile_size, d, means2d.shape[0])
        n_isects = counts.sum()
        ctx.mark_non_differentiable(n_dropped, n_isects)
        return img, alpha, n_dropped, n_isects

    @staticmethod
    def backward(ctx, v_img, v_alpha, _drop, _isect):
        packed, starts, counts, ids, t_fin, last, order = ctx.saved_tensors
        width, height, tile_size, d, n = ctx.dims
        _, g = rasterize_flat_bwd(packed, starts, counts, ids, n, v_img,
                                  v_alpha, t_fin, last, width, height,
                                  tile_size, d, with_entries=False, order=order)
        absgrad = g[6 + d:8 + d].T if ctx.needs_input_grad[4] else None
        return (g[0:2].T, g[2:5].T, g[6:6 + d].T, g[5], absgrad,
                None, None, None, None, None, None, None, None)


def bin_cameras(means, quats_xyzw, scales, opacities, colors, viewmats, Ks,
                width: int, height: int, tile_size: int, max_per_tile: int,
                max_tiles_per_gauss: int, render_mode: str = "RGB+ED",
                eps2d: float = projection.EPS2D,
                near_plane: float = projection.NEAR_PLANE,
                far_plane: float = projection.FAR_PLANE,
                calc_compensations: bool = False, radius_clip: float = 0.0,
                tight_radius: bool = True):
    """Project all C pinhole cameras in one call, colour them (SH per
    camera, the render mode's channels) and bin them into one sorted f32
    list (bin_gaussians_packed_multi) with opacity-tight radii (unless
    tight_radius=False) and the exact ellipse-tile test -> (bins, the
    projection)."""
    C = viewmats.shape[0]
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    covars = projection.quat_scale_to_covar_planes(quats_xyzw, scales)
    proj = projection.fully_fused_projection(
        means, covars, viewmats, Ks, width, height, eps2d=eps2d,
        near_plane=near_plane, far_plane=far_plane,
        calc_compensations=calc_compensations, radius_clip=radius_clip)
    op = (opacities[None].expand(C, -1) if proj.compensations is None
          else opacities[None] * proj.compensations)
    rad = tiles.opacity_tight_radii(proj.radii, op) if tight_radius else proj.radii
    col = mode_channels(render_mode, lambda: torch.stack(
        [_colors(colors, means, viewmats[c]) for c in range(C)]), proj.depths)
    m2d, con = proj.means2d, proj.conics
    values = ([m2d[..., 0], m2d[..., 1], con[..., 0], con[..., 1], con[..., 2], op]
              + [col[..., i] for i in range(col.shape[-1])])
    bins = tiles.bin_gaussians_packed_multi(
        m2d, rad, proj.depths, values, tile_size, tw, th, max_tiles_per_gauss,
        max_per_tile, conic_test=tiles.conic_test_planes(con, op))
    return bins, proj


def _rasterize_camera_batch(means, quats_xyzw, scales, opacities, colors,
                            viewmats, Ks, width: int, height: int,
                            tile_size: int, max_per_tile: int,
                            max_tiles_per_gauss: int, render_mode: str, **knobs):
    """The camera_batch route (the JAX function's `camera_batch` branch):
    bin_cameras, then one K2m launch. meta["radii"] are the projection's
    radii, not the tight ones, and meta["n_dropped"] is the one total
    broadcast to (C,), as the JAX branch returns them."""
    C = viewmats.shape[0]
    bins, proj = bin_cameras(means, quats_xyzw, scales, opacities, colors,
                             viewmats, Ks, width, height, tile_size,
                             max_per_tile, max_tiles_per_gauss, render_mode, **knobs)
    img, alpha = rasterize_flat_multi(bins.packed, bins.starts, bins.counts, C,
                                      width, height, tile_size,
                                      bins.packed.shape[0] - 6)
    meta: Dict[str, torch.Tensor] = {
        "radii": proj.radii, "means2d": proj.means2d, "depths": proj.depths,
        "n_dropped": bins.n_dropped.expand(C),
        "n_isects": bins.counts.reshape(C, -1).sum(dim=1)}
    return normalize_mode(img, alpha, render_mode), alpha, meta


def _rasterize_binned_camera(m2d, con, col, opacities, rad, dep, width: int,
                             height: int, tile_size: int,
                             max_tiles_per_gauss: int, max_per_tile: int,
                             exact_test: bool):
    """The impl="jax" route of one camera (the JAX function's dense-bin
    branch): the dense per-tile id table (tiles.bin_gaussians) and the blend
    through RasterizeBinned (kernel K4; its plain version on the CPU) ->
    (img, alpha, n_dropped, n_isects)."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    bins = tiles.bin_gaussians(
        m2d, rad, dep, tile_size, tw, th, max_tiles_per_gauss, max_per_tile,
        conic_test=tiles.conic_test_planes(con, opacities) if exact_test else None)
    img, alpha = RasterizeBinned.apply(m2d, con, col, opacities, bins.gauss_ids,
                                       bins.counts, width, height, tile_size)
    return img, alpha, bins.n_dropped, bins.counts.sum()


def eval3d_rotations(quats_xyzw: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """diag(1/s) R(q)^T per splat (N, 3, 3): a world offset into the splat's
    normalised frame."""
    R = quat_to_rotmat(quats_xyzw / torch.linalg.norm(quats_xyzw, dim=-1, keepdim=True))
    return R.transpose(-1, -2) / torch.clamp_min(scales, 1e-12)[..., :, None]


def _rasterize_world_camera(means, iscl_rots, s: CameraSplats, opacities, viewmat,
                            K, ut: Dict, width: int, height: int, tile_size: int,
                            max_tiles_per_gauss: int, max_per_tile: int):
    """The eval3d route of one camera (`ut` its ut_camera keywords): dense
    bins by the projected footprint (no ellipse test: there is no exact 2D
    conic), each pixel's world ray through the inverse camera model, the
    blend in world space with the RAW opacities (the eps2d dilation and its
    compensation belong to the 2D footprint) -> (img, alpha, n_dropped,
    n_isects)."""
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    bins = tiles.bin_gaussians(s.means2d, s.radii, s.depths, tile_size, tw, th,
                               max_tiles_per_gauss, max_per_tile)
    dev = means.device
    gy, gx = torch.meshgrid(torch.arange(th * tile_size, device=dev).float() + 0.5,
                            torch.arange(tw * tile_size, device=dev).float() + 0.5,
                            indexing="ij")
    def one(x):
        return None if x is None else x[0]

    ray_o, ray_d = cameras.image_point_to_world_ray(
        torch.stack([gx, gy], -1), viewmat, K, ut["camera_model"],
        one(ut["radial_coeffs"]), one(ut["tangential_coeffs"]), ut["ftheta_coeffs"],
        ut["rolling_shutter"], one(ut["viewmats_rs"]), width, height)
    img, alpha = rasterize_binned_world(means, iscl_rots, s.colors, opacities, bins,
                                        ray_o, ray_d, width, height, tile_size)
    return img, alpha, bins.n_dropped, bins.counts.sum()


def _tensor(x, dev):
    return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=dev)


def ut_camera(c: int, camera_model: str = cameras.PINHOLE, radial_coeffs=None,
              tangential_coeffs=None,
              ftheta_coeffs: Optional[cameras.FThetaParams] = None,
              rolling_shutter: str = cameras.SHUTTER_GLOBAL, viewmats_rs=None,
              ut_params: Optional[cameras.UTParams] = None) -> Dict:
    """Camera c's keywords for cameras.fully_fused_projection_ut (its
    coefficient arrays and end pose as (1, ...)), from rasterize's camera
    arguments."""
    def pick(x):
        return None if x is None else x[c:c + 1]

    return dict(camera_model=camera_model, radial_coeffs=pick(radial_coeffs),
                tangential_coeffs=pick(tangential_coeffs), ftheta_coeffs=ftheta_coeffs,
                rolling_shutter=rolling_shutter, viewmats_rs=pick(viewmats_rs),
                ut_params=cameras.UTParams() if ut_params is None else ut_params)


def rasterize(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
              opacities: torch.Tensor, colors: torch.Tensor,
              viewmats: torch.Tensor, Ks: torch.Tensor, width: int, height: int,
              tile_size: int = 16, render_mode: str = "RGB+ED",
              eps2d: float = projection.EPS2D,
              near_plane: float = projection.NEAR_PLANE,
              far_plane: float = projection.FAR_PLANE,
              max_per_tile: int = 1024, max_tiles_per_gauss: int = 9,
              impl: str = "pallas", calc_compensations: bool = False,
              quat_order: str = "xyzw", camera_model: str = cameras.PINHOLE,
              radial_coeffs=None, tangential_coeffs=None,
              ftheta_coeffs: Optional[cameras.FThetaParams] = None,
              with_eval3d: bool = False,
              rolling_shutter: str = cameras.SHUTTER_GLOBAL, viewmats_rs=None,
              ut_params: Optional[cameras.UTParams] = None,
              radius_clip: float = 0.0, abs_tap=None, camera_batch: bool = False,
              payload_f16: bool = False, slot_fracs=None, tight_radius: bool = True,
              exact_tile_test: bool = True, device=None):
    """Render N splats into C cameras (gsplat.rasterization's dense
    single-batch form; the JAX function's signature and defaults).
    colors: (N, D) or SH (N, K, 3); viewmats (C, 4, 4) world->cam; Ks
    (C, 3, 3).

    `render_mode` picks the blended channels: RGB, D (accumulated depth),
    ED (expected depth: D over alpha), RGB+D or RGB+ED. `eps2d`,
    `near_plane`, `far_plane`, `radius_clip` (cull footprints whose larger
    radius is <= it) and `calc_compensations` (opacity times the
    anti-aliasing compensation into the blend) are the projection's knobs;
    `tight_radius=False` bins by the 3.33-sigma radii. A camera_model other
    than "pinhole" ("fisheye", "ftheta", "ortho"), OpenCV `radial_coeffs`
    (C, k) or `tangential_coeffs` (C, 2), or a `rolling_shutter` scan order
    with `viewmats_rs` (C, 4, 4), the end-of-frame poses, project through
    the unscented transform (ops/cameras.py, `ut_params` its knobs); the
    binning and blend downstream are the same. `with_eval3d=True` blends
    each splat in world space at its closest approach to the pixel's ray
    (exact under distortion), binned by the projected footprint.

    Differentiable (autograd) in means, quats, scales, opacities and colors
    when grad is enabled and one of them requires it; `abs_tap`, an (N, 2)
    tensor that requires grad and is shared by all cameras, then receives
    the summed AbsGS absgrad (the flat route only, not with eval3d). The
    backward takes only the f32 payload.

    impl="pallas" (the default) is the flat route: a sorted flat list per
    camera blended by kernel K2 (K5 with WM_RASTER_GROUP > 1), its backward
    kernel K3. `slot_fracs` ("auto", or a sequence of one fraction a slot
    plane) bins the forward through coverage-scheduled prefixes
    (tiles.bin_gaussians_packed_prefix): fewer sorted rows, the slots a
    prefix cuts counted in n_dropped; the training path ignores it and bins
    exactly, as the JAX VJP re-bins. impl="jax" is the JAX package's
    dense-bin route: the per-tile id table (tiles.bin_gaussians) blended by
    kernel K4, the backward the plain version under autograd; it ignores
    payload_f16 and slot_fracs, as JAX does, and takes no abs_tap.
    `exact_tile_test=False` drops the ellipse-tile test on both routes.

    `camera_batch=True` renders all pinhole cameras through one sort and
    one K2m launch (_rasterize_camera_batch): forward only, so it raises on
    an input that requires grad or an `abs_tap`, and it always bins the f32
    payload with the exact test. With the unscented transform or eval3d it
    renders per camera, as the JAX function does.

    Runs on `device`: CUDA unless the caller passes one (on a machine
    without a GPU, device=None raises). Returns (colors (C, H, W, D') in
    the render mode's channels, alphas (C, H, W, 1), meta) with
    meta["radii"] (C, N, 2) tight radii, meta["means2d"] (C, N, 2),
    meta["depths"] (C, N), meta["n_dropped"] (C,) intersections lost to the
    static caps and meta["n_isects"] (C,) entries blended.
    """
    if impl not in ("pallas", "jax"):
        raise ValueError(f"unknown impl {impl!r}")
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode must be one of {RENDER_MODES}, got {render_mode!r}")
    if slot_fracs is not None and not isinstance(slot_fracs, str):
        slot_fracs = tuple(slot_fracs)
    dev = resolve_device(device)
    means, quats, scales, opacities, colors, viewmats, Ks = (
        torch.as_tensor(t, dtype=torch.float32, device=dev)
        for t in (means, quats, scales, opacities, colors, viewmats, Ks))
    radial_coeffs, tangential_coeffs, viewmats_rs = (
        _tensor(x, dev) for x in (radial_coeffs, tangential_coeffs, viewmats_rs))
    if quat_order == "wxyz":
        quats = quats[..., [1, 2, 3, 0]]
        profiling.count("host_syncs")   # the index list's upload
    elif quat_order != "xyzw":
        raise ValueError(f"unknown quat_order {quat_order!r}")
    train = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad
        for x in (means, quats, scales, opacities, colors, abs_tap))
    if abs_tap is not None and (impl != "pallas" or with_eval3d):
        # only the flat backward (K3) computes the AbsGS tap; any other
        # route would hand back a zero cotangent and starve the densifier
        raise ValueError(f"abs_tap is differentiated only by impl='pallas' without "
                         f"eval3d (got impl={impl!r}, with_eval3d={with_eval3d})")
    if impl == "jax":
        if camera_batch:
            raise ValueError("camera_batch=True takes only impl='pallas'")
        payload_f16, slot_fracs = False, None
    if train and payload_f16:
        raise ValueError("the rasterizer's backward takes only the f32 payload")
    use_ut = (camera_model != cameras.PINHOLE or radial_coeffs is not None
              or tangential_coeffs is not None
              or rolling_shutter != cameras.SHUTTER_GLOBAL)
    camera_batch = camera_batch and not use_ut and not with_eval3d
    if camera_batch and (train or abs_tap is not None):
        raise ValueError("camera_batch=True is forward only: it takes no input "
                         "that requires grad and no abs_tap")
    knobs = dict(eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
                 calc_compensations=calc_compensations, radius_clip=radius_clip,
                 tight_radius=tight_radius)
    max_per_tile = _capped(max_per_tile, means.shape[0], max_tiles_per_gauss)
    if camera_batch:
        return _rasterize_camera_batch(means, quats, scales, opacities, colors,
                                       viewmats, Ks, width, height, tile_size,
                                       max_per_tile, max_tiles_per_gauss,
                                       render_mode, **knobs)
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    # the UT factors each splat's (3, 3) covariance; the EWA takes planes
    covars = (projection.quat_scale_to_covar(quats, scales) if use_ut
              else projection.quat_scale_to_covar_planes(quats, scales))
    iscl_rots = eval3d_rotations(quats, scales) if with_eval3d else None

    outs = []
    for c in range(viewmats.shape[0]):
        ut = ut_camera(c, camera_model, radial_coeffs, tangential_coeffs, ftheta_coeffs,
                       rolling_shutter, viewmats_rs, ut_params)
        with profiling.span("render.project"):
            s = prepare_camera(means, covars, opacities, colors, viewmats[c], Ks[c],
                               width, height, render_mode, ut=ut if use_ut else None,
                               **knobs)
        if with_eval3d:
            img, alpha, n_drop, n_isect = _rasterize_world_camera(
                means, iscl_rots, s, opacities, viewmats[c], Ks[c], ut, width, height,
                tile_size, max_tiles_per_gauss, max_per_tile)
        elif impl == "jax":
            img, alpha, n_drop, n_isect = _rasterize_binned_camera(
                s.means2d, s.conics, s.colors, s.opacities, s.radii, s.depths, width,
                height, tile_size, max_tiles_per_gauss, max_per_tile, exact_tile_test)
        elif train:
            img, alpha, n_drop, n_isect = RasterizeFlat.apply(
                s.means2d, s.conics, s.colors, s.opacities, abs_tap, s.radii,
                s.depths, width, height, tile_size, max_tiles_per_gauss,
                max_per_tile, exact_tile_test)
        else:
            with profiling.span("render.bin"):
                bins = bin_splats(s.means2d, s.conics, s.colors, s.opacities, s.radii,
                                  s.depths, tile_size, tw, th, max_tiles_per_gauss,
                                  max_per_tile, payload_f16, slot_fracs=slot_fracs,
                                  exact_test=exact_tile_test)
            with profiling.span("render.blend"):
                (img, alpha), _, counts, n_drop = blend_flat(
                    bins, width, height, tile_size, s.colors.shape[-1], payload_f16,
                    max_per_tile)
            n_isect = counts.sum()
        outs.append((img, alpha, n_drop, n_isect, s.radii, s.means2d, s.depths))
    (render_colors, render_alphas, drops, isects, radii, means2d,
     depths) = (torch.stack([o[i] for o in outs]) for i in range(7))
    meta: Dict[str, torch.Tensor] = {
        "radii": radii, "means2d": means2d, "depths": depths,
        "n_dropped": drops, "n_isects": isects}
    return normalize_mode(render_colors, render_alphas, render_mode), render_alphas, meta


def top_k_ids(w: torch.Tensor, ids: torch.Tensor, k: int):
    """Per pixel the k largest blend weights of a group -> (ids (G, P, k)
    int32, -1 where the weight is 0, weights (G, P, k)); w (G, K, P), ids
    (G, K) the entries' splat ids. K < k pads with zero weights."""
    if w.shape[1] < k:
        w = torch.nn.functional.pad(w, (0, 0, 0, k - w.shape[1]))
        ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]))
    vals, idx = torch.topk(w.transpose(1, 2), k, dim=-1)            # (G, P, k)
    gid = torch.gather(ids[:, None, :].expand(-1, idx.shape[1], -1), 2, idx)
    return torch.where(vals > 0, gid, torch.full_like(gid, -1)).to(torch.int32), vals


def indices_image(blocks, width: int, height: int, tile_size: int):
    """(ids, weights) tile groups of top_k_ids -> (ids (H, W, k), weights
    (H, W, k))."""
    ids = torch.cat([b[0] for b in blocks])
    vals = torch.cat([b[1] for b in blocks])
    return (_from_tiles(ids, width, height, tile_size).contiguous(),
            _from_tiles(vals, width, height, tile_size).contiguous())


@torch.no_grad()
def rasterize_to_indices(means: torch.Tensor, quats: torch.Tensor,
                         scales: torch.Tensor, opacities: torch.Tensor,
                         viewmats: torch.Tensor, Ks: torch.Tensor, width: int,
                         height: int, k: int = 8, tile_size: int = 16,
                         eps2d: float = projection.EPS2D,
                         near_plane: float = projection.NEAR_PLANE,
                         far_plane: float = projection.FAR_PLANE,
                         max_per_tile: int = 1024, max_tiles_per_gauss: int = 9,
                         quat_order: str = "xyzw", device=None):
    """Per pixel its top-`k` contributing splats by blend weight alpha T
    (gsplat's rasterize_to_indices in the JAX package's static-shape form):
    the pinhole projection, dense bins by the 3.33-sigma radii, the dense
    blend's weights (rasterizer_binned.dense_weights). Plain PyTorch, as
    the JAX function is plain XLA. Runs on `device` (CUDA unless given) ->
    (ids (C, H, W, k) int32, -1 where the weight is 0, weights (C, H, W, k)
    f32)."""
    dev = resolve_device(device)
    means, quats, scales, opacities, viewmats, Ks = (
        torch.as_tensor(t, dtype=torch.float32, device=dev)
        for t in (means, quats, scales, opacities, viewmats, Ks))
    if quat_order == "wxyz":
        quats = quats[..., [1, 2, 3, 0]]
    covars = projection.quat_scale_to_covar_planes(quats, scales)
    tw = (width + tile_size - 1) // tile_size
    th = (height + tile_size - 1) // tile_size
    P = tile_size * tile_size
    outs = []
    for c in range(viewmats.shape[0]):
        proj = projection.fully_fused_projection(
            means, covars, viewmats[c:c + 1], Ks[c:c + 1], width, height,
            eps2d=eps2d, near_plane=near_plane, far_plane=far_plane)
        m2d, con = proj.means2d[0], proj.conics[0]
        bins = tiles.bin_gaussians(m2d, proj.radii[0], proj.depths[0], tile_size,
                                   tw, th, max_tiles_per_gauss, max_per_tile)
        blocks = []
        for t0, t1, K in tile_groups(bins.counts, P):
            ids, live = group_entries(bins, t0, t1, K)
            w = dense_weights(m2d, con, opacities, ids, live,
                              *tile_pixels(t0, t1, width, tile_size, dev))
            blocks.append(top_k_ids(w, ids, k))
        outs.append(indices_image(blocks, width, height, tile_size))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(2))
