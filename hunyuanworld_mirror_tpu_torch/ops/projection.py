"""3D Gaussian EWA projection (world -> camera -> screen conics).

Port of hunyuanworld_mirror_tpu/ops/projection.py: `quat_scale_to_covar`,
`quat_scale_to_covar_planes`, the matrix form (`world_to_cam`,
`persp_proj`, `finish_projection`, the tail the unscented-transform
projection of ops/cameras.py shares) and the pinhole
`fully_fused_projection`: gsplat semantics with FOV-limit clamping, eps2d
low-pass dilation with optional anti-aliasing compensation, conics =
inverse 2D covariance, 3.33-sigma integer radii, near/far, radius-clip and
frustum culling by zeroing radii. `fully_fused_projection` works on (C, N)
planes and forms no (C, N, 3, 3) tensor.

`project_pinhole` is one pinhole camera from the splat parameters to what
the blend takes (the covariance, the EWA, the opacity-tight radii, the SH
colours and the render mode's channels), differentiable through an
analytic VJP. A CUDA tensor launches kernel K6 (csrc/project_fwd.cu and
csrc/project_bwd.cu); a CPU tensor runs their plain versions: the forward
is the plain code above (`project_fwd_plain`), the backward
`project_bwd_plain`, which the CUDA backward transcribes.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import profiling
from ..utils import sh as sh_utils
from ..utils.rotation import quat_to_rotmat
from . import tiles
from ._launch import check_device, launch

EPS2D = 0.3          # low-pass dilation of the 2D covariance
NEAR_PLANE = 0.01
FAR_PLANE = 1e10


class Projected(NamedTuple):
    radii: torch.Tensor          # (C, N, 2) int32, 0 marks culled
    means2d: torch.Tensor        # (C, N, 2)
    depths: torch.Tensor         # (C, N)
    conics: torch.Tensor         # (C, N, 3)
    compensations: Optional[torch.Tensor] = None  # (C, N) with calc_compensations


def quat_scale_to_covar(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """XYZW quats (..., 4) + scales (..., 3) -> covariance (..., 3, 3)
    R diag(s)^2 R^T, R from the normalised quats."""
    R = quat_to_rotmat(quats / torch.linalg.norm(quats, dim=-1, keepdim=True))
    M = R * scales[..., None, :]
    return torch.einsum("...ij,...kj->...ik", M, M)


def quat_scale_to_covar_planes(quats: torch.Tensor, scales: torch.Tensor):
    """XYZW quats (N, 4) + scales (N, 3) -> covariance as six (N,) planes
    (xx, xy, xz, yy, yz, zz) of R diag(s)^2 R^T."""
    n = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    x, y, z, w = n[..., 0], n[..., 1], n[..., 2], n[..., 3]
    sx, sy, sz = scales[..., 0], scales[..., 1], scales[..., 2]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    return (m00 * m00 + m01 * m01 + m02 * m02,
            m00 * m10 + m01 * m11 + m02 * m12,
            m00 * m20 + m01 * m21 + m02 * m22,
            m10 * m10 + m11 * m11 + m12 * m12,
            m10 * m20 + m11 * m21 + m12 * m22,
            m20 * m20 + m21 * m21 + m22 * m22)


def world_to_cam(means: torch.Tensor, covars: torch.Tensor,
                 viewmats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """N splats (means (N, 3), covars (N, 3, 3)) into C camera frames
    (viewmats (C, 4, 4) world->cam) -> means_c (C, N, 3), covars_c
    (C, N, 3, 3)."""
    R = viewmats[:, :3, :3]
    t = viewmats[:, :3, 3]
    means_c = torch.einsum("cij,nj->cni", R, means) + t[:, None]
    covars_c = torch.einsum("cij,njk,clk->cnil", R, covars, R)
    return means_c, covars_c


def _fov_limits(Ks: torch.Tensor, width: int, height: int):
    """Per camera (C, 1): fx, fy and the clamp of tx / tz, ty / tz at the
    image edges plus 30% of the half field of view."""
    fx, fy = Ks[:, 0, 0, None], Ks[:, 1, 1, None]
    cx, cy = Ks[:, 0, 2, None], Ks[:, 1, 2, None]
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    return (fx, fy, cx / fx + 0.3 * tan_fovx, (width - cx) / fx + 0.3 * tan_fovx,
            cy / fy + 0.3 * tan_fovy, (height - cy) / fy + 0.3 * tan_fovy)


def persp_proj(means_c: torch.Tensor, covars_c: torch.Tensor, Ks: torch.Tensor,
               width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perspective EWA: camera-frame splats (C, N, 3) and (C, N, 3, 3) ->
    screen means (C, N, 2) and 2D covariance (C, N, 2, 2)."""
    tx, ty, tz = means_c[..., 0], means_c[..., 1], means_c[..., 2]
    tz2 = tz * tz
    fx, fy, lim_x_neg, lim_x_pos, lim_y_neg, lim_y_pos = _fov_limits(Ks, width, height)
    txc = tz * torch.minimum(torch.maximum(tx / tz, -lim_x_neg), lim_x_pos)
    tyc = tz * torch.minimum(torch.maximum(ty / tz, -lim_y_neg), lim_y_pos)
    O = torch.zeros_like(tz)
    J = torch.stack([fx / tz, O, -fx * txc / tz2,
                     O, fy / tz, -fy * tyc / tz2], dim=-1).reshape(*tz.shape, 2, 3)
    cov2d = torch.einsum("...ij,...jk,...lk->...il", J, covars_c, J)
    means2d = torch.einsum("cij,cnj->cni", Ks[:, :2, :3], means_c) / tz[..., None]
    return means2d, cov2d


def _radii(radius_x, radius_y, keep):
    zero = torch.zeros_like(radius_x)
    radii = torch.stack([torch.where(keep, radius_x, zero),
                         torch.where(keep, radius_y, zero)], dim=-1)
    # saturate before the cast (a float -> int cast out of range is undefined)
    return torch.clamp_max(radii, 2.0 ** 30).to(torch.int32)


def finish_projection(means2d: torch.Tensor, covars2d: torch.Tensor,
                      depths: torch.Tensor, width: int, height: int,
                      eps2d: float = EPS2D, near_plane: float = NEAR_PLANE,
                      far_plane: float = FAR_PLANE,
                      calc_compensations: bool = False,
                      extra_valid: Optional[torch.Tensor] = None,
                      radius_clip: float = 0.0) -> Projected:
    """The shared tail: 2D covariance (..., 2, 2) -> dilated conic, radii
    and culling. A NaN covariance (a failed Cholesky factor of the UT path)
    is culled: its det fails det > 0."""
    det_orig = (covars2d[..., 0, 0] * covars2d[..., 1, 1]
                - covars2d[..., 0, 1] * covars2d[..., 1, 0])
    covars2d = covars2d + torch.eye(2, dtype=means2d.dtype, device=means2d.device) * eps2d
    det = torch.clamp_min(covars2d[..., 0, 0] * covars2d[..., 1, 1]
                          - covars2d[..., 0, 1] * covars2d[..., 1, 0], 1e-10)
    compensations = None
    if calc_compensations:
        compensations = torch.sqrt(torch.clamp_min(det_orig / det, 0.0))
    conics = torch.stack([covars2d[..., 1, 1] / det,
                          -(covars2d[..., 0, 1] + covars2d[..., 1, 0]) / 2.0 / det,
                          covars2d[..., 0, 0] / det], dim=-1)
    radius_x = torch.ceil(3.33 * torch.sqrt(covars2d[..., 0, 0]))
    radius_y = torch.ceil(3.33 * torch.sqrt(covars2d[..., 1, 1]))
    valid = (det > 0) & (depths > near_plane) & (depths < far_plane)
    if radius_clip > 0.0:
        valid = valid & (torch.maximum(radius_x, radius_y) > radius_clip)
    if extra_valid is not None:
        valid = valid & extra_valid
    inside = ((means2d[..., 0] + radius_x > 0) & (means2d[..., 0] - radius_x < width)
              & (means2d[..., 1] + radius_y > 0) & (means2d[..., 1] - radius_y < height))
    return Projected(_radii(radius_x, radius_y, valid & inside), means2d, depths,
                     conics, compensations)


def fully_fused_projection(means: torch.Tensor, covars, viewmats: torch.Tensor,
                           Ks: torch.Tensor, width: int, height: int,
                           eps2d: float = EPS2D, near_plane: float = NEAR_PLANE,
                           far_plane: float = FAR_PLANE,
                           calc_compensations: bool = False,
                           radius_clip: float = 0.0) -> Projected:
    """Project N world-space splats into C pinhole cameras (viewmats
    (C, 4, 4) world->cam, Ks (C, 3, 3)). `covars` is the six planes of
    quat_scale_to_covar_planes or an (N, 3, 3) matrix array; either way
    the math is world_to_cam + persp_proj + finish_projection on (C, N)
    planes."""
    if isinstance(covars, torch.Tensor):
        covars = (covars[:, 0, 0], covars[:, 0, 1], covars[:, 0, 2],
                  covars[:, 1, 1], covars[:, 1, 2], covars[:, 2, 2])
    s_xx, s_xy, s_xz, s_yy, s_yz, s_zz = (c[None] for c in covars)
    S = ((s_xx, s_xy, s_xz), (s_xy, s_yy, s_yz), (s_xz, s_yz, s_zz))
    mw = (means[:, 0][None], means[:, 1][None], means[:, 2][None])
    R = viewmats[:, :3, :3]
    t = viewmats[:, :3, 3]
    r = [[R[:, i, j, None] for j in range(3)] for i in range(3)]

    tx, ty, tz = (r[i][0] * mw[0] + r[i][1] * mw[1] + r[i][2] * mw[2]
                  + t[:, i, None] for i in range(3))
    A = [[r[i][0] * S[0][k] + r[i][1] * S[1][k] + r[i][2] * S[2][k]
          for k in range(3)] for i in range(3)]

    def cc(i, j):
        return A[i][0] * r[j][0] + A[i][1] * r[j][1] + A[i][2] * r[j][2]

    c00, c01, c02 = cc(0, 0), cc(0, 1), cc(0, 2)
    c11, c12, c22 = cc(1, 1), cc(1, 2), cc(2, 2)

    fx, fy, lim_x_neg, lim_x_pos, lim_y_neg, lim_y_pos = _fov_limits(Ks, width, height)
    txc = tz * torch.minimum(torch.maximum(tx / tz, -lim_x_neg), lim_x_pos)
    tyc = tz * torch.minimum(torch.maximum(ty / tz, -lim_y_neg), lim_y_pos)

    tz2 = tz * tz
    j00 = fx / tz
    j02 = -fx * txc / tz2
    j11 = fy / tz
    j12 = -fy * tyc / tz2
    v00 = j00 * j00 * c00 + 2.0 * j00 * j02 * c02 + j02 * j02 * c22
    v01 = j00 * j11 * c01 + j00 * j12 * c02 + j02 * j11 * c12 + j02 * j12 * c22
    v11 = j11 * j11 * c11 + 2.0 * j11 * j12 * c12 + j12 * j12 * c22

    u = (Ks[:, 0, 0, None] * tx + Ks[:, 0, 1, None] * ty
         + Ks[:, 0, 2, None] * tz) / tz
    v = (Ks[:, 1, 0, None] * tx + Ks[:, 1, 1, None] * ty
         + Ks[:, 1, 2, None] * tz) / tz

    det_orig = v00 * v11 - v01 * v01
    d00 = v00 + eps2d
    d11 = v11 + eps2d
    det = torch.clamp_min(d00 * d11 - v01 * v01, 1e-10)
    compensations = None
    if calc_compensations:
        compensations = torch.sqrt(torch.clamp_min(det_orig / det, 0.0))
    conics = torch.stack([d11 / det, -v01 / det, d00 / det], dim=-1)
    radius_x = torch.ceil(3.33 * torch.sqrt(d00))
    radius_y = torch.ceil(3.33 * torch.sqrt(d11))
    valid = (det > 0) & (tz > near_plane) & (tz < far_plane)
    if radius_clip > 0.0:
        valid = valid & (torch.maximum(radius_x, radius_y) > radius_clip)
    inside = ((u + radius_x > 0) & (u - radius_x < width)
              & (v + radius_y > 0) & (v - radius_y < height))
    return Projected(_radii(radius_x, radius_y, valid & inside),
                     torch.stack([u, v], dim=-1), tz, conics, compensations)


# --- one pinhole camera, the splat parameters to the blend's inputs ---------

RENDER_MODES = ("RGB", "D", "ED", "RGB+D", "RGB+ED")


def xyzw(quats: torch.Tensor, quat_order: str) -> torch.Tensor:
    """Quaternions (..., 4) in `quat_order` ("xyzw" or "wxyz") as XYZW."""
    if quat_order == "wxyz":
        return torch.cat([quats[..., 1:], quats[..., :1]], dim=-1)
    if quat_order != "xyzw":
        raise ValueError(f"unknown quat_order {quat_order!r}")
    return quats


def sh_colors(colors, means, viewmat):
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


def camera_splats(proj: Projected, means, opacities, colors, viewmat,
                  render_mode: str, tight_radius: bool):
    """Camera 0 of `proj` as the blend takes it: (means2d, conics, the
    render mode's channels, opacities times the compensation if there is
    one, radii (opacity-tight unless tight_radius=False), depths)."""
    m2d, con, dep, rad = proj.means2d[0], proj.conics[0], proj.depths[0], proj.radii[0]
    op = opacities if proj.compensations is None else opacities * proj.compensations[0]
    if tight_radius:
        rad = tiles.opacity_tight_radii(rad, op)
    col = mode_channels(render_mode, lambda: sh_colors(colors, means, viewmat), dep)
    return m2d, con, col, op, rad, dep


class Pinhole(NamedTuple):
    """One pinhole camera's render settings, rasterize's knobs of that name."""
    width: int
    height: int
    render_mode: str = "RGB+ED"
    eps2d: float = EPS2D
    near_plane: float = NEAR_PLANE
    far_plane: float = FAR_PLANE
    calc_compensations: bool = False
    radius_clip: float = 0.0
    tight_radius: bool = True
    quat_order: str = "xyzw"

    @property
    def rgb(self) -> bool:
        return self.render_mode in ("RGB", "RGB+D", "RGB+ED")

    @property
    def depth(self) -> bool:
        return self.render_mode != "RGB"


def sh_degree(colors: torch.Tensor) -> int:
    """The SH degree of (N, K, 3) coefficients, as sh_colors reads it."""
    deg = int(round(colors.shape[-2] ** 0.5)) - 1
    if not 0 <= deg <= 4 or colors.shape[-2] < (deg + 1) ** 2:
        raise ValueError(f"bad SH degree {deg} for {colors.shape[-2]} coefficients")
    return deg


def project_fwd_plain(means, quats, scales, opacities, colors, viewmat, K,
                      cam: Pinhole):
    """K6's forward, plain: the covariance planes of the XYZW quats,
    fully_fused_projection into the one camera, camera_splats ->
    (means2d (N, 2), conics (N, 3), the render mode's channels (N, D'),
    opacities (N,), radii (N, 2) int32, depths (N,))."""
    covars = quat_scale_to_covar_planes(xyzw(quats, cam.quat_order), scales)
    proj = fully_fused_projection(
        means, covars, viewmat[None], K[None], cam.width, cam.height,
        eps2d=cam.eps2d, near_plane=cam.near_plane, far_plane=cam.far_plane,
        calc_compensations=cam.calc_compensations, radius_clip=cam.radius_clip)
    return camera_splats(proj, means, opacities, colors, viewmat, cam.render_mode,
                         cam.tight_radius)


def _sh_basis(deg: int, x, y, z):
    """eval_sh's terms without their coefficients: for k < (deg + 1)^2 the
    basis b_k and its partials (d/dx, d/dy, d/dz), each an (N,) plane or a
    number."""
    C1, C2, C3, C4 = sh_utils.C1, sh_utils.C2, sh_utils.C3, sh_utils.C4
    out = [(sh_utils.C0, (0.0, 0.0, 0.0))]
    if deg > 0:
        out += [(-C1 * y, (0.0, -C1, 0.0)), (C1 * z, (0.0, 0.0, C1)),
                (-C1 * x, (-C1, 0.0, 0.0))]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [(C2[0] * xy, (C2[0] * y, C2[0] * x, 0.0)),
                (C2[1] * yz, (0.0, C2[1] * z, C2[1] * y)),
                (C2[2] * (2 * zz - xx - yy), (-2 * C2[2] * x, -2 * C2[2] * y, 4 * C2[2] * z)),
                (C2[3] * xz, (C2[3] * z, 0.0, C2[3] * x)),
                (C2[4] * (xx - yy), (2 * C2[4] * x, -2 * C2[4] * y, 0.0))]
    if deg > 2:
        out += [(C3[0] * y * (3 * xx - yy), (C3[0] * 6 * xy, C3[0] * 3 * (xx - yy), 0.0)),
                (C3[1] * xy * z, (C3[1] * yz, C3[1] * xz, C3[1] * xy)),
                (C3[2] * y * (4 * zz - xx - yy),
                 (-2 * C3[2] * xy, C3[2] * (4 * zz - xx - 3 * yy), 8 * C3[2] * yz)),
                (C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                 (-6 * C3[3] * xz, -6 * C3[3] * yz, C3[3] * (6 * zz - 3 * xx - 3 * yy))),
                (C3[4] * x * (4 * zz - xx - yy),
                 (C3[4] * (4 * zz - 3 * xx - yy), -2 * C3[4] * xy, 8 * C3[4] * xz)),
                (C3[5] * z * (xx - yy), (2 * C3[5] * xz, -2 * C3[5] * yz, C3[5] * (xx - yy))),
                (C3[6] * x * (xx - 3 * yy), (3 * C3[6] * (xx - yy), -6 * C3[6] * xy, 0.0))]
    if deg > 3:
        out += [(C4[0] * xy * (xx - yy), (C4[0] * y * (3 * xx - yy), C4[0] * x * (xx - 3 * yy), 0.0)),
                (C4[1] * yz * (3 * xx - yy),
                 (6 * C4[1] * xy * z, 3 * C4[1] * z * (xx - yy), C4[1] * y * (3 * xx - yy))),
                (C4[2] * xy * (7 * zz - 1),
                 (C4[2] * y * (7 * zz - 1), C4[2] * x * (7 * zz - 1), 14 * C4[2] * xy * z)),
                (C4[3] * yz * (7 * zz - 3), (0.0, C4[3] * z * (7 * zz - 3), C4[3] * y * (21 * zz - 3))),
                (C4[4] * (zz * (35 * zz - 30) + 3), (0.0, 0.0, C4[4] * z * (140 * zz - 60))),
                (C4[5] * xz * (7 * zz - 3), (C4[5] * z * (7 * zz - 3), 0.0, C4[5] * x * (21 * zz - 3))),
                (C4[6] * (xx - yy) * (7 * zz - 1),
                 (2 * C4[6] * x * (7 * zz - 1), -2 * C4[6] * y * (7 * zz - 1), 14 * C4[6] * z * (xx - yy))),
                (C4[7] * xz * (xx - 3 * yy),
                 (3 * C4[7] * z * (xx - yy), -6 * C4[7] * xy * z, C4[7] * x * (xx - 3 * yy))),
                (C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
                 (4 * C4[8] * x * (xx - 3 * yy), 4 * C4[8] * y * (yy - 3 * xx), 0.0))]
    return out


def _clamp_weight(r, lo, hi):
    """d minimum(maximum(r, lo), hi) / dr as autograd takes it: 1 inside,
    0 outside, 1/2 at a tie."""
    m = torch.maximum(r, lo)
    a = torch.where(r > lo, 1.0, torch.where(r == lo, 0.5, 0.0))
    return a * torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))


def project_bwd_plain(means, quats, scales, opacities, colors, viewmat, K,
                      cam: Pinhole, v_m2d, v_con, v_col, v_op, v_dep):
    """K6's backward, plain: the VJP of project_fwd_plain, written out (the
    CUDA backward transcribes it). The cotangents of means2d (N, 2), conics
    (N, 3), the channels (N, D'), the compensated opacities (N,) and the
    depths (N,) may each be None (zero). Returns the gradients of means,
    quats (in cam.quat_order), scales, opacities (None without
    calc_compensations: the opacities then pass through the projection
    unchanged) and colours (None in the depth-only modes). A row whose
    cotangents are all zero gets zero gradients, as its true VJP is: its
    partials may be NaN (a dead slot at a camera's centre is 0/0)."""
    n = means.shape[0]
    zero = means.new_zeros(n)

    def col_of(g, i):
        return zero if g is None else g[:, i]

    hot = torch.zeros(n, dtype=torch.bool, device=means.device)
    for g in (v_m2d, v_con, v_col, v_op, v_dep):
        if g is not None:
            hot |= (g != 0).reshape(n, -1).any(dim=-1)

    # the forward, recomputed
    q = xyzw(quats, cam.quat_order)
    qn = torch.linalg.norm(q, dim=-1)
    x, y, z, w = (q / qn[:, None]).unbind(-1)
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    s = scales.unbind(-1)
    M = [[R[i][j] * s[j] for j in range(3)] for i in range(3)]
    Sig = [[M[i][0] * M[j][0] + M[i][1] * M[j][1] + M[i][2] * M[j][2]
            for j in range(3)] for i in range(3)]
    Wv = [[viewmat[i, j] for j in range(3)] for i in range(3)]
    mu = means.unbind(-1)
    tx, ty, tz = (Wv[i][0] * mu[0] + Wv[i][1] * mu[1] + Wv[i][2] * mu[2] + viewmat[i, 3]
                  for i in range(3))
    A = [[Wv[i][0] * Sig[0][k] + Wv[i][1] * Sig[1][k] + Wv[i][2] * Sig[2][k]
          for k in range(3)] for i in range(3)]
    C = [[A[i][0] * Wv[j][0] + A[i][1] * Wv[j][1] + A[i][2] * Wv[j][2]
          for j in range(3)] for i in range(3)]
    fx, fy, lxn, lxp, lyn, lyp = (v[0, 0] for v in _fov_limits(K[None], cam.width, cam.height))
    rx, ry = tx / tz, ty / tz
    clx = torch.minimum(torch.maximum(rx, -lxn), lxp)
    cly = torch.minimum(torch.maximum(ry, -lyn), lyp)
    tz2 = tz * tz
    j00, j11 = fx / tz, fy / tz
    j02, j12 = -fx * tz * clx / tz2, -fy * tz * cly / tz2
    c00, c01, c02, c11, c12, c22 = C[0][0], C[0][1], C[0][2], C[1][1], C[1][2], C[2][2]
    v00 = j00 * j00 * c00 + 2 * j00 * j02 * c02 + j02 * j02 * c22
    v01 = j00 * j11 * c01 + j00 * j12 * c02 + j02 * j11 * c12 + j02 * j12 * c22
    v11 = j11 * j11 * c11 + 2 * j11 * j12 * c12 + j12 * j12 * c22
    u = (K[0, 0] * tx + K[0, 1] * ty + K[0, 2] * tz) / tz
    v = (K[1, 0] * tx + K[1, 1] * ty + K[1, 2] * tz) / tz
    d00, d11 = v00 + cam.eps2d, v11 + cam.eps2d
    det_raw = d00 * d11 - v01 * v01
    det = torch.clamp_min(det_raw, 1e-10)

    # conics (d11, -v01, d00) / det
    g_ca, g_cb, g_cc = col_of(v_con, 0), col_of(v_con, 1), col_of(v_con, 2)
    g_d00, g_d11, g_v01 = g_cc / det, g_ca / det, -g_cb / det
    g_det = -(g_ca * d11 - g_cb * v01 + g_cc * d00) / (det * det)
    g_v00 = g_v11 = zero
    g_op = None
    if cam.calc_compensations:
        det_orig = v00 * v11 - v01 * v01
        ratio = det_orig / det
        comp = torch.sqrt(torch.clamp_min(ratio, 0.0))
        g_opo = zero if v_op is None else v_op
        g_op = g_opo * comp
        g_ratio = torch.where(ratio >= 0, g_opo * opacities / (2 * comp), 0.0)
        g_do = g_ratio / det
        g_det = g_det - g_ratio * det_orig / (det * det)
        g_v00, g_v11 = g_do * v11, g_do * v00
        g_v01 = g_v01 - 2 * g_do * v01
    g_detr = torch.where(det_raw >= 1e-10, g_det, 0.0)
    g_v00 = g_v00 + g_d00 + g_detr * d11
    g_v11 = g_v11 + g_d11 + g_detr * d00
    g_v01 = g_v01 - 2 * g_detr * v01

    # the 2D covariance J C J^T
    g_c00 = g_v00 * j00 * j00
    g_c01 = g_v01 * j00 * j11
    g_c02 = 2 * g_v00 * j00 * j02 + g_v01 * j00 * j12
    g_c11 = g_v11 * j11 * j11
    g_c12 = g_v01 * j02 * j11 + 2 * g_v11 * j11 * j12
    g_c22 = g_v00 * j02 * j02 + g_v01 * j02 * j12 + g_v11 * j12 * j12
    g_j00 = g_v00 * 2 * (j00 * c00 + j02 * c02) + g_v01 * (j11 * c01 + j12 * c02)
    g_j02 = g_v00 * 2 * (j00 * c02 + j02 * c22) + g_v01 * (j11 * c12 + j12 * c22)
    g_j11 = g_v11 * 2 * (j11 * c11 + j12 * c12) + g_v01 * (j00 * c01 + j02 * c12)
    g_j12 = g_v11 * 2 * (j11 * c12 + j12 * c22) + g_v01 * (j00 * c02 + j02 * c22)

    # the camera-frame mean: J, the clamp, means2d, depth
    g_u, g_v = col_of(v_m2d, 0), col_of(v_m2d, 1)
    g_tz = zero if v_dep is None else v_dep
    if cam.depth and v_col is not None:
        g_tz = g_tz + v_col[:, -1]
    g_tz = (g_tz - (g_j00 * j00 + g_j11 * j11 + 2 * (g_j02 * j02 + g_j12 * j12)) / tz
            + (g_u * (K[0, 2] - u) + g_v * (K[1, 2] - v)) / tz)
    g_txc, g_tyc = -g_j02 * fx / tz2, -g_j12 * fy / tz2
    g_rx = g_txc * tz * _clamp_weight(rx, -lxn, lxp)
    g_ry = g_tyc * tz * _clamp_weight(ry, -lyn, lyp)
    g_tz = g_tz + g_txc * clx + g_tyc * cly - (g_rx * rx + g_ry * ry) / tz
    g_t = (g_rx / tz + (g_u * K[0, 0] + g_v * K[1, 0]) / tz,
           g_ry / tz + (g_u * K[0, 1] + g_v * K[1, 1]) / tz, g_tz)
    g_mu = [Wv[0][a] * g_t[0] + Wv[1][a] * g_t[1] + Wv[2][a] * g_t[2] for a in range(3)]

    # the world covariance: gS = W^T sym(gC) W, then dS = dM M^T + M dM^T
    Gs = [[g_c00, g_c01 / 2, g_c02 / 2], [g_c01 / 2, g_c11, g_c12 / 2],
          [g_c02 / 2, g_c12 / 2, g_c22]]
    GW = [[Gs[i][0] * Wv[0][b] + Gs[i][1] * Wv[1][b] + Gs[i][2] * Wv[2][b]
           for b in range(3)] for i in range(3)]
    gS = [[Wv[0][a] * GW[0][b] + Wv[1][a] * GW[1][b] + Wv[2][a] * GW[2][b]
           for b in range(3)] for a in range(3)]
    g_M = [[2 * (gS[i][0] * M[0][j] + gS[i][1] * M[1][j] + gS[i][2] * M[2][j])
            for j in range(3)] for i in range(3)]
    g_s = torch.stack([g_M[0][j] * R[0][j] + g_M[1][j] * R[1][j] + g_M[2][j] * R[2][j]
                       for j in range(3)], dim=-1)
    g = [[g_M[i][j] * s[j] for j in range(3)] for i in range(3)]
    g_n = torch.stack([
        2 * (y * (g[0][1] + g[1][0]) + z * (g[0][2] + g[2][0]) + w * (g[2][1] - g[1][2])
             - 2 * x * (g[1][1] + g[2][2])),
        2 * (x * (g[0][1] + g[1][0]) + z * (g[1][2] + g[2][1]) + w * (g[0][2] - g[2][0])
             - 2 * y * (g[0][0] + g[2][2])),
        2 * (x * (g[0][2] + g[2][0]) + y * (g[1][2] + g[2][1]) + w * (g[1][0] - g[0][1])
             - 2 * z * (g[0][0] + g[1][1])),
        2 * (x * (g[2][1] - g[1][2]) + y * (g[0][2] - g[2][0]) + z * (g[1][0] - g[0][1]))],
        dim=-1)
    nq = torch.stack([x, y, z, w], dim=-1)
    g_q = (g_n - nq * (nq * g_n).sum(-1, keepdim=True)) / qn[:, None]
    if cam.quat_order == "wxyz":
        g_q = torch.cat([g_q[:, 3:], g_q[:, :3]], dim=-1)

    # the colours
    g_col = None
    if cam.rgb:
        d_rgb = colors.shape[-1]
        v_rgb = (torch.zeros(n, d_rgb, dtype=means.dtype, device=means.device)
                 if v_col is None else v_col[:, :d_rgb])
        if colors.dim() == 2:
            g_col = v_rgb
        else:
            deg = sh_degree(colors)
            cam_t = -torch.einsum("ij,i->j", viewmat[:3, :3], viewmat[:3, 3])
            d = means - cam_t[None, :]
            nrm = torch.linalg.norm(d, dim=-1, keepdim=True)
            nrm_c = torch.clamp_min(nrm, 1e-8)
            dx, dy, dz = (d / nrm_c).unbind(-1)
            basis = _sh_basis(deg, dx, dy, dz)
            raw = sum(torch.as_tensor(b, dtype=means.dtype)[..., None] * colors[:, k]
                      for k, (b, _) in enumerate(basis))
            v_rgb = torch.where(raw + 0.5 >= 0, v_rgb, 0.0)
            g_col = torch.zeros_like(colors)
            g_dir = [zero, zero, zero]
            for k, (b, db) in enumerate(basis):
                g_col[:, k] = torch.as_tensor(b, dtype=means.dtype)[..., None] * v_rgb
                gk = (v_rgb * colors[:, k]).sum(-1)
                g_dir = [g_dir[a] + gk * db[a] for a in range(3)]
            g_dir = torch.stack(g_dir, dim=-1)
            g_d = (g_dir / nrm_c - torch.where(nrm >= 1e-8, (g_dir * d).sum(-1, keepdim=True)
                                               / (nrm_c * nrm_c * torch.clamp_min(nrm, 1e-30)),
                                               0.0) * d)
            g_mu = [g_mu[a] + g_d[:, a] for a in range(3)]
    g_means = torch.stack(g_mu, dim=-1)

    def masked(t):
        return None if t is None else torch.where(hot.view((n,) + (1,) * (t.dim() - 1)), t, 0.0)

    return (masked(g_means), masked(g_q), masked(g_s), masked(g_op), masked(g_col))


# --- kernel K6: the wrappers and the autograd Function -----------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each C entry's arguments before the trailing stream
_FWD_ARGS = [_P] * 13 + [_LL, _I, _I] + [_F] * 4 + [_I] * 5
_BWD_ARGS = [_P] * 18 + [_LL, _I, _I, _F] + [_I] * 5
# the flags argument's bits
_WXYZ, _COMP, _TIGHT, _RGB, _DEPTH, _CLIP = 1, 2, 4, 8, 16, 32


def _kernel_inputs(means, quats, scales, opacities, colors, viewmat, K):
    """The inputs, checked and contiguous, and the colours' (channels, SH
    coefficients a channel (0 for direct colours), SH degree)."""
    n = means.shape[0]
    shapes = {"means": (means, (n, 3)), "quats": (quats, (n, 4)),
              "scales": (scales, (n, 3)), "opacities": (opacities, (n,)),
              "viewmat": (viewmat, (4, 4)), "K": (K, (3, 3))}
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != means.device:
            raise ValueError(f"{name} must be f32 {shape} on {means.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (colors.dtype != torch.float32 or colors.device != means.device
            or colors.shape[0] != n or colors.dim() not in (2, 3)
            or (colors.dim() == 3 and colors.shape[2] != 3)):
        raise ValueError(f"colors must be f32 (N, D) or SH (N, K, 3), got "
                         f"{colors.dtype} {tuple(colors.shape)}")
    kind = ((colors.shape[1], 0, 0) if colors.dim() == 2
            else (3, colors.shape[1], sh_degree(colors)))
    return [t.contiguous() for t in (means, quats, scales, opacities, colors,
                                     viewmat, K)], kind


def _flags(cam: Pinhole) -> int:
    if cam.quat_order not in ("xyzw", "wxyz"):
        raise ValueError(f"unknown quat_order {cam.quat_order!r}")
    if cam.render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode must be one of {RENDER_MODES}, got "
                         f"{cam.render_mode!r}")
    return ((_WXYZ if cam.quat_order == "wxyz" else 0)
            | (_COMP if cam.calc_compensations else 0)
            | (_TIGHT if cam.tight_radius else 0) | (_RGB if cam.rgb else 0)
            | (_DEPTH if cam.depth else 0) | (_CLIP if cam.radius_clip > 0.0 else 0))


def project_fwd(means, quats, scales, opacities, colors, viewmat, K, cam: Pinhole):
    """One pinhole camera (viewmat (4, 4) world->cam, K (3, 3)) of N splats
    (means (N, 3), quats (N, 4) in cam.quat_order, scales (N, 3),
    opacities (N,), colours (N, D) or SH (N, K, 3)) -> project_fwd_plain's
    outputs. A CPU tensor runs project_fwd_plain; a CUDA tensor launches
    K6's forward (counted in `project_fwd.launches`): one thread a splat,
    viewmat and K read on the card, every operation rounded as the plain
    code's kernels round it, so that the radii and depths, which decide the
    binning and the blend order, are the plain code's bits. Without
    calc_compensations the opacities returned are the input tensor."""
    if check_device(means, "project_fwd"):
        return project_fwd_plain(means, quats, scales, opacities, colors, viewmat, K, cam)
    flags = _flags(cam)
    ins, (d_rgb, sh_k, sh_deg) = _kernel_inputs(means, quats, scales, opacities, colors,
                                                viewmat, K)
    n, dev = means.shape[0], means.device
    d_out = (d_rgb if cam.rgb else 0) + int(cam.depth)
    m2d = torch.empty(n, 2, dtype=torch.float32, device=dev)
    con = torch.empty(n, 3, dtype=torch.float32, device=dev)
    col = torch.empty(n, d_out, dtype=torch.float32, device=dev)
    op = torch.empty(n, dtype=torch.float32, device=dev) if cam.calc_compensations else None
    rad = torch.empty(n, 2, dtype=torch.int32, device=dev)
    dep = torch.empty(n, dtype=torch.float32, device=dev)
    launch("project_fwd", "project_fwd", _FWD_ARGS, dev,
           *(t.data_ptr() for t in ins), m2d.data_ptr(), con.data_ptr(),
           col.data_ptr(), None if op is None else op.data_ptr(), rad.data_ptr(),
           dep.data_ptr(), n, cam.width, cam.height, cam.eps2d, cam.near_plane,
           cam.far_plane, cam.radius_clip, flags, d_rgb, sh_k, sh_deg, d_out)
    project_fwd.launches += 1
    return m2d, con, col, opacities if op is None else op, rad, dep


project_fwd.launches = 0


def project_bwd(means, quats, scales, opacities, colors, viewmat, K, cam: Pinhole,
                v_m2d, v_con, v_col, v_op, v_dep):
    """K6's backward -> project_bwd_plain's gradients. A CPU tensor runs
    project_bwd_plain; a CUDA tensor launches K6's backward (counted in
    `project_bwd.launches`): one thread a splat, the forward recomputed
    from the inputs, the cotangents read where they lie (any strides; a
    None one is zero), every row of each gradient written."""
    if check_device(means, "project_bwd"):
        return project_bwd_plain(means, quats, scales, opacities, colors, viewmat, K,
                                 cam, v_m2d, v_con, v_col, v_op, v_dep)
    flags = _flags(cam)
    ins, (d_rgb, sh_k, sh_deg) = _kernel_inputs(means, quats, scales, opacities, colors,
                                                viewmat, K)
    n, dev = means.shape[0], means.device
    d_out = (d_rgb if cam.rgb else 0) + int(cam.depth)
    cots = (v_m2d, (n, 2)), (v_con, (n, 3)), (v_col, (n, d_out)), (v_op, (n,)), (v_dep, (n,))
    strides = []
    for g, shape in cots:
        if g is not None and (g.dtype != torch.float32 or tuple(g.shape) != shape
                              or g.device != dev):
            raise ValueError(f"a cotangent must be f32 {shape} on {dev}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
        strides += (list(g.stride()) + [0])[:2] if g is not None else [0, 0]
    g_means = torch.empty(n, 3, dtype=torch.float32, device=dev)
    g_quats = torch.empty(n, 4, dtype=torch.float32, device=dev)
    g_scales = torch.empty(n, 3, dtype=torch.float32, device=dev)
    g_op = torch.empty(n, dtype=torch.float32, device=dev) if cam.calc_compensations else None
    g_col = torch.empty_like(ins[4]) if cam.rgb else None
    launch("project_bwd", "project_bwd", _BWD_ARGS, dev,
           *(t.data_ptr() for t in ins),
           *(None if g is None else g.data_ptr() for g, _ in cots),
           (ctypes.c_longlong * 10)(*strides), g_means.data_ptr(), g_quats.data_ptr(),
           g_scales.data_ptr(), None if g_op is None else g_op.data_ptr(),
           None if g_col is None else g_col.data_ptr(), n, cam.width, cam.height,
           cam.eps2d, flags, d_rgb, sh_k, sh_deg, d_out)
    project_bwd.launches += 1
    return g_means, g_quats, g_scales, g_op, g_col


project_bwd.launches = 0


class ProjectPinhole(torch.autograd.Function):
    """project_fwd with project_bwd as its backward. Differentiable in
    means, quats, scales, colours and, with calc_compensations, opacities;
    viewmat and K take no gradient. It saves only its inputs: the backward
    recomputes the rest, as gsplat's fully_fused_projection_bwd does.
    Without calc_compensations its opacity output is None (the caller
    passes the input on)."""

    @staticmethod
    def forward(ctx, means, quats, scales, opacities, colors, viewmat, K, cam):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means, quats, scales, opacities, colors, viewmat, K)
        ctx.cam = cam
        m2d, con, col, op, rad, dep = project_fwd(means, quats, scales, opacities,
                                                  colors, viewmat, K, cam)
        return m2d, con, col, op if cam.calc_compensations else None, rad, dep

    @staticmethod
    def backward(ctx, v_m2d, v_con, v_col, v_op, _v_rad, v_dep):
        grads = project_bwd(*ctx.saved_tensors, ctx.cam, v_m2d, v_con, v_col, v_op, v_dep)
        return (*grads, None, None, None)


def project_pinhole(means, quats, scales, opacities, colors, viewmat, K, cam: Pinhole):
    """One pinhole camera through kernel K6 (or its plain versions on the
    CPU), counted in profiling's counter "project_fused" -> (means2d,
    conics, the render mode's channels, opacities, radii, depths): what
    rasterizer.prepare_camera returns for the camera, without forming the
    covariance planes or the XYZW quaternions. Differentiable through
    ProjectPinhole when grad is on and a splat input requires it; viewmat
    and K must not require grad."""
    profiling.count("project_fused")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (means, quats, scales, opacities, colors)):
        m2d, con, col, op, rad, dep = ProjectPinhole.apply(
            means, quats, scales, opacities, colors, viewmat, K, cam)
        return m2d, con, col, opacities if op is None else op, rad, dep
    return project_fwd(means, quats, scales, opacities, colors, viewmat, K, cam)
