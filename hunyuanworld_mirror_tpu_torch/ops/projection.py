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
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.rotation import quat_to_rotmat

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
