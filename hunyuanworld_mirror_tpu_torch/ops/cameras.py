"""Distorted camera models and the unscented-transform (UT) projection.

Port of hunyuanworld_mirror_tpu/ops/cameras.py (gsplat's Cameras.cuh and
ProjectionUT3DGSFused.cu): OpenCV radial/tangential pinhole distortion,
equidistant fisheye, NVIDIA f-theta, orthographic; rolling-shutter pose
interpolation with the 10-step fixed-point pixel solve; the UT projection
(7 Merwe sigma points through the exact camera, mean and covariance from
the UT weights, then projection.finish_projection); and the inverse models,
pixels -> world rays, for world-space (eval3d) rendering.

Iteration counts are fixed, as in the JAX package (no early stop on
convergence): Newton on a polynomial 3 steps by default, the shutter solve,
the OpenCV undistortion and the fisheye inversion 10. Quaternions are XYZW.
Plain PyTorch, differentiable; the JAX package has no kernel here.
"""

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.rotation import rotmat_to_quat
from .projection import Projected, finish_projection

PINHOLE = "pinhole"
FISHEYE = "fisheye"
FTHETA = "ftheta"
ORTHO = "ortho"

# rolling-shutter scan orders: GLOBAL exposes all pixels at once; the others
# read the sensor out along one image axis, so each pixel sees the camera at
# its own relative frame time in [0, 1]
SHUTTER_GLOBAL = "global"
SHUTTER_TOP_TO_BOTTOM = "top_to_bottom"
SHUTTER_LEFT_TO_RIGHT = "left_to_right"
SHUTTER_BOTTOM_TO_TOP = "bottom_to_top"
SHUTTER_RIGHT_TO_LEFT = "right_to_left"

# FThetaParams.reference_poly: which polynomial is authoritative (the other
# direction is recovered by Newton inversion)
PIXELDIST_TO_ANGLE = "pixeldist_to_angle"
ANGLE_TO_PIXELDIST = "angle_to_pixeldist"


class UTParams(NamedTuple):
    """Unscented-transform knobs (gsplat's UnscentedTransformParameters)."""
    alpha: float = 0.1
    beta: float = 2.0
    kappa: float = 0.0
    # validity margin as a fraction of the image extent
    in_image_margin_factor: float = 0.1
    # True: every sigma point must project validly; False: any one suffices
    require_all_sigma_points_valid: bool = True


class FThetaParams(NamedTuple):
    """NVIDIA f-theta distortion: pixel_dist = f(theta) as a degree-5
    polynomial (`angle_to_pixeldist_poly`) or as its inverse
    (`pixeldist_to_angle_poly`); `linear_cde` is the 2 x 2 skew
    [[c, d], [e, 1]] on the distorted offset. Only the principal point of K
    is read, offset by +0.5 (the f-theta image origin is the first pixel's
    centre)."""
    reference_poly: str = ANGLE_TO_PIXELDIST
    pixeldist_to_angle_poly: Tuple[float, ...] = (0.0,) * 6
    angle_to_pixeldist_poly: Tuple[float, ...] = (0.0,) * 6
    max_angle: float = 3.141592653589793
    linear_cde: Tuple[float, float, float] = (1.0, 0.0, 0.0)


def _radius(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) with a finite gradient on the optical axis: the inner
    where keeps sqrt's infinite slope at 0 out of the backward (a splat's
    mean, the UT's first sigma point, can lie exactly on the axis, where
    JAX's gradient is NaN). The values are sqrt's."""
    r2 = x * x + y * y
    on_axis = r2 == 0
    return torch.where(on_axis, torch.zeros_like(r2),
                       torch.sqrt(torch.where(on_axis, torch.ones_like(r2), r2)))


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(x, float(coeffs[-1]))
    for c in reversed(coeffs[:-1]):
        acc = acc * x + float(c)
    return acc


def _poly_deriv(coeffs) -> Tuple[float, ...]:
    return tuple(float((i + 1) * c) for i, c in enumerate(coeffs[1:]))


def _newton_invert_poly(ref, approx, y: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Solve ref(x) = y for x from x0 = approx(y), `iters` Newton steps."""
    dref = _poly_deriv(ref)
    x = _horner(approx, y)
    for _ in range(iters):
        f = _horner(ref, x) - y
        df = _horner(dref, x)
        safe = torch.where(torch.abs(df) > 1e-12, df, torch.full_like(df, 1e-12))
        x = x - f / safe
    return x


def project_ftheta(means_c: torch.Tensor, K: torch.Tensor,
                   ftheta: FThetaParams) -> torch.Tensor:
    """Camera-frame points (..., 3) -> f-theta pixels (..., 2)."""
    x, y, z = means_c[..., 0], means_c[..., 1], means_c[..., 2]
    r = torch.clamp_min(_radius(x, y), 1e-12)
    theta = torch.clamp_max(torch.atan2(r, z), ftheta.max_angle)
    if ftheta.reference_poly == PIXELDIST_TO_ANGLE:
        delta = _newton_invert_poly(ftheta.pixeldist_to_angle_poly,
                                    ftheta.angle_to_pixeldist_poly, theta)
    else:
        delta = _horner(ftheta.angle_to_pixeldist_poly, theta)
    c, d, e = ftheta.linear_cde
    ipx = delta * x / r
    ipy = delta * y / r
    u = c * ipx + d * ipy + K[..., 0, 2] + 0.5
    v = e * ipx + ipy + K[..., 1, 2] + 0.5
    return torch.stack([u, v], -1)


def _padded(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """Coefficients (..., k) zero-padded to (..., n)."""
    return F.pad(coeffs, (0, n - coeffs.shape[-1]))


def _opencv_scale(x, y, k):
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    num = 1.0 + k[..., 0] * r2 + k[..., 1] * r4 + k[..., 2] * r6
    den = 1.0 + k[..., 3] * r2 + k[..., 4] * r4 + k[..., 5] * r6
    return r2, num / den


def _opencv_tangential(x, y, r2, tangential):
    p1, p2 = tangential[..., 0], tangential[..., 1]
    return (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
            p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)


def distort_opencv(xy: torch.Tensor, radial: torch.Tensor,
                   tangential: Optional[torch.Tensor] = None) -> torch.Tensor:
    """OpenCV distortion of normalised coordinates (..., 2): radial k1..k6
    (..., up to 6; the rational model with k4..k6), tangential p1, p2."""
    k = _padded(radial, 6)
    x, y = xy[..., 0], xy[..., 1]
    r2, scale = _opencv_scale(x, y, k)
    xd = x * scale
    yd = y * scale
    if tangential is not None:
        tx, ty = _opencv_tangential(x, y, r2, tangential)
        xd = xd + tx
        yd = yd + ty
    return torch.stack([xd, yd], -1)


def project_fisheye(means_c: torch.Tensor, K: torch.Tensor,
                    radial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Equidistant fisheye (Kannala-Brandt): the radius theta (1 + k1 th^2
    + k2 th^4 + k3 th^6 + k4 th^8) along the radial direction."""
    x, y, z = means_c[..., 0], means_c[..., 1], means_c[..., 2]
    r = _radius(x, y)
    theta = torch.atan2(r, z)
    th2 = theta * theta
    d = theta
    if radial is not None:
        k = _padded(radial, 4)
        d = theta * (1.0 + k[..., 0] * th2 + k[..., 1] * th2 ** 2
                     + k[..., 2] * th2 ** 3 + k[..., 3] * th2 ** 4)
    scale = torch.where(r > 1e-8, d / torch.clamp_min(r, 1e-8),
                        1.0 / torch.clamp_min(z, 1e-8))
    u = K[..., 0, 0] * x * scale + K[..., 0, 2]
    v = K[..., 1, 1] * y * scale + K[..., 1, 2]
    return torch.stack([u, v], -1)


def camera_project(means_c: torch.Tensor, K: torch.Tensor,
                   camera_model: str = PINHOLE,
                   radial: Optional[torch.Tensor] = None,
                   tangential: Optional[torch.Tensor] = None,
                   ftheta: Optional[FThetaParams] = None) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2) under the model."""
    if camera_model == FISHEYE:
        return project_fisheye(means_c, K, radial)
    if camera_model == FTHETA:
        return project_ftheta(means_c, K, ftheta if ftheta is not None else FThetaParams())
    if camera_model == ORTHO:
        return torch.stack([K[..., 0, 0] * means_c[..., 0] + K[..., 0, 2],
                            K[..., 1, 1] * means_c[..., 1] + K[..., 1, 2]], -1)
    if camera_model != PINHOLE:
        raise ValueError(f"unknown camera_model {camera_model!r}")
    z = torch.clamp_min(means_c[..., 2], 1e-8)
    xy = means_c[..., :2] / z[..., None]
    if radial is not None or tangential is not None:
        xy = distort_opencv(xy, radial if radial is not None else xy.new_zeros(1),
                            tangential)
    return torch.stack([K[..., 0, 0] * xy[..., 0] + K[..., 0, 2],
                        K[..., 1, 1] * xy[..., 1] + K[..., 1, 2]], -1)


# --- rolling shutter ---------------------------------------------------------

def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, the others broadcast as jnp.cross's."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by XYZW unit quaternions q (..., 4)."""
    qv, qw = q[..., :3], q[..., 3:4]
    t2 = 2.0 * _cross(qv, v)
    return v + qw * t2 + _cross(qv, t2)


def _quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def _quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Shortest-path slerp between XYZW quats, vectorised over t (...)."""
    d = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where(d[..., None] < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.acos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    small = sin_t < 1e-6
    safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)


def _viewmat_pose(viewmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """world->cam (4, 4) -> (XYZW quat, translation)."""
    return rotmat_to_quat(viewmat[..., :3, :3]), viewmat[..., :3, 3]


def shutter_relative_time(uv: torch.Tensor, width: int, height: int,
                          shutter_type: str) -> torch.Tensor:
    """Pixels (..., 2) -> relative frame time in [0, 1] for the scan order."""
    u, v = uv[..., 0], uv[..., 1]
    if shutter_type == SHUTTER_TOP_TO_BOTTOM:
        return torch.floor(v) / (height - 1)
    if shutter_type == SHUTTER_LEFT_TO_RIGHT:
        return torch.floor(u) / (width - 1)
    if shutter_type == SHUTTER_BOTTOM_TO_TOP:
        return (height - torch.ceil(v)) / (height - 1)
    if shutter_type == SHUTTER_RIGHT_TO_LEFT:
        return (width - torch.ceil(u)) / (width - 1)
    if shutter_type != SHUTTER_GLOBAL:
        raise ValueError(f"unknown rolling shutter {shutter_type!r}")
    return torch.zeros_like(u)


def _project_valid(pts_c: torch.Tensor, uv: torch.Tensor, width: int,
                   height: int, margin: float) -> torch.Tensor:
    """In front of the camera and inside the image grown by `margin` of its
    extent on each side."""
    mx, my = margin * width, margin * height
    inside = ((uv[..., 0] >= -mx) & (uv[..., 0] <= width + mx)
              & (uv[..., 1] >= -my) & (uv[..., 1] <= height + my))
    return inside & (pts_c[..., 2] > 1e-6)


def world_point_to_image_shutter(
        pts_w: torch.Tensor, K: torch.Tensor,
        pose_start: Tuple[torch.Tensor, torch.Tensor],
        pose_end: Tuple[torch.Tensor, torch.Tensor],
        width: int, height: int, shutter_type: str,
        camera_model: str = PINHOLE, radial: Optional[torch.Tensor] = None,
        tangential: Optional[torch.Tensor] = None,
        ftheta: Optional[FThetaParams] = None, iters: int = 10,
        margin: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rolling-shutter world -> image: `iters` fixed-point steps on the
    pixel's shutter time, from the start pose's pixel (the end pose's where
    the start's is invalid). -> (uv (..., 2), valid (...)): valid iff the
    start or the end pose projects inside the margin-grown image."""
    q0, t0 = pose_start
    q1, t1 = pose_end

    def proj(q, t):
        pts_c = _quat_rotate(q, pts_w) + t
        uv = camera_project(pts_c, K, camera_model, radial, tangential, ftheta=ftheta)
        return uv, _project_valid(pts_c, uv, width, height, margin)

    uv0, v0 = proj(q0, t0)
    if shutter_type == SHUTTER_GLOBAL:
        return uv0, v0
    uv1, v1 = proj(q1, t1)
    uv = torch.where(v0[..., None], uv0, uv1)
    for _ in range(iters):
        tr = shutter_relative_time(uv, width, height, shutter_type)
        q = _quat_slerp(q0, q1, tr)
        t = (1.0 - tr)[..., None] * t0 + tr[..., None] * t1
        uv, _ = proj(q, t)
    return uv, v0 | v1


# --- the unscented transform ---------------------------------------------------

def _cholesky3(covars: torch.Tensor):
    """Lower Cholesky factors of (..., 3, 3) matrices -> (L, failed (...)).
    torch.linalg.cholesky raises where jnp.linalg.cholesky gives NaN; here
    a matrix without a factor is factored as the identity instead, and the
    caller turns its outputs to NaN after the nonlinear projection, so that
    they are culled as in JAX while its gradient stays finite (a NaN factor
    would make 0 x NaN of every partial upstream)."""
    L, info = torch.linalg.cholesky_ex(covars)
    bad = info != 0
    if bool(bad.any()):
        eye = torch.eye(3, dtype=covars.dtype, device=covars.device)
        L, _ = torch.linalg.cholesky_ex(torch.where(bad[..., None, None], eye, covars))
    return L, bad


def _sigma_points(means: torch.Tensor, covars: torch.Tensor, alpha: float = 0.1,
                  beta: float = 2.0, kappa: float = 0.0):
    """Merwe sigma points of (..., 3) Gaussians -> (points (..., 7, 3),
    w_mean (7,), w_cov (7,), failed (...): no Cholesky factor, its points
    those of the identity covariance)."""
    n = 3
    lam = alpha * alpha * (n + kappa) - n
    # jitter keeps flat splats (tiny s_z) factorable
    eye = torch.eye(3, dtype=means.dtype, device=means.device)
    L, bad = _cholesky3(covars + 1e-10 * eye)
    scaled = (n + lam) ** 0.5 * L                                    # columns
    offsets = torch.cat([torch.zeros_like(means)[..., None, :],
                         scaled.transpose(-1, -2), -scaled.transpose(-1, -2)], dim=-2)
    pts = means[..., None, :] + offsets
    w_m = torch.full((2 * n + 1,), 1.0 / (2 * (n + lam)), dtype=means.dtype,
                     device=means.device)
    w_m[0] = lam / (n + lam)
    w_c = w_m.clone()
    w_c[0] = lam / (n + lam) + 1.0 - alpha * alpha + beta
    return pts, w_m, w_c, bad


def fully_fused_projection_ut(
        means: torch.Tensor, covars: torch.Tensor, viewmats: torch.Tensor,
        Ks: torch.Tensor, width: int, height: int, camera_model: str = PINHOLE,
        radial_coeffs: Optional[torch.Tensor] = None,
        tangential_coeffs: Optional[torch.Tensor] = None,
        ftheta_coeffs: Optional[FThetaParams] = None, eps2d: float = 0.3,
        near_plane: float = 0.01, far_plane: float = 1e10,
        calc_compensations: bool = False,
        rolling_shutter: str = SHUTTER_GLOBAL,
        viewmats_rs: Optional[torch.Tensor] = None,
        ut_params: UTParams = UTParams(), radius_clip: float = 0.0) -> Projected:
    """UT projection of N world splats (means (N, 3), covars (N, 3, 3)) into
    C cameras (viewmats (C, 4, 4) world->cam, Ks (C, 3, 3); radial (C, k),
    tangential (C, 2), f-theta shared): projection.fully_fused_projection's
    output, so the result feeds the same binning and blend.

    With a rolling shutter (`rolling_shutter` != "global" and `viewmats_rs`,
    the end-of-frame poses) each sigma point takes the fixed-point shutter
    solve and depth uses the mid-frame pose. Fisheye keeps the frontal
    hemisphere, f-theta the frontal hemisphere inside max_angle."""
    R = viewmats[:, :3, :3]
    t = viewmats[:, :3, 3]
    pts_w, w_m, w_c, bad = _sigma_points(means, covars, alpha=ut_params.alpha,
                                         beta=ut_params.beta, kappa=ut_params.kappa)
    rs = rolling_shutter != SHUTTER_GLOBAL and viewmats_rs is not None
    m2d, cov2d, dep, val = [], [], [], []
    for c in range(viewmats.shape[0]):
        Rc, tc, K = R[c], t[c], Ks[c]
        rad = None if radial_coeffs is None else radial_coeffs[c]
        tang = None if tangential_coeffs is None else tangential_coeffs[c]
        if rs:
            q0 = rotmat_to_quat(Rc)
            q1, t1 = _viewmat_pose(viewmats_rs[c])
            uv, valid_s = world_point_to_image_shutter(
                pts_w, K, (q0, tc), (q1, t1), width, height, rolling_shutter,
                camera_model, rad, tang, ftheta_coeffs,
                margin=ut_params.in_image_margin_factor)            # (N, 7, 2)
            valid = (torch.all(valid_s, dim=-1)
                     if ut_params.require_all_sigma_points_valid
                     else torch.any(valid_s, dim=-1))
            q_mid = _quat_slerp(q0, q1, torch.full((), 0.5, device=means.device))
            t_mid = 0.5 * (tc + t1)
            depth = (_quat_rotate(q_mid, means) + t_mid)[..., 2]
        else:
            pts_c = torch.einsum("ij,nsj->nsi", Rc, pts_w) + tc      # (N, 7, 3)
            uv = camera_project(pts_c, K, camera_model, rad, tang, ftheta=ftheta_coeffs)
            valid = None
            depth = torch.einsum("ij,nj->ni", Rc, means)[..., 2] + tc[2]
        mean2d = torch.einsum("s,nsi->ni", w_m, uv)
        d = uv - mean2d[:, None, :]
        m2d.append(mean2d)
        cov2d.append(torch.einsum("s,nsi,nsj->nij", w_c, d, d))
        dep.append(depth)
        val.append(valid)
    nan = torch.full((), float("nan"), dtype=means.dtype, device=means.device)
    # a splat without a Cholesky factor: NaN, culled by finish_projection
    m2d = torch.where(bad[:, None], nan, torch.stack(m2d))
    cov2d = torch.where(bad[:, None, None], nan, torch.stack(cov2d))
    dep = torch.stack(dep)

    extra = torch.stack(val) if rs else None
    if camera_model == FISHEYE:
        extra = dep > 0 if extra is None else extra & (dep > 0)
    elif camera_model == FTHETA:
        fth = ftheta_coeffs if ftheta_coeffs is not None else FThetaParams()
        means_c = torch.einsum("cij,nj->cni", R, means) + t[:, None, :]
        r_xy = torch.linalg.norm(means_c[..., :2], dim=-1)
        theta = torch.atan2(r_xy, means_c[..., 2])
        cone = (dep > 0) & (theta <= fth.max_angle)
        extra = cone if extra is None else extra & cone
    return finish_projection(m2d, cov2d, dep, width, height, eps2d, near_plane,
                             far_plane, calc_compensations, extra_valid=extra,
                             radius_clip=radius_clip)


# --- inverse models: pixels -> world rays ------------------------------------

def undistort_opencv(xy_d: torch.Tensor, radial: torch.Tensor,
                     tangential: Optional[torch.Tensor] = None,
                     iters: int = 10) -> torch.Tensor:
    """Invert distort_opencv by `iters` fixed-point steps."""
    k = _padded(radial, 6)
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2, scale = _opencv_scale(x, y, k)
        dx = dy = 0.0
        if tangential is not None:
            dx, dy = _opencv_tangential(x, y, r2, tangential)
        xy = torch.stack([(xy_d[..., 0] - dx) / scale, (xy_d[..., 1] - dy) / scale], -1)
    return xy


def _invert_fisheye_theta(rd: torch.Tensor, radial: Optional[torch.Tensor],
                          iters: int = 10) -> torch.Tensor:
    """Solve rd = theta (1 + k1 th^2 + ... + k4 th^8) for theta, `iters`
    Newton steps from theta = rd."""
    if radial is None:
        return rd
    k = _padded(radial, 4)
    theta = rd
    for _ in range(iters):
        th2 = theta * theta
        poly = (1.0 + k[..., 0] * th2 + k[..., 1] * th2 ** 2
                + k[..., 2] * th2 ** 3 + k[..., 3] * th2 ** 4)
        dpoly = (3.0 * k[..., 0] * th2 + 5.0 * k[..., 1] * th2 ** 2
                 + 7.0 * k[..., 2] * th2 ** 3 + 9.0 * k[..., 3] * th2 ** 4)
        f = theta * poly - rd
        df = poly + dpoly
        theta = theta - f / torch.clamp_min(torch.abs(df), 1e-8) * torch.sign(df)
    return theta


def image_point_to_world_ray(
        px_xy: torch.Tensor, viewmat: torch.Tensor, K: torch.Tensor,
        camera_model: str = PINHOLE, radial: Optional[torch.Tensor] = None,
        tangential: Optional[torch.Tensor] = None,
        ftheta: Optional[FThetaParams] = None,
        rolling_shutter: str = SHUTTER_GLOBAL,
        viewmat_rs: Optional[torch.Tensor] = None,
        width: Optional[int] = None, height: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixels (..., 2) of one camera (viewmat (4, 4) world->cam, K (3, 3))
    -> (camera origin, unit world ray directions (..., 3)). Under a rolling
    shutter (`viewmat_rs`, width and height given) each pixel takes the
    pose at its shutter time and the origin is per pixel (..., 3); else it
    is one (3,)."""
    rs = (rolling_shutter != SHUTTER_GLOBAL and viewmat_rs is not None
          and width is not None and height is not None)
    if camera_model == FTHETA:
        # undo the skew A = [[c, d], [e, 1]] with A^-1 = [[1, -d], [-e, c]] /
        # (c - e d), then invert the radial polynomial for theta
        fth = ftheta if ftheta is not None else FThetaParams()
        c, d, e = fth.linear_cde
        ipx = px_xy[..., 0] - (K[0, 2] + 0.5)
        ipy = px_xy[..., 1] - (K[1, 2] + 0.5)
        det = c - e * d
        ux = (ipx - d * ipy) / det
        uy = (-e * ipx + c * ipy) / det
        delta = torch.sqrt(ux * ux + uy * uy)
        if fth.reference_poly == PIXELDIST_TO_ANGLE:
            theta = _horner(fth.pixeldist_to_angle_poly, delta)
        else:
            theta = _newton_invert_poly(fth.angle_to_pixeldist_poly,
                                        fth.pixeldist_to_angle_poly, delta)
        center = delta < 1e-6
        s = torch.where(center, torch.zeros_like(delta),
                        torch.sin(theta) / torch.clamp_min(delta, 1e-6))
        dirs_c = torch.stack([s * ux, s * uy,
                              torch.where(center, torch.ones_like(theta),
                                          torch.cos(theta))], -1)
        return _camera_rays_to_world(dirs_c, px_xy, viewmat, rs, rolling_shutter,
                                     viewmat_rs, width, height)

    xd = (px_xy[..., 0] - K[0, 2]) / K[0, 0]
    yd = (px_xy[..., 1] - K[1, 2]) / K[1, 1]
    xy = torch.stack([xd, yd], -1)
    if camera_model == FISHEYE:
        rd = torch.linalg.norm(xy, dim=-1)
        theta = _invert_fisheye_theta(rd, radial)
        s = torch.where(rd > 1e-8, torch.sin(theta) / torch.clamp_min(rd, 1e-8),
                        torch.ones_like(rd))
        dirs_c = torch.stack([xy[..., 0] * s, xy[..., 1] * s, torch.cos(theta)], -1)
    else:
        if radial is not None or tangential is not None:
            xy = undistort_opencv(xy, radial if radial is not None else xy.new_zeros(1),
                                  tangential)
        dirs_c = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
        dirs_c = dirs_c / torch.linalg.norm(dirs_c, dim=-1, keepdim=True)
    return _camera_rays_to_world(dirs_c, px_xy, viewmat, rs, rolling_shutter,
                                 viewmat_rs, width, height)


def _camera_rays_to_world(dirs_c, px_xy, viewmat, rs, rolling_shutter, viewmat_rs,
                          width, height):
    """Camera-frame unit rays -> (origin, world directions); the pose at
    each pixel's shutter time when `rs`."""
    if not rs:
        R = viewmat[:3, :3]
        t = viewmat[:3, 3]
        return -torch.einsum("ij,i->j", R, t), torch.einsum("ij,...i->...j", R, dirs_c)
    q0, t0 = _viewmat_pose(viewmat)
    q1, t1 = _viewmat_pose(viewmat_rs)
    tr = shutter_relative_time(px_xy, width, height, rolling_shutter)
    q = _quat_slerp(q0, q1, tr)                                   # (..., 4)
    t = (1.0 - tr)[..., None] * t0 + tr[..., None] * t1
    q_inv = _quat_conj(q)
    return -_quat_rotate(q_inv, t), _quat_rotate(q_inv, dirs_c)
