"""Quaternion <-> rotation-matrix conversions (scalar-last XYZW order) and
the SO(3) / SE(3) exponential maps.

Port of hunyuanworld_mirror_tpu/utils/rotation.py `quat_to_rotmat` (the
camera decoding), `rotmat_to_quat` (the camera encoders of the pose prior,
the COLMAP export and the video trajectory): PyTorch3D's 4-candidate
construction, the real part standardised to be non-negative; `hat`,
`so3_exp` and `se3_exp`, the twist updates of bundle adjustment; and
`rot6d_to_matrix`, the rotation of the splat trainer's camera deltas.
"""

import torch


def quat_to_rotmat(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) in XYZW order -> rotation matrices (..., 3, 3)."""
    i, j, k, r = torch.unbind(quaternions, dim=-1)
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x == 0."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.sqrt(safe), torch.zeros_like(x))


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Flip the sign so the real (last) component is non-negative."""
    return torch.where(quaternions[..., 3:4] < 0, -quaternions, quaternions)


def rotmat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> XYZW quaternions (..., 4).

    Of the four candidates, each divided by one of (r, i, j, k), the one
    with the largest denominator is kept: argmax, whose ties go to the
    first index as jnp.argmax's do.
    """
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(
        matrix.reshape(matrix.shape[:-2] + (9,)), dim=-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    # candidates in WXYZ order, each scaled by one of (r, i, j, k)
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * torch.clamp_min(q_abs[..., None], 0.1))
    best = torch.argmax(q_abs, dim=-1)
    out = torch.gather(candidates, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]                           # WXYZ
    return standardize_quaternion(out[..., [1, 2, 3, 0]])


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]x of (..., 3) vectors -> (..., 3, 3)."""
    wx, wy, wz = torch.unbind(w, dim=-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _exp_coeffs(w: torch.Tensor, eps: float):
    """theta^2 and the Rodrigues coefficients A = sin t / t, B = (1 - cos
    t) / t^2, C = (1 - A) / t^2, each (..., 1, 1), Taylor-guarded below
    theta^2 = eps (BA's twists start exactly at zero)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    t2s = torch.clamp_min(theta2, eps)
    theta = torch.sqrt(t2s)
    small = theta2 < eps
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / t2s)
    return A, B, C


def so3_exp(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues exponential map (..., 3) -> (..., 3, 3)."""
    A, B, _ = _exp_coeffs(w, eps)
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


def se3_exp(twist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """SE(3) exponential: twist (..., 6) = (omega, upsilon) -> (..., 4, 4)."""
    w, u = twist[..., :3], twist[..., 3:]
    A, B, C = _exp_coeffs(w, eps)
    K = hat(w)
    KK = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = eye + A * K + B * KK
    V = eye + B * K + C * KK
    top = torch.cat([R, V @ u[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation representation (..., 6) -> (..., 3, 3) by Gram-Schmidt
    (Zhou et al.): the first two 3-vectors orthonormalised, the third their
    cross product; the rows are the basis vectors."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp_min(torch.linalg.norm(a1, dim=-1, keepdim=True), 1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp_min(torch.linalg.norm(a2p, dim=-1, keepdim=True), 1e-8)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)
