"""Quaternion <-> rotation-matrix conversions (scalar-last XYZW order).

Port of hunyuanworld_mirror_tpu/utils/rotation.py `quat_to_rotmat` (the
camera decoding) and `rotmat_to_quat` (the camera encoders of the pose
prior and the COLMAP export): PyTorch3D's 4-candidate construction, the
real part standardised to be non-negative.
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
