"""Quaternion -> rotation matrix (scalar-last XYZW order).

Port of hunyuanworld_mirror_tpu/utils/rotation.py `quat_to_rotmat`, the part
the camera decoding uses.
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
