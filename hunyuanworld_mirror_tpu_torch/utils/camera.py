"""Camera 9-vector codec and SE(3) helpers.

Port of hunyuanworld_mirror_tpu/utils/camera.py. The model regresses
[t(3), quat XYZW(4), fov_v, fov_u] per view: the world-to-camera [R|t] plus
vertical/horizontal FOV, principal point at the image center. The encoders
(matrices -> vectors) feed the pose prior; they return f32 as the JAX
package's do.
"""

from typing import Tuple

import torch

from .rotation import quat_to_rotmat, rotmat_to_quat


def camera_params_to_vector(ext: torch.Tensor, intr: torch.Tensor,
                            image_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., 3, 4) extrinsic + (..., 3, 3) intrinsics -> (..., 9) vector."""
    h, w = image_hw
    fov_v = 2.0 * torch.arctan(h * 0.5 / intr[..., 1, 1])
    fov_u = 2.0 * torch.arctan(w * 0.5 / intr[..., 0, 0])
    return torch.cat([ext[..., :3, 3], rotmat_to_quat(ext[..., :3, :3]),
                      fov_v[..., None], fov_u[..., None]], dim=-1).float()


def extrinsics_to_vector(ext: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) extrinsic -> (..., 7) [t, quat XYZW] vector."""
    return torch.cat([ext[..., :3, 3], rotmat_to_quat(ext[..., :3, :3])],
                     dim=-1).float()


def vector_to_extrinsics(cam_vec: torch.Tensor) -> torch.Tensor:
    """(..., 7+) [t, quat] vector -> (..., 3, 4) extrinsic [R|t]."""
    return torch.cat([quat_to_rotmat(cam_vec[..., 3:7]),
                      cam_vec[..., 0:3, None]], dim=-1)


def vector_to_camera_matrices(cam_vec: torch.Tensor, image_hw: Tuple[int, int]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 9) vector -> ((..., 3, 4) extrinsic, (..., 3, 3) intrinsics)."""
    R = quat_to_rotmat(cam_vec[..., 3:7])
    ext = torch.cat([R, cam_vec[..., 0:3, None]], dim=-1)
    h, w = image_hw
    # tan clamp keeps focals finite where a relu'd fov is exactly 0
    fy = h * 0.5 / torch.clamp_min(torch.tan(cam_vec[..., 7] * 0.5), 1e-6)
    fx = w * 0.5 / torch.clamp_min(torch.tan(cam_vec[..., 8] * 0.5), 1e-6)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    intr = torch.stack([
        torch.stack([fx, zeros, torch.full_like(fx, w * 0.5)], -1),
        torch.stack([zeros, fy, torch.full_like(fy, h * 0.5)], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return ext, intr


def to_homogeneous(ext3x4: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with [0, 0, 0, 1] appended."""
    bottom = torch.zeros_like(ext3x4[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([ext3x4, bottom], dim=-2)


def se3_inverse(se3: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched SE(3) matrices (..., 4, 4)."""
    Rt = se3[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, se3[..., :3, 3])
    return to_homogeneous(torch.cat([Rt, t_inv[..., None]], dim=-1))
