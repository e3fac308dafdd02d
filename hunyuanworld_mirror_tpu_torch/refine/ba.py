"""Levenberg-Marquardt bundle adjustment with Schur-complement reduction.

Port of hunyuanworld_mirror_tpu/refine/ba.py. With a mesh the landmarks are
sharded over its view axis: each rank builds its landmarks' part of the
reduced camera system and of the cost, the parts are summed by an
all_reduce every iteration (JAX's four psums and the cost's), and every
rank solves the same camera system.

Problem: minimize sum_{j,s} w_js || pi(K_s, T_s, X_j) - uv_js ||^2 over the
world->camera poses T_s (SE(3), left-multiplied twist updates; camera 0
fixed as the gauge) and the landmarks X_j, the intrinsics fixed. The
Gauss-Newton Hessian is arrow-shaped: camera blocks B (S, 6, 6), landmark
blocks C (M, 3, 3), coupling E (M, S, 6, 3). The landmarks are eliminated
by the Schur complement S_red = B - E C^-1 E^T, a dense (6S, 6S) system,
then back-substituted. Every step is batched einsum in f32 (TF32 is off for
the package). The LM loop keeps its accept / reject decisions and its
damping on the device (torch.where), as the JAX scan does: no host sync per
iteration.

Observations come from `build_tracks`: stride-sampled pixels become
landmarks, re-observed in the other views by reprojection and the depth
consistency gate of utils/frustum.py.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..parallel import comm
from ..parallel.sharding import axis_part
from ..utils.camera import se3_inverse
from ..utils.frustum import bilinear_sample
from ..utils.rotation import hat, se3_exp


class Tracks(NamedTuple):
    points: torch.Tensor   # (M, 3) landmark initializations (world)
    uv: torch.Tensor       # (M, S, 2) pixel observations
    mask: torch.Tensor     # (M, S) bool: observation present
    weight: torch.Tensor   # (M, S) confidence weights


def _project(points: torch.Tensor, w2c: torch.Tensor, K: torch.Tensor):
    """points (M, 3), w2c (S, 4, 4), K (S, 3, 3) -> uv (M, S, 2), z (M, S),
    Xc (M, S, 3)."""
    Xc = torch.einsum("sij,mj->msi", w2c[:, :3, :3], points) + w2c[None, :, :3, 3]
    z = Xc[..., 2]
    zs = torch.clamp_min(z, 1e-6)
    fx, fy = K[:, 0, 0], K[:, 1, 1]
    cx, cy = K[:, 0, 2], K[:, 1, 2]
    u = fx[None] * Xc[..., 0] / zs + cx[None]
    v = fy[None] * Xc[..., 1] / zs + cy[None]
    return torch.stack([u, v], -1), z, Xc


def _weights(tracks: Tracks, z: torch.Tensor) -> torch.Tensor:
    return tracks.weight * tracks.mask * (z > 1e-6)


def reprojection_cost(points, w2c, K, tracks: Tracks) -> torch.Tensor:
    uv, z, _ = _project(points, w2c, K)
    r = uv - tracks.uv
    return torch.sum(_weights(tracks, z) * torch.sum(r * r, -1))


def _gn_system(points, w2c, K, tracks: Tracks):
    """Residuals and Jacobians, batched over (M, S) -> (r (M, S, 2), Jc
    (M, S, 2, 6), Jp (M, S, 2, 3), w (M, S)). Twist convention: T <-
    exp([omega, upsilon]) T, so dXc/domega = -[Xc]x, dXc/dupsilon = I."""
    uv, z, Xc = _project(points, w2c, K)
    w = _weights(tracks, z).to(points.dtype)
    r = uv - tracks.uv
    zs = torch.clamp_min(z, 1e-6)
    fx, fy = K[:, 0, 0][None], K[:, 1, 1][None]                 # (1, S)
    zero = torch.zeros_like(zs)
    dpi = torch.stack([                                          # (M, S, 2, 3)
        torch.stack([fx / zs, zero, -fx * Xc[..., 0] / zs ** 2], -1),
        torch.stack([zero, fy / zs, -fy * Xc[..., 1] / zs ** 2], -1),
    ], -2)
    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(
        Xc.shape + (3,))
    dXc = torch.cat([-hat(Xc), eye], -1)                         # (M, S, 3, 6)
    Jc = torch.einsum("msai,msij->msaj", dpi, dXc)
    Jp = torch.einsum("msai,sij->msaj", dpi, w2c[:, :3, :3])
    return r, Jc, Jp, w


def _schur_step(points, w2c, K, tracks: Tracks, lam, fix_first: bool = True,
                group=None):
    """One damped Gauss-Newton step through the Schur complement -> (new
    w2c, new points). fix_first pins camera 0, the world anchor: without
    its 6 dof most of the gauge null space leaves the f32 solve. `group`:
    the ranks holding the other landmarks, over which the camera system's
    parts are summed."""
    S = tracks.mask.shape[1]
    r, Jc, Jp, w = _gn_system(points, w2c, K, tracks)
    wJc = w[..., None, None] * Jc
    wJp = w[..., None, None] * Jp
    B = torch.einsum("msai,msaj->sij", wJc, Jc)       # (S, 6, 6)
    b = -torch.einsum("msai,msa->si", wJc, r)         # (S, 6)
    C = torch.einsum("msai,msaj->mij", wJp, Jp)       # (M, 3, 3)
    c = -torch.einsum("msai,msa->mi", wJp, r)         # (M, 3)
    E = torch.einsum("msai,msaj->msij", wJc, Jp)      # (M, S, 6, 3)

    # additive LM damping (a multiplicative diagonal is less stable where a
    # landmark row is nearly unobserved)
    eye3 = torch.eye(3, dtype=points.dtype, device=points.device)
    Cinv = torch.linalg.inv(C + lam * eye3)
    ECE = torch.einsum("msij,mjk,mtlk->sitl", E, Cinv, E)    # (S, 6, S, 6)
    ECc = torch.einsum("msij,mjk,mk->si", E, Cinv, c)        # (S, 6)
    B, b, ECE, ECc = (comm.all_reduce(x, group) for x in (B, b, ECE, ECc))

    A4 = torch.block_diag(*B).reshape(S, 6, S, 6) - ECE
    rhs2 = b - ECc
    if fix_first:
        A4, rhs2 = A4[1:, :, 1:, :], rhs2[1:]
    s_eff = A4.shape[0]
    n = s_eff * 6
    A = A4.reshape(n, n) + lam * torch.eye(n, dtype=points.dtype,
                                           device=points.device)
    d_cam = torch.linalg.solve(A, rhs2.reshape(n)).reshape(s_eff, 6)
    if fix_first:
        d_cam = torch.cat([d_cam.new_zeros(1, 6), d_cam], 0)

    # back-substitute the landmarks: d_p = Cinv (c - E^T d_cam)
    Etd = torch.einsum("msij,si->mj", E, d_cam)
    d_p = torch.einsum("mjk,mk->mj", Cinv, c - Etd)
    return se3_exp(d_cam) @ w2c, points + d_p


def bundle_adjust(w2c: torch.Tensor, K: torch.Tensor, tracks: Tracks,
                  iters: int = 12, init_lambda: float = 1e-3, mesh=None,
                  point_axis: str = "view"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM bundle adjustment of w2c (S, 4, 4) world->camera poses with fixed
    intrinsics K (S, 3, 3) -> (w2c', points', cost0, cost). A step is kept
    where it lowers the cost (the damping then halves), else dropped (the
    damping grows 4x), both decided on the device.

    mesh: the landmarks (M of them, a multiple of the `point_axis` size)
    are sharded over that axis, each rank taking its contiguous M / V; the
    camera system and the cost are summed over the axis every iteration.
    Every rank passes the same tracks and gets the same poses and all M
    points back."""
    group = None if mesh is None else mesh.group(point_axis)
    if group is not None:
        tracks = Tracks(*(axis_part(t, mesh, point_axis, 0) for t in tracks))

    def cost_of(pts, poses):
        return comm.all_reduce(reprojection_cost(pts, poses, K, tracks), group)

    cost0 = cost_of(tracks.points, w2c)
    poses, pts, cost = w2c, tracks.points, cost0
    lam = torch.tensor(init_lambda, dtype=tracks.points.dtype,
                       device=tracks.points.device)
    for _ in range(iters):
        new_poses, new_pts = _schur_step(pts, poses, K, tracks, lam, group=group)
        new_cost = cost_of(new_pts, new_poses)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        pts = torch.where(accept, new_pts, pts)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    if group is not None:
        pts = comm.gather_raw(pts, group, 0)
    return poses, pts, cost0, cost


def build_tracks(pts3d: torch.Tensor, conf: torch.Tensor, depth: torch.Tensor,
                 w2c: torch.Tensor, K: torch.Tensor, stride: int = 16,
                 depth_tol: float = 0.05, pad_to: Optional[int] = None) -> Tracks:
    """Data association from the feed-forward predictions of one scene:
    pts3d (S, H, W, 3) world point maps, conf (S, H, W), depth (S, H, W),
    w2c (S, 4, 4), K (S, 3, 3).

    Every `stride`-th pixel of every view becomes a landmark (M = S
    ceil(H / stride) ceil(W / stride)). View t observes it where its
    reprojection lands in bounds, in front, and view t's own depth map
    agrees within `depth_tol` (relative); the source view always observes
    its own. The observation is the reprojection under the initial cameras;
    the landmark starts at the mean of the agreeing views' unprojections, so
    the bundle is inconsistent exactly where the views' geometry disagrees.
    Landmarks seen once are masked out (they constrain nothing). `pad_to`
    truncates the landmarks, or pads them with unobserved zero rows, to that
    count (sharding needs a multiple of the axis size)."""
    S, H, W, _ = pts3d.shape
    dev = pts3d.device
    ys = torch.arange(0, H, stride, device=dev)
    xs = torch.arange(0, W, stride, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gy, gx = gy.reshape(-1), gx.reshape(-1)
    m_per = gy.shape[0]

    X = pts3d[:, gy, gx].reshape(S * m_per, 3)
    w_src = conf[:, gy, gx].reshape(S * m_per)
    src_view = torch.arange(S, device=dev).repeat_interleave(m_per)

    uv, z, _ = _project(X, w2c, K)                               # (M, S, 2)
    u, v = uv[..., 0], uv[..., 1]
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 1e-6)
    d_at = torch.stack([bilinear_sample(depth[s][..., None], uv[:, s])[..., 0]
                        for s in range(S)], dim=1)               # (M, S)
    agree = torch.abs(d_at - z) < depth_tol * torch.clamp_min(z, 1e-6)
    own = torch.nn.functional.one_hot(src_view, S).bool()
    mask = (inb & agree) | own

    # consensus over the agreeing views: each puts the landmark at its own
    # depth along the same ray, unprojected back to the world
    uvh = torch.stack([u, v, torch.ones_like(u)], -1)            # (M, S, 3)
    rays_c = torch.einsum("sij,msj->msi", torch.linalg.inv(K), uvh)
    Yc = rays_c * d_at[..., None]
    Rt = w2c[:, :3, :3].transpose(-1, -2)
    Yw = torch.einsum("sij,msj->msi", Rt, Yc - w2c[None, :, :3, 3])
    mw = mask[..., None].to(X.dtype)
    consensus = (Yw * mw).sum(1) / torch.clamp_min(mw.sum(1), 1e-6)

    keep = mask.sum(-1) >= 2
    X = torch.where(keep[:, None], consensus, X)
    weight = mask * w_src[:, None] * keep[:, None]
    tracks = Tracks(points=X, uv=uv, mask=mask & keep[:, None],
                    weight=weight.float())
    if pad_to is None:
        return tracks
    pad = pad_to - X.shape[0]
    if pad <= 0:
        return Tracks(*(t[:pad_to] for t in tracks))
    return Tracks(*(torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) for t in tracks))


def refine_cameras(predictions: Dict[str, torch.Tensor], stride: int = 16,
                   iters: int = 12, mesh=None) -> Dict[str, torch.Tensor]:
    """BA-refine batch element 0 of a prediction dict (pts3d, pts3d_conf,
    depth, camera_poses c2w, camera_intrs; all views, as
    parallel.sharding.gather_predictions gives them) -> a copy with
    camera_poses replaced by the refined poses and the costs before and
    after under 'ba_cost0' and 'ba_cost'. mesh: the landmarks are sharded
    over its view axis (padded to a multiple of its size)."""
    pts3d = predictions["pts3d"][0].float()
    conf = predictions["pts3d_conf"][0].float()
    depth = predictions["depth"][0, ..., 0].float()
    K = predictions["camera_intrs"][0].float()
    w2c = se3_inverse(predictions["camera_poses"][0].float())
    pad_to = None
    if mesh is not None:
        ax = mesh.size("view")
        S, H, W, _ = pts3d.shape
        m = S * ((H + stride - 1) // stride) * ((W + stride - 1) // stride)
        pad_to = -(-m // ax) * ax
    tracks = build_tracks(pts3d, conf, depth, w2c, K, stride=stride, pad_to=pad_to)
    w2c_ref, _, cost0, cost = bundle_adjust(w2c, K, tracks, iters=iters, mesh=mesh)
    out = dict(predictions)
    out["camera_poses"] = se3_inverse(w2c_ref)[None]
    out["ba_cost0"] = cost0
    out["ba_cost"] = cost
    return out
