"""Evaluation metrics: camera ATE/RPE, point-cloud Accuracy/Completeness, NVS.

Port of hunyuanworld_mirror_tpu/utils/metrics.py. The alignment solves and
the trajectory metrics are host numpy in f64, copied; the nearest-neighbour
reduction of Accuracy/Completeness runs on the device the caller names,
as chunked matmuls (cuBLAS on the card, TF32 off: package
`__init__`); PSNR and SSIM go through the port's training/losses.py and
LPIPS through utils/lpips.py, added exactly where the JAX function adds it.
"""

from typing import Tuple

import numpy as np
import torch

from ..training import losses
from . import lpips as lpips_lib


# ---------------------------------------------------------------------------
# Sim(3) alignment (Umeyama) — host-side numpy: the SVD is 3x3.
# ---------------------------------------------------------------------------

def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True
                      ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares sim(3): returns (s, R, t) with  dst ≈ s·R·src + t.

    Closed-form Umeyama (IEEE TPAMI 13(4), 1991) over (N, 3) correspondences.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.shape[-1] != 3:
        raise ValueError(f"umeyama_alignment: shapes {src.shape} and {dst.shape} "
                         "must be one (N, 3)")
    n = src.shape[0]
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / n
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def apply_sim3(pts: np.ndarray, s: float, R: np.ndarray,
               t: np.ndarray) -> np.ndarray:
    return s * np.asarray(pts) @ np.asarray(R).T + np.asarray(t)


# ---------------------------------------------------------------------------
# Camera trajectory metrics
# ---------------------------------------------------------------------------

def ate_rmse(pred_c2w: np.ndarray, gt_c2w: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error: RMSE of camera centers after optional
    sim(3) alignment (the Re10K/CO3D relpose protocol)."""
    p = np.asarray(pred_c2w)[..., :3, 3].reshape(-1, 3)
    g = np.asarray(gt_c2w)[..., :3, 3].reshape(-1, 3)
    if align and len(p) >= 3:
        s, R, t = umeyama_alignment(p, g)
        p = apply_sim3(p, s, R, t)
    return float(np.sqrt(((p - g) ** 2).sum(-1).mean()))


def rpe(pred_c2w: np.ndarray, gt_c2w: np.ndarray,
        delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over frame pairs (i, i+delta):
    (rotation error deg, translation error)."""
    P = np.asarray(pred_c2w).reshape(-1, 4, 4)
    G = np.asarray(gt_c2w).reshape(-1, 4, 4)
    rot_errs, t_errs = [], []
    for i in range(len(P) - delta):
        dp = np.linalg.inv(P[i]) @ P[i + delta]
        dg = np.linalg.inv(G[i]) @ G[i + delta]
        e = np.linalg.inv(dg) @ dp
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rot_errs.append(np.degrees(np.arccos(cos)))
        t_errs.append(np.linalg.norm(e[:3, 3]))
    return float(np.mean(rot_errs)), float(np.mean(t_errs))


# ---------------------------------------------------------------------------
# Point-cloud Accuracy / Completeness (chamfer split)
# ---------------------------------------------------------------------------

def _nn_dist_chunked(query: torch.Tensor, ref: torch.Tensor,
                     chunk: int = 4096) -> torch.Tensor:
    """For each query point the distance to its nearest ref point, on the
    two tensors' device.

    |q - r|^2 = |q|^2 + |r|^2 - 2 q·r, the JAX function's formula
    (torch.cdist switches algorithms by size and rounds near-coincident
    points otherwise): one (chunk, N) matmul per step, each step's blocks
    freed before the next, so peak memory stays at two chunk x N blocks
    instead of M x N. The squared distances agree with JAX's within a few
    f32 ulps of |q|^2 + |r|^2 (XLA sums the squares with FMAs).
    """
    ref = ref.float()
    query = query.float()
    r2 = (ref ** 2).sum(-1)  # (N,)
    out = []
    for i in range(0, query.shape[0], chunk):
        qc = query[i:i + chunk]
        q2 = (qc ** 2).sum(-1)  # (chunk,)
        cross = qc @ ref.T      # (chunk, N)
        d2 = (q2[:, None] + r2[None, :]).sub_(cross, alpha=2.0)  # 2 q·r is exact
        del cross
        out.append(torch.sqrt(torch.clamp(d2.amin(dim=1), min=0.0)))
        del d2
    return torch.cat(out)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle values of an even count
    ((low + high) * 0.5, JAX's "midpoint"), the middle value of an odd one.
    torch.median returns the lower of the two."""
    s = torch.sort(x).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def accuracy_completeness(pred_pts: np.ndarray, gt_pts: np.ndarray,
                          align: bool = False, max_points: int = 65536,
                          seed: int = 0, statistic: str = "mean",
                          device=None) -> Tuple[float, float]:
    """Point reconstruction metrics (the reference README's protocol):

      Accuracy      = statistic over pred points of distance to nearest GT
      Completeness  = statistic over GT points of distance to nearest pred

    `align=True` Umeyama-aligns pred→GT first using the (assumed pixel-
    aligned, equal-length) correspondence; both clouds are then subsampled to
    `max_points` for the O(M·N) nearest-neighbor reduction, by the JAX
    function's draws (numpy's default_rng(seed), pred first). The
    reduction runs on `device` (the CPU by default).
    """
    pred = np.asarray(pred_pts, np.float32).reshape(-1, 3)
    gt = np.asarray(gt_pts, np.float32).reshape(-1, 3)
    if align and pred.shape == gt.shape:
        s, R, t = umeyama_alignment(pred, gt)
        pred = apply_sim3(pred, s, R, t).astype(np.float32)

    rng = np.random.default_rng(seed)
    if len(pred) > max_points:
        pred = pred[rng.choice(len(pred), max_points, replace=False)]
    if len(gt) > max_points:
        gt = gt[rng.choice(len(gt), max_points, replace=False)]

    stat = {"mean": torch.mean, "median": _median}[statistic]
    p = torch.from_numpy(np.ascontiguousarray(pred)).to(device)
    g = torch.from_numpy(np.ascontiguousarray(gt)).to(device)
    with torch.no_grad():
        acc = float(stat(_nn_dist_chunked(p, g)))
        comp = float(stat(_nn_dist_chunked(g, p)))
    return acc, comp


# ---------------------------------------------------------------------------
# NVS image metrics
# ---------------------------------------------------------------------------

def nvs_metrics(pred, target, lpips_params=None) -> dict:
    """PSNR + SSIM (+ LPIPS) over (..., H, W, 3) images in [0, 1] (numpy
    arrays or tensors; the metrics run on pred's device if it is a tensor).

    LPIPS (utils/lpips.py, the AlexNet metric) is included only when weights
    are supplied, as the JAX function includes it: `lpips_params` (the JAX
    pytree of numpy arrays, or an lpips.LPIPS module) or a converted .npz
    named by $WM_LPIPS_WEIGHTS; without them the key is absent rather than
    an uncalibrated number."""
    p = torch.as_tensor(pred, dtype=torch.float32)
    t = torch.as_tensor(target, dtype=torch.float32, device=p.device)
    if p.dim() == 3:
        p, t = p[None], t[None]
    with torch.no_grad():
        out = {"psnr": float(losses.psnr(p, t)),
               "ssim": float(losses.ssim(p, t).mean())}
        lp = lpips_params if lpips_params is not None else lpips_lib.load_params()
        if lp is not None:
            net = lpips_lib.as_module(lp, p.device)
            out["lpips"] = float(lpips_lib.distance(net, p, t).mean())
    return out
