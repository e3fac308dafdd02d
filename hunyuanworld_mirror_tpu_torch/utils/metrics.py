"""Novel-view image metrics.

Port of `nvs_metrics` of hunyuanworld_mirror_tpu/utils/metrics.py: PSNR and
SSIM through the port's training/losses.py. LPIPS (the JAX package's
utils/lpips.py, an AlexNet with calibrated weights) is not ported: where
the JAX function would add it, this one raises. The rest of the JAX
module (ATE, RPE, accuracy and completeness) is not ported either
(ROADMAP Queue 1 item 10).
"""

import os

import torch

from ..training import losses

LPIPS_ITEM = "ROADMAP Queue 1 item 10 (the trunk backward with utils/lpips.py)"


def nvs_metrics(pred, target, lpips_params=None) -> dict:
    """PSNR and SSIM over (..., H, W, 3) images in [0, 1] (numpy arrays or
    tensors; the metrics run on pred's device if it is a tensor).

    The JAX function adds LPIPS when calibrated weights are given
    (`lpips_params`, or a file named by $WM_LPIPS_WEIGHTS); the port raises
    NotImplementedError then, rather than return a dict without it."""
    path = os.environ.get("WM_LPIPS_WEIGHTS")
    if lpips_params is not None or (path and os.path.exists(path)):
        raise NotImplementedError(f"LPIPS is not ported yet: {LPIPS_ITEM}")
    p = torch.as_tensor(pred, dtype=torch.float32)
    t = torch.as_tensor(target, dtype=torch.float32, device=p.device)
    if p.dim() == 3:
        p, t = p[None], t[None]
    return {"psnr": float(losses.psnr(p, t)),
            "ssim": float(losses.ssim(p, t).mean())}
