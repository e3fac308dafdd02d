"""Plain PyTorch splat refinement: the first steps of a 3DGS optimisation.

Written from 3D Gaussian Splatting (Kerbl et al. 2023) and gsplat's
simple trainer as hunyuanworld_mirror_tpu_torch/training/splat_opt.py and
training/losses.py state it at commit
e2e15df8eb5b1f9149d8000ecb6c575b37fbec06: raw parameters means,
log_scales, quats (wxyz), opacity_logits (opacities clamped to [1e-5,
1 - 1e-5] first) and SH; the render of every camera (reference/render.py,
f32 rows); the loss (1 - l) L1 + l (1 - SSIM) with an 11-tap Gaussian
window (sigma 1.5, zero padding), means over all pixels; Adam per
parameter group (betas 0.9, 0.999, eps 1e-8; the means' rate times the
scene scale). Autograd differentiates the plain render, one camera at a
time against the loss's gradient of the whole image set, so one camera's
graph is held at once. No module of the program is imported.
"""

from typing import Dict, List

import torch
import torch.nn.functional as F

from .precision import REFERENCE, Precision
from .render import render_camera

KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def raw_from_splats(s: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    op = torch.clamp(s["opacities"], 1e-5, 1 - 1e-5)
    return {"means": s["means"].clone(), "log_scales": torch.log(torch.clamp_min(s["scales"], 1e-10)),
            "quats": s["quats"].clone(), "opacity_logits": torch.log(op / (1 - op)),
            "sh": s["sh"].clone()}


def activate(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"means": raw["means"], "quats": raw["quats"], "scales": torch.exp(raw["log_scales"]),
            "opacities": torch.sigmoid(raw["opacity_logits"]), "sh": raw["sh"]}


def ssim(a, b, rnd=lambda x: x):
    """Mean SSIM of (V, H, W, C) images: 11-tap Gaussian (sigma 1.5) as two
    depthwise convolutions with zero padding, c1 = 0.01^2, c2 = 0.03^2."""
    C = a.shape[-1]
    x = torch.arange(11, dtype=torch.float32, device=a.device) - 5.0
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    g = g / g.sum()
    ky, kx = g.view(1, 1, 11, 1).repeat(C, 1, 1, 1), g.view(1, 1, 1, 11).repeat(C, 1, 1, 1)

    def blur(t):
        t = t.permute(0, 3, 1, 2)
        t = F.conv2d(rnd(t), rnd(ky), padding=(5, 0), groups=C)
        return F.conv2d(rnd(t), rnd(kx), padding=(0, 5), groups=C).permute(0, 2, 3, 1)

    mu_a, mu_b = blur(a), blur(b)
    var_a, var_b = blur(a * a) - mu_a ** 2, blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean()


def photometric(pred, gt, lam, rnd=lambda x: x):
    return (1 - lam) * (pred - gt).abs().mean() + lam * (1 - ssim(pred, gt, rnd))


def loss_and_grads(raw, w2c, K, gt, rcfg, lam, prec: Precision = REFERENCE):
    """(loss, {key: gradient}) of one step's render of every camera."""
    V, H, W, _ = gt.shape
    with torch.no_grad():
        s = activate(raw)
        rgb = torch.stack([render_camera(s, w2c[c], K[c], W, H, rcfg, prec.render)[0][..., :3]
                           for c in range(V)])
    rgb.requires_grad_(True)
    loss = photometric(rgb, gt, lam, prec.heads)
    (g_rgb,) = torch.autograd.grad(loss, rgb)
    leaves = {k: raw[k].detach().requires_grad_(True) for k in KEYS}
    for c in range(V):
        img = render_camera(activate(leaves), w2c[c], K[c], W, H, rcfg, prec.render)[0]
        (img[..., :3] * g_rgb[c]).sum().backward()
        del img
    return float(loss.detach()), {k: leaves[k].grad for k in KEYS}


def adam(raw, grads, state, lrs, t, betas=(0.9, 0.999), eps=1e-8):
    b1, b2 = betas
    with torch.no_grad():
        for k in KEYS:
            m, v = state.setdefault(k, (torch.zeros_like(raw[k]), torch.zeros_like(raw[k])))
            m.mul_(b1).add_(grads[k], alpha=1 - b1)
            v.mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
            m_hat = m / (1 - b1 ** t)
            v_hat = v / (1 - b2 ** t)
            raw[k] = raw[k] - lrs[k] * m_hat / (v_hat.sqrt() + eps)


def follow(splats, w2c, K, gt, rcfg, lam, lrs, steps: int = 3,
           prec: Precision = REFERENCE) -> Dict:
    """The first `steps` steps from `splats` (live ones): each step's loss,
    the first step's gradients, and the parameters' change over all."""
    raw = raw_from_splats(splats)
    start = {k: v.clone() for k, v in raw.items()}
    state: Dict = {}
    losses: List[float] = []
    grad1 = None
    for t in range(1, steps + 1):
        loss, grads = loss_and_grads(raw, w2c, K, gt, rcfg, lam, prec)
        losses.append(loss)
        if grad1 is None:
            grad1 = grads
        adam(raw, grads, state, lrs, t)
    return {"losses": losses, "grad1": grad1,
            "delta": {k: raw[k] - start[k] for k in KEYS}}
