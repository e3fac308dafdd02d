"""Post-inference 3DGS optimisation at the default strategy.

Port of hunyuanworld_mirror_tpu/training/splat_opt.py on the path its CLI
runs by default: initialise from WorldMirror's splats, optimise against the
input views with (1 - l) L1 + l (1 - SSIM) (plus the optional depth loss and
opacity / scale regularisers), Adam per parameter group, and gsplat
DefaultStrategy-style grow / prune on a FIXED-capacity array with an alive
mask. The render is ops/rasterizer.rasterize, whose backward is kernel K3.

The raw dict keeps the JAX package's key names (means, log_scales, quats
(wxyz), opacity_logits, sh, alive), so a numpy dict moves between the two
packages as it is. Not ported yet: the MCMC strategy, selective Adam, 2DGS,
pose optimisation, random background, the bilateral grid, TensorBoard,
in-loop eval and the live viewer.
"""

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import rasterizer
from ..utils import camera as cam_utils
from ..utils.profiling import mark
from . import losses

PARAM_KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh")


@dataclass
class SplatOptConfig:
    iters: int = 1000
    ssim_lambda: float = 0.2
    capacity_factor: float = 2.0      # free slots for densification
    refine_every: int = 100
    refine_start: int = 100
    refine_stop: int = 700
    grow_grad2d: float = 0.0002       # gsplat DefaultStrategy threshold
    grow_scale3d: float = 0.01        # split-vs-duplicate scale boundary
    prune_opacity: float = 0.005
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_sh: float = 2.5e-3
    tile_size: int = 16   # 16 on the card (K3 takes 16 x 16 tiles only)
    max_per_tile: int = 4096
    # disparity-space depth L1 against the inference depth maps
    depth_loss: bool = False
    depth_lambda: float = 1e-2
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    # densification signal: "absgrad" (per-splat sum of |dL/d means2d| from
    # kernel K3's AbsGS rows, in half-image units as gsplat's grow_grad2d
    # expects), "mean3d" (norm of the world-space mean gradient) or "auto".
    densify_signal: str = "auto"

    def resolved_signal(self, device) -> str:
        """"auto" is absgrad where the backward runs kernel K3 (CUDA) and
        mean3d on the CPU. The JAX package maps it the same way: absgrad
        only for its Pallas kernel on a TPU, mean3d elsewhere. The two
        signals have different units; grow_grad2d is meant for absgrad."""
        if self.densify_signal != "auto":
            return self.densify_signal
        return "absgrad" if torch.device(device).type == "cuda" else "mean3d"


def _raw_from_splats(splats: Dict[str, torch.Tensor], capacity: int) -> Dict:
    """Activated splats -> raw (pre-activation) optimisation params, padded
    to `capacity` with dead slots (origin, identity quat, opacity 0)."""
    n = splats["means"].shape[0]
    pad = capacity - n

    def padded(x, fill=0.0):
        if not pad:
            return x.clone()
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    op = torch.clamp(splats["opacities"], 1e-5, 1 - 1e-5)
    quats = padded(splats["quats"])
    quats[n:, 0] = 1.0
    return {
        "means": padded(splats["means"]),
        "log_scales": padded(torch.log(torch.clamp_min(splats["scales"], 1e-10)),
                             -10.0),
        "quats": quats,
        "opacity_logits": padded(torch.log(op / (1 - op)), -15.0),
        "sh": padded(splats["sh"]),
        "alive": padded(torch.ones(n, device=op.device)),
    }


def _activate(raw: Dict):
    scales = torch.exp(raw["log_scales"])
    opac = torch.sigmoid(raw["opacity_logits"]) * raw["alive"]
    return raw["means"], raw["quats"], scales, opac, raw["sh"]


def make_optimizer(cfg: SplatOptConfig, raw: Dict,
                   scene_scale: float = 1.0) -> torch.optim.Adam:
    """Adam per parameter group (optax.adam's update: m_hat / (sqrt(v_hat)
    + eps), eps 1e-8), means at lr_means * scene_scale. `alive` is never
    updated (the JAX package's optax.set_to_zero). Marks the params as
    requiring grad; a new optimizer starts with fresh moments."""
    lrs = {"means": cfg.lr_means * scene_scale, "log_scales": cfg.lr_scales,
           "quats": cfg.lr_quats, "opacity_logits": cfg.lr_opacities,
           "sh": cfg.lr_sh}
    groups = []
    for k in PARAM_KEYS:
        raw[k].requires_grad_(True)
        groups.append({"params": [raw[k]], "lr": lrs[k]})
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def render_splats(raw: Dict, viewmats: torch.Tensor, Ks: torch.Tensor,
                  width: int, height: int, cfg: SplatOptConfig,
                  abs_tap: Optional[torch.Tensor] = None):
    means, quats, scales, opac, sh = _activate(raw)
    return rasterizer.rasterize(
        means, quats, scales, opac, sh, viewmats, Ks, width, height,
        tile_size=cfg.tile_size, max_per_tile=cfg.max_per_tile,
        quat_order="wxyz", abs_tap=abs_tap, device=means.device)


def make_train_step(cfg: SplatOptConfig, width: int, height: int,
                    scene_scale: float = 1.0, device=None):
    """-> step(raw, opt, viewmats, Ks, gt_images, gt_depths=None,
    marks=None) that renders, backpropagates, zeroes the dead rows' grads,
    steps `opt` (updating raw's params in place) and returns
    (loss, g2d (N,) densify signal, render meta). `marks` receives CUDA
    events after the render forward, the backward and the optimizer."""
    use_abs = cfg.resolved_signal(resolve_device(device)) == "absgrad"

    def step(raw, opt, viewmats, Ks, gt_images, gt_depths=None, marks=None):
        if cfg.depth_loss and gt_depths is None:
            raise ValueError("cfg.depth_loss needs gt_depths")
        dev = raw["means"].device
        tap = (torch.zeros(raw["means"].shape[0], 2, device=dev,
                           requires_grad=True) if use_abs else None)
        colors, alphas, meta = render_splats(raw, viewmats, Ks, width, height,
                                             cfg, abs_tap=tap)
        loss = losses.photometric_loss(colors[..., :3], gt_images,
                                       cfg.ssim_lambda)
        if cfg.depth_loss:
            d = colors[..., 3]
            valid = (gt_depths > 1e-6) & (d > 1e-6)
            disp = torch.where(d > 1e-6, 1.0 / torch.clamp_min(d, 1e-6), 0.0)
            disp_gt = torch.where(gt_depths > 1e-6,
                                  1.0 / torch.clamp_min(gt_depths, 1e-6), 0.0)
            dl = (torch.sum(torch.abs(disp - disp_gt) * valid)
                  / torch.clamp_min(torch.sum(valid), 1.0)) * scene_scale
            loss = loss + dl * cfg.depth_lambda
        alive_f = raw["alive"]
        n_alive = torch.clamp_min(torch.sum(alive_f), 1.0)
        if cfg.opacity_reg > 0.0:
            loss = loss + cfg.opacity_reg * torch.sum(
                torch.sigmoid(raw["opacity_logits"]) * alive_f) / n_alive
        if cfg.scale_reg > 0.0:
            loss = loss + cfg.scale_reg * torch.sum(
                torch.exp(raw["log_scales"]) * alive_f[:, None]) / (3 * n_alive)
        mark(marks, "render_forward")
        opt.zero_grad(set_to_none=True)
        loss.backward()
        mark(marks, "backward")
        # Dead slots sit at the origin where the perspective divide is
        # singular: their grads can be NaN. They are not parameters; zero
        # their rows so the optimizer state stays clean.
        alive_rows = raw["alive"] > 0.5
        with torch.no_grad():
            for k in PARAM_KEYS:
                p = raw[k]
                keep = alive_rows.view((-1,) + (1,) * (p.dim() - 1))
                p.grad = torch.where(keep, p.grad, torch.zeros_like(p.grad))
            if use_abs:
                # gsplat's units: pixel-space absgrad times half the image size
                half = torch.tensor([width * 0.5, height * 0.5], device=dev)
                g2d = torch.linalg.norm(tap.grad * half, dim=-1)
                g2d = torch.where(alive_rows, g2d, torch.zeros_like(g2d))
            else:
                g2d = torch.linalg.norm(raw["means"].grad, dim=-1)
        opt.step()
        mark(marks, "optimizer")
        return loss.detach(), g2d, meta

    return step


@torch.no_grad()
def refine(raw: Dict, grad_accum: torch.Tensor, cfg: SplatOptConfig,
           noise: torch.Tensor) -> Dict:
    """DefaultStrategy-style grow/prune on the fixed-capacity array; `noise`
    (N, 3) standard normal draws place the split clones (the JAX package
    draws jax.random.normal(key, (N, 3)) here).

    duplicate: high 2D-grad & small scale -> clone into a free slot
    split:     high 2D-grad & large scale -> clone with scales/1.6 + jitter
    prune:     opacity below threshold -> deaden slot
    Returns a new raw dict of tensors that do not require grad.
    """
    means, quats, scales, opac, sh = _activate(raw)
    alive = raw["alive"] > 0.5
    N = means.shape[0]
    log16 = math.log(1.6)

    max_scale = torch.amax(scales, dim=-1)
    high_grad = (grad_accum > cfg.grow_grad2d) & alive
    is_split = high_grad & (max_scale > cfg.grow_scale3d)

    keep = alive & (opac > cfg.prune_opacity)
    raw = {k: v.detach() for k, v in raw.items()}   # every key is replaced
    raw["alive"] = keep.float()

    # free slots (dead) first; candidates by grad, best first. Ties (many
    # dead slots, many -inf scores) keep index order, as jnp.argsort does.
    free_rank = torch.argsort(raw["alive"], stable=True)
    grow_score = torch.where(high_grad & keep, grad_accum,
                             torch.full_like(grad_accum, -math.inf))
    grow_rank = torch.argsort(-grow_score, stable=True)

    n_free = torch.sum(raw["alive"] < 0.5)
    n_grow = torch.sum(torch.isfinite(grow_score) & (grow_score > 0))
    n_clone = torch.minimum(n_free, n_grow)

    slot_idx, src_idx = free_rank, grow_rank
    do = torch.arange(N, device=means.device) < n_clone

    jitter = noise * scales[src_idx] * 0.5
    split_src = is_split[src_idx]
    new_means = means[src_idx] + torch.where(split_src[:, None], jitter, 0.0)
    new_logs = torch.where(split_src[:, None], raw["log_scales"][src_idx] - log16,
                           raw["log_scales"][src_idx])

    def scatter(arr, new_vals):
        d = do.view((-1,) + (1,) * (new_vals.dim() - 1))
        out = arr.clone()
        out[slot_idx] = torch.where(d, new_vals, arr[slot_idx])
        return out

    raw["means"] = scatter(raw["means"], new_means)
    raw["log_scales"] = scatter(raw["log_scales"], new_logs)
    raw["quats"] = scatter(raw["quats"], raw["quats"][src_idx])
    raw["opacity_logits"] = scatter(raw["opacity_logits"],
                                    raw["opacity_logits"][src_idx])
    sh_flat = raw["sh"].reshape(N, -1)
    raw["sh"] = scatter(sh_flat, sh_flat[src_idx]).reshape(raw["sh"].shape)
    raw["alive"] = scatter(raw["alive"], torch.ones_like(raw["alive"]))
    # the split source also shrinks
    raw["log_scales"] = raw["log_scales"] - torch.where(
        is_split, log16, 0.0)[:, None]
    return raw


def alive_splats(raw: Dict) -> Dict[str, np.ndarray]:
    """The live slots' activated splats as numpy."""
    means, quats, scales, opac, sh = _activate(raw)
    alive = (raw["alive"] > 0.5).cpu().numpy()
    return {k: v.detach().float().cpu().numpy()[alive]
            for k, v in (("means", means), ("quats", quats), ("scales", scales),
                         ("opacities", opac), ("sh", sh))}


def optimize_splats(
    splats: Dict[str, np.ndarray],      # activated splats, quats wxyz
    images: np.ndarray,                 # (S, H, W, 3) gt views
    c2w: np.ndarray,                    # (S, 4, 4)
    Ks: np.ndarray,                     # (S, 3, 3)
    cfg: Optional[SplatOptConfig] = None,
    seed: int = 0,
    log_fn=print,
    depths: Optional[np.ndarray] = None,  # (S, H, W) for cfg.depth_loss
    device=None,
    on_step: Optional[Callable[[Dict], None]] = None,
) -> Dict[str, np.ndarray]:
    """Optimise a splat set against its source views; returns the live
    activated splats as numpy.

    Runs on CUDA unless `device` names another (without a GPU, device=None
    raises). The split jitter is drawn from a torch.Generator seeded with
    `seed`. `on_step`, if given, is called after every step with a dict:
    it, loss (tensor), meta (render meta), refined (bool), raw, and on CUDA
    marks (events after the step's start, render forward, backward,
    optimizer and, on a refine step, refine)."""
    cfg = cfg or SplatOptConfig()
    dev = resolve_device(device)
    S, H, W, _ = images.shape
    n = splats["means"].shape[0]
    capacity = int(n * cfg.capacity_factor)

    raw = _raw_from_splats({k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                               device=dev)
                            for k, v in splats.items()}, capacity)
    c2w_np = np.asarray(c2w)
    scene_scale = float(np.linalg.norm(
        c2w_np[:, :3, 3] - c2w_np[:, :3, 3].mean(0), axis=-1).max() + 1e-6)

    opt = make_optimizer(cfg, raw, scene_scale)
    step_fn = make_train_step(cfg, W, H, scene_scale, dev)
    viewmats = cam_utils.se3_inverse(torch.as_tensor(c2w_np, dtype=torch.float32,
                                                     device=dev))
    Ks_t = torch.as_tensor(np.asarray(Ks), dtype=torch.float32, device=dev)
    gt = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=dev)
    gt_depths = (torch.as_tensor(np.asarray(depths), dtype=torch.float32, device=dev)
                 if depths is not None else torch.zeros(S, H, W, device=dev))

    gen = torch.Generator(device=dev).manual_seed(seed)
    # gsplat DefaultStrategy accumulation: per-splat grad sums averaged over
    # the steps the splat was actually visible
    grad_sum = torch.zeros(capacity, device=dev)
    seen = torch.zeros(capacity, device=dev)
    for it in range(cfg.iters):
        marks = [] if (on_step is not None and dev.type == "cuda") else None
        mark(marks, "start")
        loss, g2d, meta = step_fn(raw, opt, viewmats, Ks_t, gt, gt_depths, marks)
        grad_sum += g2d
        seen += (g2d > 0).float()
        refined = (cfg.refine_start <= it < cfg.refine_stop
                   and (it + 1) % cfg.refine_every == 0)
        if refined:
            noise = torch.randn(capacity, 3, generator=gen, device=dev)
            raw = refine(raw, grad_sum / torch.clamp_min(seen, 1.0), cfg, noise)
            opt = make_optimizer(cfg, raw, scene_scale)  # reset the moments
            grad_sum.zero_()
            seen.zero_()
            mark(marks, "refine")
        if (it + 1) % 100 == 0:
            log_fn(f"splat-opt iter {it + 1}: loss {float(loss):.4f} "
                   f"alive {int(torch.sum(raw['alive'] > 0.5))}")
        if on_step is not None:
            on_step({"it": it, "loss": loss, "meta": meta, "refined": refined,
                     "raw": raw, "marks": marks})
    return alive_splats(raw)
