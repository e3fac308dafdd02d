"""Post-inference 3DGS optimisation.

Port of hunyuanworld_mirror_tpu/training/splat_opt.py: initialise from
WorldMirror's splats, optimise against the input views with (1 - l) L1 +
l (1 - SSIM) (plus the optional depth loss, opacity / scale regularisers
and the bilateral grid's total variation), Adam (or selective Adam) per
parameter group, and refine a FIXED-capacity array with an alive mask:
gsplat DefaultStrategy-style grow / prune, or the MCMC strategy
(training/mcmc.py: teleport, 5% growth, position noise after every step).
Optional per-camera pose deltas (AdamW, lr decayed to 1% over the run),
per-view bilateral grids (training/bilagrid.py) and a random background;
TensorBoard events (training/tb_writer.py), in-loop held-out eval
(utils/metrics.py) and live-viewer snapshots (training/live_viewer.py).

The render is ops/rasterizer.rasterize: on the default route
(rasterizer_impl="pallas") kernel K2 forward and K3 backward, on "jax" the
dense-bin route (kernel K4 forward, the plain blend replayed under autograd
backward). With mode="2dgs" it is ops/gs2d.rasterize_2dgs (surfels, plain
PyTorch under autograd, as the JAX package's is plain XLA; only the RGB
channels drive the photometric loss). The raw dict keeps the JAX package's
key names (means, log_scales, quats (wxyz), opacity_logits, sh, alive, and
cam_deltas, bil_grids when on), so a numpy dict moves between the two
packages as it is.
"""

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import gs2d, rasterizer
from ..utils import camera as cam_utils
from ..utils import rotation as rot_utils
from ..utils.metrics import nvs_metrics
from ..utils.profiling import mark
from . import bilagrid, losses, mcmc

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
    # the render's route: "pallas" (flat lists, K2 / K3) or "jax" (dense
    # bins, K4, the plain backward). The JAX dataclass defaults to "jax",
    # its CPU route, and its CLI passes --rasterizer (default "pallas"); the
    # port defaults to the flat route, whose backward is kernel K3.
    rasterizer_impl: str = "pallas"
    # "default" (grad-threshold grow / prune) or "mcmc" (training/mcmc.py)
    strategy: str = "default"
    noise_lr: float = 5e5             # MCMC position-noise scale
    min_opacity: float = 0.005        # MCMC: at or below, a splat is dying
    use_selective_adam: bool = False
    # "3dgs" or "2dgs" (surfels, ops/gs2d.py: RGB+ED and normals; the
    # render ignores rasterizer_impl and takes no absgrad tap)
    mode: str = "3dgs"
    # per-camera 9-dim deltas (3 translation + 6D rotation) on the c2w side,
    # AdamW(pose_opt_lr, decay pose_opt_reg), lr decayed to 1% over iters
    pose_opt: bool = False
    pose_opt_lr: float = 1e-3
    pose_opt_reg: float = 1e-5
    # composite over a U[0, 1)^3 background drawn each step
    random_bkgd: bool = False
    # disparity-space depth L1 against the inference depth maps
    depth_loss: bool = False
    depth_lambda: float = 1e-2
    opacity_reg: float = 0.0
    scale_reg: float = 0.0
    # per-view bilateral grids (x, y, gray cells), Adam(bilgrid_lr, eps
    # 1e-15), + bilgrid_tv_mult x their total variation
    use_bilateral_grid: bool = False
    bilateral_grid_shape: Tuple[int, int, int] = (16, 16, 8)
    bilgrid_lr: float = 2e-3
    bilgrid_tv_mult: float = 10.0
    # TensorBoard (optimize_splats(tb_logdir=...)): scalars every tb_every
    # steps, with tb_save_image view 0 rendered beside its ground truth
    tb_every: int = 100
    tb_save_image: bool = False
    # held-out eval every eval_every steps (optimize_splats(eval_data=...))
    eval_every: int = 0
    # live-viewer snapshots (optimize_splats(viewer=...)); 0 disables
    viewer_every: int = 200
    # densification signal: "absgrad" (per-splat sum of |dL/d means2d| from
    # kernel K3's AbsGS rows, in half-image units as gsplat's grow_grad2d
    # expects), "mean3d" (norm of the world-space mean gradient) or "auto".
    densify_signal: str = "auto"

    def __post_init__(self):
        for name, allowed in (("mode", ("3dgs", "2dgs")),
                              ("strategy", ("default", "mcmc")),
                              ("rasterizer_impl", ("pallas", "jax"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        if self.mode == "2dgs" and self.densify_signal == "absgrad":
            raise ValueError("the 2DGS render has no absgrad tap: use "
                             "densify_signal 'mean3d' or 'auto'")

    def resolved_signal(self, device) -> str:
        """"auto" is absgrad where the backward runs kernel K3 (the 3DGS
        flat route on CUDA) and mean3d elsewhere, as the JAX package maps it
        to absgrad only for its 3DGS Pallas route on a TPU. The two signals
        have different units; grow_grad2d is meant for absgrad."""
        if self.densify_signal != "auto":
            return self.densify_signal
        return ("absgrad" if (self.rasterizer_impl == "pallas" and self.mode == "3dgs"
                              and torch.device(device).type == "cuda")
                else "mean3d")


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
                   scene_scale: float = 1.0) -> torch.optim.Optimizer:
    """The splat rows' optimizer, one parameter group each, means at
    lr_means * scene_scale: Adam (optax.adam's update: m_hat / (sqrt(v_hat)
    + eps), eps 1e-8), or with cfg.use_selective_adam mcmc.SelectiveAdam.
    `alive` is never updated (the JAX package's optax.set_to_zero). Marks
    the params as requiring grad; a new optimizer starts with fresh
    moments, which is what a refine wants (make_aux_optimizers' are kept)."""
    lrs = {"means": cfg.lr_means * scene_scale, "log_scales": cfg.lr_scales,
           "quats": cfg.lr_quats, "opacity_logits": cfg.lr_opacities,
           "sh": cfg.lr_sh}
    groups = []
    for k in PARAM_KEYS:
        raw[k].requires_grad_(True)
        groups.append({"params": [raw[k]], "lr": lrs[k]})
    if cfg.use_selective_adam:
        return mcmc.SelectiveAdam(groups, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def make_aux_optimizers(cfg: SplatOptConfig, raw: Dict) -> List[Tuple]:
    """[(optimizer, scheduler or None)] for the parameters that keep their
    moments across a refine: raw["cam_deltas"] (cfg.pose_opt) under AdamW,
    lr pose_opt_lr * 0.01^(t / iters) at update t counted from 0 (the JAX
    package's optax.adamw over optax.exponential_decay(pose_opt_lr, iters,
    0.01)), and raw["bil_grids"] (cfg.use_bilateral_grid) under Adam with
    eps 1e-15."""
    out = []
    if cfg.pose_opt:
        opt = torch.optim.AdamW([raw["cam_deltas"].requires_grad_(True)],
                                lr=cfg.pose_opt_lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.pose_opt_reg)
        out.append((opt, torch.optim.lr_scheduler.ExponentialLR(
            opt, gamma=0.01 ** (1.0 / cfg.iters))))
    if cfg.use_bilateral_grid:
        out.append((torch.optim.Adam([raw["bil_grids"].requires_grad_(True)],
                                     lr=cfg.bilgrid_lr, eps=1e-15), None))
    return out


def apply_cam_deltas(viewmats: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """(S, 4, 4) w2c adjusted by per-camera 9-dim deltas on the c2w side:
    c2w' = c2w [[rot6d(identity + drot), dx], [0, 1]] (gsplat's
    CameraOptModule)."""
    c2w = cam_utils.se3_inverse(viewmats)
    dx, drot = deltas[:, :3], deltas[:, 3:]
    ident = torch.tensor([1.0, 0, 0, 0, 1.0, 0], dtype=deltas.dtype,
                         device=deltas.device)
    R = rot_utils.rot6d_to_matrix(drot + ident)
    bottom = torch.tensor([[0.0, 0, 0, 1]], dtype=deltas.dtype,
                          device=deltas.device).expand(deltas.shape[0], 1, 4)
    T = torch.cat([torch.cat([R, dx[:, :, None]], dim=-1), bottom], dim=1)
    return cam_utils.se3_inverse(c2w @ T)


def render_splats(raw: Dict, viewmats: torch.Tensor, Ks: torch.Tensor,
                  width: int, height: int, cfg: SplatOptConfig,
                  abs_tap: Optional[torch.Tensor] = None):
    means, quats, scales, opac, sh = _activate(raw)
    if cfg.mode == "2dgs":
        colors, alphas, normals = gs2d.rasterize_2dgs(
            means, quats, scales, opac, sh, viewmats, Ks, width, height,
            tile_size=cfg.tile_size, render_mode="RGB+ED",
            max_per_tile=cfg.max_per_tile, quat_order="wxyz",
            sh_degree=int(round(sh.shape[-2] ** 0.5)) - 1, device=means.device)
        return colors, alphas, {"normals": normals}
    return rasterizer.rasterize(
        means, quats, scales, opac, sh, viewmats, Ks, width, height,
        tile_size=cfg.tile_size, max_per_tile=cfg.max_per_tile,
        quat_order="wxyz", abs_tap=abs_tap, impl=cfg.rasterizer_impl,
        device=means.device)


def make_train_step(cfg: SplatOptConfig, width: int, height: int,
                    scene_scale: float = 1.0, device=None):
    """-> step(raw, opt, viewmats, Ks, gt_images, gt_depths=None,
    marks=None, aux=(), bkgd=None) that renders, backpropagates, zeroes
    the dead rows' grads of the splat rows, steps `opt` and each of
    `aux`'s (optimizer, scheduler) pairs (updating raw's params in place)
    and returns (loss, g2d (N,) densify signal, render meta).

    In order: the pose deltas adjust the viewmats (cfg.pose_opt), the
    render's RGB goes through the bilateral grids (cfg.use_bilateral_grid),
    then over `bkgd` (1, 1, 1, 3) as rgb + bkgd (1 - alpha)
    (cfg.random_bkgd, which needs it), then the losses. `marks` receives
    CUDA events after the render forward, the backward and the optimizer;
    with the bilateral grid the render forward is split by two more,
    "rasterize" (the render) and "bilagrid" (the slice)."""
    use_abs = cfg.resolved_signal(resolve_device(device)) == "absgrad"

    def step(raw, opt, viewmats, Ks, gt_images, gt_depths=None, marks=None,
             aux=(), bkgd=None):
        if cfg.depth_loss and gt_depths is None:
            raise ValueError("cfg.depth_loss needs gt_depths")
        if cfg.random_bkgd and bkgd is None:
            raise ValueError("cfg.random_bkgd needs bkgd (1, 1, 1, 3)")
        dev = raw["means"].device
        tap = (torch.zeros(raw["means"].shape[0], 2, device=dev,
                           requires_grad=True) if use_abs else None)
        r, vm = raw, viewmats
        if cfg.pose_opt:
            vm = apply_cam_deltas(viewmats, raw["cam_deltas"])
            # Dead slots sit at the origin, on the focal plane of a camera
            # there (the inference CLI's first camera), where the projection
            # is 0/0: their zero cotangents times NaN partials would make the
            # cameras' gradient NaN, as they do in the JAX step. Render them
            # at a live splat's mean instead; at opacity 0 they blend
            # nowhere, so the render is unchanged.
            anchor = raw["means"].detach()[torch.argmax(raw["alive"])]
            r = dict(raw, means=torch.where(raw["alive"][:, None] > 0.5,
                                            raw["means"], anchor))
        colors, alphas, meta = render_splats(r, vm, Ks, width, height, cfg,
                                             abs_tap=tap)
        rgb = colors[..., :3]
        if cfg.use_bilateral_grid:
            mark(marks, "rasterize")
            rgb = bilagrid.slice_image_grids(raw["bil_grids"], rgb)
            mark(marks, "bilagrid")
        if cfg.random_bkgd:
            rgb = rgb + bkgd * (1.0 - alphas)
        loss = losses.photometric_loss(rgb, gt_images, cfg.ssim_lambda)
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
        if cfg.use_bilateral_grid:
            loss = loss + cfg.bilgrid_tv_mult * bilagrid.total_variation_loss(
                raw["bil_grids"])
        mark(marks, "render_forward")
        opt.zero_grad(set_to_none=True)
        for o, _ in aux:
            o.zero_grad(set_to_none=True)
        loss.backward()
        mark(marks, "backward")
        # Dead slots sit at the origin where the perspective divide is
        # singular: their grads can be NaN. They are not parameters; zero
        # their rows so the optimizer state stays clean (selective Adam
        # would take a NaN row for a visible one). cam_deltas and bil_grids
        # are left whole.
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
        for o, sched in aux:
            o.step()
            if sched is not None:
                sched.step()
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
    Returns a new raw dict whose splat rows and `alive` do not require
    grad; its other keys are the input's own tensors.
    """
    means, quats, scales, opac, sh = _activate(raw)
    alive = raw["alive"] > 0.5
    N = means.shape[0]
    log16 = math.log(1.6)

    max_scale = torch.amax(scales, dim=-1)
    high_grad = (grad_accum > cfg.grow_grad2d) & alive
    is_split = high_grad & (max_scale > cfg.grow_scale3d)

    keep = alive & (opac > cfg.prune_opacity)
    # every splat row is replaced; cam_deltas and bil_grids pass through
    raw = dict(raw, **{k: raw[k].detach() for k in PARAM_KEYS})
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
    tb_logdir: Optional[str] = None,      # TensorBoard events (tb_writer.py)
    eval_data: Optional[Tuple] = None,    # (images, c2w, Ks) held-out views
    viewer=None,                          # live_viewer.LiveViewer
) -> Dict[str, np.ndarray]:
    """Optimise a splat set against its source views; returns the live
    activated splats as numpy, with "c2w_opt" (S, 4, 4), the cameras after
    the pose deltas, when cfg.pose_opt, and "eval_history" rows of (step,
    PSNR, SSIM) when the in-loop eval ran (every cfg.eval_every steps on
    `eval_data`, views at the training resolution).

    Runs on CUDA unless `device` names another (without a GPU, device=None
    raises). Every random draw (the split jitter, the MCMC sources and
    position noise, the background) comes from one torch.Generator seeded
    with `seed`. `on_step`, if given, is called after every step with a
    dict: it, loss (tensor), meta (render meta), refined (bool), raw, and
    on CUDA marks (events after the step's start, the train step's phases,
    on a refine step "refine", and with the MCMC strategy "noise")."""
    cfg = cfg or SplatOptConfig()
    dev = resolve_device(device)
    S, H, W, _ = images.shape
    n = splats["means"].shape[0]
    capacity = int(n * cfg.capacity_factor)

    raw = _raw_from_splats({k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                               device=dev)
                            for k, v in splats.items()}, capacity)
    if cfg.pose_opt:
        raw["cam_deltas"] = torch.zeros(S, 9, device=dev)
    if cfg.use_bilateral_grid:
        raw["bil_grids"] = bilagrid.init_bilateral_grids(
            S, *cfg.bilateral_grid_shape, device=dev)
    c2w_np = np.asarray(c2w)
    scene_scale = float(np.linalg.norm(
        c2w_np[:, :3, 3] - c2w_np[:, :3, 3].mean(0), axis=-1).max() + 1e-6)

    opt = make_optimizer(cfg, raw, scene_scale)
    aux = make_aux_optimizers(cfg, raw)
    step_fn = make_train_step(cfg, W, H, scene_scale, dev)
    noise_scaler = cfg.lr_means * scene_scale * cfg.noise_lr
    viewmats = cam_utils.se3_inverse(torch.as_tensor(c2w_np, dtype=torch.float32,
                                                     device=dev))
    Ks_t = torch.as_tensor(np.asarray(Ks), dtype=torch.float32, device=dev)
    gt = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=dev)
    gt_depths = (torch.as_tensor(np.asarray(depths), dtype=torch.float32, device=dev)
                 if depths is not None else torch.zeros(S, H, W, device=dev))

    tb = None
    if tb_logdir:
        from .tb_writer import TBWriter
        tb = TBWriter(tb_logdir)
    eval_history = []
    run_eval = eval_data is not None and cfg.eval_every > 0
    if run_eval:
        ev_imgs, ev_c2w, ev_Ks = eval_data
        # the eval renders at the training W, H
        if tuple(np.asarray(ev_imgs).shape[1:3]) != (H, W):
            raise ValueError(
                f"eval_data resolution {tuple(np.asarray(ev_imgs).shape[1:3])} "
                f"!= training ({H}, {W}); resize the held-out views to the "
                "training resolution")
        ev_vm = cam_utils.se3_inverse(torch.as_tensor(
            np.asarray(ev_c2w), dtype=torch.float32, device=dev))
        ev_Ks_t = torch.as_tensor(np.asarray(ev_Ks), dtype=torch.float32, device=dev)
        ev_gt = torch.as_tensor(np.asarray(ev_imgs), dtype=torch.float32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(seed)
    # gsplat DefaultStrategy accumulation: per-splat grad sums averaged over
    # the steps the splat was actually visible
    grad_sum = torch.zeros(capacity, device=dev)
    seen = torch.zeros(capacity, device=dev)
    for it in range(cfg.iters):
        marks = [] if (on_step is not None and dev.type == "cuda") else None
        mark(marks, "start")
        bkgd = (torch.rand((1, 1, 1, 3), generator=gen, device=dev)
                if cfg.random_bkgd else None)
        loss, g2d, meta = step_fn(raw, opt, viewmats, Ks_t, gt, gt_depths, marks,
                                  aux, bkgd)
        grad_sum += g2d
        seen += (g2d > 0).float()
        refined = (cfg.refine_start <= it < cfg.refine_stop
                   and (it + 1) % cfg.refine_every == 0)
        if refined:
            if cfg.strategy == "mcmc":
                raw = mcmc.mcmc_refine(
                    raw, mcmc.sample_sources(raw, cfg.min_opacity, gen),
                    cfg.min_opacity)
            else:
                noise = torch.randn(capacity, 3, generator=gen, device=dev)
                raw = refine(raw, grad_sum / torch.clamp_min(seen, 1.0), cfg, noise)
            # the splat rows' moments restart; the cameras' and grids'
            # optimizers, with the pose lr's schedule, carry on
            opt = make_optimizer(cfg, raw, scene_scale)
            grad_sum.zero_()
            seen.zero_()
            mark(marks, "refine")
        if cfg.strategy == "mcmc":
            mcmc.inject_position_noise(raw, noise_scaler, generator=gen)
            mark(marks, "noise")
        if (it + 1) % 100 == 0:
            log_fn(f"splat-opt iter {it + 1}: loss {float(loss):.4f} "
                   f"alive {int(torch.sum(raw['alive'] > 0.5))}")
        if run_eval and (it + 1) % cfg.eval_every == 0:
            with torch.no_grad():
                img, _, _ = render_splats(raw, ev_vm, ev_Ks_t, W, H, cfg)
            m = nvs_metrics(torch.clamp(img[..., :3], 0, 1), ev_gt)
            eval_history.append((it + 1, m["psnr"], m["ssim"]))
            log_fn(f"splat-opt eval @{it + 1}: PSNR {m['psnr']:.2f} "
                   f"SSIM {m['ssim']:.4f} ({len(ev_gt)} held-out views)")
            if tb is not None:
                tb.scalars({"eval/psnr": m["psnr"], "eval/ssim": m["ssim"]}, it + 1)
                tb.flush()
        if (viewer is not None and cfg.viewer_every > 0
                and ((it + 1) % cfg.viewer_every == 0 or it == cfg.iters - 1)):
            viewer.update(alive_splats(raw), it + 1, float(loss))
        if tb is not None and (it + 1) % max(cfg.tb_every, 1) == 0:
            tb.scalars({"train/loss": float(loss),
                        "train/num_GS": float(torch.sum(raw["alive"] > 0.5))},
                       it + 1)
            if cfg.tb_save_image:
                # view 0 rendered beside its ground truth
                with torch.no_grad():
                    img, _, _ = render_splats(raw, viewmats[:1], Ks_t[:1], W, H, cfg)
                tb.image("train/render_vs_gt", torch.cat(
                    [torch.clamp(img[0, ..., :3], 0, 1), gt[0]], dim=1).cpu().numpy(),
                    it + 1)
            tb.flush()
        if on_step is not None:
            on_step({"it": it, "loss": loss, "meta": meta, "refined": refined,
                     "raw": raw, "marks": marks})
    if tb is not None:
        tb.close()

    out = alive_splats(raw)
    if cfg.pose_opt:
        with torch.no_grad():
            vm_opt = apply_cam_deltas(viewmats, raw["cam_deltas"])
        out["c2w_opt"] = cam_utils.se3_inverse(vm_opt).cpu().numpy()
    if eval_history:
        out["eval_history"] = np.asarray(eval_history, np.float64)
    return out
