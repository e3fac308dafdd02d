"""Pixel-aligned 3D Gaussians: raw head params -> splats -> rendered views.

Port of hunyuanworld_mirror_tpu/models/gaussians.py: the 2-conv gs_head
(per-segment init: quats 0, scales -7, opacity -2, SH 0, weights -2,
offsets 1e-3), activations, means from one of four sources
(`position_from`, by default gs_depth unprojected through the predicted
cameras) plus optional predicted offsets, residual SH over RGB2SH(image),
the confidence filter, voxel weighted merge, static compaction, and one
rasterize per camera (RGB+ED).

Splat dicts keep the JAX package's static shapes: (B, N, ...) with dead
slots (weight 0, opacity 0, parked at 1e12). The voxel merge is plain torch
(`torch.unique` + `index_add_`) instead of the TPU's sorted segmented scan;
it yields the same merged set, in another slot order. Both JAX sorts are
unstable, so splats compare as canonically re-sorted sets.
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..ops import rasterizer
from ..ops.distributed import rasterize_distributed
from ..parallel import comm
from ..utils import camera as cam_utils
from ..utils import geometry, gs_act, profiling
from ..utils import sh as sh_utils
from .nn import Conv2d, uniform_

SPLAT_KEYS = ("means", "quats", "scales", "opacities", "sh", "weights")


@dataclass(frozen=True)
class GSRendererConfig:
    feature_dim: int = 256
    sh_degree: int = 0
    # 3 more raw channels: bounded offsets added to the means
    predict_offset: bool = False
    predict_residual_sh: bool = True
    enable_prune: bool = True
    voxel_size: float = 0.002
    # keep the top (100 - conf_threshold_percent)% of splats by gs_depth_conf
    enable_conf_filter: bool = False
    conf_threshold_percent: float = 30.0
    max_gaussians: int = 5_000_000
    compact_fraction: float = 0.5
    # compaction runs only after a prune or a filter
    enable_compact: bool = True
    # where the means come from: "pts3d" (the point head), or a depth
    # unprojected through cameras: "preddepth+predcamera",
    # "gsdepth+predcamera" or "gsdepth+gtcamera" (views["camera_pose"] and
    # views["camera_intrinsics"])
    position_from: str = "gsdepth+predcamera"
    max_per_tile: int = 4096
    max_tiles_per_gauss: int = 4
    tile_size: int = 16   # 8 or 16 on the card (ops.rasterizer_flat.KERNEL_TILE_SIZES)
    # "pallas": the flat route (kernel K2); "jax": the dense-bin route
    # (kernel K4). The JAX dataclass defaults to "jax", its CPU convenience
    # (its "pallas" falls back to "jax" off the TPU); the port defaults to
    # the flat route, which the CLI selects by default on both packages
    rasterizer_impl: str = "pallas"
    # f16-pair payload on the flat route (an inference speed knob, ~1e-3
    # render delta)
    payload_f16: bool = True
    # coverage-scheduled binning on the flat route: "auto", one fraction a
    # slot plane, or None (exact). An inference-only approximation: the
    # slots a prefix cuts are counted in render_n_dropped
    slot_fracs: Optional[object] = None
    # the exact ellipse-tile test in binning (EXACT semantics, fewer
    # entries); the environment's WM_EXACT_TILE=0 also turns it off
    exact_tile_test: bool = True

    @property
    def nums_sh(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def splits(self):
        return [4, 3, 1, self.nums_sh * 3, 1] + ([3] if self.predict_offset else [])

    @property
    def raw_channels(self) -> int:
        return sum(self.splits)


class GaussianSplatRenderer(nn.Module):
    """gs_head: conv3x3 (f/2 -> f, no bias) + ReLU + conv1x1 (f -> raw)."""

    def __init__(self, cfg: GSRendererConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.feature_dim
        self.gs_head = nn.Sequential(
            Conv2d(f // 2, f, 3, padding=1, bias=False), nn.ReLU(),
            Conv2d(f, cfg.raw_channels, 1))

    def init_own(self, gen):
        # final conv per parameter segment: xavier-uniform with a gain and a
        # constant bias (quats 0, scales -7, opacity -2, SH 0, weights -2,
        # offsets 1e-3)
        conv = self.gs_head[2]
        f = self.cfg.feature_dim
        segments = [(4, 1.0, 0.0), (3, 3e-5, -7.0), (1, 1.0, -2.0),
                    (3 * self.cfg.nums_sh, 1.0, 0.0), (1, 1.0, -2.0)]
        if self.cfg.predict_offset:
            segments.append((3, 0.001, 0.001))
        start = 0
        with torch.no_grad():
            for n_out, gain, bias in segments:
                uniform_(conv.weight[start:start + n_out],
                         gain * (6.0 / (f + n_out)) ** 0.5, gen)
                conv.bias[start:start + n_out] = bias
                start += n_out

    def head(self, feats: torch.Tensor) -> torch.Tensor:
        """(B*S, H, W, f/2) fused features -> (B*S, H, W, raw) NHWC."""
        return self.gs_head(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def prepare_splats(cfg: GSRendererConfig, gs_params: torch.Tensor,
                   images: torch.Tensor, predictions: Dict,
                   views: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Raw head output -> activated splats (B, N = S*H*W, ...), the means
    from `cfg.position_from`: "gsdepth+gtcamera" reads views["camera_pose"]
    (B, S, 4, 4 c2w) and views["camera_intrinsics"] (B, S, 3, 3)."""
    B, S, H, W, _ = images.shape
    N = S * H * W
    parts = torch.split(gs_params.reshape(B, N, -1), cfg.splits, dim=-1)
    quats, scales, opac, res_sh, weights = parts[:5]
    offsets = gs_act.reg_dense_offsets(parts[5]) if cfg.predict_offset else 0.0
    splats = {
        "quats": gs_act.reg_dense_rotation(quats),
        "scales": torch.clamp_max(gs_act.reg_dense_scales(scales), 0.3),
        "opacities": gs_act.reg_dense_opacities(opac[..., 0]),
        "weights": gs_act.reg_dense_weights(weights[..., 0]),
    }
    res_sh = gs_act.reg_dense_sh(res_sh)                      # (B, N, K, 3)
    if cfg.predict_residual_sh:
        dc = sh_utils.rgb_to_sh(images.reshape(B, N, 3))
        if cfg.nums_sh > 1:
            sh = torch.cat([res_sh[..., :1, :] + dc[..., None, :],
                            res_sh[..., 1:, :]], -2)
        else:
            sh = res_sh + dc[..., None, :]
        splats["sh"] = sh
        splats["residual_sh"] = res_sh
    else:
        splats["sh"] = res_sh

    mode = cfg.position_from
    if mode == "pts3d":
        splats["means"] = predictions["pts3d"].reshape(B, N, 3) + offsets
        return splats
    if mode in ("preddepth+predcamera", "gsdepth+predcamera"):
        depth = predictions["depth" if mode.startswith("preddepth") else "gs_depth"]
        ext, intr = cam_utils.vector_to_camera_matrices(
            predictions["camera_params"].reshape(B * S, 9), (H, W))
        c2w = cam_utils.se3_inverse(cam_utils.to_homogeneous(ext))
    elif mode == "gsdepth+gtcamera":
        if views is None or "camera_pose" not in views:
            raise ValueError("position_from='gsdepth+gtcamera' needs "
                             "views['camera_pose'] / ['camera_intrinsics']")
        depth = predictions["gs_depth"]
        c2w = views["camera_pose"].reshape(B * S, 4, 4)
        intr = views["camera_intrinsics"].reshape(B * S, 3, 3)
    else:
        raise ValueError(f"invalid position_from={mode!r}")
    # the cameras pass no gradient to the splats (JAX's stop_gradient)
    pts, _, _ = geometry.depth_to_world_coords_points(
        depth.reshape(B * S, H, W), c2w.detach(), intr.detach())
    splats["means"] = pts.reshape(B, N, 3) + offsets
    return splats


def confidence_filter(cfg: GSRendererConfig, splats: Dict,
                      conf: torch.Tensor) -> Dict:
    """Keep the top (100 - p)% most confident splats (p the config's
    conf_threshold_percent), static shapes kept: the rest get opacity and
    weight 0 and means parked at 1e12, beyond the far plane."""
    B, N = splats["means"].shape[:2]
    c = conf.reshape(B, N)
    c = torch.where(c <= 1e-5, torch.full_like(c, -float("inf")), c)
    keep = int(min(cfg.max_gaussians,
                   max(1, -(-N * (100.0 - cfg.conf_threshold_percent) // 100.0))))
    kth = torch.sort(c, dim=-1).values[:, N - keep]
    alive = c >= kth[:, None]
    out = dict(splats)
    out["opacities"] = torch.where(alive, splats["opacities"], 0.0)
    out["weights"] = torch.where(alive, splats["weights"], 0.0)
    out["means"] = torch.where(alive[..., None], splats["means"], 1e12)
    return out


def voxel_prune(cfg: GSRendererConfig, splats: Dict) -> Dict:
    """Merge splats sharing a voxel (weight-averaged), static shapes kept:
    the merged splats fill the first slots in voxel order, the rest are
    dead (opacity and weight 0, means parked at 1e12, scales 1e-8)."""
    B, N = splats["means"].shape[:2]
    outs = []
    for b in range(B):
        s = {k: splats[k][b] for k in SPLAT_KEYS}
        vox = torch.floor(s["means"] / cfg.voxel_size)
        vox = vox - vox.min(dim=0, keepdim=True).values
        vox = torch.clamp(vox, 0, (1 << 20) - 1).to(torch.int64)
        key = (vox[:, 0] << 40) | (vox[:, 1] << 20) | vox[:, 2]
        _, inv = torch.unique(key, sorted=True, return_inverse=True)
        U = int(inv.max()) + 1
        profiling.count("host_syncs", 3)    # unique, U and the dead quat below
        w = s["weights"]
        sh_flat = s["sh"].reshape(N, -1)
        planes = torch.cat([w[:, None], (w * w)[:, None], w[:, None] * s["means"],
                            w[:, None] * s["scales"], w[:, None] * s["quats"],
                            w[:, None] * sh_flat], dim=1)
        acc = torch.zeros(U, planes.shape[1], dtype=planes.dtype,
                          device=planes.device).index_add_(0, inv, planes)
        wsum = torch.clamp_min(acc[:, 0], 1e-8)
        inv_w = 1.0 / wsum
        alive = acc[:, 0] > 1e-6
        qn = torch.sqrt(torch.clamp_min((acc[:, 8:12] ** 2).sum(-1), 1e-16))
        merged = {
            "means": torch.where(alive[:, None], acc[:, 2:5] * inv_w[:, None], 1e12),
            "scales": torch.where(alive[:, None], acc[:, 5:8] * inv_w[:, None], 1e-8),
            "quats": acc[:, 8:12] / qn[:, None],
            "sh": (acc[:, 12:] * inv_w[:, None]).reshape(U, *s["sh"].shape[1:]),
            "opacities": torch.where(alive, acc[:, 1] * inv_w, 0.0),
            "weights": torch.where(alive, wsum, 0.0),
        }
        with torch.device(planes.device):
            dead = {
                "means": torch.full((N - U, 3), 1e12),
                "scales": torch.full((N - U, 3), 1e-8),
                "quats": torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(N - U, 4),
                "sh": torch.zeros(N - U, *s["sh"].shape[1:]),
                "opacities": torch.zeros(N - U),
                "weights": torch.zeros(N - U),
            }
        outs.append({k: torch.cat([merged[k], dead[k]]) for k in merged})
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def compact_splats(cfg: GSRendererConfig, splats: Dict) -> Dict:
    """Sort live splats first (by merged weight, descending) and truncate to
    the static cap min(max_gaussians, ceil_512(N * compact_fraction))."""
    B, N = splats["means"].shape[:2]
    cap = min(int(cfg.max_gaussians),
              -(-int(N * cfg.compact_fraction) // 512) * 512)
    if cap >= N:
        return {**splats, "n_compact_dropped": torch.zeros(
            B, dtype=torch.int32, device=splats["means"].device)}
    outs = []
    for b in range(B):
        w = splats["weights"][b]
        w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
        order = torch.sort(w, descending=True).indices[:cap]
        outs.append({k: splats[k][b][order] for k in SPLAT_KEYS})
    out = {k: torch.stack([o[k] for o in outs]) for k in SPLAT_KEYS}
    n_live = (splats["weights"] > 0).sum(dim=1)
    out["n_compact_dropped"] = torch.clamp_min(n_live - cap, 0).to(torch.int32)
    return out


# the predictions prepare_splats and confidence_filter read, by position_from
_SPLAT_INPUTS = {"pts3d": ("pts3d",),
                 "preddepth+predcamera": ("depth", "camera_params"),
                 "gsdepth+predcamera": ("gs_depth", "camera_params"),
                 "gsdepth+gtcamera": ("gs_depth",)}


def _all_views(cfg: GSRendererConfig, gs_params, images, predictions, views,
               mesh):
    """A view-sharded render's inputs over all S views (a differentiable
    all_gather over the mesh's view axis): the splats are made, filtered,
    merged and compacted from every view, as JAX's GSPMD program makes them
    from the global arrays, identically on every view rank."""
    group = mesh.group("view")
    B, s_local, H, W, _ = images.shape

    def whole(x):
        return comm.all_gather(x, group, dim=1)

    gs_params = whole(gs_params.reshape(B, s_local, H, W, -1)).reshape(
        -1, H, W, gs_params.shape[-1])
    keys = _SPLAT_INPUTS.get(cfg.position_from, ()) + (
        ("gs_depth_conf",) if cfg.enable_conf_filter else ())
    preds = {k: whole(predictions[k]) for k in keys if k in predictions}
    if views is not None:
        views = {k: whole(views[k]) for k in ("camera_pose", "camera_intrinsics")
                 if k in views}
    return gs_params, whole(images), preds, views


def camera_matrices(camera_params: torch.Tensor, B: int, S: int, H: int, W: int):
    """B x S camera vectors (9 each) -> (world->cam (B, S, 4, 4), K (B, S,
    3, 3)), detached: the render passes the cameras no gradient."""
    ext, intr = cam_utils.vector_to_camera_matrices(
        camera_params.reshape(B * S, 9), (H, W))
    return (cam_utils.to_homogeneous(ext).reshape(B, S, 4, 4).detach(),
            intr.reshape(B, S, 3, 3).detach())


def exact_tile_test(cfg: GSRendererConfig) -> bool:
    """The config's exact ellipse-tile test, unless WM_EXACT_TILE=0."""
    return cfg.exact_tile_test and os.environ.get("WM_EXACT_TILE", "1") == "1"


def rasterize_splats(cfg: GSRendererConfig, splats: Dict, w2c: torch.Tensor,
                     Ks: torch.Tensor, W: int, H: int, device):
    """One batch element's splats (SPLAT_KEYS, each (N, ...), quats wxyz)
    into its cameras (w2c (S, 4, 4), Ks (S, 3, 3)) in RGB+ED, by the
    config's route and caps -> rasterizer.rasterize's (colors, alphas,
    meta)."""
    return rasterizer.rasterize(
        splats["means"], splats["quats"], splats["scales"], splats["opacities"],
        splats["sh"], w2c, Ks, W, H, tile_size=cfg.tile_size,
        max_per_tile=cfg.max_per_tile,
        max_tiles_per_gauss=cfg.max_tiles_per_gauss, quat_order="wxyz",
        payload_f16=cfg.payload_f16, impl=cfg.rasterizer_impl,
        slot_fracs=cfg.slot_fracs, exact_tile_test=exact_tile_test(cfg),
        device=device)


def render(renderer: GaussianSplatRenderer, gs_feats: Optional[torch.Tensor],
           images: torch.Tensor, predictions: Dict, do_render: bool = True,
           views: Optional[Dict] = None,
           gs_params: Optional[torch.Tensor] = None, mesh=None) -> Dict:
    """Head conv -> splats -> confidence filter -> voxel merge ->
    compaction -> per-camera rasterize, each stage as the config asks.
    Takes the fused features (B, S, H, W, f/2), or `gs_params` (B*S, H, W,
    raw) with the head conv already applied (the frame-chunked heads).
    Fills predictions["splats"] and, with `do_render`, rendered_colors /
    rendered_depths / rendered_alphas (and, off the distributed render,
    render_n_dropped / render_n_isects).

    mesh: S is this rank's views (parallel/mesh.py). The splats come from
    all views on every view rank (`_all_views`); where S and the splat
    count split over the view axis (JAX's `use_dist`), each rank renders
    its cameras through ops.distributed.rasterize_distributed with its
    contiguous N/V slice of the splats, else its cameras over all splats."""
    cfg = renderer.cfg
    B, S, H, W, _ = images.shape
    v_size = 1 if mesh is None else mesh.size("view")
    with profiling.span("gs_render.splats"):
        if gs_params is None:
            gs_params = renderer.head(gs_feats.reshape(B * S, H, W, -1))
        if v_size > 1:
            gs_params, all_images, all_preds, views = _all_views(
                cfg, gs_params, images, predictions, views, mesh)
        else:
            all_images, all_preds = images, predictions
        splats = prepare_splats(cfg, gs_params, all_images, all_preds, views)
        if cfg.enable_conf_filter and "gs_depth_conf" in all_preds:
            splats = confidence_filter(cfg, splats, all_preds["gs_depth_conf"])
        if cfg.enable_prune:
            splats = {**splats, **voxel_prune(cfg, {k: splats[k] for k in SPLAT_KEYS})}
        if cfg.enable_compact and (cfg.enable_prune or cfg.enable_conf_filter):
            splats = compact_splats(cfg, {k: splats[k] for k in SPLAT_KEYS})
    predictions["splats"] = splats
    if not do_render:
        return predictions

    w2c, Ks = camera_matrices(predictions["camera_params"], B, S, H, W)
    n_splats = splats["means"].shape[1]
    # JAX's use_dist: S and the splat count split over the axis (the global
    # S here always does: every rank holds S views)
    use_dist = v_size > 1 and n_splats % v_size == 0
    outs, alphas, drops, isects = [], [], [], []
    for b in range(B):
        if use_dist:
            lo = mesh.index("view") * (n_splats // v_size)
            part = {k: splats[k][b][lo:lo + n_splats // v_size] for k in SPLAT_KEYS}
            colors, alpha = rasterize_distributed(
                part["means"], part["quats"][:, [1, 2, 3, 0]], part["scales"],
                part["opacities"], part["sh"], w2c[b], Ks[b], W, H, mesh,
                axis="view", render_mode="RGB+ED", max_per_tile=cfg.max_per_tile,
                max_tiles_per_gauss=cfg.max_tiles_per_gauss,
                impl=cfg.rasterizer_impl, sh_degree=cfg.sh_degree)
            outs.append(colors)
            alphas.append(alpha)
            continue
        colors, alpha, meta = rasterize_splats(
            cfg, {k: splats[k][b] for k in SPLAT_KEYS}, w2c[b], Ks[b], W, H,
            images.device)
        outs.append(colors)
        alphas.append(alpha)
        drops.append(meta["n_dropped"])
        isects.append(meta["n_isects"])
    rendered = torch.stack(outs)
    predictions["rendered_colors"] = rendered[..., :3]
    predictions["rendered_depths"] = rendered[..., 3:]
    predictions["rendered_alphas"] = torch.stack(alphas)
    if drops:
        predictions["render_n_dropped"] = torch.stack(drops)
        predictions["render_n_isects"] = torch.stack(isects)
    return predictions
