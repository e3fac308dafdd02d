"""WorldMirror top-level assembly: trunk + prediction heads.

Port of hunyuanworld_mirror_tpu/models/worldmirror.py: the aggregator,
optionally prompted with priors (camera poses, depth maps, intrinsics:
`extract_priors`), feeds the camera head, the depth / points / normals DPT
heads and the Gaussian head, whose splats are rendered back into the input
views; each head is switched by `enable_*` and absent when off. bf16 trunk,
f32 heads (or bf16, `head_dtype`) and render; the heads optionally run in
frame chunks (`head_chunk`). Submodule names are the reference
torch state-dict prefixes (`visual_geometry_transformer`, `cam_head`,
`pts_head`, `depth_head`, `norm_head`, `gs_head`, `gs_renderer`), so the
public release's state dict loads directly.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..parallel import comm
from ..parallel.sharding import axis_part
from ..utils import camera as cam_utils
from ..utils import priors as prior_utils
from ..utils import profiling
from . import gaussians
from .aggregator import VGTConfig, VisualGeometryTransformer
from .camera_head import CameraHead, CameraHeadConfig
from .dpt import DPTConfig, DPTHead
from .nn import init_weights


@dataclass(frozen=True)
class WorldMirrorConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    gs_dim: int = 256
    enable_cond: bool = True
    enable_cam: bool = True
    enable_pts: bool = True
    enable_depth: bool = True
    enable_norm: bool = True
    enable_gs: bool = True
    patch_embed: str = "dinov2_vitl14_reg"
    sh_degree: int = 0
    voxel_size: float = 0.002
    trunk_depth: int = 24
    trunk_heads: int = 16
    intermediate_idxs: Tuple[int, ...] = (4, 11, 17, 23)
    # the render's route (gaussians.GSRendererConfig.rasterizer_impl):
    # "pallas" the flat K2 route, "jax" the dense-bin K4 route. The JAX
    # dataclass defaults to "jax" because its "pallas" falls back to "jax"
    # off the TPU; the port's default is the route the CLI selects
    rasterizer_impl: str = "pallas"
    # coverage-scheduled binning, an inference-only approximation
    # (gaussians.GSRendererConfig.slot_fracs); None bins exactly
    gs_slot_fracs: Optional[object] = None
    # splat-mean source (gaussians.GSRendererConfig.position_from)
    gs_position_from: str = "gsdepth+predcamera"
    # post-prune static compaction; False keeps every voxel-merged splat
    gs_compact: bool = True
    # DPT decoder compute dtype: "float32" as the reference's heads, or
    # "bfloat16"; the final activations are f32 either way
    head_dtype: str = "float32"
    # run the DPT heads over groups of this many frames (S a multiple of
    # it, S > head_chunk), the gs-param conv inside each group: peak head
    # memory O(head_chunk) instead of O(S). None: one batched call
    head_chunk: Optional[int] = None
    # DPT decoder width overrides (None = features 256, out_channels
    # (256, 512, 1024, 1024)); the small golden fixture shrinks them
    dpt_features: Optional[int] = None
    dpt_out_channels: Optional[Tuple[int, ...]] = None
    # the JAX package's one vmapped decode of the points and normals
    # heads; accepted for its configs, the port decodes the two in turn
    # (the same values)
    fuse_parallel_heads: bool = False

    @property
    def vgt(self) -> VGTConfig:
        return VGTConfig(img_size=self.img_size, patch_size=self.patch_size,
                         embed_dim=self.embed_dim, patch_embed=self.patch_embed,
                         enable_cond=self.enable_cond, depth=self.trunk_depth,
                         num_heads=self.trunk_heads,
                         intermediate_idxs=tuple(self.intermediate_idxs))

    @property
    def cam_head(self) -> CameraHeadConfig:
        return CameraHeadConfig(dim_in=2 * self.embed_dim)

    def _dpt(self, output_dim: int, activation: str, **kw) -> DPTConfig:
        if self.dpt_features is not None:
            kw.setdefault("features", self.dpt_features)
        if self.dpt_out_channels is not None:
            kw.setdefault("out_channels", tuple(self.dpt_out_channels))
        return DPTConfig(dim_in=2 * self.embed_dim, patch_size=self.patch_size,
                         output_dim=output_dim, activation=activation,
                         compute_dtype=self.head_dtype, **kw)

    @property
    def pts_head(self) -> DPTConfig:
        return self._dpt(4, "inv_log+expp1")

    @property
    def depth_head(self) -> DPTConfig:
        return self._dpt(2, "exp+expp1")

    @property
    def norm_head(self) -> DPTConfig:
        return self._dpt(4, "norm+expp1")

    @property
    def gs_head(self) -> DPTConfig:
        return self._dpt(2, "exp+expp1", features=self.gs_dim, is_gsdpt=True)

    @property
    def gs_renderer(self) -> gaussians.GSRendererConfig:
        return gaussians.GSRendererConfig(
            feature_dim=self.gs_dim, sh_degree=self.sh_degree,
            voxel_size=self.voxel_size, position_from=self.gs_position_from,
            enable_compact=self.gs_compact, rasterizer_impl=self.rasterizer_impl,
            slot_fracs=self.gs_slot_fracs)


def frame_chunks(cfg: WorldMirrorConfig, S: int) -> Optional[int]:
    """The heads' frame-group size for S views, or None to run unchunked."""
    ck = cfg.head_chunk
    return ck if ck and S > ck and S % ck == 0 else None


def extract_priors(views: Dict[str, torch.Tensor], image_hw):
    """The normalised priors present in `views` -> (depths (B,S,H,W), rays
    (B,S,4), poses (B,S,7)), each None where absent. camera_pose (B,S,4,4)
    goes to normalize_poses as given; the intrinsics become (fx/w, fy/h,
    cx/w, cy/h)."""
    h, w = image_hw
    depths = rays = poses = None
    if "camera_pose" in views:
        ext = prior_utils.normalize_poses(views["camera_pose"][:, :, :3])
        poses = cam_utils.extrinsics_to_vector(ext)[..., :7]
    if "depthmap" in views:
        depths = prior_utils.normalize_depth(views["depthmap"])
    if "camera_intrinsics" in views:
        K = views["camera_intrinsics"][:, :, :3, :3]
        rays = torch.stack([K[:, :, 0, 0] / w, K[:, :, 1, 1] / h,
                            K[:, :, 0, 2] / w, K[:, :, 1, 2] / h], dim=-1)
    return depths, rays, poses


class WorldMirror(nn.Module):
    """The full model. Parameters are created on `device` (CUDA unless the
    caller names one; without a GPU, device=None raises) and filled from the
    JAX package's init distributions with a torch.Generator seeded by
    `seed`. A head switched off in the config has no module."""

    def __init__(self, cfg: WorldMirrorConfig = WorldMirrorConfig(),
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            self.visual_geometry_transformer = VisualGeometryTransformer(cfg.vgt)
            if cfg.enable_cam:
                self.cam_head = CameraHead(cfg.cam_head)
            if cfg.enable_depth:
                self.depth_head = DPTHead(cfg.depth_head)
            if cfg.enable_pts:
                self.pts_head = DPTHead(cfg.pts_head)
            if cfg.enable_norm:
                self.norm_head = DPTHead(cfg.norm_head)
            if cfg.enable_gs:
                self.gs_head = DPTHead(cfg.gs_head)
                self.gs_renderer = gaussians.GaussianSplatRenderer(cfg.gs_renderer)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def _head(self, head: DPTHead, token_list, imgs, start: int):
        """A DPT head over all frames at once, or over frame groups."""
        ck = frame_chunks(self.cfg, imgs.shape[1])
        if ck is None:
            return head(token_list, imgs, start)
        outs = [head([t[:, i:i + ck] for t in token_list], imgs[:, i:i + ck], start)
                for i in range(0, imgs.shape[1], ck)]
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))

    def _gs_params_chunked(self, token_list, imgs, start: int, ck: int):
        """The gs head and the gs-param conv per frame group, so the fused
        feature map never exists for all frames -> (raw params (B*S, H, W,
        raw), gs_depth, gs_depth_conf)."""
        B, S, H, W, _ = imgs.shape
        raws, depths, confs = [], [], []
        for i in range(0, S, ck):
            fused, gd, gdc = self.gs_head([t[:, i:i + ck] for t in token_list],
                                          imgs[:, i:i + ck], start)
            raws.append(self.gs_renderer.head(fused.reshape(B * ck, H, W, -1))
                        .reshape(B, ck, H, W, -1))
            depths.append(gd)
            confs.append(gdc)
        raw = torch.cat(raws, dim=1)
        return (raw.reshape(B * S, H, W, -1), torch.cat(depths, dim=1),
                torch.cat(confs, dim=1))

    def forward(self, views: Dict[str, torch.Tensor],
                cond_flags: Sequence[int] = (0, 0, 0), render: bool = True,
                trunk_dtype=torch.bfloat16,
                camera_params: Optional[torch.Tensor] = None,
                marks: Optional[List] = None, mesh=None,
                grad: bool = False) -> Dict[str, torch.Tensor]:
        """views["img"]: (B, S, H, W, 3) in [0, 1], NHWC, on the model's
        device; optional priors views["camera_pose"] (B, S, 4, 4),
        views["depthmap"] (B, S, H, W), views["camera_intrinsics"] (B, S,
        3, 3), used where `cond_flags` (pose, depth, rays) say so (and the
        config's enable_cond). A flag whose prior is absent gives the zero
        token. camera_params: optional (B, S, 9) vectors that replace the
        camera head's prediction downstream (splats and render); the head's
        own prediction is then returned as "camera_params_pred".

        marks: pass a list to have a CUDA event appended after each phase
        (priors where they are used, encoder, trunk, heads, gs_render), for
        phase timing on the card: the end events of the forward's top-level
        spans (utils/profiling.request).

        mesh: a (data, view, model) mesh of process groups (parallel/
        mesh.py); `views` (and camera_params) are then this rank's batch
        and view shard (parallel.sharding.shard_views), the model this
        rank's tensor-parallel shard (sharding.shard_model). The global
        layers run ring attention over the view axis, the camera head and
        the splats see every view, the render is the distributed one; the
        outputs are this rank's views (the splats: all of its batch).

        grad: build the autograd graph (a training step); by default the
        forward runs under no_grad.
        """
        with torch.set_grad_enabled(grad), profiling.request(marks):
            return self._forward(views, cond_flags, render, trunk_dtype,
                                 camera_params, mesh)

    def _priors(self, views, hw, mesh):
        """extract_priors over every view: the pose normalisation spans S,
        so a view-sharded forward normalises the gathered priors and keeps
        its own views."""
        if mesh is None or mesh.size("view") == 1:
            return extract_priors(views, hw)
        group = mesh.group("view")
        whole = {k: comm.gather_raw(views[k], group, 1)
                 for k in ("camera_pose", "depthmap", "camera_intrinsics")
                 if k in views}
        return tuple(None if p is None else axis_part(p, mesh)
                     for p in extract_priors(whole, hw))

    def _forward(self, views, cond_flags, render, trunk_dtype, camera_params,
                 mesh):
        cfg = self.cfg
        imgs = views["img"]
        S, H, W = imgs.shape[1:4]
        use_cond = cfg.enable_cond and sum(cond_flags) > 0
        priors = None
        if use_cond:
            with profiling.span("priors"):
                priors = self._priors(views, (H, W), mesh)
        token_list, start = self.visual_geometry_transformer(
            imgs, priors, cond_flags if use_cond else (0, 0, 0),
            dtype=trunk_dtype, mesh=mesh)

        preds: Dict[str, torch.Tensor] = {}
        with profiling.span("heads"):
            if cfg.enable_cam:
                cam = self.cam_head(token_list, mesh=mesh)[-1]       # (B, S, 9)
                if camera_params is not None:
                    preds["camera_params_pred"] = cam
                    cam = torch.as_tensor(camera_params, dtype=torch.float32,
                                          device=imgs.device)
                    profiling.count("host_syncs")
                preds["camera_params"] = cam
                ext, intr = cam_utils.vector_to_camera_matrices(cam, (H, W))
                preds["camera_poses"] = cam_utils.se3_inverse(
                    cam_utils.to_homogeneous(ext))                   # c2w
                preds["camera_intrs"] = intr

            if cfg.enable_depth:
                with profiling.span("heads.depth"):
                    preds["depth"], preds["depth_conf"] = self._head(
                        self.depth_head, token_list, imgs, start)
            if cfg.enable_pts:
                with profiling.span("heads.pts"):
                    preds["pts3d"], preds["pts3d_conf"] = self._head(
                        self.pts_head, token_list, imgs, start)
            if cfg.enable_norm:
                with profiling.span("heads.normals"):
                    preds["normals"], preds["normals_conf"] = self._head(
                        self.norm_head, token_list, imgs, start)

            gs_feat = gs_params = None
            ck = frame_chunks(cfg, S)
            if cfg.enable_gs:
                with profiling.span("heads.gs"):
                    if ck is None:
                        gs_feat, preds["gs_depth"], preds["gs_depth_conf"] = self.gs_head(
                            token_list, imgs, start)
                    else:
                        gs_params, preds["gs_depth"], preds["gs_depth_conf"] = (
                            self._gs_params_chunked(token_list, imgs, start, ck))
        if cfg.enable_gs:
            with profiling.span("gs_render"):
                preds = gaussians.render(self.gs_renderer, gs_feat, imgs, preds,
                                         do_render=render, views=views,
                                         gs_params=gs_params, mesh=mesh)
        return preds
