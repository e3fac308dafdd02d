"""WorldMirror top-level assembly: trunk + prediction heads.

Port of hunyuanworld_mirror_tpu/models/worldmirror.py on the default path
(no priors): the aggregator feeds the camera head, the depth / points /
normals DPT heads and the Gaussian head, whose splats are rendered back into
the input views. bf16 trunk, f32 heads and render. Submodule names are the
reference torch state-dict prefixes (`visual_geometry_transformer`,
`cam_head`, `pts_head`, `depth_head`, `norm_head`, `gs_head`,
`gs_renderer`), so the public release's state dict loads directly.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..utils import camera as cam_utils
from ..utils.profiling import mark
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
    patch_embed: str = "dinov2_vitl14_reg"
    sh_degree: int = 0
    voxel_size: float = 0.002
    trunk_depth: int = 24
    trunk_heads: int = 16
    intermediate_idxs: Tuple[int, ...] = (4, 11, 17, 23)
    # post-prune static compaction; False keeps every voxel-merged splat
    gs_compact: bool = True
    # DPT decoder width overrides (None = features 256, out_channels
    # (256, 512, 1024, 1024)); the small golden fixture shrinks them
    dpt_features: Optional[int] = None
    dpt_out_channels: Optional[Tuple[int, ...]] = None

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
                         output_dim=output_dim, activation=activation, **kw)

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
            voxel_size=self.voxel_size, enable_compact=self.gs_compact)


class WorldMirror(nn.Module):
    """The full model. Parameters are created on `device` (CUDA unless the
    caller names one; without a GPU, device=None raises) and filled from the
    JAX package's init distributions with a torch.Generator seeded by
    `seed`."""

    def __init__(self, cfg: WorldMirrorConfig = WorldMirrorConfig(),
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            self.visual_geometry_transformer = VisualGeometryTransformer(cfg.vgt)
            self.cam_head = CameraHead(cfg.cam_head)
            self.depth_head = DPTHead(cfg.depth_head)
            self.pts_head = DPTHead(cfg.pts_head)
            self.norm_head = DPTHead(cfg.norm_head)
            self.gs_head = DPTHead(cfg.gs_head)
            self.gs_renderer = gaussians.GaussianSplatRenderer(cfg.gs_renderer)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)

    @torch.no_grad()
    def forward(self, views: Dict[str, torch.Tensor],
                cond_flags: Sequence[int] = (0, 0, 0), render: bool = True,
                trunk_dtype=torch.bfloat16,
                camera_params: Optional[torch.Tensor] = None,
                marks: Optional[List] = None) -> Dict[str, torch.Tensor]:
        """views["img"]: (B, S, H, W, 3) in [0, 1], NHWC, on the model's
        device. camera_params: optional (B, S, 9) vectors that replace the
        camera head's prediction downstream (splats and render); the head's
        own prediction is then returned as "camera_params_pred".

        marks: pass a list to have a CUDA event appended after each phase
        (encoder, trunk, heads, gs_render), for phase timing on the card.
        """
        if any(cond_flags):
            raise NotImplementedError("prior prompting (cond flags other than "
                                      "(0, 0, 0)) is not ported yet")
        imgs = views["img"]
        H, W = imgs.shape[2:4]
        token_list, start = self.visual_geometry_transformer(
            imgs, dtype=trunk_dtype, marks=marks)
        mark(marks, "trunk")

        preds: Dict[str, torch.Tensor] = {}
        cam = self.cam_head(token_list)[-1]                      # (B, S, 9)
        if camera_params is not None:
            preds["camera_params_pred"] = cam
            cam = torch.as_tensor(camera_params, dtype=torch.float32,
                                  device=imgs.device)
        preds["camera_params"] = cam
        ext, intr = cam_utils.vector_to_camera_matrices(cam, (H, W))
        preds["camera_poses"] = cam_utils.se3_inverse(
            cam_utils.to_homogeneous(ext))                       # c2w
        preds["camera_intrs"] = intr

        preds["depth"], preds["depth_conf"] = self.depth_head(
            token_list, imgs, start)
        preds["pts3d"], preds["pts3d_conf"] = self.pts_head(
            token_list, imgs, start)
        preds["normals"], preds["normals_conf"] = self.norm_head(
            token_list, imgs, start)
        gs_feat, preds["gs_depth"], preds["gs_depth_conf"] = self.gs_head(
            token_list, imgs, start)
        mark(marks, "heads")
        preds = gaussians.render(self.gs_renderer, gs_feat, imgs, preds,
                                 do_render=render)
        mark(marks, "gs_render")
        return preds
