"""The render's inputs for the measuring tools: the main path's scene.

`fixed_cameras(S)` are the ~60 degree cameras chip_smoke.py's main path
renders through; `render_scene` runs a model's trunk and heads once on
seeded images and returns what `models/gaussians.render` takes. On random
weights the model's own predicted cameras leave the render nearly empty
(PERF.md §4), so the fixed cameras are the default load.
"""

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

# the main path's render caps (GSRendererConfig's defaults): a tile's list
# and a splat's slots
RENDER_MPT, RENDER_TPG = 4096, 4


def fixed_cameras(S):
    """Identity-ish rotations, small translations, ~60 degree fov."""
    cams = np.zeros((1, S, 9), np.float32)
    for s in range(S):
        a = 0.05 * s
        cams[0, s, :3] = [0.05 * s, -0.02 * s, 0.03 * s]
        cams[0, s, 3:7] = [0.0, math.sin(a / 2), 0.0, math.cos(a / 2)]  # xyzw
        cams[0, s, 7:9] = math.radians(60)
    return cams


class RenderScene(NamedTuple):
    model: torch.nn.Module   # the WorldMirror the scene came from
    cfg: object              # its WorldMirrorConfig
    images: torch.Tensor     # (1, S, H, W, 3) in [0, 1]
    preds: Dict[str, torch.Tensor]  # camera_params, depth(_conf), gs_depth(_conf)
    gs_feat: torch.Tensor    # (1, S, H, W, gs_dim / 2) fused GS features
    token_list: list         # the trunk's intermediate tokens
    patch_start_idx: int


def render_scene(preset: str = "large", S: int = 4, img: int = 518,
                 seed: int = 0, cameras: str = "fixed", device=None) -> RenderScene:
    """The `preset` model (random weights from seed 0, bf16 parameters, as
    the CLI builds it) on S images of img x img px drawn from `seed`
    uniform in [0, 1]: the trunk, the camera head, the depth head and the
    GS head once, at the main path's settings. `cameras="fixed"` puts
    fixed_cameras(S) in preds["camera_params"] (the head's own prediction
    in "camera_params_pred"); "predicted" keeps the head's. Runs on
    `device` (CUDA unless given)."""
    from .. import resolve_device
    from ..infer import PRESETS, load_model
    from ..models.worldmirror import WorldMirrorConfig
    if cameras not in ("fixed", "predicted"):
        raise ValueError(f"cameras must be 'fixed' or 'predicted', got {cameras!r}")
    dev = resolve_device(device)
    cfg = WorldMirrorConfig(img_size=img, **PRESETS[preset])
    model = load_model(cfg, device=dev)
    imgs = torch.as_tensor(np.random.default_rng(seed).uniform(
        size=(1, S, img, img, 3)).astype(np.float32), device=dev)
    preds: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        token_list, start = model.visual_geometry_transformer(imgs)
        cam = model.cam_head(token_list)[-1]
        if cameras == "fixed":
            preds["camera_params_pred"] = cam
            cam = torch.as_tensor(fixed_cameras(S), device=dev)
        preds["camera_params"] = cam
        preds["depth"], preds["depth_conf"] = model.depth_head(token_list, imgs, start)
        gs_feat, preds["gs_depth"], preds["gs_depth_conf"] = model.gs_head(
            token_list, imgs, start)
    return RenderScene(model, cfg, imgs, preds, gs_feat, token_list, start)


def add_scene_args(ap, iters: Optional[int] = 3, cameras: bool = True) -> None:
    """The render tools' shared flags: the scene (--cameras where the tool
    renders), the timing (--iters, where `iters` gives its default), the
    device."""
    ap.add_argument("--preset", default="large")
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--img", type=int, default=518)
    ap.add_argument("--seed", type=int, default=0)
    if cameras:
        ap.add_argument("--cameras", choices=("fixed", "predicted"), default="fixed")
    if iters is not None:
        ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--device", default=None,
                    help="cpu to rehearse without a card (every time null)")


def scene_from_args(args, device) -> RenderScene:
    return render_scene(args.preset, args.views, args.img, args.seed,
                        getattr(args, "cameras", "fixed"), device)
