"""WorldMirror reconstruction cells: one request is one infer.reconstruct.

The cell builds the program's model as the CLI does (infer.load_model:
bf16 parameters, bf16 trunk, f32 heads, TF32 off, the flat render route
with exact binning), loads the weights that reference/weights.py draws
from the seed, and drives `infer.reconstruct(model, images,
camera_params=..., marks=...)` on the traffic's scenes. A forward hook on
the trunk keeps the intermediates of the sampled scenes' latest requests,
beside their predictions.

The check, once the window has closed and the program is freed, runs the
plain reference (reference/) on each sampled scene that the window
requested (in a window shorter than the pool, on its latest request) and
compares, each by its worst scene:
- trunk_gap: the reference's f32 trunk on the images against the
  program's bf16 intermediates, ||a - r|| / ||r||, worst layer (the
  largest single gap separates bf16 from the fp8 control by 2.5x only);
- heads_gap: the reference's f32 heads on the program's own intermediates
  against the program's head outputs (camera, depth, points, normals,
  Gaussian depth, and each confidence), max |a - r| / max |r|, worst
  output;
- render_gap: the reference's splats and render from those heads against
  the program's rendered colours, expected depths and alphas, sum |a - r|
  / sum |r|, worst of the three;
- splat_gap: the live splats' count and their summed opacities, weights,
  scales and weighted means, relative, worst of them.
The heads and the render are judged from the program's own intermediates
(its trunk is bf16, whose rounding would hide an f32 fault downstream);
the trunk is judged by itself.
"""

import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from wmbench.frozen import arith
from wmbench.reference import model as ref_model
from wmbench.reference import render as ref_render
from wmbench.reference.precision import CONTROL, Precision, f32_exact
from wmbench.reference.weights import make_weights

HEAD_KEYS = ("camera_params_pred", "depth", "depth_conf", "pts3d", "pts3d_conf",
             "normals", "normals_conf", "gs_depth", "gs_depth_conf")
RENDER_KEYS = ("rendered_colors", "rendered_depths", "rendered_alphas")


def port_config(cfg: dict):
    """The program's WorldMirrorConfig for a configuration file, checked
    against the widths the file states."""
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig
    r = cfg["render"]
    wm = WorldMirrorConfig(
        img_size=cfg["img_size"], patch_size=cfg["patch_size"],
        embed_dim=cfg["embed_dim"], gs_dim=cfg["gs_dim"],
        enable_cond=cfg["enable_cond"], patch_embed=cfg["encoder"],
        sh_degree=cfg["sh_degree"], voxel_size=cfg["voxel_size"],
        trunk_depth=cfg["trunk_depth"], trunk_heads=cfg["trunk_heads"],
        intermediate_idxs=tuple(cfg["intermediate_idxs"]),
        rasterizer_impl=r["route"], gs_slot_fracs=None,
        dpt_features=cfg["dpt_features"],
        dpt_out_channels=tuple(cfg["dpt_out_channels"]))
    rc = wm.gs_renderer
    stated = (rc.tile_size, rc.max_per_tile, rc.max_tiles_per_gauss, wm.cam_head.num_heads,
              wm.cam_head.trunk_depth, wm.vgt.patch_start_idx)
    want = (r["tile_size"], r["max_per_tile"], r["max_tiles_per_gauss"],
            cfg["cam_head_heads"], cfg["cam_head_depth"], ref_model.n_special(cfg))
    if stated != want:
        raise ValueError(f"the program's settings {stated} differ from the file's {want}")
    if cfg["encoder"] != "conv":
        vit = wm.vgt.vit_config
        if (vit.embed_dim, vit.depth, vit.num_heads) != (
                cfg["encoder_dim"], cfg["encoder_depth"], cfg["encoder_heads"]):
            raise ValueError(f"the encoder {cfg['encoder']} is not the file's")
    return wm


def _rel_max(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.float(), r.float()
    return float((a - r).abs().max() / torch.clamp_min(r.abs().max(), 1e-30))


def _rel_norm(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.float(), r.float()
    return float(torch.linalg.norm(a - r) / torch.clamp_min(torch.linalg.norm(r), 1e-30))


def _rel_sum(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.float(), r.float()
    return float((a - r).abs().sum() / torch.clamp_min(r.abs().sum(), 1e-30))


def _splat_sums(s: Dict[str, torch.Tensor]) -> List[float]:
    live = s["weights"] > 0
    w = s["weights"][live]
    return [float(live.sum()), float(s["opacities"][live].sum()), float(w.sum()),
            float(s["scales"][live].sum()),
            float(torch.linalg.norm((w[:, None] * s["means"][live]).sum(0)))]


def compare(sd, cfg, images, cams, out: Dict, tokens: List[torch.Tensor],
            info: Optional[Dict] = None) -> Dict[str, float]:
    """The check's numbers for one scene: `out` and `tokens` are what the
    program (or the control in its place) produced for `images`. `info`
    receives the entries each camera's reference blend took."""
    B, S, H, W, _ = images.shape
    with torch.no_grad():
        ref_tok = ref_model.trunk(sd, cfg, images)
        nums = {"trunk_gap": max(_rel_norm(t, r) for t, r in zip(tokens, ref_tok))}
        del ref_tok
        ref = ref_model.heads(sd, cfg, tokens, images)
        nums["heads_gap"] = max(_rel_max(out[k], ref[k]) for k in HEAD_KEYS)
        s = ref_render.splats(sd, cfg, ref["gs_feat"], ref["gs_depth"], images, cams)
        del ref
        col, dep, alpha, n_isects = ref_render.render(s, cams[0], H, W, cfg["render"])
        if info is not None:
            info["n_isects"] = n_isects
        nums["render_gap"] = max(_rel_sum(out[k][0], r) for k, r in
                                 zip(RENDER_KEYS, (col, dep, alpha)))
        mine = {k: v[0] for k, v in out["splats"].items() if v.dim() > 1}
        nums["splat_gap"] = max(abs(a - r) / max(abs(r), 1e-30) for a, r in
                                zip(_splat_sums(mine), _splat_sums(s)))
    return nums


def control_outputs(sd, cfg, images, cams, prec: Precision = CONTROL):
    """The reference put in the program's place at `prec`: (outputs in the
    program's layout, intermediates)."""
    B, S, H, W, _ = images.shape
    with torch.no_grad():
        tokens = ref_model.trunk(sd, cfg, images, prec)
        out = ref_model.heads(sd, cfg, tokens, images, prec)
        s = ref_render.splats(sd, cfg, out["gs_feat"], out["gs_depth"], images, cams, prec)
        col, dep, alpha, _ = ref_render.render(s, cams[0], H, W, cfg["render"], prec)
    out.pop("gs_feat")
    out.update(rendered_colors=col[None], rendered_depths=dep[None],
               rendered_alphas=alpha[None], splats={k: v[None] for k, v in s.items()})
    return out, tokens


class Cell:
    """One WorldMirror reconstruction cell on `device`."""


    def __init__(self, cfg: dict, traffic: dict, seed: int, device, gen):
        from hunyuanworld_mirror_tpu_torch import infer
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        data = gen.make(traffic, seed)
        self.scenes, self.cams, self.sample = data["scenes"], data["cameras"], data["sample"]
        self.check_requests = list(self.sample)   # requests whose outputs the check reads
        self.units_per_request = traffic["batch"] * traffic["views"]
        self._infer = infer
        model = infer.load_model(port_config(cfg), device=self.device)
        model.load_state_dict(make_weights(cfg, seed, self.device), strict=True)
        self.model = model
        self._tokens: Optional[list] = None
        self._capture = False
        model.visual_geometry_transformer.register_forward_hook(self._hook)
        self.kept: Dict[int, tuple] = {}
        self.profiled: List[Dict] = []
        self.keep_profiled = False
        self.log = print

    def _hook(self, _mod, _inp, output):
        if self._capture:
            self._tokens = [t.detach() for t in output[0]]

    def request(self, i: int, marks: Optional[list] = None) -> None:
        """Request i >= 0 is in the window (negative: warm-up). The window's
        latest request of each sampled scene is kept for the check, and the
        latest of any scene until a sampled one has come."""
        k = i % len(self.scenes)
        self._capture = i >= 0 and (k in self.sample or not self.kept)
        preds = self._infer.reconstruct(self.model, self.scenes[k],
                                        camera_params=self.cams, marks=marks,
                                        cond_flags=tuple(self.traffic["cond"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._capture:
            if any(s not in self.sample for s in self.kept):
                self.kept = {}
            self.kept[k] = ({key: preds[key] for key in HEAD_KEYS + RENDER_KEYS + ("splats",)},
                            self._tokens)
            self._tokens = None
        if self.keep_profiled:
            self.profiled.append(preds["splats"])

    def counters(self) -> str:
        from hunyuanworld_mirror_tpu_torch.ops.attention import attention
        from hunyuanworld_mirror_tpu_torch.ops.rasterizer_flat import rasterize_flat
        return f"K1 launches {attention.launches}, K2 launches {rasterize_flat.launches}"

    def work(self) -> Dict:
        """The profiled requests' work by the benchmark's own rules: the
        entries each camera's blend takes (reference/render.count_isects on
        the program's splats), the attention calls and the model FLOPs of a
        request."""
        cfg = self.cfg
        H = W = cfg["img_size"]
        B, S = self.traffic["batch"], self.traffic["views"]
        cams = torch.as_tensor(self.cams[0], device=self.device)
        isects = []
        with torch.no_grad():
            for sp in self.profiled:
                s = {k: v[0] for k, v in sp.items() if v.dim() > 1}
                live = s["weights"] > 0
                isects.append([n for n, _ in ref_render.count_isects(
                    {k: v[live] for k, v in s.items()}, cams, H, W, cfg["render"])])
        return {"n_isects": isects, "pixels": H * W, "d_channels": 4,
                "attention_calls": arith.attention_calls(cfg, B, S),
                "model_flops": arith.model_flops(B, S, H, W, cfg["embed_dim"], cfg["gs_dim"],
                                                 ref_model.n_special(cfg))["total"]}

    def close(self) -> None:
        """Free the program's model and everything but the kept outputs."""
        self.model = None
        self.profiled = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        f32_exact()
        sd = {k: v.float() for k, v in make_weights(self.cfg, self.seed, self.device).items()}
        nums: Dict[str, float] = {}
        if not self.kept:
            raise RuntimeError("no request completed in the window")
        for k in sorted(self.kept):
            out, tokens = self.kept.pop(k)
            images = torch.as_tensor(self.scenes[k], device=self.device)
            cams = torch.as_tensor(self.cams, device=self.device)
            info: Dict = {}
            for name, v in compare(sd, self.cfg, images, cams, out, tokens, info).items():
                nums[name] = max(nums.get(name, -np.inf), v) if np.isfinite(v) else np.inf
            self.log(f"scene {k}: intersections a camera {info['n_isects']} (reference)")
            del out, tokens
        return nums


def build(cfg: dict, traffic: dict, seed: int, device, gen) -> Cell:
    return Cell(cfg, traffic, seed, device, gen)


def control_numbers(cfg: dict, traffic: dict, seed: int, device, gen,
                    prec: Precision = CONTROL) -> Dict[str, float]:
    """The check's numbers with the reference at `prec` in the program's
    place, on the sampled scenes of `seed`."""
    f32_exact()
    data = gen.make(traffic, seed)
    sd = {k: v.float() for k, v in make_weights(cfg, seed, device).items()}
    cams = torch.as_tensor(data["cameras"], device=device)
    nums: Dict[str, float] = {}
    for k in data["sample"]:
        images = torch.as_tensor(data["scenes"][k], device=device)
        out, tokens = control_outputs(sd, cfg, images, cams, prec)
        for name, v in compare(sd, cfg, images, cams, out, tokens).items():
            nums[name] = max(nums.get(name, float("-inf")), v)
    return nums
