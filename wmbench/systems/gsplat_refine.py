"""Splat refinement cells: one request is one step of make_train_step.

Set-up makes the scene the traffic needs: the program's WorldMirror
(reference/weights.py's weights from the seed, as systems/worldmirror.py
builds it) reconstructs the traffic's views once through the camera ring,
and its export (the splats above opacity 1e-4, as infer.export_gaussians
writes them) is the scene; the model is then freed. The step is built as
training/splat_opt.optimize_splats builds it (its raw parameters padded to
capacity_factor times the splats, Adam per group, the means' rate times the
scene scale) and driven from the seed through its first `check_steps`
steps: their losses, the first step's gradients as Adam holds them (its
first moment over 1 - beta1) and the parameters' change over them are kept.
The window then runs the same step object on, with the DefaultStrategy's
gradient accumulation and no refine: the steps between refines.

The check, once the window has closed and the program is freed, follows
the same first steps with the plain reference (reference/train.py) from
the same splats and compares, by the worst parameter group against the
larger of the reference's norm of that group and of the median group:
- loss_gap: each step's loss, relative;
- grad_gap: the norm of the first step's gradient;
- change_gap: the norm of the parameters' change over the steps, for the
  groups whose reference gradient is over a thousandth of the median's.
"""

import gc
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from wmbench.systems import worldmirror as wmb
from wmbench.frozen import arith
from wmbench.reference import render as ref_render
from wmbench.reference import train as ref_train
from wmbench.reference.precision import CONTROL, REFERENCE, Precision, f32_exact
from wmbench.reference.weights import make_weights

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SPLAT_KEYS = ("means", "quats", "scales", "opacities", "sh")


def port_settings(cfg: dict):
    """The program's SplatOptConfig, checked against the file's settings."""
    from hunyuanworld_mirror_tpu_torch.training.splat_opt import SplatOptConfig
    sc = SplatOptConfig()
    keys = ("iters", "ssim_lambda", "capacity_factor", "refine_every", "refine_start",
            "refine_stop", "lr_means", "lr_scales", "lr_quats", "lr_opacities", "lr_sh",
            "tile_size", "max_per_tile", "strategy")
    stated = {k: getattr(sc, k) for k in keys}
    stated["rasterizer_impl"] = sc.rasterizer_impl
    want = {k: cfg[k] for k in keys}
    want["rasterizer_impl"] = cfg["render"]["route"]
    if stated != want or cfg["render"]["tile_size"] != sc.tile_size:
        raise ValueError(f"the program's settings {stated} differ from the file's {want}")
    return sc


def make_scene(cfg: dict, traffic: dict, seed: int, device, gen) -> Dict:
    """The scene: the program's reconstruction of the traffic's views
    (scene 0) through the camera ring, its exported splats, the views."""
    from hunyuanworld_mirror_tpu_torch import infer
    wm_cfg = cfg["scene_from"]   # a configuration file's name, or its contents
    if isinstance(wm_cfg, str):
        wm_cfg = json.loads((CONFIGS / f"{wm_cfg}.json").read_text())
    data = gen.make(traffic, seed)
    images = data["scenes"][0]
    model = infer.load_model(wmb.port_config(wm_cfg), device=device)
    model.load_state_dict(make_weights(wm_cfg, seed, device), strict=True)
    preds = infer.reconstruct(model, images, camera_params=data["cameras"],
                              cond_flags=tuple(traffic["cond"]))
    sp = preds["splats"]
    live = sp["opacities"][0] > 1e-4
    splats = {k: sp[k][0][live].float().contiguous() for k in SPLAT_KEYS}
    scene = {"splats": splats, "c2w": preds["camera_poses"][0].float(),
             "Ks": preds["camera_intrs"][0].float(),
             "images": torch.as_tensor(images[0], device=device),
             "cams": torch.as_tensor(data["cameras"][0], device=device)}
    del model, preds, sp
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return scene


def scene_scale(c2w: torch.Tensor) -> float:
    t = c2w[:, :3, 3]
    return float(torch.linalg.norm(t - t.mean(0), dim=-1).max()) + 1e-6


def lrs(cfg: dict, scale: float) -> Dict[str, float]:
    return {"means": cfg["lr_means"] * scale, "log_scales": cfg["lr_scales"],
            "quats": cfg["lr_quats"], "opacity_logits": cfg["lr_opacities"],
            "sh": cfg["lr_sh"]}


def _gap(a: float, r: float, floor: float) -> float:
    return abs(a - r) / max(abs(r), floor, 1e-30)


def compare(readings: Dict, ref: Dict) -> Dict[str, float]:
    """The check's numbers: `readings` (losses, grad_norms, change_norms)
    of the program, or of the control in its place, against the reference's
    follow()."""
    gn = {k: float(torch.linalg.norm(g)) for k, g in ref["grad1"].items()}
    dn = {k: float(torch.linalg.norm(d)) for k, d in ref["delta"].items()}
    g_med = float(np.median(list(gn.values())))
    moved = [k for k in gn if gn[k] >= 1e-3 * g_med]
    d_med = float(np.median([dn[k] for k in moved]))
    return {
        "loss_gap": max(_gap(a, r, 0.0) for a, r in zip(readings["losses"], ref["losses"])),
        "grad_gap": max(_gap(readings["grad_norms"][k], gn[k], g_med) for k in gn),
        "change_gap": max(_gap(readings["change_norms"][k], dn[k], d_med) for k in moved),
    }


def _readings(out: Dict) -> Dict:
    return {"losses": out["losses"],
            "grad_norms": {k: float(torch.linalg.norm(g)) for k, g in out["grad1"].items()},
            "change_norms": {k: float(torch.linalg.norm(d)) for k, d in out["delta"].items()}}


class Cell:
    """One splat refinement cell on `device`."""


    def __init__(self, cfg: dict, traffic: dict, seed: int, device, gen):
        from hunyuanworld_mirror_tpu_torch.training import splat_opt
        from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.units_per_request = 1
        self.check_requests: List[int] = []
        sc = port_settings(cfg)
        self.scene = scene = make_scene(cfg, traffic, seed, self.device, gen)
        n = scene["splats"]["means"].shape[0]
        capacity = int(n * cfg["capacity_factor"])
        self.scale = scene_scale(scene["c2w"])
        self.raw = splat_opt._raw_from_splats(scene["splats"], capacity)
        self.opt = splat_opt.make_optimizer(sc, self.raw, self.scale)
        H, W = scene["images"].shape[1:3]
        self.step_fn = splat_opt.make_train_step(sc, W, H, self.scale, self.device)
        self.viewmats = cam_utils.se3_inverse(scene["c2w"])
        self.gt_depths = torch.zeros(scene["images"].shape[:3], device=self.device)
        self.grad_sum = torch.zeros(capacity, device=self.device)
        self.seen = torch.zeros(capacity, device=self.device)
        self.profiled_raw: Optional[Dict] = None
        self.keep_profiled = False
        self.log = print

        # the first steps, through the window's own call, for the check
        start = {k: self.raw[k].detach().clone() for k in ref_train.KEYS}
        losses, grad_norms = [], None
        for t in range(cfg["check_steps"]):
            losses.append(float(self._step(None)))
            if grad_norms is None:
                beta1 = self.opt.param_groups[0]["betas"][0]
                # an optimizer that holds no moment got no gradient
                grad_norms = {k: float(torch.linalg.norm(self.opt.state[self.raw[k]]["exp_avg"]))
                              / (1 - beta1) if "exp_avg" in self.opt.state[self.raw[k]] else 0.0
                              for k in ref_train.KEYS}
        self.readings = {"losses": losses, "grad_norms": grad_norms,
                         "change_norms": {k: float(torch.linalg.norm(self.raw[k].detach() - start[k]))
                                          for k in ref_train.KEYS}}
        del start

    def _step(self, marks):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(("start", ev))
        loss, g2d, _ = self.step_fn(self.raw, self.opt, self.viewmats, self.scene["Ks"],
                                    self.scene["images"], self.gt_depths, marks)
        self.grad_sum += g2d
        self.seen += (g2d > 0).float()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return loss

    def request(self, i: int, marks: Optional[list] = None) -> None:
        if self.keep_profiled and self.profiled_raw is None:
            self.profiled_raw = {k: v.detach().clone() for k, v in self.raw.items()}
        self._step(marks)

    def counters(self) -> str:
        from hunyuanworld_mirror_tpu_torch.ops.rasterizer_flat import (rasterize_flat,
                                                                       rasterize_flat_bwd)
        return (f"K2 launches {rasterize_flat.launches}, K3 launches "
                f"{rasterize_flat_bwd.launches}, {self.scene['splats']['means'].shape[0]} "
                f"splats in {self.raw['means'].shape[0]} slots")

    def work(self) -> Dict:
        """The work of a profiled step by the benchmark's own rules, from the
        parameters at the stretch's start: each camera's entries and the
        splats they touch (reference/render.count_isects), the step's bytes."""
        if self.profiled_raw is None:
            return {}
        raw = self.profiled_raw
        alive = raw["alive"] > 0.5
        with torch.no_grad():
            s = ref_train.activate({k: raw[k][alive] for k in ref_train.KEYS})
            H, W = self.scene["images"].shape[1:3]
            counts = ref_render.count_isects(s, self.scene["cams"], H, W, self.cfg["render"])
        n_pix, d = H * W, 4
        k2 = sum(arith.k2_bytes(n, n_pix, d) for n, _ in counts)
        k3 = sum(arith.k3_bytes(n, n_pix, t, d) for n, t in counts)
        return {"n_isects": [[n for n, _ in counts]], "pixels": n_pix, "d_channels": d,
                "k2_bytes": k2, "k3_bytes": k3,
                "step_bytes": arith.refine_step_bytes(raw["means"].shape[0],
                                                      int(alive.sum()), len(counts), k2, k3)}

    def close(self) -> None:
        self.raw = self.opt = self.step_fn = self.profiled_raw = None
        self.grad_sum = self.seen = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        H, W = self.scene["images"].shape[1:3]
        with torch.no_grad():
            counts = ref_render.count_isects(self.scene["splats"], self.scene["cams"], H, W,
                                             self.cfg["render"])
        self.log(f"export: intersections a camera {[n for n, _ in counts]} (reference)")
        ref = follow(self.cfg, self.scene, REFERENCE)
        return compare(self.readings, ref)


def follow(cfg: dict, scene: Dict, prec: Precision) -> Dict:
    f32_exact()
    H, W = scene["images"].shape[1:3]
    w2c, K = ref_render.camera_matrices(scene["cams"], H, W)
    return ref_train.follow(scene["splats"], w2c, K, scene["images"], cfg["render"],
                            cfg["ssim_lambda"], lrs(cfg, scene_scale(scene["c2w"])),
                            cfg["check_steps"], prec)


def build(cfg: dict, traffic: dict, seed: int, device, gen) -> Cell:
    return Cell(cfg, traffic, seed, device, gen)


def control_numbers(cfg: dict, traffic: dict, seed: int, device, gen,
                    prec: Precision = CONTROL) -> Dict[str, float]:
    """The check's numbers with the reference at `prec` in the program's
    place, from the scene of `seed`."""
    f32_exact()
    scene = make_scene(cfg, traffic, seed, torch.device(device), gen)
    control = _readings(follow(cfg, scene, prec))
    return compare(control, follow(cfg, scene, REFERENCE))
