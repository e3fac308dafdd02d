"""One DPT head on the card, whole and split into its three stages.

    python -m hunyuanworld_mirror_tpu_torch.heads_profile [--views 4] [--img 518]
        [--iters 5] [--seed 0]

The port's twin of tools/heads_profile.py: the `large` model's points head
(pts_head) on the trunk's tokens for S views at the given size, timed whole
at f32 and at bf16 compute dtype, then, at f32 (the shipped dtype), stage by
stage: tokens + projections + resizes (`DPTHead.tokens_stage`), scratch +
fusion (`fusion_stage`), and the full-resolution output convs with the
activation (`fullres_stage`). The stages are the head's own pieces, so
their composition is its forward. Random weights from seed 0, bf16
parameters (as the CLI casts them), images drawn from --seed uniform in
[0, 1]. Each time is `utils/profiling.time_fn`'s median of --iters calls
after one warm-up, each call ended by torch.cuda.synchronize; every line
carries the card's name and power limit. The JAX tool's in-jit repeat
harness and relay floor have no counterpart here. Needs a CUDA card.
"""

import argparse
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch

from .models.dpt import DPTHead, activate_head
from .utils.profiling import detect_chip, time_fn


def stage_fns(head: DPTHead, images: torch.Tensor, patch_start_idx: int):
    """The head's three stages as functions: token_list -> feats -> the
    fused map -> the activated prediction (the head's forward's first
    output, flattened over B*S)."""
    def tokens(token_list):
        return head.tokens_stage(token_list, images, patch_start_idx)

    def fullres(out):
        return activate_head(head.fullres_stage(out, images), head.cfg.activation)[0]

    return tokens, head.fusion_stage, fullres


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--img", type=int, default=518)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from .infer import PRESETS, load_model
    from .models.worldmirror import WorldMirrorConfig

    _, card, watts = detect_chip()
    tag = f"[{card}, {watts:.2f} W]"
    cfg = WorldMirrorConfig(img_size=args.img, **PRESETS["large"])
    model = load_model(cfg, device="cuda")
    S = args.views
    imgs = torch.as_tensor(np.random.default_rng(args.seed).uniform(
        size=(1, S, args.img, args.img, 3)).astype(np.float32), device="cuda")
    head = model.pts_head
    ms: Dict[str, float] = {}
    with torch.no_grad():
        token_list, start = model.visual_geometry_transformer(imgs)
        f32 = head.cfg
        for dt in ("float32", "bfloat16"):
            head.cfg = replace(f32, compute_dtype=dt)
            ms[f"full_{dt}"] = 1e3 * time_fn(head, token_list, imgs, start,
                                             iters=args.iters)
            print(f"pts_head full ({dt:8s}): {ms[f'full_{dt}']:9.3f} ms  {tag}",
                  flush=True)
        head.cfg = f32
        tokens, fusion, fullres = stage_fns(head, imgs, start)
        feats = tokens(token_list)
        out = fusion(feats)
        for name, label, fn, arg in (
                ("tokens", "tokens+proj+resize", tokens, token_list),
                ("fusion", "scratch+fusion", fusion, feats),
                ("fullres", "fullres out convs", fullres, out)):
            ms[name] = 1e3 * time_fn(fn, arg, iters=args.iters)
            print(f"{label:19s}: {ms[name]:9.3f} ms  {tag}", flush=True)
    ms["stages_sum"] = ms["tokens"] + ms["fusion"] + ms["fullres"]
    print(f"{'stages summed':19s}: {ms['stages_sum']:9.3f} ms  (S={S}, "
          f"{args.img} px, f32)  {tag}", flush=True)
    return ms


if __name__ == "__main__":
    main()
