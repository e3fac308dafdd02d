"""The composed Gaussian render on the card under each rasterizer knob.

    python -m hunyuanworld_mirror_tpu_torch.render_sweep [--knob group tile ...]
        [--views 4] [--img 518] [--iters 3] [--seed 0] [--cameras fixed|predicted]
    python -m hunyuanworld_mirror_tpu_torch.render_sweep --device cpu --preset tiny --img 56

The port's twin of tools/render_sweep.py. It times `models/gaussians.render`
(head conv, prepare, voxel merge, compaction, binning, blend) on one scene
(`utils/scenes.render_scene`: the `large` model's trunk and heads once,
the fixed cameras by default) under one knob at a time, and prints each
setting's max |delta| of rendered_colors against the knob's first setting
and its intersections a camera. The knobs the card has (KNOBS):
  group       WM_RASTER_GROUP 1 / 4 / 8 / 16 (G > 1: kernel K5);
  tile        GSRendererConfig.tile_size 16 / 8 (the kernels build 8 and
              16 only: ops/rasterizer_flat.KERNEL_TILE_SIZES);
  exact_tile  exact_tile_test on / off;
  payload     payload_f16 on / off;
  impl        rasterizer_impl "pallas" (K2) / "jax" (the dense bins, K4).
By default every knob runs, in that order. WM_RASTER_GROUP is read at
every render call, so unlike the JAX tool's knobs no compiled cache holds
a stale setting and nothing needs clearing between settings. The JAX tool's
chunk, scan_sub and mxu_sigma are block parameters of the TPU's Pallas
kernels and have no counterpart here: the parser refuses them. Every
environment variable the sweep sets is restored after each setting, also
when the setting fails.

Each time is `utils/profiling.time_fn`'s median of --iters calls after one
warm-up, each call ended by torch.cuda.synchronize (the JAX tool's in-jit
repeat harness and relay floor have no counterpart); every line carries the
card's name and power limit, and the last line is one JSON object with all
the numbers. The JAX tool renders the model's predicted cameras (here
--cameras predicted). Runs on the card; without one it raises unless given
--device cpu, which rehearses the sweep on the plain versions and prints
every time as null.
"""

import argparse
import contextlib
import os
from dataclasses import replace
from typing import Callable, Dict, List, Optional

import torch

from .models import gaussians
from .utils.profiling import ToolRun, fmt_ms
from .utils.scenes import add_scene_args, scene_from_args

# knob -> its settings, each (label, environment variables, config fields)
KNOBS = {
    "group": [(f"WM_RASTER_GROUP={g}", {"WM_RASTER_GROUP": str(g)}, {})
              for g in (1, 4, 8, 16)],
    "tile": [(f"tile_size={t}", {}, {"tile_size": t}) for t in (16, 8)],
    "exact_tile": [(f"exact_tile_test={on}", {}, {"exact_tile_test": on})
                   for on in (True, False)],
    "payload": [(f"payload_f16={on}", {}, {"payload_f16": on}) for on in (True, False)],
    "impl": [(f"rasterizer_impl={impl}", {}, {"rasterizer_impl": impl})
             for impl in ("pallas", "jax")],
}
# the JAX tool's knobs that set block parameters of the TPU kernels
TPU_ONLY = ("chunk", "scan_sub", "mxu_sigma")


@contextlib.contextmanager
def environment(variables: Dict[str, str]):
    """Set `variables` inside the block; restore each one's value (or its
    absence) after it, whatever the block raised."""
    saved = {k: os.environ.get(k) for k in variables}
    try:
        os.environ.update(variables)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sweep(knob: str, cfg: gaussians.GSRendererConfig,
          runner: Callable[[gaussians.GSRendererConfig, str], Dict]) -> List[Dict]:
    """Run `runner(config, label)` under each setting of `knob` (its
    environment set, its config fields replaced) -> the runner's results
    in order, each with its label and, past the first, "max_delta": the
    max |delta| of its "colors" against the first's."""
    results, ref = [], None
    for label, env, fields in KNOBS[knob]:
        with environment(env):
            res = dict(runner(replace(cfg, **fields), label), label=label)
        if ref is None:
            ref = res["colors"]
        else:
            res["max_delta"] = float((res["colors"] - ref).abs().max())
        results.append(res)
    return results


def parse(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_scene_args(ap, iters=3)
    ap.add_argument("--knob", nargs="+", default=list(KNOBS),
                    help=f"any of {list(KNOBS)}")
    args = ap.parse_args(argv)
    for knob in args.knob:
        if knob in TPU_ONLY:
            ap.error(f"--knob {knob} sets a block parameter of the TPU's Pallas "
                     "kernels; the card's kernels have no such parameter")
        if knob not in KNOBS:
            ap.error(f"--knob {knob}: not one of {list(KNOBS)}")
    return args


def main(argv: Optional[List[str]] = None, scene=None) -> Dict:
    """Run the sweep -> its numbers (the last line's JSON). `scene` (a
    utils/scenes.RenderScene on the run's device) skips building one."""
    args = parse(argv)
    run = ToolRun(args.device, args.iters)
    if scene is None:
        scene = scene_from_args(args, run.device)
    renderer = scene.model.gs_renderer
    base = renderer.cfg

    def runner(cfg, label):
        def render():
            return gaussians.render(renderer, scene.gs_feat, scene.images,
                                    dict(scene.preds))
        renderer.cfg = cfg
        try:
            out = render()
            ms = run.ms(render)
        finally:
            renderer.cfg = base
        isects = out["render_n_isects"][0].tolist()
        run.log(f"{label:24s}: gs_render {fmt_ms(ms)} ms  intersections a camera "
                f"{isects}, n_dropped {out['render_n_dropped'][0].tolist()}")
        return {"colors": out["rendered_colors"], "ms": ms, "n_isects": isects}

    results = {}
    with torch.no_grad():
        for knob in args.knob:
            rows = sweep(knob, base, runner)
            for r in rows[1:]:
                run.log(f"  {r['label']:22s} max |delta| against "
                        f"{rows[0]['label']}: {r['max_delta']:.3e}")
            results[knob] = [{k: v for k, v in r.items() if k != "colors"} for r in rows]
    return run.finish("render_sweep", {"views": scene.images.shape[1],
                                       "img": scene.images.shape[3],
                                       "cameras": args.cameras, "knobs": results})


if __name__ == "__main__":
    main()
