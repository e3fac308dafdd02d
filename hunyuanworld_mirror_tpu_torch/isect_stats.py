"""Tile intersections a camera under the exact binning variants, on the card.

    python -m hunyuanworld_mirror_tpu_torch.isect_stats [--views 4] [--img 518]
        [--tile 16] [--seed 0] [--cameras fixed|predicted] [--preset large]
    python -m hunyuanworld_mirror_tpu_torch.isect_stats --device cpu --preset tiny --img 56

The port's twin of tools/isect_stats.py. On the compacted splats of one
scene (`utils/scenes.render_scene`, the fixed cameras by default; the
splats as gaussians.render makes them), each camera's projection
(rasterizer.prepare_camera, untightened radii) gives, summed over the
splats:
  aabb      the tiles of the projection's 3.33-sigma boxes;
  tight     the tiles of the opacity-tight boxes (tiles.opacity_tight_radii);
  ellipse   the tight boxes' cells whose rect of pixel centres meets the
            splat's alpha >= 1/255 level set, sigma <= ln(255 op): the
            exact rect-against-conic minimum (tiles._rect_sigma_min, in
            f64 as the JAX tool's numpy evaluates it), the first 32 cells
            of each box, as the JAX tool counts;
  binned    the same cells under the binning's own test
            (tiles._conic_slot_mask: f32, a margin of 1e-3 on the level).
Exact semantics in each: the blend masks every pixel outside the level
set. The exact-cover histogram (ellipse cells a splat, 11 for 11 or more)
and the fraction of splats needing slot >= k say how many of each
splat's max_tiles_per_gauss slots the scene fills.

Beside the counts it renders the same splats (gaussians.rasterize_splats:
the flat route, max_tiles_per_gauss 4, max_per_tile 4096) and prints the
render's own render_n_isects and n_dropped. They relate so: the render
gives each splat max_tiles_per_gauss slots over its tight box in row-major
order and keeps a slot's cell where the binning's test passes, then caps
each tile's list at max_per_tile; n_dropped counts the box cells past the
slots and the entries past the cap. So n_isects <= binned, with equality
where n_dropped is 0; ellipse <= tight <= aabb; binned differs from
ellipse only by the margin and f32 rounding, so binned >= ellipse on any
real scene but not by construction (the tool raises if one of the first
three relations fails).

Counts need no timing: the numbers are exact integers on any device. Every
line carries the card's name and power limit, and the last line is one
JSON object with all the numbers. The JAX tool renders the model's
predicted cameras (here --cameras predicted). Runs on the card; without one
it raises unless given --device cpu, which rehearses on the plain versions.
"""

import argparse
from dataclasses import replace
from typing import Dict, List, Optional

import torch

from .models import gaussians
from .ops import projection, rasterizer, tiles
from .utils.profiling import ToolRun
from .utils.scenes import add_scene_args, scene_from_args

MAX_CELLS = 32
HIST_BINS = 12


def intersection_counts(means2d, conics, radii, opacities, tile_size: int,
                        tile_width: int, tile_height: int) -> Dict[str, torch.Tensor]:
    """One camera's counts from its projection (means2d (N, 2), conics (N,
    3), untightened radii (N, 2), opacities (N,)) -> {"aabb", "tight",
    "ellipse", "binned"} totals and "per_splat" (N,) ellipse cells."""
    ts, tw, th = tile_size, tile_width, tile_height
    aabb = tiles._tile_boxes(means2d, radii, ts, tw, th)
    tight_r = tiles.opacity_tight_radii(radii, opacities)
    txm, tym, bw, cover, valid = tiles._tile_boxes(means2d, tight_r, ts, tw, th)
    cover = torch.where(valid, cover, torch.zeros_like(cover))
    u, v = means2d[:, 0], means2d[:, 1]
    planes = tiles.conic_test_planes(conics, opacities)
    u64, v64, a64, b64, c64 = (x.double() for x in (u, v, *planes[:3]))
    lvl64 = planes[3].double()
    n_ell = torch.zeros_like(cover, dtype=torch.int64)
    n_bin = torch.zeros_like(n_ell)
    for j in range(min(int(cover.max()) if cover.numel() else 0, MAX_CELLS)):
        has = j < cover
        jx, jy = txm + j % bw, tym + torch.div(j, bw, rounding_mode="floor")
        x0, y0 = jx.double() * ts + 0.5, jy.double() * ts + 0.5
        x1, y1 = (jx + 1).double() * ts - 0.5, (jy + 1).double() * ts - 0.5
        smin = tiles._rect_sigma_min(u64, v64, a64, b64, c64, x0, x1, y0, y1)
        n_ell += (has & (smin <= lvl64)).to(torch.int64)
        n_bin += (has & tiles._conic_slot_mask(planes, jx, jy, u, v, ts)).to(torch.int64)
    aabb_cover = torch.where(aabb[4], aabb[3], torch.zeros_like(aabb[3]))
    return {"aabb": aabb_cover.to(torch.int64).sum(), "tight": cover.to(torch.int64).sum(),
            "ellipse": n_ell.sum(), "binned": n_bin.sum(), "per_splat": n_ell}


def cover_histogram(per_splat: torch.Tensor):
    """(counts of splats with 0..10 and >= 11 ellipse cells, the fraction
    needing slot >= k for k = 0..11)."""
    hist = torch.bincount(torch.clamp_max(per_splat, HIST_BINS - 1),
                          minlength=HIST_BINS)
    frac = hist.double() / hist.sum()
    return hist, torch.flip(torch.cumsum(torch.flip(frac, [0]), 0), [0])


def main(argv: Optional[List[str]] = None, scene=None) -> Dict:
    """Count -> the numbers (the last line's JSON). `scene` (a
    utils/scenes.RenderScene on the run's device) skips building one."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_scene_args(ap, iters=None)
    ap.add_argument("--tile", type=int, default=16)
    args = ap.parse_args(argv)
    run = ToolRun(args.device)
    if scene is None:
        scene = scene_from_args(args, run.device)
    B, S, H, W, _ = scene.images.shape
    cfg = scene.cfg.gs_renderer
    ts = args.tile
    tw, th = -(-W // ts), -(-H // ts)
    with torch.no_grad():
        splats = gaussians.render(scene.model.gs_renderer, scene.gs_feat, scene.images,
                                  dict(scene.preds), do_render=False)["splats"]
        sp = {k: splats[k][0] for k in gaussians.SPLAT_KEYS}
        w2c, Ks = gaussians.camera_matrices(scene.preds["camera_params"], B, S, H, W)
        _, _, meta = gaussians.rasterize_splats(replace(cfg, tile_size=ts), sp, w2c[0], Ks[0],
                                                W, H, run.device)
        quats = sp["quats"][:, [1, 2, 3, 0]]
        covars = projection.quat_scale_to_covar_planes(quats, sp["scales"])
        per_cam, per_splat = [], []
        for c in range(S):
            s = rasterizer.prepare_camera(sp["means"], covars, sp["opacities"], sp["sh"],
                                          w2c[0, c], Ks[0, c], W, H, tight_radius=False)
            counts = intersection_counts(s.means2d, s.conics, s.radii, s.opacities,
                                         ts, tw, th)
            per_splat.append(counts.pop("per_splat"))
            per_cam.append({k: int(x) for k, x in counts.items()})
    N = sp["means"].shape[0]
    n_isects, n_dropped = meta["n_isects"].tolist(), meta["n_dropped"].tolist()
    run.log(f"S={S} img={W} N={N} splats a view, tile {ts}, cameras {args.cameras}")
    for c, cnt in enumerate(per_cam):
        run.log(f"camera {c}: aabb {cnt['aabb']}  tight {cnt['tight']} "
                f"({100 * cnt['tight'] / max(cnt['aabb'], 1):.1f}%)  ellipse "
                f"{cnt['ellipse']} ({100 * cnt['ellipse'] / max(cnt['aabb'], 1):.1f}%)  "
                f"binned {cnt['binned']}; the render: n_isects {n_isects[c]}, "
                f"n_dropped {n_dropped[c]}")
        if not cnt["ellipse"] <= cnt["tight"] <= cnt["aabb"]:
            raise AssertionError(f"isect_stats: camera {c}: not ellipse <= tight <= aabb")
        if not (n_isects[c] <= cnt["binned"]
                and (n_dropped[c] or n_isects[c] == cnt["binned"])):
            raise AssertionError(f"isect_stats: camera {c}: the render's n_isects "
                                 f"{n_isects[c]} against binned {cnt['binned']}, "
                                 f"n_dropped {n_dropped[c]}")
    hist, tail = cover_histogram(torch.cat(per_splat))
    frac = (hist.double() / hist.sum()).tolist()
    mean = {k: sum(c[k] for c in per_cam) / S for k in per_cam[0]}
    run.log("intersections a camera: " + "  ".join(f"{k} {v:.0f}" for k, v in mean.items())
            + f"; the render's n_isects {sum(n_isects) / S:.0f}")
    run.log("exact-cover histogram (cover k: fraction): " + " ".join(
        f"{k}:{f:.4f}" for k, f in enumerate(frac) if f > 0))
    run.log("fraction needing slot >= k: " + " ".join(
        f"{k}:{tail[k]:.4f}" for k in range(1, 10)))
    return run.finish("isect_stats", {
        "views": S, "img": W, "tile": ts, "cameras": args.cameras, "splats": N,
        "per_camera": per_cam, "mean": mean, "render_n_isects": n_isects,
        "render_n_dropped": n_dropped, "hist": hist.tolist(),
        "slot_tail": tail[1:10].tolist()})


if __name__ == "__main__":
    main()
