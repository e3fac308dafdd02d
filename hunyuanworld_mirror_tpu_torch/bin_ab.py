"""The flat binning on the card, split into its pieces.

    python -m hunyuanworld_mirror_tpu_torch.bin_ab [--n 537088] [--cams 4]
        [--tpg 4] [--iters 5] [--seed 0]
    python -m hunyuanworld_mirror_tpu_torch.bin_ab --device cpu --n 4096 --cams 2

The port's twin of tools/bin_ab.py. It times the plain flat binning,
`ops/tiles.bin_gaussians_packed_plain`, cumulatively by its own pieces, and
kernel K7's route beside it, in ms a camera over --cams cameras:
  keys              _isect_keys (tile boxes, slot tiles, quantized depth);
  keys+sort         + _sort_slots (one torch.sort of the packed 64-bit key
                    key32 << 32 | flat slot index);
  keys+sort+edges   + _segments (the tiles' segments by searchsorted);
  full_bin          bin_gaussians_packed_plain itself, whose last piece is
                    _gather (the payload planes by the sorted slots);
  fused             bin_gaussians_packed: on the card kernel K7, the live
                    slots alone (its plain version on the CPU).
The pieces composed are checked against bin_gaussians_packed_plain bit for
bit (every field of the FlatBins), and the fused list against the plain
one's live prefix (starts, counts, n_dropped and the rows of its length);
the tool raises otherwise. The inputs are
the JAX tool's synthetic ones, drawn from --seed with numpy: N splat
centres uniform over a 518 px image, integer radii 1-12 px, depths
uniform in [0.1, 10.1], 5 payload planes, tile 16, no ellipse test, a
camera's own draw each. --tpg defaults to 4, the main path's
max_tiles_per_gauss (2.15M rows a camera); 9 is the JAX tool's (4.83M).
The tiles' list cap is the main path's, 4096 (the JAX tool's 8192).

Each time is `utils/profiling.time_fn`'s median of --iters calls after one
warm-up, each call ended by torch.cuda.synchronize (the JAX tool's in-jit
repeat harness and relay floor have no counterpart); every line carries the
card's name and power limit, and the last line is one JSON object with all
the numbers. Runs on the card; without one it raises unless given --device
cpu, which rehearses at the given sizes and prints every time as null.
"""

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from .ops import tiles
from .utils.profiling import ToolRun, fmt_ms
from .utils.scenes import RENDER_MPT

W = H = 518
TILE = 16
N_PAYLOAD = 5


def synthetic_camera(n: int, rng: np.random.Generator, device):
    """One camera's binning inputs as numpy draws: (means2d (n, 2), radii
    (n, 2) int32, depths (n,), payload planes)."""
    m2d = rng.uniform(size=(n, 2)).astype(np.float32) * np.float32([W, H])
    rad = (rng.uniform(size=(n, 2)) * 12 + 1).astype(np.int32)
    dep = (rng.uniform(size=n) * 10 + 0.1).astype(np.float32)
    vals = [rng.normal(size=n).astype(np.float32) for _ in range(N_PAYLOAD)]
    return tuple(torch.as_tensor(a, device=device) for a in (m2d, rad, dep, *vals))


def pieces(tpg: int, mpt: int = RENDER_MPT):
    """The cumulative pieces as functions of one camera's (means2d, radii,
    depths, *values) -> a dict of what the piece made."""
    tw, th = -(-W // TILE), -(-H // TILE)
    n_tiles = tw * th
    db = tiles.depth_bits_for(n_tiles)

    def keys(m2d, rad, dep, *vals):
        key, n_cover, valid = tiles._isect_keys(m2d, rad, dep, TILE, tw, th, tpg, db)
        return {"key": key, "n_cover": n_cover, "valid": valid}

    def keys_sort(m2d, rad, dep, *vals):
        out = keys(m2d, rad, dep)
        out["key32"], out["slot"] = tiles._sort_slots(out["key"])
        return out

    def keys_sort_edges(m2d, rad, dep, *vals):
        out = keys_sort(m2d, rad, dep)
        cells = torch.arange(n_tiles + 1, dtype=torch.int64, device=m2d.device)
        out["starts"], out["counts"], out["clamped"] = tiles._segments(
            out["key32"], cells, db, mpt)
        return out

    def composed(m2d, rad, dep, *vals):
        out = keys_sort_edges(m2d, rad, dep)
        gauss = out["slot"] % m2d.shape[0]
        return tiles.FlatBins(
            tiles._gather(vals, gauss), out["starts"].to(torch.int32),
            out["counts"].to(torch.int32),
            out["clamped"] + tiles._lost_to_tpg(out["n_cover"], out["valid"], tpg))

    def full_bin(m2d, rad, dep, *vals):
        return tiles.bin_gaussians_packed_plain(m2d, rad, dep, vals, TILE, tw, th, tpg,
                                                mpt)

    def fused(m2d, rad, dep, *vals):
        return tiles.bin_gaussians_packed(m2d, rad, dep, vals, TILE, tw, th, tpg, mpt)

    return {"keys": keys, "keys+sort": keys_sort, "keys+sort+edges": keys_sort_edges,
            "full_bin": full_bin, "fused": fused}, composed


def bins_equal(a: tiles.FlatBins, b: tiles.FlatBins) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))


def live_prefix_equal(fused: tiles.FlatBins, plain: tiles.FlatBins) -> bool:
    """The fused list against the plain one's first rows, as many as it
    has: the payload's bits, the segments and the drops."""
    n = fused.packed.shape[1]
    return (bins_equal(fused[1:4], plain[1:4]) and torch.equal(
        fused.packed.view(torch.int32), plain.packed[:, :n].view(torch.int32)))


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=537088)
    ap.add_argument("--cams", type=int, default=4)
    ap.add_argument("--tpg", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to rehearse without a card (every time null)")
    args = ap.parse_args(argv)
    run = ToolRun(args.device, args.iters)
    rng = np.random.default_rng(args.seed)
    cams = [synthetic_camera(args.n, rng, run.device) for _ in range(args.cams)]
    steps, composed = pieces(args.tpg)
    plain = [steps["full_bin"](*c) for c in cams]
    equal = all(bins_equal(composed(*c), p) for c, p in zip(cams, plain))
    fused = [steps["fused"](*c) for c in cams]
    fused_equal = all(live_prefix_equal(f, p) for f, p in zip(fused, plain))
    if not (equal and fused_equal):
        raise AssertionError(f"bin_ab: the pieces composed equal bin_gaussians_packed_plain: "
                             f"{equal}; the fused list its live prefix: {fused_equal}")
    rows = args.n * args.tpg
    live = sum(f.packed.shape[1] for f in fused) / args.cams
    run.log(f"rows a camera {rows / 1e6:.2f}M ({args.n} splats x {args.tpg} slots), "
            f"{live / 1e6:.2f}M of them live, {args.cams} cameras; pieces composed equal "
            f"bin_gaussians_packed_plain and the fused list its live prefix, bit for bit")
    ms = {}
    with torch.no_grad():
        for name, fn in steps.items():
            total = run.ms(lambda: [fn(*c) for c in cams])
            ms[name] = None if total is None else total / args.cams
            run.log(f"{name:16s}: {fmt_ms(ms[name])} ms a camera")
    return run.finish("bin_ab", {"n": args.n, "cams": args.cams, "tpg": args.tpg,
                                 "rows_per_camera": rows, "live_rows_per_camera": live,
                                 "composed_equal": equal, "fused_equal": fused_equal,
                                 "ms_per_camera": ms})


if __name__ == "__main__":
    main()
