"""The binning's sort on the card: the shipped packed key against a stable
sort of the 32-bit key, and how the sort scales with rows.

    python -m hunyuanworld_mirror_tpu_torch.sort_ab2 [--n 537088] [--iters 5] [--seed 0]
    python -m hunyuanworld_mirror_tpu_torch.sort_ab2 --device cpu --n 4096

The port's twin of tools/sort_ab2.py, on the port's own sort. The shipped
binning (ops/tiles.py) sorts one int64 key, key32 << 32 | slot index
(`_sort_slots`), then gathers its payload planes by the sorted slots
(`_gather`, slot % N: a plane holds one value a splat); no payload rides
the sort. At the main path's rows (N splats x 4 slots) and the JAX tool's
(N x 9), with 6 payload planes, it times
  (a) packed         the shipped packed-key sort alone, then + gather6;
  (b) stable         torch.sort(key32, stable=True) for its indices (the
                     permutation), then + the same gather;
and (c) the packed sort alone over 1.21M, 2.15M, 2.42M and 4.83M rows
(N = 537,088). Every variant's permutation is checked against the shipped
one bit for bit, and the line says so (the tool raises on a mismatch). The
32-bit keys are drawn from --seed with numpy in [0, rows / 4), so each key
repeats about four times and the tie-break (the slot index, ascending) is
exercised. The JAX tool's payload-carrying sort has no counterpart: a
torch.sort carries no operands.

Each time is `utils/profiling.time_fn`'s median of --iters calls after one
warm-up, each call ended by torch.cuda.synchronize (the JAX tool's in-jit
repeat harness and relay floor have no counterpart); every line carries the
card's name and power limit, and the last line is one JSON object with all
the numbers. Runs on the card; without one it raises unless given --device
cpu, which rehearses at the given N and prints every time as null.
"""

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from .ops import tiles
from .utils.profiling import ToolRun, fmt_ms

N_PLANES = 6
# (c)'s rows as multiples of N: the JAX tool's 1.21M, 2.42M, 4.83M at its
# N = 537,088, and the main path's 4 slots a splat
ROW_SLOTS = (2.25, 4, 4.5, 9)


def packed_perm(key32: torch.Tensor) -> torch.Tensor:
    """The shipped permutation: _sort_slots' sorted slot indices."""
    return tiles._sort_slots(key32)[1]


def stable_perm(key32: torch.Tensor) -> torch.Tensor:
    """A stable sort of the 32-bit keys: ties keep the slot order."""
    return torch.sort(key32.reshape(-1), stable=True).indices


VARIANTS = {"packed": packed_perm, "stable": stable_perm}


def draw_keys(rows: int, rng: np.random.Generator, device) -> torch.Tensor:
    """`rows` int32 keys in [0, rows / 4): about four of each."""
    return torch.as_tensor(rng.integers(0, max(1, rows // 4), size=rows,
                                        dtype=np.int32), device=device)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=537088)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to rehearse without a card (every time null)")
    args = ap.parse_args(argv)
    run = ToolRun(args.device, args.iters)
    rng = np.random.default_rng(args.seed)
    N = args.n
    planes = [torch.as_tensor(rng.normal(size=N).astype(np.float32), device=run.device)
              for _ in range(N_PLANES)]
    out: Dict = {"n": N, "ab": {}, "rows": {}}
    with torch.no_grad():
        for tpg in (4, 9):
            rows = N * tpg
            key = draw_keys(rows, rng, run.device)
            ref = packed_perm(key)
            res = {}
            for name, perm in VARIANTS.items():
                equal = bool(torch.equal(perm(key), ref))
                if not equal:
                    raise AssertionError(f"sort_ab2: {name}'s permutation differs "
                                         "from the shipped one")

                def with_gather(perm=perm):
                    return tiles._gather(planes, perm(key) % N)

                res[name] = {"sort_ms": run.ms(perm, key),
                             "sort_gather6_ms": run.ms(with_gather), "equal": equal}
                run.log(f"{rows / 1e6:.2f}M rows  {name:6s}: sort "
                        f"{fmt_ms(res[name]['sort_ms'])} ms, + gather{N_PLANES} "
                        f"{fmt_ms(res[name]['sort_gather6_ms'])} ms  (permutation "
                        f"equals the shipped one: {equal})")
            out["ab"][rows] = res
        for slots in ROW_SLOTS:
            rows = int(N * slots)
            out["rows"][rows] = run.ms(packed_perm, draw_keys(rows, rng, run.device))
            run.log(f"packed sort at {rows / 1e6:.2f}M rows: "
                    f"{fmt_ms(out['rows'][rows])} ms")
    return run.finish("sort_ab2", out)


if __name__ == "__main__":
    main()
