"""The check's two readings on the card: the program's numbers and the
control's, seed by seed, at the cell's own size.

    python3 -m wmbench.control --workload recon.large.s4 \
        --program-seeds 11,12,... --control-seeds 21,22,23

For each program seed the cell is built as a run builds it, every sampled
scene is requested once through the timed entry, the program is freed and
the check runs: those are sound runs, whose largest number sets a limit's
lower reading. For each control seed the reference is put in the
program's place one precision step lower (reference/precision.CONTROL: fp8
trunk, TF32 heads and SSIM, bf16 render) and judged by the same check:
its smallest number sets the upper reading. One JSON line a seed, with
the card's peak allocation over the check (a control seed: over the
control and the check); the benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import sys
import time

import torch

from wmbench import run


def program_numbers(parts, seed: int, device: str) -> dict:
    gen = importlib.import_module(f"wmbench.traffic.{parts.traffic['kind']}")
    system = importlib.import_module(f"wmbench.systems.{parts.cfg['system']}")
    cell = system.build(parts.cfg, parts.traffic, seed, device, gen)
    cell.log = lambda text: print(text, file=sys.stderr, flush=True)
    for i in cell.check_requests:
        cell.request(i, None)
    cell.close()
    if device == "cuda":   # the peak printed beside the numbers is the check's own
        torch.cuda.reset_peak_memory_stats()
    nums = cell.check()
    del cell
    return nums


def control_numbers(parts, seed: int, device: str) -> dict:
    gen = importlib.import_module(f"wmbench.traffic.{parts.traffic['kind']}")
    system = importlib.import_module(f"wmbench.systems.{parts.cfg['system']}")
    return system.control_numbers(parts.cfg, parts.traffic, seed, device, gen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.cache_env(run.ROOT)
    parts = run.cell_parts(run.manifest(), args.workload)
    seeds = [("program", int(s)) for s in args.program_seeds.split(",") if s]
    seeds += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for side, seed in seeds:
        t0 = time.perf_counter()
        fn = program_numbers if side == "program" else control_numbers
        nums = fn(parts, seed, args.device)
        line = {"side": side, "seed": seed, "numbers": nums,
                "seconds": time.perf_counter() - t0}
        if args.device == "cuda":
            line["check_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
