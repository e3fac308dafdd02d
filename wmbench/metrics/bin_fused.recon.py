"""The cameras the program bins through kernel K7's route, a request (4
at S=4 and 32 at S=32 on that route): its counter bin_fused, counted once
a camera by ops/tiles.bin_gaussians_packed on either device; the mean over
the traced run's window. A program without that counter gives nothing."""

from wmbench.program import mean_count, window

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    if not any("bin_fused" in r.counts for r in window(run)):
        return None
    return mean_count(run, "bin_fused")
