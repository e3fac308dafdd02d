"""The cameras the program projects through kernel K6's route, a request (4 cameras on the fused route): its
counter project_fused, counted once a camera by
ops/projection.project_pinhole on either device; the mean over the traced
run's window. A program without that counter gives nothing."""

from wmbench.program import mean_count, window

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    if not any("project_fused" in r.counts for r in window(run)):
        return None
    return mean_count(run, "project_fused")
