"""The rows the program's binning sorts, a step, summed over the cameras:
its counter bin_rows, added once a camera by ops/tiles.bin_gaussians_packed
(on kernel K7's route the live (splat, tile) slots alone; the plain code
sorts every one of the N x TPG slots); the mean over the traced run's
window. A program without that counter gives nothing."""

from wmbench.program import mean_count, window

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "rows"
SOURCE = "program_counter"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    if not any("bin_rows" in r.counts for r in window(run)):
        return None
    return mean_count(run, "bin_rows")
