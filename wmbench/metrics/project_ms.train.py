"""The refinement step's projection: the program's span render.project
(rasterizer.prepare_camera, once a camera), summed over the cameras; the
mean over the traced run's window."""

from wmbench.program import mean_ms

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    return mean_ms(run, "render.project")
