"""The splats' making a request: the program's span gs_render.splats (the
Gaussian head conv, prepare_splats, the confidence filter, voxel_prune,
compact_splats); the mean over the traced run's window."""

from wmbench.program import mean_ms

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    return mean_ms(run, "gs_render.splats")
