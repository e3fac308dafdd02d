"""The render's blend a request: the program's span render.blend
(rasterizer.blend_flat, kernel K2's entry, once a camera), summed over
the cameras; the mean over the traced run's window."""

from wmbench.program import mean_ms

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    return mean_ms(run, "render.blend")
