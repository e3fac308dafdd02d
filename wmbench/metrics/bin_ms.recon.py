"""The render's binning a request: the program's span render.bin
(rasterizer.bin_splats, once a camera), summed over the cameras; the mean
over the traced run's window."""

from wmbench.program import mean_ms

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    return mean_ms(run, "render.bin")
