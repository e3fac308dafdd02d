"""The program's `gs_render` phase a request: the CUDA-event span that
utils/profiling.mark records around it inside infer.reconstruct, the mean
over the traced run's window."""

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4"]


def read(run):
    vals = [s["gs_render"] for s in run.spans if "gs_render" in s]
    return sum(vals) / len(vals) if vals else None
