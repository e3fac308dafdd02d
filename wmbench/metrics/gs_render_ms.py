"""The program's `gs_render` phase a request: from the end of the
program's span `heads` to the end of its span `gs_render`
(utils/profiling.span in models/worldmirror.py: the splats, the
projection, the binning and the blend of every camera), the CUDA events
that profiling.request hands the harness's marks list; the mean over the
traced run's window."""

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    vals = [s["gs_render"] for s in run.spans if "gs_render" in s]
    return sum(vals) / len(vals) if vals else None
