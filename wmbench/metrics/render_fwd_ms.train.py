"""The training step's `render_forward` phase: the CUDA-event span that
make_train_step's marks record, from the one before it; the mean over the
traced run's window."""

LAYER = "render: models/gaussians.py, ops/projection.py, ops/tiles.py, ops/rasterizer.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    vals = [s["render_forward"] for s in run.spans if "render_forward" in s]
    return sum(vals) / len(vals) if vals else None
