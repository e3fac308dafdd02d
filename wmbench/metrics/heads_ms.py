"""The program's `heads` phase a request: from the end of the program's
span `trunk` to the end of its span `heads` (utils/profiling.span in
models/worldmirror.py: the camera head and the four DPT heads), the CUDA
events that profiling.request hands the harness's marks list; the mean
over the traced run's window."""

LAYER = "heads: models/dpt.py, camera_head.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    vals = [s["heads"] for s in run.spans if "heads" in s]
    return sum(vals) / len(vals) if vals else None
