"""The program's `trunk` phase a request: the CUDA-event span that
utils/profiling.mark records around it inside infer.reconstruct, the mean
over the traced run's window."""

LAYER = "trunk: models/aggregator.py, block.py, rope.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4"]


def read(run):
    vals = [s["trunk"] for s in run.spans if "trunk" in s]
    return sum(vals) / len(vals) if vals else None
