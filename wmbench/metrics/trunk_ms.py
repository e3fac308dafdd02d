"""The program's `trunk` phase a request: from the end of the program's
span `encoder` to the end of its span `trunk` (utils/profiling.span in
models/aggregator.py), the CUDA events that profiling.request hands the
harness's marks list; the mean over the traced run's window."""

LAYER = "trunk: models/aggregator.py, block.py, rope.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    vals = [s["trunk"] for s in run.spans if "trunk" in s]
    return sum(vals) / len(vals) if vals else None
