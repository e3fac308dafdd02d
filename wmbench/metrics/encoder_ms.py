"""The program's `encoder` phase a request: from the request's start to the
end of the program's span `encoder` (utils/profiling.span in models/
aggregator.py), the CUDA events that profiling.request hands the
harness's marks list; the mean over the traced run's window."""

LAYER = "encoder: models/dinov2.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    vals = [s["encoder"] for s in run.spans if "encoder" in s]
    return sum(vals) / len(vals) if vals else None
