"""The program's `encoder` phase a request: the CUDA-event span that
utils/profiling.mark records around it inside infer.reconstruct, the mean
over the traced run's window."""

LAYER = "encoder: models/dinov2.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4"]


def read(run):
    vals = [s["encoder"] for s in run.spans if "encoder" in s]
    return sum(vals) / len(vals) if vals else None
