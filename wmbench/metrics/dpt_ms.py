"""The four DPT heads' time a request: the program's spans heads.depth,
heads.pts, heads.normals and heads.gs (their CUDA events; the frame-chunked
route included), summed; the mean over the traced run's window. The
camera head is heads_ms less this."""

from wmbench.program import mean_ms

LAYER = "heads: models/dpt.py, camera_head.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4"]


def read(run):
    return mean_ms(run, "heads.depth", "heads.pts", "heads.normals", "heads.gs")
