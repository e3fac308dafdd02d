"""A request's host-clock time minus its CUDA-event span from the program's
`start` mark to its last mark: the upload, the Python around the forward
and the final synchronisation; the mean over the traced run's window."""

LAYER = "entry: infer.reconstruct"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    pairs = [(1e3 * t, sum(s.values())) for t, s in zip(run.latencies, run.spans) if s]
    return sum(t - d for t, d in pairs) / len(pairs) if pairs else None
