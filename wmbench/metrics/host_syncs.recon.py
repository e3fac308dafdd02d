"""The program's host syncs a request: its counter host_syncs, counted at
each call that makes the host wait on the card (a readback, a
synchronising upload, an output sized by the data); the mean over the
traced run's window."""

from wmbench.program import mean_count

LAYER = "host: the Python that enqueues the kernels and waits on the card"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    return mean_count(run, "host_syncs")
