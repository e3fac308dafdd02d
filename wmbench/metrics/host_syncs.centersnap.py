"""The program's host syncs a training step: its counter host_syncs,
counted at each call that makes the host wait on the card (the batch's
pageable uploads, the RoPE tables, the normalisation constants); the mean
over the traced run's window."""

from wmbench.program import mean_count

LAYER = "host: the Python that enqueues the kernels and waits on the card"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    return mean_count(run, "host_syncs")
