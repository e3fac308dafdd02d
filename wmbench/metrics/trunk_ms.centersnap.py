"""The depth-conditioned trunk's forward a training step: the program's
span trunk (models/aggregator.py: the depth prior's tokens and the 4
frame blocks, K1 under autograd); the mean over the traced run's window."""

from wmbench.program import mean_ms

LAYER = "trunk: models/aggregator.py, block.py, rope.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    return mean_ms(run, "trunk")
