"""The frozen DINOv3 backbone's time a training step: the program's span
encoder (models/aggregator.py: the images' normalisation and the ViT's
forward, no gradient); the mean over the traced run's window."""

from wmbench.program import mean_ms

LAYER = "encoder: models/dinov2.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    return mean_ms(run, "encoder")
