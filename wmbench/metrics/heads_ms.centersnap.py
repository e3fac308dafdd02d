"""The two DPT heads' forward a training step: the program's spans
heads.heatmap and heads.pose (models/centersnap.py), summed; the mean over
the traced run's window."""

from wmbench.program import mean_ms

LAYER = "heads: models/dpt.py, camera_head.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    return mean_ms(run, "heads.heatmap", "heads.pose")
