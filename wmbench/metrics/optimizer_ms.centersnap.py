"""The training step's AdamW update of the trainable leaves: the program's
span optimizer; the mean over the traced run's window."""

from wmbench.program import mean_ms

LAYER = "pose training step: training/trainer.py make_train_step and train_iteration, training/losses.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    return mean_ms(run, "optimizer")
