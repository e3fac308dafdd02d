"""The training step's backward: the program's span backward (the heads'
f32 convolutions' gradients, the trunk's K1 replays); the mean over the
traced run's window."""

from wmbench.program import mean_ms

LAYER = "pose training step: training/trainer.py make_train_step and train_iteration, training/losses.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    return mean_ms(run, "backward")
