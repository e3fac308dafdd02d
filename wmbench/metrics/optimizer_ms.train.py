"""The refinement step's optimizer phase: the program's span optimizer (the
dead rows' grads zeroed, the densify signal, Adam); the mean over the
traced run's window."""

from wmbench.program import mean_ms

LAYER = "training step: training/splat_opt.py make_train_step, training/losses.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    return mean_ms(run, "optimizer")
