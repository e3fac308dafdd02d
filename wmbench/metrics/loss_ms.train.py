"""The refinement step's loss: the program's span loss inside
render_forward (L1 + SSIM and the regularisers); the mean over the traced
run's window."""

from wmbench.program import mean_ms

LAYER = "training step: training/splat_opt.py make_train_step, training/losses.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    return mean_ms(run, "loss")
