"""The training step's `backward` phase: the CUDA-event span that
make_train_step's marks record, from the one before it; the mean over the
traced run's window."""

LAYER = "training step: training/splat_opt.py make_train_step, training/losses.py"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    vals = [s["backward"] for s in run.spans if "backward" in s]
    return sum(vals) / len(vals) if vals else None
