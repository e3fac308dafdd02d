"""The whole refinement step's share of the chip's peak: the step's least
time (frozen refine_step_bytes at 3.35 TB/s: the step is bound by bytes,
its operations take less) over the traced run's mean step time."""

LAYER = "training step: training/splat_opt.py make_train_step, training/losses.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    if run.spec is None or not run.latencies or "step_bytes" not in run.work:
        return None
    mean_s = sum(run.latencies) / len(run.latencies)
    return 100.0 * run.work["step_bytes"] / run.spec.hbm_bytes_per_s / mean_s
