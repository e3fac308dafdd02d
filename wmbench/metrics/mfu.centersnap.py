"""The whole training step's share of the card's peaks: the step's least
time, its bf16 operations at 989 TFLOP/s plus its f32 operations at 67
TFLOP/s (frozen centersnap_arith.step_flops: the backbone's forward, the
trunk's and the depth prior's forward and backward, both heads' forward
and backward, each counted directly), over the traced run's mean step
time. An algorithm doing fewer operations than counted (cuDNN's FFT and
Winograd convolutions) is the only way past 100%."""

LAYER = "pose training step: training/trainer.py make_train_step and train_iteration, training/losses.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    if run.spec is None or not run.latencies or "flops_f32" not in run.work:
        return None
    least_s = (run.work["flops_bf16"] / run.spec.peak_flops_bf16
               + run.work["flops_f32"] / run.spec.peak_flops_f32)
    return 100.0 * least_s / (sum(run.latencies) / len(run.latencies))
