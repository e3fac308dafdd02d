"""The whole forward's share of the chip's bf16 dense peak: the frozen
model_flops (encoder, trunk and heads, the convolutions counted directly)
a request over the traced run's mean request time, over 989 TFLOP/s. No
convolution algorithm doing fewer operations than counted can push it past
100%: every operation is counted at the highest peak."""

LAYER = "model step: models/worldmirror.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    if run.spec is None or not run.latencies or "model_flops" not in run.work:
        return None
    mean_s = sum(run.latencies) / len(run.latencies)
    return 100.0 * run.work["model_flops"] / mean_s / run.spec.peak_flops_bf16
