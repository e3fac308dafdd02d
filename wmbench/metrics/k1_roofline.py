"""Kernel K1's share of its roofline: the least time of a request's
attention calls (frozen attention_flops at the cell's shapes, at the bf16
peak, the camera head's f32 calls at the f32 peak) over K1's device time a
request in the profiled stretch (kernels attn_bf16_kernel, attn_f32*)."""

from wmbench.frozen.arith import attention_flops
from wmbench.trace import device_seconds

LAYER = "kernel K1: ops/attention.py, csrc/attention_fwd.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    if run.trace is None or run.spec is None or "attention_calls" not in run.work:
        return None
    spent = device_seconds(run.trace, "attn_bf16_kernel", "attn_f32")
    if spent <= 0:
        return None
    least = sum(c.count * attention_flops(c.B, c.N, c.H, c.D)
                / (run.spec.peak_flops_bf16 if c.dtype == "bf16" else run.spec.peak_flops_f32)
                for c in run.work["attention_calls"])
    return 100.0 * least * run.traffic["trace_requests"] / spent
