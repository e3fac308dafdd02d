"""Kernel K2's share of its roofline in the refinement step's forward: the
least time of a step's four blends (frozen rasterizer_bytes of the entries
each camera takes, counted by the benchmark's plain rule from the
parameters at the profiled stretch's start, at the HBM rate) over K2's
device time a step (raster_flat_kernel)."""

from wmbench.trace import device_seconds

LAYER = "kernel K2: ops/rasterizer_flat.py, csrc/rasterize_flat_fwd.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    if run.trace is None or run.spec is None or "k2_bytes" not in run.work:
        return None
    spent = device_seconds(run.trace, "raster_flat_kernel")
    if spent <= 0:
        return None
    steps = run.traffic["trace_requests"]
    return 100.0 * run.work["k2_bytes"] * steps / run.spec.hbm_bytes_per_s / spent
