"""Kernel K3's share of its roofline: the least time of a step's four blend
backwards (frozen k3_bytes: the entries' rows and ids, the pixel planes,
the touched splats' gradient rows, at the HBM rate) over K3's device time
a step (raster_flat_bwd_kernel)."""

from wmbench.trace import device_seconds

LAYER = "kernel K3: ops/rasterizer.py RasterizeFlat, csrc/rasterize_flat_bwd.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"
WORKLOADS = ["refine.gsplat.s4"]


def read(run):
    if run.trace is None or run.spec is None or "k3_bytes" not in run.work:
        return None
    spent = device_seconds(run.trace, "raster_flat_bwd_kernel")
    if spent <= 0:
        return None
    steps = run.traffic["trace_requests"]
    return 100.0 * run.work["k3_bytes"] * steps / run.spec.hbm_bytes_per_s / spent
