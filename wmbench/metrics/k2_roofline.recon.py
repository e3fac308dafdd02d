"""Kernel K2's share of its roofline in the reconstruction's render: the
least time of each profiled request's blends (frozen rasterizer_bytes of
the entries each camera takes, counted by the benchmark's plain rule from
the request's splats, at the HBM rate) over K2's device time
(raster_flat_kernel)."""

from wmbench.frozen.arith import k2_bytes
from wmbench.trace import device_seconds

LAYER = "kernel K2: ops/rasterizer_flat.py, csrc/rasterize_flat_fwd.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    if run.trace is None or run.spec is None or not run.work.get("n_isects"):
        return None
    spent = device_seconds(run.trace, "raster_flat_kernel")
    if spent <= 0:
        return None
    w = run.work
    nbytes = sum(k2_bytes(n, w["pixels"], w["d_channels"])
                 for cams in w["n_isects"] for n in cams)
    return 100.0 * nbytes / run.spec.hbm_bytes_per_s / spent
