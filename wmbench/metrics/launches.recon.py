"""Kernel launches a request: the kernels in the profiled stretch's device
trace over its requests."""

LAYER = "host: the Python that enqueues the kernels and waits on the card"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4"]


def read(run):
    if run.trace is None or run.spec is None or run.trace.launches <= 0:
        return None
    return run.trace.launches / run.traffic["trace_requests"]
