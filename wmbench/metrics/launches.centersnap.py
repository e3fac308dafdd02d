"""Kernel launches a step: the kernels in the profiled stretch's device
trace over its steps."""

LAYER = "host: the Python that enqueues the kernels and waits on the card"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    if run.trace is None or run.spec is None or run.trace.launches <= 0:
        return None
    return run.trace.launches / run.traffic["trace_requests"]
