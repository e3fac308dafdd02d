"""The device's idle share over the profiled stretch: 1 minus the union of
its kernels, copies and fills over the stretch's host-clock length."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"
WORKLOADS = ["train.centersnap.b20"]


def read(run):
    if run.trace is None or run.spec is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
