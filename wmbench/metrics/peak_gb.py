"""torch.cuda.max_memory_allocated over the window, reset after warm-up."""

UNIT = "GB"
SOURCE = "device_trace"


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
