"""The 90th percentile of a request's host-clock latency over every request
of the window: numpy images on the host to the prediction dict synchronised
on the card."""

import numpy as np

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    return 1e3 * float(np.percentile(run.latencies, 90)) if run.latencies else None
