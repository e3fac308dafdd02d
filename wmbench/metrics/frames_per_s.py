"""Views reconstructed a second over the window (first request's start to
the last one's end), on the host clock."""

UNIT = "frames/s"
SOURCE = "host_clock"


def read(run):
    return run.units / run.window_s if run.latencies else None
