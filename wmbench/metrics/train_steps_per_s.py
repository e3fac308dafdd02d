"""Optimizer steps completed a second over the window (first step's start
to the last one's end), on the host clock."""

UNIT = "steps/s"
SOURCE = "host_clock"


def read(run):
    return run.units / run.window_s if run.latencies else None
