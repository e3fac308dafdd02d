"""The q/k normalisation calls the program runs through kernel K8's route,
a request (48 at S=4 and S=32: the 48 trunk blocks' q/k norm and RoPE):
its counter norm_fused, counted once a bf16 q/k norm-and-RoPE call by
ops/trunk_norm on either device; the mean over the traced run's window. A
program without that counter gives nothing."""

from wmbench.program import mean_count, window

LAYER = "trunk: models/aggregator.py, block.py, rope.py"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "frames_per_s"
WORKLOADS = ["recon.large.s4", "recon.large.s32"]


def read(run):
    if not any("norm_fused" in r.counts for r in window(run)):
        return None
    return mean_count(run, "norm_fused")
