"""The benchmark of hunyuanworld_mirror_tpu_torch on NVIDIA GPUs.

`python3 -m wmbench.run --workload <name> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json (see wmbench/run.py). Each
configuration, traffic mix, check limit and metric is a file of its own
under configs/, traffic/, limits/ and metrics/, found by its name;
systems/ drive the program, reference/ is the plain PyTorch reference the
check compares with, frozen/ the yardstick's arithmetic and peaks.
Nothing here imports jax or hunyuanworld_mirror_tpu.
"""
