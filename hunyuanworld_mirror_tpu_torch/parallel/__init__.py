"""parallel of the PyTorch/CUDA port: the (data, view, model) mesh of
process groups, its collectives, ring attention and tensor parallelism."""
