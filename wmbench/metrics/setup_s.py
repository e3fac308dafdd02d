"""Process start to the first timed request: imports, the CUDA context, the
kernels built or loaded from build/kernels/ in the checkout, the weights
made on the card, the traffic made on the host, the warm-up requests."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
