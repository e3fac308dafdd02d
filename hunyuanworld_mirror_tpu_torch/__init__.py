"""WorldMirror in PyTorch and CUDA for one NVIDIA H100.

The second implementation of `hunyuanworld_mirror_tpu` (the JAX package,
which stays the reference). The layout mirrors it module for module
(`models/`, `ops/`, `utils/`, `io/`); parameters carry the reference torch
`state_dict` names, so the public release's weights load directly and
`tools/convert_weights.convert_worldmirror` maps this package's state dict
onto the JAX pytree.

The softmax attention core and the flat tile-rasterizer's forward and
backward are CUDA kernels written by hand for sm_90a (`csrc/`), built with
nvcc at first use into `build/kernels/` at the repository root
(`ops/_build.py`). Each kernel wrapper takes its plain PyTorch version only
for a tensor on the CPU.

Float32 precision is set HERE, once, for the whole package: TF32 is off for
both matmuls and cuDNN convolutions, so the f32 heads compute what the JAX
reference computes (TF32 keeps about three decimal digits; cuDNN's flag
defaults to on).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Without an explicit device on a machine with no GPU this raises; the
    entry points never carry on silently on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch path on the CPU")
    return torch.device("cuda")
