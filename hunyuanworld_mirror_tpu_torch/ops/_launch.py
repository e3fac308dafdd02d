"""The kernel wrappers' shared plumbing: the device check that picks the
plain version or the kernel, and the call of a ctypes C entry on the
current stream. Nothing here builds or loads at import time."""

import ctypes

import torch

from . import _build

_SIGNATURES_SET = set()


def launch(source: str, fn: str, argtypes, dev: torch.device, *args) -> None:
    """Call the C entry `fn` of csrc/<source>.cu on dev's current stream
    (building the library at first use); raise if the launch was refused."""
    f = getattr(_build.load(source), fn)
    if fn not in _SIGNATURES_SET:
        f.argtypes = list(argtypes) + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _SIGNATURES_SET.add(fn)
    with torch.cuda.device(dev):
        rc = f(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc}")


def check_device(x: torch.Tensor, fn: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for CUDA (the
    kernel runs); anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cuda or cpu, not {x.device}")
    return x.device.type == "cpu"
