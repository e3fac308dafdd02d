"""Shared helpers for the PyTorch/CUDA port's CPU tests (test_torch_port_*).

Each test feeds the same numpy inputs, made from a seed, through the JAX
function (on the CPU, as the rest of the suite runs it) and through its
counterpart in hunyuanworld_mirror_tpu_torch with device="cpu", where every
kernel wrapper takes its plain PyTorch version.
"""

import numpy as np
import torch

# six xdist workers share the machine: keep each one's intra-op pool small
torch.set_num_threads(2)


def uniform(seed: int, shape, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def t(a) -> torch.Tensor:
    """numpy -> f32 CPU tensor."""
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def np_(x) -> np.ndarray:
    """torch tensor / JAX array -> numpy (f32 for floating types)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def tree_np(tree):
    """JAX pytree -> the same structure with (writable) numpy leaves."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_np(v) for v in tree]
    return np.array(tree)


def state_dict_np(module: torch.nn.Module):
    """A port module's state dict as numpy (the tools/convert_weights input)."""
    return {k: v.detach().cpu().float().numpy()
            for k, v in module.state_dict().items()}


def close(a, b, atol: float, rtol: float = 0.0, err_msg: str = "") -> None:
    np.testing.assert_allclose(np_(a), np_(b), atol=atol, rtol=rtol,
                               err_msg=err_msg)
