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


def splat_table(splats, b: int) -> np.ndarray:
    """Batch b's live splats (weight > 0) as one row each: means, quats,
    scales, opacity, SH, weight."""
    sp = {k: np_(v)[b] for k, v in splats.items() if k != "n_compact_dropped"}
    live = sp["weights"] > 0
    n = int(live.sum())
    return np.concatenate([sp["means"][live], sp["quats"][live], sp["scales"][live],
                           sp["opacities"][live][:, None], sp["sh"][live].reshape(n, -1),
                           sp["weights"][live][:, None]], axis=1)


def close_splat_sets(ours, ref, atol: float, rtol: float = 0.0,
                     flip_frac: float = 0.0) -> None:
    """The live splats of every batch element agree as sets of rows: the
    slot order of a voxel merge is the implementation's own, the set is
    not. Each reference row is paired with its nearest row of ours over all
    columns, and the pairing must be one to one.

    flip_frac > 0 is for splats merged from two forwards whose means differ
    by f32 rounding: a mean on a voxel edge can floor into the neighbour
    and change which splats merge (test_full_model_parity.compare_geometry
    allows the same). Then at most max(4, flip_frac * rows) rows may miss
    the band, the populations differ by no more, and every other row is
    held to it, paired one to one."""
    from scipy.spatial import cKDTree
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    for b in range(np_(ref["means"]).shape[0]):
        tab_o, tab_r = splat_table(ours, b), splat_table(ref, b)
        if flip_frac == 0.0:
            assert tab_o.shape == tab_r.shape, (b, tab_o.shape, tab_r.shape)
            _, idx = cKDTree(tab_o).query(tab_r)
            assert len(set(idx.tolist())) == len(idx), f"b={b}: rows paired twice"
            close(tab_o[idx], tab_r, atol, rtol, err_msg=f"b={b}")
            continue
        budget = max(4, int(flip_frac * len(tab_r)))
        assert abs(len(tab_o) - len(tab_r)) <= budget, (b, len(tab_o), len(tab_r))
        _, idx = cKDTree(tab_o).query(tab_r)
        ok = np.all(np.abs(tab_o[idx] - tab_r) <= atol + rtol * np.abs(tab_r), axis=1)
        assert int((~ok).sum()) <= budget, (b, int((~ok).sum()), budget)
        assert len(set(idx[ok].tolist())) == int(ok.sum()), f"b={b}: rows paired twice"
