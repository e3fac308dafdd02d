"""Checkpoints with resume, in the JAX package's npz layout.

Port of hunyuanworld_mirror_tpu/training/checkpoint.py's npz format, so a
checkpoint written by either package resumes in the other:

  params/<JAX path>        the model's parameters as the JAX pytree
                           (convert.to_jax_tree: stacked blocks, HWIO convs)
  opt_state/0/0            the Adam update count (int32)
  opt_state/0/1/<JAX path> Adam's first moment, laid out as the params
  opt_state/0/2/<JAX path> Adam's second moment
  opt_state/2/0            the learning-rate schedule's count (int32)
  step                     the training step

which is how the JAX package flattens optax.adamw(cosine schedule)'s
state. The optimizer is the trainer's AdamWCosine (its `export_state` /
`import_state`). The JAX package's orbax checkpointer (multi-host) has no
counterpart here yet.
"""

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import convert


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict = {}
    for path, val in flat.items():
        *keys, leaf = path.split("/")
        node = root
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = val
    return convert._listify(root)


def save_params(path: str, model: torch.nn.Module, step: Optional[int] = None,
                optimizer=None) -> str:
    """Write `model`'s parameters (and the optimizer's state, and the step)
    to one .npz archive in the JAX package's layout."""
    flat = _flatten({"params": convert.to_jax_tree(model)})
    if optimizer is not None:
        adam_count, sched_count, mu, nu = optimizer.export_state()
        flat.update(_flatten({"opt_state": [
            [np.asarray(adam_count, np.int32), convert.to_jax_tree(model, mu),
             convert.to_jax_tree(model, nu)],
            [],
            [np.asarray(sched_count, np.int32)]]}))
    if step is not None:
        flat["step"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **flat)
    return path


def _section(path: str, prefix: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}


def load_params(path: str):
    """The params pytree of an npz checkpoint (numpy leaves, JAX layout);
    `convert.load_jax_tree(model, tree)` copies it into a model."""
    return _unflatten(_section(path, "params/"))


def load_train_state(path: str) -> Tuple[object, Optional[int]]:
    """(params pytree, step or None) for resume; the optimizer's state
    comes back through restore_opt_state."""
    with np.load(path, allow_pickle=False) as data:
        step = int(data["step"]) if "step" in data.files else None
    return load_params(path), step


def restore_opt_state(path: str, model: torch.nn.Module, optimizer) -> bool:
    """Load the checkpoint's Adam moments and counts into `optimizer` (the
    AdamWCosine over `model`); False when the checkpoint holds none."""
    flat = _section(path, "opt_state/")
    if not flat:
        return False
    tree = _unflatten(flat)
    adam, sched = tree[0], tree[2]
    mu, nu = {}, {}
    for leaf in convert.jax_leaves(model):
        mu[leaf.name] = torch.from_numpy(convert.jax_leaf(adam[1], leaf))
        nu[leaf.name] = torch.from_numpy(convert.jax_leaf(adam[2], leaf))
    optimizer.import_state(int(adam[0]), int(sched[0]), mu, nu)
    return True
