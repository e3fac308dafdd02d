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
`import_state`).

The counterpart of the JAX package's orbax checkpointer (`save_orbax` /
`load_orbax`, multi-host) is `save_sharded` / `load_sharded`: a directory
of one npz a model rank (`model_<m>.npz`, written by the ranks of data and
view index 0) and `index.json`. Each rank writes its tensor-parallel shards
and rank 0 the replicated parameters, so every parameter (and Adam moment)
is stored once; the index records each one's global shape, dtype and split
(parallel/sharding.py). It loads onto a model sharded over any model axis
size, or onto one process as the whole state dict.
"""

import json

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


def save_sharded(path: str, model: torch.nn.Module, mesh, step: Optional[int] = None,
                 optimizer=None) -> str:
    """Every rank of `mesh` calls this: write the model shard_model sliced
    (and the AdamWCosine's moments and counts) into the directory `path`."""
    import torch.distributed as dist
    specs = getattr(model, "tp_specs", {})
    m, parts = mesh.index("model"), mesh.size("model")
    tensors = {f"param/{k}": v for k, v in model.state_dict().items()}
    counts = None
    if optimizer is not None:
        adam_count, sched_count, mu, nu = optimizer.export_state()
        tensors.update({f"mu/{k}": v for k, v in mu.items()})
        tensors.update({f"nu/{k}": v for k, v in nu.items()})
        counts = [adam_count, sched_count]
    if mesh.index("data") == 0 and mesh.index("view") == 0:
        os.makedirs(path, exist_ok=True)
        mine = {k: v.detach().cpu().float().numpy() for k, v in tensors.items()
                if k.split("/", 1)[1] in specs or m == 0}
        np.savez(os.path.join(path, f"model_{m}.npz"), **mine)
    if mesh.rank == 0:
        index = {"model_ranks": parts, "step": step, "opt_counts": counts,
                 "tensors": {}}
        for k, v in tensors.items():
            kind = specs.get(k.split("/", 1)[1])
            shape = list(v.shape)
            if kind == "qkv" or kind == "rows":
                shape[0] *= parts
            elif kind == "cols":
                shape[1] *= parts
            index["tensors"][k] = {"shape": shape, "dtype": str(v.dtype).split(".")[-1],
                                   "split": kind}
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump(index, f, indent=1)
    if dist.is_initialized():
        dist.barrier()
    return path


def _load_whole(path: str):
    """index and every tensor of a sharded checkpoint, put back together."""
    from ..parallel.sharding import unshard_tensors
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    files = []
    for m in range(index["model_ranks"]):
        with np.load(os.path.join(path, f"model_{m}.npz")) as data:
            files.append({k: data[k] for k in data.files})
    whole = {}
    for k, meta in index["tensors"].items():
        if meta["split"] is None:
            a = torch.from_numpy(files[0][k])
        else:
            a = unshard_tensors([torch.from_numpy(f[k]) for f in files], meta["split"])
        if list(a.shape) != meta["shape"]:
            raise ValueError(f"{k}: {tuple(a.shape)} in the files, {meta['shape']} "
                             "in the index")
        whole[k] = a.to(getattr(torch, meta["dtype"]))
    return index, whole


def load_sharded(path: str, model: Optional[torch.nn.Module] = None, mesh=None,
                 optimizer=None):
    """A save_sharded directory -> without a model: (the whole state dict,
    step), on one process. With a model (sliced for `mesh` by
    sharding.shard_model, or unsliced without one): its parameters (and the
    optimizer's moments and counts) loaded in place -> the step."""
    from ..parallel.sharding import shard_tensor
    index, whole = _load_whole(path)
    params = {k[len("param/"):]: v for k, v in whole.items() if k.startswith("param/")}
    if model is None:
        return params, index["step"]
    specs = getattr(model, "tp_specs", {})

    def mine(name, t):
        kind = specs.get(name)
        return t if kind is None else shard_tensor(t, kind, mesh.index("model"),
                                                   mesh.size("model"))

    model.load_state_dict({k: mine(k, v) for k, v in params.items()})
    if optimizer is not None and index["opt_counts"] is not None:
        mu = {n: mine(n, whole[f"mu/{n}"]) for n in params if f"mu/{n}" in whole}
        nu = {n: mine(n, whole[f"nu/{n}"]) for n in params if f"nu/{n}" in whole}
        optimizer.import_state(*index["opt_counts"], mu, nu)
    return index["step"]
