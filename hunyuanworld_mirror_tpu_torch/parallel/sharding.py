"""Tensor-parallel parameters and the view and data shardings.

Port of hunyuanworld_mirror_tpu/parallel/sharding.py. JAX annotates the
parameter pytree with `TP_RULES` and lets GSPMD insert the collectives;
here `shard_model` slices the matched parameters for this rank and tells
their modules, which then run Megatron's layout:

  attn/qkv/w, mlp/fc1/w   column parallel: this rank's output features
                          (for qkv its heads, within each of q, k and v)
  attn/proj/w, mlp/fc2/w  row parallel: this rank's input features; the
                          partial products are summed over the model group
                          and the bias is added once after the sum

The rules match the JAX path of each parameter (`convert.jax_leaves`), so
they reach what JAX's reach: the trunk's frame and global blocks, the
DINOv2 encoder's blocks, the camera head's trunk and the depth prior's
patch MLP. Nothing else is sharded.

`shard_views` cuts (B, S, ...) inputs into this rank's batch and view
shard, `gather_predictions` puts a forward's outputs back together, and
`gather_state` gives the unsharded state dict.
"""

import re
from typing import Dict

import torch

from . import comm

TP_RULES = [
    (r"attn/qkv/w$", "column"),
    (r"attn/proj/w$", "row"),
    (r"mlp/fc1/w$", "column"),
    (r"mlp/fc2/w$", "row"),
    (r"patch_embed/.*blocks.*qkv/w$", "column"),
]

def shard_tensor(full: torch.Tensor, kind: str, index: int, parts: int) -> torch.Tensor:
    """Part `index` of `parts` of a full parameter split as `kind`: "qkv"
    dim 0 by heads within each of q, k and v; "rows" dim 0 and "cols" dim
    1 in contiguous parts."""
    if kind == "qkv":
        per = full.shape[0] // (3 * parts)
        return full.reshape(3, parts, per, *full.shape[1:])[:, index].reshape(
            3 * per, *full.shape[1:]).contiguous()
    dim = 0 if kind == "rows" else 1
    return full.chunk(parts, dim=dim)[index].contiguous()


def unshard_tensors(shards, kind: str) -> torch.Tensor:
    """shard_tensor's inverse: the parts in order -> the full parameter."""
    if kind == "qkv":
        per = shards[0].shape[0] // 3
        rest = shards[0].shape[1:]
        st = torch.stack([s.reshape(3, per, *rest) for s in shards], dim=1)
        return st.reshape(3 * per * len(shards), *rest)
    return torch.cat(list(shards), dim=0 if kind == "rows" else 1)


def tp_specs(model: torch.nn.Module) -> Dict[str, str]:
    """Parameter name -> split kind, for every parameter the rules shard:
    the matched weights and the biases of the column-parallel layers."""
    from .. import convert
    specs = {}
    for leaf in convert.jax_leaves(model):
        path = "/".join(leaf.path)
        rule = next((r for pat, r in TP_RULES if re.search(pat, path)), None)
        if rule is None:
            continue
        layer = leaf.name[:-len(".weight")]
        if rule == "row":
            specs[leaf.name] = "cols"
            continue
        kind = "qkv" if layer.endswith(".qkv") else "rows"
        specs[leaf.name] = kind
        if model.get_submodule(layer).bias is not None:
            specs[layer + ".bias"] = kind
    return specs


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Slice `model`'s TP_RULES parameters for this rank of the mesh's model
    axis, in place, and hand the model group to the attention and MLP
    modules that own them. A model axis of one leaves the model as it is.
    The split is recorded in `model.tp_specs` (parameter name -> kind)."""
    parts = mesh.size("model")
    if parts == 1:
        model.tp_specs = {}
        return model
    from ..models.block import Attention
    from ..models.nn import Mlp
    index, group = mesh.index("model"), mesh.group("model")
    specs = tp_specs(model)
    with torch.no_grad():
        for name, kind in specs.items():
            owner, pname = name.rsplit(".", 1)
            layer = model.get_submodule(owner)
            full = getattr(layer, pname)
            setattr(layer, pname, torch.nn.Parameter(
                shard_tensor(full.data, kind, index, parts),
                requires_grad=full.requires_grad))
    owners = {n.rsplit(".", 2)[0] for n in specs}
    for name in owners:
        mod = model.get_submodule(name)
        if isinstance(mod, Attention):
            if mod.num_heads % parts:
                raise ValueError(f"{name}: {mod.num_heads} heads do not split over "
                                 f"{parts} ranks")
            mod.num_heads //= parts
        elif not isinstance(mod, Mlp):
            raise TypeError(f"{name}: no tensor-parallel form for {type(mod).__name__}")
        mod.tp = group
    model.tp_specs = specs
    return model


def tp_partial_params(model: torch.nn.Module):
    """Parameters that see only this rank's heads under TP (q_norm, k_norm
    of a sharded attention): their gradients are summed over the model
    group. Everything else outside tp_specs sees replicated activations."""
    from ..models.block import Attention
    out = []
    for mod in model.modules():
        if isinstance(mod, Attention) and mod.tp is not None and mod.q_norm is not None:
            out += list(mod.q_norm.parameters()) + list(mod.k_norm.parameters())
    return out


def _cut(x, index: int, parts: int, dim: int):
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {parts} ranks")
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * n // parts, (index + 1) * n // parts)
    return x[tuple(sl)]


def shard_views(views: Dict, mesh) -> Dict:
    """(B, S, ...) arrays or tensors -> this rank's part: the batch over
    "data", the views over "view" (contiguous, as JAX's view_sharding)."""
    return {k: _cut(_cut(v, mesh.index("data"), mesh.size("data"), 0),
                    mesh.index("view"), mesh.size("view"), 1)
            for k, v in views.items()}


def axis_part(x, mesh, axis: str = "view", dim: int = 1):
    """This rank's contiguous part of dim `dim` split over the mesh's
    `axis` (by default its views)."""
    return _cut(x, mesh.index(axis), mesh.size(axis), dim)


def gather_predictions(preds: Dict, mesh) -> Dict:
    """A sharded forward's outputs -> the whole batch's on every rank: each
    (B_local, S_local, ...) tensor gathered over "view" then "data"; the
    splats (B_local, N, ...), whole on every view rank, over "data" only."""
    def whole(x, views: bool):
        if not isinstance(x, torch.Tensor) or x.dim() < (2 if views else 1):
            return x
        if views:
            x = comm.gather_raw(x, mesh.group("view"), 1) if mesh.size("view") > 1 else x
        return comm.gather_raw(x, mesh.group("data"), 0) if mesh.size("data") > 1 else x

    out = {}
    for k, v in preds.items():
        if isinstance(v, dict):
            out[k] = {kk: whole(vv, False) for kk, vv in v.items()}
        else:
            out[k] = whole(v, True)
    return out


def gather_state(model: torch.nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The unsharded state dict of a model shard_model sliced: each sharded
    parameter gathered over the model group and put back together."""
    specs = getattr(model, "tp_specs", {})
    out = {}
    for name, t in model.state_dict().items():
        kind = specs.get(name)
        if kind is not None:
            group = mesh.group("model")
            parts = comm.gather_raw(t[None], group, 0)
            t = unshard_tensors(list(parts), kind)
        out[name] = t
    return out

