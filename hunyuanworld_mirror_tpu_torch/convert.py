"""JAX parameter pytree -> this package's state dict.

The inverse of tools/convert_weights.convert_worldmirror (which maps the
reference torch state dict onto the JAX pytree), written without importing
it: layer stacks `(L, ...)` are unstacked into `blocks.{i}`, linear weights
go back to (out, in), HWIO conv kernels to OIHW, and the conv-transpose
kernels (HWOI, stored spatially flipped by the forward converter) are
flipped back to the reference IOHW layout.

Usage: `model.load_state_dict(from_jax_params(load_npz(path)))` for an npz
checkpoint of the JAX package, or `from_jax_params(params)` for the JAX
pytree as numpy arrays. The LPIPS net's map goes both ways
(`lpips_from_jax_params`, `lpips_to_jax_params`).

For the 6D-pose models (models/centersnap.CenterSnap, models/panoptic.
Panoptic) the map goes both ways and is read off the module itself:
`jax_leaves(model)` pairs each parameter with its JAX path (a rule table
over the module path, the kind of layer from the module's type),
`to_jax_tree(model)` builds the JAX pytree and `from_jax_tree(model, tree)`
the state dict; the checkpoints (training/checkpoint.py) carry the Adam
moments through the same map.
"""

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .models import nn as pnn

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _linear(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _ln(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _conv_t(sd: StateDict, name: str, p) -> None:
    w = np.asarray(p["w"])[::-1, ::-1]                     # undo the flip
    sd[f"{name}.weight"] = _t(w.transpose(3, 2, 0, 1))     # HWOI -> IOHW
    sd[f"{name}.bias"] = _t(p["b"])


def _mlp(sd: StateDict, name: str, p) -> None:
    _linear(sd, f"{name}.fc1", p["fc1"])
    _linear(sd, f"{name}.fc2", p["fc2"])


def _block(sd: StateDict, name: str, p) -> None:
    _ln(sd, f"{name}.norm1", p["norm1"])
    _ln(sd, f"{name}.norm2", p["norm2"])
    _linear(sd, f"{name}.attn.qkv", p["attn"]["qkv"])
    _linear(sd, f"{name}.attn.proj", p["attn"]["proj"])
    if "q_norm" in p["attn"]:
        _ln(sd, f"{name}.attn.q_norm", p["attn"]["q_norm"])
        _ln(sd, f"{name}.attn.k_norm", p["attn"]["k_norm"])
    _mlp(sd, f"{name}.mlp", p["mlp"])
    if "ls1" in p:
        sd[f"{name}.ls1.gamma"] = _t(p["ls1"]["gamma"])
        sd[f"{name}.ls2.gamma"] = _t(p["ls2"]["gamma"])


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _stacked_blocks(sd: StateDict, name: str, stacked) -> None:
    n = np.asarray(stacked["norm1"]["scale"]).shape[0]
    for i in range(n):
        _block(sd, f"{name}.{i}", _unstack(stacked, i))


def _vgt(sd: StateDict, pre: str, p) -> None:
    sd[f"{pre}cam_token"] = _t(p["cam_token"])
    sd[f"{pre}reg_token"] = _t(p["reg_token"])
    _stacked_blocks(sd, f"{pre}frame_blocks", p["frame_blocks"])
    _stacked_blocks(sd, f"{pre}global_blocks", p["global_blocks"])
    pe = p["patch_embed"]
    if "cls_token" not in pe:                               # conv patchify
        _conv(sd, f"{pre}patch_embed.proj", pe["proj"])
    else:                                                   # DINOv2 encoder
        _conv(sd, f"{pre}patch_embed.patch_embed.proj", pe["patch_embed"]["proj"])
        sd[f"{pre}patch_embed.cls_token"] = _t(pe["cls_token"])
        sd[f"{pre}patch_embed.register_tokens"] = _t(pe["register_tokens"])
        sd[f"{pre}patch_embed.pos_embed"] = _t(pe["pos_embed"])
        # DINOv2's masked-image-modeling token: the JAX package drops it
        # (never used at inference); zeros keep the state dict complete
        sd[f"{pre}patch_embed.mask_token"] = torch.zeros(
            1, np.asarray(pe["cls_token"]).shape[-1])
        _stacked_blocks(sd, f"{pre}patch_embed.blocks", pe["blocks"])
        _ln(sd, f"{pre}patch_embed.norm", pe["norm"])
    if "pose_embed" in p:
        for k in ("pose_embed", "ray_embed"):
            _linear(sd, f"{pre}{k}.0", p[k]["fc1"])
            _linear(sd, f"{pre}{k}.2", p[k]["fc2"])
        _mlp(sd, f"{pre}depth_embed.proj.2", p["depth_embed"]["mlp"])


def _camera_head(sd: StateDict, pre: str, p) -> None:
    for i, blk in enumerate(p["trunk"]):
        _block(sd, f"{pre}refine_net.{i}", blk)
    _ln(sd, f"{pre}token_norm", p["token_norm"])
    _ln(sd, f"{pre}out_norm", p["out_norm"])
    sd[f"{pre}init_token"] = _t(p["init_token"])
    _linear(sd, f"{pre}param_embed", p["param_embed"])
    _linear(sd, f"{pre}adapt_norm_gen.1", p["adapt_norm_gen"])
    _mlp(sd, f"{pre}param_predictor", p["param_predictor"])


def _dpt(sd: StateDict, pre: str, p) -> None:
    _ln(sd, f"{pre}norm", p["norm"])
    for i, c in enumerate(p["projects"]):
        _conv(sd, f"{pre}projects.{i}", c)
    _conv_t(sd, f"{pre}resize_layers.0", p["resize0"])
    _conv_t(sd, f"{pre}resize_layers.1", p["resize1"])
    _conv(sd, f"{pre}resize_layers.3", p["resize3"])
    for i, c in enumerate(p["layer_rn"]):
        _conv(sd, f"{pre}scratch.layer{i + 1}_rn", c)
    for i in (1, 2, 3, 4):
        fb, rp = p[f"refine{i}"], f"{pre}scratch.refinenet{i}"
        _conv(sd, f"{rp}.out_conv", fb["out_conv"])
        for src, dst in (("res1", "resConfUnit1"), ("res2", "resConfUnit2")):
            if src in fb:
                _conv(sd, f"{rp}.{dst}.conv1", fb[src]["conv1"])
                _conv(sd, f"{rp}.{dst}.conv2", fb[src]["conv2"])
    _conv(sd, f"{pre}scratch.output_conv1", p["output_conv1"])
    _conv(sd, f"{pre}scratch.output_conv2.0", p["output_conv2"]["conv1"])
    _conv(sd, f"{pre}scratch.output_conv2.2", p["output_conv2"]["conv2"])
    if "input_merger" in p:
        _conv(sd, f"{pre}input_merger.0", p["input_merger"])


def from_jax_params(params) -> StateDict:
    """The JAX WorldMirror pytree (numpy leaves) -> a state dict with the
    reference torch names, loadable by models.worldmirror.WorldMirror. A
    head switched off in the config is absent from both."""
    sd: StateDict = {}
    _vgt(sd, "visual_geometry_transformer.", params["vgt"])
    if "cam_head" in params:
        _camera_head(sd, "cam_head.", params["cam_head"])
    for name in ("depth_head", "pts_head", "norm_head", "gs_head"):
        if name in params:
            _dpt(sd, f"{name}.", params[name])
    if "gs_renderer" in params:
        _conv(sd, "gs_renderer.gs_head.0", params["gs_renderer"]["conv1"])
        _conv(sd, "gs_renderer.gs_head.2", params["gs_renderer"]["conv2"])
    return sd


def load_npz(path: str):
    """The params pytree of a JAX-package npz checkpoint (flat
    "params/a/b/0/c" paths; all-digit levels are lists), as numpy."""
    root: Dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if not key.startswith("params/"):
                continue
            *path_, leaf = key[len("params/"):].split("/")
            node = root
            for k in path_:
                node = node.setdefault(k, {})
            node[leaf] = data[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"\d+", k) for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


# --- LPIPS (utils/lpips.py) ---------------------------------------------------

def lpips_from_jax_params(params) -> StateDict:
    """The JAX LPIPS pytree ({"convs": [{"w": HWIO, "b"}], "lins": [{"w":
    (1, 1, C, 1)}]}, numpy or JAX leaves) -> the state dict of
    utils/lpips.LPIPS (OIHW)."""
    sd: StateDict = {}
    for i, p in enumerate(params["convs"]):
        _conv(sd, f"convs.{i}", p)
    for i, p in enumerate(params["lins"]):
        _conv(sd, f"lins.{i}", p)
    return sd


def lpips_to_jax_params(model: torch.nn.Module):
    """utils/lpips.LPIPS -> the JAX LPIPS pytree (numpy f32, HWIO)."""
    def hwio(w):
        return np.ascontiguousarray(w.detach().cpu().float().numpy().transpose(2, 3, 1, 0))
    return {"convs": [{"w": hwio(c.weight), "b": c.bias.detach().cpu().float().numpy()}
                      for c in model.convs],
            "lins": [{"w": hwio(lin.weight)} for lin in model.lins]}


# --- the 6D-pose models: a two-way map read off the module ------------------

class Leaf(NamedTuple):
    """One parameter of a port module and its JAX leaf: `path` names the
    leaf in the JAX pytree, `layer` its index along a stacked (scanned)
    block axis or None, `kind` the layout change ("linear", "conv",
    "conv_t" or "id")."""
    name: str
    path: Tuple[str, ...]
    layer: Optional[int]
    kind: str


# module path -> JAX path, applied in order
_PATH_RULES = [
    (r"(^|\.)(pose_embed|ray_embed)\.0$", r"\1\2.fc1"),
    (r"(^|\.)(pose_embed|ray_embed)\.2$", r"\1\2.fc2"),
    (r"\.proj\.2\.", ".mlp."),                  # PatchEmbedMlp's Mlp
    (r"resize_layers\.(\d)", r"resize\1"),
    (r"scratch\.layer(\d)_rn", lambda m: f"layer_rn.{int(m.group(1)) - 1}"),
    (r"scratch\.refinenet(\d)", r"refine\1"),
    (r"resConfUnit(\d)", r"res\1"),
    (r"scratch\.output_conv2\.0", "output_conv2.conv1"),
    (r"scratch\.output_conv2\.2", "output_conv2.conv2"),
    (r"scratch\.", ""),
    (r"input_merger\.0", "input_merger"),
]
_STACKED = re.compile(r"^(.*?\b(?:frame_blocks|global_blocks|blocks))\.(\d+)(?:\.(.*))?$")
# parameters the JAX pytree does not hold (DINOv2's masked-image token)
_UNMAPPED = ("mask_token",)


def _kind(module) -> Tuple[str, Dict[str, str]]:
    """The layout kind of a module's weight and its leaf names."""
    if isinstance(module, torch.nn.Linear):
        return "linear", {"weight": "w", "bias": "b"}
    if isinstance(module, torch.nn.ConvTranspose2d):
        return "conv_t", {"weight": "w", "bias": "b"}
    if isinstance(module, torch.nn.Conv2d):
        return "conv", {"weight": "w", "bias": "b"}
    if isinstance(module, (pnn.LayerNorm, pnn.GroupNorm)):
        return "id", {"weight": "scale", "bias": "bias"}
    return "id", {}


def jax_leaves(model: torch.nn.Module) -> List[Leaf]:
    """Every parameter of `model` that the JAX pytree holds, with its path."""
    out = []
    for mod_name, module in model.named_modules():
        kind, leaf_names = _kind(module)
        for pname, _ in module.named_parameters(recurse=False):
            if pname in _UNMAPPED:
                continue
            path = mod_name
            for pat, rep in _PATH_RULES:
                path = re.sub(pat, rep, path)
            layer = None
            m = _STACKED.match(path)
            if m:
                path = m.group(1) + ("." + m.group(3) if m.group(3) else "")
                layer = int(m.group(2))
            segs = tuple(x for x in path.split(".") if x)
            full = f"{mod_name}.{pname}" if mod_name else pname
            out.append(Leaf(full, segs + (leaf_names.get(pname, pname),), layer,
                            kind if pname == "weight" else "id"))
    return out


def leaf_to_jax(kind: str, a: np.ndarray) -> np.ndarray:
    """A port tensor's layout -> its JAX leaf's."""
    if kind == "linear":
        return a.T
    if kind == "conv":                       # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    if kind == "conv_t":                     # IOHW -> HWOI, spatially flipped
        return a.transpose(2, 3, 1, 0)[::-1, ::-1]
    return a


def leaf_from_jax(kind: str, a: np.ndarray) -> np.ndarray:
    """A JAX leaf's layout -> the port tensor's (leaf_to_jax's inverse)."""
    if kind == "linear":
        return a.T
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "conv_t":
        return a[::-1, ::-1].transpose(3, 2, 0, 1)
    return a


def _listify(node):
    """Nested dicts whose keys are all digits -> lists; an index with no
    entry (an empty optax state between two others) becomes None."""
    if not isinstance(node, dict):
        return node
    if node and all(re.fullmatch(r"\d+", k) for k in node):
        n = max(int(k) for k in node) + 1
        return [_listify(node.get(str(i))) for i in range(n)]
    return {k: _listify(v) for k, v in node.items()}


def to_jax_tree(model: torch.nn.Module,
                tensors: Optional[Dict[str, torch.Tensor]] = None):
    """The JAX pytree (numpy f32 leaves) of `model`'s parameters, or of
    `tensors` (parameter name -> a tensor of that parameter's shape, such
    as an optimizer moment) laid out as those parameters."""
    stacked: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    root: Dict = {}
    for leaf in jax_leaves(model):
        src = tensors[leaf.name] if tensors is not None else model.get_parameter(leaf.name)
        # a copy: a CPU tensor's numpy view would follow later in-place updates
        a = np.array(leaf_to_jax(leaf.kind, src.detach().cpu().float().numpy()),
                     dtype=np.float32, order="C", copy=True)
        if leaf.layer is not None:
            stacked.setdefault(leaf.path, {})[leaf.layer] = a
            continue
        node = root
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = a
    for path, layers in stacked.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack([layers[i] for i in range(len(layers))])
    return _listify(root)


def jax_leaf(tree, leaf: Leaf) -> np.ndarray:
    """The JAX tree's array for one port parameter, in the port's layout."""
    node = tree
    for k in leaf.path:
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    a = np.asarray(node, np.float32)
    if leaf.layer is not None:
        a = a[leaf.layer]
    return np.ascontiguousarray(leaf_from_jax(leaf.kind, a))


def from_jax_tree(model: torch.nn.Module, tree) -> StateDict:
    """The JAX pytree `tree` (numpy or JAX leaves) as `model`'s parameters,
    by name; load with `load_jax_tree`."""
    return {leaf.name: torch.from_numpy(jax_leaf(tree, leaf))
            for leaf in jax_leaves(model)}


def load_jax_tree(model: torch.nn.Module, tree) -> None:
    """Copy the JAX pytree into `model`'s parameters in place."""
    with torch.no_grad():
        for name, value in from_jax_tree(model, tree).items():
            p = model.get_parameter(name)
            if p.shape != value.shape:
                raise ValueError(f"{name}: JAX leaf {tuple(value.shape)} for "
                                 f"a parameter of shape {tuple(p.shape)}")
            p.copy_(value)
