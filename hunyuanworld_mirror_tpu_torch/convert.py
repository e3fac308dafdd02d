"""JAX parameter pytree -> this package's state dict.

The inverse of tools/convert_weights.convert_worldmirror (which maps the
reference torch state dict onto the JAX pytree), written without importing
it: layer stacks `(L, ...)` are unstacked into `blocks.{i}`, linear weights
go back to (out, in), HWIO conv kernels to OIHW, and the conv-transpose
kernels (HWOI, stored spatially flipped by the forward converter) are
flipped back to the reference IOHW layout.

Usage: `model.load_state_dict(from_jax_params(load_npz(path)))` for an npz
checkpoint of the JAX package, or `from_jax_params(params)` for the JAX
pytree as numpy arrays.
"""

import re
from typing import Dict

import numpy as np
import torch

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
