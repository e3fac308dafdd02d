"""WorldMirror's parameters by name and shape, and seeded random values.

`param_spec(cfg)` lists every parameter of a WorldMirror configuration file
(wmbench/configs/*.json) under the reference torch state-dict names of the
public release (`visual_geometry_transformer.*`, `cam_head.*`,
`depth_head.*`, `pts_head.*`, `norm_head.*`, `gs_head.*`, `gs_renderer.*`),
with the distribution it is drawn from: truncated normal 0.02 for linear
layers, uniform +-1/sqrt(fan_in) for convolutions (torch's default), ones
and zeros for norms, the LayerScale constants, and the Gaussian head's
per-segment init (quats 0, scales -7, opacity -2, SH 0, weights -2).

`make_weights(cfg, seed, device, dtype)` draws all of them from one
torch.Generator on `device`, a few large uniform draws turned into each
leaf's distribution, and returns the state dict in `dtype`. The benchmark
hands the same dict to the program (load_state_dict) and, in f32, to the
reference, so neither side's own initialiser is used.
"""

import math
from typing import Dict, List, Tuple

import torch

Rule = Tuple  # ("trunc", std) | ("uniform", bound) | ("const", v) | ("rows", [(n, kind, a)])


def _linear(name, n_out, n_in, bias=True):
    out = [(f"{name}.weight", (n_out, n_in), ("trunc", 0.02))]
    if bias:
        out.append((f"{name}.bias", (n_out,), ("const", 0.0)))
    return out


def _conv(name, n_out, n_in, k, bias=True, transpose=False):
    fan_in = (n_out if transpose else n_in) * k * k
    bound = 1.0 / math.sqrt(fan_in)
    shape = (n_in, n_out, k, k) if transpose else (n_out, n_in, k, k)
    out = [(f"{name}.weight", shape, ("uniform", bound))]
    if bias:
        out.append((f"{name}.bias", (n_out,), ("uniform", bound)))
    return out


def _norm(name, dim):
    return [(f"{name}.weight", (dim,), ("const", 1.0)),
            (f"{name}.bias", (dim,), ("const", 0.0))]


def _block(name, dim, heads, mlp_ratio, init_values, qk_norm):
    hd = dim // heads
    hidden = int(dim * mlp_ratio)
    out = _norm(f"{name}.norm1", dim) + _linear(f"{name}.attn.qkv", 3 * dim, dim)
    if qk_norm:
        out += _norm(f"{name}.attn.q_norm", hd) + _norm(f"{name}.attn.k_norm", hd)
    out += _linear(f"{name}.attn.proj", dim, dim)
    out.append((f"{name}.ls1.gamma", (dim,), ("const", init_values)))
    out += _norm(f"{name}.norm2", dim)
    out += _linear(f"{name}.mlp.fc1", hidden, dim) + _linear(f"{name}.mlp.fc2", dim, hidden)
    out.append((f"{name}.ls2.gamma", (dim,), ("const", init_values)))
    return out


def _dpt(name, cfg, output_dim, features, gs):
    C2 = 2 * cfg["embed_dim"]
    oc = cfg["dpt_out_channels"]
    f = features
    out = _norm(f"{name}.norm", C2)
    for i, c in enumerate(oc):
        out += _conv(f"{name}.projects.{i}", c, C2, 1)
    out += _conv(f"{name}.resize_layers.0", oc[0], oc[0], 4, transpose=True)
    out += _conv(f"{name}.resize_layers.1", oc[1], oc[1], 2, transpose=True)
    out += _conv(f"{name}.resize_layers.3", oc[3], oc[3], 3)
    for i, c in enumerate(oc):
        out += _conv(f"{name}.scratch.layer{i + 1}_rn", f, c, 3, bias=False)
    for r in (1, 2, 3, 4):
        rn = f"{name}.scratch.refinenet{r}"
        out += _conv(f"{rn}.out_conv", f, f, 1)
        units = (2,) if r == 4 else (1, 2)
        for u in units:
            out += (_conv(f"{rn}.resConfUnit{u}.conv1", f, f, 3)
                    + _conv(f"{rn}.resConfUnit{u}.conv2", f, f, 3))
    out += _conv(f"{name}.scratch.output_conv1", f // 2, f, 3)
    out += _conv(f"{name}.scratch.output_conv2.0", 32, f // 2, 3)
    out += _conv(f"{name}.scratch.output_conv2.2", output_dim, 32, 1)
    if gs:
        out += _conv(f"{name}.input_merger.0", f // 2, 3, 7)
    return out


def gs_splits(cfg) -> List[int]:
    """The Gaussian head's raw channels: quats, scales, opacity, SH, weight."""
    return [4, 3, 1, 3 * (cfg["sh_degree"] + 1) ** 2, 1]


def param_spec(cfg: dict) -> List[Tuple[str, tuple, Rule]]:
    C = cfg["embed_dim"]
    Ce = cfg["encoder_dim"]
    p = cfg["patch_size"]
    nreg = cfg["num_register_tokens"]
    vgt = "visual_geometry_transformer"
    spec = []
    if cfg["encoder"] == "conv":
        spec += _conv(f"{vgt}.patch_embed.proj", C, 3, p)
    else:
        pe = f"{vgt}.patch_embed"
        n_patches = (cfg["img_size"] // p) ** 2
        spec += _conv(f"{pe}.patch_embed.proj", Ce, 3, p)
        spec += [(f"{pe}.cls_token", (1, 1, Ce), ("trunc", 1e-6)),
                 (f"{pe}.pos_embed", (1, n_patches + 1, Ce), ("trunc", 0.02)),
                 (f"{pe}.register_tokens", (1, nreg, Ce), ("trunc", 1e-6)),
                 (f"{pe}.mask_token", (1, Ce), ("const", 0.0))]
        for i in range(cfg["encoder_depth"]):
            spec += _block(f"{pe}.blocks.{i}", Ce, cfg["encoder_heads"],
                           cfg["mlp_ratio"], cfg["encoder_init_values"], False)
        spec += _norm(f"{pe}.norm", Ce)
    spec += [(f"{vgt}.cam_token", (1, 2, 1, C), ("trunc", 1e-6)),
             (f"{vgt}.reg_token", (1, 2, nreg, C), ("trunc", 1e-6))]
    for kind in ("frame_blocks", "global_blocks"):
        for i in range(cfg["trunk_depth"]):
            spec += _block(f"{vgt}.{kind}.{i}", C, cfg["trunk_heads"], cfg["mlp_ratio"],
                           cfg["trunk_init_values"], cfg["qk_norm"])
    if cfg["enable_cond"]:
        spec += _linear(f"{vgt}.pose_embed.0", C, 7) + _linear(f"{vgt}.pose_embed.2", C, C)
        spec += (_linear(f"{vgt}.depth_embed.proj.2.fc1", 4 * C, p * p)
                 + _linear(f"{vgt}.depth_embed.proj.2.fc2", C, 4 * C))
        spec += _linear(f"{vgt}.ray_embed.0", C, 4) + _linear(f"{vgt}.ray_embed.2", C, C)

    D = 2 * C
    for i in range(cfg["cam_head_depth"]):
        spec += _block(f"cam_head.refine_net.{i}", D, cfg["cam_head_heads"],
                       cfg["mlp_ratio"], cfg["trunk_init_values"], False)
    spec += _norm("cam_head.token_norm", D) + _norm("cam_head.out_norm", D)
    spec.append(("cam_head.init_token", (1, 1, 9), ("const", 0.0)))
    spec += _linear("cam_head.param_embed", D, 9)
    spec += _linear("cam_head.adapt_norm_gen.1", 3 * D, D)
    spec += _linear("cam_head.param_predictor.fc1", D // 2, D)
    spec += _linear("cam_head.param_predictor.fc2", 9, D // 2)

    feats = cfg["dpt_features"]
    spec += _dpt("depth_head", cfg, 2, feats, False)
    spec += _dpt("pts_head", cfg, 4, feats, False)
    spec += _dpt("norm_head", cfg, 4, feats, False)
    spec += _dpt("gs_head", cfg, 2, cfg["gs_dim"], True)

    f = cfg["gs_dim"]
    splits = gs_splits(cfg)
    raw = sum(splits)
    spec += _conv("gs_renderer.gs_head.0", f, f // 2, 3, bias=False)
    gains = (1.0, 3e-5, 1.0, 1.0, 1.0)
    biases = (0.0, -7.0, -2.0, 0.0, -2.0)
    spec.append(("gs_renderer.gs_head.2.weight", (raw, f, 1, 1),
                 ("rows", [(n, "uniform", g * (6.0 / (f + n)) ** 0.5)
                           for n, g in zip(splits, gains)])))
    spec.append(("gs_renderer.gs_head.2.bias", (raw,),
                 ("rows", [(n, "const", b) for n, b in zip(splits, biases)])))
    return spec


_P_LO = 0.5 * math.erfc(2.0 / math.sqrt(2.0))   # Phi(-2)
_P_SPAN = 1.0 - 2.0 * _P_LO                    # Phi(2) - Phi(-2)


def _fill(u: torch.Tensor, rule: Rule) -> torch.Tensor:
    """Uniform [0, 1) draws -> the rule's distribution (same shape)."""
    kind = rule[0]
    if kind == "trunc":     # inverse CDF of N(0, 1) on [-2, 2]
        return torch.special.ndtri(_P_LO + u * _P_SPAN) * rule[1]
    if kind == "uniform":
        return (2.0 * u - 1.0) * rule[1]
    if kind == "const":
        return torch.full_like(u, rule[1])
    if kind == "rows":
        parts, start = [], 0
        for n, sub, a in rule[1]:
            parts.append(_fill(u[start:start + n], (sub, a)))
            start += n
        return torch.cat(parts)
    raise ValueError(f"unknown init rule {rule!r}")


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16,
                 chunk: int = 1 << 28) -> Dict[str, torch.Tensor]:
    """Every parameter of `cfg`, drawn from `seed` on `device`: one uniform
    draw per group of leaves holding up to `chunk` values, each leaf's
    slice turned into its distribution and cast to `dtype`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    spec = param_spec(cfg)
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while i < len(spec):
        j, n = i, 0
        while j < len(spec) and (j == i or n + math.prod(spec[j][1]) <= chunk):
            n += math.prod(spec[j][1])
            j += 1
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
        off = 0
        for name, shape, rule in spec[i:j]:
            k = math.prod(shape)
            vals = u[off:off + k].reshape(shape[0], -1)
            out[name] = _fill(vals, rule).reshape(shape).to(dtype)
            off += k
        del u
        i = j
    return out
