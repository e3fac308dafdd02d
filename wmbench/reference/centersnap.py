"""Plain PyTorch CenterSnap training step: the fork's 6D-pose model, its
loss and AdamW under the cosine rate, float32.

Written from the fork's published training setup (HunyuanWorld-Mirror's
6D-pose fork, train.py:152-356: WorldMirrorCenterSnap at 384 px, patch 16,
a frozen dinov3_vits16 backbone returning x_norm_patchtokens, a 4-block
frame-only trunk 384 wide with 6 heads and QK-norm, conditioned on depth,
a 1-channel sigmoid heatmap DPT head and a 12-channel linear pose DPT head
at down_ratio 2; 100 MSE(heatmap) + masked L1(pose); AdamW 5e-5, weight
decay 0.05, cosine) as hunyuanworld_mirror_tpu_torch/models/centersnap.py,
aggregator.py, dinov2.py, dpt.py and training/{trainer,losses}.py state
it. The fork's dinov3 submodule is empty, so the backbone is the port's
DINOv3-style ViT: conv patchify, cls and register tokens, no learned
position embedding, 2D RoPE (base 100) inside its blocks with the cls and
register tokens at (0, 0), LayerScale, LayerNorm eps 1e-6, final norm.
Its conventions as the port keeps them: each image is frame 0 of its own
(the camera and register tokens' first slot), the pose and ray tokens zero
(only the depth prior is on), the depth prior's tokens added to the patch
tokens through a PixelUnshuffle MLP, the trunk's RoPE with the 7 special
tokens at (0, 0), every trunk layer captured for the heads, the heads'
UV position embeddings on.

Functions over a state dict `sd` of float32 tensors named as the program's
(`encoder.*`, `heatmap_head.*`, `pose_head.*`); no module of the program
is imported. The block, RoPE, attention and DPT pieces are those of
reference/model.py. `prec` (reference/precision.py) rounds what enters
each matrix product or convolution in the forward (the trunk's rounding
also in the backbone), identity for the reference; gradients pass through
the rounding unchanged (straight through), so the control's backward is
f32 on its own rounded forward.
"""

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .model import (_MEAN, _STD, _conv, _deconv, _fusion, _linear, _ln, _resize,
                    _uv_embed, block, rope_tables)
from .precision import REFERENCE, Precision
from .weights import _block, _conv as _conv_spec, _fill, _linear as _linear_spec, _norm

BACKBONE = "encoder.patch_embed"
HEADS = ("heatmap_head", "pose_head")


# --- parameters -----------------------------------------------------------------

def _dpt_spec(name, dim_in, features, out_channels, output_dim):
    f, oc = features, out_channels
    out = _norm(f"{name}.norm", dim_in)
    for i, c in enumerate(oc):
        out += _conv_spec(f"{name}.projects.{i}", c, dim_in, 1)
    out += _conv_spec(f"{name}.resize_layers.0", oc[0], oc[0], 4, transpose=True)
    out += _conv_spec(f"{name}.resize_layers.1", oc[1], oc[1], 2, transpose=True)
    out += _conv_spec(f"{name}.resize_layers.3", oc[3], oc[3], 3)
    for i, c in enumerate(oc):
        out += _conv_spec(f"{name}.scratch.layer{i + 1}_rn", f, c, 3, bias=False)
    for r in (1, 2, 3, 4):
        rn = f"{name}.scratch.refinenet{r}"
        out += _conv_spec(f"{rn}.out_conv", f, f, 1)
        for u in ((2,) if r == 4 else (1, 2)):
            out += (_conv_spec(f"{rn}.resConfUnit{u}.conv1", f, f, 3)
                    + _conv_spec(f"{rn}.resConfUnit{u}.conv2", f, f, 3))
    out += _conv_spec(f"{name}.scratch.output_conv1", f // 2, f, 3)
    out += _conv_spec(f"{name}.scratch.output_conv2.0", 32, f // 2, 3)
    out += _conv_spec(f"{name}.scratch.output_conv2.2", output_dim, 32, 1)
    return out


def param_spec(cfg: dict):
    """Every parameter of a CenterSnap configuration file, by the program's
    state-dict name, with its shape and init rule (reference/weights.py's
    rules: truncated normal 0.02 for linears, torch's uniform for convs,
    LayerNorms at ones and zeros, the LayerScale constants, the tokens at
    1e-6)."""
    C, p, Ce = cfg["embed_dim"], cfg["patch_size"], cfg["encoder_dim"]
    nreg = cfg["num_register_tokens"]
    n_patches = (cfg["img_size"] // p) ** 2   # the unused learned embed
    spec = [("encoder.cam_token", (1, 2, 1, C), ("trunc", 1e-6)),
            ("encoder.reg_token", (1, 2, nreg, C), ("trunc", 1e-6)),
            (f"{BACKBONE}.cls_token", (1, 1, Ce), ("trunc", 1e-6)),
            (f"{BACKBONE}.pos_embed", (1, n_patches + 1, Ce), ("trunc", 0.02)),
            (f"{BACKBONE}.register_tokens", (1, nreg, Ce), ("trunc", 1e-6)),
            (f"{BACKBONE}.mask_token", (1, Ce), ("const", 0.0))]
    spec += _conv_spec(f"{BACKBONE}.patch_embed.proj", Ce, 3, p)
    for i in range(cfg["encoder_depth"]):
        spec += _block(f"{BACKBONE}.blocks.{i}", Ce, cfg["encoder_heads"], cfg["mlp_ratio"],
                       cfg["encoder_init_values"], False)
    spec += _norm(f"{BACKBONE}.norm", Ce)
    for i in range(cfg["trunk_depth"]):
        spec += _block(f"encoder.frame_blocks.{i}", C, cfg["trunk_heads"], cfg["mlp_ratio"],
                       cfg["trunk_init_values"], cfg["qk_norm"])
    spec += _linear_spec("encoder.pose_embed.0", C, 7) + _linear_spec("encoder.pose_embed.2", C, C)
    spec += (_linear_spec("encoder.depth_embed.proj.2.fc1", 4 * C, p * p)
             + _linear_spec("encoder.depth_embed.proj.2.fc2", C, 4 * C))
    spec += _linear_spec("encoder.ray_embed.0", C, 4) + _linear_spec("encoder.ray_embed.2", C, C)
    for name, out_dim in zip(HEADS, (1, 12)):
        spec += _dpt_spec(name, C, cfg["head_features"], cfg["head_out_channels"], out_dim)
    return spec


def make_weights(cfg: dict, seed: int, device, dtype=torch.float32,
                 chunk: int = 1 << 26) -> Dict[str, torch.Tensor]:
    """Every parameter of `cfg` drawn from `seed` on `device`, as
    reference/weights.make_weights draws WorldMirror's: one uniform draw a
    group of leaves holding up to `chunk` values, each leaf's slice turned
    into its distribution."""
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
            out[name] = _fill(u[off:off + k].reshape(shape[0], -1), rule).reshape(shape).to(dtype)
            off += k
        i = j
    return out


def frozen(name: str) -> bool:
    """A leaf of the frozen DINO backbone."""
    return name.startswith(BACKBONE + ".")


# --- forward ---------------------------------------------------------------------

def _straight(rnd):
    """`rnd` in the forward, the identity in the backward."""
    if rnd is REFERENCE.trunk:
        return rnd
    return lambda x: x + (rnd(x.detach()) - x.detach())


def backbone(sd, cfg, imgs, rnd):
    """(B, H, W, 3) normalised images -> (B, h*w, Ce) patch tokens of the
    DINOv3-style ViT."""
    p, nreg = cfg["patch_size"], cfg["num_register_tokens"]
    B, H, W, _ = imgs.shape
    x = _conv(sd, f"{BACKBONE}.patch_embed.proj", imgs.permute(0, 3, 1, 2), rnd, stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd[f"{BACKBONE}.cls_token"].expand(B, 1, -1),
                   sd[f"{BACKBONE}.register_tokens"].expand(B, nreg, -1), x], 1)
    Ce, He = cfg["encoder_dim"], cfg["encoder_heads"]
    rope = rope_tables(H // p, W // p, 1 + nreg, Ce // He, cfg["encoder_rope_freq"], imgs.device)
    for i in range(cfg["encoder_depth"]):
        x = block(sd, f"{BACKBONE}.blocks.{i}", x, He, 1e-6, rnd, rope)
    return _ln(sd, f"{BACKBONE}.norm", x, 1e-6)[:, 1 + nreg:]


def n_special(cfg) -> int:
    return 1 + cfg["num_register_tokens"] + 2   # camera, registers, pose, ray


def trunk(sd, cfg, rgb, depth, prec: Precision = REFERENCE) -> List[torch.Tensor]:
    """(B, H, W, 3) images in [0, 1] and (B, H, W) depth in [0, 1] -> the
    captured intermediates, each (B, 1, N, C). The backbone runs without
    gradient; the rest builds the graph of whatever leaves require it."""
    B, H, W, _ = rgb.shape
    C, p, nreg = cfg["embed_dim"], cfg["patch_size"], cfg["num_register_tokens"]
    dev = rgb.device
    rnd = _straight(prec.trunk)
    mean, std = torch.tensor(_MEAN, device=dev), torch.tensor(_STD, device=dev)
    with torch.no_grad():
        patches = backbone(sd, cfg, (rgb - mean) / std, prec.trunk)
    if cfg["depth_cond"]:
        d = F.pixel_unshuffle(depth[:, None], p).permute(0, 2, 3, 1).reshape(B, -1, p * p)
        dn = "encoder.depth_embed.proj.2"
        d = _linear(sd, f"{dn}.fc2", F.gelu(_linear(sd, f"{dn}.fc1", d, rnd)), rnd)
        patches = patches + d
    x = torch.cat([sd["encoder.cam_token"][:, 0].expand(B, 1, C),
                   sd["encoder.reg_token"][:, 0].expand(B, nreg, C),
                   torch.zeros(B, 2, C, device=dev), patches], 1)
    heads = cfg["trunk_heads"]
    rope = rope_tables(H // p, W // p, n_special(cfg), C // heads, cfg["rope_freq"], dev)
    out = {}
    for i in range(cfg["trunk_depth"]):
        x = block(sd, f"encoder.frame_blocks.{i}", x, heads, 1e-5, rnd, rope, cfg["qk_norm"])
        out[i] = x[:, None]
    return [out[i] for i in cfg["intermediate_idxs"]]


def dpt(sd, name, cfg, tokens, H, W, down_ratio, rnd):
    """One of the fork's DPT heads -> its f32 pre-activation map (B, H /
    down_ratio, W / down_ratio, out) NHWC."""
    p = cfg["patch_size"]
    ph, pw = H // p, W // p
    B = tokens[0].shape[0]
    dev = tokens[0].device
    start = n_special(cfg)
    feats = []
    for lvl in range(4):
        t = _ln(sd, f"{name}.norm", tokens[lvl][:, 0, start:].float(), 1e-5)
        f = _conv(sd, f"{name}.projects.{lvl}", t.transpose(1, 2).reshape(B, -1, ph, pw), rnd)
        f = f + _uv_embed(f.shape[1], ph, pw, W, H, dev)
        if lvl == 0:
            f = _deconv(sd, f"{name}.resize_layers.0", f, rnd, 4)
        elif lvl == 1:
            f = _deconv(sd, f"{name}.resize_layers.1", f, rnd, 2)
        elif lvl == 3:
            f = _conv(sd, f"{name}.resize_layers.3", f, rnd, stride=2, padding=1)
        feats.append(f)
    sc = f"{name}.scratch"
    l1, l2, l3, l4 = (_conv(sd, f"{sc}.layer{i + 1}_rn", feats[i], rnd, padding=1)
                      for i in range(4))
    out = _fusion(sd, f"{sc}.refinenet4", l4, rnd, size=l3.shape[-2:])
    out = _fusion(sd, f"{sc}.refinenet3", out, rnd, l3, size=l2.shape[-2:])
    out = _fusion(sd, f"{sc}.refinenet2", out, rnd, l2, size=l1.shape[-2:])
    out = _fusion(sd, f"{sc}.refinenet1", out, rnd, l1)
    out = _conv(sd, f"{sc}.output_conv1", out, rnd, padding=1)
    fused = _resize(out, (int(ph * p / down_ratio), int(pw * p / down_ratio)))
    fused = fused + _uv_embed(fused.shape[1], fused.shape[-2], fused.shape[-1], W, H, dev)
    head = _conv(sd, f"{sc}.output_conv2.0", fused, rnd, padding=1)
    return _conv(sd, f"{sc}.output_conv2.2", F.relu(head), rnd).permute(0, 2, 3, 1)


def heads(sd, cfg, tokens, H, W, prec: Precision = REFERENCE) -> Dict[str, torch.Tensor]:
    """The trunk's intermediates (any dtype; taken as f32) -> heatmap (B,
    H, W, 1) through a sigmoid and pose_map (B, H/dr, W/dr, 12), linear."""
    rnd = _straight(prec.heads)
    heat = dpt(sd, "heatmap_head", cfg, tokens, H, W, 1, rnd)
    pose = dpt(sd, "pose_head", cfg, tokens, H, W, cfg["pose_down_ratio"], rnd)
    return {"heatmap": torch.sigmoid(heat), "pose_map": pose}


# --- loss and optimizer -------------------------------------------------------------

def prepare(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader-layout host batch -> f32 tensors: depth clamped to 25 m
    over 25, the pose map NHWC."""
    out = {k: torch.as_tensor(batch[k], dtype=torch.float32, device=device)
           for k in ("rgb", "heatmap", "pose_map", "depth")}
    out["depth"] = torch.clamp(out["depth"], 0.0, 25.0) / 25.0
    if out["pose_map"].shape[1] == 12:
        out["pose_map"] = out["pose_map"].permute(0, 2, 3, 1)
    return out


def loss(preds: Dict, batch: Dict, heat_weight: float = 100.0,
         threshold: float = 0.3) -> torch.Tensor:
    """heat_weight * MSE(heatmap) + the masked L1 of the pose map's rot6d
    and translation + size halves: each pixel's L1 summed over channels,
    summed over the pixels whose ground-truth heat (sampled at the pose
    map's stride) exceeds `threshold`, over their count (the plain sum when
    there is none)."""
    gt = batch["heatmap"]
    mse = torch.mean((preds["heatmap"][..., 0] - gt) ** 2)
    pose, gt_pose = preds["pose_map"], batch["pose_map"]
    dr = gt.shape[-1] // pose.shape[-2]
    valid = gt[:, ::dr, ::dr] > threshold
    n = int(valid.sum())

    def masked_l1(a, b):
        total = torch.where(valid, (a - b).abs().sum(-1), torch.zeros_like(a[..., 0])).sum()
        return total / n if n else total

    return heat_weight * mse + masked_l1(pose[..., :6], gt_pose[..., :6]) \
        + masked_l1(pose[..., 6:], gt_pose[..., 6:])


def learning_rate(cfg: dict, count: int) -> float:
    """The cosine schedule's rate after `count` updates."""
    T = cfg["schedule_steps"]
    return cfg["lr"] * 0.5 * (1.0 + math.cos(math.pi * min(count, T) / T))


def adamw(params: Dict, grads: Dict, state: Dict, lr: float, wd: float, t: int,
          betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One AdamW update t (from 1) of every trainable leaf in place: the
    decoupled decay first, then Adam with the bias corrections (a leaf the
    loss does not reach steps on a zero gradient)."""
    b1, b2 = betas
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k] if grads[k] is not None else torch.zeros_like(p)
            m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
            p.mul_(1 - lr * wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def follow(cfg: dict, sd: Dict[str, torch.Tensor], batches: Sequence[Dict],
           prec: Precision = REFERENCE) -> Dict:
    """One training step on each of `batches` (host batches) from the
    weights `sd`: each step's loss and gradient of each trainable leaf, the
    first step's intermediates and head outputs, every trainable leaf at
    the end and its change over the steps."""
    dev = next(iter(sd.values())).device
    fixed = {k: v for k, v in sd.items() if frozen(k)}
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()
              if not frozen(k)}
    state: Dict = {}
    out: Dict = {"losses": [], "grads": []}
    for t, host in enumerate(batches, 1):
        b = prepare(host, dev)
        H, W = b["rgb"].shape[1:3]
        full = {**fixed, **params}
        tokens = trunk(full, cfg, b["rgb"], b["depth"], prec)
        preds = heads(full, cfg, tokens, H, W, prec)
        value = loss(preds, b)
        names = list(params)
        grads = torch.autograd.grad(value, [params[k] for k in names], allow_unused=True)
        grads = dict(zip(names, grads))
        out["losses"].append(float(value.detach()))
        out["grads"].append({k: (g if g is not None else torch.zeros_like(params[k])).detach()
                             for k, g in grads.items()})
        if t == 1:
            out["grad1"] = out["grads"][0]
            out["tokens"] = [x.detach() for x in tokens]
            out["preds"] = {k: v.detach() for k, v in preds.items()}
        del tokens, preds, value
        adamw(params, grads, state, learning_rate(cfg, t - 1), cfg["weight_decay"], t)
    out["end"] = {k: v.detach() for k, v in params.items()}
    out["delta"] = {k: (params[k] - sd[k]).detach() for k in params}
    return out

