"""Plain PyTorch WorldMirror: the trunk and the heads, float32.

Written from the published architecture (HunyuanWorld-Mirror,
arXiv:2510.10726; DINOv2 ViT-L/14 with registers; VGGT's alternating
frame / global trunk with 2D RoPE and QK-norm; VGGT's camera head; DPT
heads) and checked line by line against hunyuanworld_mirror_tpu_torch/
models/{dinov2,aggregator,block,rope,camera_head,dpt}.py at commit
e2e15df8eb5b1f9149d8000ecb6c575b37fbec06, whose conventions it keeps: the
special tokens [camera | registers | pose | ray] (frame 0's distinct), RoPE
base 100 with the special tokens at (0, 0) and the patch grid shifted by
+1, the camera head's 4 refinement steps of adaptive LayerNorm, DPT's
align-corners bilinear resizes and UV position embeddings, the inplace-ReLU
skip of the residual units.

Functions over a state dict `sd` of float32 tensors (reference/weights.py
names); no module of the program is imported. Everything runs in float32
with TF32 off; `prec` (reference/precision.py) rounds what enters each
matrix product or convolution, identity for the reference and one step
lower for the control. Attention is softmax(q k^T / sqrt(d)) v, computed
a few heads and a block of query rows at a time, so that the global layers
of many views fit beside the weights.
"""

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import REFERENCE, Precision, fp8

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _linear(sd, name, x, rnd):
    b = sd.get(f"{name}.bias")
    return F.linear(rnd(x), rnd(sd[f"{name}.weight"]), b)


def _ln(sd, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), sd.get(f"{name}.weight"),
                        sd.get(f"{name}.bias"), eps)


def _conv(sd, name, x, rnd, stride=1, padding=0):
    return F.conv2d(rnd(x), rnd(sd[f"{name}.weight"]), sd.get(f"{name}.bias"),
                    stride, padding)


def _deconv(sd, name, x, rnd, stride):
    return F.conv_transpose2d(rnd(x), rnd(sd[f"{name}.weight"]),
                              sd[f"{name}.bias"], stride)


def attention(q, k, v, rnd, heads_at_once: int = 4, block_bytes: int = 1 << 30):
    """(B, N, H, D) q, k, v -> (B, N, H, D): softmax(q k^T / sqrt(D)) v.

    `heads_at_once` heads at a time, each group's q, k and v rounded whole;
    the query rows in blocks whose scores take at most `block_bytes`. Each
    row's softmax runs over every key, so the blocks change no number. The
    probabilities are rounded with one scale a group: fp8 takes the group's
    largest from a first pass over the blocks."""
    B, N = q.shape[:2]
    scale = q.shape[-1] ** -0.5
    rows = max(1, block_bytes // (4 * B * heads_at_once * N))
    starts = range(0, N, rows)
    outs = []
    for h in range(0, q.shape[2], heads_at_once):
        qh, kh, vh = (rnd(t[:, :, h:h + heads_at_once].transpose(1, 2))
                      for t in (q, k, v))
        kt = kh.transpose(-1, -2)

        def probs(i):
            return torch.softmax(torch.matmul(qh[:, :, i:i + rows], kt) * scale, -1)

        rnd_p = rnd
        if rnd is fp8 and len(starts) > 1:
            amax = torch.stack([probs(i).amax() for i in starts]).amax()
            rnd_p = functools.partial(fp8, amax=amax)
        outs.append(torch.cat([torch.matmul(rnd_p(probs(i)), vh) for i in starts], 2))
    return torch.cat(outs, dim=1).transpose(1, 2)


# --- 2D RoPE ---------------------------------------------------------------

def rope_tables(h: int, w: int, n_special: int, head_dim: int, freq: float,
                device) -> Tuple[torch.Tensor, ...]:
    """cos/sin tables (N, head_dim / 2) for the y and x halves: special
    tokens at (0, 0), the patch grid at (y + 1, x + 1)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([ys.reshape(-1), xs.reshape(-1)], -1) + 1
    pos = np.concatenate([np.zeros((n_special, 2), np.int64), pos])
    half = head_dim // 2
    inv = 1.0 / freq ** (np.arange(0, half, 2, dtype=np.float64) / half)
    out = []
    for axis in (0, 1):
        ang = pos[:, axis, None].astype(np.float64) * inv[None]
        ang = np.concatenate([ang, ang], -1)
        out += [torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
                torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device)]
    return tuple(out)


def apply_rope(x, tables):
    """Rotate (B, N, H, D): the first half of D by y, the second by x; in
    each half (a, b) -> (a cos - b sin, b cos + a sin) on its quarters."""
    half = x.shape[-1] // 2
    q = half // 2

    def rot(t, cos, sin):
        c, s = cos[None, :, None, :q], sin[None, :, None, :q]
        a, b = t[..., :q], t[..., q:]
        return torch.cat([a * c - b * s, b * c + a * s], -1)

    cy, sy, cx, sx = tables
    return torch.cat([rot(x[..., :half], cy, sy), rot(x[..., half:], cx, sx)], -1)


# --- transformer block -------------------------------------------------------

def block(sd, name, x, heads, eps, rnd, rope=None, qk_norm=False):
    B, N, C = x.shape
    D = C // heads
    h = _ln(sd, f"{name}.norm1", x, eps)
    q, k, v = _linear(sd, f"{name}.attn.qkv", h, rnd).reshape(B, N, 3, heads, D).unbind(2)
    if qk_norm:
        q = _ln(sd, f"{name}.attn.q_norm", q, eps)
        k = _ln(sd, f"{name}.attn.k_norm", k, eps)
    if rope is not None:
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    a = attention(q, k, v, rnd).reshape(B, N, C)
    x = x + sd[f"{name}.ls1.gamma"] * _linear(sd, f"{name}.attn.proj", a, rnd)
    h = _ln(sd, f"{name}.norm2", x, eps)
    h = _linear(sd, f"{name}.mlp.fc2",
                F.gelu(_linear(sd, f"{name}.mlp.fc1", h, rnd)), rnd)
    return x + sd[f"{name}.ls2.gamma"] * h


# --- trunk -----------------------------------------------------------------

def n_special(cfg) -> int:
    return 1 + cfg["num_register_tokens"] + (2 if cfg["enable_cond"] else 0)


def encoder(sd, cfg, imgs, rnd):
    """(F, H, W, 3) normalised images -> (F, h*w, C) patch tokens."""
    p = cfg["patch_size"]
    if cfg["encoder"] == "conv":
        y = _conv(sd, "visual_geometry_transformer.patch_embed.proj",
                  imgs.permute(0, 3, 1, 2), rnd, stride=p)
        return y.flatten(2).transpose(1, 2)
    pe = "visual_geometry_transformer.patch_embed"
    Fr = imgs.shape[0]
    x = _conv(sd, f"{pe}.patch_embed.proj", imgs.permute(0, 3, 1, 2), rnd, stride=p)
    x = x.flatten(2).transpose(1, 2)
    pos = sd[f"{pe}.pos_embed"]
    if pos.shape[1] != x.shape[1] + 1:
        raise ValueError("the reference takes images at the configuration's img_size")
    x = torch.cat([sd[f"{pe}.cls_token"].expand(Fr, 1, -1), x], 1) + pos
    nreg = cfg["num_register_tokens"]
    x = torch.cat([x[:, :1], sd[f"{pe}.register_tokens"].expand(Fr, nreg, -1),
                   x[:, 1:]], 1)
    for i in range(cfg["encoder_depth"]):
        x = block(sd, f"{pe}.blocks.{i}", x, cfg["encoder_heads"], 1e-6, rnd)
    x = _ln(sd, f"{pe}.norm", x, 1e-6)
    return x[:, 1 + nreg:]


def trunk(sd, cfg, images, prec: Precision = REFERENCE) -> List[torch.Tensor]:
    """(B, S, H, W, 3) images in [0, 1] -> the 4 captured intermediates,
    each (B, S, N, 2C): concat(frame output, global output)."""
    rnd = prec.trunk
    B, S, H, W, _ = images.shape
    C, p = cfg["embed_dim"], cfg["patch_size"]
    dev = images.device
    mean = torch.tensor(_MEAN, device=dev)
    std = torch.tensor(_STD, device=dev)
    patches = encoder(sd, cfg, (images.reshape(B * S, H, W, 3) - mean) / std, rnd)
    vgt = "visual_geometry_transformer"

    def special(tok):
        t = torch.cat([tok[:, 0:1].expand(B, 1, *tok.shape[2:]),
                       tok[:, 1:2].expand(B, S - 1, *tok.shape[2:])], 1)
        return t.reshape(B * S, *tok.shape[2:])

    parts = [special(sd[f"{vgt}.cam_token"]), special(sd[f"{vgt}.reg_token"])]
    if cfg["enable_cond"]:   # no priors: the pose and ray tokens are zero
        parts += [torch.zeros(B * S, 2, C, device=dev)]
    x = torch.cat(parts + [patches], 1)
    N = x.shape[1]
    heads = cfg["trunk_heads"]
    rope = rope_tables(H // p, W // p, n_special(cfg), C // heads,
                       cfg["rope_freq"], dev)
    rope_g = tuple(t.repeat(S, 1) for t in rope)
    out = {}
    for i in range(cfg["trunk_depth"]):
        xf = block(sd, f"{vgt}.frame_blocks.{i}", x.reshape(B * S, N, C), heads,
                   1e-5, rnd, rope, cfg["qk_norm"])
        x = block(sd, f"{vgt}.global_blocks.{i}", xf.reshape(B, S * N, C), heads,
                  1e-5, rnd, rope_g, cfg["qk_norm"])
        if i in cfg["intermediate_idxs"]:
            out[i] = torch.cat([xf.reshape(B, S, N, C), x.reshape(B, S, N, C)], -1)
    return [out[i] for i in cfg["intermediate_idxs"]]


# --- camera head --------------------------------------------------------------

def camera_head(sd, cfg, tokens, rnd):
    """The last intermediate's camera tokens -> (B, S, 9) [t, quat xyzw,
    fov_v, fov_u] after `cam_head_steps` refinements."""
    cam = _ln(sd, "cam_head.token_norm", tokens[-1][:, :, 0], 1e-5)
    B, S, D = cam.shape
    curr = None
    for _ in range(cfg["cam_head_steps"]):
        inp = sd["cam_head.init_token"].expand(B, S, -1) if curr is None else curr
        mod = _linear(sd, "cam_head.adapt_norm_gen.1",
                      F.silu(_linear(sd, "cam_head.param_embed", inp, rnd)), rnd)
        shift, scale, gate = mod.chunk(3, -1)
        norm = F.layer_norm(cam, (D,), eps=1e-6)
        feat = gate * (norm * (1 + scale) + shift) + cam
        for i in range(cfg["cam_head_depth"]):
            feat = block(sd, f"cam_head.refine_net.{i}", feat, cfg["cam_head_heads"],
                         1e-5, rnd)
        h = _ln(sd, "cam_head.out_norm", feat, 1e-5)
        delta = _linear(sd, "cam_head.param_predictor.fc2",
                        F.gelu(_linear(sd, "cam_head.param_predictor.fc1", h, rnd)), rnd)
        curr = delta if curr is None else curr + delta
    return torch.cat([curr[..., :7], F.relu(curr[..., 7:])], -1)


# --- DPT heads ---------------------------------------------------------------

def _uv_embed(C, h, w, W_img, H_img, device):
    """The (C, h, w) sinusoidal embedding of the UV grid spanning
    +-span / diagonal, omega base 100, times 0.1."""
    ar = W_img / H_img
    diag = (ar ** 2 + 1.0) ** 0.5
    sx, sy = ar / diag, 1.0 / diag
    xs = np.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w)
    ys = np.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h)
    uu, vv = np.meshgrid(xs, ys)
    uv = torch.as_tensor(np.stack([uu, vv], -1), dtype=torch.float32, device=device)
    omega = np.arange(C // 4, dtype=np.float64) / (C / 4.0)
    omega = torch.as_tensor(1.0 / 100.0 ** omega, dtype=torch.float32, device=device)
    px = uv.reshape(-1, 2)[:, 0:1] * omega[None]
    py = uv.reshape(-1, 2)[:, 1:2] * omega[None]
    emb = torch.cat([torch.sin(px), torch.cos(px), torch.sin(py), torch.cos(py)], -1)
    return (emb.reshape(h, w, C) * 0.1).permute(2, 0, 1)[None]


def _resize(x, size):
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def _rcu(sd, name, x, rnd):
    a = F.relu(x)
    y = _conv(sd, f"{name}.conv1", a, rnd, padding=1)
    return _conv(sd, f"{name}.conv2", F.relu(y), rnd, padding=1) + a


def _fusion(sd, name, x, rnd, residual=None, size=None):
    if residual is not None:
        x = x + _rcu(sd, f"{name}.resConfUnit1", residual, rnd)
    x = _rcu(sd, f"{name}.resConfUnit2", x, rnd)
    x = _conv(sd, f"{name}.out_conv", x, rnd)
    return _resize(x, size if size is not None else (x.shape[-2] * 2, x.shape[-1] * 2))


def dpt(sd, name, tokens, images, start, rnd, gs=False):
    """One DPT head -> the f32 pre-activation map (B*S, H, W, out) NHWC
    (and the fused feature map (B*S, H, W, f/2) for the Gaussian head)."""
    B, S, H, W, _ = images.shape
    p = 14
    ph, pw = H // p, W // p
    dev = images.device
    feats = []
    for lvl in range(4):
        t = tokens[lvl][:, :, start:]
        t = _ln(sd, f"{name}.norm", t.reshape(B * S, ph * pw, t.shape[-1]), 1e-5)
        f = _conv(sd, f"{name}.projects.{lvl}",
                  t.transpose(1, 2).reshape(B * S, -1, ph, pw), rnd)
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
    fused = _resize(out, (ph * p, pw * p))
    fused = fused + _uv_embed(fused.shape[1], fused.shape[-2], fused.shape[-1], W, H, dev)
    head = _conv(sd, f"{sc}.output_conv2.0", fused, rnd, padding=1)
    head = _conv(sd, f"{sc}.output_conv2.2", F.relu(head), rnd).permute(0, 2, 3, 1)
    if not gs:
        return head
    img = images.reshape(B * S, H, W, 3).permute(0, 3, 1, 2)
    fused = fused + F.relu(_conv(sd, f"{name}.input_merger.0", img, rnd, padding=3))
    return head, fused.permute(0, 2, 3, 1)


def _activate(head, attr, B, S):
    x, c = head[..., :-1], head[..., -1]
    if attr == "inv_log":
        x = torch.sign(x) * torch.expm1(torch.abs(x))
    elif attr == "exp":
        x = torch.exp(x)
    elif attr == "norm":
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    return (x.reshape(B, S, *x.shape[1:]),
            (1 + torch.exp(c)).reshape(B, S, *c.shape[1:]))


def heads(sd, cfg, tokens, images, prec: Precision = REFERENCE) -> Dict[str, torch.Tensor]:
    """Every head from the trunk's intermediates (any dtype; taken as f32)
    -> camera_params_pred, depth(_conf), pts3d(_conf), normals(_conf),
    gs_depth(_conf) and gs_feat (B, S, H, W, f/2)."""
    rnd = prec.heads
    B, S = images.shape[:2]
    tokens = [t.float() for t in tokens]
    start = n_special(cfg)
    out = {"camera_params_pred": camera_head(sd, cfg, tokens, rnd)}
    out["depth"], out["depth_conf"] = _activate(
        dpt(sd, "depth_head", tokens, images, start, rnd), "exp", B, S)
    out["pts3d"], out["pts3d_conf"] = _activate(
        dpt(sd, "pts_head", tokens, images, start, rnd), "inv_log", B, S)
    out["normals"], out["normals_conf"] = _activate(
        dpt(sd, "norm_head", tokens, images, start, rnd), "norm", B, S)
    head, fused = dpt(sd, "gs_head", tokens, images, start, rnd, gs=True)
    out["gs_depth"], out["gs_depth_conf"] = _activate(head, "exp", B, S)
    out["gs_feat"] = fused.reshape(B, S, *fused.shape[1:])
    return out
