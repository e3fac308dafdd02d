"""The CenterSnap training step's operations, counted from its shapes.

The benchmark's own count, written from the fork's published architecture
(wmbench/configs/centersnap_sope.json) for one training step of batch B:
the frozen backbone's forward; the trunk's and the depth prior's forward
and backward; both DPT heads' forward and backward. Every count is the
direct count of the algorithm's work: a matrix product of (M, K) by
(K, N) at 2 M K N, a convolution at 2 k k cin cout an output pixel (a
transposed one at 2 k k cin cout an input pixel), attention at its two
products, whatever algorithm the library picks. A backward counts the
gradient of each weight (as much as the forward) and the gradient of each
input that needs one (as much again): the trunk's and the heads' inputs
all do, the depth prior's pixels do not. Elementwise work, norms, the
loss and AdamW are not counted. By dtype as the configuration runs them:
the backbone, the trunk and the depth prior in bf16, the heads in f32.
"""

from typing import Dict, Sequence


def block_flops(tokens: float, seqs: float, seq_len: float, C: float,
                mlp_ratio: float = 4.0) -> float:
    """One pre-LN transformer block's forward: qkv, proj and the MLP's two
    products, and the attention's two."""
    return 2.0 * tokens * C * (4 * C + 2 * mlp_ratio * C) + 4.0 * seqs * seq_len * seq_len * C


def backbone_flops(B: int, P: int, C: int, depth: int, n_reg: int, patch: int) -> float:
    """The ViT's forward over B images of P patches: its patchify and
    `depth` blocks over cls + registers + patches."""
    N = P + 1 + n_reg
    return depth * block_flops(B * N, B, N, C) + 2.0 * B * P * (patch * patch * 3) * C


def trunk_flops(B: int, P: int, C: int, depth: int, n_special: int) -> float:
    """The frame-only trunk's forward over B images."""
    N = P + n_special
    return depth * block_flops(B * N, B, N, C)


def depth_prior_flops(B: int, P: int, C: int, patch: int) -> Dict[str, float]:
    """The depth prior's MLP (patch^2 -> 4C -> C a patch): its forward and
    its backward (fc1's weight only: its input is the depth itself)."""
    fc1 = 2.0 * B * P * patch * patch * 4 * C
    fc2 = 2.0 * B * P * 4 * C * C
    return {"forward": fc1 + fc2, "backward": fc1 + 2 * fc2}


def dpt_flops(B: int, H: int, W: int, patch: int, dim_in: int, f: int,
              ocs: Sequence[int], output_dim: int, down_ratio: int) -> float:
    """One DPT head's forward over B images: the 1x1 projections on the
    patch grid, the resizes (x4 and x2 transposed, stride-2 3x3), the 3x3
    scratch convs, the fusion blocks (residual units of two 3x3 convs; the
    1x1 out_conv before each x2 resize), output_conv1 at 8x the grid, the
    two output convs at the image size over down_ratio."""
    ph, pw = H // patch, W // patch
    p2 = ph * pw
    q2 = ((ph + 1) // 2) * ((pw + 1) // 2)            # the stride-2 level
    res = [16 * p2, 4 * p2, p2, q2]
    fl = sum(2.0 * p2 * dim_in * oc for oc in ocs)
    fl += 2.0 * p2 * 16 * ocs[0] * ocs[0] + 2.0 * p2 * 4 * ocs[1] * ocs[1]
    fl += 2.0 * q2 * 9 * ocs[3] * ocs[3]
    fl += sum(2.0 * r * 9 * oc * f for r, oc in zip(res, ocs))
    for r, units in zip(res, (2, 2, 2, 1)):           # refinenet1 .. refinenet4
        fl += units * 2 * 2.0 * r * 9 * f * f + 2.0 * r * f * f
    fl += 2.0 * (4 * res[0]) * 9 * f * (f // 2)
    out_px = (ph * patch // down_ratio) * (pw * patch // down_ratio)
    fl += 2.0 * out_px * 9 * (f // 2) * 32 + 2.0 * out_px * 32 * output_dim
    return B * fl


def step_flops(cfg: dict, B: int) -> Dict[str, float]:
    """One training step's operations by dtype, {"bf16": ..., "f32": ...},
    for a configuration file at batch B."""
    p, H = cfg["patch_size"], cfg["img_size"]
    P = (H // p) ** 2
    C = cfg["embed_dim"]
    n_special = 1 + cfg["num_register_tokens"] + 2
    bf16 = backbone_flops(B, P, cfg["encoder_dim"], cfg["encoder_depth"],
                          cfg["num_register_tokens"], p)
    bf16 += 3 * trunk_flops(B, P, C, cfg["trunk_depth"], n_special)
    if cfg["depth_cond"]:
        prior = depth_prior_flops(B, P, C, p)
        bf16 += prior["forward"] + prior["backward"]
    f = cfg["head_features"]
    ocs = cfg["head_out_channels"]
    heads = (dpt_flops(B, H, H, p, C, f, ocs, 1, 1)
             + dpt_flops(B, H, H, p, C, f, ocs, 12, cfg["pose_down_ratio"]))
    return {"bf16": bf16, "f32": 3 * heads}
