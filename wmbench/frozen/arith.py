"""The yardstick's arithmetic: operations and bytes computed from shapes.

Frozen copies, so that a later change to the program cannot move the
yardstick it is judged by:

- `attention_flops`, `rasterizer_bytes`: hunyuanworld_mirror_tpu_torch/
  utils/profiling.py at commit e2e15df8eb5b1f9149d8000ecb6c575b37fbec06.
- `_block_flops`, `encoder_flops`, `trunk_flops`, `dpt_flops`,
  `model_flops`: hunyuanworld_mirror_tpu_torch/bench.py at the same
  commit, with `n_special` 7 (the trunk's special tokens under
  enable_cond) as the default.

`attention_calls`, `k2_bytes`, `k3_bytes` and `refine_step_bytes` are the
benchmark's own, written from the model's published shapes. Every count here is the direct count of the
algorithm's work: convolutions at 2 * k * k * cin * cout a pixel, whatever
algorithm cuDNN picks.
"""

from typing import List, NamedTuple


def attention_flops(B: int, N: int, H: int, D: int) -> float:
    """QK^T + PV matmul FLOPs for one attention call."""
    return 2.0 * B * H * N * N * D * 2


def rasterizer_bytes(n_splats: int, n_pix: int, k_per_tile: int,
                     n_tiles: int, d_channels: int) -> float:
    """HBM traffic lower bound for the tile blender: staged splat rows +
    written pixels."""
    splat_row = (2 + 3 + d_channels + 1) * 4
    return n_tiles * k_per_tile * splat_row + n_pix * (d_channels + 1) * 4


def _block_flops(tokens: float, C: float, n_seq: float, seq_len: float,
                 mlp_ratio: float = 4.0) -> float:
    """One pre-LN transformer block: qkv(3C)+proj(C)+mlp(2*ratio*C) GEMMs
    plus the two attention matmuls."""
    linear = 2.0 * tokens * C * (4 * C + 2 * mlp_ratio * C)
    attn = 4.0 * n_seq * seq_len * seq_len * C
    return linear + attn


def encoder_flops(BS: int, P: int, C: int = 1024, depth: int = 24) -> float:
    """DINOv2 ViT-L/14 over B*S frames (cls + 4 reg + P patch tokens)."""
    N = P + 5
    return depth * _block_flops(BS * N, C, BS, N) + 2.0 * BS * P * (14 * 14 * 3) * C


def trunk_flops(B: int, S: int, P: int, C: int = 1024, depth: int = 24,
                n_special: int = 7) -> float:
    """24x alternating (frame, global) blocks."""
    Nf = P + n_special
    T = B * S * Nf
    frame = _block_flops(T, C, B * S, Nf)
    glob = _block_flops(T, C, B, S * Nf)
    return depth * (frame + glob)


def dpt_flops(S: int, H: int, W: int, dim_in: int = 2048, f: int = 256,
              ocs=(256, 512, 1024, 1024), output_dim: int = 4) -> float:
    """One DPT head over S frames at (H, W), patch 14 (models/dpt.py)."""
    ph, pw = H // 14, W // 14
    p2 = ph * pw
    fl = 0.0
    for oc in ocs:
        fl += 2.0 * p2 * dim_in * oc
    fl += 2.0 * p2 * 16 * ocs[0] * ocs[0]
    fl += 2.0 * p2 * 4 * ocs[1] * ocs[1]
    fl += 2.0 * (p2 / 4) * 9 * ocs[3] * ocs[3]
    res = [16 * p2, 4 * p2, p2, p2 / 4]
    for r, oc in zip(res, ocs):
        fl += 2.0 * r * 9 * oc * f
    units = [1, 2, 2, 2]
    for r, u in zip(res[::-1], units):
        fl += u * 2 * 2.0 * r * 9 * f * f
        fl += 2.0 * (4 * r) * f * f
    fl += 2.0 * (4 * res[0]) * 9 * f * (f // 2)
    fl += 2.0 * H * W * 9 * (f // 2) * 32 + 2.0 * H * W * 32 * output_dim
    return S * fl


def model_flops(B: int, S: int, H: int, W: int, C: int = 1024,
                gs_dim: int = 256, n_special: int = 7) -> dict:
    """Analytic forward FLOPs by phase: encoder, trunk and heads (the
    render is counted in bytes)."""
    P = (H // 14) * (W // 14)
    enc = encoder_flops(B * S, P, C)
    trk = trunk_flops(B, S, P, C, n_special=n_special)
    heads = (dpt_flops(B * S, H, W, 2 * C, 256, output_dim=4) * 2
             + dpt_flops(B * S, H, W, 2 * C, 256, output_dim=2)
             + dpt_flops(B * S, H, W, 2 * C, gs_dim, output_dim=2))
    heads += 4 * 4 * _block_flops(B * S, 2 * C, B, S)
    heads += B * S * H * W * (2.0 * 9 * (gs_dim // 2) * gs_dim
                              + 2.0 * gs_dim * 14)
    return {"encoder": enc, "trunk": trk, "heads": heads,
            "total": enc + trk + heads}


class AttnCall(NamedTuple):
    B: int
    N: int
    H: int
    D: int
    dtype: str   # "bf16" or "f32": the peak its least time is taken at
    count: int   # calls a forward


def attention_calls(cfg: dict, B: int, S: int) -> List[AttnCall]:
    """The softmax attention calls of one forward of a WorldMirror
    configuration file (wmbench/configs/*.json): the encoder's and the
    trunk's frame layers on B*S frames, the global layers on B sequences of
    S frames, all bf16; the camera head's f32 blocks (2C wide) on B
    sequences of S tokens, `cam_head_steps` x `cam_head_depth` calls."""
    C, p = cfg["embed_dim"], cfg["patch_size"]
    P = (cfg["img_size"] // p) ** 2
    enc_tokens = P + 1 + cfg["num_register_tokens"]
    n_special = 1 + cfg["num_register_tokens"] + (2 if cfg["enable_cond"] else 0)
    Nf = P + n_special
    Ce, He = cfg["encoder_dim"], cfg["encoder_heads"]
    Ht = cfg["trunk_heads"]
    Hc = cfg["cam_head_heads"]
    return [
        AttnCall(B * S, enc_tokens, He, Ce // He, "bf16", cfg["encoder_depth"]),
        AttnCall(B * S, Nf, Ht, C // Ht, "bf16", cfg["trunk_depth"]),
        AttnCall(B, S * Nf, Ht, C // Ht, "bf16", cfg["trunk_depth"]),
        AttnCall(B, S, Hc, 2 * C // Hc, "f32",
                 cfg["cam_head_steps"] * cfg["cam_head_depth"]),
    ]


def k2_bytes(n_isects: float, n_pix: int, d_channels: int) -> float:
    """The blend's bytes for one camera's list of `n_isects` entries and
    `n_pix` pixels of d_channels + alpha: rasterizer_bytes with the entries
    as one tile's list (the splat rows it stages are one a list entry)."""
    return rasterizer_bytes(0, n_pix, int(n_isects), 1, d_channels)


def k3_bytes(n_isects: float, n_pix: int, n_splats: int, d_channels: int) -> float:
    """The blend backward's bytes for one camera: the sorted list's f32
    rows and entry ids read once, the cotangents (d_channels + alpha) and
    the transmittance and last-entry planes read once a pixel, the touched
    splats' gradient rows (2 + 3 + 1 + d_channels + 2 absgrad) written
    once."""
    return (n_isects * ((6 + d_channels) * 4 + 4) + n_pix * (d_channels + 3) * 4
            + n_splats * (8 + d_channels) * 4)


def refine_step_bytes(n_slots: int, n_live: int, n_cams: int, k2: float, k3: float) -> float:
    """A refinement step's least bytes: Adam over every slot's 14 values
    (parameter, gradient and both moments read, parameter and moments
    written), each camera's projection (a live splat's 14 values read, its
    12 projected ones written), and the blends forward (k2) and backward
    (k3). The sorts and the loss are not counted, so the bound stays below
    what the step must move."""
    adam = n_slots * 14 * 4 * 7
    projection = n_cams * n_live * (14 + 12) * 4
    return adam + projection + k2 + k3
