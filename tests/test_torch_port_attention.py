"""Port attention (ops/attention.py, the plain version of kernel K1) vs the
JAX attention oracle (attn_onepass._einsum_ref) and models/block.attention.

f32: atol 1e-5. bf16 inputs: atol 2e-3 against the f32 oracle on the
bf16-rounded inputs (attn_onepass.py documents ~1e-3 for its bf16 kernel).
On a CPU tensor the wrapper runs the plain version and launches nothing.
"""

import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import close, normal, state_dict_np, t
from hunyuanworld_mirror_tpu.models import block as jblock
from hunyuanworld_mirror_tpu.models import rope as jrope
from hunyuanworld_mirror_tpu.ops.attn_onepass import _einsum_ref
from hunyuanworld_mirror_tpu_torch.models import block as pblock
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.models import rope as prope
from hunyuanworld_mirror_tpu_torch.ops import attention as pattn
from tools import convert_weights as cw

SHAPES = [(n, d) for n in (5, 37, 130, 300) for d in (64, 128)]
# the CUDA kernel's tile edges at D = 64: 128-key tiles, and 192-query
# blocks (three consumer warpgroups of 64 rows)
EDGE_N = (127, 128, 129, 193, 257)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


def _qkv(n, d, seed, b=2, h=2):
    # v at 0.1 keeps |out| < 0.5, where a bf16 output rounds by <= 1e-3
    return [normal(seed + i, (b, n, h, d), 0.1 if i == 2 else 1.0)
            for i in range(3)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_f32_matches_einsum_ref(n, d):
    q, k, v = _qkv(n, d, seed=n + d)
    scale = d ** -0.5
    ref = _einsum_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    close(pattn.attention_plain(t(q), t(k), t(v), scale), ref, 1e-5)


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_bf16_band(n, d):
    q, k, v = (t(a).bfloat16() for a in _qkv(n, d, seed=3 * n + d))
    scale = d ** -0.5
    out = pattn.attention_plain(q, k, v, scale)
    assert out.dtype == torch.bfloat16
    ref = _einsum_ref(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), scale)
    close(out, ref, 2e-3)


@pytest.mark.parametrize("qk_norm,use_rope", [(False, False), (True, True)])
def test_attention_module_matches_block_attention(qk_norm, use_rope):
    dim, heads, h0, w0, n_special = 128, 2, 4, 5, 5
    n = n_special + h0 * w0
    mod = pblock.Attention(dim, heads, qk_norm=qk_norm)
    pnn.init_weights(mod, torch.Generator().manual_seed(0))
    sd = state_dict_np(mod)
    p = {"qkv": cw._linear(sd, "qkv"), "proj": cw._linear(sd, "proj")}
    if qk_norm:
        p["q_norm"], p["k_norm"] = cw._ln(sd, "q_norm"), cw._ln(sd, "k_norm")
    pos = prope.grid_positions(h0, w0, n_special)
    rope_p = prope.make_rope_tables(pos, dim // heads) if use_rope else None
    rope_j = jrope.make_rope_tables(pos, dim // heads) if use_rope else None
    x = normal(11, (2, n, dim))
    with torch.no_grad():
        out = mod(t(x), rope_p)
    ref = jblock.attention(p, jnp.asarray(x), heads, rope=rope_j)
    close(out, ref, 1e-5)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    q, k, v = (t(a) for a in _qkv(37, 64, seed=5))
    before = (pattn.attention.launches, pattn.attention.flash_route_launches)
    out = pattn.attention(q, k, v, 0.125)
    assert (pattn.attention.launches, pattn.attention.flash_route_launches) == before
    assert torch.equal(out, pattn.attention_plain(q, k, v, 0.125))


def _held_to_oracle(q, k, v, scale):
    """attention_plain on (possibly strided) q, k, v against _einsum_ref on
    the same values, at the file's band for their dtype."""
    out = pattn.attention_plain(q, k, v, scale)
    assert out.dtype == q.dtype
    ref = _einsum_ref(*(jnp.asarray(x.float().contiguous().numpy())
                        for x in (q, k, v)), scale)
    close(out, ref, ATOL[q.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", EDGE_N)
def test_plain_at_tile_edges(n, dtype):
    q, k, v = (t(a).to(dtype) for a in _qkv(n, 64, seed=7 * n))
    _held_to_oracle(q, k, v, 64 ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_past_flash_threshold(dtype):
    # N >= 4096 is the JAX package's flash route (K1b); one head keeps the
    # (N, N) logits at 67 MB
    n = 4100
    assert n >= pattn.FLASH_MIN_N
    q, k, v = (t(a).to(dtype) for a in _qkv(n, 64, seed=11, b=1, h=1))
    _held_to_oracle(q, k, v, 64 ** -0.5)


def test_plain_on_fused_qkv_views():
    # the encoder's layout: q, k, v are views of one (B, N, 3, H, D) tensor,
    # N-stride 3 H D, as the kernel receives them without a copy
    fused = t(normal(13, (2, 130, 3, 2, 64)))
    fused[:, :, 2] *= 0.1
    q, k, v = fused.unbind(2)
    assert q.stride() == (130 * 3 * 128, 3 * 128, 64, 1) and not q.is_contiguous()
    _held_to_oracle(q, k, v, 0.125)
    assert torch.equal(pattn.attention(q, k, v, 0.125),
                       pattn.attention_plain(q, k, v, 0.125))


def test_negative_scale_folds_into_q():
    # the wrapper hands the CUDA kernel (-q, -scale) for a negative scale
    q, k, v = (t(a) for a in _qkv(37, 64, seed=17))
    close(pattn.attention_plain(-q, k, v, 0.125),
          pattn.attention_plain(q, k, v, -0.125), 1e-6)

