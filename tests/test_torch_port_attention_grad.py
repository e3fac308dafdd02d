"""The gradient through kernel K1 (ops/attention.py) against the JAX VJP.

On the card `attention` runs K1 as the forward of an autograd Function
whose backward is `attention_replay_grads`: the replay of
attn_onepass._einsum_ref's math (q * scale, logits in the input dtype, an
f32 softmax rounded to the input dtype, the PV einsum), which is what
onepass_attention's custom VJP differentiates. K1 has no CPU build, so the
Function itself runs only on the card (chip_smoke.py phase 15 (a)); here the
replay helper it calls is held against jax.vjp of _einsum_ref on the same
inputs and cotangent: f32 within 1e-5 (absolute, |grads| ~ 1), bf16 within
two bf16 ulps of the largest gradient (2^-6 of max|g|: both sides round
the logits, the weights and the backward's products to bf16, each its own
way), and with a negative scale
(the kernel negates q; the backward must use the original q).

On the CPU `attention` is attention_plain and stays differentiable by
autograd; the replay is not attention_plain (its logits are f32), so in
bf16 the two give different gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import close, normal, np_, t
from hunyuanworld_mirror_tpu.ops.attn_onepass import _einsum_ref
from hunyuanworld_mirror_tpu_torch.ops import attention as pattn

SHAPES = [(2, 37, 2, 64), (1, 130, 3, 64), (2, 67, 2, 128)]


def _inputs(shape, seed):
    q, k, v = (normal(seed + i, shape) for i in range(3))
    g = normal(seed + 3, shape)
    return q, k, v, g


def _jax_vjp(q, k, v, g, scale, dtype):
    qj, kj, vj, gj = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: _einsum_ref(a, b, c, scale), qj, kj, vj)
    return [np.asarray(x, np.float32) for x in vjp(gj)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_replay_grads_match_jax_vjp_f32(shape, sign):
    q, k, v, g = _inputs(shape, seed=sum(shape))
    scale = sign * shape[-1] ** -0.5
    ours = pattn.attention_replay_grads(t(q), t(k), t(v), scale, t(g))
    ref = _jax_vjp(q, k, v, g, scale, jnp.float32)
    for name, a, b in zip("qkv", ours, ref):
        close(a, b, 1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_replay_grads_match_jax_vjp_bf16(shape, sign):
    q, k, v, g = (np_(t(a).bfloat16()) for a in _inputs(shape, seed=2 * sum(shape)))
    scale = sign * shape[-1] ** -0.5
    bf = [t(a).bfloat16() for a in (q, k, v, g)]
    ours = pattn.attention_replay_grads(*bf[:3], scale, bf[3])
    assert all(x.dtype == torch.bfloat16 for x in ours)
    ref = _jax_vjp(q, k, v, g, scale, jnp.bfloat16)
    for name, a, b in zip("qkv", ours, ref):
        close(a, b, 2.0 ** -6 * np.abs(b).max(), err_msg=f"d{name}")


def test_replay_forward_is_einsum_ref():
    q, k, v, _ = _inputs((2, 37, 2, 64), seed=9)
    ref = _einsum_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125)
    close(pattn.attention_replay(t(q), t(k), t(v), 0.125), ref, 1e-5)


def test_cpu_attention_is_differentiable_and_launches_nothing():
    q, k, v, g = (t(a) for a in _inputs((2, 37, 2, 64), seed=21))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (pattn.attention.launches, pattn.attention.backward_replays)
    out = pattn.attention(q, k, v, 0.125)
    assert out.grad_fn is not None
    out.backward(g)
    assert (pattn.attention.launches, pattn.attention.backward_replays) == before
    # f32: the plain version's gradient is the replay's to rounding
    ref = pattn.attention_replay_grads(q, k, v, 0.125, g)
    for name, a, b in zip("qkv", (q.grad, k.grad, v.grad), ref):
        close(a, b, 1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_function_plumbing_with_a_stand_in_launch(monkeypatch, sign):
    """The autograd Function around K1 with the launch replaced by its
    plain version (K1 cannot run here): the output has a grad_fn, the
    backward replays on the saved q (not the negated one the launch
    takes for a negative scale), counts one replay and launches nothing."""
    launched = []

    def stand_in(q, k, v, scale):
        launched.append(scale)
        if scale < 0:
            q, scale = -q, -scale
        with torch.no_grad():
            return pattn.attention_plain(q, k, v, scale)

    monkeypatch.setattr(pattn, "_launch", stand_in)
    q, k, v, g = (t(a) for a in _inputs((2, 37, 2, 64), seed=33))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    scale = sign * 0.125
    replays = pattn.attention.backward_replays
    out = pattn._AttentionK1.apply(*leaves, scale)
    assert out.grad_fn is not None and launched == [scale]
    out.backward(g)
    assert launched == [scale]
    assert pattn.attention.backward_replays == replays + 1
    ref = _jax_vjp(q, k, v, g, scale, jnp.float32)
    for name, a, b in zip("qkv", (x.grad for x in leaves), ref):
        close(a, b, 1e-5, err_msg=f"d{name}")
