"""The port's multi-device layer: the mesh, its collectives, ring attention
and a tensor-parallel block, on gloo process groups over the CPU.

The port's side runs in 2 or 4 processes that parallel.mesh.spawn starts
(a `file://` store, no network); they import no JAX. The JAX side runs here
on the 8-device CPU mesh tests/conftest.py forces, and the inputs go to
both as numpy.

Bands:
- every comm Function, forward and backward, in f64 against the
  one-process math of JAX's transposes: 1e-12;
- ring_self_attention at V = 2 and 4 against JAX's ring_self_attention at
  make_mesh(1, V, 1) (test_ring.py's inputs): f32 1e-5 as test_ring.py:37;
  the gradients of sum(out^2) 1e-4 as test_ring.py:64; bf16 within JAX's
  own bf16 error (both against the f32 answer: the port's error at most
  1.25x JAX's plus one bf16 ulp of the largest output);
- V = 1 (no ring): the port's dense branch against JAX's, f32 1e-6;
- a Block at model = 2 (heads and MLP split) against the same block
  unsharded: its output 1e-5 and every parameter's gradient 1e-5 relative
  to the largest gradient of its layer (f32; only the summation order
  differs; k_norm's bias has a zero gradient in exact arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (comm_worker, normal, ring_worker, spawn_gloo,
                                tp_block_worker)
from hunyuanworld_mirror_tpu.parallel import mesh as jmesh
from hunyuanworld_mirror_tpu.parallel.ring import ring_self_attention as jring
from hunyuanworld_mirror_tpu_torch import multichip
from hunyuanworld_mirror_tpu_torch.models.block import Block
from hunyuanworld_mirror_tpu_torch.models.nn import init_weights
from hunyuanworld_mirror_tpu_torch.parallel import mesh as pmesh, ring as pring


# --- mesh ---------------------------------------------------------------------

def test_make_mesh_needs_the_world_size():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.make_mesh(1, 2, 1)
    m = pmesh.make_mesh()
    assert m.dims == (1, 1, 1) and m.coords == (0, 0, 0)
    assert m.shape == {"data": 1, "view": 1, "model": 1}
    assert all(m.group(a) is None for a in ("data", "view", "model", "replica"))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_dims_follow_jax(n):
    """multichip.dims_for is __graft_entry__'s factoring; auto_mesh's view
    axis is jmesh.auto_mesh's."""
    want = ((n // 8, 4, 2) if n % 8 == 0 else (n // 4, 2, 2) if n % 4 == 0
            else (n // 2, 2, 1) if n % 2 == 0 else (1, 1, 1))
    assert multichip.dims_for(n) == want
    if n <= 8:
        view = jmesh.auto_mesh(n).shape["view"]
        assert view == next(c for c in (8, 4, 2, 1) if n % c == 0)


def test_nccl_refuses_more_ranks_than_cards():
    with pytest.raises(ValueError, match='backend="gloo"'):
        pmesh.spawn(comm_worker, torch.cuda.device_count() + 1, backend="nccl")


def test_multichip_entry_raises_without_a_gpu():
    """The twin's main(): with no card and no device it raises before it
    starts a process; NCCL with more ranks than cards names gloo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.main([])
    with pytest.raises(ValueError, match='backend="gloo"'):
        multichip.main(["--devices", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multichip.main(["--devices", "2", "--backend", "gloo"])


def test_spawn_without_a_device_raises_on_a_machine_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.spawn(comm_worker, 2, backend="gloo")


# --- comm ---------------------------------------------------------------------

def _comm_inputs(n):
    rng = np.random.default_rng(n)
    shapes = {"all_gather": (3, 2, 5), "all_to_all": (2 * n, 3, 2), "ppermute": (4, 3),
              "all_reduce": (4, 3), "copy_to_tp": (4, 3), "reduce_from_tp": (4, 3)}
    out_shapes = {"all_gather": (3, 2 * n, 5), "all_to_all": (2, 3 * n, 2)}
    xs = {k: rng.normal(size=(n,) + s) for k, s in shapes.items()}
    gs = {k: rng.normal(size=(n,) + out_shapes.get(k, s)) for k, s in shapes.items()}
    return xs, gs


def _comm_reference(name, x, g):
    """Per rank (output, input gradient) of the one-process math."""
    n = x.shape[0]
    if name == "all_gather":
        full = np.concatenate(list(x), axis=1)
        gsum = g.sum(0)
        return [(full, gsum[:, r * 2:(r + 1) * 2]) for r in range(n)]
    if name == "all_to_all":
        c = x.shape[1] // n
        outs = [np.concatenate([x[q][r * c:(r + 1) * c] for q in range(n)], axis=1)
                for r in range(n)]
        grads = [np.concatenate([g[r][:, q * 3:(q + 1) * 3] for r in range(n)], axis=0)
                 for q in range(n)]
        return list(zip(outs, grads))
    if name == "ppermute":
        return [(x[(r - 1) % n], g[(r + 1) % n]) for r in range(n)]
    if name in ("all_reduce", "reduce_from_tp"):
        return [(x.sum(0), g[r]) for r in range(n)]
    if name == "copy_to_tp":
        return [(x[r], g.sum(0)) for r in range(n)]
    raise KeyError(name)


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def comm_run(request):
    n = request.param
    xs, gs = _comm_inputs(n)
    return n, xs, gs, spawn_gloo(comm_worker, n, xs, gs)


@pytest.mark.parametrize("name", ["all_gather", "all_to_all", "ppermute", "all_reduce",
                                  "copy_to_tp", "reduce_from_tp"])
def test_comm_forward_and_transpose(comm_run, name):
    n, xs, gs, outs = comm_run
    ref = _comm_reference(name, xs[name], gs[name])
    for r in range(n):
        y, gx = outs[r][name]
        np.testing.assert_allclose(y, ref[r][0], atol=1e-12, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(gx, ref[r][1], atol=1e-12, err_msg=f"{name} rank {r} grad")


# --- ring attention -------------------------------------------------------------

def _qkv(seed, B=2, N=48, H=4, D=16):
    return [normal(seed + i, (B, N, H, D)) for i in range(3)]


def _jax_ring(q, k, v, V, dtype=jnp.float32):
    mesh = jmesh.make_mesh(1, V, 1)
    scale = q.shape[-1] ** -0.5
    qj, kj, vj = (jnp.asarray(a, dtype) for a in (q, k, v))
    out = jax.jit(lambda a, b, c: jring(a, b, c, mesh, scale))(qj, kj, vj)
    if dtype != jnp.float32:
        return np.asarray(out.astype(jnp.float32))
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jring(a, b, c, mesh, scale) ** 2),
                             argnums=(0, 1, 2)))(qj, kj, vj)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module", params=[2, 4], ids=["V2", "V4"])
def ring_run(request):
    V = request.param
    q, k, v = _qkv(10)
    cases = [(q, k, v, "float32"), (q, k, v, "bfloat16")]
    outs = spawn_gloo(ring_worker, V, cases)
    return V, (q, k, v), outs


def test_ring_f32_matches_jax(ring_run):
    V, (q, k, v), outs = ring_run
    ref, ref_grads = _jax_ring(q, k, v, V)
    ours = np.concatenate([o[0][0] for o in outs], axis=1)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    for i in range(3):
        g = np.concatenate([o[0][1][i] for o in outs], axis=1)
        np.testing.assert_allclose(g, ref_grads[i], atol=1e-4, rtol=1e-4,
                                   err_msg="qkv"[i])


def test_ring_bf16_within_jax_bf16_error(ring_run):
    V, (q, k, v), outs = ring_run
    exact, _ = _jax_ring(q, k, v, V)
    ref = _jax_ring(q, k, v, V, jnp.bfloat16)
    ours = np.concatenate([o[1][0] for o in outs], axis=1)
    err_jax = np.abs(ref - exact).max()
    err_port = np.abs(ours - exact).max()
    ulp = 2.0 ** -8 * np.abs(exact).max()
    assert err_port <= 1.25 * err_jax + ulp, (err_port, err_jax, ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_view_axis_of_one_is_jax_dense_branch(dtype):
    q, k, v = _qkv(20, B=2, N=16, H=2, D=8)
    jd = getattr(jnp, dtype)
    scale = 8 ** -0.5
    ref = jring(*(jnp.asarray(a, jd) for a in (q, k, v)), jmesh.make_mesh(8, 1, 1), scale)
    td = getattr(torch, dtype)
    ours = pring.ring_self_attention(*(torch.tensor(a).to(td) for a in (q, k, v)),
                                     pmesh.make_mesh(), scale)
    atol = 1e-6 if dtype == "float32" else 2.0 ** -8 * float(np.abs(ref).max())
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=atol)


# --- tensor parallelism -----------------------------------------------------------

@pytest.fixture(scope="module")
def tp_run():
    blk = Block(64, 4, init_values=0.01, qk_norm=True)
    init_weights(blk, torch.Generator().manual_seed(3))
    with torch.no_grad():      # LayerNorm affines off their init, so their
        for p in blk.parameters():   # gradients are not trivially shared
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    state = {k: v.numpy() for k, v in blk.state_dict().items()}
    x, g = normal(30, (2, 10, 64)), normal(31, (2, 10, 64))
    y = blk(torch.tensor(x))
    (y * torch.tensor(g)).sum().backward()
    ref = (y.detach().numpy(), {n: p.grad.numpy() for n, p in blk.named_parameters()})
    return ref, spawn_gloo(tp_block_worker, 2, state, x, g)


def test_tp_block_forward_matches_unsharded(tp_run):
    (y, _), outs = tp_run
    for r, (ours, _) in enumerate(outs):
        np.testing.assert_allclose(ours, y, atol=1e-5, err_msg=f"rank {r}")


def test_tp_block_gradients_match_unsharded(tp_run):
    (_, grads), outs = tp_run
    # the scale of a gradient is its layer's: k_norm's bias has none of its
    # own (the softmax ignores a bias shared by every key)
    scale = {}
    for name, g in grads.items():
        layer = name.rsplit(".", 1)[0]
        scale[layer] = max(scale.get(layer, 0.0), float(np.abs(g).max()))
    for r, (_, ours) in enumerate(outs):
        assert set(ours) == set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(ours[name], g,
                                       atol=1e-5 * scale[name.rsplit(".", 1)[0]],
                                       err_msg=f"rank {r} {name}")
