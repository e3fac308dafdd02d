"""The plain version of kernel K3, through the port's autograd Function,
against the JAX package's own K3: jax.grad through the custom VJP of
rasterize_flat_pallas, whose backward runs in Pallas interpret mode
(atol = rtol = 1e-3, the JAX suite's own band)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_raster import GRAD_TOL, TILE, W, H, _projected
from torch_port_helpers import close, t
from hunyuanworld_mirror_tpu.ops.rasterizer_pallas import rasterize_flat_pallas
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast


def _opaque_stack():
    """600 near-opaque splats on one spot: early stop must engage."""
    n = 600
    return dict(m2d=np.tile([[16.0, 16.0]], (n, 1)).astype(np.float32),
                con=np.tile([[0.5, 0.0, 0.5]], (n, 1)).astype(np.float32),
                col=np.concatenate([np.linspace(0, 1, n)[:, None] * np.ones((1, 3)),
                                    np.linspace(1, 2, n)[:, None]], -1).astype(np.float32),
                op=np.full((n,), 0.9, np.float32),
                rad=np.full((n, 2), 5, np.int32),
                dep=np.linspace(1.0, 2.0, n).astype(np.float32))


@pytest.mark.parametrize("case", ["scene", "multi_chunk", "opaque"])
def test_plain_k3_matches_pallas_interpret(case):
    """Grads of means2d, conics, colours, opacities and the AbsGS absgrad
    through the port's RasterizeFlat against jax.grad through the JAX
    package's custom VJP, whose backward is its K3 in interpret mode."""
    if case == "opaque":
        s, (w, h), mpt, tpg = _opaque_stack(), (32, 32), 1024, 4
    else:
        n, mpt = (60, 512) if case == "scene" else (400, 1024)
        s, (w, h), tpg = _projected(n), (W, H), 12
    rng = np.random.default_rng(5)
    v_img = rng.normal(size=(h, w, 4)).astype(np.float32)
    v_alpha = rng.normal(size=(h, w, 1)).astype(np.float32)
    n = len(s["op"])

    def loss_j(m, c, col, op, tap):
        img, a, _ = rasterize_flat_pallas(
            m, c, col, op, jnp.asarray(s["rad"]), jnp.asarray(s["dep"]), tap,
            w, h, TILE, tpg, mpt, True)
        return jnp.sum(img * v_img) + jnp.sum(a * v_alpha)

    # under jit the interpret-mode kernels compile as one program, several
    # times faster than dispatching them eagerly
    diff = [jnp.asarray(s[k]) for k in ("m2d", "con", "col", "op")]
    ref = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4)))(
        *diff, jnp.zeros((n, 2), jnp.float32))

    ins = [t(s[k]).requires_grad_(True) for k in ("m2d", "con", "col", "op")]
    tap = torch.zeros(n, 2, requires_grad=True)
    img, alpha, _, _ = prast.RasterizeFlat.apply(
        *ins, tap, torch.tensor(s["rad"]), t(s["dep"]), w, h, TILE, tpg, mpt)
    ((img * t(v_img)).sum() + (alpha * t(v_alpha)).sum()).backward()
    for name, got, want in zip(("means2d", "conics", "colors", "opacities",
                                "absgrad"), [x.grad for x in ins] + [tap.grad], ref):
        assert np.abs(np.asarray(want)).max() > 0, name
        close(got, want, GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
