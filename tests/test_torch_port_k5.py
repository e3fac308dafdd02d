"""K5 as K2's entry on the window-clamped segments, and K4's unpadded table,
checked on the CPU where their kernels cannot run:

* the K5 route of `blend_flat` (WM_RASTER_GROUP = G > 1) hands on the order
  of the clamped counts (`order_out` equals longest_first of the counts
  that group_windows returns, which differ from the unclamped ones where a
  window overflows), and through `RasterizeFlat` the plain K3 gradient on
  that route equals the G = 1 route where no window overflows (atol 0) and
  jax.grad through the JAX package's grouped forward and its K3, both in
  Pallas interpret mode (atol = rtol = 1e-3, the JAX suite's own band);
* on a CUDA tensor `rasterize_flat_grouped` launches K2's C entry on the
  clamped (starts, counts) with an order and the training planes, counted
  as K5 and not as K2 (a stand-in records the launch);
* K4's table (`splat_table`) holds each splat's 6 + D fields in place, no
  padding, and `rasterize_binned_plain` equals the JAX package's K4
  (`_forward_pallas`, its `_kernel` in interpret mode) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_raster_variants import (MPT, TILE, H, W, _bins_both, _dense_case,
                                             _flat_bins, _params, _projected, _saturated)
from torch_port_helpers import close, normal, t
from hunyuanworld_mirror_tpu.ops import rasterizer_pallas as jrp
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as pbin
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat

GRAD_TOL = 1e-3


# --- K5: the order K3 takes ------------------------------------------------------

@pytest.mark.parametrize("case", ["scene", "saturated"])
@pytest.mark.parametrize("group", [4, 5])
def test_k5_route_hands_on_the_clamped_order(case, group, monkeypatch):
    """order_out is longest_first of the clamped counts the route returns;
    on the saturated scene those differ from the unclamped counts."""
    monkeypatch.setenv("WM_RASTER_GROUP", str(group))
    s = _projected(300, 1) if case == "scene" else _saturated()
    bins = _flat_bins(s, 0)
    order = torch.full(bins.counts.shape, -1, dtype=torch.int64)
    (img, alpha), starts, counts, _ = prast.blend_flat(bins, W, H, TILE, 4, False, MPT,
                                                       order_out=order)
    want_s, want_c, _ = pflat.group_windows(bins.starts, bins.counts, group, MPT,
                                            bins.packed.shape[1])
    assert torch.equal(starts, want_s) and torch.equal(counts, want_c)
    assert torch.equal(order, pflat.longest_first(counts))
    assert sorted(order.tolist()) == list(range(len(counts)))
    assert torch.equal(counts, bins.counts) == (case == "scene")
    img_k2, alpha_k2 = pflat.rasterize_flat(bins.packed, starts, counts, W, H, TILE, 4,
                                            False)
    assert torch.equal(img, img_k2) and torch.equal(alpha, alpha_k2)


def test_k5_route_grads_match_g1_and_pallas(monkeypatch):
    """RasterizeFlat's gradients (means2d, conics, colours, opacities, the
    AbsGS absgrad) at G=4 equal G=1's exactly (no window overflows here)
    and jax.grad through rasterize_flat_pallas at WM_RASTER_GROUP=4, whose
    forward is _forward_flat_grouped and backward its K3, in interpret
    mode."""
    s = {k: v[0] for k, v in _projected(300, 1).items()}
    n = len(s["op"])
    rng = np.random.default_rng(5)
    v_img = rng.normal(size=(H, W, 4)).astype(np.float32)
    v_alpha = rng.normal(size=(H, W, 1)).astype(np.float32)
    grads = {}
    for group in ("1", "4"):
        monkeypatch.setenv("WM_RASTER_GROUP", group)
        ins = [t(s[k]).requires_grad_(True) for k in ("m2d", "con", "col", "op")]
        tap = torch.zeros(n, 2, requires_grad=True)
        img, alpha, n_dropped, _ = prast.RasterizeFlat.apply(
            *ins, tap, torch.tensor(s["rad"]), t(s["dep"]), W, H, TILE, 9, MPT)
        ((img * t(v_img)).sum() + (alpha * t(v_alpha)).sum()).backward()
        grads[group] = [x.grad for x in ins] + [tap.grad]
        assert int(n_dropped) == 0
    for a, b in zip(grads["1"], grads["4"]):
        close(a, b, 0.0)

    def loss_j(m, c, col, op, tap):
        img, a, _ = jrp.rasterize_flat_pallas(
            m, c, col, op, jnp.asarray(s["rad"]), jnp.asarray(s["dep"]), tap,
            W, H, TILE, 9, MPT, True)
        return jnp.sum(img * v_img) + jnp.sum(a * v_alpha)

    monkeypatch.setenv("WM_RASTER_GROUP", "4")   # read as the JAX forward traces
    ref = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(s[k]) for k in ("m2d", "con", "col", "op")),
        jnp.zeros((n, 2), jnp.float32))
    for name, got, want in zip(("means2d", "conics", "colors", "opacities", "absgrad"),
                               grads["4"], ref):
        assert np.abs(np.asarray(want)).max() > 0, name
        close(got, want, GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


# --- K5: K2's entry on the card --------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_k5_launches_k2_entry_on_the_clamped_list(with_state, monkeypatch):
    """With the device check answering "cuda" and a stand-in for the launch:
    one launch of rasterize_flat_fwd's C entry `rasterize_flat_fwd` on the
    clamped starts and counts, the order written into order_out, the
    training planes with `with_state`; counted as K5, not as K2."""
    s = _saturated()
    bins = _flat_bins(s, 0, True)
    starts, counts, _ = pflat.group_windows(bins.starts, bins.counts, 4, MPT,
                                            bins.packed.shape[1])
    calls = []
    monkeypatch.setattr(pflat, "check_device", lambda x, fn: False)
    monkeypatch.setattr(pflat, "launch", lambda *a: calls.append(a))
    order = torch.empty(counts.shape, dtype=torch.int64)
    k5, k2 = pflat.rasterize_flat_grouped.launches, pflat.rasterize_flat.launches
    outs = pflat.rasterize_flat_grouped(bins.packed, starts, counts, W, H, TILE, 4, True,
                                        4, with_state=with_state, order_out=order)
    assert len(outs) == (4 if with_state else 2)
    assert pflat.rasterize_flat_grouped.launches == k5 + 1
    assert pflat.rasterize_flat.launches == k2
    (source, fn, argtypes, dev, *args), = calls
    assert (source, fn, argtypes) == ("rasterize_flat_fwd", "rasterize_flat_fwd",
                                      pflat._FWD_ARGS)
    assert len(args) == len(pflat._FWD_ARGS)
    assert args[:8] == [bins.packed.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                        order.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                        outs[2].data_ptr() if with_state else None,
                        outs[3].data_ptr() if with_state else None]
    tw, th = -(-W // TILE), -(-H // TILE)
    assert args[8:] == [W, H, TILE, tw, tw * th, 4, bins.packed.shape[1], 1]
    with pytest.raises(ValueError, match="group"):
        pflat.rasterize_flat_grouped(bins.packed, starts, counts, W, H, TILE, 4, True, 0)


# --- K4: the unpadded table ------------------------------------------------------

@pytest.mark.parametrize("d", [1, 3, 4, 8])
def test_splat_table_rows_hold_the_fields(d):
    """(N, 6 + D) rows: mean, conic, opacity, colours in place, bit for bit."""
    n = 37
    m2d, con, col, op = (t(normal(10 * d + i, shape)) for i, shape in
                         enumerate(((n, 2), (n, 3), (n, d), (n,))))
    table = pbin.splat_table(m2d, con, col, op)
    assert pbin.row_floats(d) == 6 + d
    assert table.shape == (n, 6 + d) and table.dtype == torch.float32
    assert table.is_contiguous()
    assert torch.equal(table[:, 0:2], m2d) and torch.equal(table[:, 2:5], con)
    assert torch.equal(table[:, 5], op) and torch.equal(table[:, 6:], col)


@pytest.mark.parametrize("case", ["scene", "multi_chunk", "opaque"])
def test_plain_k4_matches_pallas_kernel(case):
    """rasterize_binned_plain against _forward_pallas (the JAX K4, `_kernel`
    in interpret mode) on the JAX binning's table, atol 1e-5."""
    s, (w, h), mpt = _dense_case(case)
    bins, ref = _bins_both(s, w, h, mpt)
    img, alpha = pbin.rasterize_binned_plain(*(t(a) for a in _params(s)), bins, w, h,
                                             TILE)
    m2d, con, col, op = (jnp.asarray(a) for a in _params(s))
    img_p, a_p = jax.jit(lambda g, c: jrp._forward_pallas(
        m2d, con, col, op, g, c, w, h, TILE, interpret=True))(ref.gauss_ids, ref.counts)
    close(img, img_p, 1e-5)
    close(alpha, a_p, 1e-5)
    assert float(alpha.max()) > 0.5
