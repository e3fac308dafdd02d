"""The plain version of kernel K3, through the port's autograd Function,
against the JAX package's own K3: jax.grad through the custom VJP of
rasterize_flat_pallas, whose backward runs in Pallas interpret mode
(atol = rtol = 1e-3, the JAX suite's own band); the invariants the kernel's
in-kernel scatter and its bounding-box skip rely on."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_raster import GRAD_TOL, TILE, W, H, _projected
from torch_port_helpers import close, np_, t
from hunyuanworld_mirror_tpu.ops.rasterizer_pallas import (_backward_flat,
                                                           rasterize_flat_pallas)
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat


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


def _case(case):
    """(splats, (width, height), max_per_tile, max_tiles_per_gauss)."""
    if case == "opaque":
        return _opaque_stack(), (32, 32), 1024, 4
    n, mpt = (60, 512) if case == "scene" else (400, 1024)
    return _projected(n), (W, H), mpt, 12


def _bins(s, w, h, mpt, tpg):
    return prast.bin_splats(t(s["m2d"]), t(s["con"]), t(s["col"]), t(s["op"]),
                            torch.tensor(s["rad"]), t(s["dep"]), TILE,
                            -(-w // TILE), -(-h // TILE), tpg, mpt, False,
                            with_ids=True)


@pytest.mark.parametrize("case", ["scene", "multi_chunk", "opaque"])
def test_plain_k3_matches_pallas_interpret(case):
    """Grads of means2d, conics, colours, opacities and the AbsGS absgrad
    through the port's RasterizeFlat against jax.grad through the JAX
    package's custom VJP, whose backward is its K3 in interpret mode."""
    s, (w, h), mpt, tpg = _case(case)
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


@pytest.mark.parametrize("case", ["scene", "multi_chunk", "opaque"])
def test_plain_k3_splat_rows_are_the_walked_entries(case):
    """What the kernel's in-kernel scatter relies on: the plain version's
    entry rows are zero outside every tile's segment [start, start + count)
    and past each tile's walk (its pixels' largest last-kept index + 1), so
    its per-splat rows are the index_add_ of the walked entries alone; and
    those rows are the JAX package's per-splat grads (its K3 in interpret
    mode, then its scatter), within the JAX suite's band."""
    s, (w, h), mpt, tpg = _case(case)
    d, n = 4, len(s["op"])
    bins = _bins(s, w, h, mpt, tpg)
    rng = np.random.default_rng(6)
    v_img = rng.normal(size=(h, w, d)).astype(np.float32)
    v_alpha = rng.normal(size=(h, w, 1)).astype(np.float32)
    entry, splat = pflat.rasterize_flat_bwd_plain(
        bins.packed, bins.starts, bins.counts, bins.gauss_ids, n, t(v_img),
        t(v_alpha), w, h, TILE, d)
    *_, last = pflat.rasterize_flat_plain(bins.packed, bins.starts, bins.counts,
                                          w, h, TILE, d, False, with_state=True)
    tw, th = -(-w // TILE), -(-h // TILE)
    lp = torch.nn.functional.pad(last, (0, tw * TILE - w, 0, th * TILE - h), value=-1)
    walk = lp.reshape(th, TILE, tw, TILE).transpose(1, 2).reshape(tw * th, -1).amax(1) + 1
    assert int(walk.max()) > 0
    walked = torch.zeros(entry.shape[1], dtype=torch.bool)
    for st, cnt, wk in zip(bins.starts.tolist(), bins.counts.tolist(), walk.tolist()):
        assert wk <= cnt
        walked[st:st + wk] = True
    assert torch.equal(entry[:, ~walked], torch.zeros_like(entry[:, ~walked]))
    ref = torch.zeros_like(splat).index_add_(1, bins.gauss_ids[walked].long(),
                                             entry[:, walked])
    close(splat, ref, 1e-6)

    bwd = jax.jit(functools.partial(_backward_flat, width=w, height=h,
                                    tile_size=TILE, d_col=d, max_per_tile=mpt,
                                    n_gauss=n, interpret=True))
    gm, gc, gcol, gop, gabs = bwd(*(jnp.asarray(np_(x)) for x in (
        bins.packed, bins.starts, bins.counts, bins.gauss_ids)), v_img, v_alpha)
    for name, got, want in (("means2d", splat[0:2].T, gm), ("conics", splat[2:5].T, gc),
                            ("opacities", splat[5], gop),
                            ("colors", splat[6:6 + d].T, gcol),
                            ("absgrad", splat[6 + d:8 + d].T, gabs)):
        assert np.abs(np.asarray(want)).max() > 0, name
        close(got, want, GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_k3_without_entry_rows():
    """with_entries=False gives (None, the same per-splat rows), through the
    wrapper as RasterizeFlat.backward calls it and through the plain
    version."""
    s, (w, h), mpt, tpg = _case("multi_chunk")
    d, n = 4, len(s["op"])
    bins = _bins(s, w, h, mpt, tpg)
    _, _, t_fin, last = pflat.rasterize_flat(bins.packed, bins.starts, bins.counts,
                                             w, h, TILE, d, False, with_state=True)
    rng = np.random.default_rng(7)
    args = (bins.packed, bins.starts, bins.counts, bins.gauss_ids, n,
            t(rng.normal(size=(h, w, d))), t(rng.normal(size=(h, w, 1))))
    entry, splat = pflat.rasterize_flat_bwd(*args, t_fin, last, w, h, TILE, d)
    assert entry.shape == (8 + d, bins.packed.shape[1])
    for got in (pflat.rasterize_flat_bwd(*args, t_fin, last, w, h, TILE, d,
                                         with_entries=False),
                pflat.rasterize_flat_bwd_plain(*args, w, h, TILE, d,
                                               with_entries=False)):
        assert got[0] is None
        assert torch.equal(got[1], splat)


@pytest.mark.parametrize("payload_f16", [False, True], ids=["f32", "f16"])
@pytest.mark.parametrize("case", ["scene", "multi_chunk", "opaque", "thin"])
def test_k3_keep_box_holds_every_kept_pair(case, payload_f16):
    """K3 and the forward kernels skip, for a whole warp, the entries whose
    keep box (rasterizer_flat.keep_box, csrc/raster_common.cuh) misses the
    warp's pixels: no pixel the plain blend keeps may lie outside its
    entry's box, on the training path's f32 payload and on the f16-pair
    payload the main path's K2 lists carry (the box taken from the decoded
    values, as the kernels take it). "thin" holds needle-like ellipses at
    det C = ca cc / 100, the edge of the box's use, with opacities up to 1."""
    if case == "thin":
        rng = np.random.default_rng(9)
        m = 300
        ca = rng.uniform(0.01, 2.0, m).astype(np.float32)
        cc = rng.uniform(0.01, 2.0, m).astype(np.float32)
        cb = (np.sqrt(ca * cc * 0.99) * rng.choice([-1, 1], m)).astype(np.float32)
        s = dict(m2d=rng.uniform(0, 64, (m, 2)).astype(np.float32),
                 con=np.stack([ca, cb, cc], -1), col=rng.uniform(0, 1, (m, 4)).astype(
                     np.float32), op=rng.uniform(0.05, 1.0, m).astype(np.float32),
                 rad=np.full((m, 2), 40, np.int32),
                 dep=rng.uniform(1, 2, m).astype(np.float32))
        (w, h), mpt, tpg = (64, 48), 1024, 12
    else:
        s, (w, h), mpt, tpg = _case(case)
    d = 4
    bins = prast.bin_splats(t(s["m2d"]), t(s["con"]), t(s["col"]), t(s["op"]),
                            torch.tensor(s["rad"]), t(s["dep"]), TILE,
                            -(-w // TILE), -(-h // TILE), tpg, mpt, payload_f16)
    rows = pflat.decode_payload(bins.packed, d, payload_f16)[:6]
    tw = -(-w // TILE)
    n_kept = 0
    for b in pflat.blend_groups(bins.packed, bins.starts, bins.counts, w, h, TILE,
                                d, payload_f16):
        x0, x1, y0, y1 = pflat.keep_box(*(r[b.idx] for r in rows))
        lin = torch.arange(TILE * TILE)
        px = ((b.g % tw) * TILE)[:, None].float() + (lin % TILE).float() + 0.5
        py = ((b.g // tw) * TILE)[:, None].float() + (lin // TILE).float() + 0.5
        kept = b.alpha > 0                                   # (G, K, P)
        inside = ((px[:, None, :] >= x0[..., None]) & (px[:, None, :] <= x1[..., None])
                  & (py[:, None, :] >= y0[..., None]) & (py[:, None, :] <= y1[..., None]))
        assert not bool((kept & ~inside).any())
        n_kept += int(kept.sum())
    assert n_kept > 0
