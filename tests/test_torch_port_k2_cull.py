"""The forward kernels' culled walk (csrc/raster_common.cuh), mirrored in
plain PyTorch: each 8 x 4-pixel warp of a tile drops the entries whose keep
box (rasterizer_flat.keep_box) misses its pixels, then blends front to back.
Its image, alpha, final T and last kept entry must equal
rasterize_flat_plain's exactly, because the box never drops a pair the keep
test keeps; the pairs themselves are checked too. The lists hold
needle-like ellipses at the edge of the box's use (det C = ca cc / 100),
near-opaque stacks that stop the blend early, and a random scene, on an
image whose width and height are not multiples of the tile."""

import numpy as np
import pytest
import torch

from test_torch_port_train_raster import _projected
from torch_port_helpers import t
from hunyuanworld_mirror_tpu_torch.ops import rasterizer as prast
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat

W, H, TILE, D = 70, 45, 16, 4


def _scene():
    """Needles, two near-opaque stacks and a projected random scene."""
    rng = np.random.default_rng(11)
    m = 300
    ca = rng.uniform(0.01, 2.0, m).astype(np.float32)
    cc = rng.uniform(0.01, 2.0, m).astype(np.float32)
    cb = (np.sqrt(ca * cc * 0.99) * rng.choice([-1, 1], m)).astype(np.float32)
    parts = [dict(m2d=rng.uniform(-5, 75, (m, 2)), con=np.stack([ca, cb, cc], -1),
                  op=rng.uniform(0.05, 1.0, m), rad=np.full((m, 2), 40),
                  col=rng.uniform(0, 1, (m, D)), dep=rng.uniform(1, 3, m))]
    for cx, cy in ((20.0, 20.0), (66.0, 41.0)):
        n = 200
        parts.append(dict(m2d=np.tile([[cx, cy]], (n, 1)),
                          con=np.tile([[0.08, 0.01, 0.05]], (n, 1)),
                          op=np.full(n, 0.99), rad=np.full((n, 2), 20),
                          col=rng.uniform(0, 1, (n, D)), dep=rng.uniform(0.5, 2.5, n)))
    proj = _projected(200, seed=3)   # 64 x 48 projections, inside this image
    parts.append(dict(m2d=proj["m2d"], con=proj["con"], op=proj["op"],
                      rad=proj["rad"], col=proj["col"], dep=proj["dep"]))
    s = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return {k: (v.astype(np.int32) if k == "rad" else v.astype(np.float32))
            for k, v in s.items()}


def culled_plain(packed, starts, counts, f16):
    """rasterize_flat_plain's blend after the warps' cull -> (img, alpha,
    T, last, the (pixel, entry) pairs kept outside their warp's rectangle,
    the culled (warp-pixel, entry) pairs, all pairs walked)."""
    tw = -(-W // TILE)
    P = TILE * TILE
    mx, my = pflat.decode_payload(packed, D, f16)[:2]
    rx0, rx1, ry0, ry1 = pflat.warp_rects(TILE)
    out = torch.zeros(tw * -(-H // TILE), P, D)
    asum = torch.zeros(out.shape[:2])
    t_fin = torch.ones(out.shape[:2])
    last = torch.full(out.shape[:2], -1, dtype=torch.int32)
    lost = culled = walked = 0
    for b in pflat.blend_groups(packed, starts, counts, W, H, TILE, D, f16):
        ca, cb, cc, op = (v[..., 0] for v in b.params)
        x0, x1, y0, y1 = (v[..., None] for v in pflat.keep_box(
            mx[b.idx], my[b.idx], ca, cb, cc, op))                   # (G, K, 1)
        gx = ((b.g % tw) * TILE).float()[:, None, None]
        gy = ((b.g // tw) * TILE).float()[:, None, None]
        miss = ((x1 < gx + rx0) | (x0 > gx + rx1) | (y1 < gy + ry0) | (y0 > gy + ry1))
        miss &= b.live[..., None]
        lost += int((miss & (b.alpha > 0)).sum())
        culled += int(miss.sum())
        walked += int(b.live.sum()) * P
        alpha = torch.where(miss, torch.zeros_like(b.alpha), b.alpha)
        t_after = torch.cumprod(1.0 - alpha, dim=1)
        t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], 1)
        w = alpha * t_before * (t_after > pflat.T_EPS)
        out[b.g] = torch.einsum("gkp,dgk->gpd", w, b.col)
        asum[b.g] = w.sum(dim=1)
        kept = w > 0
        t_fin[b.g] = torch.where(kept, 1.0 - alpha, 1.0).prod(dim=1)
        k = torch.arange(kept.shape[1])[None, :, None]
        last[b.g] = torch.where(kept, k, -1).amax(dim=1).to(torch.int32)
    planes = [pflat._from_tiles(x, W, H, TILE) for x in (out, asum, t_fin, last)]
    return (*planes, lost, culled, walked)


@pytest.mark.parametrize("payload_f16", [False, True], ids=["f32", "f16"])
def test_culled_walk_equals_plain_blend(payload_f16):
    s = _scene()
    bins = prast.bin_splats(t(s["m2d"]), t(s["con"]), t(s["col"]), t(s["op"]),
                            torch.tensor(s["rad"]), t(s["dep"]), TILE,
                            -(-W // TILE), -(-H // TILE), 9, 1024, payload_f16)
    args = (bins.packed, bins.starts, bins.counts)
    img, alpha, t_fin, last = pflat.rasterize_flat_plain(
        *args, W, H, TILE, D, payload_f16, with_state=True)
    c_img, c_alpha, c_t, c_last, lost, culled, walked = culled_plain(*args, payload_f16)
    assert lost == 0
    assert torch.equal(c_img, img) and torch.equal(c_alpha[..., None], alpha)
    assert torch.equal(c_t, t_fin) and torch.equal(c_last, last)
    # the scene exercises all of it: kept pairs, early stops, culled pairs
    assert int((last >= 0).sum()) > 0 and float(t_fin.min()) < 1e-3
    assert 0.2 < culled / walked < 1.0


def test_order_out_is_longest_first_and_reaches_k3():
    """On the CPU rasterize_flat fills `order_out` with longest_first(counts)
    (on the card K2's C entry sorts it in count bins), and the training
    path's RasterizeFlat saves that order for K3."""
    s = _scene()
    bins = prast.bin_splats(t(s["m2d"]), t(s["con"]), t(s["col"]), t(s["op"]),
                            torch.tensor(s["rad"]), t(s["dep"]), TILE,
                            -(-W // TILE), -(-H // TILE), 9, 1024, False)
    order = torch.empty(bins.counts.shape, dtype=torch.int64)
    pflat.rasterize_flat(bins.packed, bins.starts, bins.counts, W, H, TILE, D,
                         False, order_out=order)
    assert torch.equal(order, pflat.longest_first(bins.counts))
    assert bool((bins.counts[order][:-1] >= bins.counts[order][1:]).all())
    with pytest.raises(ValueError, match="order must be"):
        pflat.rasterize_flat(bins.packed, bins.starts, bins.counts, W, H, TILE, D,
                             False, order_out=order.int())
    leaves = [t(s[k]).requires_grad_() for k in ("m2d", "con", "col", "op")]
    abs_tap = torch.zeros(len(s["op"]), 2, requires_grad=True)
    img, alpha, _, _ = prast.RasterizeFlat.apply(
        *leaves, abs_tap, torch.tensor(s["rad"]), t(s["dep"]), W, H, TILE, 9, 1024)
    saved_order = img.grad_fn.saved_tensors[-1]
    assert torch.equal(saved_order, order)
    (img.sum() + alpha.sum()).backward()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


@pytest.mark.parametrize("tile_size", [4, 8, 12, 16, 24, 32])
def test_kernel_tile_sizes(tile_size):
    """The wrappers admit only the tiles the forward kernels launch (whole
    8 x 4-pixel warps, at most 256 threads a block) and refuse the others
    with a ValueError that names the tile size, before any launch."""
    tiles = -(-W // tile_size) * -(-H // tile_size)
    args = (torch.zeros(10, 1), torch.zeros(tiles, dtype=torch.int32),
            torch.zeros(tiles, dtype=torch.int32), W, H, tile_size, D, 10)
    if tile_size in (8, 16):
        pflat._check_list(*args)
        pflat.check_kernel_dims(tile_size, D)
    else:
        for check in (lambda: pflat._check_list(*args),
                      lambda: pflat.check_kernel_dims(tile_size, D)):
            with pytest.raises(ValueError, match=f"tile_size 8 or 16 .* got {tile_size}"):
                check()
