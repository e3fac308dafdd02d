"""K1c (K1's f32 route, the camera head) and K4 (the dense-bin blend) as
redesigned for the H100, checked on the CPU where their kernels cannot run:

* K1c: `attention` on f32 at D = 128 and N at the edges of its register
  kernel's instances (N <= 16), its 16-row blocks, its resident K/V and
  its ring (1, 4, 5, 16, 17, 33, 97, 130) against the JAX oracle (attn_onepass._einsum_ref, which the JAX tests
  hold onepass_attention to on the CPU), and a plain mirror of the kernel's
  arithmetic (32-key tiles, online softmax) against the same oracle, atol
  1e-5;
* the wrapper's cached input check (`attention._check`) raises on every
  input the uncached check raises on, with the same message, also once an
  input of the same shapes and strides is cached;
* K4's table (`splat_table`): rows equal to the JAX route's (N, 6 + D)
  rows exactly, with no padding;
* the kernels' longest-first tile order (`longest_first_bins`, the plain
  copy of raster_order.cuh): a permutation, counts falling bin by bin, and
  a plain mirror of K4's walk (tiles in that order, batches staged from
  the table's rows, the sequential blend) equal to the walk in tile order
  and in reverse bit for bit, and within 1e-5 of rasterize_binned_pallas
  in interpret mode and of rasterize_binned (its plain version on the
  CPU).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_raster_variants import TILE, _bins_both, _dense_case, _params
from torch_port_helpers import close, normal, t
from hunyuanworld_mirror_tpu.ops import rasterizer_pallas as jrp
from hunyuanworld_mirror_tpu.ops.attn_onepass import _einsum_ref
from hunyuanworld_mirror_tpu_torch.ops import attention as pattn
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as pbin
from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as pflat

# the camera head's f32 attention: (1, N, H, 128) at N = S views
K1C_N = (1, 4, 5, 16, 17, 33, 97, 130)
K1C_TILE = 32   # keys a tile of the kernel (one a lane)


def _f32_qkv(n, seed, h=4):
    return [t(normal(seed + i, (1, n, h, 128), 0.1 if i == 2 else 1.0))
            for i in range(3)]


def _oracle(q, k, v, scale):
    return _einsum_ref(*(jnp.asarray(x.numpy()) for x in (q, k, v)), scale)


def k1c_mirror(q, k, v, scale):
    """K1c's arithmetic in plain PyTorch: per (batch, head) the keys in
    tiles of 32, each tile's f32 logits, the running max m, the sum l and
    the output rescaled by e^(m_old - m_new), then O / l. Up to 16 keys
    this is one tile, the register kernel's exact softmax."""
    B, N, H, D = q.shape
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))     # (B, H, N, D)
    m = torch.full((B, H, N, 1), -torch.inf)
    l = torch.zeros(B, H, N, 1)
    acc = torch.zeros(B, H, N, D)
    for k0 in range(0, N, K1C_TILE):
        s = qh @ kh[:, :, k0:k0 + K1C_TILE].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vh[:, :, k0:k0 + K1C_TILE]
        m = m_new
    return (acc / l).permute(0, 2, 1, 3)


@pytest.mark.parametrize("n", K1C_N)
def test_k1c_attention_f32_matches_oracle(n):
    q, k, v = _f32_qkv(n, seed=3 * n)
    scale = 128 ** -0.5
    out = pattn.attention(q, k, v, scale)
    assert out.dtype == torch.float32 and out.shape == q.shape
    close(out, _oracle(q, k, v, scale), 1e-5)


@pytest.mark.parametrize("n", K1C_N)
def test_k1c_tiled_online_softmax_matches_oracle(n):
    q, k, v = _f32_qkv(n, seed=5 * n + 1)
    scale = 128 ** -0.5
    close(k1c_mirror(q, k, v, scale), _oracle(q, k, v, scale), 1e-5)


def _bad_inputs():
    """name -> (q, k, v, the message _check_inputs raises)."""
    good = [torch.zeros(1, 8, 2, 64) for _ in range(3)]
    bf = [x.bfloat16() for x in good]
    wide = torch.zeros(1, 8, 2, 65, dtype=torch.bfloat16)[..., :64]    # N-stride 130
    flipped = torch.zeros(1, 8, 64, 2).transpose(-1, -2)               # D-stride 2
    return {
        "wrong rank": (good[0][0], good[1][0], good[2][0], "one \\(B, N, H, D\\) shape"),
        "mixed dtypes": (good[0], bf[1], good[2], "bf16 or f32"),
        "head dim 32": (*(torch.zeros(1, 8, 2, 32) for _ in range(3)),
                        "head dim must be 64 or 128"),
        "non-contiguous head dim": (flipped, good[1], good[2],
                                    "q's head dim must be contiguous"),
        "misaligned bf16 strides": (bf[0], wide, bf[2], "k must be 16-byte aligned"),
        "mixed devices": (good[0], torch.empty(1, 8, 2, 64, device="meta"), good[2],
                          "one device"),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_check_cached_path_raises_as_uncached(case, monkeypatch):
    """Every input the uncached check refuses is refused on every call, after
    a valid input was cached, with the uncached check's message."""
    monkeypatch.setattr(pattn, "_PLANS", {})
    q, k, v, msg = _bad_inputs()[case]
    with pytest.raises(ValueError, match=msg):
        pattn._check_inputs(q, k, v)
    pattn._check(*(torch.zeros(1, 8, 2, 64) for _ in range(3)))
    pattn._check(*(torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16) for _ in range(3)))
    for _ in range(2):
        with pytest.raises(ValueError, match=msg):
            pattn._check(q, k, v)
    assert len(pattn._PLANS) == 2


def test_check_caches_plans_and_checks_bf16_bases(monkeypatch):
    """A valid input's plan is cached by shapes, strides, dtypes and devices
    and carries the C entry's dims; the bf16 base alignment, not part of the
    key, is checked on every call."""
    monkeypatch.setattr(pattn, "_PLANS", {})
    base = torch.zeros(2 * 8 * 2 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:2 * 8 * 2 * 64].view(2, 8, 2, 64)
    off = base[1:1 + 2 * 8 * 2 * 64].view(2, 8, 2, 64)   # 2 bytes off
    assert aligned.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 2
    plan = pattn._check(aligned, aligned, aligned)
    assert pattn._check(aligned, aligned, aligned) is plan
    assert list(plan.dims) == [2, 8, 2, 64, *aligned.stride()[:3] * 3, 1]
    assert plan.bf16 and not plan.flash and not plan.empty
    for args in ((off, aligned, aligned), (aligned, aligned, off)):
        name = "q" if args[0] is off else "v"
        with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
            pattn._check(*args)
    f32 = pattn._check(*(torch.zeros(1, 4, 16, 128) for _ in range(3)))
    assert not f32.bf16 and list(f32.dims)[-1] == 0 and len(pattn._PLANS) == 2


@pytest.mark.parametrize("d", [1, 3, 4, 8])
def test_splat_table_rows_are_padded_jax_rows(d):
    n = 37
    m2d, con, col, op = (t(normal(d + i, shape)) for i, shape in
                         enumerate(((n, 2), (n, 3), (n, d), (n,))))
    table = pbin.splat_table(m2d, con, col, op)
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert table.shape == (n, pbin.row_floats(d)) == (n, 6 + d)
    old = torch.cat([m2d, con, op[:, None], col], dim=-1)     # the JAX route's rows
    assert torch.equal(table, old)


def test_longest_first_bins_is_the_kernels_order():
    """A permutation; bins by falling count; index order within a bin."""
    counts = torch.tensor([0, 5, 4096, 17, 4096, 3, 0, 4095, 9, 4], dtype=torch.int32)
    order = pflat.longest_first_bins(counts)
    assert torch.equal(order.sort().values, torch.arange(len(counts)))
    b, c = pflat.order_bins(counts)[order], counts[order]
    assert bool((b[1:] >= b[:-1]).all())
    assert bool(((c[1:] <= c[:-1]) | (b[1:] == b[:-1])).all())
    bins = pflat.order_bins(counts)
    assert order.tolist()[:3] == [2, 4, 7] and int(bins[2]) == 0
    assert int(bins[0]) == pflat.ORDER_BINS - 1
    empty = pflat.longest_first_bins(torch.zeros(4, dtype=torch.int32))
    assert empty.tolist() == [0, 1, 2, 3]


def k4_mirror(table, bins, d, w, h, order, nthr=TILE * TILE):
    """K4's walk in plain PyTorch: tiles in `order`, each tile's entries in
    batches of nthr staged from the table's rows, every pixel blended front to
    back with the kernels' rounding (conic_sigma's order) and stop rule."""
    tw, th = -(-w // TILE), -(-h // TILE)
    out = torch.zeros(th * TILE, tw * TILE, d)
    asum = torch.zeros(th * TILE, tw * TILE)
    lin = torch.arange(TILE * TILE)
    for tile in order.tolist():
        y0, x0 = (tile // tw) * TILE, (tile % tw) * TILE
        px = (x0 + lin % TILE).float() + 0.5
        py = (y0 + lin // TILE).float() + 0.5
        T, acc, a_sum = torch.ones(len(lin)), torch.zeros(len(lin), d), torch.zeros(len(lin))
        done = torch.zeros(len(lin), dtype=torch.bool)
        count = min(int(bins.counts[tile]), bins.gauss_ids.shape[1])
        for b0 in range(0, count, nthr):
            rows = table[bins.gauss_ids[tile, b0:min(count, b0 + nthr)].long()]
            for r in rows:
                mx, my, ca, cb, cc, op = r[:6]
                dx, dy = px - mx, py - my
                sigma = 0.5 * ((ca * dx) * dx + (cc * dy) * dy) + (cb * dx) * dy
                raw = torch.where(sigma >= 0, op * torch.exp(-sigma), torch.zeros(()))
                a = torch.clamp_max(raw, 0.999)
                keep = (raw >= pflat.ALPHA_THRESHOLD) & ~done
                nxt = T * (1 - a)
                stop = keep & (nxt <= pflat.T_EPS)
                blend = keep & ~stop
                wgt = torch.where(blend, a * T, torch.zeros(()))
                acc += wgt[:, None] * r[6:6 + d]
                a_sum += wgt
                T = torch.where(blend, nxt, T)
                done |= stop
        out[y0:y0 + TILE, x0:x0 + TILE] = acc.view(TILE, TILE, d)
        asum[y0:y0 + TILE, x0:x0 + TILE] = a_sum.view(TILE, TILE)
    return out[:h, :w], asum[:h, :w, None]


@pytest.mark.parametrize("case", ["scene", "multi_chunk", "opaque"])
def test_k4_walk_in_longest_first_order(case):
    """K4's walk mirrored over the table's rows: the longest-first order and
    the tile order give the same image bit for bit, within 1e-5 of the
    Pallas K4 in interpret mode and of the plain version."""
    s, (w, h), mpt = _dense_case(case)
    bins, ref = _bins_both(s, w, h, mpt)
    params = [t(a) for a in _params(s)]
    table = pbin.splat_table(*params)
    d = params[2].shape[1]
    order = pflat.longest_first_bins(bins.counts)
    img, alpha = k4_mirror(table, bins, d, w, h, order)
    for other in (torch.arange(len(order)), order.flip(0)):
        img_o, alpha_o = k4_mirror(table, bins, d, w, h, other)
        assert torch.equal(img, img_o) and torch.equal(alpha, alpha_o)
    img_p, a_p = jax.jit(lambda m, c, col, op, b: jrp.rasterize_binned_pallas(
        m, c, col, op, b, w, h, TILE, True))(*(jnp.asarray(a) for a in _params(s)), ref)
    img_plain, a_plain = pbin.rasterize_binned(*params, bins, w, h, TILE)
    for want_img, want_a in ((img_p, a_p), (img_plain, a_plain)):
        close(img, want_img, 1e-5)
        close(alpha, want_a, 1e-5)
