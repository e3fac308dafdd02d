"""The trunk's normalisation on the CPU (ops/trunk_norm.py): the LayerNorm
route and kernel K8's q/k LayerNorm and 2D RoPE.

On the CPU `LayerNorm` and `Attention` take the plain code, bit for bit
the chain they ran before K8 (one PyTorch operation at a time), and
`Attention` counts "norm_fused" once a bf16 call. On "the card" (the
device check answering so) a bf16 LayerNorm with bf16 parameters outside
autograd is one F.layer_norm on the tensors as they are, anything else the
chain. K8's wrapper hands its C entry its arguments: a stand-in launch
emulates `qk_norm_rope` through the pointers, strides, flags, eps and
tables it is given, and the outputs are the plain code's. Under autograd
the launch is the forward of a Function whose backward replays the plain
code: its gradients are the plain chain's. The benchmark's reader of the
counter reads the window."""

import ctypes
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import normal
from hunyuanworld_mirror_tpu_torch.models import block as pblock
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.models import rope as prope
from hunyuanworld_mirror_tpu_torch.ops import trunk_norm as tn
from hunyuanworld_mirror_tpu_torch.utils import profiling as pprof

BF16 = torch.bfloat16

# the attention routes: (qk_norm, rope)
ROUTES = {"trunk": (True, True), "dinov3": (False, True), "no_rope": (True, False)}
# (model width, heads): the trunk's head dim 64 at the three widths, and
# the tiny preset's 16-wide heads
WIDTHS = {"w64": (64, 1), "w384": (384, 6), "w1024": (1024, 16), "tiny_d16": (64, 4)}


def _bf16(seed, shape, scale=1.0):
    return torch.tensor(normal(seed, shape, scale)).to(BF16)


def _ln_before(x, weight, bias, dim, eps):
    """LayerNorm.forward as it was before K8."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (dim,), w, b, eps).to(x.dtype)


def _qk_before(attn, q, k, rope):
    """Attention's q/k chain as it was before K8."""
    if attn.q_norm is not None:
        q = _ln_before(q, attn.q_norm.weight, attn.q_norm.bias, attn.head_dim, attn.q_norm.eps)
        k = _ln_before(k, attn.k_norm.weight, attn.k_norm.bias, attn.head_dim, attn.k_norm.eps)
    if rope is not None:
        q, k = prope.apply_rope2d(q, rope), prope.apply_rope2d(k, rope)
    return q, k


def _attention(C, H, qk_norm, seed, param_dtype=BF16):
    gen = torch.Generator().manual_seed(seed)
    attn = pblock.Attention(C, H, qk_norm=qk_norm, norm_eps=1e-5)
    pnn.init_weights(attn, gen)
    if qk_norm:                         # away from the init's ones and zeros
        with torch.no_grad():
            for m in (attn.q_norm, attn.k_norm):
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
    return attn.to(param_dtype)


def _rope(N, D, tiled=1):
    side = int(np.ceil(np.sqrt(N)))
    pos = prope.grid_positions(side, side, 1)[:N]
    tabs = prope.make_rope_tables(pos, D)
    return prope.tile_tables(tabs, tiled) if tiled > 1 else tabs


def _qkv(attn, x):
    B, N, _ = x.shape
    qkv = attn.qkv(x).reshape(B, N, 3, attn.num_heads, attn.head_dim)
    return qkv.unbind(2)


# --- the CPU route: the plain chain, counted ---------------------------------------

@pytest.mark.parametrize("width", [64, 384, 1024])
@pytest.mark.parametrize("param_dtype", [BF16, torch.float32])
def test_cpu_layer_norm_is_the_chain_before(width, param_dtype):
    """A bf16 LayerNorm on the CPU and an f32 one: the chain before K8 bit
    for bit, uncounted."""
    ln = pnn.LayerNorm(width, 1e-6).to(param_dtype)
    with torch.no_grad():
        ln.weight.copy_(torch.tensor(normal(1, (width,), 0.3)) + 1)
        ln.bias.copy_(torch.tensor(normal(2, (width,), 0.3)))
    x = _bf16(3, (2, 37, width), 2.0) + 0.5
    with pprof.recording() as rec, pprof.request():
        y = ln(x)
        y32 = ln(x.float())
    (req,) = rec.resolve()
    assert y.dtype == BF16 and torch.equal(y, _ln_before(x, ln.weight, ln.bias, width, 1e-6))
    assert torch.equal(y32, _ln_before(x.float(), ln.weight, ln.bias, width, 1e-6))
    assert req.counts == {}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_cpu_attention_is_the_chain_before_and_counts(route, width):
    """Attention on the CPU at each route and width: q and k through the
    chain before K8 and the plain attention give its output bit for bit;
    one "norm_fused" a bf16 call, none with neither norm nor RoPE or in
    f32."""
    qk_norm, use_rope = ROUTES[route]
    C, H = WIDTHS[width]
    attn = _attention(C, H, qk_norm, 5)
    x = _bf16(6, (2, 50, C))
    rope = _rope(50, C // H) if use_rope else None
    with pprof.recording() as rec, pprof.request():
        out = attn(x, rope)
        plain = pblock.Attention(C, H, qk_norm=False)
        plain.load_state_dict({k: v for k, v in attn.state_dict().items()
                               if "norm" not in k})
        plain.to(BF16)(x)
        attn.float()(x.float(), rope)
    (req,) = rec.resolve()
    attn.to(BF16)
    q, k, v = _qkv(attn, x)
    q, k = _qk_before(attn, q, k, rope)
    B, N, _ = x.shape
    ref = attn.proj(pblock.attention(q, k, v, attn.head_dim ** -0.5).reshape(B, N, C))
    assert torch.equal(out, ref)
    assert req.counts == {"norm_fused": 1}


def test_cpu_global_tables_are_the_frames_tiled():
    """The global layers' tiled tables on the CPU: the chain before K8."""
    attn = _attention(384, 6, True, 7)
    x = _bf16(8, (1, 3 * 26, 384))
    rope = _rope(26, 64, tiled=3)
    q, k, _ = _qkv(attn, x)
    got = tn.qk_norm_rope(q, k, pblock._norm(attn.q_norm), pblock._norm(attn.k_norm), rope)
    for a, b in zip(got, _qk_before(attn, q, k, rope)):
        assert torch.equal(a, b)


# --- K8's wrapper through a stand-in launch -----------------------------------------

def _at(ptr, n, dtype):
    """The n elements of `dtype` at address ptr, as a tensor sharing them."""
    size = torch.empty(0, dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_uint8 * (n * size)).from_address(ptr), dtype=dtype)


def _param(ptr, n, bf16):
    return None if ptr is None else _at(ptr, n, BF16 if bf16 else torch.float32)


def _qk_entry(q, k, qo, ko, B, N, H, D, qsb, qsn, qsh, ksb, ksn, ksh, qw, qb, kw, kb,
              cy, sy, cx, sx, ts, flags, eps):
    """qk_norm_rope emulated: q and k where they lie at their strides, the
    norms' affine as stored, the tables at their row stride."""
    assert D in tn.QK_HEAD_DIMS and flags & 3 and not flags & ~7
    E = 4 if D == 16 else 8
    views = []
    for p, st in ((q, (qsb, qsn, qsh)), (k, (ksb, ksn, ksh))):
        assert p % (2 * E) == 0 and all(s % E == 0 for s in st)
        span = (B - 1) * st[0] + (N - 1) * st[1] + (H - 1) * st[2] + D
        views.append(_at(p, span, BF16).as_strided((B, N, H, D), (*st, 1)))
    bf16 = bool(flags & 4)
    norms = (None, None)
    if flags & 1:
        norms = ((_param(qw, D, bf16), _param(qb, D, bf16), eps),
                 (_param(kw, D, bf16), _param(kb, D, bf16), eps))
    rope = None
    if flags & 2:
        assert ts >= D // 2 and ts % 4 == 0
        rope = prope.RopeTables(*(_at(t, (N - 1) * ts + D // 2, torch.float32)
                                  .as_strided((N, D // 2), (ts, 1)) for t in (cy, sy, cx, sx)))
    outs = tn.qk_norm_rope_plain(*views, *norms, rope)
    for o, r in zip((qo, ko), outs):
        _at(o, B * N * H * D, BF16).view(B, N, H, D)[:] = r
    _seen.append(dict(entry="qk_norm_rope", shape=(B, N, H, D), q_strides=(qsb, qsn, qsh),
                      k_strides=(ksb, ksn, ksh), k_offset=k - q, flags=flags, eps=eps,
                      ts=ts))


_seen = []


@pytest.fixture
def standin(monkeypatch):
    """The device check answers "the card" and K8's C entry runs as
    _qk_entry -> the list of the calls' arguments."""
    _seen.clear()

    def launch(src, fn, argtypes, dev, *a):
        assert src == "trunk_norm" and len(a) == len(argtypes)
        assert fn == "qk_norm_rope"
        with pprof.recording():         # the emulation's own counts stay out
            _qk_entry(*a)

    monkeypatch.setattr(tn, "check_device", lambda x, fn: False)
    monkeypatch.setattr(tn, "launch", launch)
    return _seen


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("params", ["bf16", "f32", "none"])
def test_card_layer_norm_route(standin, monkeypatch, params, grad):
    """A bf16 LayerNorm on "the card": with bf16 parameters (or none) and
    no gradient wanted, one F.layer_norm on the bf16 tensors as they are
    (PyTorch's bf16 kernel, f32 inside); with f32 parameters (which that
    kernel refuses) or under autograd, the chain: its F.layer_norm on f32.
    No K8 launch, no count; the output is the chain's where the chain
    runs."""
    width = 384
    ln = pnn.LayerNorm(width, 1e-6, affine=params != "none")
    if params != "none":
        ln.to(BF16 if params == "bf16" else torch.float32)
        with torch.no_grad():
            ln.weight.copy_(torch.tensor(normal(1, (width,), 0.3)) + 1)
            ln.bias.copy_(torch.tensor(normal(2, (width,), 0.3)))
    ln.requires_grad_(grad)
    x = _bf16(4, (3, 21, width + 16), 2.0).requires_grad_(grad)[..., 8:8 + width]
    seen = []
    library = F.layer_norm

    def spy(t, shape, w=None, b=None, eps=1e-5):
        seen.append((t.dtype, t.data_ptr() == x.data_ptr(), tuple(shape),
                     None if w is None else w.dtype, eps))
        return library(t, shape, w, b, eps)

    monkeypatch.setattr(F, "layer_norm", spy)
    with pprof.recording() as rec, pprof.request():
        y = ln(x)
    (req,) = rec.resolve()
    assert req.counts == {} and not standin and y.dtype == BF16
    fast = params != "f32" and not grad
    pdt = {"bf16": BF16, "f32": torch.float32, "none": None}[params]
    if fast:
        assert seen == [(BF16, True, (width,), pdt, 1e-6)]
    else:
        assert seen == [(torch.float32, False, (width,),
                         None if pdt is None else torch.float32, 1e-6)]
        assert torch.equal(y, _ln_before(x, ln.weight, ln.bias, width, 1e-6))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_k8_qk_norm_rope_gets_the_views(standin, route, width):
    """qk_norm_rope on the fused qkv's q and k views at each route and width:
    one launch, the views' strides (3 H D a token) and k's offset (H D), the
    flags, eps and the tables' stride; q' and k' contiguous and the plain
    chain's, bit for bit, counted once."""
    qk_norm, use_rope = ROUTES[route]
    C, H = WIDTHS[width]
    D = C // H
    attn = _attention(C, H, qk_norm, 11)
    x = _bf16(12, (2, 30, C))
    rope = _rope(30, D) if use_rope else None
    q, k, _ = _qkv(attn, x)
    launches = tn.qk_norm_rope.launches
    with pprof.recording() as rec, pprof.request():
        got = tn.qk_norm_rope(q, k, pblock._norm(attn.q_norm), pblock._norm(attn.k_norm),
                              rope)
    (req,) = rec.resolve()
    assert req.counts == {"norm_fused": 1} and tn.qk_norm_rope.launches == launches + 1
    for a, b in zip(got, _qk_before(attn, q, k, rope)):
        assert a.is_contiguous() and torch.equal(a, b)
    (call,) = standin
    assert call == dict(entry="qk_norm_rope", shape=(2, 30, H, D),
                        q_strides=(30 * 3 * C, 3 * C, D), k_strides=(30 * 3 * C, 3 * C, D),
                        k_offset=2 * C, flags=qk_norm * 5 + use_rope * 2,
                        eps=pytest.approx(1e-5 if qk_norm else 0.0),
                        ts=D // 2 if use_rope else 0)


def test_k8_attention_forward_launches_once(standin):
    """Attention.forward on "the card": one qk_norm_rope launch, then the
    attention on q' and k' (K1 takes them contiguous); the output is the
    plain chain's."""
    attn = _attention(1024, 16, True, 13)
    x = _bf16(14, (1, 40, 1024))
    rope = _rope(20, 64, tiled=2)
    out = attn(x, rope)
    assert [c["entry"] for c in standin] == ["qk_norm_rope"]
    q, k, v = _qkv(attn, x)
    q, k = _qk_before(attn, q, k, rope)
    ref = attn.proj(pblock.attention(q, k, v, 0.125).reshape(1, 40, 1024))
    assert torch.equal(out, ref)


def test_k8_qk_refusals(standin):
    """Head dims K8 does not take and tables of another shape raise."""
    q = _bf16(15, (1, 8, 2, 48))
    with pytest.raises(ValueError, match="head dims"):
        tn.qk_norm_rope(q, q, None, None, _rope(8, 48))
    q = _bf16(15, (1, 8, 2, 64))
    with pytest.raises(ValueError, match="RoPE tables"):
        tn.qk_norm_rope(q, q, None, None, _rope(9, 64))


def test_k8_block_and_vit_launch_counts(standin):
    """A trunk block launches K8 once (its q/k route); a DINOv2 block not at
    all; a DINOv3 block once (its rope-only route)."""
    for qk_norm, use_rope, want in ((True, True, 1), (False, False, 0), (False, True, 1)):
        standin.clear()
        blk = pblock.Block(384, 6, init_values=0.01, qk_norm=qk_norm, norm_eps=1e-6)
        pnn.init_weights(blk, torch.Generator().manual_seed(0))
        blk.to(BF16)(_bf16(16, (2, 10, 384)), _rope(10, 64) if use_rope else None)
        assert len(standin) == want


# --- the autograd Function: the plain chain's gradients ------------------------------

def _grads(module, inputs, extra):
    """The gradients of a fixed projection of module(*inputs) for each
    input and parameter."""
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    module.zero_grad(set_to_none=True)
    out = module(*ins, *extra)
    cot = torch.tensor(normal(17, tuple(out.shape))).to(out.dtype)
    (out.float() * cot.float()).sum().backward()
    return [t.grad for t in ins] + [p.grad for p in module.parameters()]


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("param_dtype", [BF16, torch.float32])
def test_k8_attention_gradients_are_the_plain_chains(monkeypatch, route, param_dtype):
    """Attention through the q/k Function at each route (CenterSnap's
    trainable trunk is the first): the gradients of x, qkv, proj and the
    q/k norms are the plain chain's, bit for bit."""
    qk_norm, use_rope = ROUTES[route]
    attn = _attention(384, 6, qk_norm, 19, param_dtype)
    x = _bf16(20, (2, 12, 384))
    rope = (_rope(12, 64),) if use_rope else (None,)
    plain = _grads(attn, [x], rope)
    monkeypatch.setattr(tn, "check_device", lambda x, fn: False)
    monkeypatch.setattr(tn, "launch", lambda src, fn, argtypes, dev, *a: _qk_entry(*a))
    _seen.clear()
    k8 = _grads(attn, [x], rope)
    assert [c["entry"] for c in _seen] == ["qk_norm_rope"]
    assert len(k8) == len(plain)
    for a, b in zip(k8, plain):
        assert a is not None and torch.equal(a, b)


# --- the benchmark's reader of the counter --------------------------------------------

METRICS = Path(__file__).resolve().parents[1] / "wmbench" / "metrics"


def test_the_norm_fused_reader_reads_the_window():
    """norm_fused.recon gives the counter's mean a request over the window,
    and nothing where the program counted none (the parent's program)."""
    spec = importlib.util.spec_from_file_location("norm_fused.recon",
                                                  METRICS / "norm_fused.recon.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.SOURCE, mod.UNIT, mod.MOVES) == ("program_counter", "count", "frames_per_s")
    for n in (47, 49):
        with pprof.request([], start=True):
            pprof.count("norm_fused", n)
    assert mod.read(SimpleNamespace(spans=[{}, {}])) == 48
    with pprof.request([], start=True):
        pprof.count("host_syncs")
    assert mod.read(SimpleNamespace(spans=[{}])) is None
