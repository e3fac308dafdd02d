"""The trunk's normalisation: kernel K8 and the plain versions.

Two stages of every transformer block run here:
- `layer_norm`: a LayerNorm with f32 statistics and affine, output in the
  input's dtype (the JAX package's models/nn.py layer_norm). On the card
  a bf16 input whose parameters are bf16 too takes PyTorch's own LayerNorm
  in bf16: one launch that computes its statistics and affine in f32, bit
  for bit the cast chain `layer_norm_plain` (chip_smoke.py phase 8d holds
  it to that on the trunk's and the encoder's rows); every other input,
  and a call under autograd, takes `layer_norm_plain`. PyTorch's kernel
  refuses a bf16 input with f32 parameters.
- `qk_norm_rope`: an attention's q/k LayerNorm over the head dim and its 2D
  RoPE (`apply_rope2d`, the JAX package's models/rope.py), on the q and k
  views of the fused qkv projection. The RoPE tables are the four f32
  (N, D / 2) tensors (cos_y, sin_y, cos_x, sin_x) of models/rope.py's
  RopeTables.

A bf16 q and k count in profiling's counter "norm_fused" on either
device, once a call. On the CPU they take the plain code
(`qk_norm_rope_plain`: one PyTorch operation at a time, as the JAX package
writes it); on the card kernel K8 (csrc/trunk_norm.cu, its entry
`qk_norm_rope`), one launch a call, counted in `qk_norm_rope.launches`, or
the wrapper raises. Another dtype takes the plain code on every device,
uncounted.

K8 writes q' and k' contiguous, as the plain code does. Its RoPE is the
plain code's bits; its LayerNorm agrees with PyTorch's to f32 rounding,
one bf16 ulp at the affine's scale at most. Under autograd (an input that
requires a gradient) the launch is the forward of an autograd Function
whose backward replays the plain code through autograd on the saved bf16
inputs, as K1's does (ops/attention.py), so its gradients are the plain
code's.
"""

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import profiling
from ._launch import check_device, launch

# a LayerNorm's parameters: (weight, bias, eps), weight and bias None
# without the affine
Norm = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], float]
# the RoPE tables (cos_y, sin_y, cos_x, sin_x), each f32 (N, D / 2)
Tables = Sequence[torch.Tensor]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the C entry's arguments before the trailing stream
_QK_ARGS = [_P] * 4 + [_LL] * 3 + [_I] + [_LL] * 6 + [_P] * 8 + [_LL, _I, _F]
# the head dims K8 takes
QK_HEAD_DIMS = (16, 64)
_QK_NORM, _QK_ROPE, _QK_PARAM_BF16 = 1, 2, 4


def layer_norm_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """F.layer_norm over the last dim in f32 (statistics and affine), cast
    back to x's dtype."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def apply_rope2d(x: torch.Tensor, tables: Tables) -> torch.Tensor:
    """Rotate (B, N, heads, head_dim) features by their 2D token position.

    (a, b) -> (a cos - b sin, b cos + a sin) on each quarter pair; the
    tables are cast to x's dtype first, as the JAX package does.
    """
    dtype = x.dtype
    half = x.shape[-1] // 2
    q = half // 2
    cos_y, sin_y, cos_x, sin_x = tables

    def rot(t, cos, sin):
        c = cos[None, :, None, :q].to(dtype)
        s = sin[None, :, None, :q].to(dtype)
        a, b = t[..., :q], t[..., q:]
        return torch.cat([a * c - b * s, b * c + a * s], dim=-1)

    return torch.cat([rot(x[..., :half], cos_y, sin_y),
                      rot(x[..., half:], cos_x, sin_x)], dim=-1)


def qk_norm_rope_plain(q: torch.Tensor, k: torch.Tensor, q_norm: Optional[Norm],
                       k_norm: Optional[Norm], rope: Optional[Tables]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each of q and k (B, N, H, D) through its LayerNorm over D (if given),
    then the 2D RoPE (if given)."""
    if q_norm is not None:
        q, k = layer_norm_plain(q, *q_norm), layer_norm_plain(k, *k_norm)
    if rope is not None:
        q, k = apply_rope2d(q, rope), apply_rope2d(k, rope)
    return q, k


def _aligned(t: Optional[torch.Tensor], elems: int) -> Optional[torch.Tensor]:
    """t as it is if its innermost dim is contiguous and its base and other
    strides are multiples of `elems` elements, else a contiguous copy."""
    if t is None:
        return None
    st = t.stride()
    if (st[-1] == 1 and t.data_ptr() % (elems * t.element_size()) == 0
            and all(s % elems == 0 for s in st[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _params(*ps: Optional[torch.Tensor]) -> Tuple[list, bool]:
    """The affine parameters as K8 reads them (contiguous, 16-byte aligned,
    all f32 or all bf16) -> (them, whether they are bf16)."""
    bf16 = {p.dtype for p in ps if p is not None} == {torch.bfloat16}
    return [None if p is None else
            _aligned(p.detach().reshape(-1) if bf16 else p.detach().float().reshape(-1),
                     8 if bf16 else 4) for p in ps], bf16


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _replay(fn, inputs: Sequence[Optional[torch.Tensor]], needs: Sequence[bool], grads):
    """The gradients of fn(*inputs) for the cotangents `grads`, through
    autograd, None for each input that needs none."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(bool(n))
               for t, n in zip(inputs, needs)]
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wanted = [t for t, n in zip(ins, needs) if t is not None and n]
        got = iter(torch.autograd.grad(outs, wanted, grads)) if wanted else iter(())
        return tuple(next(got) if t is not None and n else None
                     for t, n in zip(ins, needs))


def _grad_wanted(*ts: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """LayerNorm over x's last dim with f32 statistics and affine, in x's
    dtype: PyTorch's bf16 LayerNorm for a bf16 x with bf16 (or no)
    parameters on the card outside autograd, else layer_norm_plain (see
    the module)."""
    if (x.dtype == torch.bfloat16 and not check_device(x, "layer_norm")
            and all(p is None or p.dtype == x.dtype for p in (weight, bias))
            and not _grad_wanted(x, weight, bias)):
        return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
    return layer_norm_plain(x, weight, bias, eps)


def _rope_tables(rope: Tables, N: int, D: int) -> Tuple[list, int]:
    """The four f32 (N, D / 2) tables at one row stride -> (them, the
    stride)."""
    if any(t.dtype != torch.float32 or tuple(t.shape) != (N, D // 2) for t in rope):
        raise ValueError(f"the RoPE tables must be f32 ({N}, {D // 2}), got "
                         f"{[(t.dtype, tuple(t.shape)) for t in rope]}")
    tabs = [_aligned(t, 4) for t in rope]
    if len({t.stride(0) for t in tabs}) != 1:
        tabs = [t.contiguous() for t in tabs]
    return tabs, tabs[0].stride(0)


def _qk_launch(q, k, q_norm: Optional[Norm], k_norm: Optional[Norm],
               rope: Optional[Tables]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One qk_norm_rope launch on bf16 CUDA q and k (B, N, H, D)."""
    if q.shape != k.shape or q.dim() != 4 or k.dtype != q.dtype or k.device != q.device:
        raise ValueError(f"q and k must be one (B, N, H, D) shape, dtype and device, got "
                         f"{tuple(q.shape)} {q.dtype}, {tuple(k.shape)} {k.dtype}")
    B, N, H, D = q.shape
    if D not in QK_HEAD_DIMS:
        raise ValueError(f"K8's q/k route takes head dims {QK_HEAD_DIMS}, got {D}")
    E = 4 if D == 16 else 8
    q, k = _aligned(q, E), _aligned(k, E)
    qo = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    ko = torch.empty_like(qo)
    flags, eps, norms = 0, 0.0, [None] * 4
    if q_norm is not None:
        if q_norm[2] != k_norm[2]:
            raise ValueError("q_norm and k_norm must share one eps")
        ps = (*q_norm[:2], *k_norm[:2])
        if any(p is not None and p.numel() != D for p in ps):
            raise ValueError(f"the q/k norms' parameters must be ({D},)")
        norms, bf16 = _params(*ps)
        flags |= _QK_NORM | (_QK_PARAM_BF16 if bf16 else 0)
        eps = q_norm[2]
    tabs, ts = [None] * 4, 0
    if rope is not None:
        tabs, ts = _rope_tables(rope, N, D)
        flags |= _QK_ROPE
    launch("trunk_norm", "qk_norm_rope", _QK_ARGS, q.device, q.data_ptr(), k.data_ptr(),
           qo.data_ptr(), ko.data_ptr(), B, N, H, D, *q.stride()[:3], *k.stride()[:3],
           *(_ptr(t) for t in norms), *(_ptr(t) for t in tabs), ts, flags, float(eps))
    qk_norm_rope.launches += 1
    return qo, ko


class _QKNormRopeK8(torch.autograd.Function):
    """qk_norm_rope forward; the backward replays qk_norm_rope_plain."""

    @staticmethod
    def forward(ctx, q, k, qw, qb, kw, kb, eps, rope):
        ctx.save_for_backward(q, k, qw, qb, kw, kb)
        ctx.eps, ctx.rope = eps, rope
        norms = (None, None) if eps is None else ((qw, qb, eps), (kw, kb, eps))
        return _qk_launch(q, k, *norms, rope)

    @staticmethod
    def backward(ctx, dq, dk):
        eps, rope = ctx.eps, ctx.rope

        def plain(q, k, qw, qb, kw, kb):
            norms = (None, None) if eps is None else ((qw, qb, eps), (kw, kb, eps))
            return qk_norm_rope_plain(q, k, *norms, rope)

        grads = _replay(plain, ctx.saved_tensors, ctx.needs_input_grad[:6], (dq, dk))
        return (*grads, None, None)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, q_norm: Optional[Norm],
                 k_norm: Optional[Norm], rope: Optional[Tables]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k (B, N, H, D) through their LayerNorms over D (q_norm, k_norm:
    (weight, bias, eps), or both None) and the 2D RoPE (`rope`'s tables, or
    None) -> (q', k'). A bf16 pair counts in "norm_fused" and takes kernel
    K8 on the card (see the module); anything else takes qk_norm_rope_plain."""
    if q.dtype != torch.bfloat16 or (q_norm is None and rope is None):
        return qk_norm_rope_plain(q, k, q_norm, k_norm, rope)
    profiling.count("norm_fused")
    if check_device(q, "qk_norm_rope"):
        return qk_norm_rope_plain(q, k, q_norm, k_norm, rope)
    qw, qb, eps = q_norm if q_norm is not None else (None, None, None)
    kw, kb, _ = k_norm if k_norm is not None else (None, None, None)
    if _grad_wanted(q, k, qw, qb, kw, kb):
        return _QKNormRopeK8.apply(q, k, qw, qb, kw, kb, eps, rope)
    return _qk_launch(q, k, q_norm, k_norm, rope)


qk_norm_rope.launches = 0
