"""Exact non-causal softmax attention: kernel K1 and its plain version.

Replaces BOTH attention routes of the JAX package: the one-pass Pallas
kernel hunyuanworld_mirror_tpu/ops/attn_onepass.py (`_kernel`, N <= 4095:
encoder, frame layers, camera head, global layers at S <= 2) and the Pallas
flash kernel that models/block.py `_flash_core` calls for N >= 4096 (global
layers at S >= 3). Both compute softmax(q k^T * scale) v with f32 logits and
an f32 row softmax; the CUDA kernel (csrc/attention_fwd.cu) streams K/V
tiles with an online softmax, so one kernel serves every N.

Layout is the JAX package's (B, N, H, D) for q, k, v and the output. The
head dim must be contiguous; other strides are free, so the q/k/v views of
a fused qkv projection go to the kernel without a copy.

The gradient is the JAX package's: `onepass_attention`'s custom VJP replays
the einsum formulation (attn_onepass._einsum_ref) through autodiff, so on
the card K1 runs the forward of an autograd Function whose backward replays
that math (`attention_replay`) on the saved q, k and v. The backward
launches no kernel and counts its replays in `attention.backward_replays`.
"""

import ctypes

import torch

from . import _build

_SIGNATURE_SET = False
# the JAX package's routes: the one-pass kernel for N <= 4095, the flash
# kernel for N >= 4096 (models/block.py, WM_FLASH_MIN_N); one kernel serves
# both here, and `attention.flash_route_launches` counts the second's share
FLASH_MIN_N = 4096


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """einsum -> f32 softmax -> einsum (attn_onepass._einsum_ref's math with
    the kernel's f32 logits): P is rounded to the input dtype before the PV
    product, accumulation is f32, the output is in the input dtype."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", w.float(), v.float()).to(q.dtype)


def attention_replay(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """attn_onepass._einsum_ref's math, which the JAX VJP differentiates:
    q * scale, the logits in the input dtype, an f32 softmax rounded to the
    input dtype, then the PV einsum in the input dtype. Its bf16 logits are
    not the kernel's f32 ones (attention_plain's), so its gradients are
    JAX's and not those of attention_plain."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", w, v)


def attention_replay_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, grad_out: torch.Tensor):
    """(dq, dk, dv) of attention_replay at (q, k, v) for the cotangent
    grad_out: the backward of K1's autograd Function, on any device."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = attention_replay(q, k, v, scale)
        return torch.autograd.grad(out, (q, k, v), grad_out)


def declare(lib):
    """Give a loaded build of csrc/attention_fwd.cu its C signature."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.attention_fwd.argtypes = ([p, p, p, p, i, i, i, i] + [ll] * 9
                                  + [ctypes.c_float, i, p])
    lib.attention_fwd.restype = ctypes.c_int
    return lib


def _library():
    global _SIGNATURE_SET
    lib = _build.load("attention_fwd")
    if not _SIGNATURE_SET:
        declare(lib)
        _SIGNATURE_SET = True
    return lib


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError(f"attention takes bf16 or f32, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"head dim must be 64 or 128, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        # the bf16 kernel's TMA loads need a 16-byte aligned base and strides
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             "that are multiples of 8 elements")


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """One K1 launch on CUDA tensors; counts it in `attention.launches`."""
    _check(q, k, v)
    B, N, H, D = q.shape
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    if scale < 0:   # the kernel takes scale >= 0; (-q) k^T |scale| is the same
        q, scale = -q, -scale
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, N, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), 1 if q.dtype == torch.bfloat16 else 0, stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error {rc}")
    attention.launches += 1
    attention.flash_route_launches += N >= FLASH_MIN_N
    return o


class _AttentionK1(torch.autograd.Function):
    """K1 forward; the backward replays attention_replay on the saved
    (un-negated) q, k, v, as onepass_attention's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_replay_grads(q, k, v, ctx.scale, grad_out)
        attention.backward_replays += 1
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, N, H, D); the model's one seam.

    A CPU tensor takes attention_plain (differentiable as it stands); a CUDA
    tensor launches the kernel (and counts the launch in
    `attention.launches`) or raises. Under grad with an input that requires
    it, the launch is the forward of an autograd Function whose backward
    replays the JAX VJP's math.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _AttentionK1.apply(q, k, v, scale)
    return _launch(q, k, v, scale)


attention.launches = 0
attention.flash_route_launches = 0
attention.backward_replays = 0
