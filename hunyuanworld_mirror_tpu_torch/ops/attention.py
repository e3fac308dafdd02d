"""Exact non-causal softmax attention: kernel K1 and its plain version.

Replaces BOTH attention routes of the JAX package: the one-pass Pallas
kernel hunyuanworld_mirror_tpu/ops/attn_onepass.py (`_kernel`, N <= 4095:
encoder, frame layers, camera head, global layers at S <= 2) and the Pallas
flash kernel that models/block.py `_flash_core` calls for N >= 4096 (global
layers at S >= 3). Both compute softmax(q k^T * scale) v with f32 logits and
an f32 row softmax; the CUDA kernel (csrc/attention_fwd.cu) streams K/V
tiles with an online softmax, so one kernel serves every N. f32 inputs
(the camera head) take its f32 route, K1c, counted in
`attention.f32_launches` besides `attention.launches`.

The host path is short because the camera head makes 16 launches of a few
microseconds each: the checks run once per (shapes, strides, dtypes,
devices) and the launch plan (the C entry's dims) is cached with them; the
device is switched only when it is not the current one.

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

_ENTRY = None   # the loaded C entry, declared
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
    """Give a loaded build of csrc/attention_fwd.cu its C signature: q, k,
    v, o, the plan's dims (14 int64: B, N, H, D, the (batch, token, head)
    strides of q, k and v, 1 for bf16), scale, stream."""
    p = ctypes.c_void_p
    lib.attention_fwd.argtypes = [p, p, p, p, p, ctypes.c_float, p]
    lib.attention_fwd.restype = ctypes.c_int
    return lib


def _entry():
    """attention_fwd's C entry, built, loaded and declared at first use."""
    global _ENTRY
    if _ENTRY is None:
        _ENTRY = declare(_build.load("attention_fwd")).attention_fwd
    return _ENTRY


class _Plan:
    """What a launch needs of a validated (shapes, strides, dtypes, devices):
    the C entry's dims (kept alive here, passed by address) and which
    routes it counts in."""

    __slots__ = ("dims", "addr", "bf16", "flash", "empty", "device")

    def __init__(self, q, k, v):
        B, N, H, D = q.shape
        self.bf16 = q.dtype == torch.bfloat16
        self.dims = (ctypes.c_longlong * 14)(
            B, N, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(self.bf16))
        self.addr = ctypes.addressof(self.dims)
        self.flash = N >= FLASH_MIN_N
        self.empty = q.numel() == 0
        self.device = q.device.index


# validated inputs by everything _check_inputs reads but the data pointers
_PLANS = {}
_PLANS_MAX = 1024


def _check_inputs(q, k, v):
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


def _check(q, k, v) -> _Plan:
    """Raise on what the kernel does not take (_check_inputs) -> the launch
    plan. Everything but the data pointers is checked once per (shapes,
    strides, dtypes, devices) and cached; the bf16 route's base alignment
    is checked on every call, with the same message."""
    key = (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
           q.dtype, k.dtype, v.dtype, q.device, k.device, v.device)
    plan = _PLANS.get(key)
    if plan is None:
        _check_inputs(q, k, v)
        plan = _Plan(q, k, v)
        if len(_PLANS) >= _PLANS_MAX:
            _PLANS.clear()
        _PLANS[key] = plan
    elif plan.bf16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned with strides "
                                 "that are multiples of 8 elements")
    return plan


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """One K1 launch on CUDA tensors; counts it in `attention.launches`
    (and in `f32_launches` or `flash_route_launches` by route)."""
    plan = _check(q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if plan.empty:
        return o
    if scale < 0:   # the kernel takes scale >= 0; (-q) k^T |scale| is the same
        q, scale = -q, -scale
        plan = _check(q, k, v)
    fn = _entry()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), plan.addr,
            float(scale))
    if torch.cuda.current_device() == plan.device:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(plan.device))
    else:
        with torch.cuda.device(plan.device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(plan.device))
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error {rc}")
    attention.launches += 1
    attention.flash_route_launches += plan.flash
    attention.f32_launches += not plan.bf16
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
    if not q.is_cuda:
        if q.device.type == "cpu":
            return attention_plain(q, k, v, scale)
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _AttentionK1.apply(q, k, v, scale)
    return _launch(q, k, v, scale)


attention.launches = 0
attention.flash_route_launches = 0
attention.f32_launches = 0
attention.backward_replays = 0
