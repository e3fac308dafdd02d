"""Each DPT-head convolution alone on the card, under dtype and cuDNN
variants.

    python -m hunyuanworld_mirror_tpu_torch.conv_ab [--views 4] [--img 518]
        [--iters 5] [--seed 0] [--preset large]
    python -m hunyuanworld_mirror_tpu_torch.conv_ab --device cpu --preset tiny --img 56

The port's twin of tools/conv_ab.py. The JAX tool times a hard-coded list
of six shapes; this one takes its list from the model: forward hooks on
every Conv2d and ConvTranspose2d of the four DPT heads (depth, points,
normals, GS; the camera head has none of them) during one heads forward of
the `large` model on S views at --img (`utils/scenes.render_scene`'s trunk
tokens), deduplicated by (kind, batch, H, W, Cin, Cout, kernel, stride,
padding, groups), each with the calls it gets a forward and the modules
that make them. Each distinct conv is then timed alone (F.conv2d /
F.conv_transpose2d with the module's weights cast once, an input drawn from
--seed) under VARIANTS:
  f32                f32, TF32 off: the shipped setting (the package's
                     __init__ turns TF32 off; cudnn.benchmark off);
  f32_benchmark      the same with torch.backends.cudnn.benchmark = True;
  tf32               cuDNN's TF32 on;
  bf16               bf16 input and weights;
  f32_channels_last  f32, input and weights channels_last.
Each line gives ms, TFLOP/s (FLOPs = 2 B H W k^2 Cin Cout / groups, H x W
the output's for a conv, the input's for a transposed conv) and the share
of CHIP_SPECS["h100"]'s peak (bf16 against the bf16 peak, the rest against
the f32 peak: TF32's tensor-core rate is not in the table, so its share may
pass 1), and the max |delta| against the shipped f32 output over that
output's max |value|, which must stay within BANDS of the variant's dtype
(the tool raises otherwise). Then, per variant, calls x ms summed over a
forward beside the four heads' own time at f32: how much of the heads the
convs account for. The global cuDNN flags are restored on exit, whatever
was raised.

Each time is `utils/profiling.time_fn`'s median of --iters calls after one
warm-up (the cuDNN autotune of f32_benchmark runs there), each call ended
by torch.cuda.synchronize (the JAX tool's in-jit repeat harness and relay
floor have no counterpart); every line carries the card's name and power
limit, and the last line is one JSON object with all the numbers. Runs on
the card; without one it raises unless given --device cpu, which rehearses
on the CPU's convolutions and prints every time as null.
"""

import argparse
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .render_profile import heads_forward
from .utils.profiling import ToolRun, fmt_ms
from .utils.scenes import add_scene_args, scene_from_args

HEADS = ("depth_head", "pts_head", "norm_head", "gs_head")
# name -> (dtype, channels_last, cudnn.benchmark, cudnn.allow_tf32)
VARIANTS = {
    "f32": (torch.float32, False, False, False),
    "f32_benchmark": (torch.float32, False, True, False),
    "tf32": (torch.float32, False, False, True),
    "bf16": (torch.bfloat16, False, False, False),
    "f32_channels_last": (torch.float32, True, False, False),
}
# max |y - y_f32| / max |y_f32| allowed: f32 under another algorithm or
# layout (FFT and Winograd round differently), TF32's 10-bit and bf16's
# 7-bit mantissas on the inputs (bf16 also rounds the output)
BANDS = {"f32": 1e-4, "tf32": 1e-2, "bf16": 5e-2}


@dataclass
class ConvEntry:
    kind: str              # "conv" or "deconv" (ConvTranspose2d)
    in_shape: tuple        # (B, Cin, H, W)
    out_shape: tuple       # (B, Cout, Ho, Wo)
    kernel: tuple
    stride: tuple
    padding: tuple
    groups: int
    module: nn.Module      # the first module of this shape (its weights)
    names: List[str] = field(default_factory=list)
    calls: int = 0

    @property
    def flops(self) -> float:
        B, cin = self.in_shape[:2]
        cout = self.out_shape[1]
        h, w = self.out_shape[2:] if self.kind == "conv" else self.in_shape[2:]
        return (2.0 * B * h * w * self.kernel[0] * self.kernel[1] * cin * cout
                / self.groups)

    @property
    def label(self) -> str:
        B, cin, h, w = self.in_shape
        return (f"{self.kind} {self.kernel[0]}x{self.kernel[1]}/{self.stride[0]} "
                f"{cin}>{self.out_shape[1]} B={B} {h}x{w}")


def collect_convs(model, token_list, images, start) -> List[ConvEntry]:
    """The four DPT heads' convolutions, one forward of each under forward
    hooks -> one entry a distinct shape, in the order of first call."""
    entries: Dict[tuple, ConvEntry] = {}

    def hook(name):
        def record(m, inputs, out):
            x = inputs[0]
            kind = "deconv" if isinstance(m, nn.ConvTranspose2d) else "conv"
            key = (kind, *x.shape[:1], *x.shape[2:], m.in_channels, m.out_channels,
                   m.kernel_size, m.stride, m.padding, m.groups)
            e = entries.setdefault(key, ConvEntry(
                kind, tuple(x.shape), tuple(out.shape), tuple(m.kernel_size),
                tuple(m.stride), tuple(m.padding), m.groups, m))
            e.calls += 1
            e.names.append(name)
        return record

    handles = [m.register_forward_hook(hook(f"{h}.{name}"))
               for h in HEADS for name, m in getattr(model, h).named_modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            for h in HEADS:
                getattr(model, h)(token_list, images, start)
    finally:
        for handle in handles:
            handle.remove()
    return list(entries.values())


@contextlib.contextmanager
def cudnn_flags(benchmark: bool, tf32: bool):
    """cuDNN's benchmark and TF32 flags inside the block, restored after."""
    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cudnn.benchmark = benchmark
        torch.backends.cudnn.allow_tf32 = tf32
        yield
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = saved


def conv_call(e: ConvEntry, x: torch.Tensor, dtype, channels_last: bool):
    """The entry's convolution on `x` in `dtype` (weights cast once)."""
    m = e.module
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = x.to(dtype).contiguous(memory_format=fmt)
    w = m.weight.detach().to(dtype).contiguous(memory_format=fmt)
    b = None if m.bias is None else m.bias.detach().to(dtype)
    if e.kind == "deconv":
        return lambda: F.conv_transpose2d(x, w, b, m.stride, m.padding,
                                          m.output_padding, m.groups, m.dilation)
    return lambda: F.conv2d(x, w, b, m.stride, m.padding, m.dilation, m.groups)


def band(variant: str) -> float:
    dtype, _, _, tf32 = VARIANTS[variant]
    return BANDS["bf16" if dtype == torch.bfloat16 else "tf32" if tf32 else "f32"]


def main(argv: Optional[List[str]] = None, scene=None) -> Dict:
    """Time the heads' convolutions -> the numbers (the last line's JSON).
    `scene` (a utils/scenes.RenderScene on the run's device) skips building
    one."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_scene_args(ap, iters=5, cameras=False)
    args = ap.parse_args(argv)
    run = ToolRun(args.device, args.iters)
    if scene is None:
        scene = scene_from_args(args, run.device)
    model, toks, imgs, start = (scene.model, scene.token_list, scene.images,
                                scene.patch_start_idx)
    entries = collect_convs(model, toks, imgs, start)
    gen = torch.Generator(device=run.device).manual_seed(args.seed)
    rows = []
    with torch.no_grad():
        heads_ms = run.ms(heads_forward, model, toks, imgs, start)
        for e in entries:
            x = torch.randn(e.in_shape, generator=gen, device=run.device)
            row = {"label": e.label, "calls": e.calls,
                   "gflop": e.flops / 1e9, "variants": {}}
            ref = None
            for name, (dtype, cl, bench, tf32) in VARIANTS.items():
                with cudnn_flags(bench, tf32):
                    fn = conv_call(e, x, dtype, cl)
                    y = fn().float()
                    ms = run.ms(fn)
                if ref is None:
                    ref = y
                delta = float((y - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
                peak = (None if run.spec is None else run.spec.peak_flops_bf16
                        if dtype == torch.bfloat16 else run.spec.peak_flops_f32)
                tflops = None if ms is None else e.flops / ms / 1e9
                share = None if ms is None else tflops * 1e12 / peak
                row["variants"][name] = {"ms": ms, "tflops": tflops, "share": share,
                                         "rel_delta": delta}
                run.log(f"{e.label:40s} x{e.calls:<3d} {name:17s} {fmt_ms(ms, 4)} ms  "
                        f"{'null' if ms is None else f'{tflops:7.2f}'} TFLOP/s  share "
                        f"{'null' if ms is None else f'{share:.3f}'}  rel delta "
                        f"{delta:.2e}")
                if not delta <= band(name):
                    raise AssertionError(f"conv_ab: {e.label} {name}: relative delta "
                                         f"{delta:.3e} past its band {band(name):.0e}")
            rows.append(row)
    sums = {}
    for name in VARIANTS:
        sums[name] = (float(sum(r["calls"] * r["variants"][name]["ms"] for r in rows))
                      if run.on_card else None)
        run.log(f"calls x ms over a forward, {name:17s}: {fmt_ms(sums[name])} ms  "
                f"(the four heads at f32: {fmt_ms(heads_ms)} ms)")
    if run.on_card:
        rows.sort(key=lambda r: -r["calls"] * r["variants"]["f32"]["ms"])
        for r in rows[:5]:
            part = r["calls"] * r["variants"]["f32"]["ms"]
            run.log(f"f32 leader: {r['label']:40s} x{r['calls']} {part:.3f} ms "
                    f"({100 * part / sums['f32']:.1f}% of the f32 sum)")
    return run.finish("conv_ab", {"views": imgs.shape[1], "img": imgs.shape[3],
                                  "convs": rows, "sums_ms": sums,
                                  "heads_f32_ms": heads_ms,
                                  "distinct": len(rows),
                                  "calls": sum(r["calls"] for r in rows)})


if __name__ == "__main__":
    main()
