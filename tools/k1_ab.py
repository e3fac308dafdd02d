"""A/B of K1's build-time design choices, on one NVIDIA GPU.

    python3 tools/k1_ab.py [PARENT]

Compiles hunyuanworld_mirror_tpu_torch/csrc/attention_fwd.cu once as it is
and once for each variant below (one constant changed), loads each
build with ctypes, holds each against the plain version (max|d| within
2^-6 max|plain|, phase 3's band of chip_smoke.py) and times them in
alternating rounds at the main path's bf16 shapes, every build launched
through its C entry alone, with SDPA beside them. Prints the card's name
and power limit first. Nothing here runs without a card.

With PARENT, a checkout root of another tree (a parent unpacked with `git
archive` into a directory `.gitignore` lists, e.g. build/ab/parent), it
also builds PARENT's attention_fwd.cu and times its f32 route against this
tree's (K1c) at the camera head's (1, N, 16, 128), N = 4, 16 and 32, each
held to the plain version's f32 band (2^-16 max|plain|): the device time a call
under torch.profiler and the C entry's time a call in a back-to-back loop,
in alternating rounds, SDPA beside them. It also holds this tree's bf16
route (K1a, K1b) to PARENT's bit for bit at the main path's shapes and on
the encoder's fused-qkv views, and fails where they differ.
"""

import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hunyuanworld_mirror_tpu_torch.ops import _build  # noqa: E402
from hunyuanworld_mirror_tpu_torch.ops import attention as A  # noqa: E402

# name -> (the source's line, its replacement), or None for the source as it is
VARIANTS = {
    "as built": None,
    "2 consumer warpgroups": ("constexpr int CONSUMER_WGS = 3;",
                              "constexpr int CONSUMER_WGS = 2;"),
    "3 K/V stages": ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
    "no ping-pong turns": ("constexpr bool PINGPONG = true;",
                           "constexpr bool PINGPONG = false;"),
}
SHAPES = [("encoder", (4, 1374, 16, 64)), ("frame", (4, 1376, 16, 64)),
          ("global", (1, 5504, 16, 64))]
ROUNDS, REPS = 6, 30


def build(out_dir: Path):
    """Compile every variant at once -> {name: loaded library}."""
    src = (_build.CSRC / "attention_fwd.cu").read_text()
    procs = {}
    for i, (name, sub) in enumerate(VARIANTS.items()):
        text = src
        if sub is not None:
            if sub[0] not in text:
                raise RuntimeError(f"{name}: {sub[0]!r} is no longer in the source")
            text = text.replace(*sub)
        path = out_dir / f"k1_ab_{i}.cu"
        path.write_text(text)
        lib = out_dir / f"libk1_ab_{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(lib), str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        for line in report.splitlines():    # registers, spills, any C75xx warning
            if "Used" in line or "spill" in line or "C75" in line:
                print(f"{name}: {line.strip()}", flush=True)
        libs[name] = A.declare(ctypes.CDLL(str(lib)))
    return libs


def launch(lib, q, k, v, o, scale):
    rc = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           A._check(q, k, v).addr, scale,
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")


def parent_k1(parent: str):
    """PARENT's attention_fwd.cu built and loaded -> a launch function of
    (q, k, v, o, scale) for either of its C signatures (dims by address, or
    the 22 arguments of the trees before it)."""
    src = Path(parent) / "hunyuanworld_mirror_tpu_torch" / "csrc" / "attention_fwd.cu"
    lib_path = _build.BUILD_DIR / "libk1_ab_parent.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    if re.search(r"const long long\* dims", src.read_text()):
        A.declare(lib)

        def run(q, k, v, o, scale):
            launch(lib, q, k, v, o, scale)
    else:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.attention_fwd.argtypes = [p, p, p, p, i, i, i, i] + [ll] * 9 + [
            ctypes.c_float, i, p]
        lib.attention_fwd.restype = ctypes.c_int

        def run(q, k, v, o, scale):
            rc = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   *q.shape, *q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3], scale, int(q.dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"the parent's K1 launch failed: CUDA error {rc}")
    return run


def device_ms(fn, reps=100):
    """fn's device time a call under torch.profiler (its CUDA kernels), or
    None if the profiler shows none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps if total > 0 else None


def bf16_same(theirs, ours, gen):
    """This tree's bf16 route against PARENT's, bit for bit, at SHAPES and
    on fused-qkv views (N-stride 3 C)."""
    cases = [(label, [torch.randn(shape, generator=gen, device="cuda").bfloat16()
                      for _ in range(3)]) for label, shape in SHAPES]
    x = torch.randn(4, 1374, 3, 16, 64, generator=gen, device="cuda").bfloat16()
    cases.append(("fused views", list(x.unbind(2))))
    for label, (q, k, v) in cases:
        scale = q.shape[-1] ** -0.5
        o_theirs, o_ours = torch.empty_like(q), torch.empty_like(q)
        theirs(q, k, v, o_theirs, scale)
        launch(ours, q, k, v, o_ours, scale)
        torch.cuda.synchronize()
        same = torch.equal(o_theirs, o_ours)
        print(f"bf16 {label} {tuple(q.shape)}: this tree against the parent "
              f"{'bit for bit' if same else 'DIFFERS'}", flush=True)
        if not same:
            raise AssertionError(f"bf16 {label}: {int((o_theirs != o_ours).sum())} "
                                 "elements differ from the parent's")


def f32_ab(parent: str):
    """K1c (this tree's C entry) against PARENT's f32 route and SDPA; the
    bf16 route against PARENT's bit for bit."""
    theirs = parent_k1(parent)
    ours = A.declare(_build.load("attention_fwd"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16_same(theirs, ours, gen)
    for n in (4, 16, 32):
        shape = (1, n, 16, 128)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        o = torch.empty_like(q)
        scale = 128 ** -0.5
        ref = A.attention_plain(q, k, v, scale)
        band = 2.0 ** -16 * float(ref.abs().max())
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        runs = {"parent f32": lambda: theirs(q, k, v, o, scale),
                "this tree (K1c)": lambda: launch(ours, q, k, v, o, scale),
                "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale)}
        for name in ("parent f32", "this tree (K1c)"):
            o.zero_()
            runs[name]()
            torch.cuda.synchronize()
            err = float((o - ref).abs().max())
            if not err <= band:
                raise AssertionError(f"{name} {shape}: max|d| {err} > {band}")
        times = {name: ([], []) for name in runs}
        names = list(runs)
        for r in range(ROUNDS):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name][0].append(device_ms(runs[name]))
                times[name][1].append(cuda_ms(runs[name], reps=200))
        for name, (dev, call) in times.items():
            dev = [x for x in dev if x is not None]
            print(f"f32 {shape}: {name:16s} device (profiler) median "
                  f"{statistics.median(dev) if dev else float('nan'):.5f} ms  C entry a "
                  f"call median {statistics.median(call):.5f} ms  rounds "
                  + " ".join(f"{x:.5f}" for x in dev), flush=True)


def cuda_ms(fn, reps=REPS):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if sys.argv[1:]:
        f32_ab(sys.argv[1])
    libs = build(_build.BUILD_DIR)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, shape in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        o = torch.empty_like(q)
        scale = shape[-1] ** -0.5
        ref = A.attention_plain(q, k, v, scale).float()
        band = 2.0 ** -6 * float(ref.abs().max())
        runs = {name: (lambda lib=lib: launch(lib, q, k, v, o, scale))
                for name, lib in libs.items()}
        for name, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            err = float((o.float() - ref).abs().max())
            if not err <= band:
                raise AssertionError(f"{name} {shape}: max|d| {err} > {band}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        runs["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale)
        t0 = time.time()
        while time.time() - t0 < 1.0:       # clocks up before the first round
            for fn in runs.values():
                fn()
        times = {name: [] for name in runs}
        names = list(runs)
        for r in range(ROUNDS):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name].append(cuda_ms(runs[name]))
        flops = 4.0 * shape[0] * shape[2] * shape[1] ** 2 * shape[3]
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"{label} {shape}: {name:24s} median {med:.4f} ms "
                  f"(min {min(ts):.4f}, max {max(ts):.4f}, {ROUNDS} rounds of {REPS})  "
                  f"{flops / med / 1e9:.0f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
