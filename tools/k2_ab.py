"""K2, the rasterizer forward, on the main path's and the training cell's own
lists, one NVIDIA GPU: a parent tree's build against this tree's, or this
tree with pieces of its design swapped, in alternating rounds in one process.

    python3 tools/k2_ab.py PARENT [--variants]

PARENT is a checkout root of the tree to compare against (a parent unpacked
with `git archive` into a directory `.gitignore` lists, e.g.
build/ab/parent). First one process runs the main path of `chip_smoke.py`
(the `large` preset, S=4, 518 px, random weights, fixed cameras), exports it
for tools/k3_ab.py's training runs and saves its splats and cameras. Then
one process:

  * builds PARENT's csrc/rasterize_flat_fwd.cu and this tree's (with
    --variants also one build per entry of VARIANTS: this tree's sources
    with one piece of the design swapped by a text substitution for what
    it was measured against), all nvcc processes at once, into
    build/k2_ab/;
  * makes three sets of 4 lists (one per camera): the main path's (f16
    payload, the render's caps, as phase 5 of chip_smoke.py bins them), and
    through tools/k3_ab.py's `train` (30 training steps of this tree) the
    training step's at step 10 and after the refine at 29 (f32 payload,
    blended with the training planes);
  * holds every build's outputs (image, alpha, and on the training lists
    the final T and last kept entry) against the parent build's bit for
    bit, and fails where they differ;
  * times each build on each set (totals over its 4 lists, CUDA events) in
    ROUNDS rounds whose order alternates (P C ... then ... C P). A build
    whose C entry sorts the tiles itself (longest first) is timed with that
    sort and without it (a null order: tiles in index order);
  * prints each set's share of (warp, entry) steps the 8 x 4 warps cull
    (chip_smoke.blend_pairs) and each build's ptxas registers, spills and
    blocks an SM;
  * K5 at G = 16, 8 and 4 on the main path's 4 lists clamped to their group
    windows (rasterizer_flat.group_windows): PARENT's K5 where it has a
    kernel of its own (csrc/rasterize_flat_grouped_fwd.cu, its C entry),
    this tree's K5 (`rasterize_flat_grouped`, which launches K2's entry on
    the clamped lists) through its wrapper and through the C entry it
    launches, and this tree's K2 (`rasterize_flat`) on the same lists: the
    image and alpha of each held against this tree's K5 bit for bit, and
    each timed (totals over the 4 cameras) in ROUNDS alternating rounds.

The card's name and power limit come first. Nothing here runs without a
card.
"""

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools import k3_ab  # noqa: E402

OUT_DIR = ROOT / "build" / "k2_ab"
SCENE = OUT_DIR / "main_path_scene.pt"
W = H = 518
D = 4
ROUNDS = 5
# name -> [(file, the source's text, its replacement), ...]: the design's
# pieces swapped, one at a time, for what they were measured against.
FWD, COMMON = "rasterize_flat_fwd.cu", "raster_common.cuh"
K5_OLD = "rasterize_flat_grouped_fwd"   # K5's kernel of its own, before it took K2's
K5_GROUPS = (16, 8, 4)
BLEND_HEAD = "  __device__ __forceinline__ void blend(const Batch& b, int nb, int b0) {\n"


def split(n: int):
    """A tile's pixels over n blocks of 256 / n threads, each block 8 / n
    of the tile's warps."""
    return [(FWD, "__launch_bounds__(MAX_THREADS)\n", f"__launch_bounds__(MAX_THREADS / {n})\n"),
            (FWD, "int(order[blockIdx.x]) : blockIdx.x;",
             f"int(order[blockIdx.x / {n}]) : blockIdx.x / {n};"),
            (FWD, "pixel.init(seg - cam * n_tiles, threadIdx.x >> 5,",
             f"pixel.init(seg - cam * n_tiles, (blockIdx.x % {n}) * (blockDim.x >> 5) + "
             "(threadIdx.x >> 5),"),
            (FWD, "  const int nthr = tile_size * tile_size;\n",
             f"  const int nthr = tile_size * tile_size / {n};\n"),
            (FWD, "<<<n_tiles * n_cams, nthr,", f"<<<n_tiles * n_cams * {n}, nthr,")]


def serial_walk(cull: bool):
    """Every staged entry in turn for the whole warp: its box checked by the
    warp (K3's skip), or no skip at all."""
    test = "!box_misses(b.box[i], x0, x1, y0, y1)" if cull else "true"
    return [(COMMON, BLEND_HEAD,
             BLEND_HEAD + "    for (int i = 0; i < nb && !done; ++i)\n"
             f"      if ({test}) apply(b, i, b0, raw_alpha(b, i));\n    return;\n")]


VARIANTS = {
    "split 2": split(2),
    "split 4": split(4),
    "one hit a warp step": [(COMMON, "        if (hits == 0u) {\n          apply(",
                             "        if (true) {\n          apply(")],
    "warps of 16 x 2 pixels": [(COMMON, "constexpr int WARP_W = 8, WARP_H = 4;",
                                "constexpr int WARP_W = 16, WARP_H = 2;")],
    "serial box checks": serial_walk(True),
    "no cull": serial_walk(False),
    "keep box inlined": [(COMMON, "__device__ __noinline__ float4 keep_box(",
                          "__device__ __forceinline__ float4 keep_box(")],
    "6 blocks an SM (<= 40 registers)": [(FWD, "__launch_bounds__(MAX_THREADS)\n",
                                          "__launch_bounds__(MAX_THREADS, 6)\n")],
    "six planes a staged entry": [
        (COMMON, "    geo[s] = make_float4(e.mx, e.my, e.ca, e.cb);\n"
                 "    cop[s] = make_float2(e.cc, e.op);\n",
         "    float* pl = reinterpret_cast<float*>(geo);\n"
         "    pl[s] = e.mx;\n    pl[nthr + s] = e.my;\n    pl[2 * nthr + s] = e.ca;\n"
         "    pl[3 * nthr + s] = e.cb;\n    pl[4 * nthr + s] = e.cc;\n"
         "    pl[5 * nthr + s] = e.op;\n"),
        (COMMON, "    const float4 g = b.geo[i];\n    const float2 q = b.cop[i];\n"
                 "    const float dx = px - g.x;\n    const float dy = py - g.y;\n"
                 "    const float sigma = conic_sigma(g.z, g.w, q.x, dx, dy);\n"
                 "    return sigma >= 0.f ? q.y * expf(-sigma) : 0.f;",
         "    const float* pl = reinterpret_cast<const float*>(b.geo);\n"
         "    const int n = b.nthr;\n"
         "    const float dx = px - pl[i];\n    const float dy = py - pl[n + i];\n"
         "    const float sigma = conic_sigma(pl[2 * n + i], pl[3 * n + i], pl[4 * n + i], "
         "dx, dy);\n"
         "    return sigma >= 0.f ? pl[5 * n + i] * expf(-sigma) : 0.f;")],
}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def prepare():
    """The main path's predictions -> k3_ab.INFER_DIR (for k3_ab.train) and
    its splats and 4 cameras -> SCENE."""
    import numpy as np
    import torch

    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.infer import PRESETS, export, run
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig

    imgs = np.random.default_rng(0).uniform(size=(1, 4, W, H, 3)).astype(np.float32)
    preds = run(imgs, WorldMirrorConfig(**PRESETS["large"]),
                camera_params=chip_smoke.fixed_cameras(4))
    torch.cuda.synchronize()
    export(preds, imgs, k3_ab.INFER_DIR)
    np.save(k3_ab.INFER_DIR / "images.npy", imgs[0])
    torch.save(chip_smoke.main_path_scene(preds)[:7], SCENE)


def takes_order(source: str) -> bool:
    """Whether a rasterize_flat_fwd.cu's C entry takes a tile order."""
    decl = re.search(r'extern "C" int rasterize_flat_fwd\((.*?)\)', source, re.S)
    return "order" in decl.group(1)


def build(trees_and_variants, parent_k5=None):
    """{name: (csrc dir, [(file, old, new), ...])} -> ({name: (library, takes
    an order, ptxas report)}, PARENT's K5 C entry or None); every nvcc at
    once. parent_k5: the csrc dir holding K5_OLD.cu, if it does."""
    from hunyuanworld_mirror_tpu_torch.ops import _build
    procs = {}
    jobs = [(name, csrc, subs, FWD) for name, (csrc, subs) in trees_and_variants.items()]
    if parent_k5 is not None:
        jobs.append(("K5 parent", parent_k5, [], f"{K5_OLD}.cu"))
    for i, (name, csrc, subs, source) in enumerate(jobs):
        src_dir = OUT_DIR / f"src_{i}"
        src_dir.mkdir(parents=True, exist_ok=True)
        texts = {f.name: f.read_text() for f in Path(csrc).glob("raster*")}
        for file, old, new in subs:
            if old not in texts[file]:
                raise RuntimeError(f"{name}: {old!r} is no longer in {file}")
            texts[file] = texts[file].replace(old, new)
        for file, text in texts.items():
            (src_dir / file).write_text(text)
        lib = OUT_DIR / f"libk2_{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src_dir / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            source == FWD and takes_order(texts[FWD]))
    libs, k5 = {}, None
    for name, (proc, lib, order) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        if name == "K5 parent":
            k5 = ctypes.CDLL(str(lib)).rasterize_flat_grouped_fwd
            k5.argtypes = [_P] * 7 + [_I] * 7 + [_LL, _I, _P]
            k5.restype = ctypes.c_int
            continue
        fn = ctypes.CDLL(str(lib)).rasterize_flat_fwd
        fn.argtypes = [_P] * (8 if order else 7) + [_I] * 6 + [_LL, _I, _P]
        fn.restype = ctypes.c_int
        libs[name] = (fn, order, report)
    return libs, k5


def make_lists():
    """{set label: [(bins, f16, with the training planes), ...]} and the
    summary of k3_ab.train's runs."""
    import torch

    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer

    means, quats, scales, opac, sh, w2c, intr = torch.load(SCENE)
    sets = {"main path": [
        (rasterizer.bin_camera(means, quats, scales, opac, sh, w2c[c], intr[c], W, H, 16,
                               chip_smoke.RENDER_MPT, chip_smoke.RENDER_TPG, True),
         True, False) for c in range(4)]}
    summary, snaps, _, _ = k3_ab.train(str(ROOT))
    for label, lists in snaps.items():
        sets[f"training {label}"] = [(lst[0], False, True) for lst in lists()]
    return sets, summary


def main_measure(parent: str, variants: bool):
    import torch

    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.ops import _build
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R

    t0 = time.time()
    builds = {"parent": (Path(parent) / "hunyuanworld_mirror_tpu_torch" / "csrc", []),
              "this tree": (_build.CSRC, [])}
    if variants:
        builds.update({name: (_build.CSRC, subs) for name, subs in VARIANTS.items()})
    pcsrc = Path(parent) / "hunyuanworld_mirror_tpu_torch" / "csrc"
    libs, k5_parent = build(builds, pcsrc if (pcsrc / f"{K5_OLD}.cu").exists() else None)
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s", flush=True)
    sets, summary = make_lists()
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, bins, f16, state, outs, order=None):
        fn, takes, _ = libs[name]
        img, alpha, t_fin, last = outs
        args = [bins.packed.data_ptr(), bins.starts.data_ptr(), bins.counts.data_ptr()]
        if takes:
            args.append(None if order is None else order.data_ptr())
        args += [img.data_ptr(), alpha.data_ptr(),
                 t_fin.data_ptr() if state else None, last.data_ptr() if state else None,
                 W, H, 16, 33, 33 * 33, D, bins.packed.shape[1], int(f16), stream]
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    # bit for bit against the parent build
    out = dict(summary=summary, sets={})
    for label, lists in sets.items():
        pairs = {}
        for bins, f16, _ in lists:
            for k, v in chip_smoke.blend_pairs(bins.packed, bins.starts, bins.counts, W, H,
                                               16, D, f16).items():
                pairs[k] = pairs.get(k, 0) + v
        differ = {}
        for bins, f16, state in lists:
            ref = None
            for name in libs:
                outs = R.forward_outputs((), H, W, D, bins.packed.device, True)
                order = torch.empty(bins.counts.shape, dtype=torch.int64, device="cuda")
                call(name, bins, f16, state, outs, order)
                torch.cuda.synchronize()
                outs = outs if state else outs[:2]
                if ref is None:
                    ref = outs
                elif not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                    differ[name] = [int((a != b).sum()) for a, b in zip(outs, ref)]
        out["sets"][label] = dict(
            entries=sum(int(b.counts.sum()) for b, _, _ in lists), pairs=pairs,
            culled=1 - pairs["fwd_warp_hit"] / max(pairs["fwd_warp_walked"], 1),
            differ_from_parent=differ)
        print(f"{label}: {out['sets'][label]}", flush=True)

    # alternating rounds
    hows = ("longest first", "tile order")
    times = {(name, label, how): [] for name in libs for label in sets for how in hows}
    scratch = {label: [R.forward_outputs((), H, W, D, b.packed.device, True)
                       for b, _, _ in lists] for label, lists in sets.items()}
    orders = {label: [torch.empty(b.counts.shape, dtype=torch.int64, device="cuda")
                      for b, _, _ in lists] for label, lists in sets.items()}
    names = list(libs)
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            for label, lists in sets.items():
                for how in (hows if libs[name][1] else hows[1:]):
                    total = 0.0
                    for (bins, f16, state), outs, order in zip(lists, scratch[label],
                                                                orders[label]):
                        o = order if how == "longest first" else None
                        total += chip_smoke.cuda_ms(
                            lambda: call(name, bins, f16, state, outs, o), reps=5, warmup=1)
                    times[(name, label, how)].append(total)
    res = {}
    for name, (_, _, report) in libs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", report))
        frames = sum(int(n) for n in re.findall(r"(\d+) bytes stack frame", report))
        res[name] = dict(registers=regs, spill_bytes=spills, stack_bytes=frames, ms={})
        for label in sets:
            for how in hows:
                if times[(name, label, how)]:
                    res[name]["ms"][f"{label}, {how}"] = times[(name, label, how)]
    print(json.dumps(dict(out, builds=res)), flush=True)
    for name, r in res.items():
        print(f"{name}: registers {r['registers']}, spills {r['spill_bytes']} B, stack "
              f"{r['stack_bytes']} B", flush=True)
        for key, ts in r["ms"].items():
            print(f"  {key:46s} median {statistics.median(ts):.4f} ms  rounds "
                  + " ".join(f"{x:.4f}" for x in ts), flush=True)
    bad = {label: s["differ_from_parent"] for label, s in out["sets"].items()
           if s["differ_from_parent"]}
    k5 = measure_k5([b for b, _, _ in sets["main path"]], libs["this tree"][0], k5_parent,
                    stream)
    bad.update({f"K5 G={g}": r["differ"] for g, r in k5.items() if r["differ"]})
    if bad:
        raise AssertionError(f"outputs differ: {bad}")


def measure_k5(lists, tree_entry, parent_k5, stream):
    """K5 on the main path's f16 lists clamped at each of K5_GROUPS: parent's
    (its own kernel, if given), this tree's through its wrapper and through
    K2's C entry it launches, and this tree's K2, held against this tree's
    K5 bit for bit and timed in alternating rounds -> {G: {"differ": {name:
    [differing elements of img, alpha]}, "ms": {name: [totals a round]}}}."""
    import torch

    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    res = {}
    for group in K5_GROUPS:
        clamped = [R.group_windows(b.starts, b.counts, group, chip_smoke.RENDER_MPT,
                                   b.packed.shape[1])[:2] for b in lists]
        outs = [R.forward_outputs((), H, W, D, "cuda")[:2] for _ in lists]
        orders = [torch.empty(b.counts.shape, dtype=torch.int64, device="cuda")
                  for b in lists]

        def calls(i):
            bins, (st, ct), (img, alpha) = lists[i], clamped[i], outs[i]
            args = (bins.packed, st, ct, W, H, 16, D, True)
            head = [bins.packed.data_ptr(), st.data_ptr(), ct.data_ptr()]
            tail = [img.data_ptr(), alpha.data_ptr(), None, None, W, H, 16, 33, 33 * 33]
            fns = {"K5 this tree": lambda: R.rasterize_flat_grouped(*args, group),
                   "K5 this tree, C entry": lambda: tree_entry(
                       *head, orders[i].data_ptr(), *tail, D, bins.packed.shape[1], 1,
                       stream),
                   "K2 this tree": lambda: R.rasterize_flat(*args)}
            if parent_k5 is not None:
                fns["K5 parent"] = lambda: parent_k5(
                    *head, *tail, group, D, bins.packed.shape[1], 1, stream)
            return fns

        differ = {}
        for i in range(len(lists)):
            ref, fns = None, calls(i)
            for name, fn in fns.items():
                got = fn()
                if got is None or isinstance(got, int):
                    if got:
                        raise RuntimeError(f"{name}: CUDA error {got}")
                    got = outs[i]
                torch.cuda.synchronize()
                got = [x.clone() for x in got]
                if ref is None:
                    ref = got
                elif not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    differ.setdefault(name, []).append(
                        [int((a != b).sum()) for a, b in zip(got, ref)])
        names = list(calls(0))
        times = {name: [] for name in names}
        for r in range(ROUNDS):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name].append(sum(chip_smoke.cuda_ms(calls(i)[name], reps=5, warmup=1)
                                       for i in range(len(lists))))
        res[group] = dict(differ=differ, ms=times,
                          entries=sum(int(ct.sum()) for _, ct in clamped))
        print(f"K5 G={group:2d}, {res[group]['entries']} entries after the clamp: "
              f"{'bit for bit' if not differ else differ}", flush=True)
        for name, ts in times.items():
            print(f"  {name:24s} median {statistics.median(ts):.4f} ms a render  rounds "
                  + " ".join(f"{x:.4f}" for x in ts), flush=True)
    print(json.dumps({"k5": res}), flush=True)
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if not sys.argv[1:] or sys.argv[1].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    k3_ab.INFER_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    subprocess.run([sys.executable, __file__, "--prepare"], check=True)
    print(f"prepare: {time.time() - t0:.1f} s", flush=True)
    subprocess.run([sys.executable, __file__, "--measure", str(Path(sys.argv[1]).resolve()),
                    *sys.argv[2:]], check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--prepare"]:
        prepare()
    elif sys.argv[1:2] == ["--measure"]:
        main_measure(sys.argv[2], "--variants" in sys.argv[3:])
    else:
        sys.exit(main())
