"""K4, the dense-bin rasterizer forward, on the main path's and the training
step's own tables, one NVIDIA GPU: a parent tree's build against this
tree's, and this tree with one piece of its design taken back at a time, in
alternating rounds in one process.

    python3 tools/k4_ab.py PARENT [--variants]

PARENT is a checkout root of the tree to compare against (a parent unpacked
with `git archive` into a directory `.gitignore` lists, e.g.
build/ab/parent). First one process runs the main path of `chip_smoke.py`
(the `large` preset, S=4, 518 px, random weights, fixed cameras), exports
it and saves its splats and cameras. Then one process:

  * builds PARENT's csrc/rasterize_binned_fwd.cu and rasterize_flat_fwd.cu
    and this tree's (with --variants also one K4 build per entry of
    VARIANTS: this tree's sources with one piece of the design swapped by a
    text substitution for what it replaced, or for an alternative tried:
    the splats' fields gathered from their arrays with no table at all),
    all nvcc processes at once, into build/k4_ab/;
  * makes two sets of 4 dense tables (one per camera), as the routes bin
    them: the `--rasterizer jax` forward's (tight radii, the exact
    ellipse-tile test, 4 tiles a splat, 4096 a tile) and the training
    step's on that route (step 0's splats, 9 tiles a splat, 4096 a tile);
  * holds every K4 build's image and alpha against the parent build's bit
    for bit on both sets, and K2 and K2m (rasterize_flat_fwd.cu) of this
    tree against the parent's on the main path's per-camera and
    camera-batched lists; it fails where any differs;
  * times each K4 build's C entry on each set (totals over its 4 tables,
    CUDA events) in ROUNDS rounds whose order alternates (P C ... then ...
    C P). A C entry that takes the splats' arrays packs its own table into
    a scratch (the "rows from splat_table" variant skips that and reads
    splat_table's rows, built beforehand); one that takes a table reads
    splat_table's. The wrapper-side table (splat_table) is timed beside
    them;
  * prints each build's ptxas registers, spills and stack.

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

OUT_DIR = ROOT / "build" / "k4_ab"
INFER_DIR = OUT_DIR / "infer"
SCENE = OUT_DIR / "main_path_scene.pt"
W = H = 518
TILE = 16
ROUNDS = 5
K4 = "rasterize_binned_fwd.cu"
# name -> [(file, the source's text, its replacement), ...]: the design's
# pieces taken back, or another tried, one at a time
VARIANTS = {
    "rows from splat_table": [
        (K4, "    if (n_splats > 0)\n      pack_rows_kernel",
         "    if (false)\n      pack_rows_kernel")],
    "tiles in index order": [
        (K4, "  const int t = int(order[blockIdx.x]);", "  const int t = blockIdx.x;"),
        (K4, "  raster::longest_first_kernel<<<",
         "  if (false) raster::longest_first_kernel<<<")],
    "no table: fields gathered from the arrays": [
        (K4, "    if (n_splats > 0)\n      pack_rows_kernel",
         "    if (false)\n      pack_rows_kernel"),
        (K4, "raster_binned_kernel(const float* __restrict__ table,",
         "raster_binned_kernel(const float* __restrict__ table, const float* g_m2d, "
         "const float* g_con, const float* g_op, const float* g_col,"),
        (K4, "        static_cast<const float*>(table), static_cast<const int*>(ids),",
         "        static_cast<const float*>(table), static_cast<const float*>(means2d), "
         "static_cast<const float*>(conics), static_cast<const float*>(opacities), "
         "static_cast<const float*>(colors), static_cast<const int*>(ids),"),
        (K4, "    const float* row = table + static_cast<long long>(tile_ids[j]) * (6 + D);\n"
             "    b.put(s, {row[0], row[1], row[2], row[3], row[4], row[5]});",
         "    const long long i = tile_ids[j];\n"
         "    b.put(s, {g_m2d[2 * i], g_m2d[2 * i + 1], g_con[3 * i], g_con[3 * i + 1], "
         "g_con[3 * i + 2], g_op[i]});"),
        (K4, "b.col[c * b.nthr + s] = row[6 + c];", "b.col[c * b.nthr + s] = g_col[D * i + c];")],
}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def prepare():
    """The main path's predictions -> INFER_DIR (for the training tables)
    and its splats and 4 cameras -> SCENE."""
    import numpy as np
    import torch

    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.infer import PRESETS, export, run
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig

    imgs = np.random.default_rng(0).uniform(size=(1, 4, W, H, 3)).astype(np.float32)
    preds = run(imgs, WorldMirrorConfig(**PRESETS["large"]),
                camera_params=chip_smoke.fixed_cameras(4))
    torch.cuda.synchronize()
    export(preds, imgs, INFER_DIR)
    np.save(INFER_DIR / "images.npy", imgs[0])
    torch.save(chip_smoke.main_path_scene(preds)[:7], SCENE)


def takes_order(source: str, entry: str) -> bool:
    """Whether a source's C entry `entry` takes a tile order."""
    decl = re.search(rf'extern "C" int {entry}\((.*?)\)', source, re.S)
    return "order" in decl.group(1)


def build(builds):
    """{name: (csrc dir, source file, [(file, old, new), ...])} -> {name:
    (the loaded library, the source's text, ptxas report)}; every nvcc at
    once."""
    from hunyuanworld_mirror_tpu_torch.ops import _build
    procs = {}
    for i, (name, (csrc, source, subs)) in enumerate(builds.items()):
        src_dir = OUT_DIR / f"src_{i}"
        src_dir.mkdir(parents=True, exist_ok=True)
        texts = {f.name: f.read_text() for f in Path(csrc).glob("raster*")}
        for file, old, new in subs:
            if texts[file].count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in {file}")
            texts[file] = texts[file].replace(old, new)
        for file, text in texts.items():
            (src_dir / file).write_text(text)
        lib = OUT_DIR / f"libk4_ab_{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src_dir / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            texts[source])
    libs = {}
    for name, (proc, lib, text) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        libs[name] = (ctypes.CDLL(str(lib)), text, report)
    return libs


def k4_entry(lib, text):
    """The K4 C entry -> (fn, it takes an order, it takes the splats'
    arrays and packs its own table)."""
    order = takes_order(text, "rasterize_binned_fwd")
    arrays = "const void* means2d" in re.search(
        r'extern "C" int rasterize_binned_fwd\((.*?)\)', text, re.S).group(1)
    fn = lib.rasterize_binned_fwd
    head = [_P] * 4 + [_I] + [_P] * 6 if arrays else [_P] * (6 if order else 5)
    fn.argtypes = head + [_I] * 7 + [_P]
    fn.restype = ctypes.c_int
    return fn, order, arrays


def tables():
    """{set label: [(m2d, con, col, op, bins), ...] for the 4 cameras}."""
    import torch

    import chip_smoke
    from hunyuanworld_mirror_tpu_torch import splat_trainer
    from hunyuanworld_mirror_tpu_torch.ops import projection, rasterizer, tiles

    means, quats, scales, opac, sh, w2c, Ks = torch.load(SCENE)
    covars = projection.quat_scale_to_covar_planes(quats, scales)
    mpt = rasterizer._capped(chip_smoke.RENDER_MPT, means.shape[0], chip_smoke.RENDER_TPG)
    fwd = []
    for c in range(w2c.shape[0]):
        m2d, con, col, rad, dep = rasterizer.project_camera(
            means, covars, opac, sh, w2c[c], Ks[c], W, H)
        bins = tiles.bin_gaussians(m2d, rad, dep, TILE, 33, 33, chip_smoke.RENDER_TPG,
                                   mpt, conic_test=tiles.conic_test_planes(con, opac))
        fwd.append((m2d, con, col, opac, bins))
    inputs = splat_trainer.load_infer_dir(str(INFER_DIR), str(INFER_DIR / "images.npy"),
                                          W, lambda *a: None)
    return {"--rasterizer jax forward": fwd,
            "training step": chip_smoke.jax_route_bins(inputs, 4096)}


def flat_lists():
    """The main path's per-camera f32 lists and its camera-batched list."""
    import torch

    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer

    means, quats, scales, opac, sh, w2c, Ks = torch.load(SCENE)
    per_camera = [rasterizer.bin_camera(means, quats, scales, opac, sh, w2c[c], Ks[c],
                                        W, H, TILE, chip_smoke.RENDER_MPT,
                                        chip_smoke.RENDER_TPG, False)
                  for c in range(w2c.shape[0])]
    multi, _ = rasterizer.bin_cameras(means, quats, scales, opac, sh, w2c, Ks, W, H,
                                      TILE, chip_smoke.RENDER_MPT, chip_smoke.RENDER_TPG)
    return per_camera, multi


def check_flat(libs, stream):
    """K2 and K2m of this tree against the parent's, bit for bit -> {entry:
    [differing elements of img, alpha] or []}."""
    import torch

    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    per_camera, multi = flat_lists()
    out, d = {}, 4
    for entry, lists, n_cams in (("rasterize_flat_fwd", per_camera, 1),
                                 ("rasterize_flat_multi_fwd", [multi], 4)):
        differ = []
        for bins in lists:
            got = []
            for name in ("K2 parent", "K2 this tree"):
                fn = getattr(libs[name][0], entry)
                img, alpha, _, _ = R.forward_outputs((n_cams,), H, W, d, "cuda")
                order = torch.empty(bins.counts.shape, dtype=torch.int64, device="cuda")
                if entry == "rasterize_flat_fwd":
                    fn.argtypes = [_P] * 8 + [_I] * 6 + [_LL, _I, _P]
                    args = [None, None, W, H, TILE, 33, 33 * 33, d, bins.packed.shape[1], 0]
                else:
                    fn.argtypes = [_P] * 6 + [_I] * 7 + [_LL, _P]
                    args = [W, H, TILE, 33, 33 * 33, n_cams, d, bins.packed.shape[1]]
                fn.restype = ctypes.c_int
                rc = fn(bins.packed.data_ptr(), bins.starts.data_ptr(),
                        bins.counts.data_ptr(), order.data_ptr(), img.data_ptr(),
                        alpha.data_ptr(), *args, stream)
                if rc:
                    raise RuntimeError(f"{name} {entry}: CUDA error {rc}")
                torch.cuda.synchronize()
                got.append((img, alpha))
            if not all(torch.equal(a, b) for a, b in zip(*got)):
                differ.append([int((a != b).sum()) for a, b in zip(*got)])
        out[entry] = differ
        print(f"{entry}: this tree against the parent on {len(lists)} list(s): "
              f"{'bit for bit' if not differ else differ}", flush=True)
    return out


def main_measure(parent: str, variants: bool):
    import torch

    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.ops import _build
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as B
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R

    t0 = time.time()
    pcsrc = Path(parent) / "hunyuanworld_mirror_tpu_torch" / "csrc"
    builds = {"parent": (pcsrc, K4, []), "this tree": (_build.CSRC, K4, [])}
    if variants:
        for name, subs in VARIANTS.items():
            builds[name] = (_build.CSRC, K4, subs)
    builds["K2 parent"] = (pcsrc, "rasterize_flat_fwd.cu", [])
    builds["K2 this tree"] = (_build.CSRC, "rasterize_flat_fwd.cu", [])
    libs = build(builds)
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    flat_differ = check_flat(libs, stream)
    k4 = {name: (*k4_entry(lib, text), report) for name, (lib, text, report) in libs.items()
          if not name.startswith("K2 ")}
    sets = tables()

    # each set's tables, built once: a build whose C entry takes no arrays
    # and "rows from splat_table" read them; the others pack their own into
    # a scratch (rows of up to 16 floats)
    layouts = {label: [(B.splat_table(m2d, con, col, op), bins)
                       for m2d, con, col, op, bins in cams]
               for label, cams in sets.items()}
    arrays = {label: [[x.float().contiguous() for x in (m2d, con, op, col)]
                      for m2d, con, col, op, _ in cams] for label, cams in sets.items()}
    scratch_tables = {label: [torch.empty(c[0].shape[0], 16, device="cuda")
                              for c in cams] for label, cams in sets.items()}

    def call(name, label, i, img, alpha, order):
        fn, takes, packs, _ = k4[name]
        table, bins = layouts[label][i]
        if not packs:
            args = [table.data_ptr()]
        else:
            m2d, con, op, col = arrays[label][i]
            if name != "rows from splat_table":
                table = scratch_tables[label][i]
            args = [m2d.data_ptr(), con.data_ptr(), op.data_ptr(), col.data_ptr(),
                    m2d.shape[0], table.data_ptr()]
        args += [bins.gauss_ids.data_ptr(), bins.counts.data_ptr()]
        if takes:
            args.append(order.data_ptr())
        rc = fn(*args, img.data_ptr(), alpha.data_ptr(), W, H, TILE, 33, 33 * 33, 4,
                bins.gauss_ids.shape[1], stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    out = dict(sets={}, flat_differ_from_parent=flat_differ)
    scratch = {label: [(*R.forward_outputs((), H, W, 4, "cuda")[:2],
                        torch.empty(b.counts.shape, dtype=torch.int64, device="cuda"))
                       for _, b in cams] for label, cams in layouts.items()}
    for label, cams in layouts.items():
        differ = {}
        for i, (img, alpha, order) in enumerate(scratch[label]):
            ref = None
            for name in k4:
                call(name, label, i, img, alpha, order)
                torch.cuda.synchronize()
                got = (img.clone(), alpha.clone())
                if ref is None:
                    ref = got
                elif not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    differ[name] = [int((a != b).sum()) for a, b in zip(got, ref)]
        out["sets"][label] = dict(entries=sum(int(b.counts.sum()) for _, b in cams),
                                  differ_from_parent=differ)
        print(f"{label}: {out['sets'][label]}", flush=True)

    # alternating rounds: each build's C entry, then the wrappers' tables
    tables_fn = {"table: splat_table (plain)": lambda c: B.splat_table(*c[:4])}
    times = {(key, label): [] for key in [*k4, *tables_fn] for label in layouts}
    keys = [*k4, *tables_fn]
    for r in range(ROUNDS):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            for label, cams in layouts.items():
                total = 0.0
                for i, (img, alpha, order) in enumerate(scratch[label]):
                    if key in tables_fn:
                        c = sets[label][i]
                        total += chip_smoke.cuda_ms(lambda: tables_fn[key](c), reps=5,
                                                    warmup=1)
                        continue
                    total += chip_smoke.cuda_ms(
                        lambda: call(key, label, i, img, alpha, order), reps=5, warmup=1)
                times[(key, label)].append(total)
    res = {}
    for key in keys:
        res[key] = {label: times[(key, label)] for label in layouts}
    regs = {}
    for name, (_, _, _, report) in k4.items():
        regs[name] = dict(
            registers=[int(n) for n in re.findall(r"Used (\d+) registers", report)],
            spill_bytes=sum(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", report)),
            stack_bytes=sum(int(n) for n in re.findall(r"(\d+) bytes stack frame", report)))
    print(json.dumps(dict(out, ms=res, builds=regs)), flush=True)
    for name, r in regs.items():
        print(f"{name}: registers {r['registers']}, spills {r['spill_bytes']} B, stack "
              f"{r['stack_bytes']} B", flush=True)
    for key in keys:
        for label in layouts:
            ts = times[(key, label)]
            print(f"  {key:52s} {label:26s} median {statistics.median(ts):.4f} ms  "
                  "rounds " + " ".join(f"{x:.4f}" for x in ts), flush=True)
    bad = {label: s["differ_from_parent"] for label, s in out["sets"].items()
           if s["differ_from_parent"]}
    bad.update({k: v for k, v in flat_differ.items() if v})
    if bad:
        raise AssertionError(f"outputs differ from the parent build's: {bad}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("k4_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if not sys.argv[1:] or sys.argv[1].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    INFER_DIR.mkdir(parents=True, exist_ok=True)
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
