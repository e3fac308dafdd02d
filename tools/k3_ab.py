"""K3, the rasterizer backward, on the training cell's own lists, one NVIDIA
GPU: trees side by side, or the kernel's design constants, in one call.

    python3 tools/k3_ab.py [TREE ...]        (default: this checkout)
    python3 tools/k3_ab.py --variants
    python3 tools/k3_ab.py --profile

First one process runs the main path of `chip_smoke.py` (the `large`
preset, S=4, 518 px, random weights, fixed cameras) and exports it with
`infer.export` into build/k3_ab/. Then a process of its own per TREE (a
checkout root: this one, or a parent unpacked with `git archive` into a
directory `.gitignore` lists) imports that tree's package, builds its
kernels into that tree's build/, runs `optimize_splats` for 30 steps as
phase 8 of `chip_smoke.py` does (refines at 19 and 29) and prints one JSON
line:

  * the median render forward / backward / optimizer ms over the 28 steps
    without a refine (CUDA events), of each of TRAIN_RUNS runs and over
    them, the host's wall time inside `loss.backward()` (the time to
    enqueue the backward), the peak memory, the first and last loss;
  * on the lists of two slot states (the input of step 10, the slots after
    the refine at step 29), totals over the 4 cameras (one training step's
    K3 launches): K3 through its wrapper (`rasterize_flat_bwd` as
    `RasterizeFlat.backward` calls it), through its C entry alone (and,
    where the C entry takes a tile order, with the blocks taking the tiles
    by falling count), and the wrapper's other work (the zeroing and the
    `index_add_` of a tree whose kernel writes per-entry rows); each
    tile's walk (its pixels' largest last-kept index + 1): mean, p99 and
    max over the tiles, against the tile's count; the kept share of the
    (pixel, entry) pairs the walks test;
  * K3's ptxas report and the blocks an SM holds (65,536 registers and
    228 KB an SM, a warp's registers in units of 256, 1 KB reserved a
    block).

With --variants, the process builds csrc/rasterize_flat_bwd.cu once as it is
and once per entry of VARIANTS (design constants of the source changed), and times
each build's C entry on the 4 lists after the refine at 29 in alternating
rounds, each held against the build as it is (K3_REL_BAND of
chip_smoke.py) unless it is marked as a timing probe (a variant that drops
work, to show what that work costs).

With --profile, the process runs torch.profiler over PROFILE_STEPS training
steps without a refine and prints their wall time, the kernels' summed
device time, the device's idle share and the ops with the most host time.

The card's name and power limit come first. Times are CUDA-event times
after a warm-up. Run trees in turns (parent, change, change, parent) to
compare them on one card. Nothing here runs without a card.
"""

import ctypes
import inspect
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INFER_DIR = ROOT / "build" / "k3_ab"
W = H = 518
D = 4
# name -> ([(the source's text, its replacement), ...], a timing probe?)
VARIANTS = {
    "as built": ([], False),
    "no bounding-box skip": ([("constexpr bool BBOX = true;",
                               "constexpr bool BBOX = false;")], False),
    "split 1 (a tile a block)": ([("constexpr int SPLIT = 4;", "constexpr int SPLIT = 1;")],
                                 False),
    "split 2": ([("constexpr int SPLIT = 4;", "constexpr int SPLIT = 2;")], False),
    "warps of 16 x 2 pixels": ([("constexpr int WARP_W = 8;", "constexpr int WARP_W = 16;")],
                               False),
    "batch 32": ([("constexpr int BATCH = 64;", "constexpr int BATCH = 32;")], False),
    "batch 128": ([("constexpr int BATCH = 64;", "constexpr int BATCH = 128;")], False),
    "probe: no butterfly": ([("        butterfly16(v, lane);\n", "")], True),
    "probe: no kept pair": ([("if (raw >= ALPHA_THRESHOLD) {", "if (raw >= 2.f) {")], True),
}
ROUNDS = 5
# 30-step training runs per tree: the step's phases are medians over each
# run's 28 refine-free steps, then over the runs
TRAIN_RUNS = 3
# training steps under torch.profiler (--profile)
PROFILE_STEPS = 5


def prepare():
    """The main path's predictions -> INFER_DIR (gaussians.ply, cameras,
    depths) and INFER_DIR/images.npy."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.infer import PRESETS, export, run
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig

    imgs = np.random.default_rng(0).uniform(size=(1, 4, W, H, 3)).astype(np.float32)
    preds = run(imgs, WorldMirrorConfig(**PRESETS["large"]),
                camera_params=chip_smoke.fixed_cameras(4))
    torch.cuda.synchronize()
    export(preds, imgs, INFER_DIR)
    np.save(INFER_DIR / "images.npy", imgs[0])


def blocks_per_sm(report: str, threads: int, smem: int):
    """(registers a thread, blocks an SM holds) from a ptxas report (its
    largest register count)."""
    regs = max(int(n) for n in re.findall(r"Used (\d+) registers", report))
    by_regs = 65536 // (math.ceil(regs * 32 / 256) * 256 * (threads // 32))
    by_smem = (228 * 1024) // (smem + 1024)
    return regs, min(32, 2048 // threads, by_regs, by_smem)


def train(tree: str):
    """30 steps of phase 8 in `tree` -> (summary dict, {label: a function
    yielding that slot state's 4 lists as (bins, t_final, last, v_img,
    v_alpha)}, the tree's rasterizer_flat module, n_gauss)."""
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    from hunyuanworld_mirror_tpu_torch import splat_trainer
    from hunyuanworld_mirror_tpu_torch.ops import _build, rasterizer
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils

    assert Path(R.__file__).resolve().is_relative_to(Path(tree).resolve())
    _build.build(["rasterize_flat_fwd", "rasterize_flat_bwd"])
    splats, gt, c2w, Ks, depths = splat_trainer.load_infer_dir(
        str(INFER_DIR), str(INFER_DIR / "images.npy"), W, lambda *a: None)
    cfg = splat_opt.SplatOptConfig(iters=30, refine_start=10, refine_every=10,
                                   refine_stop=30)
    snap_at = {9: "step 10", 29: "after refine 29"}
    snaps, steps = {}, []

    def on_step(info):
        m = info["marks"]
        steps.append((float(info["loss"]), info["refined"],
                      {name: m[j - 1][1].elapsed_time(ev)
                       for j, (name, ev) in enumerate(m) if j}))
        if info["it"] in snap_at:
            with torch.no_grad():
                snaps[snap_at[info["it"]]] = [
                    x.detach().clone() for x in splat_opt._activate(info["raw"])]

    # the host's time inside loss.backward(): the backward's kernels enqueued
    host_ms, backward = [], torch.autograd.backward

    def timed_backward(*a, **k):
        t0 = time.perf_counter()
        backward(*a, **k)
        host_ms.append((time.perf_counter() - t0) * 1e3)

    torch.autograd.backward = timed_backward
    runs = []
    for _ in range(TRAIN_RUNS):
        host_ms.clear()
        steps.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        splat_opt.optimize_splats(splats, gt, c2w, Ks, cfg, depths=depths,
                                  device="cuda", log_fn=lambda *a: None,
                                  on_step=on_step)
        torch.cuda.synchronize()
        plain = [ph for _, refined, ph in steps if not refined]
        runs.append(dict(losses=[steps[0][0], steps[-1][0]],
                         host_backward_ms=float(np.median(
                             [h for h, (_, refined, _) in zip(host_ms, steps) if not refined])),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         step_ms={k: float(np.median([p[k] for p in plain]))
                                  for k in ("render_forward", "backward", "optimizer")}))
    torch.autograd.backward = backward
    out = dict(tree=tree, runs=runs, losses=runs[0]["losses"],
               host_backward_ms=float(np.median([r["host_backward_ms"] for r in runs])),
               peak_gb=max(r["peak_gb"] for r in runs),
               step_ms={k: float(np.median([r["step_ms"][k] for r in runs]))
                        for k in runs[0]["step_ms"]})

    w2c = cam_utils.se3_inverse(torch.as_tensor(c2w, device="cuda"))
    Ks_t = torch.as_tensor(Ks, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)

    def lists(means, quats, scales, opac, sh):
        for c in range(4):
            bins = rasterizer.bin_camera(means, quats[:, [1, 2, 3, 0]], scales, opac,
                                         sh, w2c[c], Ks_t[c], W, H, 16,
                                         cfg.max_per_tile, 9, False, with_ids=True)
            _, _, t_fin, last = R.rasterize_flat(
                bins.packed, bins.starts, bins.counts, W, H, 16, D, False,
                with_state=True)
            yield (bins, t_fin, last, torch.randn(H, W, D, generator=gen, device="cuda"),
                   torch.randn(H, W, 1, generator=gen, device="cuda"))

    n_gauss = snaps["step 10"][0].shape[0]
    return out, {k: (lambda v=v: lists(*v)) for k, v in snaps.items()}, R, n_gauss


def c_entry(R, lst, n, longest_first=False):
    """A closure that launches the tree's K3 C entry alone on outputs
    allocated once; with `longest_first` (a C entry that takes a tile
    order) its blocks take the tiles by falling count."""
    import torch
    bins, t_fin, last, v_img, v_alpha = lst
    M, dev = bins.packed.shape[1], bins.packed.device
    if "with_entries" not in inspect.signature(R.rasterize_flat_bwd).parameters:
        entry = torch.empty(8 + D, M, device=dev)
        return lambda: R.launch("rasterize_flat_bwd", "rasterize_flat_bwd",
                                R._BWD_ARGS, dev, bins.packed.data_ptr(),
                                bins.starts.data_ptr(), bins.counts.data_ptr(),
                                v_img.data_ptr(), v_alpha.data_ptr(), t_fin.data_ptr(),
                                last.data_ptr(), entry.data_ptr(), W, H, 16, 33,
                                33 * 33, D, M)
    splat = torch.zeros(n, R.splat_cols(D), device=dev)
    order = R.longest_first(bins.counts) if longest_first else None
    return lambda: R.rasterize_flat_bwd_launch(
        bins.packed, bins.starts, bins.counts, bins.gauss_ids, v_img, v_alpha, t_fin,
        last, splat, None, W, H, 16, D, order)


def measure(tree: str):
    import torch

    out, snaps, R, n = train(tree)
    sys.path.insert(0, tree)
    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.ops import _build

    new_layout = "with_entries" in inspect.signature(R.rasterize_flat_bwd).parameters
    out["lists"] = {}
    for label, lists in snaps.items():
        tot = dict(wrapper_ms=0.0, entry_ms=0.0)
        walks, counts, kept, tested, warp_kept, warp_walked = [], [], 0, 0, 0, 0
        for lst in lists():
            bins, t_fin, last, v_img, v_alpha = lst
            args = (bins.packed, bins.starts, bins.counts, bins.gauss_ids, n, v_img,
                    v_alpha, t_fin, last, W, H, 16, D)
            kw = {"with_entries": False} if new_layout else {}
            tot["wrapper_ms"] += chip_smoke.cuda_ms(
                lambda: R.rasterize_flat_bwd(*args, **kw), reps=5, warmup=1)
            tot["entry_ms"] += chip_smoke.cuda_ms(c_entry(R, lst, n), reps=5, warmup=1)
            if new_layout:
                tot["entry_longest_first_ms"] = tot.get("entry_longest_first_ms", 0.0) + \
                    chip_smoke.cuda_ms(c_entry(R, lst, n, longest_first=True), reps=5,
                                       warmup=1)
            else:
                rows, M = 8 + D, bins.packed.shape[1]
                entry = torch.zeros(rows, M, device="cuda")
                splat = torch.zeros(rows, n, device="cuda")
                tot["zeros_ms"] = tot.get("zeros_ms", 0.0) + chip_smoke.cuda_ms(
                    lambda: torch.zeros(rows, M, device="cuda"), reps=5, warmup=1)
                tot["scatter_ms"] = tot.get("scatter_ms", 0.0) + chip_smoke.cuda_ms(
                    lambda: splat.index_add_(1, bins.gauss_ids, entry), reps=5,
                    warmup=1)
                del entry, splat
            lp = torch.nn.functional.pad(last, (0, 33 * 16 - W, 0, 33 * 16 - H),
                                         value=-1)
            lp = lp.reshape(33, 16, 33, 16).transpose(1, 2).reshape(33 * 33, 256)
            walks.append(lp.amax(1) + 1)
            counts.append(bins.counts.long())
            pairs = chip_smoke.blend_pairs(bins.packed, bins.starts, bins.counts, W, H,
                                           16, D, False)
            kept += pairs["kept"]
            tested += pairs["backward"]
            warp_kept += pairs.get("warp_kept", 0)
            warp_walked += pairs.get("warp_walked", 0)
            del bins, t_fin, last, lst
            torch.cuda.empty_cache()
        walk = torch.cat(walks).float()
        count = torch.cat(counts).float()
        out["lists"][label] = dict(
            tot, walk_mean=float(walk.mean()),
            walk_p99=float(torch.quantile(walk, 0.99)), walk_max=float(walk.max()),
            count_mean=float(count.mean()), count_max=float(count.max()),
            tiles_walked=int((walk > 0).sum()), pairs_tested=tested,
            pairs_kept=kept, kept_share=kept / max(tested, 1), warp_walked=warp_walked,
            warp_kept=warp_kept, warp_kept_share=warp_kept / max(warp_walked, 1))
    report = (_build.BUILD_DIR / "rasterize_flat_bwd.ptxas.txt").read_text()
    out["ptxas"] = [ln.strip() for ln in report.splitlines()
                    if "Used" in ln or "spill" in ln or "stack" in ln]
    if new_layout:
        lib = _build.load("rasterize_flat_bwd")
        threads, smem = lib.rasterize_flat_bwd_threads(16), lib.rasterize_flat_bwd_smem(16, D)
    else:
        threads, smem = 256, (6 + D + 8 + D) * 256 * 4
    out["regs"], out["blocks_per_sm"] = blocks_per_sm(report, threads, smem)
    out["threads"], out["smem_bytes"] = threads, smem
    print(json.dumps(out), flush=True)


def build_variants(_build):
    """Compile every variant at once -> {name: (library, ptxas report)}."""
    out_dir = INFER_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "rasterize_flat_bwd.cu").read_text()
    procs = {}
    for i, (name, sub) in enumerate(VARIANTS.items()):
        text = src
        for old, new in sub[0]:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is no longer in the source")
            text = text.replace(old, new)
        path = out_dir / f"k3_{i}.cu"
        path.write_text(text)
        lib = out_dir / f"libk3_{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        libs[name] = (ctypes.CDLL(str(lib)), report)
    return libs


def measure_variants():
    import torch

    out, snaps, R, n = train(str(ROOT))
    import chip_smoke
    from hunyuanworld_mirror_tpu_torch.ops import _build

    libs = build_variants(_build)
    lists = list(snaps["after refine 29"]())
    runs = {}
    for name, (lib, report) in libs.items():
        fn = lib.rasterize_flat_bwd
        fn.argtypes = list(R._BWD_ARGS) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(bins, t_fin, last, v_img, v_alpha, splat, fn=fn, name=name, order=None):
            rc = fn(bins.packed.data_ptr(), bins.starts.data_ptr(), bins.counts.data_ptr(),
                    bins.gauss_ids.data_ptr(), v_img.data_ptr(), v_alpha.data_ptr(),
                    t_fin.data_ptr(), last.data_ptr(),
                    None if order is None else order.data_ptr(), splat.data_ptr(), None,
                    W, H, 16, 33, 33 * 33, D, bins.packed.shape[1],
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        outs = [torch.zeros(n, R.splat_cols(D), device="cuda") for _ in lists]
        for lst, splat in zip(lists, outs):
            run(*lst, splat)
        torch.cuda.synchronize()
        threads, smem = lib.rasterize_flat_bwd_threads(16), lib.rasterize_flat_bwd_smem(16, D)
        runs[name] = dict(run=run, outs=outs, threads=threads, smem=smem,
                          regs_blocks_per_sm=blocks_per_sm(report, threads, smem),
                          spill_bytes=sum(int(x) for x in re.findall(
                              r"(\d+) bytes spill (?:stores|loads)", report)))
    ref = runs["as built"]["outs"]
    for name, r in runs.items():
        err = max(float(((a - b).abs().amax(0) / b.abs().amax(0).clamp_min(1e-30)).max())
                  for a, b in zip(r.pop("outs"), ref))
        r["rel_err"] = err
        probe = VARIANTS[name][1]
        if not probe and not err <= chip_smoke.K3_REL_BAND:
            raise AssertionError(f"{name}: rows differ from the build as it is by {err}")
    orders = [R.longest_first(lst[0].counts) for lst in lists]
    scratch = [torch.zeros(n, R.splat_cols(D), device="cuda") for _ in lists]
    for _ in range(ROUNDS):
        for r in runs.values():
            for key, ords in (("ms", [None] * len(lists)), ("ms_longest_first", orders)):
                r.setdefault(key, []).append(sum(
                    chip_smoke.cuda_ms(lambda: r["run"](*lst, s, order=o), reps=3,
                                       warmup=1)
                    for lst, s, o in zip(lists, scratch, ords)))
    res = {name: dict(ms_median=statistics.median(r["ms"]),
                      ms_longest_first_median=statistics.median(r["ms_longest_first"]),
                      regs_blocks_per_sm=r["regs_blocks_per_sm"], threads=r["threads"],
                      smem=r["smem"], rel_err=r["rel_err"], spill_bytes=r["spill_bytes"])
           for name, r in runs.items()}
    print(json.dumps(dict(out, variants=res)), flush=True)
    for name, r in res.items():
        print(f"{name:28s} {r['ms_median']:.4f} ms  longest first "
              f"{r['ms_longest_first_median']:.4f} ms  (registers, blocks an SM) "
              f"{r['regs_blocks_per_sm']}  threads {r['threads']}  smem {r['smem']}  "
              f"spills {r['spill_bytes']} B  rel err {r['rel_err']:.2e}", flush=True)


def measure_profile():
    """torch.profiler over PROFILE_STEPS refine-free training steps of this
    tree after its 30-step runs: the steps' wall time (CUDA events), the
    kernels' summed device time in that window and so the device's idle
    share, and the ops with the most host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out, _, _, _ = train(str(ROOT))
    from hunyuanworld_mirror_tpu_torch import splat_trainer
    from hunyuanworld_mirror_tpu_torch.training import splat_opt

    splats, gt, c2w, Ks, depths = splat_trainer.load_infer_dir(
        str(INFER_DIR), str(INFER_DIR / "images.npy"), W, lambda *a: None)
    cfg = splat_opt.SplatOptConfig(iters=PROFILE_STEPS, refine_start=10**6)
    ms = []
    on_step = lambda info: ms.append(sum(info["marks"][j - 1][1].elapsed_time(ev)
                                         for j, (_, ev) in enumerate(info["marks"]) if j))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        splat_opt.optimize_splats(splats, gt, c2w, Ks, cfg, depths=depths,
                                  device="cuda", log_fn=lambda *a: None,
                                  on_step=on_step)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    device_ms = sum(e.device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    steps_ms = sum(ms)
    top = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    print(json.dumps(dict(
        out, profile=dict(steps=PROFILE_STEPS, steps_ms=steps_ms, device_ms=device_ms,
                          device_idle_share=1 - device_ms / steps_ms,
                          host_top=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                                    for e in top]))), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    INFER_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    subprocess.run([sys.executable, __file__, "--prepare"], check=True)
    print(f"prepare: {time.time() - t0:.1f} s", flush=True)
    if sys.argv[1:] in (["--variants"], ["--profile"]):
        subprocess.run([sys.executable, __file__, "--measure-" + sys.argv[1][2:]],
                       check=True)
        return 0
    for tree in sys.argv[1:] or [str(ROOT)]:
        t0 = time.time()
        subprocess.run([sys.executable, __file__, "--measure",
                        str(Path(tree).resolve())], check=True)
        print(f"{tree}: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--prepare"]:
        prepare()
    elif sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2])
    elif sys.argv[1:2] == ["--measure-variants"]:
        measure_variants()
    elif sys.argv[1:2] == ["--measure-profile"]:
        measure_profile()
    else:
        sys.exit(main())
