"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the four CUDA sources (csrc/*.cu) compiled from this checkout,
     the nvcc processes started together;
  3. K1 (attention_fwd) against its plain version: the ptxas report (no
     C7508, no spills); the main path's shapes, timed (kernel, plain, SDPA,
     bound); the ragged and tile-edge N (37, 127, 129, 130, 193, 4097), D = 128 bf16, the encoder's
     q/k/v as views of one fused qkv, the trunk's q/k (LayerNorm, RoPE) and
     strided v, and 3 batches whose middle one has 100x keys and values,
     each batch held to its own band; then K1c, the f32 route (the camera
     head, (1, N, 16, 128) at N = S views), at N = 1, 4, 5, 32, 97, 130,
     on q, k, v views of one fused qkv and on inputs 4 bytes off 16-byte
     alignment, timed at N = 4 (the main path) and N = 32: device time
     under torch.profiler, per-call wall time of a back-to-back loop, both
     for SDPA too, and the bound;
  4. K2 (rasterize_flat_fwd): its ptxas report (fails on a stack frame or a
     spill) and the blocks an SM holds; then K2 against its plain version on
     a synthetic 518 px scene of ~500k splats, f32 and f16-pair payloads,
     with the share of (warp, entry) steps its warps cull and the pairs it
     still tests;
  5. the main path through the CLI's `run(...)`: the `large` preset (ViT-L
     trunk, width 1024, 24 + 24 blocks, all five heads, the Gaussian render)
     at B=1, S=4, 518 px, random weights from a seed, fixed cameras: one
     `run` with the kernels' launch counts (88 attention launches, 24 of
     them at N >= 4096, and 4 rasterizer launches) and the peak memory;
     then one model from `load_model`, one warm-up and 7 timed forwards
     through `reconstruct`, with the per-phase
     time; then, on the same model, one forward of 4 landscape images at
     518 x 392 (the CLI's crop of a 4:3 photo: a 28 x 37 patch grid, 825
     tiles): finite outputs, the same launch counts, and K2 against its
     plain version on its 4 lists; then, on the same model, the prior path:
     one forward with all three priors, cond (1, 1, 1) (the fixed cameras
     as 4 x 4 camera-to-world poses and their K, the no-prior forward's
     depth as the depth map): finite outputs, the same launch counts,
     outputs that differ from the no-prior forward's, K2 against its plain
     version on its 4 lists, and 7 timed forwards split into phases (a
     `priors` phase before `encoder`) with the peak memory; then K2 against
     its plain version on the main path's own intersection lists;
  6. the port on the card against the same port on the CPU (plain versions)
     for a small configuration whose heads are 64 wide: the default path,
     the prior path (cond 1, 1, 1), `gs_position_from="gsdepth+gtcamera"`,
     `head_dtype="bfloat16"` and `head_chunk=1`;
  7. K3 (rasterize_flat_bwd): its ptxas report (fails on a stack frame or
     a spill) and the blocks an SM holds; then K3 against its plain
     version, per-splat rows with and without the per-entry rows and the
     per-entry rows themselves, with cotangents drawn from a seeded
     generator, on the synthetic scene of phase 4 (f32 payload, 9 tiles
     per splat) and on the lists of the main path's splats for its 4
     cameras (f32 payload, 9 tiles per splat, 4096 per tile), its wrapper
     and its C entry timed, and each list's walks (a tile's largest
     last-kept index + 1: mean, p99, max); K2's two training planes (final
     T, last kept entry) are held against the plain version there too;
  8. the training path at full size: phase 5's predictions written by
     `infer.export`, the trainer twin's `run()` for 2 iterations on that
     directory, then `optimize_splats` on the same splats, images and
     cameras for 30 iterations with refines at steps 19 and 29: every loss
     finite, the last below the first, 4 K2 and 4 K3 launches per step, the
     slot count unchanged across the refines; the median step time split by
     CUDA events into render forward, backward, optimizer and refine, the
     peak memory, the live splats after each refine and n_dropped per camera;
     then K3 (and K2's planes) against the plain version on the training
     step's own 4 lists, binned from two slot states: the input of step 10
     and the slots after the refine at step 29;
  9. K2m (rasterize_flat_multi_fwd): `rasterize(camera_batch=True)` on
     phase 5's 537,088 splats and 4 cameras at 518 px with the render's caps
     (4096 per tile, 4 tiles per splat): one sort of all cameras' slots, 1
     K2m and 0 K2 launches; K2m against its plain version on that list; the
     render against the per-camera route at the f32 payload (max, median
     and share of pixels with |d| > 1e-3: the camera-batched key keeps 18
     depth bits, not 20); the kernel, its plain version, the whole route
     and the per-camera route timed;
 10. K5 (`rasterize_flat_grouped`: K2's entry in rasterize_flat_fwd.cu on
     the window-clamped segments, one block a tile, longest first): the
     per-camera inference route (f16 payload) with WM_RASTER_GROUP at 16, 8
     and 4: 4 K5 and 0 K2 launches a call, K5 against its plain version and
     bit for bit against K2 on each camera's clamped list, both timed,
     extra_dropped; then optimize_splats for 3 steps on phase 8's
     inputs with WM_RASTER_GROUP=4 against the same 3 steps with G=1: 4 K5,
     0 K2 and 4 K3 launches a step, the losses within 1e-5 relative,
     n_dropped equal (the window clamp cut nothing, so K3 read the same
     counts K5 blended);
 11. K4 (rasterize_binned_fwd): its ptxas report (fails on a stack frame
     or a spill: the packing kernel, the blend at D = 1..8); then
     `render_local_cameras`, the
     per-rank body of the multi-device render, on phase 5's splats and 4
     cameras with the render's caps (untightened radii, 1089 x 4096 id
     table per camera): 4 K4 launches, K4 against its plain version (the
     JAX package's log-space blend) on each camera's bins, both timed (the
     wrapper's call: the C entry packs the table, sorts the tiles, blends);
 12. the CLI's remaining flags, on one model of phase 5's configuration
     and weights with phase 5's images and cameras (the render's route
     switched on the model's renderer config between forwards): one flat
     forward (88 K1, 4 K2) and 7 timed; (a) rasterizer_impl="jax"
     (--rasterizer jax): one forward with 88 K1, 0 K2 and 4 K4 launches,
     its render against the flat forward's (max, median, share past 1e-3),
     K4 against its plain version on each camera's dense bins (tight radii,
     4096 a tile, 4 tiles a splat), 7 timed forwards; (b) slot_fracs="auto"
     (--fast-binning): one forward with 4 K2, sorted rows a camera against
     the exact binning's, the render against the flat forward's, K2 against
     its plain version on the 4 prefix lists, 7 timed forwards; (c) the
     --video trajectory through the 4 cameras (46 frames, 46 K2 launches),
     every frame finite and lit, ms a frame, K2 against its plain version on
     frame 0's list, then 3 frames with the spread effect (3 K2) and 3 on
     impl="jax" (3 K4), no mp4 written; (d) refine_cameras (--ba) on the flat
     forward's predictions, 12 iterations at stride 16, timed, cost not
     raised, cost0 within 1e-4 relative of the same call on the CPU, then
     the same on a bundle made consistent from that forward (its depth
     with 1% noise unprojected through its cameras), where the cost must
     fall; (e)
     the CLI's main() on a .npy of the images with --glb --glb-mesh
     --mask-sky --ba --ba-iters 4 --fast-binning: 88 K1 and 4 K2 launches,
     every file written, scene.glb a valid glTF header;
 13. the trainer's remaining flags, on phase 8's training inputs (510,964
     splats in 1,021,928 slots, 4 cameras at 518 px, 4096 a tile), each run
     with the (K2, K3, K4) counts set to 0 just before it: first one
     selective-Adam step, every row with an all-zero gradient (K3 never
     touched it, no regulariser) unchanged bit for bit; (a)
     strategy="mcmc" with selective Adam, 30 steps with refines at 19 and
     29: 4 K2 and 4 K3 launches a step, finite losses, the last below the
     first, each refine growing the live count by exactly
     min(floor(0.05 n_alive), free slots), the slots unchanged, the median
     step split into render forward, backward, optimizer, refine and noise
     beside phase 8's; (b) pose_opt, random_bkgd and use_bilateral_grid, 10
     steps: 4 K2 and 4 K3 a step, the camera deltas off zero, the grids'
     gradients non-zero, the median step with the grid's slice as its own
     mark; (c) rasterizer_impl="jax": K4 against its plain version on step
     0's dense bins, 3 steps with 4 K4 and no K2 or K3 a step, step 0's loss
     within 1e-4 relative of phase 8's where neither route drops an
     intersection, the step's time (the backward is the plain blend replayed
     under autograd) and peak memory, its wall time; (d) the trainer CLI's
     main() on a COLMAP directory (infer.export's sparse/ and gaussians.ply,
     the 4 images as PNGs) with --normalize --iters 30 --strategy mcmc
     --selective-adam --pose-opt --random-bkgd --bilateral-grid --test-every
     2 --eval-every 10 --tb --compress --viewer: 2 training views, so 2 K2
     and 2 K3 launches a step, plus 2 K2 for each of the 3 in-loop evals and
     the final eval, gaussians_opt.ply, cameras_opt.npz and
     compressed/meta.json written, eval/psnr read back from the events by
     the port's reader, the live viewer's page, status and snapshot fetched
     just before it closes;
 14. the camera models, render modes and 2DGS, on phase 5's splats and 4
     cameras at 518 px, each run with the (K2, K3, K4) counts set to 0 just
     before it: (a) the pinhole route, then fisheye (k1..k4), OpenCV (radial
     and tangential), f-theta (NVIDIA's published polynomials rescaled to
     the cameras' focal) and a top-to-bottom rolling shutter (end pose 5 cm
     along x), each on the flat route (4 K2) and the dense route (4 K4):
     finite outputs, K2 and K4 against their plain versions on each
     camera's f32 lists of the route, the render's rasterize call timed;
     (b) RGB, D, ED and RGB+D with calc_compensations and radius_clip
     through the per-camera route (4 K2) and camera_batch (1 K2m): K2 on
     camera 0's list and K2m on the batch list against their plain
     versions (colour widths 3, 1, 1, 4); (c) K3 against its plain version
     on the fisheye route's lists (9 tiles a splat, seeded cotangents), and
     one gradient of means and quats through the UT projection (4 K2, then
     4 K3), finite and non-zero; (d) eval3d on the fisheye route (no
     launch), finite, timed; (e) rasterize_to_indices and
     rasterize_to_indices_2dgs: ids in range or -1, weights in [0, 1];
     (f) rasterize_2dgs on the pinhole and fisheye cameras, the trainer
     twin's run(..., gs2d=True) for 2 iterations on phase 5's export, and
     optimize_splats(mode="2dgs") for 10 steps on phase 8's inputs: finite
     losses, the last below the first, no K2, K3 or K4 launch a step, the
     median step split into render forward, backward and optimizer beside
     phase 8's default step, the peak memory;
 15. the CenterSnap 6D-pose trainer (K1 forward, the JAX VJP's einsum
     replay backward): (a) K1 at B=20, N=581, 583 and 1031, H=6 and at
     (4, 1376, 16, 64), bf16: the forward against its plain version, then
     under grad: a grad_fn, one launch forward and none backward, dq / dk
     / dv against autograd through the replay math with seeded
     cotangents, the forward launch timed beside its bound, its plain
     version and SDPA, and the replay timed; (b) the CLI twin's main() at
     every default (B=20, 384 px, no depth) on 200 train and 40 test
     synthetic samples packed by the wds_tools twin with generated
     targets: one epoch (10 steps, a test pass, a checkpoint), then
     --resume for one more (steps 11-20):
     finite losses, 4 K1 launches and 4 replays a step, the checkpoint's
     step, the median step split into forward, backward and optimizer, the
     peak memory; then one step of the same config under torch.profiler:
     device time by kernel family and the idle share; (c)
     CenterSnapConfig's defaults (512 px, depth condition) for 10 steps
     on one in-memory batch of 20: finite, the last loss below the first,
     4 K1 launches a step, median step and peak; (d) --arch res_fpn, the
     same: no K1 launch; (e) patch_embed="dinov3_vits16" at 384 px: one
     step with 16 K1 launches (12 encoder + 4 trunk), every gradient
     finite; (f) a small CenterSnap (width 128, 64 px) on the card against
     the port on the CPU: the loss and each leaf's gradient norm;
 16. evaluation and the demo server (the decoders PIL and cv2 printed
     first): (a) the app twin (`python -m hunyuanworld_mirror_tpu_torch.app
     --preset large --size 518`, its main() serve=False, served on port 0
     in a thread): GET /health; three POST /run of phase 5's 4 views as
     uploaded PNGs, then one with example= (a temporary examples directory
     of the same PNGs, mask_sky and as_mesh), one with video=on and one
     with the model switched to rasterizer_impl="jax", each with the
     counts set to 0 just before it and read after: (K1, K1 at N >= 4096,
     K2, K4) = (88, 24, 4, 0), (88, 24, 50, 0) with the video's 46 frames,
     (88, 24, 0, 4) on the jax route; every file of the run written,
     scene.glb fetched back through /out/ a valid glTF; the first
     request's images equal to prepare_images of the same files and its
     depth to infer.reconstruct's on them; the request's wall time split
     into the images' decode, the forward's elapsed, the PNGs, the GLB, the
     Gaussians' files and the rest (medians of the 3 uploads), beside 7
     forwards of the same model timed by CUDA events, that forward on the
     host clock and its predictions' copy to the host, and the peak
     memory; /viewer; (b)
     accuracy_completeness on phase 5's point map against a copy with
     noise of 1% of its mean radius (65,536 points a side, mean and
     median) on the card and on the CPU beside the f64 answer (the card
     no further from it than 3x the CPU, or 1e-5 relative), timed; LPIPS on random weights over the 4 rendered views against the
     inputs at 518 px, the card against the CPU (1e-5 relative), timed;
     the eval twin's main() in its three modes on files from
     infer.export_maps (points.ply, .npy clouds with --align --median,
     camera npz, PNG directories with $WM_LPIPS_WEIGHTS set): the JAX
     tool's keys, finite;
 17. the multi-device layer on the one card, every rank a process on a gloo
     group whose collectives stage CUDA tensors through host memory (NCCL
     refuses two ranks on one card); the parent built every kernel in
     phase 2, the ranks only load them: (a) phase 5's weights on the
     dense-bin route, sharded at mesh (1,2,1) (2 ranks: ring attention in
     the global layers, the camera head on the gathered tokens, the
     distributed render): per rank one forward of its 2 views with the
     counts set to 0 just before it and read after, (K1a, K1b, K2, K4) =
     (64, 0, 0, 2), the bytes of each collective (and the bytes staged
     through the host), 3 forwards on the host clock between barriers,
     the peak memory; the gathered depth, points, normals, camera head
     prediction and render held against the one-device forward of the
     same weights: the relative L2 of each no more than that of the
     one-device bf16 forward against its f32-trunk forward; (b) the same
     at (1,2,2) (4 ranks, heads and MLP split over 2); (c)
     rasterize_distributed on phase 5's splats and 4 cameras at V = 2 and
     4 against rasterize(impl="jax") on one device (atol 2e-5, rtol 1e-4),
     4 / V K4 launches a rank, and K4 against its plain version on rank
     0's first camera's exchanged lists, timed; (d) the dry-run twin
     (multichip.py) at n = 1, 2 and 4 with its bf16 trunk and with an f32
     one, each loss term printed: with the f32 trunk every rank's loss
     within 1e-4 relative of the n = 1 run's, with bf16 finite (its rounding
     moves the toy's few large splats, and the render term with them); its
     flagship pass at n = 2 (112 px, bf16, one fwd + bwd + AdamW step):
     loss, peak memory a rank, collectives; (e) the twin's main() over NCCL
     at the world size the machine has, f32 trunk, its loss within 1e-4
     relative of the gloo n = 1 run's (printed beside it); (f) BA with the
     landmarks sharded over 2 ranks on phase 12's consistent bundle, in
     f64 its poses within 1e-4 of one-device BA's (in f32, where the
     Schur step's rounding moves the LM path, the difference printed). One-card times measure the
     staging and the ranks sharing one card, not multi-GPU scaling;
 18. the measuring tools: (a) the bench twin's headline row (`python -m
     hunyuanworld_mirror_tpu_torch.bench --row '{"stage": "headline"}'`, its
     own process: large, S=4, 518 px, gs_slot_fracs="auto", the model's own
     cameras): rc 0, every key of bench.HEADLINE_KEYS, value > 0, 0 < mfu
     <= 1.05, e2e_sol_fraction <= 1.05, render_n_dropped >= 0, its line
     logged; (b) K2 (`rasterize`, the flat route) and K4 (impl="jax")
     against the dense oracle `ops/rasterizer_ref.rasterize_reference`,
     which does no binning, on tests/test_rasterizer.py's scene (150 splats,
     2 cameras, 64 x 48, RGB) and on 4096 seeded splats at distinct depths
     in a 128 x 128 camera: nothing dropped, image and alpha within 1e-4,
     max|d| logged per kernel; (c) the heads-profile twin
     (`heads_profile.main`: pts_head whole at f32 and bf16, then its three
     f32 stages); (d) torch.profiler around one main-path forward recorded
     with the program's spans: the trace file written, every span a user
     annotation in it, device time for K1 and K2 in its key_averages(),
     the idle share;
 19. the render and conv tools, each once at --iters 2 on one fixed-camera
     scene (`utils/scenes.render_scene`: large, S=4, 518 px) with the
     rasterizers' counts set to 0 just before: `render_profile` (gs_render
     by stage; D1 -> D2 -> D3 bit for bit D, the camera-batched route
     within phase 9's band of it), `render_sweep` (every card knob),
     `bin_ab` (its pieces composed bit for bit bin_gaussians_packed),
     `sort_ab2` (every permutation bit for bit the shipped one),
     `isect_stats` (ellipse <= tight <= aabb, the render's n_isects <= the
     binning's own count, equal where nothing is dropped) and `conv_ab`
     (every variant within its dtype's band of the f32 output, the cuDNN
     flags restored); K2, K2m, K5 and K4 each launched;
then the script's total wall time, a `kernels` JSON line, the card line,
and as the last line {"ok": true, "device": {...}}. Each phase prints its
wall time.

Times are CUDA-event times after a warm-up. `bound_ms` is the larger of the
bytes the function must move over 3.35 TB/s and its operations over the
card's peak for their type (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32; the
H100 SXM data sheet, `utils/profiling.CHIP_SPECS["h100"]`). K1 has two entries in the `kernels` line, one per
JAX route it replaces: N <= 4095 (the one-pass kernel: encoder, frame
layers, camera head) and N >= 4096 (the flash kernel: global layers). The
rasterizers' work is counted on the plain replay of this run's list
(blend_pairs), for the culled walk the kernels run: every (pixel, entry)
pair the walk tests pays TEST_FLOPS, and the pairs that pass the keep test
pay K2_FLOPS_PER_KEPT or K3_FLOPS_PER_KEPT instead; a pair is tested only
where the entry's keep box reaches the pixel's warp of 8 x 4 pixels (the
forward kernels from the entry that ends the pixel's blend on, K3 past the
pixel's last kept entry, test nothing); each (warp, entry) step of the walk
pays BOX_TEST_FLOPS, and each entry a tile stages KEEP_BOX_FLOPS for its
box. The bytes count the entries a tile stages (up to the one that ends
its last pixel, for K3 its largest last kept one), read once. K3's bytes
are those entries (payload and id), the per-splat grads written once, the cotangents and the T/last
planes read once; the per-entry grads, which the kernel writes only when
asked, are not counted (phase 7 prints the bound with them beside). In the
`kernels` line every number of an
inference kernel (K1, K2) is per forward of the main path: `launches` is
the count from the one `run`, and `ms`, `plain_ms`, `library_ms` and
`bound_ms` are totals over that forward's launches of the kernel, at its
shapes. For the training kernel K3 they are per training step: `launches`
is the count of one step of phase 8, and the times are totals over the 4
training lists of the slots after the refine at step 29. K2m, K5 (G=4) and
K4 are per call of their route over the 4 cameras: `launches` is the
count of that call, the times and bounds totals over its cameras. K4's
bytes are the id table's live slots and one read of each live slot's
splat row, its operations those of the same blend replayed as a flat list.
Phase 12's paths add keys to two entries: K2's `fast_binning_forward`
(per forward over the 4 prefix lists) and `video_frame` (`launches` for the
46-frame trajectory, the times on frame 0's list), K4's
`rasterizer_jax_forward` (per forward of the --rasterizer jax path).
Phase 13's add two more: K3's `mcmc_step` (launches and the median MCMC
step's ms) and K4's `training_step` (the kernel numbers on step 0's 4
dense bins of the --rasterizer jax training path, with the step's median
render forward and plain backward ms). Phase 14's add: K2's and K4's
`ut_routes` (per route, per render of the 4 cameras: the kernel numbers on
the route's f32 lists, the rasterize call's ms beside the pinhole route's,
and the kernel's ms on the pinhole route's f32 lists), K2's and K2m's
`render_modes` (K2 on camera 0's list, K2m on the 4-camera batch list) and
K3's `fisheye_lists` (per step of the 4 fisheye lists). Phase 15's adds
K1's (N <= 4095) `centersnap_step`: per training step of the CLI's
defaults (B=20, 384 px, N=581), the 4 forward launches (`ms`,
`plain_ms`, `library_ms`, `bound_ms` totals), none in the backward, the 4
replays' `replay_ms`, the gradient's max|d| against the replay math, and
the step's median ms. Phase 16's add K1's (both routes) and K2's
`app_request` (the launches of one POST /run of 4 uploaded views, its
median wall `request_ms` and forward `elapsed_ms`) and K4's
`app_request_jax` (the same on the --rasterizer jax route). Phase 17's
add K1's (N <= 4095) `multichip_forward` (rank 0's launches in one
sharded forward at mesh (1,2,1), and at (1,2,2) under `launches_122`;
the kernel numbers totalled over that rank's launches at its shapes; the
median sharded forward on the host clock) and K4's `distributed_render`
(the launches a rank in that forward; the kernel numbers on rank 0's
first camera's exchanged lists at V = 2; the distributed call's median
host-clock time at V = 2 and 4). Phase 18's add K2's and K4's
`oracle_max_abs_err` (max|d| of image and alpha against the dense oracle
over both scenes) and K1's (N <= 4095) and K2's `traced_forward_device_ms`
(their kernels' device time in the traced forward, K1 over every bf16
launch).
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from hunyuanworld_mirror_tpu_torch.utils.profiling import CHIP_SPECS
# the main path's cameras and render caps; tools/k*_ab.py read them from here
from hunyuanworld_mirror_tpu_torch.utils.scenes import (RENDER_MPT, RENDER_TPG,  # noqa: F401
                                                         fixed_cameras)

H100 = CHIP_SPECS["h100"]
# f32 operations per (pixel, entry) pair. Every pair a blend walks pays the
# keep test: dx, dy, sigma (five with FMAs), e^-sigma, op e^-sigma, the test.
TEST_FLOPS = 10
# a kept pair in K2: the test, alpha, T, w, 4 colour FMAs, the alpha sum
K2_FLOPS_PER_KEPT = 25
# a kept pair in K3: the test, alpha, T / (1 - alpha), g (4 colour FMAs), w,
# d alpha, S, d sigma, d op, two mean grads, three conic grads, 4 colour
# grads, two |.|, and the 12 rows' share of the sums over pixels
K3_FLOPS_PER_KEPT = 60
# a warp's test of one staged entry's keep box against its rectangle of
# pixel centres: four compares
BOX_TEST_FLOPS = 4
# one staged entry's keep box (raster_common.cuh keep_box): 255 op, its log,
# + 1e-3, det C, 0.01 ca cc, three compares, the clamp, 2.02 s, and for each
# axis a product, a division, a square root and + 0.01, then the four edges
KEEP_BOX_FLOPS = 24


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    from hunyuanworld_mirror_tpu_torch.utils.profiling import card_line
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    log(f"device: {name} (count {torch.cuda.device_count()})")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from hunyuanworld_mirror_tpu_torch.ops import _build
    t0 = time.time()
    seconds = _build.build(["attention_fwd", "rasterize_flat_fwd",
                            "rasterize_flat_bwd", "rasterize_binned_fwd"])
    log(f"build: {time.time() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for name in seconds:
        report = (_build.BUILD_DIR / f"{name}.ptxas.txt").read_text()
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# --- K1 ---------------------------------------------------------------------

# (label, (B, N, H, D), dtype, launches per forward on the main path). The
# JAX route a shape stands for follows N: K1a the one-pass kernel
# (N <= 4095), K1b the flash kernel (N >= 4096).
K1_SHAPES = [
    ("encoder", (4, 1374, 16, 64), torch.bfloat16, 24),
    ("frame", (4, 1376, 16, 64), torch.bfloat16, 24),
    ("global", (1, 5504, 16, 64), torch.bfloat16, 24),
    ("ragged", (2, 37, 16, 64), torch.bfloat16, 0),
    ("ragged_d128", (3, 130, 4, 128), torch.bfloat16, 0),
    ("n127", (1, 127, 16, 64), torch.bfloat16, 0),
    ("n129", (1, 129, 16, 64), torch.bfloat16, 0),
    ("n193", (1, 193, 16, 64), torch.bfloat16, 0),
    ("n4097", (1, 4097, 16, 64), torch.bfloat16, 0),
    ("d128_n300", (2, 300, 8, 128), torch.bfloat16, 0),
]


# K1c, the f32 route: the camera head's (1, N, 16, 128) at N = S views;
# held at the edges of its register kernel's instances (4, 8, 16 keys), of
# its 16-row blocks (N <= 64), of its resident K/V (3 tiles of 32 keys) and
# of its ring, timed at the main path's N = 4 (16 launches a forward) and at
# S = 32 views
K1C_CHECK_N = (1, 4, 5, 16, 17, 32, 97, 130)
K1C_TIMED_N = (4, 32)
K1C_PER_FWD = 16


def k1_route(n):
    from hunyuanworld_mirror_tpu_torch.ops.attention import FLASH_MIN_N
    return "K1b" if n >= FLASH_MIN_N else "K1a"


# max|kernel - plain| <= this share of max|plain|: 2^-6 is at most 4 ulps at
# the largest output for bf16, 2^-16 for f32 (ragged N and a skipped K/V
# tile move the output far more).
K1_REL_BAND = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -16}


def k1_bound_ms(shape, dtype):
    B, N, H, D = shape
    flops = 4.0 * B * H * N * N * D
    byts = 4.0 * B * N * H * D * (2 if dtype == torch.bfloat16 else 4)
    rate = H100.peak_flops_bf16 if dtype == torch.bfloat16 else H100.peak_flops_f32
    return max(flops / rate, byts / H100.hbm_bytes_per_s) * 1e3


def k1_check(label, q, k, v, per_batch=False):
    """K1 against its plain version within the band -> max|d|; with
    per_batch each batch is held to the band of its own max|plain|."""
    from hunyuanworld_mirror_tpu_torch.ops import attention as A
    scale = q.shape[-1] ** -0.5
    out = A.attention(q, k, v, scale)
    torch.cuda.synchronize()
    ref = A.attention_plain(q, k, v, scale).float()
    d = (out.float() - ref).abs()
    if per_batch:
        err = d.flatten(1).amax(1)
        band = K1_REL_BAND[q.dtype] * ref.abs().flatten(1).amax(1)
    else:
        err, band = d.max(), K1_REL_BAND[q.dtype] * ref.abs().max()
    ok = bool((err <= band).all()) and bool(torch.isfinite(out).all())
    err, band = err.tolist(), band.tolist()
    log(f"K1 {label:12s} {str(tuple(q.shape)):22s} {str(q.dtype)[6:]:8s} "
        f"strides {tuple(q.stride())}/{tuple(k.stride())}/{tuple(v.stride())}  "
        f"max|d| {err} (band {band})")
    if not ok:
        raise AssertionError(f"K1 {label} {tuple(q.shape)}: max|d| {err} > {band}")
    return max(err) if per_batch else err


def trunk_qkv(gen):
    """q, k, v of a frame layer as models/block.Attention.forward makes
    them: the fused qkv projection's views, q_norm / k_norm, and the 2D RoPE
    with the large preset's frame tables (7 special tokens + 37 x 37
    patches), at (4, 1376, 16, 64) bf16."""
    from hunyuanworld_mirror_tpu_torch.models import block, nn as pnn, rope
    B, N, C, H = 4, 1376, 1024, 16
    attn = block.Attention(C, H, qk_norm=True)
    pnn.init_weights(attn, torch.Generator().manual_seed(5))
    attn = attn.to("cuda", torch.bfloat16)
    x = torch.randn(B, N, C, generator=gen, device="cuda").to(torch.bfloat16)
    tables = rope.make_rope_tables(rope.grid_positions(37, 37, N - 37 * 37), C // H,
                                   device="cuda")
    with torch.no_grad():
        q, k, v = attn.qkv(x).reshape(B, N, 3, H, C // H).unbind(2)
        q, k = attn.q_norm(q), attn.k_norm(k)
        q, k = rope.apply_rope2d(q, tables), rope.apply_rope2d(k, tables)
    return q, k, v


def phase_k1():
    """K1 against its plain version: the main path's shapes (timed: kernel,
    plain, SDPA, bound), the ragged and tile-edge N, D = 128, the encoder's
    fused-qkv views, the trunk's q/k/v, and a batch whose keys and values
    are 100x its neighbours' -> per-route totals for the `kernels` line."""
    from hunyuanworld_mirror_tpu_torch.ops import _build
    from hunyuanworld_mirror_tpu_torch.ops import attention as A
    report = (_build.BUILD_DIR / "attention_fwd.ptxas.txt").read_text()
    for line in report.splitlines():
        if "Used" in line or "spill" in line or "C75" in line or "warning" in line:
            log(f"  ptxas attention_fwd: {line.strip()}")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)]
    if "C7508" in report or any(spills):
        raise AssertionError("K1: setmaxnreg ignored (C7508) or registers spilled")

    gen = torch.Generator(device="cuda").manual_seed(1)
    routes = {r: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
              for r in ("K1a", "K1b")}

    def note_err(n, err):
        routes[k1_route(n)]["err"] = max(routes[k1_route(n)]["err"], err)

    for label, shape, dtype, per_fwd in K1_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        note_err(shape[1], k1_check(label, q, k, v))
        if not per_fwd:
            continue
        scale = shape[-1] ** -0.5
        ms = cuda_ms(lambda: A.attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: A.attention_plain(q, k, v, scale), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale))
        bound = k1_bound_ms(shape, dtype)
        flops = 4.0 * shape[0] * shape[2] * shape[1] ** 2 * shape[3]
        log(f"K1 {label:12s} kernel {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s)  "
            f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  kernel/sdpa "
            f"{ms / lib_ms:.3f}  bound {bound:.4f} ms")
        tot = routes[k1_route(shape[1])]
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound)):
            tot[key] += per_fwd * val
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # the encoder's q, k, v: views of one fused qkv, N-stride 3 C
    x = torch.randn(4, 1374, 3, 16, 64, generator=gen, device="cuda").bfloat16()
    note_err(1374, k1_check("fused_views", *x.unbind(2)))
    # the trunk's: q and k normed and rotated (contiguous), v the strided view
    note_err(1376, k1_check("trunk_qkv", *trunk_qkv(gen)))
    # a read across the batch boundary would carry batch 1's 100x keys into
    # batches 0 and 2 and leave their own bands (the 100x batch's error is
    # left out of the kernels line's max_abs_err)
    q, k, v = (torch.randn(3, 1374, 16, 64, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    k[1] *= 100
    v[1] *= 100
    k1_check("batch_bleed", q, k, v, per_batch=True)
    del x, q, k, v
    torch.cuda.empty_cache()
    for name, r in routes.items():
        log(f"K1 {name} per forward: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.2f} ms  "
            f"sdpa {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms  "
            f"max|d| {r['err']:.3e}")
    routes["K1c"] = phase_k1c(gen)
    return routes


def device_ms_per_call(fn, reps=50):
    """fn's device time per call: the CUDA kernels' time under
    torch.profiler over `reps` calls (after one warm call), summed, / reps
    -> (ms or None if the profiler shows no device time, kernel names)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, names = 0.0, set()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.device_time_total / 1e3
            names.add(e.name)
    return (total / reps if total > 0 else None), sorted(names)


def phase_k1c(gen):
    """K1c, K1's f32 route, against its plain version at K1C_CHECK_N (and
    on fused-qkv views and misaligned inputs), then timed at K1C_TIMED_N
    against SDPA both ways -> the route's per-forward totals (at N = 4,
    K1C_PER_FWD launches) with the N = 32 numbers beside them."""
    from hunyuanworld_mirror_tpu_torch.ops import attention as A
    err = 0.0
    for n in K1C_CHECK_N:
        q, k, v = (torch.randn(1, n, 16, 128, generator=gen, device="cuda")
                   for _ in range(3))
        err = max(err, k1_check(f"K1c n{n}", q, k, v))
    # on each of its kernels: the camera head's layout (views of one qkv
    # projection), and a base 4 bytes off 16-byte alignment (the tiled
    # kernel's 4-byte copies)
    for n in (4, 33):
        x = torch.randn(1, n, 3, 16, 128, generator=gen, device="cuda")
        err = max(err, k1_check(f"K1c fused n{n}", *x.unbind(2)))
        y = torch.randn(3, 1, n * 16 * 128 + 1, generator=gen, device="cuda")
        q, k, v = (t[0, 1:].view(1, n, 16, 128) for t in y)
        assert q.data_ptr() % 16 == 4
        err = max(err, k1_check(f"K1c misaligned n{n}", q, k, v))
        del x, y, q, k, v
    out = {"err": err}
    for n in K1C_TIMED_N:
        shape = (1, n, 16, 128)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        scale = 128 ** -0.5
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def kern():
            return A.attention(q, k, v, scale)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=scale)

        ms, lib_ms = cuda_ms(kern, reps=200, warmup=20), cuda_ms(sdpa, reps=200, warmup=20)
        dev_ms, dev_names = device_ms_per_call(kern)
        lib_dev_ms, lib_names = device_ms_per_call(sdpa)
        plain_ms = cuda_ms(lambda: A.attention_plain(q, k, v, scale), reps=20)
        bound = k1_bound_ms(shape, torch.float32)
        ops_ms = 4.0 * 16 * n * n * 128 / H100.peak_flops_f32 * 1e3
        fmt = lambda x: "not measured" if x is None else f"{x:.5f} ms"  # noqa: E731
        log(f"K1c n{n} {shape}: per call (back-to-back loop) kernel {ms:.5f} ms, sdpa "
            f"{lib_ms:.5f} ms ({ms / lib_ms:.3f}x); device (profiler) kernel "
            f"{fmt(dev_ms)} {dev_names}, sdpa {fmt(lib_dev_ms)} {lib_names}; plain "
            f"{plain_ms:.5f} ms; bound {bound:.2e} ms")
        out[f"n{n}"] = {"ms": ms, "device_ms": dev_ms, "library_ms": lib_ms,
                        "library_device_ms": lib_dev_ms, "plain_ms": plain_ms,
                        "bound_ms": bound,
                        "bound_by": "operations" if ops_ms >= bound else "bytes"}
    main = out[f"n{K1C_TIMED_N[0]}"]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                "library_device_ms"):
        out[key] = None if main[key] is None else K1C_PER_FWD * main[key]
    out["bound_by"] = main["bound_by"]
    log(f"K1 K1c per forward ({K1C_PER_FWD} launches at N = {K1C_TIMED_N[0]}): kernel "
        f"{out['ms']:.4f} ms  plain {out['plain_ms']:.4f} ms  sdpa {out['library_ms']:.4f} "
        f"ms  bound {out['bound_ms']:.2e} ms  max|d| {out['err']:.3e}")
    return out


# --- K2 ---------------------------------------------------------------------

K2_BAND = 2e-3


def blend_pairs(packed, starts, counts, width, height, tile_size, d_col,
                f16) -> dict:
    """The (pixel, entry) pairs of this list's blend, over in-image pixels,
    counted on the plain replay: `kept` pairs pass the keep test and carry
    the full arithmetic; `forward` pairs are those a front-to-back blend
    with early stop tests (entries up to the one that takes T to <= 1e-4,
    K2's work without the cull); `backward` pairs are those a back-to-front
    walk tests (entries up to the pixel's last kept one, K3's work);
    `warp_walked` counts the (32-pixel warp, entry) steps of that walk
    (entries up to the warp's largest last kept one), `warp_kept` those
    where a pixel of the warp keeps the entry. For the forward kernels'
    warps of 8 x 4 pixels: `fwd_warp_walked` counts the (warp, entry) steps
    of the front-to-back walk (entries up to the one that ends the warp's
    last pixel), `fwd_warp_hit` those whose keep box reaches the warp (the
    rest are culled), `fwd_tested` the forward pairs the kernel still
    tests, those whose box reaches the pixel's warp, and `fwd_entries` the
    entries a tile stages (up to the one that ends its last pixel). The
    same for K3's warps of 8 x 4 pixels and back-to-front walk:
    `bwd_warp_walked` (entries up to the warp's largest last kept one),
    `bwd_tested` (the backward pairs whose box reaches the pixel's warp)
    and `bwd_entries` (entries up to the tile's largest last kept one)."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    tw = (width + tile_size - 1) // tile_size
    lin = torch.arange(tile_size * tile_size, device=packed.device)
    mx, my = R.decode_payload(packed, d_col, f16)[:2]
    rx0, rx1, ry0, ry1 = R.warp_rects(tile_size, packed.device)
    n = dict(kept=0, forward=0, backward=0, warp_walked=0, warp_kept=0,
             fwd_warp_walked=0, fwd_warp_hit=0, fwd_tested=0, fwd_entries=0,
             bwd_warp_walked=0, bwd_tested=0, bwd_entries=0)
    for b in R.blend_groups(packed, starts, counts, width, height, tile_size,
                            d_col, f16):
        g = b.g
        inside = ((((g % tw) * tile_size)[:, None] + lin % tile_size < width)
                  & (((g // tw) * tile_size)[:, None] + lin // tile_size < height))
        kept = (b.w > 0) & inside[:, None, :]
        k = torch.arange(kept.shape[1], device=packed.device)[None, :, None]
        last = torch.where(kept, k, -1).amax(dim=1)                    # (G, P)
        fwd = (b.t_before > R.T_EPS) & b.live[..., None] & inside[:, None, :]
        n["kept"] += int(kept.sum())
        n["forward"] += int(fwd.sum())
        n["backward"] += int((last + 1).sum())
        G, K, P = kept.shape
        n["warp_kept"] += int(kept.reshape(G, K, P // 32, 32).any(-1).sum())
        n["warp_walked"] += int((last.reshape(G, P // 32, 32).amax(-1) + 1).sum())
        x0, x1, y0, y1 = (v[..., None] for v in R.keep_box(
            mx[b.idx], my[b.idx], *(v[..., 0] for v in b.params)))     # (G, K, 1)
        gx = ((g % tw) * tile_size).float()[:, None, None]
        gy = ((g // tw) * tile_size).float()[:, None, None]
        hit = ~((x1 < gx + rx0) | (x0 > gx + rx1) | (y1 < gy + ry0) | (y0 > gy + ry1))
        n["fwd_tested"] += int((fwd & hit).sum())
        n["fwd_entries"] += int(fwd.any(-1).sum())
        # pixels (row-major) -> (warp rows, 4, warp columns, 8)
        shape = (G, K, tile_size // R.WARP_H, R.WARP_H, tile_size // R.WARP_W, R.WARP_W)
        walked = fwd.reshape(shape).any(5).any(3)
        n["fwd_warp_walked"] += int(walked.sum())
        n["fwd_warp_hit"] += int((walked & hit.reshape(shape)[:, :, :, 0, :, 0]).sum())
        n["bwd_tested"] += int(((k <= last[:, None, :]) & hit).sum())
        n["bwd_entries"] += int((last.amax(-1) + 1).sum())
        n["bwd_warp_walked"] += int((last.reshape(shape[:1] + shape[2:]).amax(4).amax(2)
                                     + 1).sum())
    return n


def ops_ms(pairs, way, flops_per_kept):
    """Time at the f32 peak for a culled walk's operations, way "fwd" (K2's
    loop) or "bwd" (K3's): the pairs it tests, of which pairs["kept"] carry
    `flops_per_kept` operations and the rest only the keep test, its warps'
    box tests, and the keep box of each entry it stages."""
    kept = pairs["kept"]
    flops = (kept * flops_per_kept + (pairs[f"{way}_tested"] - kept) * TEST_FLOPS
             + pairs[f"{way}_warp_walked"] * BOX_TEST_FLOPS
             + pairs[f"{way}_entries"] * KEEP_BOX_FLOPS)
    return flops / H100.peak_flops_f32 * 1e3


def blend_bound(packed, starts, counts, W, H, d_col, f16, n_cams=1,
                extra_bytes=0, id_bytes=0):
    """A forward blend's bound on this list -> (bound_ms, bound_by, pairs,
    bytes ms, operations ms): the entries the blend stages read once (plus
    `id_bytes` each), starts and counts, the image and alpha written once
    (plus `extra_bytes`), against the operations of the culled front-to-back
    walk with early stop (ops_ms), over each camera's segments of the
    list."""
    n_tiles = starts.numel() // n_cams
    pairs = {}
    for c in range(n_cams):
        seg = slice(c * n_tiles, (c + 1) * n_tiles)
        for k, v in blend_pairs(packed, starts[seg], counts[seg], W, H, 16, d_col,
                                f16).items():
            pairs[k] = pairs.get(k, 0) + v
    byts = (pairs["fwd_entries"] * (packed.shape[0] * 4 + id_bytes) + 2 * counts.numel() * 4
            + n_cams * W * H * (d_col + 1) * 4 + extra_bytes)
    t_bytes = byts / H100.hbm_bytes_per_s * 1e3
    t_ops = ops_ms(pairs, "fwd", K2_FLOPS_PER_KEPT)
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
            pairs, t_bytes, t_ops)


def check_blend(label, kern, plain):
    """A forward kernel's (img, alpha) against its plain version's, within
    K2_BAND -> max|d|."""
    img, alpha = kern()
    torch.cuda.synchronize()
    img_p, alpha_p = plain()
    err = max(float((img - img_p).abs().max()), float((alpha - alpha_p).abs().max()))
    if not (err <= K2_BAND) or not torch.isfinite(img).all():
        raise AssertionError(f"{label}: max|d| {err} > {K2_BAND}")
    return err


def check_order(label, order, counts):
    """The tile order K2's C entry sorted (raster_order.cuh) against its
    plain version, longest_first_bins: a permutation whose tiles' count bins
    equal the plain order's place by place (within a bin the kernel's
    atomics decide)."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    n = counts.numel()
    perm = torch.equal(order.sort().values, torch.arange(n, device=order.device))
    bins = R.order_bins(counts)
    if not (perm and torch.equal(bins[order], bins[R.longest_first_bins(counts)])):
        raise AssertionError(f"{label}: the tile order is not a permutation or not "
                             f"longest first by count bin")


def k2_check(label, bins, W, H, d_col, f16):
    """K2 vs its plain version on one sorted list, and the tile order it
    sorted -> (err, ms, plain_ms, bound_ms, bound_by, pairs)."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    args = (bins.packed, bins.starts, bins.counts, W, H, 16, d_col, f16)
    order = torch.empty(bins.counts.shape, dtype=torch.int64, device=bins.counts.device)
    err = check_blend(f"K2 {label}", lambda: R.rasterize_flat(*args, order_out=order),
                      lambda: R.rasterize_flat_plain(*args))
    check_order(f"K2 {label}", order, bins.counts)
    ms = cuda_ms(lambda: R.rasterize_flat(*args))
    plain_ms = cuda_ms(lambda: R.rasterize_flat_plain(*args), reps=2, warmup=1)
    n_entries = int(bins.counts.sum())
    bound, by, pairs, t_bytes, t_ops = blend_bound(bins.packed, bins.starts,
                                                   bins.counts, W, H, d_col, f16)
    culled = 1 - pairs["fwd_warp_hit"] / max(pairs["fwd_warp_walked"], 1)
    log(f"K2 {label:24s} payload {'f16' if f16 else 'f32'}  entries {n_entries}  "
        f"pairs walked {pairs['forward']} kept {pairs['kept']}, tested after the "
        f"cull {pairs['fwd_tested']}; (warp, entry) steps {pairs['fwd_warp_walked']}, "
        f"culled {culled:.3f}  max|d| {err:.3e} "
        f"(band {K2_BAND:.0e})  kernel {ms:.4f} ms  plain {plain_ms:.2f} ms  "
        f"bound {bound:.4f} ms ({by}; bytes {t_bytes:.4f}, operations {t_ops:.4f})")
    return err, ms, plain_ms, bound, by, pairs


def synthetic_scene():
    """~500k random splats in front of a 518 px camera, projected: (means2d,
    conics, colours + depth, opacities, tight radii, depths)."""
    from hunyuanworld_mirror_tpu_torch.ops import projection, tiles
    W = H = 518
    n = 500_000
    g = torch.Generator(device="cuda").manual_seed(2)
    means = torch.rand(n, 3, generator=g, device="cuda") * torch.tensor(
        [3.0, 3.0, 2.0], device="cuda") - torch.tensor([1.5, 1.5, -2.0], device="cuda")
    quats = torch.randn(n, 4, generator=g, device="cuda")
    scales = torch.rand(n, 3, generator=g, device="cuda") * 0.004 + 0.001
    opac = torch.rand(n, generator=g, device="cuda") * 0.9 + 0.1
    rgb = torch.rand(n, 3, generator=g, device="cuda")
    viewmat = torch.eye(4, device="cuda")
    f = 0.5 * W / math.tan(math.radians(30))
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], device="cuda")
    cov = projection.quat_scale_to_covar_planes(quats, scales)
    pj = projection.fully_fused_projection(means, cov, viewmat[None], K[None], W, H)
    rad = tiles.opacity_tight_radii(pj.radii[0], opac)
    col = torch.cat([rgb, pj.depths[0][:, None]], -1)
    return pj.means2d[0], pj.conics[0], col, opac, rad, pj.depths[0]


def phase_k2_synthetic():
    """K2's ptxas report, then K2 on the synthetic scene, both payloads."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer
    ptxas_check("rasterize_flat_fwd", "K2 / K2m")
    m2d, con, col, opac, rad, dep = synthetic_scene()
    for f16 in (False, True):
        bins = rasterizer.bin_splats(m2d, con, col, opac, rad, dep, 16, 33, 33,
                                     4, 4096, f16)
        k2_check(f"synthetic 500k splats", bins, 518, 518, 4, f16)


# --- main path --------------------------------------------------------------

def main_path_scene(preds):
    """Phase 5's compacted splats (quats xyzw) and its 4 predicted cameras
    (world->cam, intrinsics) -> (means, quats, scales, opacities, sh, w2c,
    Ks, HW), HW the images' height (their width too, but for the landscape
    forward)."""
    from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils
    HW = preds["depth"].shape[2]
    sp = preds["splats"]
    ext, intr = cam_utils.vector_to_camera_matrices(preds["camera_params"][0],
                                                    tuple(preds["depth"].shape[2:4]))
    return (sp["means"][0], sp["quats"][0][:, [1, 2, 3, 0]], sp["scales"][0],
            sp["opacities"][0], sp["sh"][0], cam_utils.to_homogeneous(ext), intr, HW)


def phase_main_path():
    from hunyuanworld_mirror_tpu_torch.infer import (PRESETS, load_model,
                                                     reconstruct, run)
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer, rasterizer_flat
    from hunyuanworld_mirror_tpu_torch.ops.attention import attention

    cfg = WorldMirrorConfig(**PRESETS["large"])
    S, HW = 4, 518
    imgs = np.random.default_rng(0).uniform(size=(1, S, HW, HW, 3)).astype(np.float32)
    cams = fixed_cameras(S)
    torch.cuda.reset_peak_memory_stats()
    attention.launches = attention.flash_route_launches = attention.f32_launches = 0
    rasterizer_flat.rasterize_flat.launches = 0
    t0 = time.time()
    preds = run(imgs, cfg, camera_params=cams)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"attention_fwd": attention.launches,
                "attention_fwd_flash_route": attention.flash_route_launches,
                "attention_fwd_f32": attention.f32_launches,
                "rasterize_flat_fwd": rasterizer_flat.rasterize_flat.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path run: {wall:.2f} s wall incl. model build and first use; "
        f"peak memory {peak_gb:.2f} GB; launches {launches}")
    if launches != {"attention_fwd": 88, "attention_fwd_flash_route": 24,
                    "attention_fwd_f32": K1C_PER_FWD, "rasterize_flat_fwd": 4}:
        raise AssertionError(f"expected 88 attention launches (24 at N >= 4096, "
                             f"{K1C_PER_FWD} f32) and 4 rasterizer launches per forward, "
                             f"got {launches}")

    # timing: one model, so no forward pays for a model build
    model = load_model(cfg, device="cuda")
    reconstruct(model, imgs, cams)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = timed_forwards("main path", lambda marks: reconstruct(model, imgs, cams,
                                                                 marks=marks))
    landscape_forward(model, cams)
    prior_forward(model, imgs, cams, out)
    del model, out

    for k in ("camera_params", "depth", "pts3d", "normals", "gs_depth",
              "rendered_colors", "rendered_depths", "rendered_alphas"):
        v = preds[k]
        if not torch.isfinite(v).all():
            raise AssertionError(f"main path: {k} is not finite")
        log(f"  {k:16s} {tuple(v.shape)}  mean {float(v.float().mean()):.4f}")
    shapes = {"depth": (1, S, HW, HW, 1), "rendered_colors": (1, S, HW, HW, 3),
              "rendered_alphas": (1, S, HW, HW, 1), "camera_params": (1, S, 9)}
    for k, shp in shapes.items():
        if tuple(preds[k].shape) != shp:
            raise AssertionError(f"main path: {k} {tuple(preds[k].shape)} != {shp}")
    sp = preds["splats"]
    alpha_mean = float(preds["rendered_alphas"].mean())
    log(f"  splats {tuple(sp['means'].shape)}  live {int((sp['weights'] > 0).sum())}  "
        f"n_compact_dropped {sp['n_compact_dropped'].tolist()}  intersections "
        f"{preds['render_n_isects'].tolist()}  n_dropped "
        f"{preds['render_n_dropped'].tolist()}  mean alpha {alpha_mean:.4f}")
    if not alpha_mean > 0.05:
        raise AssertionError("main path: the render is empty")

    # K2 on the main path's own sorted lists (the same binning as the render)
    means, quats, scales, opac, sh, w2c, intr, _ = main_path_scene(preds)
    k2 = dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, by=set())
    for c in range(S):
        bins = rasterizer.bin_camera(means, quats, scales, opac, sh, w2c[c], intr[c],
                                     HW, HW, 16, RENDER_MPT, RENDER_TPG, True)
        err, ms, plain_ms, bound, by, _ = k2_check(f"main path camera {c}", bins,
                                                   HW, HW, 4, True)
        k2["err"] = max(k2["err"], err)
        k2["ms"] += ms
        k2["plain_ms"] += plain_ms
        k2["bound_ms"] += bound
        k2["by"].add(by)
    return launches, k2, preds, imgs


def timed_forwards(label, forward, n=7, medians=None):
    """n forwards, each split into its phases by the CUDA events the model
    records (`marks`), after a reset of the peak memory -> the last output.
    `medians` (a dict) receives each phase's median ms and the total's."""
    torch.cuda.reset_peak_memory_stats()
    totals, phases = [], {}
    for i in range(n):
        marks = []
        out = forward(marks)
        torch.cuda.synchronize()
        ph = {name: marks[j - 1][1].elapsed_time(ev)
              for j, (name, ev) in enumerate(marks) if j}
        for k, v in ph.items():
            phases.setdefault(k, []).append(v)
        totals.append(sum(ph.values()))
        log(f"{label} forward {i}: " + "  ".join(f"{k} {v:.2f} ms" for k, v in ph.items())
            + f"  total {totals[-1]:.2f} ms")
        if i < n - 1:
            del out
    log(f"{label} forward total: median {float(np.median(totals)):.2f} ms, "
        f"min {min(totals):.2f}, max {max(totals):.2f} over {len(totals)}; "
        f"peak memory with the bf16 model resident "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if medians is not None:
        medians.update({k: float(np.median(v)) for k, v in phases.items()},
                       total=float(np.median(totals)))
    return out


def prior_views(cams, HW, depth):
    """Priors for S views: the cameras of `cams` (1, S, 9) as 4 x 4
    camera-to-world poses and their K, and `depth` (1, S, H, W)."""
    from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils
    ext, K = cam_utils.vector_to_camera_matrices(torch.as_tensor(cams).to(depth.device), HW)
    return {"camera_pose": cam_utils.se3_inverse(cam_utils.to_homogeneous(ext)),
            "camera_intrinsics": K, "depthmap": depth}


def prior_forward(model, imgs, cams, ref):
    """Phase 5's model with all three priors, cond (1, 1, 1): the phase's
    cameras as poses and intrinsics, the no-prior forward's depth as the
    depth map. Finite outputs, the no-prior launch counts (88 K1, 24 of them
    at N >= 4096, 4 K2), outputs that differ from the no-prior forward `ref`
    by more than 1e-4 and ten times the spread of a repeated no-prior forward
    (the prior tokens reached the trunk), K2 against its plain version on
    its 4 lists, then 7 timed forwards with the phase split."""
    from hunyuanworld_mirror_tpu_torch.infer import reconstruct
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer, rasterizer_flat
    from hunyuanworld_mirror_tpu_torch.ops.attention import attention
    S, HW = imgs.shape[1], imgs.shape[2]
    priors = prior_views(cams, (HW, HW), ref["depth"][..., 0].float())
    attention.launches = attention.flash_route_launches = 0
    rasterizer_flat.rasterize_flat.launches = 0
    preds = reconstruct(model, imgs, cams, priors=priors, cond_flags=(1, 1, 1))
    torch.cuda.synchronize()
    launches = (attention.launches, attention.flash_route_launches,
                rasterizer_flat.rasterize_flat.launches)
    again = reconstruct(model, imgs, cams)
    keys = ("camera_params_pred", "depth", "pts3d", "normals", "gs_depth")
    diffs = {k: float((preds[k].float() - ref[k].float()).abs().max()) for k in keys}
    noise = {k: float((again[k].float() - ref[k].float()).abs().max()) for k in keys}
    del again
    log(f"prior forward (cond 1,1,1): launches (K1, K1 at N >= 4096, K2) {launches}; "
        f"max|prior - no prior| {json.dumps(diffs)}; max|no prior - no prior| "
        f"{json.dumps(noise)}; intersections {preds['render_n_isects'].tolist()}  "
        f"mean alpha {float(preds['rendered_alphas'].mean()):.4f}")
    if launches != (88, 24, 4):
        raise AssertionError(f"prior forward: launches {launches} != (88, 24, 4)")
    for k in ("camera_params_pred", "depth", "pts3d", "normals", "gs_depth",
              "rendered_colors", "rendered_alphas"):
        if not torch.isfinite(preds[k]).all():
            raise AssertionError(f"prior forward: {k} is not finite")
    if not all(diffs[k] > max(1e-4, 10 * noise[k]) for k in keys):
        raise AssertionError(f"prior forward: outputs do not differ from the no-prior "
                             f"forward's beyond 1e-4 and 10x its run-to-run spread: "
                             f"{diffs} vs {noise}")
    means, quats, scales, opac, sh, w2c, intr, _ = main_path_scene(preds)
    for c in range(S):
        bins = rasterizer.bin_camera(means, quats, scales, opac, sh, w2c[c], intr[c],
                                     HW, HW, 16, RENDER_MPT, RENDER_TPG, True)
        k2_check(f"prior camera {c}", bins, HW, HW, 4, True)
    del preds
    timed_forwards("prior path", lambda marks: reconstruct(
        model, imgs, cams, marks=marks, priors=priors, cond_flags=(1, 1, 1)))


# a 4:3 photo as the CLI's default crop mode makes it: 518 wide, 392 tall
# (a 28 x 37 patch grid; 33 x 25 = 825 tiles, the bottom row partial)
LANDSCAPE_HW = (392, 518)


def landscape_forward(model, cams):
    """One forward of phase 5's model on S = 4 landscape images: finite
    outputs of the landscape's shape, 88 K1 launches (24 at N >= 4096) and 4
    K2 launches, then K2 against its plain version on its 4 lists."""
    from hunyuanworld_mirror_tpu_torch.infer import reconstruct
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer, rasterizer_flat
    from hunyuanworld_mirror_tpu_torch.ops.attention import attention
    H, W = LANDSCAPE_HW
    S = cams.shape[1]
    imgs = np.random.default_rng(2).uniform(size=(1, S, H, W, 3)).astype(np.float32)
    attention.launches = attention.flash_route_launches = 0
    rasterizer_flat.rasterize_flat.launches = 0
    preds = reconstruct(model, imgs, cams)
    torch.cuda.synchronize()
    launches = (attention.launches, attention.flash_route_launches,
                rasterizer_flat.rasterize_flat.launches)
    log(f"landscape {W}x{H} forward: launches (K1, K1 at N >= 4096, K2) {launches}; "
        f"intersections {preds['render_n_isects'].tolist()}  mean alpha "
        f"{float(preds['rendered_alphas'].mean()):.4f}")
    if launches != (88, 24, 4):
        raise AssertionError(f"landscape forward: launches {launches} != (88, 24, 4)")
    for k, shp in (("depth", (1, S, H, W, 1)), ("rendered_colors", (1, S, H, W, 3)),
                   ("pts3d", (1, S, H, W, 3))):
        if tuple(preds[k].shape) != shp or not torch.isfinite(preds[k]).all():
            raise AssertionError(f"landscape forward: {k} {tuple(preds[k].shape)} "
                                 f"not finite or != {shp}")
    means, quats, scales, opac, sh, w2c, intr, _ = main_path_scene(preds)
    for c in range(S):
        bins = rasterizer.bin_camera(means, quats, scales, opac, sh, w2c[c], intr[c],
                                     W, H, 16, RENDER_MPT, RENDER_TPG, True)
        if bins.starts.numel() != 825:
            raise AssertionError(f"landscape list: {bins.starts.numel()} tiles")
        k2_check(f"{W}x{H} camera {c}", bins, W, H, 4, True)


# --- K3 -----------------------------------------------------------------------

# max|kernel - plain| of every output row (the 8 + D per-splat rows, and the
# per-entry rows where asked) <= this share of that row's max|plain|. The
# sums run in another order than the plain version's: a warp butterfly,
# the warps in order, then global reductions into each splat's row whose
# order changes from run to run, and T is recovered by division walking
# back instead of a cumulative product.
K3_REL_BAND = 1e-3
# K2's final T against the plain replay (absolute), and the share of pixels
# whose last kept entry may differ (an entry at the 1e-4 stop, decided in
# another rounding)
K2_STATE_BAND = 2e-3
K2_LAST_MISMATCH = 1e-3


def ptxas_check(source, label):
    """A rasterizer source's ptxas report (every kernel instance):
    registers, stack, spills, and the blocks an SM holds at 16 x 16 tiles
    and D = 4 (the D = 4 instance's registers; 65,536 registers and 228 KB
    an SM, registers allocated 256 to a warp, 1 KB reserved a block, at
    most 32 blocks and 2,048 threads). Fails on a stack frame or a spill."""
    from hunyuanworld_mirror_tpu_torch.ops import _build
    report = (_build.BUILD_DIR / f"{source}.ptxas.txt").read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
    frames = [int(n) for n in re.findall(r"(\d+) bytes stack frame", report)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)]
    # each entry function's name (D = 4: template argument "ILi4E") and registers
    entries = re.findall(r"Compiling entry function '([^']+)'.*?Used (\d+) registers",
                         report, re.S)
    regs4 = [int(r) for name, r in entries if "ILi4E" in name] or regs
    lib = _build.load(source)
    threads = getattr(lib, f"{source}_threads")(16)
    smem = getattr(lib, f"{source}_smem")(16, 4)
    by_regs = 65536 // (math.ceil(max(regs4) * 32 / 256) * 256 * (threads // 32))
    blocks = min(32, 2048 // threads, by_regs, (228 * 1024) // (smem + 1024))
    log(f"{label} ptxas: registers {regs} ({max(regs4)} at D = 4), stack frames "
        f"{frames}, spills {spills}; {threads} threads and {smem} B of shared "
        f"memory a block at D = 4; {blocks} blocks an SM ({blocks * threads} threads)")
    if any(frames) or any(spills) or not regs:
        raise AssertionError(f"{label}: ptxas reports a stack frame or a spill")


def tile_walks(last, W, H, tile_size=16):
    """Each tile's walk, its pixels' largest last-kept index + 1 (float,
    tile order), from K2's (H, W) last-kept plane."""
    tw, th = -(-W // tile_size), -(-H // tile_size)
    lp = torch.nn.functional.pad(last, (0, tw * tile_size - W, 0, th * tile_size - H),
                                 value=-1)
    lp = lp.reshape(th, tile_size, tw, tile_size).transpose(1, 2).reshape(tw * th, -1)
    return (lp.amax(1) + 1).float()


def k3_check(label, bins, W, H, d_col, n_gauss, gen):
    """K3 vs its plain version on one sorted f32 list, with and without the
    per-entry rows -> (err, ms, plain_ms, bound_ms, bound_by, entry_ms,
    walks, counts). ms is the wrapper as RasterizeFlat.backward calls it
    (no per-entry rows), entry_ms its C entry alone on outputs and a tile
    order made once."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    fwd = (bins.packed, bins.starts, bins.counts, W, H, 16, d_col, False)
    _, _, t_fin, last = R.rasterize_flat(*fwd, with_state=True)
    _, _, t_fin_p, last_p = R.rasterize_flat_plain(*fwd, with_state=True)
    t_err = float((t_fin - t_fin_p).abs().max())
    last_bad = float((last != last_p).float().mean())
    if not (t_err <= K2_STATE_BAND and last_bad <= K2_LAST_MISMATCH):
        raise AssertionError(f"K2 state {label}: max|dT| {t_err}, last differs "
                             f"at {last_bad} of pixels")
    dev = bins.packed.device
    v_img = torch.randn(H, W, d_col, generator=gen, device=dev)
    v_alpha = torch.randn(H, W, 1, generator=gen, device=dev)
    list_args = (bins.packed, bins.starts, bins.counts, bins.gauss_ids, n_gauss)
    kern = lambda entries: R.rasterize_flat_bwd(*list_args, v_img, v_alpha, t_fin,
                                                last, W, H, 16, d_col,
                                                with_entries=entries)
    plain = lambda: R.rasterize_flat_bwd_plain(*list_args, v_img, v_alpha, W, H,
                                               16, d_col)
    entry, splat = kern(True)
    torch.cuda.synchronize()
    entry_p, splat_p = plain()
    _, splat_only = kern(False)
    err = 0.0
    for name, a, b in (("entry", entry, entry_p), ("splat", splat, splat_p),
                       ("splat without entry rows", splat_only, splat_p)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"K3 {label}: {name} grads not finite")
        d = (a - b).abs().amax(dim=1)
        band = K3_REL_BAND * b.abs().amax(dim=1)
        if not bool((d <= band).all()):
            raise AssertionError(f"K3 {label}: {name} rows max|d| {d.tolist()} > "
                                 f"band {band.tolist()}")
        err = max(err, float(d.max()))
    del entry, entry_p
    ms = cuda_ms(lambda: kern(False), reps=5, warmup=1)
    out = torch.zeros(n_gauss, R.splat_cols(d_col), device=dev)
    order = R.longest_first(bins.counts)
    entry_ms = cuda_ms(lambda: R.rasterize_flat_bwd_launch(
        bins.packed, bins.starts, bins.counts, bins.gauss_ids, v_img, v_alpha, t_fin,
        last, out, None, W, H, 16, d_col, order), reps=5, warmup=1)
    plain_ms = cuda_ms(plain, reps=1, warmup=0)
    k2_state_ms = cuda_ms(lambda: R.rasterize_flat(*fwd, with_state=True))
    n_entries = int(bins.counts.sum())
    rows = R.grad_rows(d_col)
    pairs = blend_pairs(*fwd)
    # the entries the walks stage (payload, id) read once, the per-splat rows
    # written once, the cotangents and K2's T / last planes read once,
    # starts, counts
    byts = (pairs["bwd_entries"] * (bins.packed.shape[0] + 1) * 4 + n_gauss * rows * 4
            + W * H * ((d_col + 1) * 4 + 8) + 2 * bins.counts.numel() * 4)
    t_bytes = byts / H100.hbm_bytes_per_s * 1e3
    # the same with the per-entry rows written, which the training path skips
    t_bytes_entries = (byts + n_entries * rows * 4) / H100.hbm_bytes_per_s * 1e3
    t_ops = ops_ms(pairs, "bwd", K3_FLOPS_PER_KEPT)
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes > t_ops else "operations"
    walks, counts = tile_walks(last, W, H), bins.counts.float()
    log(f"K3 {label:24s} entries {n_entries}  pairs walked {pairs['backward']}, tested "
        f"after the box skip {pairs['bwd_tested']}, kept {pairs['kept']}  max|d| {err:.3e} (rows within {K3_REL_BAND:.0e} "
        f"of max|plain|)  K2 state max|dT| {t_err:.1e} last differs "
        f"{last_bad:.1e}  wrapper {ms:.4f} ms  C entry {entry_ms:.4f} ms  plain "
        f"{plain_ms:.2f} ms  bound {bound:.4f} ms ({by}; bytes {t_bytes:.4f}, "
        f"operations {t_ops:.4f}; with the per-entry rows {max(t_bytes_entries, t_ops):.4f})"
        f"  walks mean {float(walks.mean()):.1f} p99 "
        f"{float(torch.quantile(walks, 0.99)):.1f} max {float(walks.max()):.0f} "
        f"(counts max {float(counts.max()):.0f})  K2 with the training planes "
        f"{k2_state_ms:.4f} ms")
    return err, ms, plain_ms, bound, by, entry_ms, walks, counts


def phase_k3_synthetic(gen):
    """K3 (and K2's training planes) on the synthetic scene of phase 4."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer
    scene = synthetic_scene()
    bins = rasterizer.bin_splats(*scene, 16, 33, 33, 9, 4096, False,
                                 with_ids=True)
    k3_check("synthetic 500k splats", bins, 518, 518, 4, scene[0].shape[0], gen)


def k3_cameras(label, means, quats_xyzw, scales, opac, sh, w2c, Ks, HW,
               max_per_tile, gen):
    """k3_check on each camera's f32 list (9 tiles per splat), binned as the
    training step bins -> totals over the cameras, and the walks of all
    their tiles."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer
    k3 = dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, by=set(), entry_ms=0.0)
    walks, counts = [], []
    for c in range(w2c.shape[0]):
        bins = rasterizer.bin_camera(means, quats_xyzw, scales, opac, sh, w2c[c],
                                     Ks[c], HW, HW, 16, max_per_tile, 9, False,
                                     with_ids=True)
        err, ms, plain_ms, bound, by, entry_ms, w, n = k3_check(
            f"{label} camera {c}", bins, HW, HW, 4, means.shape[0], gen)
        k3["err"] = max(k3["err"], err)
        k3["ms"] += ms
        k3["plain_ms"] += plain_ms
        k3["bound_ms"] += bound
        k3["by"].add(by)
        k3["entry_ms"] += entry_ms
        walks.append(w)
        counts.append(n)
        del bins
        torch.cuda.empty_cache()
    w, n = torch.cat(walks), torch.cat(counts)
    log(f"K3 {label}: walks over {w.numel()} tiles mean {float(w.mean()):.1f} "
        f"p99 {float(torch.quantile(w, 0.99)):.1f} max {float(w.max()):.0f} "
        f"(longest / mean {float(w.max() / w.mean()):.2f}); counts mean "
        f"{float(n.mean()):.1f} max {float(n.max()):.0f}")
    return k3


def phase_k3(preds):
    """K3's ptxas report, then K3 on the synthetic scene and on the lists of
    the main path's splats."""
    ptxas_check("rasterize_flat_bwd", "K3 (D = 1..8)")
    gen = torch.Generator(device="cuda").manual_seed(7)
    phase_k3_synthetic(gen)
    means, quats, scales, opac, sh, w2c, Ks, HW = main_path_scene(preds)
    k3_cameras("main path", means, quats, scales, opac, sh, w2c, Ks, HW, RENDER_MPT,
               gen)


# --- the training path ----------------------------------------------------------

def phase_train(preds, imgs):
    import tempfile
    from pathlib import Path

    from hunyuanworld_mirror_tpu_torch import splat_trainer
    from hunyuanworld_mirror_tpu_torch.infer import export
    from hunyuanworld_mirror_tpu_torch.io import ply as io_ply
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    from hunyuanworld_mirror_tpu_torch.training import splat_opt

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp) / "infer"
        export(preds, imgs, out_dir)
        images = Path(tmp) / "images.npy"
        np.save(images, imgs[0])
        HW = imgs.shape[2]

        t0 = time.time()
        out = splat_trainer.run(str(out_dir), str(images), iters=2, size=HW,
                                device="cuda", log_fn=log)
        torch.cuda.synchronize()
        n_ply = len(io_ply.read_ply(out_dir / "gaussians_opt.ply")["x"])
        log(f"trainer twin run(): 2 iterations in {time.time() - t0:.2f} s wall, "
            f"loading the directory and the training path's first use "
            f"included; wrote gaussians_opt.ply with {n_ply} splats")
        if n_ply != len(out["means"]) or not np.isfinite(out["means"]).all():
            raise AssertionError("trainer twin: bad gaussians_opt.ply")

        splats, gt, c2w, Ks, depths = splat_trainer.load_infer_dir(
            str(out_dir), str(images), HW, log)
    n = len(splats["means"])
    cfg = splat_opt.SplatOptConfig(iters=30, refine_start=10, refine_every=10,
                                   refine_stop=30)
    capacity = int(n * cfg.capacity_factor)
    log(f"training: {n} splats from gaussians.ply in {capacity} slots, "
        f"{len(gt)} cameras at {HW}x{HW}, RGB+ED, max_per_tile "
        f"{cfg.max_per_tile}, 9 tiles per splat, f32 payload, SH degree 0")

    steps = []
    prev = {"k2": 0, "k3": 0}
    # the slot states whose lists K3 is held on: the input of step 10, a step
    # of the median below, and the state after the refine at step 29
    snap_at = {9: "step 10", cfg.iters - 1: "after refine 29"}
    snaps = {}

    def on_step(info):
        k2, k3 = R.rasterize_flat.launches, R.rasterize_flat_bwd.launches
        steps.append(dict(info, loss=float(info["loss"]), k2=k2 - prev["k2"],
                          k3=k3 - prev["k3"],
                          alive=int((info["raw"]["alive"] > 0.5).sum()),
                          slots=tuple(info["raw"]["means"].shape),
                          n_dropped=info["meta"]["n_dropped"].tolist(), raw=None,
                          meta=None))
        prev.update(k2=k2, k3=k3)
        if info["it"] in snap_at:
            with torch.no_grad():
                snaps[snap_at[info["it"]]] = [
                    x.detach().clone() for x in splat_opt._activate(info["raw"])]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    R.rasterize_flat.launches = R.rasterize_flat_bwd.launches = 0
    t0 = time.time()
    splat_opt.optimize_splats(splats, gt, c2w, Ks, cfg, depths=depths,
                              device="cuda", log_fn=log, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [s["loss"] for s in steps]
    phases = []
    for s in steps:
        m = s["marks"]
        phases.append({name: m[j - 1][1].elapsed_time(ev)
                       for j, (name, ev) in enumerate(m) if j})
    plain_steps = [p for p, s in zip(phases, steps) if not s["refined"]]
    names = ("render_forward", "backward", "optimizer")
    med = {k: float(np.median([p[k] for p in plain_steps])) for k in names}
    med_total = float(np.median([sum(p.values()) for p in plain_steps]))
    refines = [(s["it"], s["alive"], phases[i]["refine"])
               for i, s in enumerate(steps) if s["refined"]]
    log(f"training: {len(steps)} steps in {wall:.2f} s wall; losses first "
        f"{losses[0]:.5f} last {losses[-1]:.5f}; peak memory {peak_gb:.2f} GB")
    log(f"training step (median of {len(plain_steps)} steps without a refine): "
        + "  ".join(f"{k} {v:.2f} ms" for k, v in med.items())
        + f"  total {med_total:.2f} ms")
    for it, alive, ms in refines:
        log(f"training refine at step {it}: {ms:.2f} ms, {alive} live splats after")
    log(f"training n_dropped per camera: first step {steps[0]['n_dropped']}, "
        f"last step {steps[-1]['n_dropped']}; launches per step (K2, K3) "
        f"{sorted({(s['k2'], s['k3']) for s in steps})}")

    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"training: losses {losses}")
    if any((s["k2"], s["k3"]) != (4, 4) for s in steps):
        raise AssertionError("training: expected 4 K2 and 4 K3 launches per step")
    if any(s["slots"] != (capacity, 3) for s in steps):
        raise AssertionError("training: the slot count changed")
    if [it for it, _, _ in refines] != [19, 29]:
        raise AssertionError(f"training: refines at {refines}")

    # K3 against its plain version on the training step's own lists, binned
    # as the step bins them
    from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils
    w2c = cam_utils.se3_inverse(torch.as_tensor(c2w, device="cuda"))
    Ks_t = torch.as_tensor(Ks, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    k3 = {}
    for label, (means, quats, scales, opac, sh) in snaps.items():
        k3[label] = k3_cameras(f"training {label}", means, quats[:, [1, 2, 3, 0]],
                               scales, opac, sh, w2c, Ks_t, HW, cfg.max_per_tile,
                               gen)
        log(f"K3 per training step on the lists of {label}: wrapper "
            f"{k3[label]['ms']:.4f} ms  C entry {k3[label]['entry_ms']:.4f} ms  "
            f"plain {k3[label]['plain_ms']:.2f} ms  bound {k3[label]['bound_ms']:.4f} ms")
    ref = {"median_ms": med_total, "loss0": losses[0],
           "dropped0": steps[0]["n_dropped"]}
    return steps[0]["k3"], k3["after refine 29"], (splats, gt, c2w, Ks, depths), ref


# --- the rasterizer variants: K2m, K5, K4 -------------------------------------

def totals(label, rows):
    """Sum the per-camera (err, ms, plain_ms, bound_ms, bound_by) rows of
    one route -> the kernels-line numbers."""
    out = dict(err=max(r[0] for r in rows), ms=sum(r[1] for r in rows),
               plain_ms=sum(r[2] for r in rows), bound_ms=sum(r[3] for r in rows),
               by="operations" if any(r[4] == "operations" for r in rows) else "bytes")
    log(f"{label}: kernel {out['ms']:.4f} ms  plain {out['plain_ms']:.2f} ms  "
        f"bound {out['bound_ms']:.4f} ms ({out['by']})  max|d| {out['err']:.3e}")
    return out


def phase_k2m(preds):
    """K2m: the camera-batched route, its kernel against the plain version,
    and the route against the per-camera one."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    means, quats, scales, opac, sh, w2c, Ks, HW = main_path_scene(preds)
    C = w2c.shape[0]

    def route(batch):
        return rasterizer.rasterize(means, quats, scales, opac, sh, w2c, Ks, HW, HW,
                                    max_per_tile=RENDER_MPT,
                                    max_tiles_per_gauss=RENDER_TPG,
                                    camera_batch=batch, device="cuda")

    R.rasterize_flat.launches = R.rasterize_flat_multi.launches = 0
    out, alpha, meta = route(True)
    torch.cuda.synchronize()
    launches = (R.rasterize_flat_multi.launches, R.rasterize_flat.launches)
    if launches != (1, 0):
        raise AssertionError(f"K2m route: (K2m, K2) launches {launches} != (1, 0)")
    out_c, alpha_c, meta_c = route(False)
    d = torch.cat([(out - out_c)[..., :3], alpha - alpha_c], -1).abs()
    diff = dict(max=float(d.max()), median=float(d.median()),
                share_gt_1e_3=float((d.amax(-1) > 1e-3).float().mean()))
    log(f"K2m route vs per-camera route (RGB and alpha, f32 payload): {diff}; "
        f"n_isects {meta['n_isects'].tolist()} vs {meta_c['n_isects'].tolist()}, "
        f"n_dropped {int(meta['n_dropped'][0])} vs {meta_c['n_dropped'].tolist()}")
    if not (torch.isfinite(out).all() and diff["median"] < 1e-3):
        raise AssertionError(f"K2m route: render differs from the per-camera one {diff}")

    bins, _ = rasterizer.bin_cameras(means, quats, scales, opac, sh, w2c, Ks, HW,
                                     HW, 16, RENDER_MPT, RENDER_TPG)
    args = (bins.packed, bins.starts, bins.counts, C, HW, HW, 16, 4)
    err = check_blend("K2m", lambda: R.rasterize_flat_multi(*args),
                      lambda: R.rasterize_flat_multi_plain(*args))
    ms = cuda_ms(lambda: R.rasterize_flat_multi(*args))
    plain_ms = cuda_ms(lambda: R.rasterize_flat_multi_plain(*args), reps=2, warmup=1)
    bound, by, pairs, t_bytes, t_ops = blend_bound(bins.packed, bins.starts,
                                                   bins.counts, HW, HW, 4, False, C)
    route_ms = cuda_ms(lambda: route(True), reps=5, warmup=1)
    per_camera_ms = cuda_ms(lambda: route(False), reps=5, warmup=1)
    log(f"K2m {C} cameras, one list of {bins.packed.shape[1]} slots, entries "
        f"{int(bins.counts.sum())}  pairs tested {pairs['forward']} kept "
        f"{pairs['kept']}  max|d| {err:.3e} (band {K2_BAND:.0e})  kernel {ms:.4f} ms  "
        f"plain {plain_ms:.2f} ms  bound {bound:.4f} ms ({by}; bytes {t_bytes:.4f}, "
        f"operations {t_ops:.4f})")
    log(f"rasterize, {C} cameras: camera-batched route {route_ms:.3f} ms, "
        f"per-camera route (f32 payload) {per_camera_ms:.3f} ms")
    return launches[0], dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by)


def phase_k5(preds, train_inputs):
    """K5: the per-camera inference route at G = 16, 8, 4, then 3 training
    steps at G=4 against G=1. WM_RASTER_GROUP is restored afterwards."""
    saved = os.environ.get("WM_RASTER_GROUP")
    try:
        line = None
        for group in (16, 8, 4):
            os.environ["WM_RASTER_GROUP"] = str(group)
            launches, line = k5_render(preds, group)
        train_k5(train_inputs)
    finally:
        if saved is None:
            os.environ.pop("WM_RASTER_GROUP", None)
        else:
            os.environ["WM_RASTER_GROUP"] = saved
    return launches, line


def k5_render(preds, group):
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    means, quats, scales, opac, sh, w2c, Ks, HW = main_path_scene(preds)
    R.rasterize_flat.launches = R.rasterize_flat_grouped.launches = 0
    out, _, meta = rasterizer.rasterize(means, quats, scales, opac, sh, w2c, Ks, HW,
                                        HW, max_per_tile=RENDER_MPT,
                                        max_tiles_per_gauss=RENDER_TPG,
                                        payload_f16=True, device="cuda")
    torch.cuda.synchronize()
    launches = (R.rasterize_flat_grouped.launches, R.rasterize_flat.launches)
    if launches != (4, 0) or not torch.isfinite(out).all():
        raise AssertionError(f"K5 G={group} route: (K5, K2) launches {launches}")
    rows, k2_total = [], 0.0
    for c in range(w2c.shape[0]):
        bins = rasterizer.bin_camera(means, quats, scales, opac, sh, w2c[c], Ks[c],
                                     HW, HW, 16, RENDER_MPT, RENDER_TPG, True)
        starts, counts, extra = R.group_windows(bins.starts, bins.counts, group,
                                                RENDER_MPT, bins.packed.shape[1])
        args = (bins.packed, starts, counts, HW, HW, 16, 4, True)
        err = check_blend(f"K5 G={group} camera {c}",
                          lambda: R.rasterize_flat_grouped(*args, group),
                          lambda: R.rasterize_flat_grouped_plain(*args))
        img, alpha = R.rasterize_flat_grouped(*args, group)
        img2, alpha2 = R.rasterize_flat(*args)
        vs_k2 = max(float((img - img2).abs().max()), float((alpha - alpha2).abs().max()))
        if not (torch.equal(img, img2) and torch.equal(alpha, alpha2)):
            raise AssertionError(f"K5 G={group} camera {c}: differs from K2 on the same "
                                 f"clamped list by {vs_k2}")
        ms = cuda_ms(lambda: R.rasterize_flat_grouped(*args, group))
        k2_ms = cuda_ms(lambda: R.rasterize_flat(*args))
        plain_ms = cuda_ms(lambda: R.rasterize_flat_grouped_plain(*args), reps=2,
                           warmup=1)
        bound, by, _, _, _ = blend_bound(bins.packed, starts, counts, HW, HW, 4, True)
        log(f"K5 G={group:2d} camera {c}: extra_dropped {int(extra)}  max|d| vs plain "
            f"{err:.3e}, vs K2 on the same list {vs_k2:.3e}  kernel {ms:.4f} ms  "
            f"K2 {k2_ms:.4f} ms  plain {plain_ms:.2f} ms  bound {bound:.4f} ms ({by})")
        rows.append((err, ms, plain_ms, bound, by))
        k2_total += k2_ms
    out = totals(f"K5 G={group} per render of {w2c.shape[0]} cameras", rows)
    log(f"K5 G={group} per render: {out['ms']:.4f} ms against K2's {k2_total:.4f} ms on "
        f"the same clamped lists ({out['ms'] / k2_total:.4f}x)")
    return launches[0], out


def train_k5(train_inputs):
    """3 optimize_splats steps at WM_RASTER_GROUP=4 against G=1."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    splats, gt, c2w, Ks, depths = train_inputs
    cfg = splat_opt.SplatOptConfig(iters=3, refine_start=100)
    runs = {}
    for group in ("1", "4"):
        os.environ["WM_RASTER_GROUP"] = group
        steps, prev = [], [0, 0, 0]

        def on_step(info):
            now = [R.rasterize_flat_grouped.launches, R.rasterize_flat.launches,
                   R.rasterize_flat_bwd.launches]
            steps.append((float(info["loss"]), tuple(n - p for n, p in zip(now, prev)),
                          info["meta"]["n_dropped"].tolist()))
            prev[:] = now

        R.rasterize_flat_grouped.launches = R.rasterize_flat.launches = 0
        R.rasterize_flat_bwd.launches = 0
        splat_opt.optimize_splats(splats, gt, c2w, Ks, cfg, depths=depths,
                                  device="cuda", log_fn=lambda *a: None,
                                  on_step=on_step)
        runs[group] = steps
        log(f"training with WM_RASTER_GROUP={group}: losses "
            f"{[s[0] for s in steps]}, (K5, K2, K3) launches per step "
            f"{[s[1] for s in steps]}, n_dropped {[s[2] for s in steps]}")
    for (l1, _, d1), (l4, n4, d4) in zip(runs["1"], runs["4"]):
        if n4 != (4, 0, 4) or d1 != d4 or not abs(l4 - l1) <= 1e-5 * abs(l1):
            raise AssertionError(f"K5 training: G=4 {runs['4']} against G=1 {runs['1']}")


def phase_k4(preds):
    """K4: its ptxas report (fails on a stack frame or a spill), then the
    per-rank render of the multi-device path on one card."""
    from hunyuanworld_mirror_tpu_torch.ops import distributed, projection
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as B
    ptxas_check("rasterize_binned_fwd", "K4")
    means, quats, scales, opac, sh, w2c, Ks, HW = main_path_scene(preds)
    covars = projection.quat_scale_to_covar_planes(quats, scales)
    proj = distributed.project_for_cameras(means, covars, opac, sh, w2c, Ks, HW, HW)
    B.rasterize_binned.launches = 0
    out, alpha = distributed.render_local_cameras(*proj, HW, HW, 16, RENDER_MPT,
                                                  RENDER_TPG)
    torch.cuda.synchronize()
    launches = B.rasterize_binned.launches
    if launches != 4 or not torch.isfinite(out).all():
        raise AssertionError(f"K4 route: {launches} launches != 4")
    log(f"K4 route: render_local_cameras over {w2c.shape[0]} cameras, mean alpha "
        f"{float(alpha.mean()):.4f}")
    rows = []
    for c in range(w2c.shape[0]):
        m2d, con, dep, rad, col, op = (x[c] for x in proj)
        colors, bins = distributed.bin_local_camera(
            m2d, con, dep, rad, col, op, HW, HW, 16, RENDER_MPT, RENDER_TPG)
        rows.append(k4_check(f"K4 camera {c}", m2d, con, colors, op, bins, HW))
        del bins
    return launches, totals(f"K4 per render of {w2c.shape[0]} cameras", rows)


def k4_check(label, m2d, con, colors, op, bins, HW):
    """K4 against its plain version on one camera's dense bins, both timed,
    and its bound -> (err, ms, plain_ms, bound_ms, bound_by)."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned as B
    args = (m2d, con, colors, op, bins, HW, HW, 16)
    err = check_blend(label, lambda: B.rasterize_binned(*args),
                      lambda: B.rasterize_binned_plain(*args))
    ms = cuda_ms(lambda: B.rasterize_binned(*args))
    plain_ms = cuda_ms(lambda: B.rasterize_binned_plain(*args), reps=2, warmup=1)
    # the same blend as a flat list: the live slots' rows in tile order
    mpt = bins.gauss_ids.shape[1]
    live = torch.arange(mpt, device="cuda")[None, :] < bins.counts[:, None].long()
    table = B.splat_table(m2d, con, colors, op)
    packed = table[bins.gauss_ids[live].long()].T.contiguous()
    starts = (torch.cumsum(bins.counts.long(), 0) - bins.counts).to(torch.int32)
    bound, by, pairs, t_bytes, t_ops = blend_bound(
        packed, starts, bins.counts, HW, HW, 4, False, id_bytes=4,
        extra_bytes=-bins.counts.numel() * 4)
    log(f"{label}: live slots {int(bins.counts.sum())} of {mpt} a tile, n_dropped "
        f"{int(bins.n_dropped)}  pairs tested {pairs['forward']} kept {pairs['kept']}  "
        f"max|d| {err:.3e} (band {K2_BAND:.0e})  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.2f} ms  bound {bound:.4f} ms ({by}; bytes {t_bytes:.4f}, "
        f"operations {t_ops:.4f})")
    return err, ms, plain_ms, bound, by


# --- the card against the CPU ------------------------------------------------

def card_vs_cpu(label, cfg, cpu_state, imgs, cams, priors=None, cond_flags=(0, 0, 0)):
    """One forward of `cfg` with the weights `cpu_state` on the CPU (plain
    versions) and on the card, f32 trunk, the cameras substituted: the
    dense heads within 5e-3 of each other relative to 1 + |CPU|, the
    renders' median |d| below 5e-3 with under 5% of pixels past 5e-2."""
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirror
    cpu = WorldMirror(cfg, device="cpu")
    cpu.load_state_dict(cpu_state)
    gpu = WorldMirror(cfg, device="cuda")
    gpu.load_state_dict(cpu_state)
    views = {"img": torch.tensor(imgs), **(priors or {})}
    kw = dict(trunk_dtype=torch.float32, camera_params=torch.tensor(cams),
              cond_flags=cond_flags)
    ref = cpu(views, **kw)
    out = gpu({k: v.cuda() for k, v in views.items()},
              **{**kw, "camera_params": kw["camera_params"].cuda()})
    worst = {}
    for k in ("camera_params_pred", "depth", "pts3d", "normals", "gs_depth"):
        a, b = out[k].float().cpu(), ref[k].float()
        d = float(((a - b).abs() / (1 + b.abs())).max())
        worst[k] = d
        if not d <= 5e-3:
            raise AssertionError(f"card vs CPU, {label}: {k} rel max|d| {d} > 5e-3")
    d = (out["rendered_colors"].cpu() - ref["rendered_colors"]).abs()
    worst["rendered_colors_median"] = float(d.median())
    worst["rendered_colors_frac_gt_5e-2"] = float((d > 5e-2).float().mean())
    if not (worst["rendered_colors_median"] < 5e-3
            and worst["rendered_colors_frac_gt_5e-2"] < 0.05):
        raise AssertionError(f"card vs CPU, {label}: renders differ {worst}")
    log(f"card vs CPU (plain versions), small config, {label}: {json.dumps(worst)}")
    return ref


def phase_cpu_reference():
    """A 64-wide-head configuration, f32 trunk: the kernels on the card vs
    the plain versions on the CPU, same weights and inputs; then the prior
    path (cond 1, 1, 1: the cameras as poses and intrinsics, the first
    forward's depth as the depth map), the splat means from the given
    cameras (gsdepth+gtcamera), bf16 heads and the heads in frame groups of
    one."""
    from dataclasses import replace
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import (WorldMirror,
                                                                  WorldMirrorConfig)
    cfg = WorldMirrorConfig(img_size=112, embed_dim=512, trunk_heads=8,
                            patch_embed="conv", trunk_depth=2, gs_dim=32,
                            intermediate_idxs=(0, 1, 1, 1), dpt_features=32,
                            dpt_out_channels=(32, 48, 64, 64))
    state = WorldMirror(cfg, device="cpu", seed=3).state_dict()
    imgs = np.random.default_rng(1).uniform(size=(1, 2, 112, 112, 3)).astype(np.float32)
    cams = fixed_cameras(2)
    ref = card_vs_cpu("no priors", cfg, state, imgs, cams)
    priors = prior_views(cams, (112, 112), ref["depth"][..., 0])
    card_vs_cpu("priors, cond 1,1,1", cfg, state, imgs, cams, priors, (1, 1, 1))
    card_vs_cpu("gsdepth+gtcamera", replace(cfg, gs_position_from="gsdepth+gtcamera"),
                state, imgs, cams, priors)
    card_vs_cpu("bf16 heads", replace(cfg, head_dtype="bfloat16"), state, imgs, cams)
    card_vs_cpu("head_chunk 1", replace(cfg, head_chunk=1), state, imgs, cams)


# --- phase 12: the CLI's remaining flags --------------------------------------

def reset_counts():
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned, rasterizer_flat
    from hunyuanworld_mirror_tpu_torch.ops.attention import attention
    attention.launches = attention.flash_route_launches = attention.f32_launches = 0
    rasterizer_flat.rasterize_flat.launches = 0
    rasterizer_binned.rasterize_binned.launches = 0


def read_counts():
    """(K1, K1 at N >= 4096, K2, K4) launches since reset_counts."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned, rasterizer_flat
    from hunyuanworld_mirror_tpu_torch.ops.attention import attention
    torch.cuda.synchronize()
    return (attention.launches, attention.flash_route_launches,
            rasterizer_flat.rasterize_flat.launches,
            rasterizer_binned.rasterize_binned.launches)


def counted_forward(label, model, imgs, cams, want):
    """One forward with every count set to 0 just before and read just
    after; fails unless (K1, K1 at N >= 4096, K2, K4) == want."""
    from hunyuanworld_mirror_tpu_torch.infer import reconstruct
    reset_counts()
    preds = reconstruct(model, imgs, cams)
    got = read_counts()
    log(f"{label} forward: launches (K1, K1 at N >= 4096, K2, K4) {got}; "
        f"intersections {preds['render_n_isects'].tolist()}  n_dropped "
        f"{preds['render_n_dropped'].tolist()}  mean alpha "
        f"{float(preds['rendered_alphas'].mean()):.4f}")
    if got != want:
        raise AssertionError(f"{label} forward: launches {got} != {want}")
    for k in ("rendered_colors", "rendered_alphas", "rendered_depths"):
        if not torch.isfinite(preds[k]).all():
            raise AssertionError(f"{label} forward: {k} is not finite")
    return preds


def render_diff(label, preds, ref):
    """RGB and alpha of two renders: max, median and the share of pixels
    with |d| > 1e-3 in any channel."""
    d = torch.cat([preds["rendered_colors"] - ref["rendered_colors"],
                   preds["rendered_alphas"] - ref["rendered_alphas"]], -1).abs()
    diff = dict(max=float(d.max()), median=float(d.median()),
                share_gt_1e_3=float((d.amax(-1) > 1e-3).float().mean()))
    log(f"{label} render vs the flat route's (RGB and alpha): {json.dumps(diff)}")
    if not diff["median"] < 1e-3:
        raise AssertionError(f"{label}: render differs from the flat route's {diff}")
    return diff


def gs_render_ms(label, model, imgs, cams):
    from hunyuanworld_mirror_tpu_torch.infer import reconstruct
    med = {}
    timed_forwards(label, lambda marks: reconstruct(model, imgs, cams, marks=marks),
                   medians=med)
    return med["gs_render"], med["total"]


def phase_cli_flags(imgs):
    """Phase 12: the CLI's remaining flags on one model of phase 5's
    configuration and weights (`large`, seed 0), phase 5's images and fixed
    cameras. The render's route is switched on the model's renderer config
    between forwards. (a) rasterizer_impl="jax" (--rasterizer jax), (b)
    slot_fracs="auto" (--fast-binning), (c) the novel-view trajectory of
    --video, (d) bundle adjustment (--ba), (e) the CLI's main() with the GLB
    flags, --ba and --fast-binning -> the numbers for the kernels line."""
    from dataclasses import replace
    from hunyuanworld_mirror_tpu_torch.infer import PRESETS, load_model, reconstruct
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig
    S, HW = imgs.shape[1], imgs.shape[2]
    cams = fixed_cameras(S)
    model = load_model(WorldMirrorConfig(**PRESETS["large"]), device="cuda")
    base = model.gs_renderer.cfg
    reconstruct(model, imgs, cams)                                 # warm-up
    flat = counted_forward("flat route", model, imgs, cams, (88, 24, 4, 0))
    out = {"gs_render_ms": {}, "total_ms": {}}
    out["gs_render_ms"]["flat"], out["total_ms"]["flat"] = gs_render_ms(
        "flat route", model, imgs, cams)

    model.gs_renderer.cfg = replace(base, rasterizer_impl="jax")
    out["k4_forward"], out["diff_jax"] = cli_jax_route(model, imgs, cams, flat)
    out["gs_render_ms"]["jax"], out["total_ms"]["jax"] = gs_render_ms(
        "rasterizer_impl=jax", model, imgs, cams)

    model.gs_renderer.cfg = replace(base, slot_fracs="auto")
    out["k2_prefix"], out["diff_auto"], out["rows"] = cli_prefix_route(
        model, imgs, cams, flat)
    out["gs_render_ms"]["auto"], out["total_ms"]["auto"] = gs_render_ms(
        "slot_fracs=auto", model, imgs, cams)
    model.gs_renderer.cfg = base
    log(f"gs_render median ms over 7 forwards: {json.dumps(out['gs_render_ms'])}; "
        f"forward total median ms: {json.dumps(out['total_ms'])}")
    del model

    out["video"] = cli_video(flat)
    out["ba"] = cli_ba(flat)
    cli_main(imgs)
    return out


def cli_jax_route(model, imgs, cams, flat):
    """(a): one forward on the dense-bin route (4 K4, 0 K2), its render
    against the flat route's, and K4 against its plain version on each
    camera's dense bins as the route makes them (tight radii, the exact
    test, 4096 a tile, 4 tiles a splat)."""
    from hunyuanworld_mirror_tpu_torch.ops import projection, rasterizer, tiles
    preds = counted_forward("rasterizer_impl=jax", model, imgs, cams, (88, 24, 0, 4))
    diff = render_diff("rasterizer_impl=jax (f32 payload, K4)", preds, flat)
    means, quats, scales, opac, sh, w2c, Ks, HW = main_path_scene(preds)
    covars = projection.quat_scale_to_covar_planes(quats, scales)
    mpt = rasterizer._capped(RENDER_MPT, means.shape[0], RENDER_TPG)
    rows = []
    for c in range(w2c.shape[0]):
        m2d, con, col, rad, dep = rasterizer.project_camera(
            means, covars, opac, sh, w2c[c], Ks[c], HW, HW)
        bins = tiles.bin_gaussians(m2d, rad, dep, 16, 33, 33, RENDER_TPG, mpt,
                                   conic_test=tiles.conic_test_planes(con, opac))
        rows.append(k4_check(f"K4 --rasterizer jax camera {c}", m2d, con, col, opac,
                             bins, HW))
        del bins
    del preds
    return totals("K4 per forward on the --rasterizer jax path", rows), diff


def cli_prefix_route(model, imgs, cams, flat):
    """(b): one forward with slot_fracs="auto" (4 K2), the sorted rows a
    camera against the exact binning's, its render against the exact
    route's, and K2 against its plain version on the 4 prefix lists."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer
    preds = counted_forward("slot_fracs=auto", model, imgs, cams, (88, 24, 4, 0))
    diff = render_diff("slot_fracs=auto", preds, flat)
    means, quats, scales, opac, sh, w2c, Ks, HW = main_path_scene(preds)
    rows, sorted_rows = [], []
    for c in range(w2c.shape[0]):
        kw = (means, quats, scales, opac, sh, w2c[c], Ks[c], HW, HW, 16, RENDER_MPT,
              RENDER_TPG, True)
        exact = rasterizer.bin_camera(*kw)
        bins = rasterizer.bin_camera(*kw, slot_fracs="auto")
        sorted_rows.append((bins.packed.shape[1], exact.packed.shape[1]))
        if c == 0:
            bin_ms = (cuda_ms(lambda: rasterizer.bin_camera(*kw, slot_fracs="auto"),
                              reps=5, warmup=1),
                      cuda_ms(lambda: rasterizer.bin_camera(*kw), reps=5, warmup=1))
        if not torch.equal(bins.counts, exact.counts) and int(bins.n_dropped) == int(
                exact.n_dropped):
            raise AssertionError(f"prefix camera {c}: counts differ, none dropped")
        err, ms, plain_ms, bound, by, _ = k2_check(f"prefix camera {c}", bins, HW, HW,
                                                   4, True)
        rows.append((err, ms, plain_ms, bound, by))
        del exact, bins
    log(f"slot_fracs=auto: sorted rows a camera (prefix, exact) {sorted_rows}, "
        f"ratio {np.mean([a / b for a, b in sorted_rows]):.4f}; render_n_dropped "
        f"{preds['render_n_dropped'].tolist()}; camera 0's projection and binning "
        f"(bin_camera) {bin_ms[0]:.3f} ms with the prefixes, {bin_ms[1]:.3f} ms exact")
    if not all(a < b for a, b in sorted_rows):
        raise AssertionError(f"prefix binning sorted no fewer rows: {sorted_rows}")
    del preds
    return (totals("K2 per forward on the --fast-binning path", rows), diff,
            dict(sorted_rows=sorted_rows, bin_camera_ms=bin_ms))


def frames_ok(label, frames, n):
    if frames.shape[0] != n or not np.isfinite(frames).all():
        raise AssertionError(f"{label}: {frames.shape[0]} frames or not finite")
    lit = (frames.sum(-1) > 0).mean(axis=(1, 2))
    return lit


def cli_video(flat):
    """(c): the interpolated trajectory through phase 5's cameras (46
    frames at S = 4) rendered from the flat forward's splats (46 K2
    launches), timed; K2 against its plain version on frame 0's list (f32
    payload, 9 tiles a splat, 4096 a tile, as render_trajectory bins it);
    then 3 frames with the spread effect (3 K2) and 3 on impl="jax" (3 K4).
    No cv2: the mp4 writer is not run here."""
    from hunyuanworld_mirror_tpu_torch.io import effects
    from hunyuanworld_mirror_tpu_torch.io import render as V
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer
    from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils
    HW = flat["depth"].shape[2]
    c2w = flat["camera_poses"][0].float().cpu().numpy()
    Ks = flat["camera_intrs"][0].float().cpu().numpy()
    traj, traj_K = V.interpolate_trajectory(c2w, Ks)
    T = len(traj)
    splats = {k: flat["splats"][k][0] for k in V.SPLAT_KEYS}
    V.render_trajectory(splats, traj[:2], traj_K[:2], HW, HW, device="cuda")  # warm-up
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.time()
    start.record()
    frames, depths = V.render_trajectory(splats, traj, traj_K, HW, HW, device="cuda")
    end.record()
    got = read_counts()
    wall = time.time() - t0
    event_ms = start.elapsed_time(end)
    lit = frames_ok("video", frames, T)
    log(f"video: {T} frames at {HW} px, launches (K1, K1 flash, K2, K4) {got}; "
        f"{wall * 1e3 / T:.2f} ms a frame wall, {event_ms / T:.2f} ms a frame by CUDA "
        f"events (frames copied to the host included); lit share per frame min "
        f"{lit.min():.4f} mean {lit.mean():.4f}; depth range "
        f"{float(depths.min()):.3f}..{float(depths.max()):.3f}")
    if got != (0, 0, T, 0) or T != 46 or not lit.min() > 0.01:
        raise AssertionError(f"video: {T} frames, launches {got}, lit {lit.min()}")
    means, quats = splats["means"], splats["quats"][:, [1, 2, 3, 0]]
    w2c0 = cam_utils.se3_inverse(torch.as_tensor(traj[0], device="cuda"))
    bins = rasterizer.bin_camera(means, quats, splats["scales"], splats["opacities"],
                                 splats["sh"], w2c0, torch.as_tensor(traj_K[0],
                                                                     device="cuda"),
                                 HW, HW, 16, 4096, 9, False)
    err, ms, plain_ms, bound, by, _ = k2_check("video frame 0", bins, HW, HW, 4, False)
    del bins
    np_splats = {k: v.float().cpu().numpy() for k, v in splats.items()}
    rng = np.random.default_rng(0)
    reset_counts()
    fx = [V.render_trajectory(effects.apply_effect(np_splats, 10.0 * i / (T - 1),
                                                   "spread", rng),
                              traj[i:i + 1], traj_K[i:i + 1], HW, HW,
                              device="cuda")[0] for i in range(3)]
    got_fx = read_counts()
    frames_ok("spread", np.concatenate(fx), 3)
    reset_counts()
    fj, _ = V.render_trajectory(splats, traj[:3], traj_K[:3], HW, HW, impl="jax",
                                device="cuda")
    got_j = read_counts()
    lit_j = frames_ok("video impl=jax", fj, 3)
    d = float(np.abs(fj - frames[:3]).max())
    log(f"video, 3 frames with effect spread: launches {got_fx}; 3 frames on "
        f"impl=jax: launches {got_j}, lit min {lit_j.min():.4f}, max|d| vs the flat "
        f"route's frames {d:.3e}")
    if got_fx != (0, 0, 3, 0) or got_j != (0, 0, 0, 3):
        raise AssertionError(f"video variants: launches {got_fx}, {got_j}")
    return dict(frames=T, launches=got[2], ms_per_frame_wall=wall * 1e3 / T,
                ms_per_frame_events=event_ms / T, k2_frame=dict(
                    err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by))


def cli_ba(flat):
    """(d): refine_cameras on the flat forward's predictions, 12 iterations,
    stride 16 (M = 4 x 33 x 33 landmarks), timed, the cost not raised and
    cost0 within 1e-4 relative of the same call on the CPU. Random weights
    give point maps no other view's depth agrees with (no landmark is seen
    twice, cost 0), so the same is then done on a bundle made consistent
    from the same forward: pts3d its depth, with 1% noise, unprojected
    through its cameras; there the cost must fall."""
    from hunyuanworld_mirror_tpu_torch.utils import geometry
    keys = ("pts3d", "pts3d_conf", "depth", "camera_poses", "camera_intrs")
    sub = {k: flat[k].float() for k in keys}
    out = {"predictions": ba_run("predictions", sub)}
    d = sub["depth"][0, ..., 0]
    g = torch.Generator(device="cuda").manual_seed(5)
    noisy = d * (1 + 0.01 * torch.randn(d.shape, generator=g, device="cuda"))
    pts, _, _ = geometry.depth_to_world_coords_points(noisy, sub["camera_poses"][0],
                                                      sub["camera_intrs"][0])
    out["consistent"] = ba_run("consistent bundle", {**sub, "pts3d": pts[None]})
    if not (out["consistent"]["observations"] > 0
            and out["consistent"]["cost"] < out["consistent"]["cost0"]):
        raise AssertionError(f"BA on the consistent bundle: {out['consistent']}")
    return out


def ba_run(label, sub):
    from hunyuanworld_mirror_tpu_torch.refine import ba
    ba.refine_cameras(sub, iters=1)                                # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.time()
    start.record()
    out = ba.refine_cameras(sub, stride=16, iters=12)
    end.record()
    torch.cuda.synchronize()
    wall_ms, event_ms = (time.time() - t0) * 1e3, start.elapsed_time(end)
    cost0, cost = float(out["ba_cost0"]), float(out["ba_cost"])
    cpu = ba.refine_cameras({k: v.cpu() for k, v in sub.items()}, stride=16, iters=12)
    cpu0 = float(cpu["ba_cost0"])
    tracks = ba.build_tracks(sub["pts3d"][0], sub["pts3d_conf"][0],
                             sub["depth"][0, ..., 0],
                             torch.linalg.inv(sub["camera_poses"][0]),
                             sub["camera_intrs"][0])
    moved = float((out["camera_poses"] - sub["camera_poses"]).abs().max())
    log(f"BA on the {label}: {tracks.mask.shape[0]} landmarks, "
        f"{int(tracks.mask.sum())} observations; cost {cost0:.6e} -> {cost:.6e} (CPU: "
        f"{cpu0:.6e} -> {float(cpu['ba_cost']):.6e}); {wall_ms:.2f} ms wall, "
        f"{event_ms:.2f} ms by CUDA events for 12 iterations; max|pose change| "
        f"{moved:.3e}")
    if not (torch.isfinite(out["camera_poses"]).all() and cost <= cost0
            and abs(cost0 - cpu0) <= 1e-4 * abs(cpu0)):
        raise AssertionError(f"BA on the {label}: cost {cost0} -> {cost}, CPU cost0 "
                             f"{cpu0}")
    return dict(cost0=cost0, cost=cost, wall_ms=wall_ms, event_ms=event_ms,
                landmarks=int(tracks.mask.shape[0]), observations=int(tracks.mask.sum()))


def cli_main(imgs):
    """(e): the CLI's main() on a .npy of the images with --glb --glb-mesh
    --mask-sky --ba --ba-iters 4 --fast-binning (the large preset, 518 px):
    every file written, scene.glb a valid glTF header, and the forward's
    launches as in (b). Its files go to build/smoke_cli/ of this checkout."""
    import shutil
    from pathlib import Path
    from hunyuanworld_mirror_tpu_torch import infer
    root = Path(__file__).resolve().parent / "build" / "smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    np.save(root / "views.npy", imgs[0])
    out = root / "out"
    reset_counts()
    t0 = time.time()
    infer.main([str(root / "views.npy"), "-o", str(out), "--glb", "--glb-mesh",
                "--mask-sky", "--ba", "--ba-iters", "4", "--fast-binning"])
    got = read_counts()
    S = imgs.shape[1]
    want = (["points.ply", "camera_params.json", "gaussians.ply", "gaussians.splat",
             "scene.glb", "sparse/cameras.bin", "sparse/images.bin",
             "sparse/points3D.bin"]
            + [f"{k}_{s:03d}.{e}" for s in range(S)
               for k, e in (("depth", "png"), ("depth", "npy"), ("normal", "png"))])
    missing = [n for n in want if not (out / n).is_file()]
    glb = (out / "scene.glb").read_bytes() if (out / "scene.glb").is_file() else b""
    header_ok = (len(glb) > 20 and glb[:4] == b"glTF"
                 and int.from_bytes(glb[4:8], "little") == 2
                 and int.from_bytes(glb[8:12], "little") == len(glb))
    log(f"CLI main() --glb --glb-mesh --mask-sky --ba --ba-iters 4 --fast-binning: "
        f"{time.time() - t0:.1f} s wall incl. model build; launches (K1, K1 flash, "
        f"K2, K4) {got}; {len(want) - len(missing)} of {len(want)} files, scene.glb "
        f"{len(glb)} bytes")
    if got != (88, 24, 4, 0) or missing or not header_ok:
        raise AssertionError(f"CLI main(): launches {got}, missing {missing}, glTF "
                             f"header ok {header_ok}")
    shutil.rmtree(root, ignore_errors=True)


# --- phase 13: the trainer's remaining flags ---------------------------------

def train_counts():
    """(K2, K3, K4) launch counts."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned, rasterizer_flat
    return (rasterizer_flat.rasterize_flat.launches,
            rasterizer_flat.rasterize_flat_bwd.launches,
            rasterizer_binned.rasterize_binned.launches)


def reset_train_counts():
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned, rasterizer_flat
    rasterizer_flat.rasterize_flat.launches = 0
    rasterizer_flat.rasterize_flat_bwd.launches = 0
    rasterizer_binned.rasterize_binned.launches = 0


def counted_training(label, train_inputs, cfg, want, extra=None):
    """optimize_splats on phase 8's inputs with the (K2, K3, K4) counts set
    to 0 just before and read after every step -> (steps, output, wall s,
    peak GB). Fails unless every step launches `want` and every loss is
    finite. `extra(info)` adds a value to each step's record."""
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    splats, gt, c2w, Ks, depths = train_inputs
    steps, prev = [], [(0, 0, 0)]

    def on_step(info):
        now = train_counts()
        m = info["marks"]
        steps.append({"it": info["it"], "loss": float(info["loss"]),
                      "launches": tuple(a - b for a, b in zip(now, prev[0])),
                      "alive": int((info["raw"]["alive"] > 0.5).sum()),
                      "slots": tuple(info["raw"]["means"].shape),
                      "refined": info["refined"],
                      "n_dropped": (info["meta"]["n_dropped"].tolist()
                                    if "n_dropped" in info["meta"] else None),
                      "phases": {name: m[j - 1][1].elapsed_time(ev)
                                 for j, (name, ev) in enumerate(m) if j},
                      "extra": extra(info) if extra else None})
        prev[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    t0 = time.time()
    out = splat_opt.optimize_splats(splats, gt, c2w, Ks, cfg, depths=depths,
                                    device="cuda", log_fn=log, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [s["loss"] for s in steps]
    log(f"{label}: {len(steps)} steps in {wall:.2f} s wall, peak memory "
        f"{peak:.2f} GB; losses first {losses[0]:.5f} last {losses[-1]:.5f}; "
        f"(K2, K3, K4) launches per step {sorted({s['launches'] for s in steps})}; "
        f"n_dropped first step {steps[0]['n_dropped']}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    if any(s["launches"] != want for s in steps):
        raise AssertionError(f"{label}: launches {[s['launches'] for s in steps]} "
                             f"!= {want} a step")
    return steps, out, wall, peak


def step_medians(label, steps, names):
    """Medians over the steps without a refine of each phase in `names` and
    of the whole step."""
    plain = [s["phases"] for s in steps if not s["refined"]]
    med = {k: float(np.median([p[k] for p in plain])) for k in names}
    med["total"] = float(np.median([sum(p.values()) for p in plain]))
    log(f"{label} step (median of {len(plain)} steps without a refine): "
        + "  ".join(f"{k} {v:.2f} ms" for k, v in med.items()))
    return med


def phase_trainer_flags(preds, imgs, train_inputs, ref):
    """Phase 13: the trainer's remaining flags on phase 8's training inputs
    (510,964 splats in 1,021,928 slots, 4 cameras at 518 px, 4096 a tile):
    (a) strategy="mcmc" with selective Adam, (b) pose_opt + random_bkgd +
    use_bilateral_grid, (c) rasterizer_impl="jax", (d) the CLI's main() on
    a COLMAP directory with every flag -> the numbers for the kernels line."""
    selective_adam_rows(train_inputs)
    out = {"mcmc": train_mcmc(train_inputs, ref),
           "options": train_options(train_inputs, ref)}
    t0 = time.time()
    out["jax"] = train_jax_route(train_inputs, ref)
    log(f"(c) rasterizer_impl=jax: {time.time() - t0:.1f} s wall")
    trainer_cli(preds, imgs)
    return out


def selective_adam_rows(train_inputs):
    """One selective-Adam step, no regulariser, on phase 8's inputs: every
    row whose gradient K3 left all zero keeps its value bit for bit (the
    count of such live rows is printed; the dead slots are among them)."""
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils
    splats, gt, c2w, Ks, _ = train_inputs
    HW = gt.shape[1]
    cfg = splat_opt.SplatOptConfig(use_selective_adam=True)
    raw = splat_opt._raw_from_splats(
        {k: torch.as_tensor(v, device="cuda") for k, v in splats.items()},
        2 * len(splats["means"]))
    before = {k: raw[k].detach().clone() for k in splat_opt.PARAM_KEYS}
    opt = splat_opt.make_optimizer(cfg, raw)
    step = splat_opt.make_train_step(cfg, HW, HW, device="cuda")
    step(raw, opt, cam_utils.se3_inverse(torch.as_tensor(c2w, device="cuda")),
         torch.as_tensor(Ks, device="cuda"), torch.as_tensor(gt, device="cuda"))
    live = raw["alive"] > 0.5
    counts, bad = {}, 0
    for k in splat_opt.PARAM_KEYS:
        n = raw[k].shape[0]
        hidden = ~(raw[k].grad.reshape(n, -1) != 0).any(dim=1)
        same = (raw[k].detach() == before[k]).reshape(n, -1).all(dim=1)
        bad += int((hidden & ~same).sum())
        counts[k] = (int((hidden & live).sum()), int((~hidden & same).sum()))
    log(f"selective Adam, one step: (live rows with an all-zero gradient, rows "
        f"with a gradient that did not move) per parameter {counts}; "
        f"zero-gradient rows that moved {bad}")
    if bad:
        raise AssertionError("selective Adam moved a row K3 never touched")


def train_mcmc(train_inputs, ref):
    """(a): 30 steps, refines at 19 and 29; each refine grows the live count
    by exactly min(floor(0.05 n_alive), free slots)."""
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    cfg = splat_opt.SplatOptConfig(iters=30, refine_start=10, refine_every=10,
                                   refine_stop=30, strategy="mcmc",
                                   use_selective_adam=True)
    steps, _, _, _ = counted_training("(a) mcmc + selective Adam", train_inputs, cfg,
                                      (4, 4, 0))
    capacity = steps[0]["slots"][0]
    alive = [len(train_inputs[0]["means"])] + [s["alive"] for s in steps]
    for i, s in enumerate(steps):
        grow = (min(int(np.floor(np.float32(alive[i]) * np.float32(0.05))),
                    capacity - alive[i]) if s["refined"] else 0)
        if s["refined"]:
            log(f"(a) refine at step {s['it']}: {s['phases']['refine']:.2f} ms, live "
                f"{alive[i]} -> {alive[i + 1]} (+{grow} expected)")
        if alive[i + 1] - alive[i] != grow:
            raise AssertionError(f"(a) step {s['it']}: live {alive[i]} -> "
                                 f"{alive[i + 1]}, expected +{grow}")
    losses = [s["loss"] for s in steps]
    if [s["it"] for s in steps if s["refined"]] != [19, 29] or \
            any(s["slots"] != (capacity, 3) for s in steps) or not losses[-1] < losses[0]:
        raise AssertionError(f"(a): refines, slots or losses {losses}")
    med = step_medians("(a) mcmc", steps, ("render_forward", "backward",
                                           "optimizer", "noise"))
    log(f"(a) mcmc step median {med['total']:.2f} ms against phase 8's default "
        f"step {ref['median_ms']:.2f} ms ({med['total'] / ref['median_ms']:.3f}x)")
    return {"launches": 4, "step_ms": med["total"], "phases_ms": med}


def train_options(train_inputs, ref):
    """(b): pose_opt, random_bkgd and use_bilateral_grid together, 10 steps:
    the deltas move off zero and the grids' gradients are not zero."""
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    cfg = splat_opt.SplatOptConfig(iters=10, pose_opt=True, random_bkgd=True,
                                   use_bilateral_grid=True)

    def extra(info):
        raw = info["raw"]
        return (float(raw["cam_deltas"].detach().abs().max()),
                float(raw["bil_grids"].grad.abs().sum()))

    steps, out, _, _ = counted_training("(b) pose + background + bilateral grid",
                                        train_inputs, cfg, (4, 4, 0), extra)
    moved, grid_grads = steps[-1]["extra"][0], [s["extra"][1] for s in steps]
    log(f"(b) max |cam_deltas| after 10 steps {moved:.3e}; grids' |grad| sums "
        f"{min(grid_grads):.3e}..{max(grid_grads):.3e}; c2w_opt finite "
        f"{bool(np.isfinite(out['c2w_opt']).all())}")
    if not (moved > 0 and min(grid_grads) > 0 and np.isfinite(out["c2w_opt"]).all()):
        raise AssertionError("(b): the deltas did not move or the grids got no gradient")
    med = step_medians("(b) pose + background + bilateral grid", steps,
                       ("rasterize", "bilagrid", "render_forward", "backward",
                        "optimizer"))
    log(f"(b) step median {med['total']:.2f} ms against phase 8's default step "
        f"{ref['median_ms']:.2f} ms ({med['total'] / ref['median_ms']:.3f}x); the "
        f"bilateral grid's slice {med['bilagrid']:.2f} ms")
    return {"launches": 4, "step_ms": med["total"], "phases_ms": med}


def jax_route_bins(train_inputs, max_per_tile):
    """Step 0's dense bins on the jax route, as rasterize bins them ->
    [(m2d, con, col, op, bins)] for each camera."""
    from hunyuanworld_mirror_tpu_torch.ops import projection, rasterizer, tiles
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    from hunyuanworld_mirror_tpu_torch.utils import camera as cam_utils
    splats, gt, c2w, Ks, _ = train_inputs
    HW = gt.shape[1]
    n = len(splats["means"])
    raw = splat_opt._raw_from_splats(
        {k: torch.as_tensor(v, device="cuda") for k, v in splats.items()}, 2 * n)
    means, quats, scales, opac, sh = splat_opt._activate(raw)
    covars = projection.quat_scale_to_covar_planes(quats[:, [1, 2, 3, 0]], scales)
    w2c = cam_utils.se3_inverse(torch.as_tensor(c2w, device="cuda"))
    Ks_t = torch.as_tensor(Ks, device="cuda")
    mpt = rasterizer._capped(max_per_tile, 2 * n, 9)
    tw = (HW + 15) // 16
    out = []
    for c in range(len(c2w)):
        m2d, con, col, rad, dep = rasterizer.project_camera(
            means, covars, opac, sh, w2c[c], Ks_t[c], HW, HW)
        bins = tiles.bin_gaussians(m2d, rad, dep, 16, tw, tw, 9, mpt,
                                   conic_test=tiles.conic_test_planes(con, opac))
        out.append((m2d, con, col, opac, bins))
    return out


def train_jax_route(train_inputs, ref):
    """(c): rasterizer_impl="jax", 3 steps (4 K4, no K2 or K3 a step); K4
    against its plain version on step 0's dense bins; step 0's loss against
    the default route's (phase 8) where neither drops an intersection; the
    step's time and peak memory. If the plain backward does not fit at
    max_per_tile 4096, the run is recorded and repeated at 2048."""
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    HW = train_inputs[1].shape[1]
    with torch.no_grad():
        rows = [k4_check(f"(c) K4 on step 0's dense bins, camera {c}", *b, HW)
                for c, b in enumerate(jax_route_bins(train_inputs, 4096))]
    k4 = totals("(c) K4 per training step's forward (4 cameras)", rows)
    for mpt in (4096, 2048):
        cfg = splat_opt.SplatOptConfig(iters=3, rasterizer_impl="jax",
                                       max_per_tile=mpt)
        try:
            steps, _, wall, peak = counted_training(
                f"(c) rasterizer_impl=jax, max_per_tile {mpt}", train_inputs, cfg,
                (0, 0, 4))
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"(c) max_per_tile {mpt}: out of device memory ({e}); peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            torch.cuda.empty_cache()
    med = step_medians(f"(c) rasterizer_impl=jax, max_per_tile {mpt}", steps,
                       ("render_forward", "backward", "optimizer"))
    loss0, dropped0 = steps[0]["loss"], steps[0]["n_dropped"]
    log(f"(c) step 0 loss {loss0:.7f} (n_dropped {dropped0}) against the default "
        f"route's {ref['loss0']:.7f} (n_dropped {ref['dropped0']}): relative "
        f"{abs(loss0 - ref['loss0']) / abs(ref['loss0']):.3e}; step median "
        f"{med['total']:.2f} ms against phase 8's {ref['median_ms']:.2f} ms "
        f"({med['total'] / ref['median_ms']:.2f}x); peak {peak:.2f} GB")
    if not (mpt == 4096 and not any(dropped0) and not any(ref["dropped0"])
            and abs(loss0 - ref["loss0"]) <= 1e-4 * abs(ref["loss0"])):
        raise AssertionError(f"(c): step 0 loss {loss0} (n_dropped {dropped0}, "
                             f"max_per_tile {mpt}) against {ref['loss0']} "
                             f"(n_dropped {ref['dropped0']})")
    return {**k4, "launches": 4, "forward_ms": med["render_forward"],
            "plain_backward_ms": med["backward"], "step_ms": med["total"],
            "peak_gb": peak, "max_per_tile": mpt, "wall_s": wall}


def trainer_cli(preds, imgs):
    """(d): the CLI's main() on a COLMAP directory (infer.export's sparse/
    and gaussians.ply, the 4 images as PNGs) with every flag but --video
    (phase 16 writes an mp4 through the app twin) and --gs2d. --test-every 2 trains on 2 of
    the 4 views, so a step launches 2 K2 and 2 K3; each in-loop eval and the
    final eval render the 2 held-out views (2 K2). The viewer's endpoints
    are fetched once, just before it closes. Its files go to
    build/smoke_trainer/ of this checkout."""
    import shutil
    import urllib.request
    from pathlib import Path
    from PIL import Image
    from hunyuanworld_mirror_tpu_torch import splat_trainer
    from hunyuanworld_mirror_tpu_torch.infer import export
    from hunyuanworld_mirror_tpu_torch.training import live_viewer, tb_writer
    root = Path(__file__).resolve().parent / "build" / "smoke_trainer"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    export(preds, imgs, data, log=lambda *a: None)
    (data / "images").mkdir()
    for i, img in enumerate(imgs[0]):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            data / "images" / f"frame_{i + 1}", format="PNG")
    fetched = {}
    close = live_viewer.LiveViewer.close

    def fetch_then_close(viewer):
        for path in ("/", "/out/live/live_status.json", "/out/live/live.splat"):
            with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}",
                                        timeout=30) as r:
                fetched[path] = r.read()
        close(viewer)

    iters, evals = 30, 3
    live_viewer.LiveViewer.close = fetch_then_close
    try:
        reset_train_counts()
        t0 = time.time()
        splat_trainer.main(
            ["--colmap", str(data), "--normalize", "--iters", str(iters),
             "--strategy", "mcmc", "--selective-adam", "--pose-opt", "--random-bkgd",
             "--bilateral-grid", "--test-every", "2", "--eval-every", "10",
             "--tb", str(root / "tb"), "--compress", "--viewer"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        live_viewer.LiveViewer.close = close
    got = train_counts()
    want = (2 * iters + 2 * evals + 2, 2 * iters, 0)
    missing = [n for n in ("gaussians_opt.ply", "cameras_opt.npz",
                           "compressed/meta.json") if not (data / n).is_file()]
    events = sorted((root / "tb").glob("events.out.tfevents.*"))
    psnr_steps = ([s for s, v in tb_writer.read_scalars(str(events[0]))
                   if "eval/psnr" in v] if events else [])
    status = json.loads(fetched.get("/out/live/live_status.json", b"{}"))
    log(f"(d) CLI main() --colmap --normalize --iters {iters} --strategy mcmc "
        f"--selective-adam --pose-opt --random-bkgd --bilateral-grid --test-every 2 "
        f"--eval-every 10 --tb --compress --viewer: {wall:.1f} s wall; (K2, K3, K4) "
        f"launches {got} (expected {want}: 2 + 2 a step); eval/psnr at steps "
        f"{psnr_steps}; viewer page {len(fetched.get('/', b''))} bytes, status "
        f"{status}, snapshot {len(fetched.get('/out/live/live.splat', b''))} bytes; "
        f"missing files {missing}")
    if (got != want or missing or psnr_steps != [10, 20, 30]
            or b"live" not in fetched.get("/", b"") or status.get("step") != iters
            or not fetched.get("/out/live/live.splat")):
        raise AssertionError("(d): the CLI's main() on the COLMAP directory failed "
                             "a check")
    shutil.rmtree(root, ignore_errors=True)


# --- phase 14: camera models, render modes, eval3d, indices, 2DGS ------------

def ut_routes(w2c, Ks):
    """The four UT routes of phase 14 as rasterize's keywords, for 518 px
    cameras of focal Ks[0, 0, 0]: fisheye (k1..k4), OpenCV radial and
    tangential, f-theta (the published NVIDIA calibration's polynomials
    rescaled to this focal) and a top-to-bottom rolling shutter whose end
    pose is shifted 5 cm along x."""
    from hunyuanworld_mirror_tpu_torch.ops import cameras
    C, dev = w2c.shape[0], w2c.device
    s = float(Ks[0, 0, 0]) / 118.43232
    a2p = tuple(c * s for c in (0.0, 118.43232, -2.562147, 6.317949, -10.41861,
                                3.6694396))
    p2a = tuple(c / s ** i for i, c in enumerate(
        (0.0, 8.4335003e-03, 2.3174282e-06, -5.0478608e-08, 6.1392608e-10,
         -1.7447865e-12)))
    rs = w2c.clone()
    rs[:, 0, 3] += 0.05

    def per_camera(*v):
        return torch.tensor([v], device=dev).expand(C, -1).contiguous()

    return {
        "fisheye": dict(camera_model=cameras.FISHEYE,
                        radial_coeffs=per_camera(0.05, -0.01, 0.002, 0.0)),
        "opencv": dict(radial_coeffs=per_camera(-0.05, 0.01, 0.0),
                       tangential_coeffs=per_camera(1e-3, -1e-3)),
        "ftheta": dict(camera_model=cameras.FTHETA, ftheta_coeffs=cameras.FThetaParams(
            angle_to_pixeldist_poly=a2p, pixeldist_to_angle_poly=p2a, max_angle=1.2,
            linear_cde=(9.9968284e-01, 1.8735906e-05, 1.7659619e-05))),
        "rolling_shutter": dict(rolling_shutter=cameras.SHUTTER_TOP_TO_BOTTOM,
                                viewmats_rs=rs),
    }


def counted(label, want, fn, *args, **kw):
    """fn(*args, **kw) with the (K2, K3, K4) counts set to 0 just before and
    read just after -> (its output, the counts); fails unless they are
    `want`."""
    reset_train_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    got = train_counts()
    if got != want:
        raise AssertionError(f"{label}: (K2, K3, K4) launches {got} != {want}")
    return out, got


def finite(label, *xs):
    for x in xs:
        if not torch.isfinite(x).all():
            raise AssertionError(f"{label}: output not finite")


def camera_route_lists(scene, kw, c, max_tiles_per_gauss, with_ids=False):
    """Camera c's splats on a UT route, projected and coloured as rasterize
    does -> (CameraSplats, its sorted f32 flat list)."""
    from hunyuanworld_mirror_tpu_torch.ops import projection, rasterizer
    means, quats, scales, opac, sh, w2c, Ks, HW = scene
    ut = rasterizer.ut_camera(c, **kw) if kw else None       # {}: the pinhole EWA
    covars = (projection.quat_scale_to_covar(quats, scales) if kw
              else projection.quat_scale_to_covar_planes(quats, scales))
    s = rasterizer.prepare_camera(means, covars, opac, sh, w2c[c], Ks[c], HW, HW, ut=ut)
    bins = rasterizer.bin_splats(s.means2d, s.conics, s.colors, s.opacities, s.radii,
                                 s.depths, 16, -(-HW // 16), -(-HW // 16),
                                 max_tiles_per_gauss, RENDER_MPT, False, with_ids=with_ids)
    return s, bins


def phase14_ut_routes(scene):
    """(a) the pinhole route, then each UT route, on the flat route (4 K2)
    and the dense route (4 K4): finite outputs, K2 and K4 against their
    plain versions on the route's own f32 lists, the render's rasterize
    call timed (each route's ratio to the pinhole one)."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer, tiles
    means, quats, scales, opac, sh, w2c, Ks, HW = scene
    args = (means, quats, scales, opac, sh, w2c, Ks, HW, HW)
    caps = dict(max_per_tile=RENDER_MPT, max_tiles_per_gauss=RENDER_TPG, device="cuda")
    with torch.no_grad():
        out = {}
        for name, kw in {"pinhole": {}, **ut_routes(w2c, Ks)}.items():
            row = {}
            for impl, want in (("pallas", (4, 0, 0)), ("jax", (0, 0, 4))):
                (img, alpha, meta), _ = counted(f"{name} {impl}", want, rasterizer.rasterize,
                                                *args, impl=impl, **caps, **kw)
                finite(f"{name} {impl}", img, alpha)
                row[impl] = dict(
                    ms=cuda_ms(lambda: rasterizer.rasterize(*args, impl=impl, **caps, **kw),
                               reps=3, warmup=1),
                    n_isects=meta["n_isects"].tolist(), alpha=float(alpha.mean()))
            k2_rows, k4_rows = [], []
            for c in range(w2c.shape[0]):
                s, bins = camera_route_lists(scene, kw, c, RENDER_TPG)
                k2_rows.append(k2_check(f"{name} camera {c}", bins, HW, HW, 4, False)[:5])
                del bins
                dense = tiles.bin_gaussians(
                    s.means2d, s.radii, s.depths, 16, -(-HW // 16), -(-HW // 16),
                    RENDER_TPG, RENDER_MPT,
                    conic_test=tiles.conic_test_planes(s.conics, s.opacities))
                k4_rows.append(k4_check(f"K4 {name} camera {c}", s.means2d, s.conics,
                                        s.colors, s.opacities, dense, HW))
                del dense
            row["k2"] = totals(f"K2 {name} route, 4 cameras", k2_rows)
            row["k4"] = totals(f"K4 {name} route, 4 cameras", k4_rows)
            pin = out.get("pinhole", row)
            log(f"{name} route: rasterize {row['pallas']['ms']:.2f} ms flat "
                f"(x{row['pallas']['ms'] / pin['pallas']['ms']:.2f} the pinhole route's), "
                f"{row['jax']['ms']:.2f} ms dense "
                f"(x{row['jax']['ms'] / pin['jax']['ms']:.2f}); K2 "
                f"x{row['k2']['ms'] / pin['k2']['ms']:.2f}, K4 "
                f"x{row['k4']['ms'] / pin['k4']['ms']:.2f} the pinhole lists'; n_isects "
                f"per camera {row['pallas']['n_isects']}, mean alpha "
                f"{row['pallas']['alpha']:.4f}")
            out[name] = row
    pin_ms = {impl: out["pinhole"][impl]["ms"] for impl in ("pallas", "jax")}
    return {k: v for k, v in out.items() if k != "pinhole"}, pin_ms, out["pinhole"]


def phase14_modes(scene):
    """(b) RGB, D, ED and RGB+D with calc_compensations and radius_clip
    through K2 (4 a render) and K2m (1): K2 on camera 0's list and K2m on
    the batch list against their plain versions."""
    from hunyuanworld_mirror_tpu_torch.ops import projection, rasterizer
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    means, quats, scales, opac, sh, w2c, Ks, HW = scene
    args = (means, quats, scales, opac, sh, w2c, Ks, HW, HW)
    knobs = dict(calc_compensations=True, radius_clip=1.0)
    caps = dict(max_per_tile=RENDER_MPT, max_tiles_per_gauss=RENDER_TPG, device="cuda")
    C, tiles_x = w2c.shape[0], -(-HW // 16)
    planes = projection.quat_scale_to_covar_planes(quats, scales)
    out = {}
    with torch.no_grad():
        for mode in ("RGB", "D", "ED", "RGB+D"):
            (img, alpha, _), _ = counted(f"mode {mode}", (4, 0, 0), rasterizer.rasterize,
                                         *args, render_mode=mode, **knobs, **caps)
            R.rasterize_flat_multi.launches = 0
            (img_b, alpha_b, _), _ = counted(f"mode {mode} camera_batch", (0, 0, 0),
                                             rasterizer.rasterize, *args, render_mode=mode,
                                             camera_batch=True, **knobs, **caps)
            if R.rasterize_flat_multi.launches != 1:
                raise AssertionError(f"mode {mode}: K2m launches "
                                     f"{R.rasterize_flat_multi.launches} != 1")
            finite(f"mode {mode}", img, alpha, img_b, alpha_b)
            s = rasterizer.prepare_camera(means, planes, opac, sh, w2c[0], Ks[0], HW, HW,
                                          mode, **knobs)
            d_col = s.colors.shape[-1]
            bins = rasterizer.bin_splats(s.means2d, s.conics, s.colors, s.opacities,
                                         s.radii, s.depths, 16, tiles_x, tiles_x,
                                         RENDER_TPG, RENDER_MPT, False)
            k2 = k2_check(f"mode {mode} camera 0", bins, HW, HW, d_col, False)
            bb, _ = rasterizer.bin_cameras(means, quats, scales, opac, sh, w2c, Ks, HW,
                                           HW, 16, RENDER_MPT, RENDER_TPG, mode, **knobs)
            margs = (bb.packed, bb.starts, bb.counts, C, HW, HW, 16, d_col)
            err = check_blend(f"K2m mode {mode}", lambda: R.rasterize_flat_multi(*margs),
                              lambda: R.rasterize_flat_multi_plain(*margs))
            ms = cuda_ms(lambda: R.rasterize_flat_multi(*margs))
            plain_ms = cuda_ms(lambda: R.rasterize_flat_multi_plain(*margs), reps=2,
                               warmup=1)
            bound, by, _, _, _ = blend_bound(bb.packed, bb.starts, bb.counts, HW, HW,
                                             d_col, False, C)
            d = (img[..., :d_col] - img_b[..., :d_col]).abs()
            log(f"K2m mode {mode} (D = {d_col}), {C} cameras: max|d| {err:.3e}  kernel "
                f"{ms:.4f} ms  plain {plain_ms:.2f} ms  bound {bound:.4f} ms ({by}); "
                f"render vs the per-camera route median |d| {float(d.median()):.2e}")
            out[mode] = dict(k2=dict(zip(("err", "ms", "plain_ms", "bound_ms", "by"),
                                         k2[:5])),
                             k2m=dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                      by=by))
            del bins, bb
    return out


def phase14_k3(scene):
    """(c) K3 against its plain version on the fisheye route's lists (9
    tiles a splat, seeded cotangents), then one gradient of means and quats
    through the UT projection: 4 K2 and 4 K3 launches, finite and non-zero."""
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer
    means, quats, scales, opac, sh, w2c, Ks, HW = scene
    kw = ut_routes(w2c, Ks)["fisheye"]
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for c in range(w2c.shape[0]):
        with torch.no_grad():
            _, bins = camera_route_lists(scene, kw, c, 9, with_ids=True)
        rows.append(k3_check(f"fisheye camera {c}", bins, HW, HW, 4, means.shape[0],
                             gen)[:5])
        del bins
        torch.cuda.empty_cache()
    k3 = totals("K3 fisheye route, 4 cameras", rows)
    m = means.clone().requires_grad_(True)
    q = quats.clone().requires_grad_(True)
    t0 = time.time()
    (img, alpha, _), launches = counted(
        "fisheye gradient forward", (4, 0, 0), rasterizer.rasterize, m, q, scales, opac,
        sh, w2c, Ks, HW, HW, max_per_tile=RENDER_MPT, device="cuda", **kw)
    reset_train_counts()
    (img[..., :3].mean() + alpha.mean()).backward()
    torch.cuda.synchronize()
    got = train_counts()
    log(f"fisheye gradient: forward and backward {1e3 * (time.time() - t0):.1f} ms wall, "
        f"backward (K2, K3, K4) {got}; |d means| max {float(m.grad.abs().max()):.3e}, "
        f"|d quats| max {float(q.grad.abs().max()):.3e}")
    if got != (0, 4, 0):
        raise AssertionError(f"fisheye backward: launches {got} != (0, 4, 0)")
    for name, g in (("means", m.grad), ("quats", q.grad)):
        if not (torch.isfinite(g).all() and float(g.abs().max()) > 0):
            raise AssertionError(f"fisheye gradient of {name}: not finite or all zero")
    return k3


def phase14_eval3d_indices(scene):
    """(d) eval3d on the fisheye route and (e) rasterize_to_indices and
    rasterize_to_indices_2dgs: no kernel launch, outputs checked, timed."""
    from hunyuanworld_mirror_tpu_torch.ops import gs2d, rasterizer
    means, quats, scales, opac, sh, w2c, Ks, HW = scene
    kw = ut_routes(w2c, Ks)["fisheye"]
    args = (means, quats, scales, opac, sh, w2c, Ks, HW, HW)
    caps = dict(max_per_tile=RENDER_MPT, max_tiles_per_gauss=RENDER_TPG, device="cuda")
    out = {}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        (img, alpha, meta), _ = counted("eval3d", (0, 0, 0), rasterizer.rasterize, *args,
                                        with_eval3d=True, **caps, **kw)
        finite("eval3d", img, alpha)
        out["eval3d_ms"] = cuda_ms(lambda: rasterizer.rasterize(
            *args, with_eval3d=True, **caps, **kw), reps=2, warmup=0)
        log(f"eval3d, fisheye route, 4 cameras: {out['eval3d_ms']:.2f} ms, entries per "
            f"camera {meta['n_isects'].tolist()}, mean alpha {float(alpha.mean()):.4f}, "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        iargs = (means, quats, scales, opac, w2c, Ks, HW, HW)
        for name, fn in (("rasterize_to_indices", rasterizer.rasterize_to_indices),
                         ("rasterize_to_indices_2dgs", gs2d.rasterize_to_indices_2dgs)):
            (ids, w), _ = counted(name, (0, 0, 0), fn, *iargs, k=8, **caps)
            ok = (((ids == -1) | ((ids >= 0) & (ids < means.shape[0]))).all()
                  & ((ids == -1) == (w == 0)).all() & (w >= 0).all() & (w <= 1).all())
            ms = cuda_ms(lambda: fn(*iargs, k=8, **caps), reps=2, warmup=0)
            log(f"{name}: ids {tuple(ids.shape)}, pixels with a splat "
                f"{float((ids[..., 0] >= 0).float().mean()):.4f}, weight sum mean "
                f"{float(w.sum(-1).mean()):.4f}; {ms:.2f} ms")
            if not bool(ok) or not bool((ids >= 0).any()):
                raise AssertionError(f"{name}: ids out of range or weights off [0, 1]")
            out[name + "_ms"] = ms
    return out


def phase14_gs2d(preds, imgs, scene, train_inputs, train_ref):
    """(f) rasterize_2dgs at full width (pinhole and fisheye), the trainer
    twin's run(..., gs2d=True) for 2 iterations on phase 5's export, and
    optimize_splats(mode="2dgs") for 10 steps: finite losses, the last below
    the first, no K2, K3 or K4 launch a step; the step split and the peak
    memory."""
    import tempfile
    from pathlib import Path

    from hunyuanworld_mirror_tpu_torch import splat_trainer
    from hunyuanworld_mirror_tpu_torch.infer import export
    from hunyuanworld_mirror_tpu_torch.ops import gs2d
    from hunyuanworld_mirror_tpu_torch.training import splat_opt
    means, quats, scales, opac, sh, w2c, Ks, HW = scene
    out = {}
    with torch.no_grad():
        for name, kw in (("pinhole", {}), ("fisheye", ut_routes(w2c, Ks)["fisheye"])):
            (img, alpha, nrm), _ = counted(f"2DGS {name}", (0, 0, 0), gs2d.rasterize_2dgs,
                                           means, quats, scales, opac, sh, w2c, Ks, HW, HW,
                                           max_per_tile=RENDER_MPT, sh_degree=0,
                                           device="cuda", **kw)
            finite(f"2DGS {name}", img, alpha, nrm)
            out[f"forward_{name}_ms"] = cuda_ms(lambda: gs2d.rasterize_2dgs(
                means, quats, scales, opac, sh, w2c, Ks, HW, HW, max_per_tile=RENDER_MPT,
                sh_degree=0, device="cuda", **kw), reps=2, warmup=0)
            log(f"rasterize_2dgs {name}, 4 cameras: {out[f'forward_{name}_ms']:.2f} ms, "
                f"mean alpha {float(alpha.mean()):.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "infer"
        export(preds, imgs, d)
        np.save(Path(tmp) / "images.npy", imgs[0])
        t0 = time.time()
        res = splat_trainer.run(str(d), str(Path(tmp) / "images.npy"), iters=2, size=HW,
                                gs2d=True, device="cuda", log_fn=lambda *a: None)
        log(f"trainer twin run(..., gs2d=True): 2 iterations in {time.time() - t0:.2f} s "
            f"wall, {len(res['means'])} splats written")
        if not np.isfinite(res["means"]).all():
            raise AssertionError("2DGS trainer twin: splats not finite")
    cfg = splat_opt.SplatOptConfig(iters=10, refine_start=100, mode="2dgs")
    steps, _, wall, peak = counted_training("2DGS training", train_inputs, cfg, (0, 0, 0))
    losses = [s["loss"] for s in steps]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"2DGS training: losses {losses}")
    med = step_medians("2DGS training", steps, ("render_forward", "backward", "optimizer"))
    out.update(step=med, peak_gb=peak, wall_s=wall,
               vs_default=med["total"] / train_ref["median_ms"])
    log(f"2DGS step {med['total']:.2f} ms against phase 8's default step "
        f"{train_ref['median_ms']:.2f} ms: x{out['vs_default']:.2f}; peak {peak:.2f} GB")
    return out


def phase_camera_models(preds, imgs, train_inputs, train_ref):
    """Phase 14 on phase 5's splats and its 4 cameras at 518 px."""
    scene = main_path_scene(preds)
    res = {}
    for key, fn, args in (("ut", phase14_ut_routes, (scene,)),
                          ("modes", phase14_modes, (scene,)),
                          ("k3", phase14_k3, (scene,)),
                          ("eval3d_indices", phase14_eval3d_indices, (scene,)),
                          ("gs2d", phase14_gs2d, (preds, imgs, scene, train_inputs,
                                                  train_ref))):
        t0 = time.time()
        res[key] = fn(*args)
        log(f"phase 14 {key}: {time.time() - t0:.1f} s wall")
        torch.cuda.empty_cache()
    return res


# --- phase 15: the CenterSnap 6D-pose trainer ---------------------------------

# K1's forward and gradient on the trainer's shapes: (label, (B, N, H, D))
# bf16, the CLI's 384 px (576 patches + 5 special tokens, + 2 with
# --depth-cond), CenterSnapConfig's 512 px with the depth condition
# (1024 + 7), each N ending in a partial key tile, and one frame layer of
# the main path
K1_GRAD_SHAPES = [("centersnap_384", (20, 581, 6, 64)),
                  ("centersnap_384_depth", (20, 583, 6, 64)),
                  ("centersnap_512", (20, 1031, 6, 64)),
                  ("frame", (4, 1376, 16, 64))]
# dq, dk, dv against autograd through the same math on the same bf16 inputs:
# two bf16 ulps of the largest gradient (the CPU tests' band against JAX)
K1_GRAD_BAND = 2.0 ** -6
# (f): the card's forward is K1 (f32 logits) and its backward the bf16-logit
# replay, the CPU's both attention_plain (f32 logits): the loss within this
# share, each leaf's gradient norm within this share of itself (or of 1e-3
# of the largest norm, for a leaf whose gradient cancels to near 0)
CS_CPU_LOSS_BAND = 1e-3
CS_CPU_NORM_BAND = 5e-2


def k1_counts():
    """(K1 launches, K1 backward replays)."""
    from hunyuanworld_mirror_tpu_torch.ops.attention import attention
    return attention.launches, attention.backward_replays


def k1_grad_check(label, shape, gen):
    """K1 under grad on CUDA: the output has a grad_fn, one launch forward
    and none backward, dq / dk / dv against autograd through
    attention_replay on the same inputs -> the forward launch's time, its
    bound and the replay's time."""
    from hunyuanworld_mirror_tpu_torch.ops import attention as A
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for _ in range(4))
    scale = shape[-1] ** -0.5
    fwd_err = k1_check(label, q, k, v)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = k1_counts()
    out = A.attention(*leaves, scale)
    if out.grad_fn is None:
        raise AssertionError(f"K1 grad {label}: the output has no grad_fn")
    mid = k1_counts()
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    after = k1_counts()
    if (mid[0] - before[0], after[0] - mid[0], after[1] - mid[1]) != (1, 0, 1):
        raise AssertionError(f"K1 grad {label}: launches forward {mid[0] - before[0]}, "
                             f"backward {after[0] - mid[0]}, replays {after[1] - mid[1]}")
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(A.attention_replay(*ref_leaves, scale), ref_leaves, g)
    errs = []
    for name, a, b in zip("qkv", grads, ref):
        err = float((a.float() - b.float()).abs().max())
        band = K1_GRAD_BAND * float(b.float().abs().max())
        if not (err <= band and bool(torch.isfinite(a).all())):
            raise AssertionError(f"K1 grad {label} d{name}: max|d| {err} > {band}")
        errs.append(err)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: A.attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: A.attention_plain(q, k, v, scale), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale))
    replay_ms = cuda_ms(lambda: A.attention_replay_grads(q, k, v, scale, g), reps=5)
    bound = k1_bound_ms(shape, torch.bfloat16)
    log(f"K1 grad {label:15s} {str(shape):20s} grad_fn {type(out.grad_fn).__name__}  "
        f"max|d| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}  forward "
        f"{fwd_ms:.4f} ms (bound {bound:.4f}, plain {plain_ms:.4f}, sdpa {lib_ms:.4f})  "
        f"replay {replay_ms:.4f} ms")
    del q, k, v, g, leaves, ref_leaves, out, grads, ref, qt, kt, vt
    torch.cuda.empty_cache()
    return {"err": max(errs), "fwd_err": fwd_err, "ms": fwd_ms, "bound_ms": bound,
            "plain_ms": plain_ms, "library_ms": lib_ms, "replay_ms": replay_ms}


def synthetic_sope(rng, size):
    """One synthetic SOPE-style frame at size x size: 1-3 boxes (random
    rotation, 5-20 cm sides, 0.6-1.5 m away, centred at a random pixel) seen
    through a pinhole camera (focal 0.8 size), each drawn as a flat-coloured
    ellipse mask over a smooth background; depth 3 m behind them."""
    f = 0.8 * size
    K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    rgb = np.stack([xx / size, yy / size, np.full((size, size), rng.uniform())], -1)
    depth = np.full((size, size), 3.0, np.float32)
    masks, rots, trans, sizes = [], [], [], []
    for _ in range(int(rng.integers(1, 4))):
        u, v = rng.uniform(0.2, 0.8, 2) * size
        z = rng.uniform(0.6, 1.5)
        t = np.array([(u - size / 2) * z / f, (v - size / 2) * z / f, z], np.float32)
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        rot = (q * np.sign(np.diag(r))).astype(np.float32)
        if np.linalg.det(rot) < 0:
            rot[:, 0] *= -1
        ext = rng.uniform(0.05, 0.2, 3).astype(np.float32)
        ry, rx = np.clip(f * ext[:2] / z / 2, 3, size / 5)
        m = ((yy - v) / ry) ** 2 + ((xx - u) / rx) ** 2 <= 1
        rgb[m] = rng.uniform(size=3)
        depth[m] = z
        masks.append(m)
        rots.append(rot)
        trans.append(t)
        sizes.append(ext)
    return {"rgb": (rgb * 255).astype(np.uint8), "depth": depth, "masks": masks,
            "rotations": rots, "translations": trans, "sizes": sizes, "K": K}


def write_sope_samples(out_dir, n, size, seed):
    """n synthetic samples in the layout the wds_tools twin's `convert
    --gen-targets` packs: <key>.color.png (the port's PNG writer, filter-0
    rows), <key>.meta.json and <key>.targets.json (rotations, translations,
    sizes, intrinsics, and the path of the instance masks under masks/)."""
    from pathlib import Path
    from hunyuanworld_mirror_tpu_torch.training.tb_writer import png_encode
    out = Path(out_dir)
    (out / "masks").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        s, key = synthetic_sope(rng, size), f"{seed:03d}{i:06d}"
        np.savez_compressed(out / "masks" / f"{key}.npz", masks=np.stack(s["masks"]))
        (out / f"{key}.color.png").write_bytes(png_encode(s["rgb"]))
        (out / f"{key}.meta.json").write_text(json.dumps({"objects": len(s["masks"])}))
        (out / f"{key}.targets.json").write_text(json.dumps({
            "masks": str(out / "masks" / f"{key}.npz"),
            "rotations": [r.tolist() for r in s["rotations"]],
            "translations": [t.tolist() for t in s["translations"]],
            "sizes": [x.tolist() for x in s["sizes"]], "intrinsics": s["K"].tolist()}))
    return out


def sope_batch(n, size, seed):
    """An in-memory batch of n synthetic frames, as the loader gives it
    (rgb in [0, 1], depth in metres, generated targets)."""
    from hunyuanworld_mirror_tpu_torch import preprocessing as prep
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        s = synthetic_sope(rng, size)
        heat, pose = prep.make_targets(s["masks"], s["rotations"], s["translations"],
                                       s["sizes"], s["K"])
        rows.append({"rgb": s["rgb"].astype(np.float32) / 255.0, "depth": s["depth"],
                     "heatmap": heat, "pose_map": pose})
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def step_phases(marks):
    return {name: marks[j - 1][1].elapsed_time(ev) for j, (name, ev) in enumerate(marks) if j}


def median_phases(label, phases):
    med = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    med["total"] = float(np.median([sum(p.values()) for p in phases]))
    log(f"{label} step (median of {len(phases)}): "
        + "  ".join(f"{k} {v:.2f} ms" for k, v in med.items()))
    return med


def phase15_cli(tmp):
    """(b) the CLI twin at every default on synthetic shards, one epoch with
    a checkpoint, then --resume for one more."""
    import glob
    from hunyuanworld_mirror_tpu_torch import train as train_cli
    from hunyuanworld_mirror_tpu_torch import wds_tools
    from hunyuanworld_mirror_tpu_torch.training import checkpoint as ckpt_lib
    t0 = time.time()
    splits = (("train", 200, 1), ("test", 40, 2))
    for split, n, seed in splits:
        wds_tools.do_convert(str(write_sope_samples(f"{tmp}/{split}_samples", n, 384, seed)),
                             f"{tmp}/{split}", shard_size=50, prefix=split,
                             gen_targets=True)
    log(f"CenterSnap CLI: {splits} samples at 384 px written and sharded with "
        f"generated targets in {time.time() - t0:.1f} s")
    ckpt = f"{tmp}/centersnap.npz"
    base = ["--train-shards", f"{tmp}/train/train-*.tar",
            "--test-shards", f"{tmp}/test/test-*.tar", "--epochs", "1",
            "--ckpt", ckpt, "--ckpt-every-epochs", "1"]
    runs = {}
    for run, extra in (("first", []), ("resumed", ["--resume", ckpt])):
        steps, lines, prev = [], [], [k1_counts()]

        def on_step(step, loss, logs, marks):
            now = k1_counts()
            steps.append({"step": step, "loss": float(loss),
                          "k1": (now[0] - prev[0][0], now[1] - prev[0][1]),
                          "phases": step_phases(marks)})
            prev[0] = now

        def log_fn(msg):
            lines.append(msg)
            log(f"  train.main: {msg}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        train_cli.main(base + extra, device="cuda", on_step=on_step, log_fn=log_fn)
        torch.cuda.synchronize()
        wall, peak = time.time() - t0, torch.cuda.max_memory_allocated() / 1e9
        tests = [float(m.split("test loss ")[1].split()[0]) for m in lines if "test loss" in m]
        losses = [s["loss"] for s in steps]
        med = median_phases(f"CenterSnap CLI ({run})", [s["phases"] for s in steps[1:]])
        log(f"CenterSnap CLI ({run}): {len(steps)} steps {steps[0]['step']}..{steps[-1]['step']} "
            f"in {wall:.1f} s wall; train losses {losses[0]:.5f} .. {losses[-1]:.5f}; "
            f"test loss {tests}; (K1, replays) a step {sorted({s['k1'] for s in steps})}; "
            f"peak {peak:.2f} GB")
        want_first = 1 if run == "first" else 11
        if len(steps) != 10 or steps[0]["step"] != want_first:
            raise AssertionError(f"CenterSnap CLI ({run}): steps "
                                 f"{[s['step'] for s in steps]}")
        if not (np.isfinite(losses).all() and len(tests) == 1 and np.isfinite(tests[0])):
            raise AssertionError(f"CenterSnap CLI ({run}): losses {losses}, test {tests}")
        if any(s["k1"] != (4, 4) for s in steps):
            raise AssertionError(f"CenterSnap CLI ({run}): (K1, replays) a step "
                                 f"{[s['k1'] for s in steps]}, want (4, 4)")
        _, saved = ckpt_lib.load_train_state(ckpt)
        if saved != steps[-1]["step"]:
            raise AssertionError(f"CenterSnap CLI ({run}): checkpoint step {saved}")
        runs[run] = {"median": med, "peak_gb": peak, "wall_s": wall,
                     "losses": (losses[0], losses[-1]), "test": tests[0]}
    return runs


def train_loop(label, cfg, batch, n_steps, want_k1):
    """n_steps of make_train_step on one fixed batch (the loader's layout,
    through _prepare_batch) -> losses, median step split and peak."""
    from hunyuanworld_mirror_tpu_torch.training import trainer
    from hunyuanworld_mirror_tpu_torch.utils import profiling
    model = trainer.model_init(cfg, "cuda")
    opt = trainer.make_optimizer(cfg, model)
    step = trainer.make_train_step(cfg, model, opt)
    b = trainer._prepare_batch(cfg, batch, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, phases, counts = [], [], []
    t0 = time.time()
    for _ in range(n_steps):
        before = k1_counts()
        marks = []
        with profiling.request(marks, start=True):
            loss, _ = step(b, marks)
        losses.append(float(loss))
        now = k1_counts()
        counts.append((now[0] - before[0], now[1] - before[1]))
        phases.append(step_phases(marks))
    wall, peak = time.time() - t0, torch.cuda.max_memory_allocated() / 1e9
    med = median_phases(label, phases[1:])
    log(f"{label}: {n_steps} steps in {wall:.2f} s wall; losses {losses[0]:.5f} .. "
        f"{losses[-1]:.5f}; (K1, replays) a step {sorted(set(counts))}; peak {peak:.2f} GB")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses}")
    if any(c != (want_k1, want_k1) for c in counts):
        raise AssertionError(f"{label}: (K1, replays) a step {counts}, want {want_k1}")
    return {"median": med, "peak_gb": peak, "losses": (losses[0], losses[-1])}


def phase15_profile(batch):
    """Where the CLI's default step (B=20, 384 px) spends device time: one
    warm step, then one under torch.profiler -> device ms by op family."""
    from hunyuanworld_mirror_tpu_torch.training import trainer
    cfg = trainer.TrainConfig()
    model = trainer.model_init(cfg, "cuda")
    step = trainer.make_train_step(cfg, model, trainer.make_optimizer(cfg, model))
    b = trainer._prepare_batch(cfg, batch, "cuda")
    step(b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=acts) as prof:
        step(b)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    dev = {}
    for e in prof.events():   # the kernels themselves (as tools/k3_ab.py reads them)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.name] = dev.get(e.name, 0.0) + e.device_time_total / 1e3
    total = sum(dev.values())
    if total == 0:
        log("CenterSnap step profile: the profiler shows no device time (not measured)")
        return None
    # the first family whose pattern a kernel's name holds (the top ten
    # names are printed below, to check the sorting)
    families = {"K1": ("attn_bf16_kernel", "attn_f32_kernel"),
                # cuDNN's f32 convolutions: direct, implicit GEMM, and FFT
                # (complex cf32 GEMMs between the transforms)
                "conv": ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                         "cudnn", "fft", "cf32", "region_transform"),
                "gemm": ("gemm", "cutlass", "nvjet"), "softmax": ("softmax",)}
    fam = {k: 0.0 for k in families}
    fam["other"] = 0.0
    for key, ms in dev.items():
        name = next((f for f, pats in families.items()
                     if any(p in key.lower() for p in pats)), "other")
        fam[name] += ms
    log(f"CenterSnap step profile (B=20, 384 px): device {total:.2f} ms of {wall_ms:.2f} ms "
        f"wall (idle share {max(0.0, 1 - total / wall_ms):.3f}); "
        + "  ".join(f"{k} {v:.2f}" for k, v in fam.items()))
    for key, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {ms:9.3f} ms  {key[:110]}")
    return {"device_ms": total, "wall_ms": wall_ms, "families": fam}


def phase15_dinov3(batch):
    """(e) patch_embed="dinov3_vits16" at 384 px: one step, 12 encoder + 4
    trunk K1 launches, every gradient finite."""
    from hunyuanworld_mirror_tpu_torch.models.centersnap import CenterSnapConfig
    from hunyuanworld_mirror_tpu_torch.training import losses as L
    from hunyuanworld_mirror_tpu_torch.training import trainer
    cfg = trainer.TrainConfig(model=CenterSnapConfig(img_size=384,
                                                     patch_embed="dinov3_vits16",
                                                     use_depth_condition=False))
    model = trainer.model_init(cfg, "cuda")
    opt = trainer.make_optimizer(cfg, model)
    b = trainer._prepare_batch(cfg, batch, "cuda")
    before = k1_counts()
    loss, _ = L.centersnap_loss(trainer.model_forward(cfg, model, b), b)
    mid = k1_counts()
    loss.backward()
    torch.cuda.synchronize()
    after = k1_counts()
    reached = [p for p in opt.params if p.grad is not None]
    bad = [leaf.name for leaf, p in zip(opt.leaves, opt.params)
           if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    opt.step()
    log(f"CenterSnap dinov3_vits16 384 px: loss {float(loss.detach()):.5f}; K1 launches forward "
        f"{mid[0] - before[0]}, backward {after[0] - mid[0]}, replays {after[1] - mid[1]}; "
        f"{len(reached)} of {len(opt.params)} leaves reached by the loss (the unused "
        f"pos_embed steps on zeros)")
    if (mid[0] - before[0], after[0] - mid[0], after[1] - mid[1]) != (16, 0, 16):
        raise AssertionError("CenterSnap dinov3: want 16 K1 launches and 16 replays")
    if bad or not np.isfinite(float(loss.detach())):
        raise AssertionError(f"CenterSnap dinov3: non-finite gradients {bad[:5]}")


def phase15_card_vs_cpu(batch):
    """(f) a small CenterSnap (width 128, 2 heads of 64, depth 2, 64 px, depth
    condition) on the card against the same port on the CPU: the loss and
    each leaf's gradient norm."""
    from hunyuanworld_mirror_tpu_torch.models.centersnap import CenterSnapConfig
    from hunyuanworld_mirror_tpu_torch.training import losses as L
    from hunyuanworld_mirror_tpu_torch.training import trainer
    cfg = trainer.TrainConfig(model=CenterSnapConfig(
        img_size=64, embed_dim=128, trunk_depth=2, trunk_heads=2, heatmap_features=32))
    out = {}
    for dev in ("cpu", "cuda"):
        model = trainer.model_init(cfg, dev)
        b = trainer._prepare_batch(cfg, batch, dev)
        loss, _ = L.centersnap_loss(trainer.model_forward(cfg, model, b), b)
        loss.backward()
        out[dev] = (float(loss.detach()), {n: float(p.grad.double().norm()) for n, p in
                                  model.named_parameters() if p.grad is not None})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    scale = max(g_cpu.values())
    rel = {n: abs(g_gpu[n] - g_cpu[n]) / max(g_cpu[n], 1e-3 * scale) for n in g_cpu}
    worst = max(rel, key=rel.get)
    total = math.sqrt(sum((g_gpu[n] - g_cpu[n]) ** 2 for n in g_cpu)) / math.sqrt(
        sum(v * v for v in g_cpu.values()))
    log(f"CenterSnap card vs CPU (64 px, width 128): loss {l_gpu:.6f} / {l_cpu:.6f}; "
        f"leaf gradient norms: worst {worst} {rel[worst]:.3e} (relative, floor 1e-3 of "
        f"the largest), all leaves {total:.3e}")
    if set(g_gpu) != set(g_cpu):
        raise AssertionError("CenterSnap card vs CPU: different leaves reached")
    if abs(l_gpu - l_cpu) > CS_CPU_LOSS_BAND * abs(l_cpu) or rel[worst] > CS_CPU_NORM_BAND:
        raise AssertionError("CenterSnap card vs CPU: outside the bands")


def phase_centersnap():
    """Phase 15: the CenterSnap 6D-pose trainer -> the numbers of the
    kernels line's `centersnap_step` key and PERF.md."""
    import tempfile
    from hunyuanworld_mirror_tpu_torch.models.centersnap import CenterSnapConfig
    from hunyuanworld_mirror_tpu_torch.models.panoptic import PanopticConfig
    from hunyuanworld_mirror_tpu_torch.training import trainer
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(15)
    res["k1"] = {label: k1_grad_check(label, shape, gen) for label, shape in K1_GRAD_SHAPES}
    with tempfile.TemporaryDirectory() as tmp:
        res["cli"] = phase15_cli(tmp)
    b512 = sope_batch(20, 512, 3)
    res["defaults"] = train_loop("CenterSnapConfig defaults (512 px, depth cond, B=20)",
                                 trainer.TrainConfig(model=CenterSnapConfig()), b512, 10, 4)
    res["res_fpn"] = train_loop("res_fpn (512 px, B=20)",
                                trainer.TrainConfig(arch="res_fpn", model=PanopticConfig()),
                                b512, 10, 0)
    del b512
    torch.cuda.empty_cache()
    b384 = sope_batch(20, 384, 4)
    res["profile"] = phase15_profile(b384)
    phase15_dinov3(b384)
    phase15_card_vs_cpu(sope_batch(2, 64, 5))
    return res


# --- phase 16: evaluation and the demo server ---------------------------------

# LPIPS on the card against the CPU (relative). accuracy / completeness
# evaluate |q|^2 + |r|^2 - 2 q.r in f32, whose cancellation (not the device)
# sets their error: the card's values are held to the f64 answer within
# EVAL_F64_TIMES the CPU's own error, or EVAL_CPU_BAND relative
EVAL_CPU_BAND = 1e-5
EVAL_F64_TIMES = 3


def nn_exact(q, r, chunk=1024):
    """Each q point's distance to its nearest r point, in f64 on the card."""
    q = torch.as_tensor(q, dtype=torch.float64, device="cuda")
    r = torch.as_tensor(r, dtype=torch.float64, device="cuda")
    return torch.cat([((q[i:i + chunk, None] - r[None]) ** 2).sum(-1).amin(1).sqrt()
                      for i in range(0, len(q), chunk)])


def post_run(port, fields, files=()):
    """POST /run as the page's form sends it (multipart/form-data) -> (page,
    wall ms from the request to the page read back)."""
    import urllib.request
    b = "wmsmokeboundary"
    parts = [f'--{b}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    for path in files:
        parts.append(f'--{b}\r\nContent-Disposition: form-data; name="images"; '
                     f'filename="{os.path.basename(path)}"\r\nContent-Type: image/png'
                     f'\r\n\r\n'.encode() + open(path, "rb").read() + b"\r\n")
    parts.append(f"--{b}--\r\n".encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}/run", data=b"".join(parts),
                                 headers={"Content-Type": f"multipart/form-data; boundary={b}"})
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=600) as r:
        page = r.read().decode()
    return page, (time.time() - t0) * 1e3


def glb_ok(data):
    return (len(data) > 20 and data[:4] == b"glTF"
            and int.from_bytes(data[4:8], "little") == 2
            and int.from_bytes(data[8:12], "little") == len(data))


def app_request(label, port, demo, fields, files, want, extra=()):
    """One POST /run with every count set to 0 just before and read just
    after: (K1, K1 at N >= 4096, K2, K4) == want and K1's f32 launches (K1c)
    == K1C_PER_FWD, every file of the run written (plus `extra`), scene.glb
    fetched back through /out/ a valid glTF -> the request's numbers."""
    import urllib.request

    from hunyuanworld_mirror_tpu_torch.ops.attention import attention
    reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    page, ms = post_run(port, fields, files)
    got = read_counts()
    f32 = attention.f32_launches
    peak = torch.cuda.max_memory_allocated()
    m = re.search(r"/out/(run_[0-9a-f]+)/", page)
    if m is None:
        raise AssertionError(f"{label}: no result in the page")
    run_id = m.group(1)
    run_dir = os.path.join(demo.args.workdir, run_id)
    S = sum(1 for f in os.listdir(run_dir) if f.startswith("input_"))
    want_files = (["scene.glb", "gaussians.ply", "gaussians.splat", "cameras.json"]
                  + [f"{k}_{s:02d}.png" for s in range(S)
                     for k in ("depth", "normal", "input")] + list(extra))
    missing = [f for f in want_files
               if not os.path.isfile(os.path.join(run_dir, f))
               or os.path.getsize(os.path.join(run_dir, f)) == 0]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/out/{run_id}/scene.glb",
                                timeout=60) as r:
        glb = r.read()
    elapsed_ms = demo.last_elapsed * 1e3
    log(f"app {label}: launches (K1, K1 at N >= 4096, K2, K4) {got}, K1c {f32}; {S} views; "
        f"request {ms:.1f} ms wall, forward elapsed {elapsed_ms:.1f} ms; peak "
        f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the {base / 1e9:.2f} "
        f"GB allocated before it); {len(want_files) - len(missing)} of "
        f"{len(want_files)} files, scene.glb {len(glb)} bytes")
    if got != want or f32 != K1C_PER_FWD or missing or not glb_ok(glb) or S != 4:
        raise AssertionError(f"app {label}: launches {got} != {want} or K1c {f32} != "
                             f"{K1C_PER_FWD}, missing {missing}, glTF ok {glb_ok(glb)}, "
                             f"{S} views")
    return dict(counts=got, f32_launches=f32, ms=ms, elapsed_ms=elapsed_ms,
                peak_gb=peak / 1e9,
                above_gb=(peak - base) / 1e9, run_dir=run_dir)


@contextlib.contextmanager
def request_split():
    """Host ms of the app's steps after the upload, summed over one request
    into the dict it yields: the images' decode and resize, the forward up
    to its predictions on the host (`elapsed`), the PNGs, the GLB and the
    Gaussians' PLY and .splat; the module functions wrapped, then restored."""
    from hunyuanworld_mirror_tpu_torch import app
    split = {}
    steps = [(app.io_images, "prepare_images", "decode"),
             (app.io_ply, "save_depth_png", "pngs"), (app.io_ply, "save_normal_png", "pngs"),
             (app.io_ply, "save_image_png", "pngs"),
             (app.scene_lib, "predictions_to_glb", "glb"),
             (app.infer, "export_gaussians", "gaussians")]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in steps]

    def wrap(fn, label):
        def timed_call(*a, **kw):
            t0 = time.time()
            try:
                return fn(*a, **kw)
            finally:
                split[label] = split.get(label, 0.0) + (time.time() - t0) * 1e3
        return timed_call

    for (mod, name, label), (_, _, fn) in zip(steps, originals):
        setattr(mod, name, wrap(fn, label))
    try:
        yield split
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def phase16_app(imgs):
    """(a) The app twin at --preset large --size 518 on port 0 in a thread:
    GET /health; three POST /run of phase 5's 4 views as uploaded PNGs, one
    with example= (mask_sky, as_mesh), one with video=on, one on the
    rasterizer_impl="jax" route -> the numbers for the kernels line."""
    import shutil
    import threading
    import urllib.request
    from dataclasses import replace
    from pathlib import Path
    from PIL import Image
    from hunyuanworld_mirror_tpu_torch import app, infer
    from hunyuanworld_mirror_tpu_torch.io import images as io_images
    root = Path(__file__).resolve().parent / "build" / "smoke_app"
    shutil.rmtree(root, ignore_errors=True)
    scene = root / "examples" / "smoke" / "four_views"
    scene.mkdir(parents=True)
    S = imgs.shape[1]
    paths = []
    for s in range(S):
        Image.fromarray((imgs[0, s] * 255).astype(np.uint8)).save(scene / f"view_{s}.png")
        paths.append(str(scene / f"view_{s}.png"))
    t0 = time.time()
    srv = app.main(["--preset", "large", "--size", "518", "--port", "0", "--workdir",
                    str(root / "work"), "--examples", str(root / "examples")],
                   serve=False)
    demo = srv.demo
    log(f"app twin: model built in {time.time() - t0:.1f} s")
    predict, captured = demo.predict, []

    def capture(image_paths):
        out = predict(image_paths)
        captured.append(out)
        demo.last_elapsed = out[2]
        return out

    demo.predict = capture
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    res = {}
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            health = json.loads(r.read())
        if health != {"ok": True, "model": "large"}:
            raise AssertionError(f"/health: {health}")
        want = (88, 24, 4, 0)
        reqs = []
        with request_split() as split:
            for i in range(3):
                split.clear()
                reqs.append(app_request(f"upload {i}", port, demo, {"conf": "20"},
                                        paths, want))
                reqs[-1]["split"] = dict(split)
                log(f"app upload {i} split (host ms): " + "  ".join(
                    f"{k} {v:.1f}" for k, v in split.items()))
        # the first request's depth against infer.reconstruct on the same files
        imgs_app, preds_app, _ = captured[0]
        ref_imgs = io_images.prepare_images(paths, target_size=518)
        with demo.lock:
            ref = infer.reconstruct(demo.model, ref_imgs)
        ref_depth = ref["depth"].float().cpu().numpy()
        d_img = float(np.abs(imgs_app - ref_imgs).max())
        d_depth = float(np.abs(preds_app["depth"] - ref_depth).max())
        log(f"app upload 0 against infer.reconstruct on prepare_images of the same "
            f"files: images max|d| {d_img:.3g}, depth max|d| {d_depth:.3g} (depth "
            f"max {float(np.abs(ref_depth).max()):.4g})")
        if d_img != 0.0 or not d_depth <= 1e-5 * float(np.abs(ref_depth).max()):
            raise AssertionError(f"app depth differs from infer.reconstruct's: {d_depth}")
        del ref
        res["example"] = app_request(
            "example", port, demo, {"example": "smoke/four_views", "conf": "20",
                                    "mask_sky": "on", "as_mesh": "on"}, (), want)
        # the novel-view video: 46 frames along the 4 cameras, one K2 each
        res["video"] = app_request("video=on", port, demo, {"video": "on"}, paths,
                                   (88, 24, 4 + 46, 0), extra=("rendered.mp4",))
        base = demo.model.gs_renderer.cfg
        demo.model.gs_renderer.cfg = replace(base, rasterizer_impl="jax")
        res["jax"] = app_request("rasterizer_impl=jax", port, demo, {"conf": "20"},
                                 paths, (88, 24, 0, 4))
        demo.model.gs_renderer.cfg = base
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/viewer?run=x",
                                    timeout=60) as r:
            if b"<canvas" not in r.read():
                raise AssertionError("/viewer: no canvas")
        # forwards of the app's model, CUDA events, in this call; then the
        # forward's host wall time and the copy of its predictions to the host
        med = {}
        timed_forwards("app model", lambda marks: infer.reconstruct(
            demo.model, ref_imgs, marks=marks), medians=med)
        wall, copy = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            out = infer.reconstruct(demo.model, ref_imgs)
            torch.cuda.synchronize()
            t1 = time.time()
            infer.numpy_preds(out)
            wall.append((t1 - t0) * 1e3)
            copy.append((time.time() - t1) * 1e3)
            del out
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    # each upload's launches, as counted in its request: (K1a, K1b, K1c, K2,
    # K4); app_request held every request to them
    res["launches"] = [(r["counts"][0] - r["counts"][1] - r["f32_launches"],
                        r["counts"][1], r["f32_launches"], *r["counts"][2:])
                       for r in reqs]
    res["request_ms"] = float(np.median([r["ms"] for r in reqs]))
    res["elapsed_ms"] = float(np.median([r["elapsed_ms"] for r in reqs]))
    res["forward_ms"] = med["total"]
    res["forward_wall_ms"], res["copy_ms"] = float(np.median(wall)), float(np.median(copy))
    res["peak_gb"] = max(r["peak_gb"] for r in reqs)
    res["split_ms"] = {k: float(np.median([r["split"][k] for r in reqs]))
                       for k in reqs[0]["split"]}
    res["split_ms"]["forward elapsed"] = res["elapsed_ms"]
    res["split_ms"]["rest"] = res["request_ms"] - sum(res["split_ms"].values())
    log(f"app request split, medians of 3 (host ms): {json.dumps(res['split_ms'])}")
    log(f"app requests (3 uploads): median wall {res['request_ms']:.1f} ms, median "
        f"forward elapsed {res['elapsed_ms']:.1f} ms against {med['total']:.2f} ms "
        f"(CUDA events, median of 7 forwards of the same model): ratio "
        f"{res['elapsed_ms'] / med['total']:.3f}; the same forward on the host clock "
        f"{res['forward_wall_ms']:.1f} ms and its predictions' copy to the host "
        f"{res['copy_ms']:.1f} ms (medians of 3); peak {res['peak_gb']:.2f} GB")
    del demo, srv
    shutil.rmtree(root, ignore_errors=True)
    return res


def phase16_eval(preds, imgs):
    """(b) Evaluation on the card: accuracy_completeness on phase 5's point
    map against a 1%-noise copy (65,536 a side, mean and median) beside the
    same calls on the CPU; LPIPS on random weights over the 4 rendered views
    against the inputs at 518 px, card against CPU; eval.main in its three
    modes on files from infer.export_maps."""
    import tempfile
    from pathlib import Path
    from PIL import Image
    from hunyuanworld_mirror_tpu_torch import eval as eval_cli
    from hunyuanworld_mirror_tpu_torch.infer import export_maps
    from hunyuanworld_mirror_tpu_torch.training import checkpoint as ckpt
    from hunyuanworld_mirror_tpu_torch.utils import lpips, metrics
    from hunyuanworld_mirror_tpu_torch import convert
    res = {}
    rng = np.random.default_rng(16)
    pts = preds["pts3d"][0].float().cpu().numpy().reshape(-1, 3)
    spread = float(np.linalg.norm(pts - pts.mean(0), axis=1).mean())
    noisy = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.01 * spread
    metrics.accuracy_completeness(pts, noisy, device="cuda")               # warm-up
    # the f64 answer on the subsample the function draws (seed 0, pred first)
    draw = np.random.default_rng(0)
    q = pts[draw.choice(len(pts), 65536, replace=False)] if len(pts) > 65536 else pts
    r = noisy[draw.choice(len(noisy), 65536, replace=False)] if len(noisy) > 65536 else noisy
    d_qr, d_rq = nn_exact(q, r), nn_exact(r, q)
    for stat in ("mean", "median"):
        f = {"mean": torch.mean, "median": metrics._median}[stat]
        exact = np.array([float(f(d_qr)), float(f(d_rq))])
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            card = metrics.accuracy_completeness(pts, noisy, statistic=stat, device="cuda")
            ms.append((time.time() - t0) * 1e3)
        t0 = time.time()
        cpu = metrics.accuracy_completeness(pts, noisy, statistic=stat, device="cpu")
        cpu_ms = (time.time() - t0) * 1e3
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        err, err_cpu = np.abs(np.array(card) - exact), np.abs(np.array(cpu) - exact)
        log(f"accuracy_completeness ({stat}, {len(pts)} points to 65536 a side, noise "
            f"0.01 x {spread:.4g}): card {card}, CPU {cpu}, f64 {exact.tolist()}; card "
            f"vs CPU max rel {rel:.3g}; |card - f64| {err.tolist()}, |CPU - f64| "
            f"{err_cpu.tolist()}; card {float(np.median(ms)):.2f} ms (median of 3, both "
            f"directions), CPU {cpu_ms:.0f} ms")
        if not np.all(err <= np.maximum(EVAL_F64_TIMES * err_cpu, EVAL_CPU_BAND * exact)):
            raise AssertionError(f"accuracy_completeness {stat}: card {card} further "
                                 f"from the f64 {exact} than {EVAL_F64_TIMES}x the CPU's {cpu}")
        res[f"acc_comp_{stat}"] = dict(card=card, cpu=cpu, f64=exact.tolist(), rel=rel,
                                       ms=float(np.median(ms)), cpu_ms=cpu_ms)
    del d_qr, d_rq

    net = lpips.init_random(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    net_cpu = lpips.as_module(convert.lpips_to_jax_params(net), "cpu")
    rendered = preds["rendered_colors"][0].float().clamp(0, 1)
    inputs = torch.as_tensor(imgs[0], device="cuda")
    with torch.no_grad():
        d_card = lpips.distance(net, rendered, inputs)
        d_cpu = lpips.distance(net_cpu, rendered.cpu(), inputs.cpu())
        lp_ms = cuda_ms(lambda: lpips.distance(net, rendered, inputs), reps=5)
    rel = float(((d_card.cpu() - d_cpu).abs() / d_cpu.abs()).max())
    log(f"LPIPS (random weights) over {len(inputs)} pairs at {inputs.shape[1]} px: card "
        f"{d_card.tolist()}, CPU {d_cpu.tolist()}, max rel {rel:.3g}; "
        f"{lp_ms:.3f} ms a call")
    if not rel <= EVAL_CPU_BAND:
        raise AssertionError(f"LPIPS card vs CPU: {rel}")
    res["lpips"] = dict(rel=rel, ms=lp_ms)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        export_maps(preds, imgs, tmp / "export")
        np.save(tmp / "pts.npy", pts)
        np.save(tmp / "noisy.npy", noisy)
        poses = preds["camera_poses"][0].float().cpu().numpy()
        moved = poses.copy()
        for i, a in enumerate(rng.normal(size=len(poses)) * 0.02):  # radians about z
            rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
            moved[i, :3, :3] = rz @ poses[i, :3, :3]
        moved[:, :3, 3] += rng.normal(size=(len(poses), 3)) * 0.01
        np.savez(tmp / "pred.npz", c2w=poses)
        np.savez(tmp / "gt.npz", camera_poses=moved)
        for name, frames in (("pred", rendered.cpu().numpy()), ("gt", imgs[0])):
            (tmp / name).mkdir()
            for s, f in enumerate(frames):
                Image.fromarray((np.clip(f, 0, 1) * 255).round().astype(np.uint8)).save(
                    tmp / name / f"{s:03d}.png")
        flat = ckpt._flatten({"params": convert.lpips_to_jax_params(net)})
        np.savez(tmp / "lpips.npz", **flat)
        os.environ["WM_LPIPS_WEIGHTS"] = str(tmp / "lpips.npz")
        try:
            t0 = time.time()
            outs = {
                "points_ply": eval_cli.main(["points", "--pred", str(tmp / "export" / "points.ply"),
                                             "--gt", str(tmp / "noisy.npy")]),
                "points_align_median": eval_cli.main(
                    ["points", "--pred", str(tmp / "pts.npy"), "--gt", str(tmp / "noisy.npy"),
                     "--align", "--median"]),
                "cameras": eval_cli.main(["cameras", "--pred", str(tmp / "pred.npz"),
                                          "--gt", str(tmp / "gt.npz")]),
                "nvs": eval_cli.main(["nvs", "--pred", str(tmp / "pred"), "--gt",
                                      str(tmp / "gt")]),
            }
            eval_s = time.time() - t0
        finally:
            del os.environ["WM_LPIPS_WEIGHTS"]
    keys = {"points_ply": {"accuracy", "completeness", "chamfer", "n_pred", "n_gt"},
            "cameras": {"ate_rmse", "rpe_rot_deg", "rpe_trans", "n_frames"},
            "nvs": {"psnr", "ssim", "lpips", "n_frames"}}
    keys["points_align_median"] = keys["points_ply"]
    log(f"eval.main, 4 runs in {eval_s:.1f} s: {json.dumps(outs)}")
    for k, v in outs.items():
        if set(v) != keys[k] or not all(np.isfinite(x) for x in v.values()):
            raise AssertionError(f"eval {k}: {v}")
    if outs["points_align_median"]["n_pred"] != len(pts) or outs["nvs"]["n_frames"] != 4:
        raise AssertionError(f"eval counts: {outs}")
    res["eval"] = outs
    return res


def phase_app_eval(preds, imgs):
    """Phase 16: the demo server twin (a) and evaluation (b) on the card."""
    import importlib.util
    versions = {m: (getattr(importlib.import_module(m), "__version__", "?")
                    if importlib.util.find_spec(m) else "absent") for m in ("PIL", "cv2")}
    log(f"decoders on this machine: {versions}")
    torch.cuda.empty_cache()
    return {"app": phase16_app(imgs), **phase16_eval(preds, imgs)}


# --- multi-device (phase 17) -------------------------------------------------

# the outputs phase 17 holds against the one-device forward
MULTI_KEYS = ("depth", "pts3d", "normals", "camera_params_pred", "rendered_colors")
# the distributed render's caps: the JAX function's tiles a splat, the
# render's per-tile cap
DIST_MPT, DIST_TPG = 4096, 9


def multi_model(device):
    """Phase 5's configuration and weights (large, seed 0, bf16 parameters)
    on the dense-bin route, the one a multi-device render takes."""
    from hunyuanworld_mirror_tpu_torch.infer import PRESETS, load_model
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig
    return load_model(WorldMirrorConfig(**PRESETS["large"], rasterizer_impl="jax"),
                      device=device)


def multi_sharded_forward(rank, device, dims, imgs, cams, n_timed=3):
    """(a), (b) on one rank: the large model sharded over `dims`, one counted
    forward of this rank's views (launches, collectives), n_timed more on
    the host clock between barriers, the peak memory; rank 0 returns the
    gathered outputs."""
    import torch.distributed as dist
    from hunyuanworld_mirror_tpu_torch.parallel import comm, mesh as mesh_lib, sharding
    mesh = mesh_lib.make_mesh(*dims)
    model = sharding.shard_model(multi_model(device), mesh)
    views = sharding.shard_views({"img": torch.tensor(imgs, device=device),
                                  "cams": torch.tensor(cams, device=device)}, mesh)
    cam = views.pop("cams")
    model(views, camera_params=cam, mesh=mesh)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    comm.reset()
    preds = model(views, camera_params=cam, mesh=mesh)
    counts = read_counts()
    from hunyuanworld_mirror_tpu_torch.ops.attention import attention
    f32_launches = attention.f32_launches
    stats = {k: dict(v) for k, v in comm.stats.items()}
    times = []
    for _ in range(n_timed):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.time()
        model(views, camera_params=cam, mesh=mesh)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    out = {"counts": counts, "f32_launches": f32_launches, "comm": stats, "ms": times,
           "coords": mesh.coords,
           "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}
    whole = sharding.gather_predictions(preds, mesh)
    if rank == 0:
        out["preds"] = {k: whole[k].float().cpu().numpy() for k in MULTI_KEYS}
    del model, preds, whole
    torch.cuda.empty_cache()
    return out


def multi_render(rank, device, scene, HW, reps=3):
    """(c) on one rank: rasterize_distributed over mesh (1, n, 1) on this
    rank's slice of phase 5's splats and cameras (launches, host-clock
    time between barriers); rank 0 also holds K4 against its plain version
    on its first camera's dense bins of the exchanged lists."""
    import torch.distributed as dist
    from hunyuanworld_mirror_tpu_torch.ops import distributed, projection
    from hunyuanworld_mirror_tpu_torch.parallel import comm, mesh as mesh_lib, sharding
    n = dist.get_world_size()
    mesh = mesh_lib.make_mesh(1, n, 1)
    means, quats, scales, opac, sh, w2c, Ks = (
        sharding.axis_part(torch.tensor(a, device=device), mesh, "view", 0) for a in scene)

    def render():
        return distributed.rasterize_distributed(
            means, quats, scales, opac, sh, w2c, Ks, HW, HW, mesh,
            max_per_tile=DIST_MPT, max_tiles_per_gauss=DIST_TPG, sh_degree=0)

    render()                                                         # warm-up
    reset_counts()
    out, alpha = render()
    counts = read_counts()
    times = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.time()
        render()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    res = {"counts": counts, "ms": times, "out": out.cpu().numpy(),
           "alpha": alpha.cpu().numpy()}
    # the exchanged lists, as rasterize_distributed makes them
    group = mesh.group("view")
    covars = projection.quat_scale_to_covar_planes(quats, scales)
    proj = distributed.project_for_cameras(
        means, covars, opac, sh, comm.all_gather(w2c, group, 0),
        comm.all_gather(Ks, group, 0), HW, HW)
    proj = [comm.all_to_all(x, group, 0, 1) for x in proj]
    if rank == 0:
        m2d, con, dep, rad, col, op = (x[0] for x in proj)
        colors, bins = distributed.bin_local_camera(m2d, con, dep, rad, col, op, HW, HW,
                                                    16, DIST_MPT, DIST_TPG)
        res["k4"] = k4_check(f"K4 rank 0 camera 0 at V={n}", m2d, con, colors, op,
                             bins, HW)
    dist.barrier()
    return res


def ba_inputs(w2c, K, tracks, dtype, device):
    """BA's inputs in `dtype` (the mask stays bool)."""
    from hunyuanworld_mirror_tpu_torch.refine import ba
    tr = ba.Tracks(*(torch.as_tensor(a, device=device).to(
        torch.bool if i == 2 else dtype) for i, a in enumerate(tracks)))
    return (torch.as_tensor(w2c, device=device).to(dtype),
            torch.as_tensor(K, device=device).to(dtype), tr)


def multi_ba(rank, device, w2c, K, tracks, iters=12):
    """(f) on one rank: bundle_adjust with the landmarks sharded over the
    view axis of mesh (1, n, 1), in f64 and in f32, each timed on the host
    clock -> the results by dtype."""
    import torch.distributed as dist
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib
    from hunyuanworld_mirror_tpu_torch.refine import ba
    mesh = mesh_lib.make_mesh(1, dist.get_world_size(), 1)
    out = {}
    for dt in (torch.float64, torch.float32):
        args = ba_inputs(w2c, K, tracks, dt, device)
        ba.bundle_adjust(*args, iters=1, mesh=mesh)                    # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        poses, _, cost0, cost = ba.bundle_adjust(*args, iters=iters, mesh=mesh)
        torch.cuda.synchronize()
        out[str(dt)[6:]] = {"poses": poses.cpu().numpy(), "cost0": float(cost0),
                            "cost": float(cost), "ms": (time.time() - t0) * 1e3}
    return out


def multi_dryrun(rank, device, flagship):
    """(d) on one rank: the dry-run twin's step at n = the world size, with
    its bf16 trunk (and the flagship pass where asked), then with an f32
    trunk -> the results by trunk dtype."""
    import torch.distributed as dist
    from hunyuanworld_mirror_tpu_torch import multichip
    n = dist.get_world_size()
    res = {"bfloat16": multichip.dryrun_rank(rank, device, n, flagship=flagship),
           "float32": multichip.dryrun_rank(rank, device, n, trunk_dtype="float32")}
    torch.cuda.empty_cache()
    return res


def multi_jobs(rank, device, jobs):
    """Phase 17's jobs for one rank, in order: (function name, args) -> the
    results by name."""
    return {name: globals()[name](rank, device, *args) for name, args in jobs}


def rel_l2(a, b):
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def k1_rank_totals(label, shapes):
    """K1 at one rank's shapes of the sharded forward, each timed once a
    shape (kernel, plain, SDPA, bound) and held to its band -> totals over
    the rank's launches."""
    from hunyuanworld_mirror_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(17)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    for name, shape, dtype, count in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        tot["err"] = max(tot["err"], k1_check(f"{label} {name}", q, k, v))
        scale = shape[-1] ** -0.5
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        for key, val in (
                ("ms", cuda_ms(lambda: A.attention(q, k, v, scale))),
                ("plain_ms", cuda_ms(lambda: A.attention_plain(q, k, v, scale), reps=3,
                                     warmup=1)),
                ("library_ms", cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale))),
                ("bound_ms", k1_bound_ms(shape, dtype))):
            tot[key] += count * val
    log(f"K1 {label} per rank and forward: kernel {tot['ms']:.4f} ms  plain "
        f"{tot['plain_ms']:.2f} ms  sdpa {tot['library_ms']:.4f} ms  bound "
        f"{tot['bound_ms']:.4f} ms  max|d| {tot['err']:.3e}")
    return tot


def phase_multichip(preds, imgs):
    """Phase 17: the multi-device layer on the one card, every rank a
    process on a gloo group (the collectives staged through host memory),
    then the dry-run twin over NCCL at the world size the machine has.
    The kernels were built by phase 2, so the ranks only load them."""
    from hunyuanworld_mirror_tpu_torch import multichip
    from hunyuanworld_mirror_tpu_torch.ops import distributed
    from hunyuanworld_mirror_tpu_torch.ops.rasterizer import rasterize
    from hunyuanworld_mirror_tpu_torch.parallel import mesh as mesh_lib
    from hunyuanworld_mirror_tpu_torch.refine import ba
    from hunyuanworld_mirror_tpu_torch.utils import geometry
    S, HW = imgs.shape[1], imgs.shape[2]
    cams = fixed_cameras(S)
    res = {}

    # the one-device references: the same weights and route, bf16 and f32 trunk
    model = multi_model("cuda")
    views = {"img": torch.tensor(imgs, device="cuda")}
    cam_t = torch.tensor(cams, device="cuda")
    ref = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        out = model(views, camera_params=cam_t, trunk_dtype=dt)
        ref[name] = {k: out[k].float().cpu().numpy() for k in MULTI_KEYS}
        del out
    del model
    torch.cuda.empty_cache()
    band = {k: rel_l2(ref["bf16"][k], ref["f32"][k]) for k in MULTI_KEYS}

    # (c)'s inputs: phase 5's splats and cameras
    means, quats, scales, opac, sh, w2c, Ks, _ = main_path_scene(preds)
    scene = [x.float().cpu().numpy() for x in (means, quats, scales, opac, sh, w2c, Ks)]
    dref, dalpha, _ = rasterize(means, quats, scales, opac, sh, w2c, Ks, HW, HW,
                                max_per_tile=DIST_MPT, max_tiles_per_gauss=DIST_TPG,
                                impl="jax", tight_radius=False, device="cuda")
    dref, dalpha = dref.cpu().numpy(), dalpha.cpu().numpy()

    # (f)'s bundle: phase 12's consistent one, from phase 5's predictions
    d = preds["depth"][0, ..., 0].float()
    g = torch.Generator(device="cuda").manual_seed(5)
    noisy = d * (1 + 0.01 * torch.randn(d.shape, generator=g, device="cuda"))
    c2w, K = preds["camera_poses"][0].float(), preds["camera_intrs"][0].float()
    pts, _, _ = geometry.depth_to_world_coords_points(noisy, c2w, K)
    w2c_ba = torch.linalg.inv(c2w)
    M = S * (-(-HW // 16)) ** 2
    tracks = ba.build_tracks(pts, preds["pts3d_conf"][0].float(), d, w2c_ba, K,
                             pad_to=-(-M // 2) * 2)
    one = {str(dt)[6:]: ba.bundle_adjust(*ba_inputs(w2c_ba, K, tracks, dt, "cuda"),
                                         iters=12)
           for dt in (torch.float64, torch.float32)}
    tracks_np = [t.cpu().numpy() for t in tracks]

    # the ranks
    t0 = time.time()
    runs = {}
    runs[2] = mesh_lib.spawn(multi_jobs, 2, backend="gloo", device="cuda", args=([
        ("multi_sharded_forward", ((1, 2, 1), imgs, cams)),
        ("multi_render", (scene, HW)),
        ("multi_ba", (w2c_ba.cpu().numpy(), K.cpu().numpy(), tracks_np)),
        ("multi_dryrun", (True,))],))
    log(f"phase 17: 2 ranks on the card, {time.time() - t0:.1f} s wall")
    t0 = time.time()
    runs[4] = mesh_lib.spawn(multi_jobs, 4, backend="gloo", device="cuda", args=([
        ("multi_sharded_forward", ((1, 2, 2), imgs, cams)),
        ("multi_render", (scene, HW)),
        ("multi_dryrun", (False,))],))
    log(f"phase 17: 4 ranks on the card, {time.time() - t0:.1f} s wall")

    # (a), (b): launches, collectives, times, peaks and the band
    for n, dims in ((2, (1, 2, 1)), (4, (1, 2, 2))):
        tag = "a" if n == 2 else "b"
        fwd = [r["multi_sharded_forward"] for r in runs[n]]
        for r, f in enumerate(fwd):
            k1, k1b, k2, k4 = f["counts"]
            log(f"({tag}) mesh {dims} rank {r} {f['coords']}: launches K1a {k1 - k1b} "
                f"(K1c {f['f32_launches']} of them) K1b {k1b} K2 {k2} K4 {k4}; forward ms "
                f"{[round(t, 2) for t in f['ms']]}; "
                f"peak {f['peak_gb']:.2f} GB")
            log(f"({tag})   rank {r} collectives a forward: " + json.dumps(f["comm"]))
            if (k1b, k2, k4) != (0, 0, S // dims[1]) or k1 - k1b != 64:
                raise AssertionError(f"({tag}) rank {r}: launches {f['counts']}, want "
                                     f"64 K1a, 0 K1b, 0 K2, {S // dims[1]} K4")
        ours = fwd[0]["preds"]
        for k in MULTI_KEYS:
            err = rel_l2(ours[k], ref["bf16"][k])
            log(f"({tag}) {k:18s} rel L2 against the one-device bf16 forward {err:.3e}; "
                f"bf16 against f32 trunk {band[k]:.3e}")
            if not (np.isfinite(ours[k]).all() and err <= band[k]):
                raise AssertionError(f"({tag}) {k}: {err} > {band[k]}")
        res[tag] = {"launches": fwd[0]["counts"], "f32_launches": fwd[0]["f32_launches"],
                    "forward_ms": float(np.median(
            [t for f in fwd for t in f["ms"]])), "peak_gb": max(f["peak_gb"] for f in fwd),
            "comm": fwd[0]["comm"], "rel_l2": {k: rel_l2(ours[k], ref["bf16"][k])
                                               for k in MULTI_KEYS}, "band": band}

    # (c): the distributed render against one device
    res["c"] = {}
    for n in (2, 4):
        rend = [r["multi_render"] for r in runs[n]]
        out = np.concatenate([r["out"] for r in rend])
        alpha = np.concatenate([r["alpha"] for r in rend])
        err = max(float(np.abs(out - dref).max()), float(np.abs(alpha - dalpha).max()))
        ok = (np.allclose(out, dref, atol=2e-5, rtol=1e-4)
              and np.allclose(alpha, dalpha, atol=2e-5, rtol=1e-4))
        ms = float(np.median([t for r in rend for t in r["ms"]]))
        log(f"(c) rasterize_distributed V={n}: max|d| {err:.3e} against rasterize(impl="
            f"'jax') on one device (atol 2e-5, rtol 1e-4); K4 launches a rank "
            f"{[r['counts'][3] for r in rend]}; {ms:.2f} ms a call (host clock)")
        if not ok or any(r["counts"][3] != S // n or r["counts"][2] for r in rend):
            raise AssertionError(f"(c) V={n}: max|d| {err}, launches "
                                 f"{[r['counts'] for r in rend]}")
        res["c"][n] = {"err": err, "ms": ms, "k4": rend[0]["k4"]}

    # (d), (e): the dry-run twin, its bf16 trunk and an f32 one
    t0 = time.time()
    runs[1] = mesh_lib.spawn(multi_jobs, 1, backend="gloo", device="cuda",
                             args=([("multi_dryrun", (False,))],))
    log(f"phase 17: 1 rank, {time.time() - t0:.1f} s wall")
    dry = {n: [r["multi_dryrun"] for r in runs[n]] for n in (1, 2, 4)}
    for n in (2, 4):
        log(f"(d) n={n} comm (rank 0, bf16 trunk) " + json.dumps(dry[n][0]["bfloat16"]["comm"]))
    losses = {(n, dt): [r[dt]["loss"] for r in dry[n]] for n in (1, 2, 4)
              for dt in ("bfloat16", "float32")}
    log("(d) losses by (n, trunk dtype), every rank: "
        + ", ".join(f"{k}: {v}" for k, v in losses.items()))
    for dt in ("bfloat16", "float32"):
        log(f"(d) {dt} loss terms (rank 0) n=1 / 2 / 4: " + "; ".join(
            f"{t} " + " / ".join(f"{dry[n][0][dt]['terms'][t]:.6g}" for n in (1, 2, 4))
            for t in dry[1][0][dt]["terms"]))
    # the f32 trunk: only the summation order differs between n. The bf16
    # trunk's rounding moves the toy's few large splats (the terms above
    # say which term moves), so there the losses are printed and only held
    # finite
    l1 = losses[(1, "float32")][0]
    for n in (2, 4):
        if not all(abs(x - l1) <= 1e-4 * abs(l1) for x in losses[(n, "float32")]):
            raise AssertionError(f"(d) float32 n={n} losses {losses[(n, 'float32')]} not "
                                 f"within 1e-4 of n=1's {l1}")
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"(d) a loss is not finite: {losses}")
    fl = [r["bfloat16"]["flagship"] for r in dry[2]]
    log(f"(d) dryrun_flagship ok: ViT-L dims + GS + distributed raster + ring attention, "
        f"mesh=(1,2,1) 112px loss={fl[0]['loss']:.4f}; peak memory a rank "
        f"{[round(f['peak_gb'], 2) for f in fl]} GB; comm " + json.dumps(fl[0]["comm"]))
    log("(d) dryrun_flagship 518px lower skipped: eager PyTorch has no separate "
        "lowering step to check")
    nccl = multichip.main(["--devices", str(torch.cuda.device_count()),
                           "--trunk-dtype", "float32"], log=log)
    log(f"(e) NCCL n={torch.cuda.device_count()} loss {nccl['loss']!r} against gloo "
        f"n=1's {l1!r} (f32 trunk): relative {abs(nccl['loss'] - l1) / abs(l1):.3e}")
    if not (np.isfinite(fl[0]["loss"]) and abs(nccl["loss"] - l1) <= 1e-4 * abs(l1)):
        raise AssertionError(f"(d)/(e) flagship loss {fl[0]['loss']}, NCCL loss "
                             f"{nccl['loss']} against gloo's {l1}")
    res["d"] = {"losses": {f"{n}/{dt}": v for (n, dt), v in losses.items()},
                "nccl": nccl["loss"], "flagship_loss": fl[0]["loss"],
                "flagship_peak_gb": max(f["peak_gb"] for f in fl)}

    # K1a at one rank's shapes of (a): encoder and frame layers on its 2
    # frames, the camera head on all 4 views
    res["k1"] = k1_rank_totals("mesh (1,2,1)", [
        ("encoder", (2, 1374, 16, 64), torch.bfloat16, 24),
        ("frame", (2, 1376, 16, 64), torch.bfloat16, 24),
        ("camera_head", (1, 4, 16, 128), torch.float32, 16)])
    # (f): BA with the landmarks sharded at V = 2, held in f64 (in f32 the
    # Schur step's rounding moves the LM path: printed beside it)
    fb = [r["multi_ba"] for r in runs[2]]
    res["f"] = {}
    for dt in ("float64", "float32"):
        poses1, _, c0, c1 = one[dt]
        dp = max(float(np.abs(f[dt]["poses"] - poses1.cpu().numpy()).max()) for f in fb)
        log(f"(f) BA {dt}, {tracks.mask.shape[0]} landmarks sharded over 2 ranks: cost "
            f"{fb[0][dt]['cost0']:.6e} -> {fb[0][dt]['cost']:.6e} (one device "
            f"{float(c0):.6e} -> {float(c1):.6e}); max|pose - one device's| {dp:.3e}; "
            f"{fb[0][dt]['ms']:.2f} ms for 12 iterations")
        res["f"][dt] = {"max_pose_diff": dp, "ms": fb[0][dt]["ms"]}
    if not all(np.allclose(f["float64"]["poses"], one["float64"][0].cpu().numpy(),
                           atol=1e-4, rtol=1e-4) for f in fb):
        raise AssertionError(f"(f) sharded BA's f64 poses off by {res['f']['float64']}")
    return res


# --- 18. the measuring tools ----------------------------------------------

ORACLE_BAND = 1e-4   # tests/test_rasterizer.py's own band against the oracle
# the headline row's shares of the card's peaks may not pass this
SHARE_LIMIT = 1.05


def phase_bench_headline():
    """(a) The bench twin's headline row in its own process, as the bench
    runs it: rc 0, every headline key, value > 0, 0 < mfu <= 1.05,
    e2e_sol_fraction <= 1.05, render_n_dropped >= 0 -> the row's dict."""
    from hunyuanworld_mirror_tpu_torch import bench
    cmd = [sys.executable, "-m", "hunyuanworld_mirror_tpu_torch.bench", "--row",
           json.dumps({"stage": "headline"})]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = r.stdout.strip().splitlines()
    log(f"bench headline row: rc {r.returncode}, {time.time() - t0:.1f} s wall; "
        f"its line: {lines[-1] if lines else '(none)'}")
    if r.returncode != 0:
        raise AssertionError(f"bench headline row: rc {r.returncode}: "
                             f"{r.stderr.strip()[-2000:]}")
    row = json.loads(lines[-1])
    missing = [k for k in bench.HEADLINE_KEYS if k not in row]
    if missing:
        raise AssertionError(f"bench headline row: keys missing {missing}")
    mfu, share = row["mfu"], row["sol"]["e2e_sol_fraction"]
    if not (row["value"] > 0 and 0 < mfu <= SHARE_LIMIT and share <= SHARE_LIMIT
            and row["render_n_dropped"] >= 0):
        raise AssertionError(f"bench headline row: value {row['value']}, mfu {mfu}, "
                             f"e2e_sol_fraction {share}, render_n_dropped "
                             f"{row['render_n_dropped']}")
    return row


def oracle_scenes():
    """(b)'s two scenes as (label, means, quats xyzw, scales, opacities,
    colours, viewmats, Ks, W, H): tests/test_rasterizer.py's (150 splats
    from seed 42, 2 cameras, 64 x 48, RGB) and 4096 splats from seed 3 at
    distinct depths (a permutation of 4096 evenly spaced z in [2, 6], 1e-3
    apart, far above the binning's 20-bit depth quantum) in one 128 x 128
    camera, opaque (0.8-1) and large enough (scales 0.03-0.15 at f = 100 px)
    that most pixels reach the early stop."""
    rng = np.random.default_rng(42)
    n, c = 150, 2
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[:, 2] += 4.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = rng.uniform(0.02, 0.2, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, size=(n,)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    for i in range(c):
        ca, sa = np.cos(0.15 * i), np.sin(0.15 * i)
        viewmats[i, :3, :3] = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]],
                                       dtype=np.float32)
        viewmats[i, 0, 3] = 0.2 * i
    Ks = np.tile(np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]],
                          dtype=np.float32), (c, 1, 1))
    scenes = [("test_rasterizer scene (150 splats, 2 cameras, 64 x 48)", means, quats,
               scales, opac, colors, viewmats, Ks, 64, 48)]
    rng = np.random.default_rng(3)
    n = 4096
    z = (2.0 + 4.0 * rng.permutation(n) / n).astype(np.float32)
    xy = rng.uniform(-0.6, 0.6, size=(n, 2)).astype(np.float32) * z[:, None]
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scenes.append((f"seeded scene ({n} splats at distinct depths, 128 x 128)",
                   np.concatenate([xy, z[:, None]], 1), quats,
                   rng.uniform(0.03, 0.15, size=(n, 3)).astype(np.float32),
                   rng.uniform(0.8, 1.0, size=(n,)).astype(np.float32),
                   rng.uniform(size=(n, 3)).astype(np.float32),
                   np.eye(4, dtype=np.float32)[None],
                   np.array([[[100.0, 0, 64.0], [0, 100.0, 64.0], [0, 0, 1]]],
                            dtype=np.float32), 128, 128))
    return scenes


def phase_oracle():
    """(b) K2 (`rasterize`, the flat route) and K4 (impl="jax") on the card
    against the port's dense oracle `rasterize_reference`, which does no
    binning, on each scene of oracle_scenes: nothing dropped, image and
    alpha within ORACLE_BAND -> {kernel: max|d|}."""
    from hunyuanworld_mirror_tpu_torch.ops import projection, rasterizer
    from hunyuanworld_mirror_tpu_torch.ops.rasterizer_ref import rasterize_reference
    errs = {"K2": 0.0, "K4": 0.0}
    for label, *arrays, W, H in oracle_scenes():
        means, quats, scales, opac, colors, viewmats, Ks = (
            torch.as_tensor(a, device="cuda") for a in arrays)
        cov = projection.quat_scale_to_covar_planes(quats, scales)
        pj = projection.fully_fused_projection(means, cov, viewmats, Ks, W, H)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ref = [rasterize_reference(pj.means2d[c], pj.conics[c], colors, opac,
                                   pj.depths[c], pj.radii[c], W, H)
               for c in range(viewmats.shape[0])]
        ref_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        for kernel, impl in (("K2", "pallas"), ("K4", "jax")):
            reset_counts()
            img, alpha, meta = rasterizer.rasterize(
                means, quats, scales, opac, colors, viewmats, Ks, W, H,
                render_mode="RGB", max_per_tile=means.shape[0],
                max_tiles_per_gauss=16, impl=impl, device="cuda")
            k1, _, k2, k4 = read_counts()
            launched = k2 if kernel == "K2" else k4
            dropped = int(meta["n_dropped"].sum())
            d_img = max(float((img[c] - r[0]).abs().max()) for c, r in enumerate(ref))
            d_alpha = max(float((alpha[c] - r[1]).abs().max())
                          for c, r in enumerate(ref))
            log(f"oracle, {label}: {kernel} ({launched} launches, n_dropped {dropped}) "
                f"max|d| image {d_img:.3e} alpha {d_alpha:.3e} (band {ORACLE_BAND:.0e}); "
                f"intersections {meta['n_isects'].tolist()}; the oracle's peak "
                f"memory over what the process held {ref_gb:.2f} GB")
            if launched != viewmats.shape[0] or dropped:
                raise AssertionError(f"oracle, {label}: {kernel} launched {launched} "
                                     f"times, dropped {dropped}")
            if not max(d_img, d_alpha) <= ORACLE_BAND:
                raise AssertionError(f"oracle, {label}: {kernel} off the oracle by "
                                     f"{max(d_img, d_alpha):.3e}")
            errs[kernel] = max(errs[kernel], d_img, d_alpha)
        del ref
    return errs


def phase_trace():
    """(d) torch.profiler around one main-path forward (after a warm-up)
    recorded with the program's spans (utils/profiling.recording): the
    Chrome trace written, every span a user annotation in it, device time
    for K1 (attn_bf16_kernel) and K2 (raster_flat_kernel) in its
    key_averages() -> their device ms, the forward's device ms and wall
    ms."""
    from hunyuanworld_mirror_tpu_torch.infer import PRESETS, load_model, reconstruct
    from hunyuanworld_mirror_tpu_torch.models.worldmirror import WorldMirrorConfig
    from hunyuanworld_mirror_tpu_torch.utils import profiling
    model = load_model(WorldMirrorConfig(**PRESETS["large"]), device="cuda")
    imgs = np.random.default_rng(0).uniform(size=(1, 4, 518, 518, 3)).astype(np.float32)
    cams = fixed_cameras(4)
    reconstruct(model, imgs, cams)
    torch.cuda.synchronize()
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "smoke_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, profiling.recording() as rec:
        t0 = time.time()
        reconstruct(model, imgs, cams)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        annotated = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation"}
    missing = {sp.name for r in rec.requests for sp in r.spans} - annotated
    if missing:
        raise AssertionError(f"trace: spans with no user annotation: {sorted(missing)}")
    dev = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
           if e.device_time_total > 0}
    kern = {k: sum(ms for key, ms in dev.items() if pat in key)
            for k, pat in (("K1", "attn_bf16_kernel"), ("K2", "raster_flat_kernel"))}
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    files = os.listdir(log_dir)
    log(f"trace of one forward: {files} in {log_dir}; device time by kernel: K1 "
        f"{kern['K1']:.3f} ms, K2 {kern['K2']:.3f} ms, every kernel {busy:.3f} ms of the "
        f"forward's {wall_ms:.1f} ms wall under the profiler (idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f})")
    if not files or not (kern["K1"] > 0 and kern["K2"] > 0):
        raise AssertionError(f"trace: no file or no device time for K1 / K2: {kern}")
    kern.update(device_ms=busy, wall_ms=wall_ms)
    return kern


def phase_measuring_tools():
    """Phase 18: (a) the bench's headline row, (b) K2 and K4 against the
    oracle, (c) the heads-profile twin, (d) a trace of one forward."""
    from hunyuanworld_mirror_tpu_torch import heads_profile
    row = phase_bench_headline()
    oracle = phase_oracle()
    heads = heads_profile.main([])
    return {"bench": row, "oracle": oracle, "heads": heads, "trace": phase_trace()}


# --- 19. the render, binning and conv tools ------------------------------------

def phase_render_tools():
    """Phase 19: the six measuring tools of the render, the binning and the
    heads' convolutions, each once at --iters 2 (the scene's tools on one
    fixed-camera scene); each tool raises on a failed check of its own,
    and this phase checks their results again -> their results."""
    from hunyuanworld_mirror_tpu_torch import (bin_ab, conv_ab, isect_stats,
                                               render_profile, render_sweep, sort_ab2)
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_binned
    from hunyuanworld_mirror_tpu_torch.ops import rasterizer_flat as R
    from hunyuanworld_mirror_tpu_torch.utils.scenes import render_scene
    scene = render_scene(device="cuda")
    counters = (R.rasterize_flat, R.rasterize_flat_multi, R.rasterize_flat_grouped,
                rasterizer_binned.rasterize_binned)
    for fn in counters:
        fn.launches = 0
    iters = ["--iters", "2"]
    out = {"render_profile": render_profile.main(iters, scene=scene),
           "render_sweep": render_sweep.main(iters, scene=scene),
           "bin_ab": bin_ab.main(iters), "sort_ab2": sort_ab2.main(iters),
           "isect_stats": isect_stats.main([], scene=scene),
           "conv_ab": conv_ab.main(iters, scene=scene)}
    launches = dict(zip(("K2", "K2m", "K5", "K4"), (fn.launches for fn in counters)))
    rp, st = out["render_profile"], out["isect_stats"]
    failed = []
    if not (rp["stages_equal"] and rp["dm_delta"]["median"] < 1e-3):
        failed.append(f"render_profile: stages equal {rp['stages_equal']}, "
                      f"camera-batched |d| {rp['dm_delta']}")
    if not out["bin_ab"]["composed_equal"]:
        failed.append("bin_ab: the pieces differ from bin_gaussians_packed")
    if not all(v["equal"] for r in out["sort_ab2"]["ab"].values() for v in r.values()):
        failed.append("sort_ab2: a permutation differs from the shipped one")
    for c, (cnt, n, drop) in enumerate(zip(st["per_camera"], st["render_n_isects"],
                                           st["render_n_dropped"])):
        if not (cnt["ellipse"] <= cnt["tight"] <= cnt["aabb"] and n <= cnt["binned"]
                and (drop or n == cnt["binned"])):
            failed.append(f"isect_stats camera {c}: {cnt}, render {n}, dropped {drop}")
    for r in out["conv_ab"]["convs"]:
        for name, v in r["variants"].items():
            if not v["rel_delta"] <= conv_ab.band(name):
                failed.append(f"conv_ab {r['label']} {name}: {v['rel_delta']:.3e}")
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if flags != (False, False, False):
        failed.append(f"conv_ab left cudnn.benchmark, cudnn / matmul TF32 at {flags}")
    if not all(launches.values()):
        failed.append(f"a rasterizer was not launched: {launches}")
    ms = rp["ms"]
    log(f"render and conv tools: launches {launches}; gs_render stages A {ms['A']:.3f}, "
        f"B {ms['B']:.3f}, C {ms['C']:.3f}, D {ms['D']:.3f} (D1 {ms['D1']:.3f}, D2 "
        f"{ms['D2']:.3f}, D3 {ms['D3']:.3f}) ms, summed {ms['stages_sum']:.3f} against "
        f"the composed render's {ms['render']:.3f}; the heads' convs at f32 "
        f"{out['conv_ab']['sums_ms']['f32']:.3f} ms of the heads' "
        f"{out['conv_ab']['heads_f32_ms']:.3f}")
    if failed:
        raise AssertionError("render and conv tools: " + "; ".join(failed))
    return out


def timed(name, fn, *args):
    t0 = time.time()
    out = fn(*args)
    log(f"phase {name}: {time.time() - t0:.1f} s wall")
    return out


T_START = time.time()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device_name, smi = timed("device", phase_device)
    timed("build", phase_build)
    k1 = timed("K1", phase_k1)
    timed("K2 synthetic", phase_k2_synthetic)
    launches, k2, preds, imgs = timed("main path", phase_main_path)
    timed("card vs CPU", phase_cpu_reference)
    timed("K3", phase_k3, preds)
    k3_launches, k3, train_inputs, train_ref = timed("training", phase_train, preds,
                                                     imgs)
    k2m_launches, k2m = timed("K2m", phase_k2m, preds)
    k5_launches, k5 = timed("K5", phase_k5, preds, train_inputs)
    k4_launches, k4 = timed("K4", phase_k4, preds)
    cli = timed("CLI flags", phase_cli_flags, imgs)
    trainer = timed("trainer flags", phase_trainer_flags, preds, imgs, train_inputs,
                    train_ref)
    cams = timed("camera models", phase_camera_models, preds, imgs, train_inputs,
                 train_ref)
    cs = timed("CenterSnap trainer", phase_centersnap)
    ev = timed("app and eval", phase_app_eval, preds, imgs)
    mc = timed("multi-device", phase_multichip, preds, imgs)
    tools = timed("measuring tools", phase_measuring_tools)
    timed("render and conv tools", phase_render_tools)
    kernels = [
        {"name": "attention_fwd (N <= 4095, bf16: encoder, frame)",
         "route": "cuda", "source": "hunyuanworld_mirror_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "hunyuanworld_mirror_tpu/ops/attn_onepass.py:57",
         "launches": (launches["attention_fwd"] - launches["attention_fwd_flash_route"]
                      - launches["attention_fwd_f32"]),
         "max_abs_err": k1["K1a"]["err"], "ms": k1["K1a"]["ms"],
         "plain_ms": k1["K1a"]["plain_ms"], "bound_ms": k1["K1a"]["bound_ms"],
         "bound_by": "operations", "library_ms": k1["K1a"]["library_ms"]},
        {"name": "attention_fwd (N >= 4096: global)",
         "route": "cuda", "source": "hunyuanworld_mirror_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "hunyuanworld_mirror_tpu/models/block.py:162",
         "launches": launches["attention_fwd_flash_route"],
         "max_abs_err": k1["K1b"]["err"], "ms": k1["K1b"]["ms"],
         "plain_ms": k1["K1b"]["plain_ms"], "bound_ms": k1["K1b"]["bound_ms"],
         "bound_by": "operations", "library_ms": k1["K1b"]["library_ms"]},
        {"name": "rasterize_flat_fwd", "route": "cuda",
         "source": "hunyuanworld_mirror_tpu_torch/csrc/rasterize_flat_fwd.cu",
         "replaces": "hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:337",
         "launches": launches["rasterize_flat_fwd"], "max_abs_err": k2["err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "operations" if "operations" in k2["by"] else "bytes",
         "library_ms": None},
        {"name": "rasterize_flat_bwd", "route": "cuda",
         "source": "hunyuanworld_mirror_tpu_torch/csrc/rasterize_flat_bwd.cu",
         "replaces": "hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:865",
         "launches": k3_launches, "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": "operations" if "operations" in k3["by"] else "bytes",
         "library_ms": None},
    ]
    for kernel, source, replaces, count, row in (
            ("rasterize_flat_multi_fwd", "rasterize_flat_fwd.cu", 771, k2m_launches, k2m),
            ("rasterize_flat_grouped (K2's entry on the clamped lists)",
             "rasterize_flat_fwd.cu", 467, k5_launches, k5),
            ("rasterize_binned_fwd", "rasterize_binned_fwd.cu", 138, k4_launches, k4)):
        kernels.append(
            {"name": kernel, "route": "cuda",
             "source": f"hunyuanworld_mirror_tpu_torch/csrc/{source}",
             "replaces": f"hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:{replaces}",
             "launches": count, "max_abs_err": row["err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["by"], "library_ms": None})

    def sub(row, launches):
        return {"launches": launches, "max_abs_err": row["err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["by"]}

    # the phase-12 paths: K2 on the --fast-binning forward's prefix lists and
    # on one --video frame, K4 on the --rasterizer jax forward
    kernels[2]["fast_binning_forward"] = sub(cli["k2_prefix"], 4)
    kernels[2]["video_frame"] = {**sub(cli["video"]["k2_frame"], 1),
                                 "launches": cli["video"]["launches"],
                                 "frames": cli["video"]["frames"]}
    kernels[-1]["rasterizer_jax_forward"] = sub(cli["k4_forward"], 4)
    # the phase-13 paths: K3 in an MCMC step, K4 as the --rasterizer jax
    # training step's forward (its backward is the plain replay)
    kernels[3]["mcmc_step"] = {"launches": trainer["mcmc"]["launches"],
                               "step_ms": trainer["mcmc"]["step_ms"]}
    tj = trainer["jax"]
    kernels[-1]["training_step"] = {**sub(tj, 4), "forward_ms": tj["forward_ms"],
                                    "plain_backward_ms": tj["plain_backward_ms"],
                                    "max_per_tile": tj["max_per_tile"]}
    # the phase-14 paths: K2 and K4 on each UT route's lists (per render of the
    # 4 cameras), K2 and K2m in each render mode, K3 on the fisheye lists
    ut, pin_ms, pin = cams["ut"]
    kernels[2]["ut_routes"] = {name: {**sub(r["k2"], 4), "rasterize_ms": r["pallas"]["ms"],
                                      "pinhole_rasterize_ms": pin_ms["pallas"],
                                      "pinhole_f32_lists_ms": pin["k2"]["ms"],
                                      "n_isects": r["pallas"]["n_isects"]}
                               for name, r in ut.items()}
    kernels[-1]["ut_routes"] = {name: {**sub(r["k4"], 4), "rasterize_ms": r["jax"]["ms"],
                                       "pinhole_rasterize_ms": pin_ms["jax"],
                                       "pinhole_lists_ms": pin["k4"]["ms"]}
                                for name, r in ut.items()}
    kernels[2]["render_modes"] = {m: sub(r["k2"], 4) for m, r in cams["modes"].items()}
    kernels[4]["render_modes"] = {m: sub(r["k2m"], 1) for m, r in cams["modes"].items()}
    kernels[3]["fisheye_lists"] = sub(cams["k3"], 4)
    # phase 15: K1 in a CenterSnap training step at the CLI's defaults (B=20,
    # 384 px, N=581): 4 launches forward, the backward 4 replays of the JAX
    # VJP's einsum math (no launch)
    k1cs = cs["k1"]["centersnap_384"]
    kernels[0]["centersnap_step"] = {
        "launches": 4, "backward_launches": 0, "max_abs_err": k1cs["err"],
        "forward_max_abs_err": k1cs["fwd_err"],
        "ms": 4 * k1cs["ms"], "plain_ms": 4 * k1cs["plain_ms"],
        "bound_ms": 4 * k1cs["bound_ms"], "library_ms": 4 * k1cs["library_ms"],
        "replay_ms": 4 * k1cs["replay_ms"],
        "step_ms": cs["cli"]["first"]["median"]["total"]}
    # phase 16: a POST /run of 4 uploaded views to the app twin (medians of 3
    # requests; each launch count from every request), and one on the
    # --rasterizer jax route
    a = ev["app"]
    a_k1a, a_k1b, a_k1c, a_k2, _ = a["launches"][0]
    for row, n in ((kernels[0], a_k1a), (kernels[1], a_k1b), (kernels[2], a_k2)):
        row["app_request"] = {"launches": n, "request_ms": a["request_ms"],
                              "elapsed_ms": a["elapsed_ms"]}
    kernels[-1]["app_request_jax"] = {"launches": a["jax"]["counts"][3],
                                      "request_ms": a["jax"]["ms"],
                                      "elapsed_ms": a["jax"]["elapsed_ms"]}
    # phase 17: K1a per rank on the sharded forward at mesh (1,2,1) (its
    # launches from rank 0's counted forward, its times at that rank's
    # shapes; `launches_122` at (1,2,2)), K4 on the distributed render (the
    # launches a rank in the sharded forward, the kernel numbers on rank
    # 0's first camera's exchanged lists at V = 2)
    k1m = mc["k1"]
    kernels[0]["multichip_forward"] = {
        "launches": mc["a"]["launches"][0] - mc["a"]["f32_launches"],
        "launches_122": mc["b"]["launches"][0] - mc["b"]["f32_launches"],
        "max_abs_err": k1m["err"], "ms": k1m["ms"], "plain_ms": k1m["plain_ms"],
        "bound_ms": k1m["bound_ms"], "bound_by": "operations",
        "library_ms": k1m["library_ms"], "forward_ms": mc["a"]["forward_ms"],
        "forward_ms_122": mc["b"]["forward_ms"]}
    k4m = mc["c"][2]["k4"]
    kernels[-1]["distributed_render"] = {
        "launches": mc["a"]["launches"][3], "max_abs_err": k4m[0], "ms": k4m[1],
        "plain_ms": k4m[2], "bound_ms": k4m[3], "bound_by": k4m[4], "library_ms": None,
        "call_ms_v2": mc["c"][2]["ms"], "call_ms_v4": mc["c"][4]["ms"]}
    # phase 18: K2 and K4 against the dense oracle (no binning), and K1's and
    # K2's device ms in the trace of one forward
    kernels[2]["oracle_max_abs_err"] = tools["oracle"]["K2"]
    kernels[-1]["oracle_max_abs_err"] = tools["oracle"]["K4"]
    kernels[0]["traced_forward_device_ms"] = tools["trace"]["K1"]
    kernels[2]["traced_forward_device_ms"] = tools["trace"]["K2"]
    # K1c, K1's f32 route (the camera head), beside K1a and K1b: per forward
    # at the main path's N = 4, its N = 32 numbers beside them
    k1c = k1["K1c"]
    kernels.insert(2, {
        "name": "attention_fwd (f32: camera head, K1c)", "route": "cuda",
        "source": "hunyuanworld_mirror_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "hunyuanworld_mirror_tpu/ops/attn_onepass.py:57",
        "launches": launches["attention_fwd_f32"], "max_abs_err": k1c["err"],
        "ms": k1c["ms"], "plain_ms": k1c["plain_ms"], "bound_ms": k1c["bound_ms"],
        "bound_by": k1c["bound_by"], "library_ms": k1c["library_ms"],
        "device_ms": k1c["device_ms"], "library_device_ms": k1c["library_device_ms"],
        "n32": k1c[f"n{K1C_TIMED_N[1]}"],
        "app_request": {"launches": a_k1c, "request_ms": a["request_ms"],
                        "elapsed_ms": a["elapsed_ms"]},
        "multichip_forward": {"launches": mc["a"]["f32_launches"],
                              "launches_122": mc["b"]["f32_launches"]}})
    log(f"chip_smoke: {time.time() - T_START:.1f} s wall in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
