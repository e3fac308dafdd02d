// Kernel K3: flat tile-rasterizer backward (3D Gaussian splats), for sm_90a.
//
// Replaces (TPU, Pallas): hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:
// _kernel_flat_bwd and the scatter of _backward_flat that follows it (the
// custom VJP of rasterize_flat_pallas). Input is the forward's own sorted
// list (the f32 payload [mx, my, ca, cb, cc, op, col_0 .. col_{D-1}], tile t
// owning entries [starts[t], starts[t] + counts[t])) with its entry -> splat
// map gauss_ids, the cotangents v_img (H, W, D) and v_alpha (H, W, 1), and
// the two planes kernel K2 writes for training: each pixel's final
// transmittance and the tile-local index of its last kept entry.
//
// Per pixel and kept entry i (K2's keep and stop rules), with
// g_i = <v_out, c_i> + v_alpha, w_i = alpha_i T_i, S_i = sum_{j>i} w_j g_j:
//   d alpha_i = T_i g_i - S_i / max(1 - alpha_i, 1e-3)
//   d sigma   = -d alpha alpha [alpha < 0.999],  d op = d alpha e^-sigma [alpha < 0.999]
//   d mx = -d sigma (ca dx + cb dy),  d my = -d sigma (cc dy + cb dx)
//   d conic = d sigma (dx^2 / 2, dx dy, dy^2 / 2),  d col = w v_out
//   absgrad (AbsGS) = (|d mx|, |d my|) of each pixel's own term.
// The output is one row block per splat, splat_grad (n_gauss, R) with
// R = 8 + D rounded up to 4: [mx, my, ca, cb, cc, op, col_0 .. col_{D-1},
// |mx|, |my|, 0 ...], each summed over the pixels of every tile the splat
// lies in. entry_grad (8 + D, M), the same rows per list entry, is added
// into only when its pointer is not null (to find where a fault lies).
//
// Design (gsplat's backward structure, not the TPU's two front-to-back
// sweeps): a tile's 16 x 16 pixels are split over SPLIT blocks, one thread
// per pixel, each warp a block of 8 x 4 pixels. A block walks its tile's
// list BACK TO FRONT from its pixels' largest last-kept index, in batches of
// BATCH entries staged in shared memory. Each thread holds S exactly in a
// register (no total - prefix cancellation) and recovers
// T_i = T_{i+1} / (1 - alpha_i), exact up to rounding since 1 - alpha >=
// 1e-3. What bounds it on this card is the work per (warp, entry) step:
// the keep test for 32 pixels (~10 FP32 operations a pair, ~1G pairs a
// training step) and, where a lane keeps the entry (~26% of the steps at
// 16 x 2 pixels a warp), ~60 operations more and the warp's sum of its
// pixels' terms. What the design does about each:
//   * the sum over pixels: a warp sums its pixels' 8 + D terms (padded to
//     16) in one transposed butterfly, 8 + 4 + 2 + 1 + 1 = 16 shuffles (a
//     5-shuffle tree per row takes 60 at D = 4), after which lanes 2r and
//     2r + 1 hold row r and 16 lanes store all rows at once into the warp's
//     own shared-memory slot (no shared-memory atomics). A warp skips an
//     entry none of its lanes keeps (vote).
//   * the steps no pixel can keep: before a batch is walked, each entry gets
//     the bounding box of its ellipse op e^-sigma >= 1/255, and a warp skips
//     an entry whose box misses its 8 x 4 pixels without testing them. The
//     compact warp shape makes both skips more frequent.
//   * the scatter: after each batch the block sums the warps' slots (in a
//     fixed order) and adds each entry's rows, if any pixel kept it, into
//     its splat's row with one 16-byte global reduction per 4 rows. There
//     is no per-entry buffer and no index_add_ over the list's capacity;
//     the bytes (the list and its ids, the pixel planes read once, the
//     splat rows reduced into) take a few tenths of a millisecond.
//   * the tail: every tile walks its whole list (its last entry is kept by
//     some pixel), the longest ~1.5x the mean on the training lists. SPLIT
//     blocks of 64 threads make 4x the blocks, each waiting at its barriers
//     for 2 warps rather than 8, and the wrapper hands the blocks the tiles
//     longest first (`order`), so the last to start are the short ones.
//
// Keep test: conic_sigma and expf exactly as K2, so that K3 keeps the pairs
// K2 kept (raster_common.cuh).
//
// C interface: rasterize_flat_bwd(...) returns cudaGetLastError().

#include "raster_common.cuh"

namespace {

using raster::ALPHA_THRESHOLD;
using raster::MAX_D;
using raster::conic_sigma;  // K2's sigma, so that K3 keeps exactly the pairs K2 kept

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_THREADS = 256;  // a block's pixels: one 16 x 16 tile at most
constexpr int BATCH = 64;         // entries staged per batch
constexpr int SLOT = 17;          // a warp's 16 rows of one entry, +1 against bank conflicts
// Design constants; tools/k3_ab.py --variants times each against other
// values on the training lists. SPLIT: the blocks a tile's pixels are split
// into (4: 64 threads, so a block waits at its barriers for 2 warps, not 8,
// and the grid has 4 x the blocks). WARP_W: the width of a warp's block of
// pixels (8: 8 x 4, more compact than 16 x 2, so fewer warps see each
// splat). BBOX: skip, for a whole warp, the entries whose ellipse of
// alpha >= 1/255 has a bounding box clear of the warp's pixels.
constexpr int SPLIT = 4;
constexpr int WARP_W = 8;
constexpr bool BBOX = true;

// One step of butterfly16: lanes whose bit 2H is set keep the upper H of
// their 2H values, the others the lower H; each adds its partner's copy of
// the half it keeps. H is a template constant so that every index is one
// and the choices are selects, not branches.
template <int H>
__device__ __forceinline__ void butterfly_step(float (&v)[16], int lane) {
  const bool up = (lane & (2 * H)) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? v[k] : v[k + H];
    const float keep = up ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL_MASK, send, 2 * H);
  }
}

// Sum 16 values over the warp, transposed: afterwards lanes 2r and 2r + 1
// hold the warp's sum of v[r] in v[0] (8 + 4 + 2 + 1 + 1 = 16 shuffles).
__device__ __forceinline__ void butterfly16(float (&v)[16], int lane) {
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  v[0] += __shfl_xor_sync(FULL_MASK, v[0], 1);
}

// Dynamic shared memory of a block of nthr threads: the staged payload
// (6 + D, BATCH), each entry's bounding box (4, BATCH), the warps' row
// slots (warps, BATCH, SLOT) and their flags (warps, BATCH).
size_t bwd_smem(int nthr, int d_col) {
  const size_t n_warps = nthr / 32;
  return ((size_t(6 + d_col) + 4) * BATCH + n_warps * BATCH * SLOT) *
             sizeof(float) +
         n_warps * BATCH * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(MAX_THREADS / SPLIT)
raster_flat_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ starts,
                       const int* __restrict__ counts, const int* __restrict__ gauss_ids,
                       const float* __restrict__ v_img, const float* __restrict__ v_alpha,
                       const float* __restrict__ t_final, const int* __restrict__ last_in,
                       const long long* __restrict__ order, float* __restrict__ splat_grad,
                       float* __restrict__ entry_grad, int width, int height,
                       int tile_size, int tiles_x, long long M) {
  constexpr int V = 6 + D;
  constexpr int ROWS = 8 + D;
  constexpr int GROUPS = (ROWS + 3) / 4;  // 16-byte reductions per entry
  extern __shared__ float sm[];
  __shared__ int s_live;
  const int nthr = blockDim.x;
  const int n_warps = nthr >> 5;
  float* s_pl = sm;                        // (V, BATCH) staged payload
  float* s_box = sm + V * BATCH;           // (4, BATCH) x0, x1, y0, y1: see BBOX
  float* s_red = s_box + 4 * BATCH;        // (n_warps, BATCH, SLOT) warp sums
  int* s_flag = reinterpret_cast<int*>(s_red + n_warps * BATCH * SLOT);  // (n_warps, BATCH)

  // block -> tile t (in `order`, if given) and its part-th share of pixels;
  // a warp covers a block of ww x 32 / ww pixels
  const int t = order != nullptr ? int(order[blockIdx.x / SPLIT]) : blockIdx.x / SPLIT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wi = (blockIdx.x % SPLIT) * n_warps + warp;  // warp of the tile
  const int ww = min(WARP_W, tile_size);
  const int pxi = (t % tiles_x) * tile_size + (wi % (tile_size / ww)) * ww + lane % ww;
  const int pyi = (t / tiles_x) * tile_size + (wi / (tile_size / ww)) * (32 / ww) + lane / ww;
  const float px = float(pxi) + 0.5f;
  const float py = float(pyi) + 0.5f;
  // the centres of the warp's corner pixels
  const float wx0 = float((t % tiles_x) * tile_size + (wi % (tile_size / ww)) * ww) + 0.5f;
  const float wy0 =
      float((t / tiles_x) * tile_size + (wi / (tile_size / ww)) * (32 / ww)) + 0.5f;
  const float wx1 = wx0 + float(ww - 1), wy1 = wy0 + float(32 / ww - 1);
  const long long start = starts[t];
  const int count = counts[t];

  float T = 1.f, va = 0.f, S = 0.f;
  float vout[D];
#pragma unroll
  for (int c = 0; c < D; ++c) vout[c] = 0.f;
  int last = -1;
  if (pxi < width && pyi < height) {
    const long long p = static_cast<long long>(pyi) * width + pxi;
    T = t_final[p];
    last = min(last_in[p], count - 1);
    va = v_alpha[p];
#pragma unroll
    for (int c = 0; c < D; ++c) vout[c] = v_img[p * D + c];
  }
  // the warp's and the block's walk: to their pixels' largest last index
  const int wmax = __reduce_max_sync(FULL_MASK, last);
  if (tid == 0) s_live = -1;
  __syncthreads();
  if (lane == 0) atomicMax(&s_live, wmax);
  __syncthreads();
  const int n_live = s_live + 1;

  for (int hi = n_live; hi > 0; hi -= BATCH) {
    const int lo = max(hi - BATCH, 0);
    const int nb = hi - lo;
    // barrier: the previous batch's slots are summed before they refill
    __syncthreads();
    for (int q = tid; q < V * BATCH; q += nthr) {
      const int i = q % BATCH;
      if (i < nb) s_pl[q] = packed[(q / BATCH) * M + start + lo + i];
    }
    for (int i = lane; i < BATCH; i += 32) s_flag[warp * BATCH + i] = 0;
    __syncthreads();
    if (BBOX) {
      for (int i = tid; i < nb; i += nthr) {
        // K2's keep box (raster_common.cuh): no pair the keep test keeps
        // lies outside it
        const float4 box =
            raster::keep_box(s_pl[i], s_pl[BATCH + i], s_pl[2 * BATCH + i],
                             s_pl[3 * BATCH + i], s_pl[4 * BATCH + i], s_pl[5 * BATCH + i]);
        s_box[i] = box.x;
        s_box[BATCH + i] = box.y;
        s_box[2 * BATCH + i] = box.z;
        s_box[3 * BATCH + i] = box.w;
      }
      __syncthreads();
    }

    for (int j = min(hi - 1, wmax); j >= lo; --j) {  // back to front
      const int i = j - lo;
      if (BBOX && (s_box[BATCH + i] < wx0 || s_box[i] > wx1 ||
                   s_box[3 * BATCH + i] < wy0 || s_box[2 * BATCH + i] > wy1))
        continue;  // warp-uniform: no pixel of the warp keeps the entry
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = 0.f;
      bool contrib = false;
      if (j <= last) {
        const float dx = px - s_pl[i];
        const float dy = py - s_pl[BATCH + i];
        const float ca = s_pl[2 * BATCH + i], cb = s_pl[3 * BATCH + i];
        const float cc = s_pl[4 * BATCH + i];
        const float sigma = conic_sigma(ca, cb, cc, dx, dy);
        // K2's keep test: sigma >= 0 and op e^-sigma >= 1/255
        const float ex = sigma >= 0.f ? expf(-sigma) : 0.f;
        const float raw = s_pl[5 * BATCH + i] * ex;
        if (raw >= ALPHA_THRESHOLD) {
          contrib = true;
          const float a = fminf(0.999f, raw);
          // K2 multiplied T by exactly (1 - a); max(1 - a, 1e-3) is the
          // formula's divisor
          const float T_before = T / (1.f - a);
          float g = va;
#pragma unroll
          for (int c = 0; c < D; ++c) g += vout[c] * s_pl[(6 + c) * BATCH + i];
          const float w = a * T_before;
          const float dalpha = T_before * g - S / fmaxf(1.f - a, 1e-3f);
          S += w * g;
          T = T_before;
          const float not_cl = raw < 0.999f ? 1.f : 0.f;
          const float dsig = -dalpha * a * not_cl;
          v[0] = -dsig * (ca * dx + cb * dy);
          v[1] = -dsig * (cc * dy + cb * dx);
          v[2] = dsig * 0.5f * dx * dx;
          v[3] = dsig * dx * dy;
          v[4] = dsig * 0.5f * dy * dy;
          v[5] = dalpha * ex * not_cl;
#pragma unroll
          for (int c = 0; c < D; ++c) v[6 + c] = w * vout[c];
          v[6 + D] = fabsf(v[0]);
          v[7 + D] = fabsf(v[1]);
        }
      }
      if (__any_sync(FULL_MASK, contrib)) {
        butterfly16(v, lane);
        const int r = lane >> 1;
        if (!(lane & 1) && r < 4 * GROUPS) s_red[(warp * BATCH + i) * SLOT + r] = v[0];
        if (lane == 1) s_flag[warp * BATCH + i] = 1;
      }
    }
    __syncthreads();

    // each entry's block sum (the warps in order) into its splat's row
    for (int q = tid; q < GROUPS * BATCH; q += nthr) {
      const int i = q % BATCH;
      const int grp = q / BATCH;
      if (i >= nb) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      bool kept = false;
      for (int w = 0; w < n_warps; ++w) {
        if (!s_flag[w * BATCH + i]) continue;
        kept = true;
        const float* slot = s_red + (w * BATCH + i) * SLOT + 4 * grp;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += slot[c];
      }
      const long long e = start + lo + i;
      if (kept) {
        float* dst = splat_grad + static_cast<long long>(gauss_ids[e]) * (4 * GROUPS) + 4 * grp;
        atomicAdd(reinterpret_cast<float4*>(dst), make_float4(acc[0], acc[1], acc[2], acc[3]));
      }
      if (entry_grad != nullptr && kept) {
        // the tile's SPLIT blocks each add their pixels' share
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * grp + c < ROWS) atomicAdd(entry_grad + (4 * grp + c) * M + e, acc[c]);
      }
    }
  }
}

template <int D>
int launch(const void* packed, const void* starts, const void* counts, const void* gauss_ids,
           const void* v_img, const void* v_alpha, const void* t_final, const void* last_in,
           const void* order, void* splat_grad, void* entry_grad, int width, int height,
           int tile_size, int tiles_x, int n_tiles, long long M, cudaStream_t stream) {
  const int nthr = tile_size * tile_size / SPLIT;
  const size_t smem = bwd_smem(nthr, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_flat_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  raster_flat_bwd_kernel<D><<<n_tiles * SPLIT, nthr, smem, stream>>>(
      static_cast<const float*>(packed), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(gauss_ids),
      static_cast<const float*>(v_img), static_cast<const float*>(v_alpha),
      static_cast<const float*>(t_final), static_cast<const int*>(last_in),
      static_cast<const long long*>(order), static_cast<float*>(splat_grad),
      static_cast<float*>(entry_grad), width, height, tile_size, tiles_x, M);
  return int(cudaGetLastError());
}

}  // namespace

// splat_grad (n_gauss, 4 ceil((8 + d_col) / 4)) and entry_grad (8 + d_col,
// M), or null, both zeroed by the caller. order (n_tiles,) int64 is the order in
// which the blocks take the tiles, or null for 0, 1, ...
extern "C" int rasterize_flat_bwd(const void* packed, const void* starts, const void* counts,
                                  const void* gauss_ids, const void* v_img,
                                  const void* v_alpha, const void* t_final,
                                  const void* last_in, const void* order, void* splat_grad,
                                  void* entry_grad, int width, int height, int tile_size,
                                  int tiles_x, int n_tiles, int d_col, long long M,
                                  void* stream) {
  const int nthr = tile_size * tile_size / SPLIT;
  if (d_col < 1 || d_col > MAX_D || nthr * SPLIT != tile_size * tile_size ||
      nthr > MAX_THREADS || nthr % 32 != 0 || n_tiles < 1 ||
      tile_size % min(WARP_W, tile_size) != 0 || 32 % min(WARP_W, tile_size) != 0)
    return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (d_col) {
#define K3_CASE(DD)                                                                         \
  case DD:                                                                                  \
    return launch<DD>(packed, starts, counts, gauss_ids, v_img, v_alpha, t_final, last_in, \
                      order, splat_grad, entry_grad, width, height, tile_size, tiles_x,    \
                      n_tiles, M, s);
    K3_CASE(1) K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5) K3_CASE(6) K3_CASE(7) K3_CASE(8)
#undef K3_CASE
  }
  return int(cudaErrorInvalidValue);
}

// A block's dynamic shared memory in bytes (for occupancy arithmetic).
extern "C" int rasterize_flat_bwd_smem(int tile_size, int d_col) {
  return static_cast<int>(bwd_smem(tile_size * tile_size / SPLIT, d_col));
}

// Threads a block (a tile's pixels over SPLIT blocks).
extern "C" int rasterize_flat_bwd_threads(int tile_size) {
  return tile_size * tile_size / SPLIT;
}
