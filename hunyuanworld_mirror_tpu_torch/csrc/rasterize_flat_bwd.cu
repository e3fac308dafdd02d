// Kernel K3: flat tile-rasterizer backward (3D Gaussian splats), for sm_90a.
//
// Replaces (TPU, Pallas): hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:
// _kernel_flat_bwd (launched from _backward_flat, the custom VJP of
// rasterize_flat_pallas). Input is the forward's own sorted list (the f32
// payload [mx, my, ca, cb, cc, op, col_0 .. col_{D-1}], tile t owning entries
// [starts[t], starts[t] + counts[t])), the cotangents v_img (H, W, D) and
// v_alpha (H, W, 1), and two planes kernel K2 writes for training: each
// pixel's final transmittance and the tile-local index of its last kept
// entry.
//
// Per pixel and kept entry i (K2's keep and stop rules), with
// g_i = <v_out, c_i> + v_alpha, w_i = alpha_i T_i, S_i = sum_{j>i} w_j g_j:
//   d alpha_i = T_i g_i - S_i / max(1 - alpha_i, 1e-3)
//   d sigma   = -d alpha alpha [alpha < 0.999],  d op = d alpha e^-sigma [alpha < 0.999]
//   d mx = -d sigma (ca dx + cb dy),  d my = -d sigma (cc dy + cb dx)
//   d conic = d sigma (dx^2 / 2, dx dy, dy^2 / 2),  d col = w v_out
//   absgrad (AbsGS) = (|d mx|, |d my|) of each pixel's own term.
// The output is one row block per entry, grad (8 + D, M): rows
// [mx, my, ca, cb, cc, op, col_0 .. col_{D-1}, |mx|, |my|], each summed over
// the tile's pixels. The wrapper scatters it to splats by the entry -> splat
// map (index_add_), as the JAX package scatters in XLA.
//
// Design (the structure of gsplat's backward, not the TPU's two front-to-
// back sweeps): one block of tile_size^2 threads per tile, one thread per
// pixel. The block walks its tile's list BACK TO FRONT, from the largest
// last-kept index of its pixels, in batches of blockDim entries staged in
// shared memory. Each thread holds S exactly in a register (no
// total - prefix cancellation) and recovers T_i = T_{i+1} / (1 - alpha_i),
// exact up to rounding since 1 - alpha >= 1e-3. Per entry, the 8 + D values
// are summed over a warp with shuffles (skipped when no lane of the warp
// contributes), then one shared-memory atomicAdd per warp; after the batch
// the block writes its entries' rows with coalesced stores. An entry
// belongs to one tile, so no two blocks write the same row.
//
// What bounds it on this card: bytes and operations about equally. Per entry
// it reads 44 bytes of list and id and writes 48 bytes of grads; per
// (pixel, entry) pair it walks it runs the keep test (~10 FP32 operations),
// and only the pairs that pass (~5% on 518 px scenes) cost ~60 operations
// more. On an H100 it runs ~80x off that bound (~2.4 ms for a list of 0.7M
// entries): the (8 + D) * 5 warp shuffles that sum each entry over a warp
// run whenever one lane keeps the entry. The warp vote that skips an entry
// no lane keeps is what this design does about it so far; the shuffle
// reductions are the next cost to cut.
//
// C interface: rasterize_flat_bwd(...) returns cudaGetLastError().

#include "raster_common.cuh"

namespace {

using raster::ALPHA_THRESHOLD;
using raster::MAX_D;
using raster::conic_sigma;  // K2's sigma, so that K3 keeps exactly the pairs K2 kept

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  return v;
}

__global__ void raster_flat_bwd_kernel(const float* __restrict__ packed,
                                       const int* __restrict__ starts,
                                       const int* __restrict__ counts,
                                       const float* __restrict__ v_img,
                                       const float* __restrict__ v_alpha,
                                       const float* __restrict__ t_final,
                                       const int* __restrict__ last_in,
                                       float* __restrict__ grad,
                                       int width, int height, int tile_size, int tiles_x,
                                       int d_col, long long M) {
  extern __shared__ float sm[];
  __shared__ int s_n_live;
  const int nthr = blockDim.x;
  const int n_rows = 8 + d_col;
  float* s_mx = sm;
  float* s_my = sm + nthr;
  float* s_ca = sm + 2 * nthr;
  float* s_cb = sm + 3 * nthr;
  float* s_cc = sm + 4 * nthr;
  float* s_op = sm + 5 * nthr;
  float* s_col = sm + 6 * nthr;              // (d_col, nthr)
  float* s_acc = s_col + d_col * nthr;       // (n_rows, nthr)

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pxi = (t % tiles_x) * tile_size + tid % tile_size;
  const int pyi = (t / tiles_x) * tile_size + tid / tile_size;
  const bool inside = pxi < width && pyi < height;
  const float px = float(pxi) + 0.5f;
  const float py = float(pyi) + 0.5f;
  const long long start = starts[t];
  const int count = counts[t];

  float T = 1.f, va = 0.f, S = 0.f;
  float vout[MAX_D];
  int last = -1;
#pragma unroll
  for (int c = 0; c < MAX_D; ++c) vout[c] = 0.f;
  if (inside) {
    const long long p = static_cast<long long>(pyi) * width + pxi;
    T = t_final[p];
    last = min(last_in[p], count - 1);
    va = v_alpha[p];
#pragma unroll
    for (int c = 0; c < MAX_D; ++c)
      if (c < d_col) vout[c] = v_img[p * d_col + c];
  }
  if (tid == 0) s_n_live = 0;
  __syncthreads();
  if (last >= 0) atomicMax(&s_n_live, last + 1);
  __syncthreads();
  const int n_live = s_n_live;

  for (int b_end = n_live; b_end > 0; b_end -= nthr) {
    // barrier: the previous batch's rows are written out before reuse
    __syncthreads();
    const int jl = b_end - 1 - tid;         // thread tid stages entry jl
    if (jl >= 0) {
      const long long e = start + jl;
      s_mx[tid] = packed[e];
      s_my[tid] = packed[M + e];
      s_ca[tid] = packed[2 * M + e];
      s_cb[tid] = packed[3 * M + e];
      s_cc[tid] = packed[4 * M + e];
      s_op[tid] = packed[5 * M + e];
      for (int c = 0; c < d_col; ++c) s_col[c * nthr + tid] = packed[(6 + c) * M + e];
    }
    for (int r = 0; r < n_rows; ++r) s_acc[r * nthr + tid] = 0.f;
    __syncthreads();

    const int nb = min(nthr, b_end);
    for (int i = 0; i < nb; ++i) {           // entry b_end - 1 - i, back to front
      // this pixel's terms: mx, my, ca, cb, cc, op | colours | |mx|, |my|
      float f[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float fc[MAX_D];
#pragma unroll
      for (int c = 0; c < MAX_D; ++c) fc[c] = 0.f;
      float ax = 0.f, ay = 0.f;
      bool contrib = false;
      if (b_end - 1 - i <= last) {
        const float dx = px - s_mx[i];
        const float dy = py - s_my[i];
        const float ca = s_ca[i], cb = s_cb[i], cc = s_cc[i];
        const float sigma = conic_sigma(ca, cb, cc, dx, dy);
        const float ex = expf(-sigma);
        const float raw = s_op[i] * ex;
        if (sigma >= 0.f && raw >= ALPHA_THRESHOLD) {
          contrib = true;
          const float a = fminf(0.999f, raw);
          const float one_m = fmaxf(1.f - a, 1e-3f);
          // K2 multiplied T by exactly (1 - a); one_m is the formula's divisor
          const float T_before = T / (1.f - a);
          float g = va;
#pragma unroll
          for (int c = 0; c < MAX_D; ++c)
            if (c < d_col) g += vout[c] * s_col[c * nthr + i];
          const float w = a * T_before;
          const float dalpha = T_before * g - S / one_m;
          S += w * g;
          T = T_before;
          const float not_cl = raw < 0.999f ? 1.f : 0.f;
          const float dsig = -dalpha * a * not_cl;
          f[0] = -dsig * (ca * dx + cb * dy);
          f[1] = -dsig * (cc * dy + cb * dx);
          f[2] = dsig * 0.5f * dx * dx;
          f[3] = dsig * dx * dy;
          f[4] = dsig * 0.5f * dy * dy;
          f[5] = dalpha * ex * not_cl;
#pragma unroll
          for (int c = 0; c < MAX_D; ++c) fc[c] = w * vout[c];
          ax = fabsf(f[0]);
          ay = fabsf(f[1]);
        }
      }
      if (__any_sync(FULL_MASK, contrib)) {
        // warp sums, then one shared-memory add per warp and row
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          const float s = warp_sum(f[r]);
          if (lane == 0) atomicAdd(&s_acc[r * nthr + i], s);
        }
#pragma unroll
        for (int c = 0; c < MAX_D; ++c) {
          if (c < d_col) {
            const float s = warp_sum(fc[c]);
            if (lane == 0) atomicAdd(&s_acc[(6 + c) * nthr + i], s);
          }
        }
        const float sx = warp_sum(ax);
        const float sy = warp_sum(ay);
        if (lane == 0) {
          atomicAdd(&s_acc[(6 + d_col) * nthr + i], sx);
          atomicAdd(&s_acc[(7 + d_col) * nthr + i], sy);
        }
      }
    }
    __syncthreads();
    if (jl >= 0) {
      const long long e = start + jl;
      for (int r = 0; r < n_rows; ++r) grad[r * M + e] = s_acc[r * nthr + tid];
    }
  }
}

}  // namespace

extern "C" int rasterize_flat_bwd(const void* packed, const void* starts, const void* counts,
                                  const void* v_img, const void* v_alpha,
                                  const void* t_final, const void* last_in, void* grad,
                                  int width, int height, int tile_size, int tiles_x,
                                  int n_tiles, int d_col, long long M, void* stream) {
  const int nthr = tile_size * tile_size;
  if (d_col < 1 || d_col > MAX_D || nthr > 1024 || nthr % 32 != 0 || n_tiles < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = size_t(6 + d_col + 8 + d_col) * nthr * sizeof(float);
  if (smem > 48 * 1024) return int(cudaErrorInvalidValue);
  raster_flat_bwd_kernel<<<n_tiles, nthr, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const float*>(v_img),
      static_cast<const float*>(v_alpha), static_cast<const float*>(t_final),
      static_cast<const int*>(last_in), static_cast<float*>(grad), width, height,
      tile_size, tiles_x, d_col, M);
  return int(cudaGetLastError());
}
