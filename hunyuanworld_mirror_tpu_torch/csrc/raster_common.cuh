// Shared pieces of the tile-rasterizer kernels, for sm_90a: the keep and stop
// rules, the sigma rounding, the f16 decode, and the front-to-back blend of
// one tile that the forward kernels K2 / K2m (rasterize_flat_fwd.cu), K5
// (rasterize_flat_grouped_fwd.cu) and K4 (rasterize_binned_fwd.cu) run. K3
// (rasterize_flat_bwd.cu) replays the same keep test with the same sigma.
//
// Every kernel that includes this header has to decide each (pixel, entry)
// pair exactly as the plain PyTorch versions do (ops/rasterizer_flat.py
// blend_groups, ops/rasterizer_binned.py): a pair at alpha ~ 1/255 that one
// rounding keeps and another drops moves T for the rest of its pixel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace raster {

constexpr int MAX_D = 8;
constexpr float ALPHA_THRESHOLD = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

// int32 holding f16 bits in its low 16 -> f32, subnormals flushed to 0 (the
// JAX decode, rasterizer_pallas._f16_bits_to_f32).
__device__ __forceinline__ float f16_bits_to_f32(uint32_t h) {
  const uint32_t s = (h & 0x8000u) << 16;
  const uint32_t e = (h >> 10) & 0x1Fu;
  const uint32_t m = h & 0x3FFu;
  const uint32_t mag = (e == 0u) ? 0u : (((e + 112u) << 23) | (m << 13));
  return __uint_as_float(s | mag);
}

// sigma = 0.5 (ca dx^2 + cc dy^2) + cb dx dy, rounded op by op in the plain
// version's order (no FMA contraction), so that every kernel keeps the pairs
// the plain version keeps.
__device__ __forceinline__ float conic_sigma(float ca, float cb, float cc, float dx,
                                             float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                            __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// One batch of blockDim entries staged in shared memory, decoded to f32:
// planes mx, my, ca, cb, cc, op, then d_col colour planes, nthr floats each.
struct Batch {
  float *mx, *my, *ca, *cb, *cc, *op, *col;
  int nthr;
  __device__ __forceinline__ Batch(float* sm, int n)
      : mx(sm), my(sm + n), ca(sm + 2 * n), cb(sm + 3 * n), cc(sm + 4 * n),
        op(sm + 5 * n), col(sm + 6 * n), nthr(n) {}
};

// Shared memory a forward block needs for one batch.
inline size_t batch_smem(int nthr, int d_col) {
  return size_t(6 + d_col) * nthr * sizeof(float);
}

// Stage entry e of a component-major (V, M) sorted list into slot s. f32
// layout [mx, my, ca, cb, cc, op, col_0 .. col_{D-1}]; f16 layout
// [mx, my, ca|cb, cc|op, col pairs ...], each packed row holding two f16
// values as (hi << 16) | lo.
__device__ __forceinline__ void stage_list_entry(const Batch& b, int s,
                                                 const float* __restrict__ packed,
                                                 long long M, long long e, int d_col,
                                                 int f16) {
  b.mx[s] = packed[e];
  b.my[s] = packed[M + e];
  if (!f16) {
    b.ca[s] = packed[2 * M + e];
    b.cb[s] = packed[3 * M + e];
    b.cc[s] = packed[4 * M + e];
    b.op[s] = packed[5 * M + e];
    for (int c = 0; c < d_col; ++c) b.col[c * b.nthr + s] = packed[(6 + c) * M + e];
  } else {
    const uint32_t u2 = __float_as_uint(packed[2 * M + e]);
    const uint32_t u3 = __float_as_uint(packed[3 * M + e]);
    b.ca[s] = f16_bits_to_f32(u2 >> 16);
    b.cb[s] = f16_bits_to_f32(u2 & 0xFFFFu);
    b.cc[s] = f16_bits_to_f32(u3 >> 16);
    b.op[s] = f16_bits_to_f32(u3 & 0xFFFFu);
    for (int c = 0; c < d_col; c += 2) {
      const uint32_t u = __float_as_uint(packed[(4 + c / 2) * M + e]);
      b.col[c * b.nthr + s] = f16_bits_to_f32(u >> 16);
      if (c + 1 < d_col) b.col[(c + 1) * b.nthr + s] = f16_bits_to_f32(u & 0xFFFFu);
    }
  }
}

// One pixel (one thread) of a tile: its centre and its blend so far.
struct Pixel {
  float px, py, T, asum;
  float acc[MAX_D];
  int last;   // tile-local index of the last kept entry, -1 if none
  bool done;  // outside the image, or T has fallen to T_EPS

  // Pixel threadIdx.x of tile t (tiles_x tiles to a row) -> its index in the
  // (height, width) image, or -1 when it lies on the pad past the image.
  __device__ __forceinline__ long long init(int t, int tiles_x, int tile_size, int width,
                                            int height) {
    const int pxi = (t % tiles_x) * tile_size + threadIdx.x % tile_size;
    const int pyi = (t / tiles_x) * tile_size + threadIdx.x / tile_size;
    const bool inside = pxi < width && pyi < height;
    px = float(pxi) + 0.5f;
    py = float(pyi) + 0.5f;
    T = 1.f;
    asum = 0.f;
    last = -1;
    done = !inside;
#pragma unroll
    for (int c = 0; c < MAX_D; ++c) acc[c] = 0.f;
    return inside ? static_cast<long long>(pyi) * width + pxi : -1;
  }

  // Walk the staged batch front to back; entry i has tile-local index b0 + i.
  //   alpha = min(0.999, op e^-sigma), kept iff sigma >= 0 and alpha >= 1/255
  //   stop once T (1 - alpha) <= 1e-4, the tripping entry excluded
  __device__ __forceinline__ void blend(const Batch& b, int nb, int b0, int d_col) {
    for (int i = 0; i < nb && !done; ++i) {
      const float dx = px - b.mx[i];
      const float dy = py - b.my[i];
      const float sigma = conic_sigma(b.ca[i], b.cb[i], b.cc[i], dx, dy);
      if (!(sigma >= 0.f)) continue;           // also skips NaN, as the JAX mask does
      const float raw = b.op[i] * expf(-sigma);
      if (!(raw >= ALPHA_THRESHOLD)) continue;  // min(0.999, raw) >= 1/255 <=> raw >= 1/255
      const float a = fminf(0.999f, raw);
      const float next_T = T * (1.f - a);
      if (next_T <= T_EPS) {
        done = true;
        break;
      }
      const float w = a * T;
#pragma unroll
      for (int c = 0; c < MAX_D; ++c)
        if (c < d_col) acc[c] += w * b.col[c * b.nthr + i];
      asum += w;
      T = next_T;
      last = b0 + i;
    }
  }

  // Write the blend at image index p (the caller adds a camera's offset).
  // t_final / last_out are the training planes, null at inference.
  __device__ __forceinline__ void write(long long p, int d_col, float* __restrict__ out,
                                        float* __restrict__ alpha_out,
                                        float* __restrict__ t_final,
                                        int* __restrict__ last_out) const {
#pragma unroll
    for (int c = 0; c < MAX_D; ++c)
      if (c < d_col) out[p * d_col + c] = acc[c];
    alpha_out[p] = asum;
    if (t_final != nullptr) {
      t_final[p] = T;
      last_out[p] = last;
    }
  }
};

// Blend a tile of `count` entries into this thread's `pixel`: batches of
// blockDim entries are staged cooperatively, stage(j, s) putting the tile's
// entry j into slot s, then every thread walks the batch. The block leaves
// as soon as __syncthreads_count says every pixel is done. The barrier at
// the head of each batch also guards the staging planes against the
// previous batch (or the previous tile's last batch) still being read.
template <class Stage>
__device__ __forceinline__ void blend_tile(const Batch& b, int count, int d_col,
                                           Pixel& pixel, Stage stage) {
  for (int b0 = 0; b0 < count; b0 += b.nthr) {
    if (__syncthreads_count(pixel.done) == b.nthr) break;
    const int j = b0 + static_cast<int>(threadIdx.x);
    if (j < count) stage(j, static_cast<int>(threadIdx.x));
    __syncthreads();
    pixel.blend(b, min(b.nthr, count - b0), b0, d_col);
  }
}

}  // namespace raster
