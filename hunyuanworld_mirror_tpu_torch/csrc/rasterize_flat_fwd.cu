// Kernel K2: flat tile-rasterizer forward (3D Gaussian splats), for sm_90a.
//
// Replaces (TPU, Pallas): hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:
// _kernel_flat (launched from _forward_flat, public entry
// rasterize_flat_pallas). Input is the globally (tile | depth)-sorted,
// component-major intersection list from ops/tiles.bin_gaussians_packed:
// tile t owns entries [starts[t], starts[t] + counts[t]) of packed (V, M).
//
// Per pixel, front to back over its tile's entries:
//   sigma = 0.5 (ca dx^2 + cc dy^2) + cb dx dy     (pixel centre at +0.5)
//   alpha = min(0.999, op e^-sigma), kept iff sigma >= 0 and alpha >= 1/255
//   stop once T (1 - alpha) <= 1e-4, the tripping entry excluded
//   out += alpha T colour, alpha_out += alpha T, T *= (1 - alpha).
// The TPU kernel's log-space prefix product on the MXU (a triangular matmul)
// was a TPU workaround; this kernel does the plain sequential product. The
// two agree to f32 reassociation.
//
// What bounds it on this card: the per-(pixel, entry) arithmetic on the FP32
// pipes, the keep test (~10 operations) for each of 256 pixels per entry and
// ~25 for the few pairs kept, against 24-40 bytes of payload per entry read
// once by one block; early termination cuts both.
// Design (the gsplat forward structure): one block of tile_size^2 threads
// per tile, one thread per pixel. The block stages a batch of blockDim
// entries into shared memory cooperatively (one entry per thread, decoded to
// f32 there), then every thread walks the batch with its own transmittance.
// The block leaves as soon as __syncthreads_count says every pixel is done.
//
// Payload rows: f32 layout [mx, my, ca, cb, cc, op, col_0 .. col_{D-1}];
// f16 layout [mx, my, ca|cb, cc|op, col pairs ...], each packed row holding
// two f16 values as (hi << 16) | lo. The f16 decode keeps the JAX decode's
// flush-to-zero of subnormals (rasterizer_pallas._f16_bits_to_f32).
//
// Training adds two per-pixel planes for the backward (kernel K3,
// rasterize_flat_bwd.cu): the final transmittance and the tile-local index
// of the last kept entry (-1 if none). Their pointers are null on the
// inference path, which then writes nothing more.
//
// C interface: rasterize_flat_fwd(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 8;
constexpr float ALPHA_THRESHOLD = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

__device__ __forceinline__ float f16_bits_to_f32(uint32_t h) {
  const uint32_t s = (h & 0x8000u) << 16;
  const uint32_t e = (h >> 10) & 0x1Fu;
  const uint32_t m = h & 0x3FFu;
  const uint32_t mag = (e == 0u) ? 0u : (((e + 112u) << 23) | (m << 13));
  return __uint_as_float(s | mag);
}

// sigma = 0.5 (ca dx^2 + cc dy^2) + cb dx dy, rounded op by op in the plain
// version's order (no FMA contraction). The keep test (sigma >= 0, alpha >=
// 1/255) is a step in alpha: a pair that one rounding keeps and another drops
// changes T for every earlier entry of its pixel in the backward. With this
// order the kernel decides as the plain version does, and K3
// (rasterize_flat_bwd.cu, the same function) as K2 does.
__device__ __forceinline__ float conic_sigma(float ca, float cb, float cc, float dx,
                                             float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                            __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(cb, dx), dy));
}

__global__ void raster_flat_kernel(const float* __restrict__ packed,
                                   const int* __restrict__ starts,
                                   const int* __restrict__ counts,
                                   float* __restrict__ out, float* __restrict__ alpha_out,
                                   float* __restrict__ t_final, int* __restrict__ last_out,
                                   int width, int height, int tile_size, int tiles_x,
                                   int d_col, long long M, int f16) {
  extern __shared__ float sm[];
  const int nthr = blockDim.x;
  float* s_mx = sm;
  float* s_my = sm + nthr;
  float* s_ca = sm + 2 * nthr;
  float* s_cb = sm + 3 * nthr;
  float* s_cc = sm + 4 * nthr;
  float* s_op = sm + 5 * nthr;
  float* s_col = sm + 6 * nthr;  // (d_col, nthr)

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int pxi = (t % tiles_x) * tile_size + tid % tile_size;
  const int pyi = (t / tiles_x) * tile_size + tid / tile_size;
  const bool inside = pxi < width && pyi < height;
  const float px = float(pxi) + 0.5f;
  const float py = float(pyi) + 0.5f;
  const long long start = starts[t];
  const int count = counts[t];

  bool done = !inside;
  float T = 1.f, asum = 0.f;
  int last = -1;
  float acc[MAX_D];
#pragma unroll
  for (int c = 0; c < MAX_D; ++c) acc[c] = 0.f;

  for (int b0 = 0; b0 < count; b0 += nthr) {
    // barrier: the previous batch is fully consumed before it is overwritten
    if (__syncthreads_count(done) == nthr) break;
    const int j = b0 + tid;
    if (j < count) {
      const long long e = start + j;
      s_mx[tid] = packed[e];
      s_my[tid] = packed[M + e];
      if (!f16) {
        s_ca[tid] = packed[2 * M + e];
        s_cb[tid] = packed[3 * M + e];
        s_cc[tid] = packed[4 * M + e];
        s_op[tid] = packed[5 * M + e];
        for (int c = 0; c < d_col; ++c) s_col[c * nthr + tid] = packed[(6 + c) * M + e];
      } else {
        const uint32_t u2 = __float_as_uint(packed[2 * M + e]);
        const uint32_t u3 = __float_as_uint(packed[3 * M + e]);
        s_ca[tid] = f16_bits_to_f32(u2 >> 16);
        s_cb[tid] = f16_bits_to_f32(u2 & 0xFFFFu);
        s_cc[tid] = f16_bits_to_f32(u3 >> 16);
        s_op[tid] = f16_bits_to_f32(u3 & 0xFFFFu);
        for (int c = 0; c < d_col; c += 2) {
          const uint32_t u = __float_as_uint(packed[(4 + c / 2) * M + e]);
          s_col[c * nthr + tid] = f16_bits_to_f32(u >> 16);
          if (c + 1 < d_col) s_col[(c + 1) * nthr + tid] = f16_bits_to_f32(u & 0xFFFFu);
        }
      }
    }
    __syncthreads();
    const int nb = min(nthr, count - b0);
    for (int i = 0; i < nb && !done; ++i) {
      const float dx = px - s_mx[i];
      const float dy = py - s_my[i];
      const float sigma = conic_sigma(s_ca[i], s_cb[i], s_cc[i], dx, dy);
      if (!(sigma >= 0.f)) continue;           // also skips NaN, as the JAX mask does
      const float raw = s_op[i] * expf(-sigma);
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
        if (c < d_col) acc[c] += w * s_col[c * nthr + i];
      asum += w;
      T = next_T;
      last = b0 + i;
    }
  }

  if (inside) {
    const long long p = static_cast<long long>(pyi) * width + pxi;
#pragma unroll
    for (int c = 0; c < MAX_D; ++c)
      if (c < d_col) out[p * d_col + c] = acc[c];
    alpha_out[p] = asum;
    if (t_final != nullptr) {
      t_final[p] = T;
      last_out[p] = last;
    }
  }
}

}  // namespace

extern "C" int rasterize_flat_fwd(const void* packed, const void* starts, const void* counts,
                                  void* out, void* alpha_out, void* t_final,
                                  void* last_out, int width, int height,
                                  int tile_size, int tiles_x, int n_tiles, int d_col,
                                  long long M, int f16, void* stream) {
  const int nthr = tile_size * tile_size;
  if (d_col < 1 || d_col > MAX_D || nthr > 1024 || n_tiles < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = size_t(6 + d_col) * nthr * sizeof(float);
  raster_flat_kernel<<<n_tiles, nthr, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<float*>(out),
      static_cast<float*>(alpha_out), static_cast<float*>(t_final),
      static_cast<int*>(last_out), width, height, tile_size, tiles_x, d_col, M, f16);
  return int(cudaGetLastError());
}
