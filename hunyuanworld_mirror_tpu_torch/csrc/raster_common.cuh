// Shared pieces of the tile-rasterizer kernels, for sm_90a: the keep and stop
// rules, the sigma rounding, the f16 decode, each entry's keep box, and the
// front-to-back blend of one tile that the forward kernels K2 / K2m / K5
// (rasterize_flat_fwd.cu) and K4 (rasterize_binned_fwd.cu) run. K3 (rasterize_flat_bwd.cu) replays the same
// keep test with the same sigma, and skips with the same box.
//
// Every kernel that includes this header has to decide each (pixel, entry)
// pair exactly as the plain PyTorch versions do (ops/rasterizer_flat.py
// blend_groups, ops/rasterizer_binned.py): a pair at alpha ~ 1/255 that one
// rounding keeps and another drops moves T for the rest of its pixel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace raster {

constexpr int MAX_D = 8;
constexpr float ALPHA_THRESHOLD = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// A forward warp's block of pixels: 8 x 4, more compact than a row-major
// 16 x 2, so that fewer warps see each splat.
constexpr int WARP_W = 8, WARP_H = 4;

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

// The box (x0, x1, y0, y1) that holds every pixel centre at which the entry
// can pass the keep test op e^-sigma >= 1/255. That needs sigma <= lim =
// ln(255 op) (+ 1e-3, ~1000x the rounding of logf, expf and the product).
// sigma = x^T C x / 2 <= s holds |dx| <= sqrt(2 s cc / det C), |dy| <=
// sqrt(2 s ca / det C). With det C >= ca cc / 100, sigma's rounding is
// < 1e-4 of sigma, far inside the 1% on s, and 0.01 px covers the rounding
// of dx, dy: the box never drops a pair the exact test keeps. Otherwise (or
// NaN) the box is infinite; a NaN mean gives a NaN box, which no test skips.
// Not inlined: a staging thread calls it once a batch, and inlined into K3
// it led nvcc to schedule K3's walk ~17% slower (PERF.md).
__device__ __noinline__ float4 keep_box(float mx, float my, float ca, float cb,
                                        float cc, float op) {
  const float lim = logf(255.f * op) + 1e-3f;
  const float det = ca * cc - cb * cb;
  float rx = __int_as_float(0x7f800000), ry = rx;  // +inf
  if (ca > 0.f && cc > 0.f && det >= 0.01f * ca * cc) {
    const float s2 = 2.02f * fmaxf(lim, 0.f);
    rx = sqrtf(s2 * cc / det) + 0.01f;
    ry = sqrtf(s2 * ca / det) + 0.01f;
  }
  return make_float4(mx - rx, mx + rx, my - ry, my + ry);
}

// Whether a box misses the rectangle of pixel centres [x0, x1] x [y0, y1].
__device__ __forceinline__ bool box_misses(float4 box, float x0, float x1, float y0,
                                           float y1) {
  return box.y < x0 || box.x > x1 || box.w < y0 || box.z > y1;
}

// One entry's blend parameters, decoded to f32.
struct Splat {
  float mx, my, ca, cb, cc, op;
};

// One batch of blockDim entries staged in shared memory, decoded to f32, nthr
// slots each: a float4 (mx, my, ca, cb) and a float2 (cc, op) per entry, so
// that a pair's keep test takes two shared loads (six planes, one load
// each, were ~5% slower: tools/k2_ab.py, PERF.md), each entry's keep box (a
// float4), then d_col colour planes.
struct Batch {
  float4* geo;  // mx, my, ca, cb
  float2* cop;  // cc, op
  float4* box;
  float* col;
  int nthr;
  __device__ __forceinline__ Batch(float* sm, int n)
      : geo(reinterpret_cast<float4*>(sm)), cop(reinterpret_cast<float2*>(sm + 4 * n)),
        box(reinterpret_cast<float4*>(sm + 6 * n)), col(sm + 10 * n), nthr(n) {}

  __device__ __forceinline__ void put(int s, const Splat& e) const {
    geo[s] = make_float4(e.mx, e.my, e.ca, e.cb);
    cop[s] = make_float2(e.cc, e.op);
    box[s] = keep_box(e.mx, e.my, e.ca, e.cb, e.cc, e.op);
  }
};

// Shared memory a forward block of nthr threads needs for one batch
// (nthr a multiple of 32, so that the records and boxes stay aligned).
inline size_t batch_smem(int nthr, int d_col) {
  return size_t(10 + d_col) * nthr * sizeof(float);
}

// Stage entry e of a component-major (V, M) sorted list into slot s. f32
// layout [mx, my, ca, cb, cc, op, col_0 .. col_{D-1}]; f16 layout
// [mx, my, ca|cb, cc|op, col pairs ...], each packed row holding two f16
// values as (hi << 16) | lo.
__device__ __forceinline__ void stage_list_entry(const Batch& b, int s,
                                                 const float* __restrict__ packed,
                                                 long long M, long long e, int d_col,
                                                 int f16) {
  Splat sp;
  sp.mx = packed[e];
  sp.my = packed[M + e];
  if (!f16) {
    sp.ca = packed[2 * M + e];
    sp.cb = packed[3 * M + e];
    sp.cc = packed[4 * M + e];
    sp.op = packed[5 * M + e];
    for (int c = 0; c < d_col; ++c) b.col[c * b.nthr + s] = packed[(6 + c) * M + e];
  } else {
    const uint32_t u2 = __float_as_uint(packed[2 * M + e]);
    const uint32_t u3 = __float_as_uint(packed[3 * M + e]);
    sp.ca = f16_bits_to_f32(u2 >> 16);
    sp.cb = f16_bits_to_f32(u2 & 0xFFFFu);
    sp.cc = f16_bits_to_f32(u3 >> 16);
    sp.op = f16_bits_to_f32(u3 & 0xFFFFu);
    for (int c = 0; c < d_col; c += 2) {
      const uint32_t u = __float_as_uint(packed[(4 + c / 2) * M + e]);
      b.col[c * b.nthr + s] = f16_bits_to_f32(u >> 16);
      if (c + 1 < d_col) b.col[(c + 1) * b.nthr + s] = f16_bits_to_f32(u & 0xFFFFu);
    }
  }
  b.put(s, sp);
}

// One pixel (one thread) of a tile blending D colour channels: its centre,
// its warp's rectangle and its blend so far.
template <int D>
struct Pixel {
  float px, py, T, asum;
  float x0, x1, y0, y1;  // the centres of the warp's corner pixels
  float acc[D];
  int last;   // tile-local index of the last kept entry, -1 if none
  bool done;  // outside the image, or T has fallen to T_EPS

  // The pixel of lane threadIdx.x % 32 in warp wi of tile t (tiles_x tiles
  // to a row), warps of WARP_W x WARP_H pixels filling the tile column by
  // column -> its index in the (height, width) image, or -1 when it lies on
  // the pad past the image. A warp wholly past the image's edge walks
  // nothing.
  __device__ __forceinline__ long long init(int t, int wi, int tiles_x, int tile_size,
                                            int width, int height) {
    const int lane = threadIdx.x & 31;
    const int warps_y = tile_size / WARP_H;
    const int ox = (t % tiles_x) * tile_size + (wi / warps_y) * WARP_W;
    const int oy = (t / tiles_x) * tile_size + (wi % warps_y) * WARP_H;
    const int pxi = ox + lane % WARP_W;
    const int pyi = oy + lane / WARP_W;
    const bool inside = pxi < width && pyi < height;
    px = float(pxi) + 0.5f;
    py = float(pyi) + 0.5f;
    x0 = float(ox) + 0.5f;
    x1 = x0 + float(WARP_W - 1);
    y0 = float(oy) + 0.5f;
    y1 = y0 + float(WARP_H - 1);
    T = 1.f;
    asum = 0.f;
    last = -1;
    done = !inside;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    return inside ? static_cast<long long>(pyi) * width + pxi : -1;
  }

  // The keep test's op e^-sigma of staged entry i at this pixel, 0 where
  // sigma < 0 or NaN (as the JAX mask does).
  __device__ __forceinline__ float raw_alpha(const Batch& b, int i) const {
    const float4 g = b.geo[i];
    const float2 q = b.cop[i];
    const float dx = px - g.x;
    const float dy = py - g.y;
    const float sigma = conic_sigma(g.z, g.w, q.x, dx, dy);
    return sigma >= 0.f ? q.y * expf(-sigma) : 0.f;
  }

  // Blend staged entry i (tile-local index b0 + i) with its raw_alpha:
  //   alpha = min(0.999, raw), kept iff alpha >= 1/255 (<=> raw >= 1/255)
  //   stop once T (1 - alpha) <= 1e-4, the tripping entry excluded
  __device__ __forceinline__ void apply(const Batch& b, int i, int b0, float raw) {
    if (!(raw >= ALPHA_THRESHOLD)) return;
    const float a = fminf(0.999f, raw);
    const float next_T = T * (1.f - a);
    if (next_T <= T_EPS) {
      done = true;
      return;
    }
    const float w = a * T;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] += w * b.col[c * b.nthr + i];
    asum += w;
    T = next_T;
    last = b0 + i;
  }

  // Walk the staged batch of nb entries front to back, skipping for the
  // whole warp the entries whose keep box misses its pixels: 32 entries'
  // boxes tested in one step (lane i against entry i), then the ballot of
  // the hits walked in ascending order, two hits a step, their keep tests
  // (independent of each other) first so that one's latency hides the
  // other's, then the two blends in order. A skipped entry is one no pixel
  // of the warp keeps, and an entry no pixel keeps changes nothing, so
  // every pixel blends what an unculled walk blends, in the same order and
  // arithmetic.
  __device__ __forceinline__ void blend(const Batch& b, int nb, int b0) {
    const int lane = threadIdx.x & 31;
    for (int c0 = 0; c0 < nb; c0 += 32) {
      const int i = c0 + lane;
      const bool hit = i < nb && !box_misses(b.box[i], x0, x1, y0, y1);
      unsigned hits = __ballot_sync(FULL_MASK, hit);
      if (__all_sync(FULL_MASK, done)) return;
      while (hits != 0u && !done) {
        const int i1 = c0 + __ffs(hits) - 1;
        hits &= hits - 1u;
        if (hits == 0u) {
          apply(b, i1, b0, raw_alpha(b, i1));
          continue;
        }
        const int i2 = c0 + __ffs(hits) - 1;
        hits &= hits - 1u;
        const float r1 = raw_alpha(b, i1), r2 = raw_alpha(b, i2);
        apply(b, i1, b0, r1);
        if (!done) apply(b, i2, b0, r2);
      }
    }
  }

  // Write the blend at image index p (the caller adds a camera's offset).
  // t_final / last_out are the training planes, null at inference.
  __device__ __forceinline__ void write(long long p, float* __restrict__ out,
                                        float* __restrict__ alpha_out,
                                        float* __restrict__ t_final,
                                        int* __restrict__ last_out) const {
#pragma unroll
    for (int c = 0; c < D; ++c) out[p * D + c] = acc[c];
    alpha_out[p] = asum;
    if (t_final != nullptr) {
      t_final[p] = T;
      last_out[p] = last;
    }
  }
};

// Whether a tile of tile_size^2 pixels, one thread each, is whole warps of
// the shape above, at most max_threads of them.
inline bool tile_fits(int tile_size, int max_threads) {
  return tile_size % WARP_W == 0 && tile_size % WARP_H == 0 &&
         tile_size * tile_size <= max_threads;
}

// Blend a tile of `count` entries into this thread's `pixel`: batches of
// blockDim entries are staged cooperatively, stage(j, s) putting the tile's
// entry j into slot s (through Batch::put, which also writes its keep box),
// then every warp walks the batch. The block leaves as soon as
// __syncthreads_count says every pixel is done. The barrier at the head of
// each batch also guards the staging planes against the previous batch
// still being read.
template <int D, class Stage>
__device__ __forceinline__ void blend_tile(const Batch& b, int count, Pixel<D>& pixel,
                                           Stage stage) {
  for (int b0 = 0; b0 < count; b0 += b.nthr) {
    if (__syncthreads_count(pixel.done) == b.nthr) break;
    const int j = b0 + static_cast<int>(threadIdx.x);
    if (j < count) stage(j, static_cast<int>(threadIdx.x));
    __syncthreads();
    pixel.blend(b, min(b.nthr, count - b0), b0);
  }
}

// f(std::integral_constant<int, d_col>()) for d_col in 1 .. MAX_D, so that a
// kernel is instantiated per colour width (its colour loops unrolled, no
// accumulator for an absent channel) -> f's result, or cudaErrorInvalidValue.
template <class F>
inline int with_d_col(int d_col, F f) {
  switch (d_col) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace raster
