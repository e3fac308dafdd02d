// Kernel K7: one camera's flat binning from its live (splat, tile) slots
// alone, for sm_90a.
//
// Replaces: no TPU kernel. The flat binning is plain XLA in the JAX package
// (hunyuanworld_mirror_tpu/ops/tiles.py bin_gaussians_packed) and plain
// PyTorch in the port (ops/tiles.py bin_gaussians_packed_plain): ~220 short
// elementwise launches a camera over every one of the N x TPG slot planes,
// one sort of all N x TPG 64-bit keys, dead slots included, and the gathers
// and searches over them. Most slots are dead (past a splat's tile cover,
// outside its alpha >= 1/255 ellipse, or of a culled splat), and no later
// stage reads them.
//
// Two C entries a camera (ops/tiles.py _bin_flat), the host reading the
// live count between them (the camera's one sync):
//   bin_flat_keys
//     bin_depth_range  grid-stride partial min / max of the valid splats'
//                      depths (valid: both radii > 0), one pair a block;
//                      it also zeroes the live counter and the drop count;
//     bin_keys         one thread a splat: its clamped tile box, each slot
//                      k < min(TPG, cover) in row-major order through the
//                      exact ellipse-tile test, and for each slot that
//                      passes the 64-bit key (tile << db | depth_q) << sb |
//                      (k N + n), sb the bits of N TPG - 1, appended at one
//                      atomic a warp; the intersections past TPG summed
//                      into the drop count;
//   bin_flat_emit
//     cub's radix sort of the n_live keys over their sb + 31 low bits;
//     bin_emit         one thread a sorted entry: the V payload planes'
//                      int32 bit patterns gathered into packed (V, n_live),
//                      each plane read where it lies, the entry's splat id,
//                      each tile's start (searchsorted's semantics) and
//                      count clamped to max_per_tile, the clamp's cut added
//                      to the drop count.
// The keys are unique and order the live slots as the plain code's keys
// (tile << db | depth_q) << 32 | (k N + n) do, so the sort gives the plain
// list's live prefix bit for bit: its starts, counts, n_dropped, payload
// rows and ids.
//
// Every float operation is the plain code's, rounded one at a time in its
// order (project_common.cuh's intrinsics: no FMA contraction), so that the
// tile boxes, the ellipse test and the depth quantisation reproduce PyTorch's
// kernels on the card bit for bit: a tensor over a Python number is a
// product with the f32 reciprocal, a tensor over a tensor a true division,
// and maximum / minimum / clamp return a NaN operand.
//
// What bounds it on this card: bytes. The inputs read once and the outputs
// written once are ~40 bytes a splat (mean, radii, depth, the four test
// planes, the payload) and 4 (V + 1) an entry: at refine's 1.07M slots and
// ~1.2M live entries a camera ~0.1 GB, ~0.04 ms at 3.35 TB/s. The work in
// between is the live keys (8 bytes each, written once, then 7 radix
// passes of cub's onesweep at 55 bits) and the payload gathered a word at
// a time by splat; the sort is about half the device time.

#include <cuda_runtime.h>

#include <cub/device/device_radix_sort.cuh>

#include "project_common.cuh"

namespace {

using proj::add;
using proj::div;
using proj::mul;
using proj::sub;
using proj::tmax;
using proj::tmin;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = tmin(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = tmax(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// tiles._to_i32: clamp to +-2^30 (a NaN stays NaN), then the cast (NaN -> 0)
__device__ __forceinline__ int to_i32(float x) {
  return int(tmin(tmax(x, -1073741824.0f), 1073741824.0f));
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// Aux words (int64 each): [0] the live count, [1] the drop count, [2 ...]
// the depth-range blocks' (min, max) pairs.
__global__ void __launch_bounds__(kThreads)
    bin_depth_range(const int2* __restrict__ radii, const float* __restrict__ depths,
                    long long n, unsigned long long* __restrict__ aux) {
  float lo = INFINITY, hi = -INFINITY;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int2 r = radii[i];
    if (r.x > 0 && r.y > 0) {
      const float d = depths[i];
      lo = tmin(lo, d);
      hi = tmax(hi, d);
    }
  }
  __shared__ float2 part[kThreads / 32];
  lo = warp_min(lo);
  hi = warp_max(hi);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_float2(lo, hi);
  __syncthreads();
  if (threadIdx.x < 32) {
    const float2 p = threadIdx.x < kThreads / 32 ? part[threadIdx.x]
                                                 : make_float2(INFINITY, -INFINITY);
    lo = warp_min(p.x);
    hi = warp_max(p.y);
    if (threadIdx.x == 0) {
      reinterpret_cast<float2*>(aux + 2)[blockIdx.x] = make_float2(lo, hi);
      if (blockIdx.x == 0) aux[0] = aux[1] = 0;
    }
  }
}

struct TileGrid {
  float inv_ts;  // the f32 reciprocal of the tile size: x / tile_size
  float ts, ts_m1;
  int tw, th, tpg, db, sb;  // sb: the key's slot bits
};

// tiles._rect_sigma_min's edge terms, in the plain code's order
__device__ __forceinline__ float edge_x(float xe, float u, float v, float ca, float cb,
                                        float cc, float y0, float y1) {
  const float dx = sub(xe, u);
  const float t = tmin(tmax(div(mul(-cb, dx), tmax(cc, 1e-12f)), sub(y0, v)), sub(y1, v));
  return add(mul(0.5f, add(mul(mul(ca, dx), dx), mul(mul(cc, t), t))), mul(mul(cb, dx), t));
}

__device__ __forceinline__ float edge_y(float ye, float u, float v, float ca, float cb,
                                        float cc, float x0, float x1) {
  const float dy = sub(ye, v);
  const float t = tmin(tmax(div(mul(-cb, dy), tmax(ca, 1e-12f)), sub(x0, u)), sub(x1, u));
  return add(mul(0.5f, add(mul(mul(ca, t), t), mul(mul(cc, dy), dy))), mul(mul(cb, t), dy));
}

// tiles._conic_slot_mask for tile (tx, ty)
__device__ __forceinline__ bool slot_passes(const TileGrid& g, int tx, int ty, float u,
                                            float v, float ca, float cb, float cc, float lvl) {
  const float x0 = add(mul(float(tx), g.ts), 0.5f), x1 = add(x0, g.ts_m1);
  const float y0 = add(mul(float(ty), g.ts), 0.5f), y1 = add(y0, g.ts_m1);
  const bool inside = u >= x0 && u <= x1 && v >= y0 && v <= y1;
  const float m = tmin(tmin(edge_x(x0, u, v, ca, cb, cc, y0, y1),
                            edge_x(x1, u, v, ca, cb, cc, y0, y1)),
                       tmin(edge_y(y0, u, v, ca, cb, cc, x0, x1),
                            edge_y(y1, u, v, ca, cb, cc, x0, x1)));
  return (inside ? 0.0f : m) <= add(lvl, 1e-3f);
}

// The four conic test planes (ca, cb, cc, level), each with its own element
// stride; ca null without the test.
struct ConicTest {
  const float *ca, *cb, *cc, *lvl;
  long long sa, sb, sc, sl;
};

__global__ void __launch_bounds__(kThreads)
    bin_keys(const float2* __restrict__ means2d, const int2* __restrict__ radii,
             const float* __restrict__ depths, const ConicTest ct, long long n, int n_part,
             const TileGrid g, unsigned long long* __restrict__ keys,
             unsigned long long* __restrict__ aux) {
  // the depth range: every block reduces the range blocks' pairs
  __shared__ float2 range;
  if (threadIdx.x < 32) {
    const float2* part = reinterpret_cast<const float2*>(aux + 2);
    float lo = INFINITY, hi = -INFINITY;
    for (int j = threadIdx.x; j < n_part; j += 32) {
      const float2 p = part[j];
      lo = tmin(lo, p.x);
      hi = tmax(hi, p.y);
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (threadIdx.x == 0) range = make_float2(lo, hi);
  }
  __syncthreads();

  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float u = 0.0f, v = 0.0f, ca = 0.0f, cb = 0.0f, cc = 0.0f, lvl = 0.0f;
  int txmin = 0, tymin = 0, bw1 = 1, cover = 0, lost = 0;
  unsigned key32_depth = 0;
  if (i < n) {
    const float2 m = means2d[i];
    const int2 r = radii[i];
    u = m.x;
    v = m.y;
    // tiles._tile_boxes
    const float rx = float(r.x), ry = float(r.y);
    txmin = clampi(to_i32(floorf(mul(sub(u, rx), g.inv_ts))), 0, g.tw);
    const int txmax = clampi(to_i32(ceilf(mul(add(u, rx), g.inv_ts))), 0, g.tw);
    tymin = clampi(to_i32(floorf(mul(sub(v, ry), g.inv_ts))), 0, g.th);
    const int tymax = clampi(to_i32(ceilf(mul(add(v, ry), g.inv_ts))), 0, g.th);
    const int bw = txmax - txmin;
    bw1 = max(bw, 1);
    if (r.x > 0 && r.y > 0) {
      cover = bw * (tymax - tymin);
      lost = max(cover - g.tpg, 0);
      // tiles._depth_q against the valid splats' [min, max]
      const float levels = float((1 << g.db) - 1);
      const float scale = div(levels, tmax(sub(range.y, range.x), 1e-12f));
      // nan_to_num, then the clamp to [0, levels] and the cast
      const float q = mul(sub(depths[i], range.x), scale);
      key32_depth = q != q ? 0u : unsigned(int(tmin(tmax(q, 0.0f), levels)));
      if (ct.ca != nullptr) {
        ca = ct.ca[i * ct.sa];
        cb = ct.cb[i * ct.sb];
        cc = ct.cc[i * ct.sc];
        lvl = ct.lvl[i * ct.sl];
      }
    }
  }

  // the intersections past TPG, one atomic a warp
  int lost_w = lost;
  for (int o = 16; o > 0; o >>= 1) lost_w += __shfl_xor_sync(kFull, lost_w, o);
  if (lane == 0 && lost_w > 0) atomicAdd(aux + 1, static_cast<unsigned long long>(lost_w));

  // the slots, 32 at a time: a mask of those that pass, the warp's prefix
  // of their counts, one atomic a warp for the block of the key buffer
  const int n_slots = min(cover, g.tpg);
  for (int k0 = 0; k0 < g.tpg; k0 += 32) {
    unsigned mask = 0;
    for (int j = 0; j < 32 && k0 + j < n_slots; ++j) {
      const int k = k0 + j;
      const int tx = txmin + k % bw1, ty = tymin + k / bw1;
      if (ct.ca == nullptr || slot_passes(g, tx, ty, u, v, ca, cb, cc, lvl)) mask |= 1u << j;
    }
    const int c = __popc(mask);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (total == 0) continue;
    unsigned long long base = 0;
    if (lane == 31) base = atomicAdd(aux, static_cast<unsigned long long>(total));
    base = __shfl_sync(kFull, base, 31) + static_cast<unsigned long long>(incl - c);
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const int k = k0 + j;
      const int tile = (tymin + k / bw1) * g.tw + txmin + k % bw1;
      const unsigned long long key32 = (static_cast<unsigned>(tile) << g.db) | key32_depth;
      keys[base++] = (key32 << g.sb) | (static_cast<unsigned long long>(k) * n + i);
    }
  }
}

// The V payload planes, each (N,) with its own element stride.
constexpr int kMaxPlanes = 16;
struct Planes {
  const int* p[kMaxPlanes];
  long long s[kMaxPlanes];
};

__global__ void __launch_bounds__(kThreads)
    bin_emit(const unsigned long long* __restrict__ keys, const Planes planes,
             int* __restrict__ packed, int* __restrict__ ids, int* __restrict__ starts,
             int* __restrict__ counts, unsigned long long* __restrict__ aux, long long n_live,
             long long n, int V, int shift, int sb, int n_tiles, int max_per_tile) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= n_live) return;
  const unsigned long long key = keys[i];
  // the slot k N + splat < 2^32 (the wrapper checks N TPG), so 32 bits do
  const long long g =
      static_cast<unsigned>(key & ((1ull << sb) - 1)) % static_cast<unsigned>(n);
  for (int c = 0; c < V; ++c) packed[c * n_live + i] = __ldg(planes.p[c] + g * planes.s[c]);
  if (ids != nullptr) ids[i] = int(g);

  // a key's tile: key >> (sb + db)
  const int tile = int(key >> shift);
  const int prev = i > 0 ? int(keys[i - 1] >> shift) : -1;
  if (tile != prev) {  // the first entry of its tile: the starts up to it
    for (int t = prev + 1; t <= tile; ++t) starts[t] = int(i);
    for (int t = prev + 1; t < tile; ++t) counts[t] = 0;
  }
  const int next = i + 1 < n_live ? int(keys[i + 1] >> shift) : n_tiles;
  if (tile != next) {  // the last entry of its tile: its count
    long long lo = 0, hi = i;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (int(keys[mid] >> shift) < tile) lo = mid + 1; else hi = mid;
    }
    const long long full = i + 1 - lo;
    counts[tile] = int(min(full, static_cast<long long>(max_per_tile)));
    if (full > max_per_tile)
      atomicAdd(aux + 1, static_cast<unsigned long long>(full - max_per_tile));
    if (i + 1 == n_live) {  // the empty tiles past the last
      for (int t = tile + 1; t < n_tiles; ++t) {
        starts[t] = int(n_live);
        counts[t] = 0;
      }
    }
  }
}

}  // namespace

// means2d (N, 2) f32, radii (N, 2) int32, depths (N,) f32, contiguous; the
// conic test planes with their element strides (ca null without the test);
// keys (N * tpg,) int64; aux (2 + n_part,) int64 with 1 <= n_part <= 264
// the range blocks. Writes the live keys' count to aux[0], the drop count past
// TPG to aux[1], and the live keys, unsorted, to keys[0, aux[0]).
extern "C" int bin_flat_keys(const void* means2d, const void* radii, const void* depths,
                             const void* ca, const void* cb, const void* cc, const void* lvl,
                             long long sa, long long sb, long long sc, long long sl,
                             void* keys, void* aux, long long n, int n_part, int tile_size,
                             int tw, int th, int tpg, int db, int slot_bits, void* stream) {
  if (n < 0 || n_part < 1 || n_part > 264 || tpg < 1 || tile_size < 1 || slot_bits > 32)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<unsigned long long*>(aux);
  bin_depth_range<<<n_part, kThreads, 0, s>>>(static_cast<const int2*>(radii),
                                               static_cast<const float*>(depths), n, a);
  if (n == 0) return int(cudaGetLastError());  // no splat: no key, no drop
  const ConicTest ct{static_cast<const float*>(ca), static_cast<const float*>(cb),
                     static_cast<const float*>(cc), static_cast<const float*>(lvl),
                     sa, sb, sc, sl};
  const TileGrid g{1.0f / float(tile_size), float(tile_size), float(tile_size - 1),
                   tw, th, tpg, db, slot_bits};
  bin_keys<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float2*>(means2d), static_cast<const int2*>(radii),
      static_cast<const float*>(depths), ct, n, n_part, g,
      static_cast<unsigned long long*>(keys), a);
  return int(cudaGetLastError());
}

// The scratch bytes bin_flat_emit's sort of n keys over end_bit bits takes.
extern "C" long long bin_flat_sort_bytes(long long n, int end_bit) {
  size_t bytes = 0;
  const cudaError_t rc = cub::DeviceRadixSort::SortKeys(
      nullptr, bytes, static_cast<const unsigned long long*>(nullptr),
      static_cast<unsigned long long*>(nullptr), static_cast<int>(n), 0, end_bit);
  return rc == cudaSuccess ? static_cast<long long>(bytes) : -1;
}

// keys (n_live,) int64 as bin_flat_keys left them, sorted into sorted
// (n_live,) over their end_bit low bits with temp (temp_bytes, from
// bin_flat_sort_bytes); planes[V] the payload planes' addresses (each (N,),
// 4-byte words) and strides[V] their element strides, V <= 16; packed (V,
// n_live) int32; ids (n_live,) int32 or null; starts and counts (n_tiles,)
// int32; aux as bin_flat_keys left it.
extern "C" int bin_flat_emit(const void* keys, void* sorted, void* temp, long long temp_bytes,
                             int end_bit, const void* const* planes, const long long* strides,
                             void* packed, void* ids, void* starts, void* counts, void* aux,
                             long long n_live, long long n, int V, int db, int slot_bits,
                             int n_tiles, int max_per_tile, void* stream) {
  if (n_live <= 0 || n_live > 0x7FFFFFFF || n <= 0 || V < 1 || V > kMaxPlanes ||
      n_tiles < 1)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t bytes = static_cast<size_t>(temp_bytes);
  const cudaError_t rc = cub::DeviceRadixSort::SortKeys(
      temp, bytes, static_cast<const unsigned long long*>(keys),
      static_cast<unsigned long long*>(sorted), static_cast<int>(n_live), 0, end_bit, s);
  if (rc != cudaSuccess) return int(rc);
  Planes pl{};
  for (int c = 0; c < V; ++c) {
    pl.p[c] = static_cast<const int*>(planes[c]);
    pl.s[c] = strides[c];
  }
  bin_emit<<<static_cast<unsigned>((n_live + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(sorted), pl, static_cast<int*>(packed),
      static_cast<int*>(ids), static_cast<int*>(starts), static_cast<int*>(counts),
      static_cast<unsigned long long*>(aux), n_live, n, V, slot_bits + db, slot_bits,
      n_tiles, max_per_tile);
  return int(cudaGetLastError());
}
