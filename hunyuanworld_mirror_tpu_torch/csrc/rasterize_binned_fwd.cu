// Kernel K4: dense-bin tile-rasterizer forward (3D Gaussian splats), for
// sm_90a.
//
// Replaces (TPU, Pallas): hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:
// _kernel (launched from _forward_pallas, public entry
// rasterize_binned_pallas; its callers are the `--rasterizer jax` render
// and training step and the per-rank render of ops/distributed.py). Input
// is the dense bins of ops/tiles.bin_gaussians: an (n_tiles, max_per_tile)
// int32 table of splat ids, tile t's first counts[t] of them depth-sorted
// front to back, and the splats' means2d (N, 2), conics (N, 3), opacities
// (N,) and colours (N, D). The C entry first packs them into an (N, 6 + D)
// row-major table [mx, my, ca, cb, cc, op, col_0 .. col_{D-1}] in a scratch
// the caller allocates (its plain version: ops/rasterizer_binned.splat_table).
//
// The blend is K2's (raster_common.cuh): per pixel, front to back, alpha =
// min(0.999, op e^-sigma) kept iff sigma >= 0 and alpha >= 1/255, stop once
// T (1 - alpha) <= 1e-4. The TPU kernel carried a log-space prefix sum and a
// stop flag across 512-entry chunks; this kernel multiplies T out
// sequentially. The two compute the same weights up to reassociation.
//
// The TPU route first gathered a (n_tiles, max_per_tile, 6 + D) staging
// copy of the table through the ids (178 MB per camera at 4096 per tile),
// because an XLA gather beat a per-row DMA from inside its kernel. This
// kernel gathers the rows itself. What bounds it on this card: K2's
// per-pair arithmetic on the FP32 pipes, against 4 bytes of id plus one
// row per live entry; the rows are scattered reads, so each costs whole
// 32-byte sectors and a round trip to device memory that depends on the
// id's. Design: K2's loop (raster_common.cuh blend_tile: a block of
// tile_size^2 threads a tile, one thread a pixel, batches of blockDim
// entries staged in shared memory, each thread loading its entry's id and
// then its row with 4-byte loads, the culled walk), and around it:
//   * the tiles longest first (raster_order.cuh, K2's counting sort), so
//     that the last wave of blocks is short;
//   * the table packed by a kernel of its own (one thread a float4 of the
//     table, 88 bytes moved a splat at D = 4) in place of the wrapper's
//     torch.cat, which took about a third of a call (tools/k4_ab.py,
//     PERF.md).
// (Measured and dropped, tools/k4_ab.py: rows padded to whole float4s and
// fetched as 16-byte cp.async copies, and the fetch of batch k + 1 in
// flight during batch k's walk in a second buffer; neither paid.)
// Every pair is decided as K2 decides it (conic_sigma's op-by-op rounding,
// the keep box, the order within a tile, the stop rule), so the image and
// alpha equal the parent design's bit for bit (tools/k4_ab.py).
//
// C interface: rasterize_binned_fwd(...) returns cudaGetLastError().

#include "raster_common.cuh"
#include "raster_order.cuh"

namespace {

// A block's threads at most: one per pixel of a 16 x 16 tile.
constexpr int MAX_THREADS = 256;

// Pack the splats' fields into (n, 6 + D) table rows: one thread a float4
// of the table, so that a warp's stores are 512 contiguous bytes; each of
// its floats is one load from whichever array holds that field (the address
// selected, so that the warp does not diverge).
template <int D>
__global__ void pack_rows_kernel(const float* __restrict__ means2d,
                                 const float* __restrict__ conics,
                                 const float* __restrict__ opacities,
                                 const float* __restrict__ colors, int n,
                                 float* __restrict__ table) {
  constexpr int ROW = 6 + D;
  const long long f0 = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  const long long total = static_cast<long long>(n) * ROW;
  if (f0 >= total) return;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = (f0 + k) / ROW;
    const int e = static_cast<int>((f0 + k) % ROW);
    const float* src = e < 2 ? means2d + 2 * i + e
                     : e < 5 ? conics + 3 * i + e - 2
                     : e == 5 ? opacities + i : colors + D * i + e - 6;
    v[k] = f0 + k < total ? __ldg(src) : 0.f;
  }
  if (f0 + 4 <= total) {
    *reinterpret_cast<float4*>(table + f0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (f0 + k < total) table[f0 + k] = v[k];
  }
}

template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
raster_binned_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     const int* __restrict__ counts, const long long* __restrict__ order,
                     float* __restrict__ out, float* __restrict__ alpha_out, int width,
                     int height, int tile_size, int tiles_x, int max_per_tile) {
  extern __shared__ __align__(16) float sm[];
  const raster::Batch b(sm, blockDim.x);
  const int t = int(order[blockIdx.x]);
  raster::Pixel<D> pixel;
  const long long p = pixel.init(t, threadIdx.x >> 5, tiles_x, tile_size, width, height);
  const int* tile_ids = ids + static_cast<long long>(t) * max_per_tile;
  raster::blend_tile(b, min(counts[t], max_per_tile), pixel, [&](int j, int s) {
    const float* row = table + static_cast<long long>(tile_ids[j]) * (6 + D);
    b.put(s, {row[0], row[1], row[2], row[3], row[4], row[5]});
#pragma unroll
    for (int c = 0; c < D; ++c) b.col[c * b.nthr + s] = row[6 + c];
  });
  if (p >= 0) pixel.write(p, out, alpha_out, nullptr, nullptr);
}

}  // namespace

// means2d (N, 2), conics (N, 3), opacities (N,), colors (N, d_col), all
// contiguous f32; table an (N, 6 + d_col) f32 scratch that receives their
// rows; order (n_tiles,) int64 receives the tiles longest first, the order
// in which the blocks take them.
extern "C" int rasterize_binned_fwd(const void* means2d, const void* conics,
                                    const void* opacities, const void* colors, int n_splats,
                                    void* table, const void* ids, const void* counts,
                                    void* order, void* out, void* alpha_out, int width,
                                    int height, int tile_size, int tiles_x, int n_tiles,
                                    int d_col, int max_per_tile, void* stream) {
  const int nthr = tile_size * tile_size;
  if (d_col < 1 || d_col > raster::MAX_D || !raster::tile_fits(tile_size, MAX_THREADS) ||
      n_tiles < 1 || max_per_tile < 1 || n_splats < 0)
    return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  raster::longest_first_kernel<<<1, raster::ORDER_BINS, 0, s>>>(
      static_cast<const int*>(counts), n_tiles, static_cast<long long*>(order));
  return raster::with_d_col(d_col, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const long long quads = (static_cast<long long>(n_splats) * (6 + D) + 3) / 4;
    if (n_splats > 0)
      pack_rows_kernel<D><<<static_cast<unsigned>((quads + 255) / 256), 256, 0, s>>>(
          static_cast<const float*>(means2d), static_cast<const float*>(conics),
          static_cast<const float*>(opacities), static_cast<const float*>(colors), n_splats,
          static_cast<float*>(table));
    raster_binned_kernel<D><<<n_tiles, nthr, raster::batch_smem(nthr, D), s>>>(
        static_cast<const float*>(table), static_cast<const int*>(ids),
        static_cast<const int*>(counts), static_cast<const long long*>(order),
        static_cast<float*>(out), static_cast<float*>(alpha_out), width, height,
        tile_size, tiles_x, max_per_tile);
    return int(cudaGetLastError());
  });
}

// Threads a block (a tile's pixels), and its dynamic shared memory in bytes
// (for occupancy arithmetic).
extern "C" int rasterize_binned_fwd_threads(int tile_size) { return tile_size * tile_size; }

extern "C" int rasterize_binned_fwd_smem(int tile_size, int d_col) {
  return static_cast<int>(raster::batch_smem(tile_size * tile_size, d_col));
}
