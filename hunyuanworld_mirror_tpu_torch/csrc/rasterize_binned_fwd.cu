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
// (N,) and colours (N, D). The C entry first packs them into an (N, ROW)
// row-major table [mx, my, ca, cb] [cc, op, col_0, col_1] [col_2 ...]
// padded with zeros to ROW = a whole number of float4s, in a scratch the
// caller allocates (its plain version: ops/rasterizer_binned.splat_table).
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
// id's. Design: a block of tile_size^2 threads per tile, one thread a
// pixel, K2's culled walk (Pixel::blend) over batches of blockDim entries
// staged in shared memory, and around it:
//   * the tiles longest first (raster_order.cuh, K2's counting sort), so
//     that the last wave of blocks is short;
//   * the staging overlapped with the walk: while the warps walk batch k,
//     each thread's cp.async of its batch k + 1 row is in flight (from the
//     id it loaded during batch k - 1), and the id of its batch k + 2 entry
//     is being loaded; after its walk the thread waits for its own row,
//     computes the keep box and writes batch k + 1's planes into the other
//     of two buffers. One barrier a batch (__syncthreads_count, which also
//     ends the tile once every pixel is done);
//   * whole float4 row reads: a row is ROW / 4 16-byte copies into the
//     thread's own landing slot in shared memory. The table is packed by a
//     kernel of its own (one thread a splat, 88 bytes moved at D = 4) in
//     place of the wrapper's torch.cat, which took about a third of a call
//     (tools/k4_ab.py, PERF.md).
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

// Floats a table row: [mx, my, ca, cb, cc, op, colours] padded to float4s.
template <int D>
struct Row {
  static constexpr int FLOATS = (6 + D + 3) / 4 * 4;
};

// Shared memory of a block of nthr threads: two batches of planes
// (raster::batch_smem each) and a landing slot of one row a thread.
template <int D>
inline size_t binned_smem(int nthr) {
  return 2 * raster::batch_smem(nthr, D) + size_t(nthr) * Row<D>::FLOATS * sizeof(float);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pack the splats' fields into table rows (zeros past the fields): one
// thread a float4 of the table, so that a warp's stores are 512 contiguous
// bytes; each of its floats is one load from whichever array holds that
// field (the address selected, so that the warp does not diverge).
template <int D>
__global__ void pack_rows_kernel(const float* __restrict__ means2d,
                                 const float* __restrict__ conics,
                                 const float* __restrict__ opacities,
                                 const float* __restrict__ colors, int n,
                                 float* __restrict__ table) {
  constexpr int ROW = Row<D>::FLOATS;
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
    v[k] = f0 + k < total && e < 6 + D ? __ldg(src) : 0.f;
  }
  if (f0 + 4 <= total) {
    *reinterpret_cast<float4*>(table + f0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (f0 + k < total) table[f0 + k] = v[k];
  }
}

// Start the copy of one table row into this thread's landing slot, a
// float4 at a time.
template <int D>
__device__ __forceinline__ void fetch_row(float* slot, const float* __restrict__ row) {
#pragma unroll
  for (int c = 0; c < Row<D>::FLOATS; c += 4) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(slot + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(row + c) : "memory");
  }
}

// The landed row -> slot s of a batch's planes, with its keep box.
template <int D>
__device__ __forceinline__ void stage_row(const raster::Batch& b, int s, const float* slot) {
  b.put(s, {slot[0], slot[1], slot[2], slot[3], slot[4], slot[5]});
#pragma unroll
  for (int c = 0; c < D; ++c) b.col[c * b.nthr + s] = slot[6 + c];
}

template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
raster_binned_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     const int* __restrict__ counts, const long long* __restrict__ order,
                     float* __restrict__ out, float* __restrict__ alpha_out, int width,
                     int height, int tile_size, int tiles_x, int max_per_tile) {
  constexpr int ROW = Row<D>::FLOATS;
  extern __shared__ __align__(16) float sm[];
  const int nthr = blockDim.x, tid = threadIdx.x;
  // batch k's planes are buffer k % 2 (raster::batch_smem floats each)
  const auto buffer = [&](int k) {
    return raster::Batch(sm + (k & 1) * (10 + D) * nthr, nthr);
  };
  float* slot = sm + 2 * (10 + D) * nthr + tid * ROW;
  const int t = int(order[blockIdx.x]);
  raster::Pixel<D> pixel;
  const long long p = pixel.init(t, tid >> 5, tiles_x, tile_size, width, height);
  const int* tile_ids = ids + static_cast<long long>(t) * max_per_tile;
  const int count = min(counts[t], max_per_tile);

  // batch 0 is staged before the walk; id_next is the id of this thread's
  // entry in the batch after the one being fetched
  if (tid < count) fetch_row<D>(slot, table + static_cast<long long>(tile_ids[tid]) * ROW);
  cp_async_commit();
  int id_next = nthr + tid < count ? tile_ids[nthr + tid] : 0;
  cp_async_wait_all();
  if (tid < count) stage_row<D>(buffer(0), tid, slot);

  for (int b0 = 0, k = 0; b0 < count; b0 += nthr, ++k) {
    // batch k's planes are complete, and every warp has left batch k - 1's
    // walk, so its buffer is free for batch k + 1
    if (__syncthreads_count(pixel.done) == nthr) break;
    const int j1 = b0 + nthr + tid;  // this thread's entry of batch k + 1
    if (j1 < count) fetch_row<D>(slot, table + static_cast<long long>(id_next) * ROW);
    cp_async_commit();
    if (j1 + nthr < count) id_next = tile_ids[j1 + nthr];
    pixel.blend(buffer(k), min(nthr, count - b0), b0);
    cp_async_wait_all();
    if (j1 < count) stage_row<D>(buffer(k + 1), tid, slot);
  }
  if (p >= 0) pixel.write(p, out, alpha_out, nullptr, nullptr);
}

// Raise a kernel instance's dynamic shared-memory limit once per device
// when a block needs more than the default 48 KB (D > 6 at 256 threads).
template <int D>
cudaError_t raise_smem(size_t bytes) {
  constexpr int MAX_DEVICES = 64;
  static bool raised[MAX_DEVICES] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && raised[dev])) return err;
  err = cudaFuncSetAttribute(raster_binned_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(binned_smem<D>(MAX_THREADS)));
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

}  // namespace

// means2d (N, 2), conics (N, 3), opacities (N,), colors (N, d_col), all
// contiguous f32; table an (N, ROW) f32 scratch that receives their rows;
// order (n_tiles,) int64 receives the tiles longest first, the order in
// which the blocks take them.
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
    const long long quads = (static_cast<long long>(n_splats) * Row<D>::FLOATS + 3) / 4;
    if (n_splats > 0)
      pack_rows_kernel<D><<<static_cast<unsigned>((quads + 255) / 256), 256, 0, s>>>(
          static_cast<const float*>(means2d), static_cast<const float*>(conics),
          static_cast<const float*>(opacities), static_cast<const float*>(colors), n_splats,
          static_cast<float*>(table));
    const size_t smem = binned_smem<D>(nthr);
    const cudaError_t err = raise_smem<D>(smem);
    if (err != cudaSuccess) return int(err);
    raster_binned_kernel<D><<<n_tiles, nthr, smem, s>>>(
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
  return raster::with_d_col(d_col, [&](auto d) {
    return static_cast<int>(binned_smem<decltype(d)::value>(tile_size * tile_size));
  });
}
