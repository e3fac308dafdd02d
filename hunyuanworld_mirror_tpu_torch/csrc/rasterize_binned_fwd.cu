// Kernel K4: dense-bin tile-rasterizer forward (3D Gaussian splats), for
// sm_90a.
//
// Replaces (TPU, Pallas): hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:
// _kernel (launched from _forward_pallas, public entry
// rasterize_binned_pallas; its caller is the per-rank render of
// ops/distributed.py). Input is the dense bins of ops/tiles.bin_gaussians:
// an (n_tiles, max_per_tile) int32 table of splat ids, tile t's first
// counts[t] of them depth-sorted front to back, and the splats' parameters
// as an (N, 6 + D) row-major table [mx, my, ca, cb, cc, op, col_0 ..
// col_{D-1}].
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
// kernel needs no such copy: it is K2's loop with one indirection. A block
// of tile_size^2 threads per tile stages a batch of blockDim entries in
// shared memory, each thread reading one id and then that splat's 40-byte
// row (and computing its keep box), and each warp of 8 x 4 pixels walks the
// entries whose box reaches it. What bounds it on
// this card: K2's per-pair arithmetic on the FP32 pipes, against 4 bytes of
// id plus one (6 + D)-float row per live entry; the rows are scattered
// reads, so the byte side costs whole 32-byte sectors.
//
// C interface: rasterize_binned_fwd(...) returns cudaGetLastError().

#include "raster_common.cuh"

namespace {

template <int D>
__global__ void raster_binned_kernel(const float* __restrict__ table,
                                     const int* __restrict__ ids,
                                     const int* __restrict__ counts,
                                     float* __restrict__ out, float* __restrict__ alpha_out,
                                     int width, int height, int tile_size, int tiles_x,
                                     int max_per_tile) {
  extern __shared__ __align__(16) float sm[];
  const raster::Batch b(sm, blockDim.x);
  const int t = blockIdx.x;
  raster::Pixel<D> pixel;
  const long long p = pixel.init(t, threadIdx.x >> 5, tiles_x, tile_size, width, height);
  const int* tile_ids = ids + static_cast<long long>(t) * max_per_tile;
  constexpr int row_len = 6 + D;
  raster::blend_tile(b, min(counts[t], max_per_tile), pixel, [&](int j, int s) {
    const float* row = table + static_cast<long long>(tile_ids[j]) * row_len;
    b.put(s, {row[0], row[1], row[2], row[3], row[4], row[5]});
    for (int c = 0; c < D; ++c) b.col[c * b.nthr + s] = row[6 + c];
  });
  if (p >= 0) pixel.write(p, out, alpha_out, nullptr, nullptr);
}

}  // namespace

extern "C" int rasterize_binned_fwd(const void* table, const void* ids, const void* counts,
                                    void* out, void* alpha_out, int width, int height,
                                    int tile_size, int tiles_x, int n_tiles, int d_col,
                                    int max_per_tile, void* stream) {
  const int nthr = tile_size * tile_size;
  if (d_col < 1 || d_col > raster::MAX_D || !raster::tile_fits(tile_size, 1024) ||
      n_tiles < 1 || max_per_tile < 1)
    return int(cudaErrorInvalidValue);
  return raster::with_d_col(d_col, [&](auto d) {
    raster_binned_kernel<decltype(d)::value>
        <<<n_tiles, nthr, raster::batch_smem(nthr, d_col),
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(table), static_cast<const int*>(ids),
            static_cast<const int*>(counts), static_cast<float*>(out),
            static_cast<float*>(alpha_out), width, height, tile_size, tiles_x,
            max_per_tile);
    return int(cudaGetLastError());
  });
}
