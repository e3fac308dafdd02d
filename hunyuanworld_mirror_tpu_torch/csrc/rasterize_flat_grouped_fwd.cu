// Kernel K5: grouped flat tile-rasterizer forward (3D Gaussian splats), for
// sm_90a.
//
// Replaces (TPU, Pallas): hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:
// _kernel_flat_grouped (launched from _forward_flat_grouped when
// WM_RASTER_GROUP = G > 1). Input is K2's sorted, component-major list with
// each tile's segment clamped to its group's window (ops/rasterizer_flat
// group_windows): tile t blends entries [starts[t], starts[t] + counts[t]).
// Its output is K2's on the clamped segments, so wherever no window clamps
// it is K2's output bit for bit.
//
// The TPU kernel grouped G consecutive tiles per grid step to amortise the
// step's fixed cost and to copy one contiguous DMA window per group. A
// block on this card pays neither cost, so no window is copied: one block of
// tile_size^2 threads walks its G tiles one after another, each with K2's
// loop (raster_common.cuh blend_tile: batches of blockDim entries staged in
// shared memory with their keep boxes, one thread per pixel, warps of 8 x 4
// pixels that skip the entries whose box misses them, early exit per
// tile). What bounds it is K2's bound (the per-pair keep test on the FP32
// pipes against the list's bytes read once); a larger G means fewer, longer
// blocks, 1089 / G of them at 518 px for 132 SMs.
//
// f32 and f16-pair payloads, and K2's optional training planes (final T,
// tile-local index of the last kept entry), null at inference.
//
// C interface: rasterize_flat_grouped_fwd(...) returns cudaGetLastError().

#include "raster_common.cuh"

namespace {

template <int D>
__global__ void raster_flat_grouped_kernel(const float* __restrict__ packed,
                                           const int* __restrict__ starts,
                                           const int* __restrict__ counts,
                                           float* __restrict__ out,
                                           float* __restrict__ alpha_out,
                                           float* __restrict__ t_final,
                                           int* __restrict__ last_out, int width,
                                           int height, int tile_size, int tiles_x,
                                           int n_tiles, int group, long long M, int f16) {
  extern __shared__ __align__(16) float sm[];
  const raster::Batch b(sm, blockDim.x);
  for (int g = 0; g < group; ++g) {
    const int t = blockIdx.x * group + g;
    if (t >= n_tiles) break;
    raster::Pixel<D> pixel;
    const long long p =
        pixel.init(t, threadIdx.x >> 5, tiles_x, tile_size, width, height);
    const long long start = starts[t];
    raster::blend_tile(b, counts[t], pixel, [&](int j, int s) {
      raster::stage_list_entry(b, s, packed, M, start + j, D, f16);
    });
    if (p >= 0) pixel.write(p, out, alpha_out, t_final, last_out);
  }
}

}  // namespace

extern "C" int rasterize_flat_grouped_fwd(const void* packed, const void* starts,
                                          const void* counts, void* out, void* alpha_out,
                                          void* t_final, void* last_out, int width,
                                          int height, int tile_size, int tiles_x,
                                          int n_tiles, int group, int d_col, long long M,
                                          int f16, void* stream) {
  const int nthr = tile_size * tile_size;
  if (d_col < 1 || d_col > raster::MAX_D || !raster::tile_fits(tile_size, 1024) ||
      n_tiles < 1 || group < 1)
    return int(cudaErrorInvalidValue);
  const int n_groups = (n_tiles + group - 1) / group;
  return raster::with_d_col(d_col, [&](auto d) {
    raster_flat_grouped_kernel<decltype(d)::value>
        <<<n_groups, nthr, raster::batch_smem(nthr, d_col),
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(packed), static_cast<const int*>(starts),
            static_cast<const int*>(counts), static_cast<float*>(out),
            static_cast<float*>(alpha_out), static_cast<float*>(t_final),
            static_cast<int*>(last_out), width, height, tile_size, tiles_x, n_tiles, group,
            M, f16);
    return int(cudaGetLastError());
  });
}
