// Kernels K2 and K2m: flat tile-rasterizer forward (3D Gaussian splats), for
// sm_90a. One kernel body, two entries.
//
// Replaces (TPU, Pallas): hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:
// _kernel_flat. K2 (rasterize_flat_fwd) is its launch from _forward_flat
// (public entry rasterize_flat_pallas): one camera. K2m
// (rasterize_flat_multi_fwd) is its launch with n_tiles != 0 from
// _forward_flat_multi (public entry rasterize_flat_pallas_multi): C cameras
// binned into one sorted list by ops/tiles.bin_gaussians_packed_multi, block
// b blending camera b / n_tiles, tile b % n_tiles. Input is a (tile | depth)-
// sorted, component-major intersection list: list segment s owns entries
// [starts[s], starts[s] + counts[s]) of packed (V, M).
//
// Per pixel, front to back over its tile's entries (raster_common.cuh):
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
// K2m differs only in its grid: all C cameras' tiles in one launch, the
// camera's image at offset camera * height * width of the output.
//
// Payload: f32 or f16 pairs (raster_common.cuh stage_list_entry); the f16
// decode keeps the JAX decode's flush-to-zero of subnormals. K2m takes the
// f32 payload only, as the JAX multi path does.
//
// Training adds two per-pixel planes for the backward (kernel K3,
// rasterize_flat_bwd.cu): the final transmittance and the tile-local index
// of the last kept entry (-1 if none). Their pointers are null on the
// inference path, which then writes nothing more.
//
// C interface: rasterize_flat_fwd(...) and rasterize_flat_multi_fwd(...)
// return cudaGetLastError().

#include "raster_common.cuh"

namespace {

__global__ void raster_flat_kernel(const float* __restrict__ packed,
                                   const int* __restrict__ starts,
                                   const int* __restrict__ counts,
                                   float* __restrict__ out, float* __restrict__ alpha_out,
                                   float* __restrict__ t_final, int* __restrict__ last_out,
                                   int width, int height, int tile_size, int tiles_x,
                                   int n_tiles, int d_col, long long M, int f16) {
  extern __shared__ float sm[];
  const raster::Batch b(sm, blockDim.x);
  const int seg = blockIdx.x;
  const int cam = seg / n_tiles;
  raster::Pixel pixel;
  const long long p = pixel.init(seg - cam * n_tiles, tiles_x, tile_size, width, height);
  const long long start = starts[seg];
  raster::blend_tile(b, counts[seg], d_col, pixel, [&](int j, int s) {
    raster::stage_list_entry(b, s, packed, M, start + j, d_col, f16);
  });
  if (p >= 0)
    pixel.write(static_cast<long long>(cam) * width * height + p, d_col, out, alpha_out,
                t_final, last_out);
}

int launch(const void* packed, const void* starts, const void* counts, void* out,
           void* alpha_out, void* t_final, void* last_out, int width, int height,
           int tile_size, int tiles_x, int n_tiles, int n_cams, int d_col, long long M,
           int f16, void* stream) {
  const int nthr = tile_size * tile_size;
  if (d_col < 1 || d_col > raster::MAX_D || nthr > 1024 || n_tiles < 1 || n_cams < 1)
    return int(cudaErrorInvalidValue);
  raster_flat_kernel<<<n_tiles * n_cams, nthr, raster::batch_smem(nthr, d_col),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<float*>(out),
      static_cast<float*>(alpha_out), static_cast<float*>(t_final),
      static_cast<int*>(last_out), width, height, tile_size, tiles_x, n_tiles, d_col, M,
      f16);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int rasterize_flat_fwd(const void* packed, const void* starts, const void* counts,
                                  void* out, void* alpha_out, void* t_final,
                                  void* last_out, int width, int height,
                                  int tile_size, int tiles_x, int n_tiles, int d_col,
                                  long long M, int f16, void* stream) {
  return launch(packed, starts, counts, out, alpha_out, t_final, last_out, width, height,
                tile_size, tiles_x, n_tiles, 1, d_col, M, f16, stream);
}

// out (n_cams, height, width, d_col), alpha_out (n_cams, height, width);
// starts / counts camera-major, n_cams * n_tiles long.
extern "C" int rasterize_flat_multi_fwd(const void* packed, const void* starts,
                                        const void* counts, void* out, void* alpha_out,
                                        int width, int height, int tile_size, int tiles_x,
                                        int n_tiles, int n_cams, int d_col, long long M,
                                        void* stream) {
  return launch(packed, starts, counts, out, alpha_out, nullptr, nullptr, width, height,
                tile_size, tiles_x, n_tiles, n_cams, d_col, M, 0, stream);
}
