// Kernels K2, K2m and K5: flat tile-rasterizer forward (3D Gaussian splats),
// for sm_90a. One kernel body, two entries.
//
// Replaces (TPU, Pallas): hunyuanworld_mirror_tpu/ops/rasterizer_pallas.py:
// _kernel_flat and _kernel_flat_grouped. K2 (rasterize_flat_fwd) is
// _kernel_flat's launch from _forward_flat (public entry
// rasterize_flat_pallas): one camera. K2m (rasterize_flat_multi_fwd) is its
// launch with n_tiles != 0 from _forward_flat_multi (public entry
// rasterize_flat_pallas_multi): C cameras binned into one sorted list by
// ops/tiles.bin_gaussians_packed_multi, segment s being camera s / n_tiles,
// tile s % n_tiles. K5 (_kernel_flat_grouped, launched from
// _forward_flat_grouped when WM_RASTER_GROUP = G > 1) is K2's entry on the
// same list with each tile's segment clamped to its group's window. Input
// is a (tile | depth)-sorted, component-major intersection list: list
// segment s owns entries [starts[s], starts[s] + counts[s]) of packed (V, M).
//
// Why K5 is K2's entry and has no kernel of its own: the TPU kernel walked
// G consecutive tiles a grid step to amortise the step's fixed cost and to
// copy one contiguous DMA window a group. A block on this card pays neither
// cost, and a block that walks G tiles in index order holds its SM for the
// group's longest tile: that design took 1.6x K2's time on the same clamped
// lists (PERF.md). The windows themselves (rasterizer_pallas._group_windows)
// are computed on the host in JAX too, and stay plain torch
// (ops/rasterizer_flat.group_windows). What is left of K5's function is
// K2's blend on the clamped (starts, counts): one block a tile, the tiles
// longest first by the clamped counts, with K2's payloads and training
// planes; G shapes the windows and never reaches the card.
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
// pipes, the keep test (~10 operations) for each pixel and entry and ~25 for
// the few pairs kept (~3% of the pairs an unculled walk tests at 518 px),
// against 24-40 bytes of payload per entry read once; early termination
// cuts both. Design (raster_common.cuh): one block of 256 threads per tile,
// one thread per pixel, each warp a block of 8 x 4 pixels; the block stages
// a batch of blockDim entries into shared memory cooperatively (one entry
// per thread, decoded to f32, with the box outside which the entry passes
// no pixel's keep test), then each warp tests 32 of the staged boxes
// against its own pixels in one step and walks only the entries that hit (a
// ballot, in ascending order, two hits a step with their keep tests
// interleaved), each thread with its own transmittance. The block leaves as
// soon as __syncthreads_count says every pixel is done. What each piece
// does about the bound:
//   * the cull leaves the keep test only the (warp, entry) steps whose box
//     reaches the warp's pixels (~21% of them on the main path's lists); a
//     skipped entry is one no pixel of the warp keeps, so every pixel
//     blends exactly what it blended without it;
//   * the blocks take the tiles longest first, so that the last wave is
//     short: before the blend, one block of ORDER_BINS threads buckets the
//     tiles by count (a counting sort, a few microseconds, where
//     torch.argsort took ~28) and writes the order, which the training path
//     hands on to K3;
//   * one instance per colour width D (raster::with_d_col): the colour
//     loops of the kept pairs unrolled, no accumulator for an absent
//     channel, 47 registers at D = 4 instead of 64, so 5 blocks an SM;
//   * each staged entry one float4 (mx, my, ca, cb) and one float2
//     (cc, op), so that a pair's keep test takes two shared loads, not six.
// (Measured and dropped, tools/k2_ab.py --variants: a tile split over 2 or
// 4 blocks, which wait at fewer warps' barriers but stage and box every
// entry 2 or 4 times; warps of 16 x 2 pixels; a serial box check; a cap on
// the registers for more blocks an SM.)
// K2m differs only in its grid: all C cameras' tiles in one launch, the
// camera's image at offset camera * height * width of the output, the
// segments taken in the order the wrapper gives over all cameras.
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
#include "raster_order.cuh"

namespace {

// A block's threads at most: one per pixel of a 16 x 16 tile.
constexpr int MAX_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
raster_flat_kernel(const float* __restrict__ packed, const int* __restrict__ starts,
                   const int* __restrict__ counts, const long long* __restrict__ order,
                   float* __restrict__ out, float* __restrict__ alpha_out,
                   float* __restrict__ t_final, int* __restrict__ last_out, int width,
                   int height, int tile_size, int tiles_x, int n_tiles, long long M,
                   int f16) {
  extern __shared__ __align__(16) float sm[];
  const raster::Batch b(sm, blockDim.x);
  const int seg = order != nullptr ? int(order[blockIdx.x]) : blockIdx.x;
  const int cam = seg / n_tiles;
  raster::Pixel<D> pixel;
  const long long p = pixel.init(seg - cam * n_tiles, threadIdx.x >> 5, tiles_x, tile_size,
                                 width, height);
  const long long start = starts[seg];
  raster::blend_tile(b, counts[seg], pixel, [&](int j, int s) {
    raster::stage_list_entry(b, s, packed, M, start + j, D, f16);
  });
  if (p >= 0)
    pixel.write(static_cast<long long>(cam) * width * height + p, out, alpha_out, t_final,
                last_out);
}

int launch(const void* packed, const void* starts, const void* counts, void* order,
           void* out, void* alpha_out, void* t_final, void* last_out, int width,
           int height, int tile_size, int tiles_x, int n_tiles, int n_cams, int d_col,
           long long M, int f16, void* stream) {
  const int nthr = tile_size * tile_size;
  if (d_col < 1 || d_col > raster::MAX_D || !raster::tile_fits(tile_size, MAX_THREADS) ||
      n_tiles < 1 || n_cams < 1)
    return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (order != nullptr)
    raster::longest_first_kernel<<<1, raster::ORDER_BINS, 0, s>>>(static_cast<const int*>(counts),
                                                 n_tiles * n_cams,
                                                 static_cast<long long*>(order));
  return raster::with_d_col(d_col, [&](auto d) {
    raster_flat_kernel<decltype(d)::value>
        <<<n_tiles * n_cams, nthr, raster::batch_smem(nthr, d_col), s>>>(
            static_cast<const float*>(packed), static_cast<const int*>(starts),
            static_cast<const int*>(counts), static_cast<const long long*>(order),
            static_cast<float*>(out), static_cast<float*>(alpha_out),
            static_cast<float*>(t_final), static_cast<int*>(last_out), width, height,
            tile_size, tiles_x, n_tiles, M, f16);
    return int(cudaGetLastError());
  });
}

}  // namespace

// order (n_tiles,) int64 receives the tiles longest first, the order in which
// the blocks take them; null: the blocks take them in index order.
extern "C" int rasterize_flat_fwd(const void* packed, const void* starts, const void* counts,
                                  void* order, void* out, void* alpha_out,
                                  void* t_final, void* last_out, int width, int height,
                                  int tile_size, int tiles_x, int n_tiles, int d_col,
                                  long long M, int f16, void* stream) {
  return launch(packed, starts, counts, order, out, alpha_out, t_final, last_out, width,
                height, tile_size, tiles_x, n_tiles, 1, d_col, M, f16, stream);
}

// out (n_cams, height, width, d_col), alpha_out (n_cams, height, width);
// starts / counts camera-major, n_cams * n_tiles long; order, or null, as
// rasterize_flat_fwd's over those n_cams * n_tiles segments.
extern "C" int rasterize_flat_multi_fwd(const void* packed, const void* starts,
                                        const void* counts, void* order, void* out,
                                        void* alpha_out, int width, int height,
                                        int tile_size, int tiles_x, int n_tiles,
                                        int n_cams, int d_col, long long M, void* stream) {
  return launch(packed, starts, counts, order, out, alpha_out, nullptr, nullptr, width,
                height, tile_size, tiles_x, n_tiles, n_cams, d_col, M, 0, stream);
}

// Threads a block (a tile's pixels), and its dynamic shared memory in bytes
// (for occupancy arithmetic).
extern "C" int rasterize_flat_fwd_threads(int tile_size) { return tile_size * tile_size; }

extern "C" int rasterize_flat_fwd_smem(int tile_size, int d_col) {
  return static_cast<int>(raster::batch_smem(tile_size * tile_size, d_col));
}
