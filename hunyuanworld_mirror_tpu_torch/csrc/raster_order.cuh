// The tile order of the forward rasterizer kernels K2 / K2m
// (rasterize_flat_fwd.cu) and K4 (rasterize_binned_fwd.cu): blocks take the
// tiles longest first, so that the last wave is short. One block sorts the
// counts into bins (a counting sort of a few microseconds, where
// torch.argsort took ~28), launched before the blend on the same stream.
// The order within a bin does not change what any tile blends.

#pragma once

#include "raster_common.cuh"

namespace raster {

constexpr int ORDER_BINS = 1024;

// The segments longest first, into order (n,): one block of ORDER_BINS
// threads puts each segment in one of ORDER_BINS bins by count (the longest
// in bin 0, bins max count / (ORDER_BINS - 1) wide), scans the bins' sizes
// and scatters each segment's index to its bin's next free slot. Within a
// bin the order is the atomics' (it does not change what a tile blends).
__global__ void __launch_bounds__(ORDER_BINS)
longest_first_kernel(const int* __restrict__ counts, int n, long long* __restrict__ order) {
  __shared__ int s_bin[ORDER_BINS];
  __shared__ int s_warp[ORDER_BINS / 32];
  __shared__ int s_top;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int top = 0;
  for (int i = tid; i < n; i += ORDER_BINS) top = max(top, counts[i]);
  top = __reduce_max_sync(FULL_MASK, top);
  if (tid == 0) s_top = 1;
  s_bin[tid] = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&s_top, top);
  __syncthreads();
  const long long scale = s_top;
  const auto bin_of = [&](int c) {
    return ORDER_BINS - 1 - int(static_cast<long long>(max(c, 0)) * (ORDER_BINS - 1) / scale);
  };
  for (int i = tid; i < n; i += ORDER_BINS) atomicAdd(&s_bin[bin_of(counts[i])], 1);
  __syncthreads();
  // exclusive scan of the bins' sizes: in each warp, then over the warps
  const int size = s_bin[tid];
  int x = size;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  s_bin[tid] = x - size + (warp > 0 ? s_warp[warp - 1] : 0);
  __syncthreads();
  for (int i = tid; i < n; i += ORDER_BINS) order[atomicAdd(&s_bin[bin_of(counts[i])], 1)] = i;
}

}  // namespace raster
