// Kernel K6, forward: one pinhole camera's projection of N 3D Gaussian
// splats, for sm_90a.
//
// Replaces: no TPU kernel. The projection is plain XLA in the JAX package
// (hunyuanworld_mirror_tpu/ops/projection.py fully_fused_projection and the
// per-camera body of ops/rasterizer.py) and plain PyTorch in the port
// (ops/projection.py project_fwd_plain), which on the card is ~240 short
// elementwise launches a camera that the host paces. This kernel is
// gsplat's fully_fused_projection in one launch a camera.
//
// One thread a splat reads its mean (3), quaternion (4, XYZW or WXYZ),
// scales (3), opacity and colours (D direct channels or K x 3 SH
// coefficients), and the camera (viewmat 4 x 4, K 3 x 3) from device
// memory, and writes what the blend takes (rasterizer.CameraSplats):
//   means2d (N, 2), conics (N, 3), the render mode's channels (N, D'),
//   the opacities times the anti-aliasing compensation (only with COMP),
//   radii (N, 2) int32 (opacity-tight with TIGHT), depths (N,).
// Per splat: the covariance R diag(s)^2 R^T, the camera-frame mean and
// covariance, the EWA Jacobian with the field-of-view clamp, the 2D
// covariance dilated by eps2d, its inverse (the conic), 3.33-sigma radii
// culled at near / far, radius_clip, det <= 0 and the image's edges, then
// the alpha >= 1/255 radii and the SH colours toward the camera.
//
// What bounds it on this card: 104 bytes a splat moved at RGB+ED and SH
// degree 0 (56 read, 48 written) against ~300 f32 operations, so it is
// bound by memory; 1.07M splats move ~0.11 GB, ~0.033 ms at 3.35 TB/s. The operations are rounded
// one at a time (project_common.cuh), which costs instructions but not
// bytes. Every thread reads the same 25 camera floats, which the L1 serves.

#include <cuda_runtime.h>

#include "project_common.cuh"

namespace {

using namespace proj;

__global__ void __launch_bounds__(256)
    project_fwd_kernel(const float* __restrict__ means, const float* __restrict__ quats,
                       const float* __restrict__ scales, const float* __restrict__ opac,
                       const float* __restrict__ colors, const float* __restrict__ viewmat,
                       const float* __restrict__ K, float* __restrict__ means2d,
                       float* __restrict__ conics, float* __restrict__ cols,
                       float* __restrict__ op_out, int* __restrict__ radii,
                       float* __restrict__ depths, long long n, int width, int height,
                       float eps2d, float near_plane, float far_plane, float radius_clip,
                       int flags, int d_rgb, int sh_k, int sh_deg, int d_out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const Camera cam = load_camera(viewmat, K, width, height);
  const Splat p = project_splat(cam, means + 3 * i, quats + 4 * i, scales + 3 * i,
                                flags & WXYZ, eps2d);

  // finish: conic, radii, culling (fully_fused_projection's tail)
  const float ca = div(p.d11, p.det), cb = div(-p.v01, p.det), cc = div(p.d00, p.det);
  const float rad_x = ceilf(mul(float(3.33), __fsqrt_rn(p.d00)));
  const float rad_y = ceilf(mul(float(3.33), __fsqrt_rn(p.d11)));
  bool keep = p.det > 0.0f && p.tz > near_plane && p.tz < far_plane;
  if (flags & CLIP) keep = keep && tmax(rad_x, rad_y) > radius_clip;
  keep = keep && add(p.u, rad_x) > 0.0f && sub(p.u, rad_x) < float(width) &&
         add(p.v, rad_y) > 0.0f && sub(p.v, rad_y) < float(height);
  int rx = keep ? int(tmin(rad_x, 1073741824.0f)) : 0;
  int ry = keep ? int(tmin(rad_y, 1073741824.0f)) : 0;

  float op = __ldg(opac + i);
  if (flags & COMP) {
    const float det_orig = sub(mul(p.v00, p.v11), mul(p.v01, p.v01));
    op = mul(op, __fsqrt_rn(tmax(div(det_orig, p.det), 0.0f)));
    op_out[i] = op;
  }
  if (flags & TIGHT) {
    // tiles.opacity_tight_radii: the alpha >= 1/255 level set
    const float lvl = mul(2.0f, logf(mul(tmax(op, float(1e-12)), 255.0f)));
    const float f = tmin(mul(__fsqrt_rn(tmax(lvl, 0.0f)), 1.0f / float(3.33)), 1.0f);
    const bool live = lvl > 0.0f;
    rx = live ? int(ceilf(mul(float(rx), f))) : 0;
    ry = live ? int(ceilf(mul(float(ry), f))) : 0;
  }

  float* col = cols + i * d_out;
  if (flags & RGB) {
    if (sh_k == 0) {
      for (int c = 0; c < d_rgb; ++c) col[c] = __ldg(colors + i * d_rgb + c);
    } else {
      Dir d = {};
      if (sh_deg > 0) d = view_dir(cam, means + 3 * i);
      const float* sh = colors + i * sh_k * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        col[c] = tmax(add(eval_sh(sh_deg, sh + c, d.x, d.y, d.z), 0.5f), 0.0f);
    }
  }
  if (flags & DEPTH) col[d_out - 1] = p.tz;
  reinterpret_cast<float2*>(means2d)[i] = make_float2(p.u, p.v);
  conics[3 * i] = ca;
  conics[3 * i + 1] = cb;
  conics[3 * i + 2] = cc;
  reinterpret_cast<int2*>(radii)[i] = make_int2(rx, ry);
  depths[i] = p.tz;
}

}  // namespace

// means (N, 3), quats (N, 4), scales (N, 3), opac (N,), colors (N, d_rgb) or
// (N, sh_k, 3), viewmat (4, 4), K (3, 3), all f32 and contiguous on the
// card; outputs as in the header comment, cols (N, d_out), op_out null
// without COMP. flags: proj::WXYZ | COMP | TIGHT | RGB | DEPTH | CLIP.
extern "C" int project_fwd(const void* means, const void* quats, const void* scales,
                           const void* opac, const void* colors, const void* viewmat,
                           const void* K, void* means2d, void* conics, void* cols, void* op_out,
                           void* radii, void* depths, long long n, int width, int height,
                           float eps2d, float near_plane, float far_plane, float radius_clip,
                           int flags, int d_rgb, int sh_k, int sh_deg, int d_out,
                           void* stream) {
  if (n < 0 || sh_deg < 0 || sh_deg > 4 || ((flags & proj::COMP) && op_out == nullptr))
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int threads = 256;
  project_fwd_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(quats),
      static_cast<const float*>(scales), static_cast<const float*>(opac),
      static_cast<const float*>(colors), static_cast<const float*>(viewmat),
      static_cast<const float*>(K), static_cast<float*>(means2d), static_cast<float*>(conics),
      static_cast<float*>(cols), static_cast<float*>(op_out), static_cast<int*>(radii),
      static_cast<float*>(depths), n, width, height, eps2d, near_plane, far_plane,
      radius_clip, flags, d_rgb, sh_k, sh_deg, d_out);
  return int(cudaGetLastError());
}
