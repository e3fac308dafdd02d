// Kernel K6's shared forward math, for sm_90a: one pinhole camera and one
// splat, from the splat's parameters to what the blend takes. The forward
// (project_fwd.cu) writes it; the backward (project_bwd.cu) recomputes it.
//
// The forward has to reproduce the plain PyTorch code on the card bit for
// bit (ops/projection.py project_fwd_plain: quat_scale_to_covar_planes,
// fully_fused_projection, camera_splats), because its radii and depths
// decide the binning and the blend order. PyTorch runs that code one
// elementwise kernel an operation, each result rounded to f32 on its own.
// So every operation here is written with the round-to-nearest intrinsics
// (no contraction into FMAs), in the plain code's order, and the few
// places where PyTorch computes something other than what the Python text
// says are written as PyTorch computes them:
//   * a Python number over a tensor (0.5 * width / fx) is
//     reciprocal(fx) * number; a tensor over a Python number (x / 3.33) is
//     x * (1 / 3.33f), the reciprocal rounded to f32 first;
//   * a Python number meets an f32 tensor as an f32 (0.3, eps2d, 1e-10);
//   * torch.linalg.norm over a row of 4 is (q0^2 + q2^2) + (q1^2 + q3^2),
//     over a row of 3 (d0^2 + d2^2) + d1^2, each square rounded (its
//     reduction kernel gives each of 2 threads every other element);
//   * maximum, minimum and clamp return a NaN operand (a dead slot at a
//     camera's centre is 0 / 0 and must stay culled).

#pragma once

#include <cuda_runtime.h>

namespace proj {

// the flags argument's bits (ops/projection.py _flags)
constexpr int WXYZ = 1, COMP = 2, TIGHT = 4, RGB = 8, DEPTH = 16, CLIP = 32;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqr(float a) { return __fmul_rn(a, a); }
// torch.maximum / minimum / clamp_min / clamp_max: a NaN operand wins
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// eval_sh's constants (utils/sh.py), each a Python float met by an f32 tensor
constexpr float C0 = float(0.28209479177387814);
constexpr float C1 = float(0.4886025119029199);
constexpr float C2_0 = float(1.0925484305920792);
constexpr float C2_1 = float(-1.0925484305920792);
constexpr float C2_2 = float(0.31539156525252005);
constexpr float C2_3 = float(-1.0925484305920792);
constexpr float C2_4 = float(0.5462742152960396);
constexpr float C3_0 = float(-0.5900435899266435);
constexpr float C3_1 = float(2.890611442640554);
constexpr float C3_2 = float(-0.4570457994644658);
constexpr float C3_3 = float(0.3731763325901154);
constexpr float C3_4 = float(-0.4570457994644658);
constexpr float C3_5 = float(1.445305721320277);
constexpr float C3_6 = float(-0.5900435899266435);
constexpr float C4_0 = float(2.5033429417967046);
constexpr float C4_1 = float(-1.7701307697799304);
constexpr float C4_2 = float(0.9461746957575601);
constexpr float C4_3 = float(-0.6690465435572892);
constexpr float C4_4 = float(0.10578554691520431);
constexpr float C4_5 = float(-0.6690465435572892);
constexpr float C4_6 = float(0.47308734787878004);
constexpr float C4_7 = float(-1.7701307697799304);
constexpr float C4_8 = float(0.6258357354491761);

// One camera: world -> camera rotation w and translation t, K's first two
// rows, and _fov_limits' clamp of tx / tz and ty / tz.
struct Camera {
  float w[3][3], t[3], k[2][3];
  float lim_x_neg, lim_x_pos, lim_y_neg, lim_y_pos;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ viewmat,
                                              const float* __restrict__ K, int width,
                                              int height) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.w[i][j] = __ldg(viewmat + i * 4 + j);
    c.t[i] = __ldg(viewmat + i * 4 + 3);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) c.k[i][j] = __ldg(K + i * 3 + j);
  const float fx = c.k[0][0], fy = c.k[1][1], cx = c.k[0][2], cy = c.k[1][2];
  const float tan_x = mul(div(1.0f, fx), 0.5f * float(width));
  const float tan_y = mul(div(1.0f, fy), 0.5f * float(height));
  const float pad_x = mul(tan_x, float(0.3)), pad_y = mul(tan_y, float(0.3));
  c.lim_x_neg = add(div(cx, fx), pad_x);
  c.lim_x_pos = add(div(sub(float(width), cx), fx), pad_x);
  c.lim_y_neg = add(div(cy, fy), pad_y);
  c.lim_y_pos = add(div(sub(float(height), cy), fy), pad_y);
  return c;
}

// One splat in one camera: the forward's values, each rounded as the plain
// code rounds it.
struct Splat {
  float x, y, z, w, qn;        // the normalised XYZW quaternion and |q|
  float r[3][3];               // its rotation
  float s[3];                  // scales
  float tx, ty, tz;            // the mean in the camera frame
  float c00, c01, c02, c11, c12, c22;  // the covariance in the camera frame
  float rx, ry, clx, cly;      // tx / tz, ty / tz and their clamps
  float j00, j02, j11, j12;    // the EWA Jacobian
  float v00, v01, v11;         // the 2D covariance
  float u, v;                  // means2d
  float d00, d11, det_raw, det;  // dilated by eps2d; det clamped at 1e-10
};

__device__ __forceinline__ Splat project_splat(const Camera& cam, const float* __restrict__ mean,
                                               const float* __restrict__ quat,
                                               const float* __restrict__ scale, bool wxyz,
                                               float eps2d) {
  Splat p;
  // the XYZW quaternion, normalised (quat_scale_to_covar_planes)
  const float q0 = __ldg(quat + (wxyz ? 1 : 0)), q1 = __ldg(quat + (wxyz ? 2 : 1));
  const float q2 = __ldg(quat + (wxyz ? 3 : 2)), q3 = __ldg(quat + (wxyz ? 0 : 3));
  p.qn = __fsqrt_rn(add(add(sqr(q0), sqr(q2)), add(sqr(q1), sqr(q3))));
  p.x = div(q0, p.qn);
  p.y = div(q1, p.qn);
  p.z = div(q2, p.qn);
  p.w = div(q3, p.qn);
  const float x = p.x, y = p.y, z = p.z, w = p.w;
  p.r[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  p.r[0][1] = mul(2.0f, sub(mul(x, y), mul(z, w)));
  p.r[0][2] = mul(2.0f, add(mul(x, z), mul(y, w)));
  p.r[1][0] = mul(2.0f, add(mul(x, y), mul(z, w)));
  p.r[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  p.r[1][2] = mul(2.0f, sub(mul(y, z), mul(x, w)));
  p.r[2][0] = mul(2.0f, sub(mul(x, z), mul(y, w)));
  p.r[2][1] = mul(2.0f, add(mul(y, z), mul(x, w)));
  p.r[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  float m[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) p.s[j] = __ldg(scale + j);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) m[i][j] = mul(p.r[i][j], p.s[j]);
  float S[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j)
      S[i][j] = S[j][i] =
          add(add(mul(m[i][0], m[j][0]), mul(m[i][1], m[j][1])), mul(m[i][2], m[j][2]));

  // world -> camera (fully_fused_projection)
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = add(add(add(mul(cam.w[i][0], __ldg(mean)), mul(cam.w[i][1], __ldg(mean + 1))),
                   mul(cam.w[i][2], __ldg(mean + 2))),
               cam.t[i]);
  p.tx = t[0];
  p.ty = t[1];
  p.tz = t[2];
  float A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      A[i][k] = add(add(mul(cam.w[i][0], S[0][k]), mul(cam.w[i][1], S[1][k])),
                    mul(cam.w[i][2], S[2][k]));
  auto cc = [&](int i, int j) {
    return add(add(mul(A[i][0], cam.w[j][0]), mul(A[i][1], cam.w[j][1])),
               mul(A[i][2], cam.w[j][2]));
  };
  p.c00 = cc(0, 0);
  p.c01 = cc(0, 1);
  p.c02 = cc(0, 2);
  p.c11 = cc(1, 1);
  p.c12 = cc(1, 2);
  p.c22 = cc(2, 2);

  // the EWA Jacobian with the field-of-view clamp
  const float fx = cam.k[0][0], fy = cam.k[1][1], tz = p.tz;
  p.rx = div(p.tx, tz);
  p.ry = div(p.ty, tz);
  p.clx = tmin(tmax(p.rx, -cam.lim_x_neg), cam.lim_x_pos);
  p.cly = tmin(tmax(p.ry, -cam.lim_y_neg), cam.lim_y_pos);
  const float txc = mul(tz, p.clx), tyc = mul(tz, p.cly), tz2 = mul(tz, tz);
  p.j00 = div(fx, tz);
  p.j02 = div(mul(-fx, txc), tz2);
  p.j11 = div(fy, tz);
  p.j12 = div(mul(-fy, tyc), tz2);
  const float j00 = p.j00, j02 = p.j02, j11 = p.j11, j12 = p.j12;
  p.v00 = add(add(mul(mul(j00, j00), p.c00), mul(mul(mul(2.0f, j00), j02), p.c02)),
              mul(mul(j02, j02), p.c22));
  p.v01 = add(add(add(mul(mul(j00, j11), p.c01), mul(mul(j00, j12), p.c02)),
                  mul(mul(j02, j11), p.c12)),
              mul(mul(j02, j12), p.c22));
  p.v11 = add(add(mul(mul(j11, j11), p.c11), mul(mul(mul(2.0f, j11), j12), p.c12)),
              mul(mul(j12, j12), p.c22));
  p.u = div(add(add(mul(cam.k[0][0], p.tx), mul(cam.k[0][1], p.ty)), mul(cam.k[0][2], tz)), tz);
  p.v = div(add(add(mul(cam.k[1][0], p.tx), mul(cam.k[1][1], p.ty)), mul(cam.k[1][2], tz)), tz);
  p.d00 = add(p.v00, eps2d);
  p.d11 = add(p.v11, eps2d);
  p.det_raw = sub(mul(p.d00, p.d11), mul(p.v01, p.v01));
  p.det = tmax(p.det_raw, float(1e-10));
  return p;
}

// sh_colors' camera centre and the unit direction from it to the mean
// (d / max(|d|, 1e-8)); nrm is |d|.
struct Dir {
  float d[3], x, y, z, nrm;
};

__device__ __forceinline__ Dir view_dir(const Camera& cam, const float* __restrict__ mean) {
  Dir r;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // -einsum("ij,i->j", R, t)
    const float ct = -add(add(mul(cam.w[0][j], cam.t[0]), mul(cam.w[1][j], cam.t[1])),
                          mul(cam.w[2][j], cam.t[2]));
    r.d[j] = sub(__ldg(mean + j), ct);
  }
  r.nrm = __fsqrt_rn(add(add(sqr(r.d[0]), sqr(r.d[2])), sqr(r.d[1])));
  const float nc = tmax(r.nrm, float(1e-8));
  r.x = div(r.d[0], nc);
  r.y = div(r.d[1], nc);
  r.z = div(r.d[2], nc);
  return r;
}

// eval_sh(deg, ...) of one channel, sh[k * 3] its coefficient k, before
// + 0.5 and the clamp; each term as eval_sh's Python text rounds it.
__device__ __forceinline__ float eval_sh(int deg, const float* __restrict__ sh, float x, float y,
                                         float z) {
  auto c = [&](int k) { return __ldg(sh + 3 * k); };
  float r = mul(C0, c(0));
  if (deg > 0) {
    r = sub(add(sub(r, mul(mul(C1, y), c(1))), mul(mul(C1, z), c(2))), mul(mul(C1, x), c(3)));
    if (deg > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      r = add(r, mul(mul(C2_0, xy), c(4)));
      r = add(r, mul(mul(C2_1, yz), c(5)));
      r = add(r, mul(mul(C2_2, sub(sub(mul(2.0f, zz), xx), yy)), c(6)));
      r = add(r, mul(mul(C2_3, xz), c(7)));
      r = add(r, mul(mul(C2_4, sub(xx, yy)), c(8)));
      if (deg > 2) {
        r = add(r, mul(mul(mul(C3_0, y), sub(mul(3.0f, xx), yy)), c(9)));
        r = add(r, mul(mul(mul(C3_1, xy), z), c(10)));
        r = add(r, mul(mul(mul(C3_2, y), sub(sub(mul(4.0f, zz), xx), yy)), c(11)));
        r = add(r, mul(mul(mul(C3_3, z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy))),
                       c(12)));
        r = add(r, mul(mul(mul(C3_4, x), sub(sub(mul(4.0f, zz), xx), yy)), c(13)));
        r = add(r, mul(mul(mul(C3_5, z), sub(xx, yy)), c(14)));
        r = add(r, mul(mul(mul(C3_6, x), sub(xx, mul(3.0f, yy))), c(15)));
        if (deg > 3) {
          r = add(r, mul(mul(mul(C4_0, xy), sub(xx, yy)), c(16)));
          r = add(r, mul(mul(mul(C4_1, yz), sub(mul(3.0f, xx), yy)), c(17)));
          r = add(r, mul(mul(mul(C4_2, xy), sub(mul(7.0f, zz), 1.0f)), c(18)));
          r = add(r, mul(mul(mul(C4_3, yz), sub(mul(7.0f, zz), 3.0f)), c(19)));
          r = add(r, mul(mul(C4_4, add(mul(zz, sub(mul(35.0f, zz), 30.0f)), 3.0f)), c(20)));
          r = add(r, mul(mul(mul(C4_5, xz), sub(mul(7.0f, zz), 3.0f)), c(21)));
          r = add(r, mul(mul(mul(C4_6, sub(xx, yy)), sub(mul(7.0f, zz), 1.0f)), c(22)));
          r = add(r, mul(mul(mul(C4_7, xz), sub(xx, mul(3.0f, yy))), c(23)));
          r = add(r, mul(mul(C4_8, sub(mul(xx, sub(xx, mul(3.0f, yy))),
                                        mul(yy, sub(mul(3.0f, xx), yy)))),
                         c(24)));
        }
      }
    }
  }
  return r;
}

}  // namespace proj
