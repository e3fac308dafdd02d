// Kernel K6, backward: the VJP of the forward (project_fwd.cu) for one
// pinhole camera, for sm_90a.
//
// Replaces: no TPU kernel. In the JAX package this is XLA's autodiff of the
// plain projection; in the port it transcribes the analytic VJP
// ops/projection.py project_bwd_plain, which on the card replaces ~300
// autograd launches a camera that the host paces (and the forward's
// tensors autograd keeps alive until the backward).
//
// One thread a splat: it recomputes the forward from the inputs (the
// forward saves nothing but its inputs, as gsplat's
// fully_fused_projection_bwd), reads the cotangents of means2d (N, 2),
// conics (N, 3), the render mode's channels (N, D'), the compensated
// opacities (N,) and the depths (N,) wherever they lie (row and column
// strides; a null pointer is a zero cotangent), and writes every row of
// the gradients of means (N, 3), quats (N, 4, the caller's order), scales
// (N, 3), opacities (only with COMP) and the colours (N, D) or (N, K, 3),
// so that no output needs zeroing first. A row whose cotangents are all
// zero writes zeros: its true VJP, where its partials may be NaN (a dead
// slot at a camera's centre is 0 / 0).
//
// The chain, per splat: conics <- det, d00, d11, v01; the compensation;
// the 2D covariance J C J^T <- J, C; J and means2d <- the camera-frame
// mean through the field-of-view clamp; C = W Sigma W^T <- Sigma = M M^T,
// M = R(q / |q|) diag(s); the SH colours <- coefficients and, for degrees
// above 0, the mean through the view direction. Memory bound as the
// forward: ~56 bytes read, ~44 cotangent bytes read and ~56 written a
// splat at D' = 4.

#include <cuda_runtime.h>

#include "project_common.cuh"

namespace {

using namespace proj;

// eval_sh's term k without its coefficient: the basis b and its partials
// in x, y, z.
__device__ __forceinline__ void sh_term(int k, float x, float y, float z, float& b, float& bx,
                                        float& by, float& bz) {
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
  bx = by = bz = 0.0f;
  switch (k) {
    case 0: b = C0; break;
    case 1: b = -C1 * y; by = -C1; break;
    case 2: b = C1 * z; bz = C1; break;
    case 3: b = -C1 * x; bx = -C1; break;
    case 4: b = C2_0 * xy; bx = C2_0 * y; by = C2_0 * x; break;
    case 5: b = C2_1 * yz; by = C2_1 * z; bz = C2_1 * y; break;
    case 6:
      b = C2_2 * (2.0f * zz - xx - yy);
      bx = -2.0f * C2_2 * x; by = -2.0f * C2_2 * y; bz = 4.0f * C2_2 * z;
      break;
    case 7: b = C2_3 * xz; bx = C2_3 * z; bz = C2_3 * x; break;
    case 8: b = C2_4 * (xx - yy); bx = 2.0f * C2_4 * x; by = -2.0f * C2_4 * y; break;
    case 9:
      b = C3_0 * y * (3.0f * xx - yy);
      bx = 6.0f * C3_0 * xy; by = 3.0f * C3_0 * (xx - yy);
      break;
    case 10: b = C3_1 * xy * z; bx = C3_1 * yz; by = C3_1 * xz; bz = C3_1 * xy; break;
    case 11:
      b = C3_2 * y * (4.0f * zz - xx - yy);
      bx = -2.0f * C3_2 * xy; by = C3_2 * (4.0f * zz - xx - 3.0f * yy);
      bz = 8.0f * C3_2 * yz;
      break;
    case 12:
      b = C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      bx = -6.0f * C3_3 * xz; by = -6.0f * C3_3 * yz;
      bz = C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      break;
    case 13:
      b = C3_4 * x * (4.0f * zz - xx - yy);
      bx = C3_4 * (4.0f * zz - 3.0f * xx - yy); by = -2.0f * C3_4 * xy;
      bz = 8.0f * C3_4 * xz;
      break;
    case 14:
      b = C3_5 * z * (xx - yy);
      bx = 2.0f * C3_5 * xz; by = -2.0f * C3_5 * yz; bz = C3_5 * (xx - yy);
      break;
    case 15:
      b = C3_6 * x * (xx - 3.0f * yy);
      bx = 3.0f * C3_6 * (xx - yy); by = -6.0f * C3_6 * xy;
      break;
    case 16:
      b = C4_0 * xy * (xx - yy);
      bx = C4_0 * y * (3.0f * xx - yy); by = C4_0 * x * (xx - 3.0f * yy);
      break;
    case 17:
      b = C4_1 * yz * (3.0f * xx - yy);
      bx = 6.0f * C4_1 * xy * z; by = 3.0f * C4_1 * z * (xx - yy);
      bz = C4_1 * y * (3.0f * xx - yy);
      break;
    case 18:
      b = C4_2 * xy * (7.0f * zz - 1.0f);
      bx = C4_2 * y * (7.0f * zz - 1.0f); by = C4_2 * x * (7.0f * zz - 1.0f);
      bz = 14.0f * C4_2 * xy * z;
      break;
    case 19:
      b = C4_3 * yz * (7.0f * zz - 3.0f);
      by = C4_3 * z * (7.0f * zz - 3.0f); bz = C4_3 * y * (21.0f * zz - 3.0f);
      break;
    case 20:
      b = C4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
      bz = C4_4 * z * (140.0f * zz - 60.0f);
      break;
    case 21:
      b = C4_5 * xz * (7.0f * zz - 3.0f);
      bx = C4_5 * z * (7.0f * zz - 3.0f); bz = C4_5 * x * (21.0f * zz - 3.0f);
      break;
    case 22:
      b = C4_6 * (xx - yy) * (7.0f * zz - 1.0f);
      bx = 2.0f * C4_6 * x * (7.0f * zz - 1.0f); by = -2.0f * C4_6 * y * (7.0f * zz - 1.0f);
      bz = 14.0f * C4_6 * z * (xx - yy);
      break;
    case 23:
      b = C4_7 * xz * (xx - 3.0f * yy);
      bx = 3.0f * C4_7 * z * (xx - yy); by = -6.0f * C4_7 * xy * z;
      bz = C4_7 * x * (xx - 3.0f * yy);
      break;
    default:
      b = C4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
      bx = 4.0f * C4_8 * x * (xx - 3.0f * yy); by = 4.0f * C4_8 * y * (yy - 3.0f * xx);
      break;
  }
}

// d minimum(maximum(r, lo), hi) / dr as autograd takes it (a tie splits)
__device__ __forceinline__ float clamp_weight(float r, float lo, float hi) {
  const float m = fmaxf(r, lo);
  const float a = r > lo ? 1.0f : (r == lo ? 0.5f : 0.0f);
  return a * (m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f));
}

// the cotangents' (row, column) strides in elements: means2d, conics, the
// channels, the opacities, the depths
struct Strides {
  long long s[10];
};
constexpr int M2D = 0, CON = 2, COL = 4, OP = 6, DEP = 8;

__global__ void __launch_bounds__(256)
    project_bwd_kernel(const float* __restrict__ means, const float* __restrict__ quats,
                       const float* __restrict__ scales, const float* __restrict__ opac,
                       const float* __restrict__ colors, const float* __restrict__ viewmat,
                       const float* __restrict__ K, const float* __restrict__ v_m2d,
                       const float* __restrict__ v_con, const float* __restrict__ v_col,
                       const float* __restrict__ v_op, const float* __restrict__ v_dep,
                       const Strides st, float* __restrict__ g_means,
                       float* __restrict__ g_quats, float* __restrict__ g_scales,
                       float* __restrict__ g_op, float* __restrict__ g_col, long long n,
                       int width, int height, float eps2d, int flags, int d_rgb, int sh_k,
                       int sh_deg, int d_out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const bool rgb = flags & RGB;
  const int n_col = sh_k == 0 ? d_rgb : 3 * sh_k;  // colour gradient floats a row

  // the cotangents
  float gu = 0.0f, gv = 0.0f, gca = 0.0f, gcb = 0.0f, gcc = 0.0f, gopo = 0.0f, gtz = 0.0f;
  bool hot = false;
  if (v_m2d != nullptr) {
    gu = v_m2d[i * st.s[M2D]];
    gv = v_m2d[i * st.s[M2D] + st.s[M2D + 1]];
  }
  if (v_con != nullptr) {
    gca = v_con[i * st.s[CON]];
    gcb = v_con[i * st.s[CON] + st.s[CON + 1]];
    gcc = v_con[i * st.s[CON] + 2 * st.s[CON + 1]];
  }
  if (v_op != nullptr) gopo = v_op[i * st.s[OP]];
  if (v_dep != nullptr) gtz = v_dep[i * st.s[DEP]];
  float g_rgb[3] = {0.0f, 0.0f, 0.0f};  // SH colours' channel cotangents
  if (v_col != nullptr) {
    const float* vc = v_col + i * st.s[COL];
    if (flags & DEPTH) {
      const float gd = vc[(d_out - 1) * st.s[COL + 1]];
      hot = gd != 0.0f;
      gtz += gd;
    }
    if (rgb && sh_k != 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        g_rgb[c] = vc[c * st.s[COL + 1]];
        hot = hot || g_rgb[c] != 0.0f;
      }
    } else if (rgb) {
      for (int c = 0; c < d_rgb; ++c) hot = hot || vc[c * st.s[COL + 1]] != 0.0f;
    }
  }
  hot = hot || gu != 0.0f || gv != 0.0f || gca != 0.0f || gcb != 0.0f || gcc != 0.0f ||
        gopo != 0.0f || gtz != 0.0f;
  float* gm = g_means + 3 * i;
  float* gq = g_quats + 4 * i;
  float* gs = g_scales + 3 * i;
  float* gc = rgb ? g_col + i * n_col : nullptr;
  if (!hot) {
    for (int j = 0; j < 3; ++j) gm[j] = gs[j] = 0.0f;
    for (int j = 0; j < 4; ++j) gq[j] = 0.0f;
    if (flags & COMP) g_op[i] = 0.0f;
    if (gc != nullptr)
      for (int j = 0; j < n_col; ++j) gc[j] = 0.0f;
    return;
  }

  const Camera cam = load_camera(viewmat, K, width, height);
  const bool wxyz = flags & WXYZ;
  const Splat p = project_splat(cam, means + 3 * i, quats + 4 * i, scales + 3 * i, wxyz, eps2d);
  const float det = p.det, tz = p.tz;

  // conics (d11, -v01, d00) / det, and the compensation
  float g_d00 = gcc / det, g_d11 = gca / det, g_v01 = -gcb / det;
  float g_det = -(gca * p.d11 - gcb * p.v01 + gcc * p.d00) / (det * det);
  float g_v00 = 0.0f, g_v11 = 0.0f;
  if (flags & COMP) {
    const float det_orig = p.v00 * p.v11 - p.v01 * p.v01;
    const float ratio = det_orig / det;
    const float comp = sqrtf(fmaxf(ratio, 0.0f));
    const float op = __ldg(opac + i);
    g_op[i] = gopo * comp;
    const float g_ratio = ratio >= 0.0f ? gopo * op / (2.0f * comp) : 0.0f;
    const float g_do = g_ratio / det;
    g_det -= g_ratio * det_orig / (det * det);
    g_v00 = g_do * p.v11;
    g_v11 = g_do * p.v00;
    g_v01 -= 2.0f * g_do * p.v01;
  }
  const float g_detr = p.det_raw >= 1e-10f ? g_det : 0.0f;
  g_v00 += g_d00 + g_detr * p.d11;
  g_v11 += g_d11 + g_detr * p.d00;
  g_v01 -= 2.0f * g_detr * p.v01;

  // the 2D covariance J C J^T
  const float j00 = p.j00, j02 = p.j02, j11 = p.j11, j12 = p.j12;
  const float g_c00 = g_v00 * j00 * j00;
  const float g_c01 = g_v01 * j00 * j11;
  const float g_c02 = 2.0f * g_v00 * j00 * j02 + g_v01 * j00 * j12;
  const float g_c11 = g_v11 * j11 * j11;
  const float g_c12 = g_v01 * j02 * j11 + 2.0f * g_v11 * j11 * j12;
  const float g_c22 = g_v00 * j02 * j02 + g_v01 * j02 * j12 + g_v11 * j12 * j12;
  const float g_j00 = 2.0f * g_v00 * (j00 * p.c00 + j02 * p.c02) + g_v01 * (j11 * p.c01 + j12 * p.c02);
  const float g_j02 = 2.0f * g_v00 * (j00 * p.c02 + j02 * p.c22) + g_v01 * (j11 * p.c12 + j12 * p.c22);
  const float g_j11 = 2.0f * g_v11 * (j11 * p.c11 + j12 * p.c12) + g_v01 * (j00 * p.c01 + j02 * p.c12);
  const float g_j12 = 2.0f * g_v11 * (j11 * p.c12 + j12 * p.c22) + g_v01 * (j00 * p.c02 + j02 * p.c22);

  // the camera-frame mean: J, the clamp, means2d, the depth
  const float fx = cam.k[0][0], fy = cam.k[1][1], tz2 = tz * tz;
  gtz += -(g_j00 * j00 + g_j11 * j11 + 2.0f * (g_j02 * j02 + g_j12 * j12)) / tz +
         (gu * (cam.k[0][2] - p.u) + gv * (cam.k[1][2] - p.v)) / tz;
  const float g_txc = -g_j02 * fx / tz2, g_tyc = -g_j12 * fy / tz2;
  const float g_rx = g_txc * tz * clamp_weight(p.rx, -cam.lim_x_neg, cam.lim_x_pos);
  const float g_ry = g_tyc * tz * clamp_weight(p.ry, -cam.lim_y_neg, cam.lim_y_pos);
  gtz += g_txc * p.clx + g_tyc * p.cly - (g_rx * p.rx + g_ry * p.ry) / tz;
  const float g_t[3] = {g_rx / tz + (gu * cam.k[0][0] + gv * cam.k[1][0]) / tz,
                        g_ry / tz + (gu * cam.k[0][1] + gv * cam.k[1][1]) / tz, gtz};
  float g_mu[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    g_mu[a] = cam.w[0][a] * g_t[0] + cam.w[1][a] * g_t[1] + cam.w[2][a] * g_t[2];

  // the world covariance: gS = W^T sym(gC) W, g_M = 2 gS M
  const float Gs[3][3] = {{g_c00, 0.5f * g_c01, 0.5f * g_c02},
                          {0.5f * g_c01, g_c11, 0.5f * g_c12},
                          {0.5f * g_c02, 0.5f * g_c12, g_c22}};
  float GW[3][3], gS[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      GW[r][b] = Gs[r][0] * cam.w[0][b] + Gs[r][1] * cam.w[1][b] + Gs[r][2] * cam.w[2][b];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      gS[a][b] = cam.w[0][a] * GW[0][b] + cam.w[1][a] * GW[1][b] + cam.w[2][a] * GW[2][b];
  float g[3][3];  // d/d R
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float g_sj = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float gM = 2.0f * (gS[r][0] * p.r[0][j] * p.s[j] + gS[r][1] * p.r[1][j] * p.s[j] +
                               gS[r][2] * p.r[2][j] * p.s[j]);
      g_sj += gM * p.r[r][j];
      g[r][j] = gM * p.s[j];
    }
    gs[j] = g_sj;
  }
  const float x = p.x, y = p.y, z = p.z, w = p.w;
  const float gn[4] = {
      2.0f * (y * (g[0][1] + g[1][0]) + z * (g[0][2] + g[2][0]) + w * (g[2][1] - g[1][2]) -
              2.0f * x * (g[1][1] + g[2][2])),
      2.0f * (x * (g[0][1] + g[1][0]) + z * (g[1][2] + g[2][1]) + w * (g[0][2] - g[2][0]) -
              2.0f * y * (g[0][0] + g[2][2])),
      2.0f * (x * (g[0][2] + g[2][0]) + y * (g[1][2] + g[2][1]) + w * (g[1][0] - g[0][1]) -
              2.0f * z * (g[0][0] + g[1][1])),
      2.0f * (x * (g[2][1] - g[1][2]) + y * (g[0][2] - g[2][0]) + z * (g[1][0] - g[0][1]))};
  const float ndot = x * gn[0] + y * gn[1] + z * gn[2] + w * gn[3];
  const float gq_xyzw[4] = {(gn[0] - x * ndot) / p.qn, (gn[1] - y * ndot) / p.qn,
                            (gn[2] - z * ndot) / p.qn, (gn[3] - w * ndot) / p.qn};
#pragma unroll
  for (int j = 0; j < 4; ++j) gq[wxyz ? (j + 1) % 4 : j] = gq_xyzw[j];

  // the colours
  if (rgb) {
    if (sh_k == 0) {
      const float* vc = v_col + i * st.s[COL];
      for (int c = 0; c < d_rgb; ++c) gc[c] = v_col != nullptr ? vc[c * st.s[COL + 1]] : 0.0f;
    } else {
      Dir d = {};
      if (sh_deg > 0) d = view_dir(cam, means + 3 * i);
      const float* sh = colors + i * sh_k * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (!(add(eval_sh(sh_deg, sh + c, d.x, d.y, d.z), 0.5f) >= 0.0f)) g_rgb[c] = 0.0f;
      const int n_basis = (sh_deg + 1) * (sh_deg + 1);
      float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;
      for (int k = 0; k < sh_k; ++k) {
        if (k >= n_basis) {
          gc[3 * k] = gc[3 * k + 1] = gc[3 * k + 2] = 0.0f;
          continue;
        }
        float b, bx, by, bz;
        sh_term(k, d.x, d.y, d.z, b, bx, by, bz);
        float gk = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          gc[3 * k + c] = b * g_rgb[c];
          gk += g_rgb[c] * __ldg(sh + 3 * k + c);
        }
        gdx += gk * bx;
        gdy += gk * by;
        gdz += gk * bz;
      }
      if (sh_deg > 0) {
        // dir = d / max(|d|, 1e-8)
        const float nc = fmaxf(d.nrm, 1e-8f);
        const float dot = d.nrm >= 1e-8f ? (gdx * d.d[0] + gdy * d.d[1] + gdz * d.d[2]) /
                                               (nc * nc * d.nrm)
                                         : 0.0f;
        g_mu[0] += gdx / nc - dot * d.d[0];
        g_mu[1] += gdy / nc - dot * d.d[1];
        g_mu[2] += gdz / nc - dot * d.d[2];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) gm[a] = g_mu[a];
}

}  // namespace

// Inputs as project_fwd's; v_* the cotangents (null: zero), strides their
// (row, column) strides in elements for means2d, conics, the channels,
// the opacities and the depths, in that order (a host array of 10);
// outputs g_means (N, 3), g_quats (N, 4), g_scales (N, 3), g_op (N,) (null
// without COMP) and g_col shaped as colors (null without RGB).
extern "C" int project_bwd(const void* means, const void* quats, const void* scales,
                           const void* opac, const void* colors, const void* viewmat,
                           const void* K, const void* v_m2d, const void* v_con,
                           const void* v_col, const void* v_op, const void* v_dep,
                           const long long* strides, void* g_means, void* g_quats,
                           void* g_scales, void* g_op, void* g_col, long long n, int width,
                           int height, float eps2d, int flags, int d_rgb, int sh_k, int sh_deg,
                           int d_out, void* stream) {
  if (n < 0 || sh_deg < 0 || sh_deg > 4 || ((flags & proj::COMP) && g_op == nullptr) ||
      ((flags & proj::RGB) && g_col == nullptr))
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Strides st;
  for (int j = 0; j < 10; ++j) st.s[j] = strides[j];
  const int threads = 256;
  project_bwd_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(quats),
      static_cast<const float*>(scales), static_cast<const float*>(opac),
      static_cast<const float*>(colors), static_cast<const float*>(viewmat),
      static_cast<const float*>(K), static_cast<const float*>(v_m2d),
      static_cast<const float*>(v_con), static_cast<const float*>(v_col),
      static_cast<const float*>(v_op), static_cast<const float*>(v_dep), st,
      static_cast<float*>(g_means), static_cast<float*>(g_quats),
      static_cast<float*>(g_scales), static_cast<float*>(g_op), static_cast<float*>(g_col), n,
      width, height, eps2d, flags, d_rgb, sh_k, sh_deg, d_out);
  return int(cudaGetLastError());
}
