// Kernel K8: the trunk's q/k normalisation, for sm_90a. Each attention's
// q/k LayerNorm and 2D RoPE is one launch (qk_norm_rope).
//
// Replaces: no TPU kernel. The JAX package writes the stage as plain jnp
// code (models/nn.py layer_norm, models/rope.py apply_rope2d, called from
// models/block.py), which XLA fuses on the TPU. In the port it is plain
// PyTorch (ops/trunk_norm.py layer_norm_plain and apply_rope2d), one
// kernel an operation: the two q/k LayerNorms take 5 launches each (the
// affine's two casts to f32, a strided copy of the view to f32,
// F.layer_norm in f32 and the cast back), and a RoPE of one tensor ~19
// (the four table casts, four products, a subtraction, an addition and
// three cats over strided quarter views). (A LayerNorm of a whole bf16
// activation needs no kernel here: ops/trunk_norm.layer_norm hands it to
// PyTorch's own bf16 LayerNorm, one launch, bit for bit the cast chain.)
//
// One C entry (ops/trunk_norm.py), qk_norm_rope: q and k, (B, N, H, D)
// views of the fused qkv projection (head dim contiguous, the other
// strides free), D = 64 (the trunk's, CenterSnap's and DINOv3's heads) or
// 16 (the tiny presets'). LPR = D / E lanes a (b, n, h) row, E = 8 values
// a lane (4 at D = 16), each lane doing its columns of both q and k, so it
// loads its table values once. Optionally each one's LayerNorm over D:
// mean and variance in f32 in two passes over the registers (JAX's
// formula: the mean, then the mean of the squared deviations), each a
// butterfly over the row's lanes, the f32 affine (parameters f32 or bf16),
// rounded to bf16 as the plain LayerNorm's output is. Optionally the 2D
// RoPE: the head dim's y half and x half each rotate their quarter pairs
// (a, b), the partner quarter one __shfl_xor away (LPR / 4 lanes), by the
// f32 tables (N, D / 2) as given, per frame or tiled along N for the
// global layers, rounded to bf16 in registers. q' and k' are written
// contiguous (B, N, H, D), which K1 takes as they are.
//
// Numerics. The RoPE is the plain code's bits: PyTorch computes each bf16
// operation in f32 and rounds it to bf16, so a c - b s is bf16(bf16(a c) -
// bf16(b s)) and b c + a s is bf16(bf16(b c) + bf16(a s)), written here
// with the round-to-nearest intrinsics (no contraction into FMAs). The
// LayerNorm sums in another order than PyTorch's Welford kernel and so
// agrees with it to f32 rounding: a bf16 output moves by at most one ulp
// at the scale of the affine's terms, in ~0.002% of the elements (more
// ulps of the output itself only where the bias cancels it to near 0).
//
// What bounds it on this card: bytes. It reads q and k and writes q' and
// k' (8 bytes a (token, head, column)); the affine and the tables are a few
// KB, held in L1 / L2. At S = 32 a trunk block's is ~0.36 GB, ~0.11 ms at
// 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// qk_norm_rope's flags
constexpr int QK_NORM = 1, QK_ROPE = 2, QK_PARAM_BF16 = 4;

// E consecutive bf16 values (E = 4 or 8) move as one 8- or 16-byte access
template <int E> struct Chunk;
template <> struct Chunk<4> { using T = uint2; };
template <> struct Chunk<8> { using T = uint4; };

template <int E>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&f)[E]) {
  const typename Chunk<E>::T u = *reinterpret_cast<const typename Chunk<E>::T*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int E>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float (&f)[E]) {
  typename Chunk<E>::T u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<typename Chunk<E>::T*>(p) = u;
}

// E f32 values from a 16-byte aligned address
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[4 * i] = t.x;
    f[4 * i + 1] = t.y;
    f[4 * i + 2] = t.z;
    f[4 * i + 3] = t.w;
  }
}

// E affine parameters from index i, stored f32 or bf16 (exact in f32)
template <int E>
__device__ __forceinline__ void load_param(const void* p, int i, bool bf16, float (&f)[E]) {
  if (bf16)
    load_bf16<E>(static_cast<const __nv_bfloat16*>(p) + i, f);
  else
    load_f32<E>(static_cast<const float*>(p) + i, f);
}

// x rounded to bf16 (round to nearest even, as PyTorch's casts), in f32
__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// the sum over the LPR lanes of a row (aligned groups of one warp)
template <int LPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A row's LPR E values, E a lane, normalised in place: (x - mean) /
// sqrt(var + eps) with f32 mean and variance. Every lane of the warp calls
// it (the butterflies take the full warp).
template <int LPR, int E>
__device__ __forceinline__ void normalise(float (&v)[E], float eps) {
  constexpr float C = LPR * E;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += v[e];
  const float mean = row_sum<LPR>(s) / C;
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float d = v[e] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(row_sum<LPR>(q) / C + eps);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = (v[e] - mean) * rstd;
}

// the affine y = x w + b on E columns from `col` (w or b null: left out)
template <int E>
__device__ __forceinline__ void affine(float (&v)[E], const void* w, const void* b, int col,
                                       bool bf16) {
  if (w != nullptr) {
    float g[E];
    load_param<E>(w, col, bf16, g);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] *= g[e];
  }
  if (b != nullptr) {
    float h[E];
    load_param<E>(b, col, bf16, h);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] += h[e];
  }
}

struct QK {
  const __nv_bfloat16* src[2];  // q, k
  __nv_bfloat16* dst[2];        // q', k': contiguous (B, N, H, D)
  long long sb[2], sn[2], sh[2];  // q's and k's batch, token and head strides
  const void* w[2];             // q_norm's and k_norm's weight and bias (null: none)
  const void* b[2];
  const float* cy;              // the RoPE tables (N, D / 2): cos and sin, y and x
  const float* sy;
  const float* cx;
  const float* sx;
  long long ts;                 // their row stride
  unsigned rows, N, H;          // B N H (b, n, h) rows
  int flags;
  float eps;
};

template <int E, int LPR>
__global__ void __launch_bounds__(kThreads) qk_norm_rope_kernel(const QK a) {
  constexpr int D = E * LPR;
  constexpr int Q = LPR / 4;    // lanes a quarter of the head dim
  // rows * LPR < 2^31 (the C entry's check): 32-bit index arithmetic
  const unsigned row = (blockIdx.x * kThreads + threadIdx.x) / LPR;
  const int lane = threadIdx.x % LPR;
  const bool live = row < a.rows;
  const unsigned h = row % a.H, bn = row / a.H, n = bn % a.N, bi = bn / a.N;
  const int col = lane * E;
  const bool norm = a.flags & QK_NORM, rope = a.flags & QK_ROPE;
  const bool pbf16 = a.flags & QK_PARAM_BF16;
  // q's and k's values first, both loads in flight
  float v[2][E];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (live) {
      load_bf16<E>(a.src[t] + bi * a.sb[t] + n * a.sn[t] + h * a.sh[t] + col, v[t]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[t][e] = 0.f;
    }
  }
  // the lane's rotation: its half's tables at its columns within the quarter
  float c[E], s[E];
  if (rope) {
    if (live) {
      const long long off = n * a.ts + (lane % Q) * E;
      load_f32<E>((lane < 2 * Q ? a.cy : a.cx) + off, c);
      load_f32<E>((lane < 2 * Q ? a.sy : a.sx) + off, s);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) c[e] = s[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      c[e] = rbf(c[e]);
      s[e] = rbf(s[e]);
    }
  }
  // the first quarter of a half holds a, the second b
  const bool first = lane % (2 * Q) < Q;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (norm) {
      normalise<LPR, E>(v[t], a.eps);
      affine<E>(v[t], a.w[t], a.b[t], col, pbf16);
#pragma unroll
      for (int e = 0; e < E; ++e) v[t][e] = rbf(v[t][e]);
    }
    if (rope) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float p = __shfl_xor_sync(kFull, v[t][e], Q);
        const float own = rbf(__fmul_rn(v[t][e], c[e])), other = rbf(__fmul_rn(p, s[e]));
        // a: a c - b s; b: b c + a s
        v[t][e] = rbf(first ? __fsub_rn(own, other) : __fadd_rn(own, other));
      }
    }
    if (live) store_bf16<E>(a.dst[t] + static_cast<long long>(row) * D + col, v[t]);
  }
}

unsigned blocks_for(long long threads) {
  const long long n = (threads + kThreads - 1) / kThreads;
  return n > 0x7FFFFFFFLL ? 0u : static_cast<unsigned>(n);
}

template <int E, int LPR>
int launch_qk(const QK& a, cudaStream_t s) {
  if (static_cast<long long>(a.rows) * LPR > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(static_cast<long long>(a.rows) * LPR);
  qk_norm_rope_kernel<E, LPR><<<blocks, kThreads, 0, s>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// q, k: (B, N, H, D) bf16, D = 64 or 16, with the head dim contiguous and
// (batch, token, head) strides qs* / ks* (elements; multiples of 8, 4 at
// D = 16, and the bases as aligned); qo, ko: (B, N, H, D) bf16 contiguous; qw, qb, kw, kb:
// the norms' (D,) affine, f32 or bf16 (flags & 4), null for none; cy, sy,
// cx, sx: the RoPE's f32 (N, D / 2) tables at row stride ts (a multiple of
// 4, 16-byte aligned bases); flags & 1 the norm, flags & 2 the RoPE.
extern "C" int qk_norm_rope(const void* q, const void* k, void* qo, void* ko, long long B,
                            long long N, long long H, int D, long long qsb, long long qsn,
                            long long qsh, long long ksb, long long ksn, long long ksh,
                            const void* qw, const void* qb, const void* kw, const void* kb,
                            const void* cy, const void* sy, const void* cx, const void* sx,
                            long long ts, int flags, float eps, void* stream) {
  if (B < 0 || N < 0 || H < 0 || !(flags & (QK_NORM | QK_ROPE)) ||
      ((flags & QK_ROPE) && (ts < D / 2 || ts % 4)) || B * N * H > 0x7FFFFFFFLL)
    return int(cudaErrorInvalidValue);
  if (B * N * H == 0) return 0;
  const QK a{{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k)},
             {static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko)},
             {qsb, ksb}, {qsn, ksn}, {qsh, ksh}, {qw, kw}, {qb, kb},
             static_cast<const float*>(cy), static_cast<const float*>(sy),
             static_cast<const float*>(cx), static_cast<const float*>(sx),
             ts, static_cast<unsigned>(B * N * H), static_cast<unsigned>(N),
             static_cast<unsigned>(H), flags, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_qk<4, 4>(a, s);
    case 64: return launch_qk<8, 8>(a, s);
    default: return int(cudaErrorInvalidValue);
  }
}
