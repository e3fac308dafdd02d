// Kernel K1: exact non-causal softmax attention, forward, for sm_90a.
//
// Replaces (TPU, Pallas):
//   hunyuanworld_mirror_tpu/ops/attn_onepass.py:_kernel  (N <= 4095: encoder,
//     frame layers, camera head, global layers at S <= 2), and
//   the JAX library's Pallas flash kernel reached from
//     hunyuanworld_mirror_tpu/models/block.py:_flash_core (N >= 4096).
// Both compute o = softmax(q k^T * scale) v with f32 logits and an f32 row
// softmax; the flash route's padding with segment ids becomes a key < N mask.
//
// What bounds it on this card: operations. 4*N^2*D flops per (batch, head)
// against (q + k + v + o) bytes gives hundreds of flops per byte at N ~ 1.4k,
// far above the H100's ~295 bf16 flops/byte ridge, so the tensor cores are
// the limit. The TPU kernel held a whole K/V row in ~16 MB of VMEM; a Hopper
// block has at most 227 KB of shared memory, so this kernel streams 64-key
// K/V tiles through shared memory with an online softmax (running max and
// sum in f32) and never writes the (N, N) logits to device memory.
//
// Design (bf16, D in {64, 128}), the FlashAttention-2 shape on mma.sync:
// one block of 4 warps per (batch*head, 64-query tile); each warp owns 16
// query rows, whose Q fragments stay in registers. K/V tiles of 64 keys are
// double-buffered in shared memory with cp.async (zero-filled past N).
// Per tile, each warp:
//   S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 accumulate), kept in
//     registers; scaled, masked (key >= N -> -inf);
//   the row max and sum update in f32 (a row lives in one lane quad);
//   P = exp(S - m) is rounded to bf16 straight from the S accumulators into
//     A fragments (the TPU kernel also rounds P to the input dtype before
//     the PV product) and O += P V with V fragments from ldmatrix.trans;
//   O stays in f32 registers, rescaled by exp(m_old - m_new).
// wgmma, TMA and warp specialization are later work.
//
// f32 inputs (the camera head: N = S views, D = 128) take a scalar kernel:
// one warp per query row, an f32 dot per key reduced by shuffles, the same
// online softmax, f32 P.
//
// C interface: attention_fwd(...) returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per K/V tile
constexpr int WARPS = 4;     // 16 query rows per warp
constexpr int THREADS = WARPS * 32;

struct Strides {
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + rows) of a (N, D) bf16 slice -> a (rows, D + 8) tile
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride_n, int row0, int n_valid) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < BK * VPR; idx += THREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    const int n = row0 + r;
    const bool valid = n < n_valid;
    cp_async16(dst + r * LD + c, src + (valid ? n : 0) * stride_n + c, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int N, int H, Strides st, float scale) {
  constexpr int LD = D + 8;            // padded row: conflict-free fragment reads
  constexpr int TILE = BK * LD;        // elements per K or V tile (BQ == BK)
  constexpr int NT = D / 8;            // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // stage s: K at smem + 2*s*TILE, V at smem + (2*s + 1)*TILE

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // fragment row group / thread in group

  const __nv_bfloat16* qb = q + b * st.q_sb + h * st.q_sh;
  const __nv_bfloat16* kb = k + b * st.k_sb + h * st.k_sh;
  const __nv_bfloat16* vb = v + b * st.v_sb + h * st.v_sh;
  const int n_tiles = (N + BK - 1) / BK;

  // Q staged through stage 1's K buffer; tile 0 into stage 0
  load_tile_async<D>(smem + 2 * TILE, qb, st.q_sn, q0, N);
  load_tile_async<D>(smem, kb, st.k_sn, 0, N);
  load_tile_async<D>(smem + TILE, vb, st.v_sn, 0, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* sq = smem + 2 * TILE + (warp * 16) * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(sq + g * LD + kk * 16 + 2 * t);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(sq + (g + 8) * LD + kk * 16 + 2 * t);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(sq + g * LD + kk * 16 + 8 + 2 * t);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(sq + (g + 8) * LD + kk * 16 + 8 + 2 * t);
    }
  }
  __syncthreads();  // stage 1 is free for the prefetch below

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;   // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;               // this lane's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + 2 * (cur ^ 1) * TILE;
      load_tile_async<D>(nxt, kb, st.k_sn, (it + 1) * BK, N);
      load_tile_async<D>(nxt + TILE, vb, st.v_sn, (it + 1) * BK, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sK = smem + 2 * cur * TILE;
    const __nv_bfloat16* sV = sK + TILE;
    const int k0 = it * BK;

    // S (16 x 64) = Q_w K^T
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = sK + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
      }
    }

    // scale, mask, online softmax (f32); a row's 64 values live in one quad
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      s[j][0] = key < N ? s[j][0] * scale : -INFINITY;
      s[j][1] = key + 1 < N ? s[j][1] * scale : -INFINITY;
      s[j][2] = key < N ? s[j][2] * scale : -INFINITY;
      s[j][3] = key + 1 < N ? s[j][3] * scale : -INFINITY;
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // finite: key k0 is always < N
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn_lo);
      s[j][1] = expf(s[j][1] - mn_lo);
      s[j][2] = expf(s[j][2] - mn_hi);
      s[j][3] = expf(s[j][3] - mn_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr_lo;
      acc[n][1] *= corr_lo;
      acc[n][2] *= corr_hi;
      acc[n][3] *= corr_hi;
    }

    // O (16 x D) += P (16 x 64, bf16) V (64 x D)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // matrix mi = lane / 8: keys kk*16 + (mi & 1)*8 + lane % 8, cols + (mi >> 1)*8
      const int mi = lane >> 3;
      const __nv_bfloat16* vrow =
          sV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(smem_addr(vrow + n * 8)));
        mma_bf16(acc[n], pa, b0, b1);
        mma_bf16(acc[n + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with stage `cur` before it refills
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int n_lo = q0 + warp * 16 + g, n_hi = n_lo + 8;
  __nv_bfloat16* o_lo = o + ((static_cast<long long>(b) * N + n_lo) * H + h) * D + 2 * t;
  __nv_bfloat16* o_hi = o + ((static_cast<long long>(b) * N + n_hi) * H + h) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n_lo < N)
      *reinterpret_cast<uint32_t*>(o_lo + n * 8) =
          pack_bf16(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    if (n_hi < N)
      *reinterpret_cast<uint32_t*>(o_hi + n * 8) =
          pack_bf16(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                int N, int H, Strides st, float scale) {
  constexpr int PER = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + warp;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  if (n >= N) return;  // no block-wide barrier below

  const float* qrow = q + b * st.q_sb + n * st.q_sn + h * st.q_sh;
  const float* kb = k + b * st.k_sb + h * st.k_sh;
  const float* vb = v + b * st.v_sb + h * st.v_sh;
  float qr[PER], acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qr[i] = qrow[lane + 32 * i];
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < N; ++j) {
    const float* krow = kb + j * st.k_sn;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) s += qr[i] * krow[lane + 32 * i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    s *= scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    const float* vrow = vb + j * st.v_sn;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = acc[i] * corr + p * vrow[lane + 32 * i];
    m = m_new;
  }
  float* orow = o + ((static_cast<long long>(b) * N + n) * H + h) * D;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < PER; ++i) orow[lane + 32 * i] = acc[i] * inv;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                        int N, int H, const Strides& st, float scale, cudaStream_t s) {
  const size_t smem = size_t(4) * BK * (D + 8) * sizeof(__nv_bfloat16);  // 2 stages x K, V
  cudaError_t err = cudaFuncSetAttribute(
      attn_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  attn_bf16_kernel<D><<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N, H, st,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                       int N, int H, const Strides& st, float scale, cudaStream_t s) {
  dim3 grid((N + WARPS - 1) / WARPS, B * H);
  attn_f32_kernel<D><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), N, H, st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* o,
                             int B, int N, int H, int D,
                             long long q_sb, long long q_sn, long long q_sh,
                             long long k_sb, long long k_sn, long long k_sh,
                             long long v_sb, long long v_sn, long long v_sh,
                             float scale, int is_bf16, void* stream) {
  const Strides st{q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H > 65535 || N < 1) return int(cudaErrorInvalidValue);
  cudaError_t err;
  if (is_bf16) {
    if (D == 64) err = launch_bf16<64>(q, k, v, o, B, N, H, st, scale, s);
    else if (D == 128) err = launch_bf16<128>(q, k, v, o, B, N, H, st, scale, s);
    else return int(cudaErrorInvalidValue);
  } else {
    if (D == 64) err = launch_f32<64>(q, k, v, o, B, N, H, st, scale, s);
    else if (D == 128) err = launch_f32<128>(q, k, v, o, B, N, H, st, scale, s);
    else return int(cudaErrorInvalidValue);
  }
  return int(err);
}
