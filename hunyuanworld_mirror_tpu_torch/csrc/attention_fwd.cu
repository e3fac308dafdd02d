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
// the limit, and beside them the exponentials: one ex2 per logit on the
// SFU (16 a clock per SM) costs about as many cycles as the two products of
// a 64-wide head on the tensor cores. The TPU kernel held a whole K/V row in
// ~16 MB of VMEM; a Hopper block has at most 227 KB of shared memory, so
// this kernel streams K/V tiles through shared memory with an online
// softmax (running max and sum in f32) and never writes the (N, N) logits
// to device memory.
//
// Design (bf16, D in {64, 128}), FlashAttention-3's shape. A persistent
// grid, one block per SM, walks the work items (batch*head, 192-query
// tile); a block is four warpgroups:
//   warpgroup 0, the producer, gives up its registers (setmaxnreg.dec) and
//     one thread issues TMA loads: an item's Q, then its K and V tiles (128
//     keys at D = 64, 64 at D = 128) into a ring of STAGES shared-memory
//     stages, each with a full and an empty mbarrier for K and for V; it
//     runs ahead into the next item while the consumers finish one. The
//     tensor maps are 4-D over (D, H, N, B) with the tensors' own strides,
//     so strided q/k/v views go in without a copy, and a box past N reads
//     TMA's zero fill, never the next batch. A 128-byte swizzle (64 bf16
//     columns a box; D = 128 loads two boxes) is what wgmma reads.
//   warpgroups 1-3, the consumers (setmaxnreg.inc), own 64 query rows
//     each. Per K/V tile i: S_i = Q K_i^T as wgmma m64nBKk16 with both
//     operands in shared memory (K-major), issued together with
//     O += P_{i-1} V_{i-1}, so that the online softmax of S_i (f32, in
//     registers; one FFMA and one ex2 a logit, the scale folded into the
//     exponent's log2 units) runs while the PV product holds the tensor
//     cores. P is rounded to bf16 straight from the S accumulators (the TPU
//     kernel also rounds P to the input dtype before the PV product) and is
//     the register A operand of wgmma m64nDk16, with V read MN-major from
//     shared memory. Keys >= N are masked on the last tile only.
//   The consumers take turns, round robin, to issue their products
//     (FlashAttention-3's ping-pong), so that one's softmax overlaps the
//     others' products on the tensor cores.
//   Epilogue: O / l, rounded to bf16, stored for rows < N.
//
// f32 inputs (K1c: the camera head, whose tokens models/camera_head.py
// casts to f32; N = S views, D = 128, a few to tens of views) take a
// kernel of their own, f32 FFMA throughout (TF32 or bf16 products would
// change the reference's precision), exact softmax with f32 P. What bounds
// it: nothing on the card. At the camera head's (1, 4, 16, 128) the work
// is ~128 KB and ~0.13 MFLOP, ~4e-5 ms at the card's rates, far below one
// launch; at N = 32, 16 heads, ~2 MFLOP. So the design is for latency, in
// two kernels. Up to N = 16 (the camera head's views), no shared memory and
// no barrier: one warp a query row, each lane loading its D / 32 columns of
// q and of every key's K and V row into registers in one round, the N dots
// reduced across the warp together (independent shuffles), then an exact
// softmax and O = P V. Past N = 16, a block of 4 warps takes 16 query rows
// (N <= 64) or 64 (past that) of one (batch, head); Q and every K/V tile of
// 32 keys go to shared memory in one round of cp.async (16-byte copies when
// the addresses allow), so a block waits for device memory once; each lane
// scores one key against its warp's rows (K read once a warp, Q broadcast),
// an online softmax with one warp max a row, then O += P V with each lane
// owning D / 32 columns. Past N = 96 (3 tiles, ~100 KB of K/V at D = 128)
// the tiles stream through a two-stage ring under the same online softmax.
//
// C interface: attention_fwd(q, k, v, o, dims, scale, stream) reads the
// shapes, strides and dtype from `dims` (14 values, so that the host passes
// 7 arguments), builds the bf16 route's tensor maps from the pointers and
// strides (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the
// library needs no -lcuda) and returns a cudaError_t after launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CONSUMER_WGS = 3;  // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * CONSUMER_WGS;
constexpr int STAGES = 2;       // K/V ring depth
constexpr int CHUNK = 64;       // bf16 columns per 128-byte swizzled box
constexpr int ROW_BYTES = 128;  // one box row in shared memory
constexpr int WG = 128;         // threads per warpgroup
constexpr int THREADS = (1 + CONSUMER_WGS) * WG;
constexpr int CONSUMERS = CONSUMER_WGS * WG;
// registers a thread after setmaxnreg: of the SM's 64K the producer keeps a
// few and the consumers take the rest (S 64 + O 32 + P 32 at D = 64)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
static_assert(PRODUCER_REGS * WG + CONSUMER_REGS * CONSUMERS <= 65536, "register file");
constexpr int BAR_TURN = 1;     // ping-pong: named barriers 1.. (0 is __syncthreads)
constexpr float LOG2E = 1.4426950408889634f;

// keys per K/V tile: 128 at D = 64; 64 at D = 128, where S, P and O of a
// 128-key tile would not fit in a consumer's registers
template <int D>
constexpr int key_tile() { return D == 64 ? 128 : 64; }

// f32 kernels (K1c): warps a block, the most keys the register kernel
// takes, keys a tile (one a lane), the most key tiles kept resident
// (N <= 96 staged whole), the ring's depth past that
constexpr int F32_WARPS = 4;
constexpr int F32_REG_N = 16;
constexpr int F32_THREADS = F32_WARPS * 32;
constexpr int F32_BK = 32;
constexpr int F32_RESIDENT = 3;
constexpr int F32_RING = 2;

struct Strides {
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
};

// shared memory, from a 1024-byte aligned base: Q | K stages | V stages | barriers
template <int D>
struct Smem {
  static constexpr int BK = key_tile<D>();
  static constexpr int NC = D / CHUNK;                 // boxes per row
  static constexpr int Q_BYTES = NC * BQ * ROW_BYTES;
  static constexpr int KV_BYTES = NC * BK * ROW_BYTES;  // one K or V stage
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // full_q, empty_q, full_k[S], full_v[S], empty_k[S], empty_v[S]
  static constexpr int BYTES = BAR_OFF + (2 + 4 * STAGES) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers, TMA, named barriers -------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// true once the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// box {64, 1, rows, 1} at (d0, h, n0, b) of a (D, H, N, B) map -> shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int n0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(n0), "r"(b),
         "r"(bar)
      : "memory");
}

// Ping-pong: the consumers take turns, round robin on named barriers 1..3,
// to issue their products, so that one's softmax runs while another's
// products hold the tensor cores; ~3% faster at the main path's shapes
// than leaving the order to the warp schedulers (false here; PERF.md section 6,
// timed by tools/k1_ab.py).
constexpr bool PINGPONG = true;
// consumer c waits for its turn / hands the turn to consumer c + 1 (round
// robin); each barrier joins two warpgroups
__device__ __forceinline__ void take_turn(int c) {
  if (PINGPONG)
    asm volatile("bar.sync %0, %1;\n" :: "r"(BAR_TURN + c), "n"(2 * WG) : "memory");
}
__device__ __forceinline__ void pass_turn(int c) {
  if (PINGPONG)
    asm volatile("bar.arrive %0, %1;\n"
                 :: "r"(BAR_TURN + (c + 1) % CONSUMER_WGS), "n"(2 * WG) : "memory");
}

// --- wgmma ------------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle; SBO = 1024 B (8 rows of 128 B)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo_bytes >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous window (the asm statements stay in order)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3]) :: "memory");
}

#define ACC8(b)                                                                       \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),   \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define REGS32                                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define REGS64                                                                        \
  REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "   \
         "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
         "%61, %62, %63"

// d (64 x 64, f32) (+)= A (64 x 16, K-major smem) * B (16 x 64, K-major smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32 "}, %32, %33, "
      "p, 1, 1, 0, 0;\n}\n"
      : ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 16, K-major smem) * B (16 x 128, K-major smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64 "}, %64, %65, "
      "p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8
#undef ACC32
#undef ACC64
#undef REGS32
#undef REGS64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the bf16 kernel ----------------------------------------------------------------

// accumulator layout of wgmma m64nN (per thread, warp w of the warpgroup,
// lane = 4 g + t): d[4j + e] is row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)

// S (64 x BK) = Q_rows K^T: D / 16 k-steps; a 128-byte row holds 64 columns,
// so D = 128 steps into the second box after 4
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(q_rows + (kk / 4) * BQ * ROW_BYTES + col, 16),
             sw128_desc(k_tile + (kk / 4) * BK * ROW_BYTES + col, 16), kk > 0);
  }
}

// O (64 x D) += P (64 x BK, registers) V (BK x D): BK / 16 k-steps of 16 keys
// (2048 bytes); the D / 64 boxes of a row lie BK rows apart (the LBO)
template <int BK, int ND>
__device__ __forceinline__ void issue_pv(float (&o)[ND], const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p[kk], sw128_desc(v_tile + kk * 16 * ROW_BYTES, BK * ROW_BYTES));
}

// P (bf16) as the A fragments of the PV product: k-slice kk is accumulator
// columns 16 kk .. 16 kk + 15 (the TPU kernel also rounds P to the input
// dtype before its PV product)
template <int BK>
__device__ __forceinline__ void to_bf16(uint32_t (&p)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// the online softmax state of a thread's two rows (g and g + 8): the row
// max m of the raw products q.k, and this thread's share of the row sum l
struct Rows {
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;

  // S -> P = 2^((S - m) scale_log2) in place, one FFMA and one ex2 a logit
  // (scale_log2 > 0, so the max commutes with the scaling); keys >= N are
  // masked on the last tile only. Returns the factors that rescale O to the
  // new row max.
  template <int BK>
  __device__ __forceinline__ float2 update(float (&s)[BK / 2], float scale_log2, int k0,
                                           int N, int t) {
    if (k0 + BK > N) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        if (key >= N) s[4 * j] = s[4 * j + 2] = -INFINITY;
        if (key + 1 >= N) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // a row lives in one lane quad
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // finite: key k0 < N on every tile; 2^-inf = 0 on the first
    const float2 corr = make_float2(ex2((m_lo - mx_lo) * scale_log2),
                                    ex2((m_hi - mx_hi) * scale_log2));
    m_lo = mx_lo;
    m_hi = mx_hi;
    const float ms_lo = mx_lo * scale_log2, ms_hi = mx_hi * scale_log2;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -ms_lo));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -ms_lo));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -ms_hi));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -ms_hi));
      sum_lo += s[4 * j] + s[4 * j + 1];
      sum_hi += s[4 * j + 2] + s[4 * j + 3];
    }
    l_lo = l_lo * corr.x + sum_lo;
    l_hi = l_hi * corr.y + sum_hi;
    return corr;
  }
};

// a ring position: stage and the parity of its current round
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Persistent: gridDim.x blocks walk the (batch*head, query tile) work items
// in order, item = blockIdx.x + k gridDim.x, so the producer loads the next
// item's Q and first K/V tiles while the consumers finish the last one.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                 int N, int H, int items, float scale_log2) {
  using L = Smem<D>;
  constexpr int NC = L::NC, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t full_q = base + L::BAR_OFF, empty_q = full_q + 8;
  const uint32_t full_k = empty_q + 8, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * STAGES;

  const int wg = threadIdx.x / WG;
  const int q_tiles = (N + BQ - 1) / BQ;
  const int n_tiles = (N + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, CONSUMERS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS);
      mbar_init(empty_v + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {
      Ring r;
      uint32_t q_phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int bh = item / q_tiles, q0 = (item % q_tiles) * BQ;
        const int b = bh / H, h = bh % H;
        mbar_wait(empty_q, q_phase ^ 1);   // round 0 passes at once
        q_phase ^= 1;
        mbar_expect_tx(full_q, BQ * D * 2);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sQ + c * BQ * ROW_BYTES, &tm_q, full_q, c * CHUNK, h, q0, b);
        for (int i = 0; i < n_tiles; ++i, r.next()) {
          const uint32_t k_dst = sK + r.stage * L::KV_BYTES, v_dst = sV + r.stage * L::KV_BYTES;
          mbar_wait(empty_k + 8 * r.stage, r.phase ^ 1);
          mbar_expect_tx(full_k + 8 * r.stage, BK * D * 2);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load(k_dst + c * BK * ROW_BYTES, &tm_k, full_k + 8 * r.stage, c * CHUNK, h,
                     i * BK, b);
          mbar_wait(empty_v + 8 * r.stage, r.phase ^ 1);
          mbar_expect_tx(full_v + 8 * r.stage, BK * D * 2);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load(v_dst + c * BK * ROW_BYTES, &tm_v, full_v + 8 * r.stage, c * CHUNK, h,
                     i * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_rows = sQ + c * 64 * ROW_BYTES;
    Ring kr, vr;                                // V runs one tile behind K
    uint32_t q_phase = 0;

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      float o_acc[D / 2];
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
      Rows rows;

      if (c == CONSUMER_WGS - 1) pass_turn(c);  // consumer 0 takes the first turn
      mbar_wait(full_q, q_phase);
      q_phase ^= 1;

      // tile 0: S only
      {
        float s_acc[BK / 2];
        mbar_wait(full_k + 8 * kr.stage, kr.phase);
        take_turn(c);
        wgmma_fence();
        issue_qk<D, BK>(s_acc, q_rows, sK + kr.stage * L::KV_BYTES);
        wgmma_commit();
        pass_turn(c);
        wgmma_wait<0>();
        fence_regs(s_acc);
        mbar_arrive(empty_k + 8 * kr.stage);
        kr.next();
        if (n_tiles == 1) mbar_arrive(empty_q);
        rows.update<BK>(s_acc, scale_log2, 0, N, t);
        to_bf16<BK>(p, s_acc);
      }
      // tile i: S_i, then P_{i-1} V_{i-1}; the softmax of S_i overlaps the second
      for (int i = 1; i < n_tiles; ++i) {
        float s_acc[BK / 2];                    // no value carried over: scale-d 0 first
        mbar_wait(full_k + 8 * kr.stage, kr.phase);
        mbar_wait(full_v + 8 * vr.stage, vr.phase);
        take_turn(c);
        wgmma_fence();
        issue_qk<D, BK>(s_acc, q_rows, sK + kr.stage * L::KV_BYTES);
        wgmma_commit();
        issue_pv<BK>(o_acc, p, sV + vr.stage * L::KV_BYTES);
        wgmma_commit();
        pass_turn(c);

        wgmma_wait<1>();
        fence_regs(s_acc);
        mbar_arrive(empty_k + 8 * kr.stage);
        kr.next();
        if (i == n_tiles - 1) mbar_arrive(empty_q);   // Q is free for the next item
        const float2 corr = rows.update<BK>(s_acc, scale_log2, i * BK, N, t);

        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(p);                          // P_{i-1} stays live until its product is done
        mbar_arrive(empty_v + 8 * vr.stage);
        vr.next();
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o_acc[4 * j] *= corr.x;
          o_acc[4 * j + 1] *= corr.x;
          o_acc[4 * j + 2] *= corr.y;
          o_acc[4 * j + 3] *= corr.y;
        }
        to_bf16<BK>(p, s_acc);
      }
      // the last tile's PV product; the last consumer hands no turn back
      mbar_wait(full_v + 8 * vr.stage, vr.phase);
      take_turn(c);
      wgmma_fence();
      issue_pv<BK>(o_acc, p, sV + vr.stage * L::KV_BYTES);
      wgmma_commit();
      if (c != CONSUMER_WGS - 1) pass_turn(c);
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(p);
      mbar_arrive(empty_v + 8 * vr.stage);
      vr.next();

      // O / l, rows < N
      float l_lo = rows.l_lo, l_hi = rows.l_hi;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
      const int bh = item / q_tiles;
      const int b = bh / H, h = bh % H;
      const int n_lo = (item % q_tiles) * BQ + c * 64 + warp * 16 + g, n_hi = n_lo + 8;
      __nv_bfloat16* o_lo = o + ((static_cast<long long>(b) * N + n_lo) * H + h) * D + 2 * t;
      __nv_bfloat16* o_hi = o + ((static_cast<long long>(b) * N + n_hi) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (n_lo < N)
          *reinterpret_cast<uint32_t*>(o_lo + 8 * j) =
              pack_bf16(o_acc[4 * j] * inv_lo, o_acc[4 * j + 1] * inv_lo);
        if (n_hi < N)
          *reinterpret_cast<uint32_t*>(o_hi + 8 * j) =
              pack_bf16(o_acc[4 * j + 2] * inv_hi, o_acc[4 * j + 3] * inv_hi);
      }
    }
  }
}

// --- the f32 kernels (K1c) -----------------------------------------------------------

// N <= NK keys (NK <= F32_REG_N): one warp a query row, F32_WARPS rows a
// block. Lane l holds columns l + 32 c of the row's q and of every key's K
// and V row; all of them are loaded before any is used, so a warp waits for
// device memory once. The NK partial dots are summed across the warp by
// five rounds of NK independent shuffles, each lane ending with every
// score; then the row's exact softmax over the N scores and O = P V.
template <int D, int NK>
__global__ void __launch_bounds__(F32_THREADS)
attn_f32_reg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int N, int H,
                    Strides st, float scale) {
  constexpr int DC = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * F32_WARPS + warp;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  if (n >= N) return;  // no barrier below
  const float* qr = q + b * st.q_sb + n * st.q_sn + h * st.q_sh + lane;
  const float* kh = k + b * st.k_sb + h * st.k_sh + lane;
  const float* vh = v + b * st.v_sb + h * st.v_sh + lane;
  float qv[DC], kv[NK][DC], vv[NK][DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) qv[c] = qr[32 * c];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      kv[j][c] = j < N ? kh[j * st.k_sn + 32 * c] : 0.f;
      vv[j][c] = j < N ? vh[j * st.v_sn + 32 * c] : 0.f;
    }
  float s[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) s[j] = fmaf(qv[c], kv[j][c], s[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < NK; ++j)
    if (j < N) mx = fmaxf(mx, s[j] * scale);
  float l = 0.f, acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (j >= N) break;
    const float p = expf(s[j] * scale - mx);
    l += p;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] = fmaf(p, vv[j][c], acc[c]);
  }
  const float inv = 1.f / l;
  float* orow = o + ((static_cast<long long>(b) * N + n) * H + h) * D + lane;
#pragma unroll
  for (int c = 0; c < DC; ++c) orow[32 * c] = acc[c] * inv;
}


// cp.async of BYTES (4 or 16) from global to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = smem_u32(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0 .. F32_RESIDENT - 1) groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// shared memory of a block, in floats: Q (BQ rows), `stages` K tiles, as
// many V tiles, and each warp's P (BK keys x RW rows). Rows are padded to
// D + 4 floats, so that 8 lanes reading float4s of 8 rows hit distinct banks.
template <int D, int RW>
struct F32Layout {
  static constexpr int LD = D + 4;
  static constexpr int BQ = F32_WARPS * RW;
  static constexpr int PLD = RW + 4;
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int TILE_FLOATS = F32_BK * LD;
  static constexpr int P_FLOATS = F32_WARPS * F32_BK * PLD;
  static constexpr size_t bytes(int stages) {
    return size_t(Q_FLOATS + 2 * stages * TILE_FLOATS + P_FLOATS) * sizeof(float);
  }
};

// rows row0 .. min(row0 + rows, N) - 1 of one head (row stride `ld_g`
// elements) into dst (row stride LD); 16-byte copies when every address is
// 16-byte aligned, else 4-byte ones. Rows past N are left as they are: a
// key past N is masked before the softmax and skipped by P V, and a query
// row past N is computed on its own and never stored.
template <int D, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* head, long long ld_g,
                                           int row0, int rows, int N, bool vec16) {
  rows = min(rows, N - row0);
  if (vec16) {
    constexpr int C = D / 4;
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      cp_async<16>(dst + r * LD + 4 * c, head + (row0 + r) * ld_g + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      cp_async<4>(dst + r * LD + c, head + (row0 + r) * ld_g + c);
    }
  }
}

// A block of F32_WARPS warps takes BQ = F32_WARPS * RW query rows of one
// (batch, head); warp w owns rows w * RW .. w * RW + RW - 1. Key tiles of
// F32_BK = 32 keys, one a lane. Per tile: each lane's dot of its key with
// the warp's RW rows (Q broadcast from shared memory, K a float4 per lane
// and step), the online softmax (one warp max a row; each lane keeps its
// own share of the row sum, summed once at the end), P to shared memory,
// then O += P V with each lane owning D / 32 columns of the warp's rows.
// K/V tiles: the first `stages` are loaded with Q up front (all of them
// when stages == tiles); tile t + stages refills tile t's slot after it.
template <int D, int RW>
__global__ void __launch_bounds__(F32_THREADS)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int N, int H,
                Strides st, float scale, int stages, int vec16) {
  using L = F32Layout<D, RW>;
  constexpr int DC = D / 32;  // output columns a lane
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;
  float* ks = qs + L::Q_FLOATS;
  float* vs = ks + stages * L::TILE_FLOATS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = vs + stages * L::TILE_FLOATS + warp * F32_BK * L::PLD;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * L::BQ;
  const float* qh = q + b * st.q_sb + h * st.q_sh;
  const float* kh = k + b * st.k_sb + h * st.k_sh;
  const float* vh = v + b * st.v_sb + h * st.v_sh;
  const int tiles = (N + F32_BK - 1) / F32_BK;

  // group t holds K/V tile t (group 0 also Q)
  stage_rows<D, L::LD>(qs, qh, st.q_sn, q0, L::BQ, N, vec16);
  for (int t = 0; t < stages; ++t) {
    stage_rows<D, L::LD>(ks + t * L::TILE_FLOATS, kh, st.k_sn, t * F32_BK, F32_BK, N, vec16);
    stage_rows<D, L::LD>(vs + t * L::TILE_FLOATS, vh, st.v_sn, t * F32_BK, F32_BK, N, vec16);
    cp_async_commit();
  }

  const int r0 = warp * RW;
  const bool active = q0 + r0 < N;
  float m[RW], l[RW], acc[RW][DC];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int slot = t % stages;
    // one group is committed per tile below, so tile t has landed once at
    // most stages - 1 groups are in flight
    cp_async_wait(stages - 1);
    __syncthreads();
    if (active) {
      const float* kt = ks + slot * L::TILE_FLOATS;
      const float* vt = vs + slot * L::TILE_FLOATS;
      // each dot as CH chains over the float4's components: with few rows a
      // warp, one chain a row would be D dependent FMAs deep
      constexpr int CH = RW <= 4 ? 4 : 1;
      float s[RW], sc[RW][CH];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int c = 0; c < CH; ++c) sc[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + lane * L::LD + d);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + i) * L::LD + d);
          sc[i][0] = fmaf(qv.x, kv.x, sc[i][0]);
          sc[i][1 % CH] = fmaf(qv.y, kv.y, sc[i][1 % CH]);
          sc[i][2 % CH] = fmaf(qv.z, kv.z, sc[i][2 % CH]);
          sc[i][3 % CH] = fmaf(qv.w, kv.w, sc[i][3 % CH]);
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        s[i] = sc[i][0];
#pragma unroll
        for (int c = 1; c < CH; ++c) s[i] += sc[i][c];
      }
      const bool key_ok = t * F32_BK + lane < N;
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float x = key_ok ? s[i] * scale : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        const float p = expf(x - m_new);
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
        m[i] = m_new;
        ps[lane * L::PLD + i] = p;
      }
      __syncwarp();
      const int nk = min(F32_BK, N - t * F32_BK);
      for (int j = 0; j < nk; ++j) {
        float vv[DC];
        if constexpr (DC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vt + j * L::LD + 4 * lane);
          vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vt + j * L::LD + 2 * lane);
          vv[0] = x.x; vv[1] = x.y;
        }
        const float* pj = ps + j * L::PLD;
#pragma unroll
        for (int i = 0; i < RW; i += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pj + i);
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            acc[i][c] = fmaf(p4.x, vv[c], acc[i][c]);
            acc[i + 1][c] = fmaf(p4.y, vv[c], acc[i + 1][c]);
            acc[i + 2][c] = fmaf(p4.z, vv[c], acc[i + 2][c]);
            acc[i + 3][c] = fmaf(p4.w, vv[c], acc[i + 3][c]);
          }
        }
      }
      __syncwarp();
    }
    // every warp is done with the slot before tile t + stages refills it
    __syncthreads();
    if (t + stages < tiles) {
      const int t2 = t + stages;
      stage_rows<D, L::LD>(ks + slot * L::TILE_FLOATS, kh, st.k_sn, t2 * F32_BK, F32_BK, N,
                           vec16);
      stage_rows<D, L::LD>(vs + slot * L::TILE_FLOATS, vh, st.v_sn, t2 * F32_BK, F32_BK, N,
                           vec16);
    }
    cp_async_commit();  // empty past the last tile: keeps one group a tile
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int n = q0 + r0 + i;
    if (n >= N) continue;
    const float inv = 1.f / li;
    float* orow = o + ((static_cast<long long>(b) * N + n) * H + h) * D;
    if constexpr (DC == 4)
      *reinterpret_cast<float4*>(orow + 4 * lane) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    else
      *reinterpret_cast<float2*>(orow + 2 * lane) = make_float2(acc[i][0] * inv,
                                                                acc[i][1] * inv);
  }
}

// --- host -------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a 4-D map over (D, H, N, B) with the tensor's own strides (elements), box
// {64, 1, rows, 1}, 128-byte swizzle, zero fill past the edges
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B, int N, int H,
              int D, long long sb, long long sn, long long sh, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(N), cuuint64_t(B)};
  // a dimension of size 1 is never stepped along: any legal stride will do
  const cuuint64_t strides[3] = {H > 1 ? cuuint64_t(sh) * 2 : 16,
                                 N > 1 ? cuuint64_t(sn) * 2 : 16,
                                 B > 1 ? cuuint64_t(sb) * 2 : 16};
  const cuuint32_t box[4] = {CHUNK, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// set up once per template instance and device: the raised shared-memory
// limit, and the SM count that sizes the persistent grid
template <int D>
cudaError_t device_setup(int* sms) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};   // the SM count once set up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(attn_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::BYTES);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) cached[dev] = *sms;
  return err;
}

// scale >= 0 (the wrapper folds a negative scale into q); a zero scale runs
// as 1e-30, where every weight rounds to 2^0 exactly, as 0 gives
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                        int N, int H, const Strides& st, float scale, cudaStream_t s) {
  if (!(scale >= 0.f)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, encode, q, B, N, H, D, st.q_sb, st.q_sn, st.q_sh, BQ) ||
      !make_map(&mk, encode, k, B, N, H, D, st.k_sb, st.k_sn, st.k_sh, Smem<D>::BK) ||
      !make_map(&mv, encode, v, B, N, H, D, st.v_sb, st.v_sn, st.v_sh, Smem<D>::BK))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = device_setup<D>(&sms);
  if (err != cudaSuccess) return err;
  const int items = B * H * ((N + BQ - 1) / BQ);
  attn_bf16_kernel<D><<<items < sms ? items : sms, THREADS, Smem<D>::BYTES, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), N, H, items, fmaxf(scale * LOG2E, 1e-30f));
  return cudaGetLastError();
}

// whether every address the f32 kernel reads is 16-byte aligned: the bases,
// and the strides of every dimension it steps along (size > 1)
bool aligned16(const void* ptr, int B, int N, int H, long long sb, long long sn,
               long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (B == 1 || sb % 4 == 0) &&
         (N == 1 || sn % 4 == 0) && (H == 1 || sh % 4 == 0);
}

// rows a warp: 4 (16 query rows a block) while N <= 64, where the blocks
// are few and short; 16 (64 a block) past that, where each block's K/V
// traffic is shared by more rows
template <int D, int RW>
cudaError_t launch_f32_rows(const void* q, const void* k, const void* v, void* o, int B,
                            int N, int H, const Strides& st, float scale, cudaStream_t s) {
  using L = F32Layout<D, RW>;
  const int tiles = (N + F32_BK - 1) / F32_BK;
  const int stages = tiles <= F32_RESIDENT ? tiles : F32_RING;
  // past the default 48 KB, raise the instance's limit once per device
  if (L::bytes(stages) > 48 * 1024) {
    constexpr int MAX_DEVICES = 64;
    static bool raised[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES || !raised[dev]) {
      err = cudaFuncSetAttribute(attn_f32_kernel<D, RW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(L::bytes(F32_RESIDENT)));
      if (err != cudaSuccess) return err;
      if (dev < MAX_DEVICES) raised[dev] = true;
    }
  }
  const bool vec16 = aligned16(q, B, N, H, st.q_sb, st.q_sn, st.q_sh) &&
                     aligned16(k, B, N, H, st.k_sb, st.k_sn, st.k_sh) &&
                     aligned16(v, B, N, H, st.v_sb, st.v_sn, st.v_sh);
  dim3 grid((N + L::BQ - 1) / L::BQ, B * H);
  attn_f32_kernel<D, RW><<<grid, F32_THREADS, L::bytes(stages), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), N, H, st, scale, stages,
      vec16 ? 1 : 0);
  return cudaGetLastError();
}

// N <= F32_REG_N: the register kernel, an instance of 4, 8 or 16 keys
template <int D, int NK>
cudaError_t launch_f32_reg(const void* q, const void* k, const void* v, void* o, int B,
                           int N, int H, const Strides& st, float scale, cudaStream_t s) {
  dim3 grid((N + F32_WARPS - 1) / F32_WARPS, B * H);
  attn_f32_reg_kernel<D, NK><<<grid, F32_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), N, H, st, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                       int N, int H, const Strides& st, float scale, cudaStream_t s) {
  static_assert(F32_REG_N == 16, "the register kernel's instances are 4, 8 and 16 keys");
  if (N <= 4) return launch_f32_reg<D, 4>(q, k, v, o, B, N, H, st, scale, s);
  if (N <= 8) return launch_f32_reg<D, 8>(q, k, v, o, B, N, H, st, scale, s);
  if (N <= F32_REG_N) return launch_f32_reg<D, 16>(q, k, v, o, B, N, H, st, scale, s);
  return N <= 64 ? launch_f32_rows<D, 4>(q, k, v, o, B, N, H, st, scale, s)
                 : launch_f32_rows<D, 16>(q, k, v, o, B, N, H, st, scale, s);
}

}  // namespace

// dims: B, N, H, D, the (batch, token, head) strides in elements of q, of k
// and of v, then 1 for bf16 or 0 for f32 (14 values, read before the launch)
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* o,
                             const long long* dims, float scale, void* stream) {
  const int B = int(dims[0]), N = int(dims[1]), H = int(dims[2]), D = int(dims[3]);
  const Strides st{dims[4], dims[5], dims[6], dims[7], dims[8], dims[9],
                   dims[10], dims[11], dims[12]};
  const bool is_bf16 = dims[13] != 0;
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
