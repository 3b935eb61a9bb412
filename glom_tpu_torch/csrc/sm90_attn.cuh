// The port's Hopper attention (sm_90a), shared by K2's bf16 forward
// (consensus_update.cu) and K4's (banded_consensus.cu), on the GEMM
// mainloop's barriers, TMA loads, descriptors and host helpers
// (sm90_gemm.cuh):
//
//   * `khat_kernel`, the keys' pre-pass: k = x / max(||x||, 1e-12) of each
//     d-element row in f32, rounded once to bf16, into a scratch the caller
//     allocates, so a key row is normalised once a launch, not once for
//     every query block that reads it (`khat_row`, one warp's row, is also
//     K2's backward pre-pass);
//   * `attn_key_loop`, the key loop of a block of 64 query rows up to
//     ATTN_NARROW_D: two warpgroups (ATTN_THREADS, thread 0 the loader)
//     each compute the whole S = Q . K^T of a 64-key tile, the caller's
//     masks, the online softmax in registers, and O += P . V over their
//     halves of up to 512 columns, with the 64 x d Q tile and a whole 64 x d
//     K tile resident;
//   * `attn_pair_loop`, the wide form past ATTN_NARROW_D (the pod width,
//     d = 1024, where Q, K and V's 512 columns would take 328,728 bytes): a
//     cluster of two blocks for each 64 query rows, block g (its rank)
//     owning the 512 columns 512 g .. 512 g + 511 of d, both as its share of
//     the contraction Q . K^T and as its share of O's columns. Each block
//     holds only its half of Q (64 KB) and of every K and V tile, so every
//     score is computed once:
//       - the two warpgroups split the keys: warpgroup w sums the partial S
//         of keys 32 w .. 32 w + 31 over the block's columns (wgmma
//         m64n32k16, all 32 K steps issued back to back);
//       - each warpgroup loads its own operands, so no warpgroup waits on
//         the other to free a stage: its thread 0 loads each key tile's 32
//         keys x 512 columns of K (32 KB) and its 64 keys x 256 columns of
//         V (32 KB) with one 4-D TMA load each, K for tile it + 1 as soon as
//         tile it's scores have retired, V as soon as its P . V has (few
//         issues: a TMA issue stalls its thread, and the warpgroup's next
//         wgmma waits for it; a load a 64-column box cost more than the
//         products it fed, PERF.md). There is no producer warp: with a
//         ninth warp or a producer warpgroup ptxas capped a thread at 168
//         registers and spilled, below O's 128 sums and the rest;
//       - the pair exchanges the partials through distributed shared
//         memory: each thread writes its 16 sums into the peer's slot with
//         st.async, which completes the peer's `s_full` mbarrier by bytes,
//         and the peer frees the slot again through its `s_empty`. Every
//         thread then forms S = S_rank0 + S_rank1, rank 0's half first, so
//         both blocks hold the same S bit for bit (one addition of two
//         terms: IEEE addition commutes, so the order cannot part them);
//       - the warpgroups exchange their row maxima, row sums and rounded P
//         through shared memory (a named barrier each), so all four
//         warpgroups of the pair hold the same m, l and P, bit for bit, and
//         each accumulates O += P . V over its four 64-column chunks of V;
//       - the epilogue's own operands (K2's bu and td) load into a
//         warpgroup's K and V bytes as soon as its last products retire.
//     Shared memory (AttnPairSmem): Q 64 KB, K and V 64 KB each (a tile's
//     for each warpgroup), the exchange slots 28 KB (32 KB: the epilogue
//     stages O there): 230,496 bytes, one block an SM, a cluster on two
//     SMs;
//   * `stage_cons` / `staged8`, the epilogue's pass of O / l through shared
//     memory, and `cached_map`, the host's cache of tensor maps.
//
// The wgmma shapes:
//
//   * S = Q . K^T: m64n64k16 with both operands in shared memory, B
//     K-major (K [keys, d] row-major, wgmma's non-transposed B); the wide
//     form's m64n32k16, B the warpgroup's 32 key rows of the box;
//   * O += P . V: m64n64k16 with A in registers (P, the rounded softmax
//     probabilities, straight from the S accumulator: the RS form) and B
//     MN-major (V [keys, d] row-major, the transposed B sm90_gemm.cuh reads).
//
// The m64n64 accumulator fragment is the m64n128 one's first half
// (sm90_gemm.cuh, for_each_pair): thread t holds, for j = 0..7, columns
// 8j + 2(t%4) + {0, 1} of rows 16(t/32) + (t%32)/4 and that + 8, in
// d[4j .. 4j+3]. Its bf16 pairs are also wgmma's register A fragment: for
// K step k (columns 16k .. 16k+15) the four registers are the packed pairs
// of d[8k .. 8k+7] in order.

#pragma once

#include <cstring>
#include <mutex>

#include "sm90_gemm.cuh"

namespace sm90 {

constexpr int ACC64 = 32;  // f32 sums a thread holds for m64n64

#define SM90_ACC64_OUTS                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_ACC64_REGS                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A and B K-major in shared memory
// (imm-trans-b = 0), bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[ACC64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC64_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC64_OUTS
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers (four packed
// bf16 pairs a thread), B MN-major in shared memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[ACC64], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC64_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_ACC64_OUTS
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef SM90_ACC64_OUTS
#undef SM90_ACC64_REGS

// d[64 x N] += A[64 x 16] . B[16 x N] for N = 32 or 16 (the backward's
// streamed tiles): A and B K-major in shared memory, as the m64n64 form.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// Wait at named barrier `id` (1..15; 0 is __syncthreads') until `count`
// threads, a multiple of 32, have arrived; or arrive without waiting.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- the attention -------------------------------------------------------------

constexpr float NEG_MAX = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float SELF_VALUE = -5e-4f;               // TOKEN_ATTEND_SELF_VALUE
constexpr int ATTN_ROWS = 64;          // query rows a block: one wgmma m64
constexpr int ATTN_KEYS = 64;          // keys a tile: S is m64n64
constexpr int ATTN_BOX = 64 * 128;     // one TMA box: 64 rows x 64 bf16 columns (128-byte swizzle)
// A warpgroup holds ATTN_NC chunks of 64 output columns, a block 2 ATTN_NC
// (512 columns). Every wgmma runs for all chunks, also where d has fewer (a
// wgmma under a branch the compiler cannot prove warpgroup-uniform is
// serialized): chunks past d are not stored (nor loaded up to
// ATTN_NARROW_D; the wide form's 4-D loads fill them with zeros).
constexpr int ATTN_NC = 4;
constexpr int ATTN_THREADS = 256;  // two warpgroups: 255 registers a thread, O's sums fit
constexpr int ATTN_STAGE_BYTES = 16 * 64 * 4;  // a warp's 16 rows x 64 columns of f32
constexpr int KHAT_ROWS = 8;                   // pre-pass rows a block: one a warp
constexpr int ATTN_NARROW_D = 640;  // widest d with a resident K tile
constexpr int ATTN_MAX_D = 1024;    // widest d of the wide form: two blocks of 512 columns

__host__ __device__ constexpr bool attn_wide(int d) { return d > ATTN_NARROW_D; }

// Shared-memory layout from a 1024-byte-aligned base (the swizzle's period):
// q [d/64 boxes], k [d/64 boxes], v [the block's 2 ATTN_NC chunks], then
// the barriers q_full, k_full, v_full. The epilogue's staging reuses k and
// v.
struct AttnSmem {
  int boxes, k_off, v_off, bar_off, bytes;
  __host__ __device__ explicit AttnSmem(int d) {
    boxes = d / 64;
    k_off = boxes * ATTN_BOX;
    v_off = k_off + boxes * ATTN_BOX;
    const int kv = (boxes + 2 * ATTN_NC) * ATTN_BOX;
    const int stage = ATTN_THREADS / 32 * ATTN_STAGE_BYTES;
    bar_off = k_off + (kv > stage ? kv : stage);
    bytes = 1024 + bar_off + 3 * 8;
  }
};

// The wide form (a two-block cluster for each 64 query rows).
constexpr int PAIR_BOXES = 2 * ATTN_NC;     // a block's 64-column boxes of d: 512 columns
constexpr int PAIR_KEYS = ATTN_KEYS / 2;    // keys a warpgroup scores: S is m64n32
constexpr int PAIR_KBOX = PAIR_KEYS * 128;  // 32 keys x 64 bf16 columns
// A warpgroup's K tile (its 32 keys x the block's PAIR_BOXES boxes) and V
// tile (64 keys x its ATTN_NC chunks): one 4-D TMA box each.
constexpr int PAIR_KTILE = PAIR_BOXES * PAIR_KBOX;
constexpr int PAIR_VTILE = ATTN_NC * ATTN_BOX;
constexpr int ACC32 = 16;        // f32 sums a thread holds for m64n32
constexpr int PAIR_CLUSTER = 2;  // blocks a cluster: the two column groups

// Its shared memory from a 1024-byte-aligned base: q [PAIR_BOXES boxes],
// k [2 warpgroups][PAIR_KTILE], v [2][PAIR_VTILE], then the exchange: xs,
// the peer's partial S for each warpgroup ([2][4][128] float4: thread t's
// sums 4i .. 4i + 3 at [w][i][t]); xp, each warpgroup's rounded P
// ([2][2][128] uint4); xm and xl, each warpgroup's row maxima and row sums
// ([2][128] float2); then the barriers. A warpgroup's epilogue may load its
// own operands into its k once its last scores have retired (e_full [w][0])
// and into its v once its last P . V has (e_full [w][1]), and the epilogue
// stages O through the exchange's bytes (each warp's ATTN_STAGE_BYTES).
struct AttnPairSmem {
  static constexpr int K_OFF = PAIR_BOXES * ATTN_BOX;
  static constexpr int V_OFF = K_OFF + 2 * PAIR_KTILE;
  static constexpr int XS_OFF = V_OFF + 2 * PAIR_VTILE;
  static constexpr int XP_OFF = XS_OFF + 2 * 128 * ACC32 * 4;
  static constexpr int XM_OFF = XP_OFF + 2 * 128 * 32;
  static constexpr int XL_OFF = XM_OFF + 2 * 128 * 8;
  static constexpr int X_END = XL_OFF + 2 * 128 * 8;
  static constexpr int STAGE = ATTN_THREADS / 32 * ATTN_STAGE_BYTES;
  static constexpr int BAR_OFF = XS_OFF + (X_END - XS_OFF > STAGE ? X_END - XS_OFF : STAGE);
  // q_full; k_full [2]; v_full [2]; s_full [2]; s_empty; e_full [2][2].
  static constexpr int Q_FULL = 0, K_FULL = 1, V_FULL = 3, S_FULL = 5, S_EMPTY = 7, E_FULL = 8;
  static constexpr int BARS = 12;
  static constexpr int BYTES = 1024 + BAR_OFF + BARS * 8;
};
static_assert(AttnPairSmem::BYTES <= 232448, "the wide form fits a block's shared memory");

// k = x / max(||x||, 1e-12) of one row of d bf16 values, in f32, rounded,
// by the calling warp (`lane` its lane): 16-byte loads (d a multiple of 8).
__device__ __forceinline__ void khat_row(const __nv_bfloat16* __restrict__ x,
                                         __nv_bfloat16* __restrict__ k, int d, int lane) {
  const uint4* src = reinterpret_cast<const uint4*>(x);
  uint4* dst = reinterpret_cast<uint4*>(k);
  const int vecs = d / 8;
  float ss = 0.0f;
  for (int c = lane; c < vecs; c += 32) {
    const uint4 u = __ldg(src + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = __bfloat162float(e[i]);
      ss = fmaf(x, x, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float denom = fmaxf(sqrtf(ss), 1e-12f);
  for (int c = lane; c < vecs; c += 32) {
    const uint4 u = __ldg(src + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
    uint4 o;
    __nv_bfloat16* ko = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i) ko[i] = __float2bfloat16(__bfloat162float(e[i]) / denom);
    dst[c] = o;
  }
}

// khat_row for each of `rows` rows: one warp a row.
static __global__ void __launch_bounds__(32 * KHAT_ROWS)
khat_kernel(const __nv_bfloat16* __restrict__ lv, __nv_bfloat16* __restrict__ khat, size_t rows,
            int d) {
  const size_t row = (size_t)blockIdx.x * KHAT_ROWS + threadIdx.x / 32;
  if (row < rows) khat_row(lv + row * d, khat + row * d, d, threadIdx.x % 32);
}

static inline cudaError_t launch_khat(const __nv_bfloat16* lv, __nv_bfloat16* khat, size_t rows,
                                      int d, cudaStream_t stream) {
  khat_kernel<<<(unsigned)((rows + KHAT_ROWS - 1) / KHAT_ROWS), 32 * KHAT_ROWS, 0, stream>>>(
      lv, khat, rows, d);
  return cudaGetLastError();
}

// e^x as 2^(x log2 e) on the special-function unit (ex2.approx: about 2
// ulps, far below p's bf16 rounding); e^(-huge) is 0. The caller subtracts
// the max first: finfo(float32).min - m stays finite (or 0 for an
// all-masked row), where finfo(float32).min * log2 e would be -inf.
__device__ __forceinline__ float exp_f32(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// x / y from inv = RN(1 / y): q = RN(x inv) and one residual step, three
// operations instead of a division. By Markstein's theorem the result is
// RN(x / y) where nothing overflows or underflows, as for the sums over
// l >= 1 it is given here.
__device__ __forceinline__ float div_rn(float x, float y, float inv) {
  const float q = __fmul_rn(x, inv);
  return __fmaf_rn(__fmaf_rn(-q, y, x), inv, q);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The key loop of a block of ATTN_ROWS query rows, run by all ATTN_THREADS
// threads; thread 0 has issued the Q load (on q_full) and tile 0's k and v
// loads (on k_full, v_full), and issues the rest: `load_k(it)` refills the
// k ring once both warpgroups are past tile it - 1's k rows, `load_v(it)`
// the v ring once past its v rows (each a single-stage ring: an mbarrier
// the load completes and a named barrier, 1 or 2, that warpgroup 1
// arrives at and warpgroup 0 waits on). Per key tile it < tiles: S = Q .
// K^T over d (K step kk covers columns 16 kk .. 16 kk + 15, in box kk / 4,
// 32 bytes further along its 128-byte rows each step); S scaled;
// `mask(it, s)` edits the thread's scores (columns 8 jj + 2 (t % 4) + {0,
// 1} of rows a and b in s[4 jj .. 4 jj + 3]); the online softmax's step
// for rows a and b (a row's max and sum over the four threads that hold
// it, so both warpgroups hold the same m, l and P, bit for bit); O = O *
// corr + P . V over the warpgroup's ATTN_NC chunks, P rounded to bf16 as
// the register A operand (K step k covers keys 16k .. 16k + 15, 2048 bytes
// on; a warp whose rows kept their max skips the rescale by 1). On return
// both warpgroups are past their last products, so k and v may become the
// epilogue's staging area.
template <class LoadK, class LoadV, class Mask>
__device__ __forceinline__ void attn_key_loop(float (&o)[ATTN_NC][ACC64], float& m_a, float& m_b,
                                              float& l_a, float& l_b, const unsigned char* qs,
                                              const unsigned char* ks, const unsigned char* vs,
                                              uint64_t* q_full, uint64_t* k_full,
                                              uint64_t* v_full, int tiles, int d, float scale,
                                              const LoadK& load_k, const LoadV& load_v,
                                              const Mask& mask) {
  const int w = threadIdx.x / 128;
  const bool loader = threadIdx.x == 0;
  const int c_first = ATTN_NC * w;  // this warpgroup's chunks of the v ring
  const uint32_t q_addr = smem_u32(qs), k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  const int k_steps = d / 16;
#pragma unroll
  for (int c = 0; c < ATTN_NC; ++c)
#pragma unroll
    for (int i = 0; i < ACC64; ++i) o[c][i] = 0.0f;
  m_a = m_b = NEG_MAX;
  l_a = l_b = 0.0f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < tiles; ++it) {
    float s[ACC64];
#pragma unroll
    for (int i = 0; i < ACC64; ++i) s[i] = 0.0f;
    mbar_wait(k_full, it & 1);
    fence_acc(s);
    wgmma_fence();
    for (int kk = 0; kk < k_steps; ++kk) {
      const uint32_t off = (kk / 4) * ATTN_BOX + (kk % 4) * 32;
      wgmma_m64n64k16_ss(s, smem_desc(q_addr + off, 16, 1024), smem_desc(k_addr + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    if (w == 1) {
      named_barrier_arrive(1, ATTN_THREADS);
    } else {
      named_barrier_sync(1, ATTN_THREADS);
      if (loader && it + 1 < tiles) load_k(it + 1);
    }

#pragma unroll
    for (int i = 0; i < ACC64; ++i) s[i] = __fmul_rn(s[i], scale);
    mask(it, s);
    float mx_a = NEG_MAX, mx_b = NEG_MAX;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * jj], s[4 * jj + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = mn_a == m_a ? 1.0f : exp_f32(__fsub_rn(m_a, mn_a));
    const float corr_b = mn_b == m_b ? 1.0f : exp_f32(__fsub_rn(m_b, mn_b));
    float sum_a = 0.0f, sum_b = 0.0f;
    uint32_t p[16];  // P rounded to bf16: K step k's A registers are p[4k .. 4k+3]
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float pa0 = exp_f32(__fsub_rn(s[4 * jj], mn_a));
      const float pa1 = exp_f32(__fsub_rn(s[4 * jj + 1], mn_a));
      const float pb0 = exp_f32(__fsub_rn(s[4 * jj + 2], mn_b));
      const float pb1 = exp_f32(__fsub_rn(s[4 * jj + 3], mn_b));
      sum_a = __fadd_rn(__fadd_rn(sum_a, pa0), pa1);
      sum_b = __fadd_rn(__fadd_rn(sum_b, pb0), pb1);
      p[2 * jj] = pack_bf16(pa0, pa1);
      p[2 * jj + 1] = pack_bf16(pb0, pb1);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      sum_a = __fadd_rn(sum_a, __shfl_xor_sync(0xffffffffu, sum_a, o2));
      sum_b = __fadd_rn(sum_b, __shfl_xor_sync(0xffffffffu, sum_b, o2));
    }
    l_a = __fmaf_rn(l_a, corr_a, sum_a);
    l_b = __fmaf_rn(l_b, corr_b, sum_b);
    m_a = mn_a;
    m_b = mn_b;

    if (__any_sync(0xffffffffu, corr_a != 1.0f || corr_b != 1.0f)) {
#pragma unroll
      for (int c = 0; c < ATTN_NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[c][4 * jj] = __fmul_rn(o[c][4 * jj], corr_a);
          o[c][4 * jj + 1] = __fmul_rn(o[c][4 * jj + 1], corr_a);
          o[c][4 * jj + 2] = __fmul_rn(o[c][4 * jj + 2], corr_b);
          o[c][4 * jj + 3] = __fmul_rn(o[c][4 * jj + 3], corr_b);
        }
    }
    mbar_wait(v_full, it & 1);
#pragma unroll
    for (int c = 0; c < ATTN_NC; ++c) fence_acc(o[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < ATTN_NC; ++c) {
      const uint32_t vb = v_addr + (c_first + c) * ATTN_BOX;
#pragma unroll
      for (int kk = 0; kk < ATTN_KEYS / 16; ++kk)
        wgmma_m64n64k16_rs(o[c], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                           smem_desc(vb + 2048 * kk, ATTN_BOX, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < ATTN_NC; ++c) fence_acc(o[c]);
    if (w == 1) {
      named_barrier_arrive(2, ATTN_THREADS);
    } else {
      named_barrier_sync(2, ATTN_THREADS);
      if (loader && it + 1 < tiles) load_v(it + 1);
    }
  }
  named_barrier_sync(3, ATTN_THREADS);
}

// --- the wide form: a two-block cluster ----------------------------------------

// Four f32 into another block's shared memory at `addr`, completing 16
// bytes of the transaction count of its mbarrier at `bar` (both
// shared::cluster addresses).
__device__ __forceinline__ void st_async_f4(uint32_t addr, float a, float b, float c, float d,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// Arrive on another block's mbarrier at `bar` (a shared::cluster address),
// releasing at cluster scope what this thread, and the threads of a named
// barrier it has passed, did before.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait acquiring at cluster scope: for a phase the other block
// completes.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint64_t start = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 4096 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > WAIT_LIMIT_NS) __trap();
    }
  }
}

// A warpgroup's exchange of its m64n32 partial sums with the same
// warpgroup of the peer block (`it` counts the exchanges): once the peer has
// read this thread's previous sums (s_empty's phase it - 1, which the peer
// arrives at remotely), the thread's 16 sums go into its slot in the peer by
// st.async, completing the peer's s_full by bytes (`arm`: the warpgroup's
// thread 0 arms this block's s_full with the peer's bytes); then the peer's
// sums are read from this block's slot `xs` (float4 i at xs[128 i]) and s =
// S_rank0 + S_rank1, rank 0's half first, so both blocks hold the same bits.
__device__ __forceinline__ void pair_exchange(float (&s)[ACC32], const float4* xs,
                                              uint32_t xs_peer, uint64_t* s_full,
                                              uint32_t s_full_peer, uint64_t* s_empty, int it,
                                              uint32_t rank, bool arm) {
  mbar_wait_cluster(s_empty, (it & 1) ^ 1);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st_async_f4(xs_peer + i * 128 * 16, s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3],
                s_full_peer);
  if (arm) mbar_expect_tx(s_full, 128 * ACC32 * 4);
  mbar_wait(s_full, it & 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = xs[i * 128];
    const float peer[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float own = s[4 * i + e];
      s[4 * i + e] = __fadd_rn(rank == 0 ? own : peer[e], rank == 0 ? peer[e] : own);
    }
  }
}

// `bytes` (a multiple of 16) from p (16-byte aligned) into L2, without
// waiting: a bulk prefetch.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// An f32 from another block's shared memory (a shared::cluster address).
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Thread 0 sets up the wide form's barriers (one arrival each: a loader's
// or the peer's); the cluster syncs later (attn_pair_loop), after the
// first loads are under way, so neither block arrives at or writes into the
// other before it is set up.
__device__ __forceinline__ void attn_pair_init(unsigned char* smem) {
  using S = AttnPairSmem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::BARS; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One 4-D TMA tile load, global -> shared, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The wide form's key loop, run by all ATTN_THREADS threads of each block
// of the pair after attn_pair_init (`rank` the block's in the pair, nb its
// boxes of d): tile 0's loads are issued before the cluster syncs, so the
// sync's wait overlaps them. The loads, each one 4-D TMA box completing on
// `bar` (its bytes armed here; boxes past d or past the rows load as
// zeros):
// load_q(dst, half, bar), the block's Q columns 256 half .. 256 half + 255
// (ATTN_NC boxes); load_k(dst, it, w, bar), the 32 keys of warpgroup w in
// the block's PAIR_BOXES boxes of key tile it; load_v(dst, it, w, bar),
// warpgroup w's ATTN_NC chunks of key tile it. Thread 0 loads Q; warpgroup
// w's thread 0 its K and V tiles. Per key tile it < tiles, each warpgroup:
//   * sums the partial S of its keys 32 w .. 32 w + 31 over the block's nb
//     boxes (K steps 32 bytes apart along the 128-byte rows), then loads
//     tile it + 1's K over this tile's;
//   * exchanges it with the peer: the partial into the peer's slot once the
//     peer has read the previous one (s_empty, which thread 0 arrives at on
//     the peer once both warpgroups here have read theirs), the peer's out
//     of this block's (s_full, armed with its bytes by the warpgroup's
//     thread 0); S = S_rank0 + S_rank1;
//   * scales S; `mask(it, s, key0)` edits the thread's scores (keys key0 +
//     8 jj + 2 (t % 4) + {0, 1} of rows a and b in s[4 jj .. 4 jj + 3],
//     key0 = 32 w);
//   * takes the online softmax's step: a row's max over the four threads
//     that hold it and then over both warpgroups (xm, named barrier 1), its
//     sum likewise (xl, named barrier 2: keys 0 .. 31 first), and P rounded
//     to bf16 (xp: the other warpgroup's 32 keys of wgmma's register A
//     operand);
//   * O = O * corr + P . V over its ATTN_NC chunks (chunks past d hold
//     zeros and are not stored), then loads tile it + 1's V over this
//     tile's.
// After the last tile's scores the warpgroup's thread 0 calls
// tail_k(its k, e_full [w][0]), after its last P . V tail_v(its v, e_full
// [w][1]): the caller's epilogue loads (or nothing). On return both
// warpgroups are past their last products and the peer's last partial is
// read (named barrier 3), so the exchange is free for the epilogue.
template <class LoadQ, class LoadK, class LoadV, class Mask, class TailK, class TailV>
__device__ __forceinline__ void attn_pair_loop(float (&o)[ATTN_NC][ACC64], float& m_a,
                                               float& m_b, float& l_a, float& l_b,
                                               unsigned char* smem, int tiles, int nb,
                                               float scale, uint32_t rank, const LoadQ& load_q,
                                               const LoadK& load_k, const LoadV& load_v,
                                               const Mask& mask, const TailK& tail_k,
                                               const TailV& tail_v) {
  using S = AttnPairSmem;
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const bool loader = t == 0;  // loads the warpgroup's K and V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* q_full = bars + S::Q_FULL;
  uint64_t* k_full = bars + S::K_FULL + w;
  uint64_t* v_full = bars + S::V_FULL + w;
  uint64_t* s_full = bars + S::S_FULL + w;
  uint64_t* s_empty = bars + S::S_EMPTY;
  uint64_t* e_full = bars + S::E_FULL + 2 * w;
  unsigned char* ks = smem + S::K_OFF + w * PAIR_KTILE;
  unsigned char* vs = smem + S::V_OFF + w * PAIR_VTILE;
  const uint32_t q_addr = smem_u32(smem), k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  // Thread t's slot for the peer's partial: float4 i at [w][i][t].
  const float4* xs = reinterpret_cast<const float4*>(smem + S::XS_OFF) + w * 4 * 128 + t;
  const uint32_t xs_peer = cluster_addr(smem_u32(xs), rank ^ 1);
  const uint32_t s_full_peer = cluster_addr(smem_u32(s_full), rank ^ 1);
  const uint32_t s_empty_peer = cluster_addr(smem_u32(s_empty), rank ^ 1);
  uint4* xp = reinterpret_cast<uint4*>(smem + S::XP_OFF);    // [2][2][128]
  float2* xm = reinterpret_cast<float2*>(smem + S::XM_OFF);  // [2][128]
  float2* xl = reinterpret_cast<float2*>(smem + S::XL_OFF);  // [2][128]
  if (loader) {
    if (w == 0) {
      mbar_expect_tx(q_full, PAIR_BOXES * ATTN_BOX);
      load_q(smem, 0, q_full);
      load_q(smem + ATTN_NC * ATTN_BOX, 1, q_full);
    }
    mbar_expect_tx(k_full, PAIR_KTILE);
    load_k(ks, 0, w, k_full);
    mbar_expect_tx(v_full, PAIR_VTILE);
    load_v(vs, 0, w, v_full);
  }
  cluster_sync();  // both blocks' barriers are set up
#pragma unroll
  for (int c = 0; c < ATTN_NC; ++c)
#pragma unroll
    for (int i = 0; i < ACC64; ++i) o[c][i] = 0.0f;
  m_a = m_b = NEG_MAX;
  l_a = l_b = 0.0f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < tiles; ++it) {
    const bool refill = loader && it + 1 < tiles;
    float s[ACC32];
#pragma unroll
    for (int i = 0; i < ACC32; ++i) s[i] = 0.0f;
    mbar_wait(k_full, it & 1);
    fence_acc(s);
    wgmma_fence();
    for (int c = 0; c < nb; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32k16_ss(s, smem_desc(q_addr + c * ATTN_BOX + kk * 32, 16, 1024),
                           smem_desc(k_addr + c * PAIR_KBOX + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    if (refill) {
      mbar_expect_tx(k_full, PAIR_KTILE);
      load_k(ks, it + 1, w, k_full);
    } else if (loader) {
      tail_k(ks, e_full);
    }

    pair_exchange(s, xs, xs_peer, s_full, s_full_peer, s_empty, it, rank, loader);

#pragma unroll
    for (int i = 0; i < ACC32; ++i) s[i] = __fmul_rn(s[i], scale);
    mask(it, s, PAIR_KEYS * w);
    float mx_a = NEG_MAX, mx_b = NEG_MAX;
#pragma unroll
    for (int jj = 0; jj < ACC32 / 4; ++jj) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * jj], s[4 * jj + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    xm[w * 128 + t] = make_float2(mx_a, mx_b);
    named_barrier_sync(1, ATTN_THREADS);
    if (threadIdx.x == 0) mbar_arrive_cluster(s_empty_peer);  // both slots here are read
    const float2 other_mx = xm[(w ^ 1) * 128 + t];
    mx_a = fmaxf(mx_a, other_mx.x);
    mx_b = fmaxf(mx_b, other_mx.y);
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = mn_a == m_a ? 1.0f : exp_f32(__fsub_rn(m_a, mn_a));
    const float corr_b = mn_b == m_b ? 1.0f : exp_f32(__fsub_rn(m_b, mn_b));
    float sum_a = 0.0f, sum_b = 0.0f;
    uint32_t p[8];  // the warpgroup's 32 keys of P, rounded to bf16
#pragma unroll
    for (int jj = 0; jj < ACC32 / 4; ++jj) {
      const float pa0 = exp_f32(__fsub_rn(s[4 * jj], mn_a));
      const float pa1 = exp_f32(__fsub_rn(s[4 * jj + 1], mn_a));
      const float pb0 = exp_f32(__fsub_rn(s[4 * jj + 2], mn_b));
      const float pb1 = exp_f32(__fsub_rn(s[4 * jj + 3], mn_b));
      sum_a = __fadd_rn(__fadd_rn(sum_a, pa0), pa1);
      sum_b = __fadd_rn(__fadd_rn(sum_b, pb0), pb1);
      p[2 * jj] = pack_bf16(pa0, pa1);
      p[2 * jj + 1] = pack_bf16(pb0, pb1);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      sum_a = __fadd_rn(sum_a, __shfl_xor_sync(0xffffffffu, sum_a, o2));
      sum_b = __fadd_rn(sum_b, __shfl_xor_sync(0xffffffffu, sum_b, o2));
    }
    xl[w * 128 + t] = make_float2(sum_a, sum_b);
    xp[(2 * w) * 128 + t] = make_uint4(p[0], p[1], p[2], p[3]);
    xp[(2 * w + 1) * 128 + t] = make_uint4(p[4], p[5], p[6], p[7]);
    named_barrier_sync(2, ATTN_THREADS);
    const float2 other_sum = xl[(w ^ 1) * 128 + t];
    const uint4 o0 = xp[(2 * (w ^ 1)) * 128 + t], o1 = xp[(2 * (w ^ 1) + 1) * 128 + t];
    const uint32_t other_p[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
    l_a = __fmaf_rn(l_a, corr_a,
                    __fadd_rn(w == 0 ? sum_a : other_sum.x, w == 0 ? other_sum.x : sum_a));
    l_b = __fmaf_rn(l_b, corr_b,
                    __fadd_rn(w == 0 ? sum_b : other_sum.y, w == 0 ? other_sum.y : sum_b));
    m_a = mn_a;
    m_b = mn_b;
    uint32_t pa[16];  // K step k's A registers are pa[4k .. 4k+3]: keys 0 .. 31, then 32 .. 63
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pa[i] = w == 0 ? p[i] : other_p[i];
      pa[8 + i] = w == 0 ? other_p[i] : p[i];
    }

    if (__any_sync(0xffffffffu, corr_a != 1.0f || corr_b != 1.0f)) {
#pragma unroll
      for (int c = 0; c < ATTN_NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[c][4 * jj] = __fmul_rn(o[c][4 * jj], corr_a);
          o[c][4 * jj + 1] = __fmul_rn(o[c][4 * jj + 1], corr_a);
          o[c][4 * jj + 2] = __fmul_rn(o[c][4 * jj + 2], corr_b);
          o[c][4 * jj + 3] = __fmul_rn(o[c][4 * jj + 3], corr_b);
        }
    }
    mbar_wait(v_full, it & 1);
#pragma unroll
    for (int c = 0; c < ATTN_NC; ++c) fence_acc(o[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < ATTN_NC; ++c)
#pragma unroll
      for (int kk = 0; kk < ATTN_KEYS / 16; ++kk)
        wgmma_m64n64k16_rs(o[c], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                           smem_desc(v_addr + c * ATTN_BOX + 2048 * kk, ATTN_BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < ATTN_NC; ++c) fence_acc(o[c]);
    if (refill) {
      mbar_expect_tx(v_full, PAIR_VTILE);
      load_v(vs, it + 1, w, v_full);
    } else if (loader) {
      tail_v(vs, e_full + 1);
    }
  }
  named_barrier_sync(3, ATTN_THREADS);
}

// The epilogue's pass of one 64-column chunk of O through shared memory:
// `stage_cons` writes O / l of the thread's rows a and b (inv = RN(1 / l))
// into its warp's `stage` ([16][32] float2, ATTN_STAGE_BYTES, pair slots
// XOR-swizzled by row so neither side conflicts on banks); after a
// __syncwarp, `staged8` reads columns 8k .. 8k + 7 of the warp's row rw.
__device__ __forceinline__ void stage_cons(const float (&o)[ACC64], float l_a, float inv_a,
                                           float l_b, float inv_b, float2* stage) {
  const int lane = threadIdx.x % 32, rw_a = lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int slot = (4 * jj + cq / 2) ^ (rw_a << 2);
    stage[rw_a * 32 + slot] =
        make_float2(div_rn(o[4 * jj], l_a, inv_a), div_rn(o[4 * jj + 1], l_a, inv_a));
    stage[(rw_a + 8) * 32 + slot] =
        make_float2(div_rn(o[4 * jj + 2], l_b, inv_b), div_rn(o[4 * jj + 3], l_b, inv_b));
  }
}

__device__ __forceinline__ void staged8(const float2* stage, int rw, int k, float (&v)[8]) {
  const float4* src = reinterpret_cast<const float4*>(stage + rw * 32 + 4 * (k ^ (rw & 7)));
  const float4 c0 = src[0], c1 = src[1];
  v[0] = c0.x, v[1] = c0.y, v[2] = c0.z, v[3] = c0.w;
  v[4] = c1.x, v[5] = c1.y, v[6] = c1.z, v[7] = c1.w;
}

// --- host side ----------------------------------------------------------------

// A bf16 tensor map of R dimensions with the 128-byte swizzle, as
// make_map_3d encodes its three (the wide form's loads are 4-D).
template <int R>
inline cudaError_t make_map_nd(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[R],
                               const cuuint64_t (&strides)[R - 1], const cuuint32_t (&box)[R]) {
  if constexpr (R == 3) {
    return make_map_3d(map, ptr, dims, strides, box);
  } else {
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return cudaErrorNotSupported;
    cuuint32_t elem_strides[R];
    for (int i = 0; i < R; ++i) elem_strides[i] = 1;
    const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
  }
}

// A make_map_nd map from a small cache (one for each R): a map depends only
// on the pointer, the extents, the strides and the box, and the serving
// and training loops pass the same few buffers again and again, so most
// calls skip cuTensorMapEncodeTiled.
template <int R = 3>
inline cudaError_t cached_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[R],
                              const cuuint64_t (&strides)[R - 1], const cuuint32_t (&box)[R]) {
  struct Entry {
    const void* ptr;
    cuuint64_t dims[R], strides[R - 1];
    cuuint32_t box[R];
    CUtensorMap map;
  };
  constexpr int ENTRIES = 16;
  static Entry cache[ENTRIES];
  static int next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : cache)
    if (e.ptr == ptr && !memcmp(e.dims, dims, sizeof(dims)) &&
        !memcmp(e.strides, strides, sizeof(strides)) && !memcmp(e.box, box, sizeof(box))) {
      *map = e.map;
      return cudaSuccess;
    }
  const cudaError_t err = make_map_nd<R>(map, ptr, dims, strides, box);
  if (err == cudaSuccess) {
    Entry& e = cache[next];
    e.ptr = ptr;
    memcpy(e.dims, dims, sizeof(dims));
    memcpy(e.strides, strides, sizeof(strides));
    memcpy(e.box, box, sizeof(box));
    e.map = *map;
    next = (next + 1) % ENTRIES;
  }
  return err;
}

// The wide form's launch config: `grid` in clusters of PAIR_CLUSTER blocks
// along grid dimension `axis` (1: y, 2: z: the column groups), blocks of
// ATTN_THREADS threads and `bytes` of shared memory (AttnPairSmem::BYTES
// for the forwards; the kernel's cap lifted by the caller).
inline cudaLaunchConfig_t pair_config(dim3 grid, int axis, int bytes, cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(ATTN_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = axis == 1 ? PAIR_CLUSTER : 1;
  attr->val.clusterDim.z = axis == 2 ? PAIR_CLUSTER : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class... Params, class... Args>
cudaError_t launch_pair_smem(void (*kernel)(Params...), dim3 grid, int axis, int bytes,
                             cudaStream_t stream, const Args&... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_config(grid, axis, bytes, stream, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <class... Params, class... Args>
cudaError_t launch_pair(void (*kernel)(Params...), dim3 grid, int axis, cudaStream_t stream,
                        const Args&... args) {
  return launch_pair_smem(kernel, grid, axis, AttnPairSmem::BYTES, stream, args...);
}

// How many clusters of the wide form's launch (`bytes` of shared memory a
// block) the device holds at once.
template <class... Params>
cudaError_t pair_clusters(void (*kernel)(Params...), int axis, int* clusters,
                          int bytes = AttnPairSmem::BYTES) {
  cudaLaunchAttribute attr;
  const dim3 grid(1, axis == 1 ? PAIR_CLUSTER : 1, axis == 2 ? PAIR_CLUSTER : 1);
  const cudaLaunchConfig_t cfg = pair_config(grid, axis, bytes, 0, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// A [slots, n, d] bf16 tensor as a 4-D map {64, n, d / 64, slots} (a
// column within its 64-column chunk, the row, the chunk, the slot) whose
// box is `chunks` chunks x `rows` rows: one load lands them as `chunks`
// swizzled 64-column boxes of `rows` rows each (cached). Chunks past d and
// rows past n load as zeros.
inline cudaError_t wide_map(CUtensorMap* map, const void* ptr, int d, int n, int slots, int rows,
                            int chunks) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)n, (cuuint64_t)d / 64, (cuuint64_t)slots};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, 128, (cuuint64_t)d * n * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, (cuuint32_t)chunks, 1};
  return cached_map<4>(map, ptr, dims, strides, box);
}

}  // namespace sm90
