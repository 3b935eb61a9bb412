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
//   * `attn_key_loop`, the key loop of a block of 64 query rows: two
//     warpgroups (ATTN_THREADS, thread 0 the loader) each compute the whole
//     S = Q . K^T of a 64-key tile, the caller's masks, the online softmax
//     in registers, and O += P . V over their halves of up to 512 columns.
//     Two forms, chosen by d (`attn_wide`): up to ATTN_NARROW_D a block
//     keeps the 64 x d Q tile and a whole 64 x d K tile resident; past it
//     (the pod width, d = 1024, where Q, K and V's 512 columns would take
//     328,728 bytes) Q stays resident and K streams through a ring of
//     ATTN_KRING 64-column boxes, so S is summed over d a box at a time. Q
//     stays resident rather than streaming beside K because the epilogue
//     reads it again, a streamed Q would be fetched again for every key
//     tile, and the shared memory it would free buys no second block (a
//     block's 256 threads at about 205 registers each hold an SM alone);
//     chosen by that count, the streamed form not built. The ring's four
//     boxes keep three loads in flight behind the box the tensor cores read;
//   * `stage_cons` / `staged8`, the epilogue's pass of O / l through shared
//     memory, and `cached_map`, the host's cache of tensor maps.
//
// The wgmma shapes:
//
//   * S = Q . K^T: m64n64k16 with both operands in shared memory, B
//     K-major (K [keys, d] row-major, wgmma's non-transposed B);
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
// serialized): chunks past d are neither loaded nor stored.
constexpr int ATTN_NC = 4;
constexpr int ATTN_THREADS = 256;  // two warpgroups: 255 registers a thread, O's sums fit
constexpr int ATTN_STAGE_BYTES = 16 * 64 * 4;  // a warp's 16 rows x 64 columns of f32
constexpr int KHAT_ROWS = 8;                   // pre-pass rows a block: one a warp

constexpr int ATTN_NARROW_D = 640;  // widest d with a resident K tile
constexpr int ATTN_MAX_D = 1024;    // widest d of the wide form: Q, the K ring and V fit
constexpr int ATTN_KRING = 4;       // the wide form's K boxes in flight

__host__ __device__ constexpr bool attn_wide(int d) { return d > ATTN_NARROW_D; }

// Shared-memory layout from a 1024-byte-aligned base (the swizzle's period):
// q [d/64 boxes], k [d/64 boxes, or the wide form's ATTN_KRING], v [the
// block's 2 ATTN_NC chunks], then the barriers q_full, k_full [1 or
// ATTN_KRING], v_full. The epilogue's staging reuses k and v.
template <bool WIDE>
struct AttnSmem {
  static constexpr int K_BARS = WIDE ? ATTN_KRING : 1;
  int boxes, k_off, v_off, bar_off, bytes;
  __host__ __device__ explicit AttnSmem(int d) {
    boxes = d / 64;
    const int k_boxes = WIDE ? ATTN_KRING : boxes;
    k_off = boxes * ATTN_BOX;
    v_off = k_off + k_boxes * ATTN_BOX;
    const int kv = (k_boxes + 2 * ATTN_NC) * ATTN_BOX;
    const int stage = ATTN_THREADS / 32 * ATTN_STAGE_BYTES;
    bar_off = k_off + (kv > stage ? kv : stage);
    bytes = 1024 + bar_off + (2 + K_BARS) * 8;
  }
};
using AttnLayout = AttnSmem<false>;

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
// arrives at and warpgroup 0 waits on). The WIDE form's k ring holds
// ATTN_KRING boxes instead, box step b (tile b / (d/64), its 64-column box
// b % (d/64)) in stage b % ATTN_KRING on k_full[stage], released through
// named barrier 4 + stage; thread 0 has issued steps 0 .. ATTN_KRING - 1,
// and `load_k(b)` issues step b once step b - ATTN_KRING's box is read.
// Per key tile it < tiles: S = Q .
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
template <bool WIDE = false, class LoadK, class LoadV, class Mask>
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
    if constexpr (WIDE) {
      const int boxes = d / 64, steps = tiles * boxes;
      for (int c = 0; c < boxes; ++c) {
        const int b = it * boxes + c, st = b % ATTN_KRING;
        mbar_wait(k_full + st, (b / ATTN_KRING) & 1);
        fence_acc(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(s, smem_desc(q_addr + c * ATTN_BOX + kk * 32, 16, 1024),
                             smem_desc(k_addr + st * ATTN_BOX + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(s);
        if (w == 1) {
          named_barrier_arrive(4 + st, ATTN_THREADS);
        } else {
          named_barrier_sync(4 + st, ATTN_THREADS);
          if (loader && b + ATTN_KRING < steps) load_k(b + ATTN_KRING);
        }
      }
    } else {
      mbar_wait(k_full, it & 1);
      fence_acc(s);
      wgmma_fence();
      for (int kk = 0; kk < k_steps; ++kk) {
        const uint32_t off = (kk / 4) * ATTN_BOX + (kk % 4) * 32;
        wgmma_m64n64k16_ss(s, smem_desc(q_addr + off, 16, 1024),
                           smem_desc(k_addr + off, 16, 1024));
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

// A make_map_3d map from a small cache: a map depends only on the pointer,
// the extents, the strides and the box, and the serving and training loops
// pass the same few buffers again and again, so most calls skip
// cuTensorMapEncodeTiled.
inline cudaError_t cached_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[3],
                              const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3]) {
  struct Entry {
    const void* ptr;
    cuuint64_t dims[3], strides[2];
    cuuint32_t box[3];
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
  const cudaError_t err = make_map_3d(map, ptr, dims, strides, box);
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

}  // namespace sm90
