// K2 forward: consensus attention fused with the 4-way mean column update,
// level-major [L, B, n, d].
//
//   cons_i = softmax_j(q_i . normalize(k_j) * d^-1/2 [masks]) . v_j
//   out_i  = (levels_i + bu_i + td_i + cons_i) / (g < L-1 ? 4 : 3)
//
// with q = v = levels and td = 0 at the top level g = L-1. For training it
// can also write each row's softmax statistics m (max score) and l (sum of
// exp(s - m)), f32 [L, B, n], for the backward (csrc/consensus_update_bwd.cu),
// and, for the one-sweep backward of long rows, the attention output cons_i
// itself, rounded to the levels type (glom_tpu's save_cons). That store is a
// template parameter, so serving and the short-row training forward compile
// it out.
//
// Replaces: glom_tpu/kernels/consensus_update.py:_consensus_update_kernel
// (resident k/v row) and :_consensus_update_kernel_streamed (streamed j
// tiles), with their save_cons output (`_forward`'s save_cons branches). The
// TPU split between the two is a VMEM-residency matter; here one kernel
// streams j tiles through shared memory at any n.
//
// Bound on the H100: device-memory bytes at the flagship bucket-8 shape
// ([6, 8, 256, 512] bf16: levels, bu and td read and out written, 48 MB,
// against 6.4 GFLOP of products); tensor-core operations at the long-row
// training shape ([6, 2, 4096, 512] bf16: 412 GFLOP against 244 MB with m,
// l and cons).
//
// Arithmetic follows the reference kernel: k is normalized in f32 and
// rounded to the compute type; scores are f32; the diagonal is replaced by
// -5e-4 when attend_self is off; pairs past the radius get the finite
// finfo(float32).min (never -inf, so a fully masked tile cannot make
// inf - inf); p is rounded to the compute type before p . v.
//
// bf16 design (Hopper, sm_90a):
//   * A pre-pass writes k = normalize(levels) rounded to bf16, [L, B, n, d],
//     to a scratch the caller allocates (one warp a row, 16-byte loads): the
//     key rows are normalized once a launch, not once for every query block
//     that reads them.
//   * The main kernel gives a block 64 query rows of one (level, image) and
//     up to 512 output columns (d > 512 takes a second block of columns,
//     which recomputes the same scores). Its thread 0 loads the block's q
//     rows once and then, tile after tile of 64 keys, the normalized k rows
//     and the v rows by TMA (128-byte swizzle) into two single-stage rings,
//     each an mbarrier that the load completes and a named barrier both
//     warpgroups pass before it is refilled: k for tile j + 1 loads while
//     tile j's softmax and P . V run, v for tile j + 1 while tile j + 1's
//     scores do.
//   * Two warpgroups each compute the whole S = Q . K^T (wgmma m64n64k16,
//     both operands in shared memory, f32 in registers), its masks and the
//     online softmax in registers (a row's max and sum over the four
//     threads that hold it), so both hold the same m, l and P, bit for bit;
//     each then accumulates its half of O's columns, O += P . V, with P
//     rounded to bf16 as wgmma's register A operand (the RS form) and the
//     f32 sums in registers (128 a thread at d = 512: with no producer
//     warpgroup a thread may hold 255 registers, so they fit unspilled).
//   * The epilogue forms cons = O / l, stages each warp's rows through
//     shared memory, and writes out (and cons) as whole 16-byte row
//     segments, reading q from the resident Q tile.
//   * Under a local radius only the live key tiles (glom_tpu's _window) are
//     loaded. Query rows past n load as zeros and are not stored; key
//     columns past n load as zeros and are masked to finfo(float32).min.
//   * Tile shapes, the K order and the rounding points are fixed, no sum is
//     split across blocks and nothing is atomic: a row's bits depend
//     neither on B, nor on the grid, nor on which launch computed them.
// Kept out of device memory: the [n, n] scores and probabilities and the
// f32 output sums; the attention output `cons` unless asked for.
//
// f32 runs on the CUDA cores with FMA (the reference's f32 arithmetic): a
// block owns 16 query rows, normalizes each 16-key tile's k rows as it
// loads them, and keeps the online softmax's accumulator in shared memory.
//
// The output must not alias the input: other row tiles still read it.
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <mutex>

#include "sm90_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_MAX = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float SELF_VALUE = -5e-4f;               // TOKEN_ATTEND_SELF_VALUE

// Rows i and j interact only within (floor(radius) + 1) * side flat
// positions (glom_tpu consensus_update.py:_window): the key tiles
// [j_lo, j_hi) of `tile` keys cover every pair of query rows [i0, i0 + rows).
struct Window {
  int j_lo, j_hi;
};

__device__ __forceinline__ Window live_tiles(int i0, int rows, int tile, int n, int reach) {
  const int n_tiles = (n + tile - 1) / tile;
  if (reach <= 0) return {0, n_tiles};
  const int lo = i0 - reach, hi = i0 + rows + reach;
  return {lo <= 0 ? 0 : lo / tile, min((hi + tile - 1) / tile, n_tiles)};
}

// --- f32: FMA on the CUDA cores -----------------------------------------------

constexpr int F32_THREADS = 256;  // 8 warps
constexpr int F32_WARPS = F32_THREADS / 32;
constexpr int F32_TI = 16, F32_TJ = 16, F32_PAD = 1;  // PAD spreads rows over banks

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// Shared-memory layout, every section 128-byte aligned.
struct F32Layout {
  static constexpr int TI = F32_TI, TJ = F32_TJ;
  int ld, ldacc, lds, ldp;
  size_t q_off, k_off, v_off, acc_off, s_off, p_off, st_off, bytes;
  __host__ __device__ explicit F32Layout(int d)
      : ld(d + F32_PAD), ldacc(d + 4), lds(TJ + 4), ldp(TJ + 8) {
    q_off = 0;
    k_off = q_off + align128(sizeof(float) * TI * ld);
    v_off = k_off + align128(sizeof(float) * TJ * ld);
    acc_off = v_off + align128(sizeof(float) * TJ * ld);
    s_off = acc_off + align128(sizeof(float) * TI * ldacc);
    p_off = s_off + align128(sizeof(float) * TI * lds);
    st_off = p_off + align128(sizeof(float) * TI * ldp);
    bytes = st_off + align128(sizeof(float) * 3 * TI);
  }
};

template <bool SAVE_CONS>
__global__ void __launch_bounds__(F32_THREADS)
consensus_update_kernel_f32(const float* __restrict__ lv, const float* __restrict__ bu,
                            const float* __restrict__ td, float* __restrict__ out,
                            float* __restrict__ m_out, float* __restrict__ l_out,
                            float* __restrict__ cons_out, int L, int B, int n, int d, int side,
                            int reach, float r2, int attend_self, float scale) {
  constexpr int TI = F32_TI, TJ = F32_TJ;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout lay(d);
  float* qs = reinterpret_cast<float*>(smem + lay.q_off);   // [TI][ld] levels rows (q)
  float* ks = reinterpret_cast<float*>(smem + lay.k_off);   // [TJ][ld] normalized k
  float* vs = reinterpret_cast<float*>(smem + lay.v_off);   // [TJ][ld] raw rows (v)
  float* acc = reinterpret_cast<float*>(smem + lay.acc_off);  // [TI][ldacc]
  float* S = reinterpret_cast<float*>(smem + lay.s_off);      // [TI][lds]
  float* P = reinterpret_cast<float*>(smem + lay.p_off);      // [TI][ldp]
  float* m_row = reinterpret_cast<float*>(smem + lay.st_off);
  float* l_row = m_row + TI;
  float* corr_row = l_row + TI;

  const int i0 = blockIdx.x * TI;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* row0 = lv + ((size_t)g * B + b) * n * d;  // levels[g, b]

  for (int e = tid; e < TI * d; e += F32_THREADS) {
    const int r = e / d, c = e - r * d;
    qs[r * lay.ld + c] = row0[(size_t)(i0 + r) * d + c];
    acc[r * lay.ldacc + c] = 0.0f;
  }
  if (tid < TI) {
    m_row[tid] = NEG_MAX;
    l_row[tid] = 0.0f;
  }
  const Window win = live_tiles(i0, TI, TJ, n, reach);
  __syncthreads();

  for (int jt = win.j_lo; jt < win.j_hi; ++jt) {
    const int j0 = jt * TJ;
    // Raw rows into vs; k = row / max(||row||, 1e-12) in f32 into ks.
    for (int r = warp; r < TJ; r += F32_WARPS) {
      const float* src = row0 + (size_t)(j0 + r) * d;
      float ss = 0.0f;
      for (int c = lane; c < d; c += 32) {
        const float v = src[c];
        vs[r * lay.ld + c] = v;
        ss = fmaf(v, v, ss);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float denom = fmaxf(sqrtf(ss), 1e-12f);
      for (int c = lane; c < d; c += 32) ks[r * lay.ld + c] = vs[r * lay.ld + c] / denom;
    }
    __syncthreads();

    // S = qs . ks^T (f32), one score per thread.
    static_assert(TI * TJ == F32_THREADS, "one score per thread");
    {
      const int r = tid / TJ, j = tid % TJ;
      float s = 0.0f;
      for (int c = 0; c < d; ++c) s = fmaf(qs[r * lay.ld + c], ks[j * lay.ld + c], s);
      S[r * lay.lds + j] = s;
    }
    __syncthreads();

    // Masks and the online-softmax step, one thread per query row.
    if (tid < TI) {
      const int r = tid, i = i0 + r;
      const int ri = i / side, ci = i - ri * side;
      float tmax = NEG_MAX;
      for (int j = 0; j < TJ; ++j) {
        float s = S[r * lay.lds + j] * scale;
        const int jj = j0 + j;
        if (!attend_self && jj == i) s = SELF_VALUE;
        if (reach > 0) {
          const int rj = jj / side, cj = jj - rj * side;
          const int dist2 = (ri - rj) * (ri - rj) + (ci - cj) * (ci - cj);
          if ((float)dist2 > r2) s = NEG_MAX;
        }
        S[r * lay.lds + j] = s;
        tmax = fmaxf(tmax, s);
      }
      const float m_old = m_row[r];
      const float m_new = fmaxf(m_old, tmax);
      const float corr = expf(m_old - m_new);
      float psum = 0.0f;
      for (int j = 0; j < TJ; ++j) {
        const float p = expf(S[r * lay.lds + j] - m_new);
        psum += p;
        P[r * lay.ldp + j] = p;
      }
      l_row[r] = l_row[r] * corr + psum;
      m_row[r] = m_new;
      corr_row[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P . vs.
    for (int e = tid; e < TI * d; e += F32_THREADS) {
      const int r = e / d, c = e - r * d;
      float pv = 0.0f;
#pragma unroll
      for (int k = 0; k < TJ; ++k) pv = fmaf(P[r * lay.ldp + k], vs[k * lay.ld + c], pv);
      acc[r * lay.ldacc + c] = acc[r * lay.ldacc + c] * corr_row[r] + pv;
    }
    __syncthreads();
  }

  // Epilogue: the 4-way mean (3-way with no top-down at the top level).
  const bool top = g == L - 1;
  const float div = top ? 3.0f : 4.0f;
  const size_t base = (((size_t)g * B + b) * n + i0) * d;
  const size_t td_base = top ? 0 : base;  // td is [L-1, B, n, d]: same offsets below the top
  for (int e = tid; e < TI * d; e += F32_THREADS) {
    const int r = e / d, c = e - r * d;
    const float cons = acc[r * lay.ldacc + c] / l_row[r];
    if constexpr (SAVE_CONS) cons_out[base + e] = cons;
    const float t = top ? 0.0f : td[td_base + e];
    const float v = (((qs[r * lay.ld + c] + bu[base + e]) + t) + cons) / div;
    out[base + e] = v;
  }
  if (m_out != nullptr && tid < TI) {
    const size_t row = ((size_t)g * B + b) * n + i0 + tid;
    m_out[row] = m_row[tid];
    l_out[row] = l_row[tid];
  }
}

// --- bf16: the Hopper kernel --------------------------------------------------

constexpr int ROWS = 64;         // query rows a block: one wgmma m64
constexpr int KEYS = 64;         // keys a tile: S is m64n64
constexpr int BOX_BYTES = 64 * 128;  // one TMA box: 64 rows x 64 bf16 columns (128-byte swizzle)
// A warpgroup holds NC chunks of 64 output columns, a block 2 NC (512
// columns). Every wgmma runs for all NC chunks, also where d has fewer (a
// wgmma under a branch the compiler cannot prove warpgroup-uniform is
// serialized): chunks past d are neither loaded nor stored.
constexpr int NC = 4;
constexpr int WARPGROUPS = 2;
constexpr int THREADS = 128 * WARPGROUPS;  // 255 registers a thread: O's sums fit
constexpr int MAX_D = 640;        // Q and K tiles of 64 rows x d, and V's 512 columns, fit
constexpr int STAGE_BYTES = 16 * 64 * 4;  // a warp's 16 rows x 64 columns of f32
constexpr int KHAT_ROWS = 8;      // pre-pass rows a block: one a warp

// Shared-memory layout from a 1024-byte-aligned base (the swizzle's period):
// q [d/64 boxes], k [d/64 boxes], v [the block's 2 NC chunks], then the
// barriers. The epilogue's staging reuses k and v.
struct Bf16Layout {
  int boxes, k_off, v_off, bar_off, bytes;
  __host__ __device__ explicit Bf16Layout(int d) {
    boxes = d / 64;
    k_off = boxes * BOX_BYTES;
    v_off = 2 * boxes * BOX_BYTES;
    const int kv = (boxes + 2 * NC) * BOX_BYTES;
    const int stage = WARPGROUPS * 4 * STAGE_BYTES;
    bar_off = k_off + (kv > stage ? kv : stage);
    bytes = 1024 + bar_off + 3 * 8;
  }
};

// k = levels / max(||levels||, 1e-12), in f32, rounded: one warp a row.
__global__ void __launch_bounds__(32 * KHAT_ROWS)
consensus_update_kernel_khat(const bf16* __restrict__ lv, bf16* __restrict__ khat,
                             size_t rows, int d) {
  const size_t row = (size_t)blockIdx.x * KHAT_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* src = reinterpret_cast<const uint4*>(lv + row * d);
  uint4* dst = reinterpret_cast<uint4*>(khat + row * d);
  const int vecs = d / 8;
  float ss = 0.0f;
  for (int c = lane; c < vecs; c += 32) {
    const uint4 u = __ldg(src + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
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
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    uint4 o;
    bf16* ko = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i) ko[i] = __float2bfloat16(__bfloat162float(e[i]) / denom);
    dst[c] = o;
  }
}

// e^x as 2^(x log2 e) on the special-function unit (ex2.approx: about 2
// ulps, far below p's bf16 rounding); e^(-huge) is 0.
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

__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Grid: (row blocks, column groups of 512, L * B). lv_map and
// k_map are [L * B, n, d] bf16 maps with a 64 x 64 box (sm90::make_map).
template <bool SAVE_CONS>
__global__ void __launch_bounds__(THREADS, 1)
consensus_update_kernel_bf16(const __grid_constant__ CUtensorMap lv_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const bf16* __restrict__ bu, const bf16* __restrict__ td,
                             bf16* __restrict__ out, float* __restrict__ m_out,
                             float* __restrict__ l_out, bf16* __restrict__ cons_out, int L, int B,
                             int n, int d, int side, int reach, float r2, int attend_self,
                             float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Bf16Layout lay(d);
  unsigned char* qs = smem;
  unsigned char* ks = smem + lay.k_off;
  unsigned char* vs = smem + lay.v_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 2;

  const int i0 = blockIdx.x * ROWS;
  const int chunk0 = 2 * NC * blockIdx.y;  // the block's first 64-column chunk
  const int z = blockIdx.z;                // slot g * B + b
  const int g = z / B;
  const Window win = live_tiles(i0, ROWS, KEYS, n, reach);
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const bool loader = threadIdx.x == 0;  // issues every TMA load of the block

  // Key tile jt's normalized k rows, and its v rows for the block's chunks.
  auto load_k = [&](int jt) {
    sm90::mbar_expect_tx(k_full, lay.boxes * BOX_BYTES);
    for (int c = 0; c < lay.boxes; ++c)
      sm90::tma_load_3d(ks + c * BOX_BYTES, &k_map, 64 * c, jt * KEYS, z, k_full);
  };
  auto load_v = [&](int jt) {
    const int chunks = min(2 * NC, lay.boxes - chunk0);
    sm90::mbar_expect_tx(v_full, chunks * BOX_BYTES);
    for (int c = 0; c < chunks; ++c)
      sm90::tma_load_3d(vs + c * BOX_BYTES, &lv_map, 64 * (chunk0 + c), jt * KEYS, z, v_full);
  };
  if (loader) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(k_full, 1);
    sm90::mbar_init(v_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    sm90::mbar_expect_tx(q_full, lay.boxes * BOX_BYTES);
    for (int c = 0; c < lay.boxes; ++c)
      sm90::tma_load_3d(qs + c * BOX_BYTES, &lv_map, 64 * c, i0, z, q_full);
    load_k(win.j_lo);
    load_v(win.j_lo);
    // The epilogue's bu and td rows into L2 meanwhile.
    const size_t row0 = (size_t)z * n + i0;
    const uint32_t bytes = (uint32_t)(min(ROWS, n - i0) * d * 2);
    prefetch_l2(bu + row0 * d, bytes);
    if (g < L - 1) prefetch_l2(td + row0 * d, bytes);
  }

  const int c_first = NC * w;  // this warpgroup's chunks of the block's O
  // The thread's two rows (wgmma's accumulator fragment) and column pairs.
  const int r_a = 16 * (t / 32) + (t % 32) / 4, r_b = r_a + 8;
  const int cq = 2 * (t % 4);
  const int i_a = i0 + r_a, i_b = i0 + r_b;
  const int ri_a = i_a / side, ci_a = i_a - ri_a * side;
  const int ri_b = i_b / side, ci_b = i_b - ri_b * side;

  float o[NC][sm90::ACC64];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < sm90::ACC64; ++i) o[c][i] = 0.0f;
  float m_a = NEG_MAX, m_b = NEG_MAX, l_a = 0.0f, l_b = 0.0f;
  const uint32_t q_addr = sm90::smem_u32(qs), k_addr = sm90::smem_u32(ks);
  const uint32_t v_addr = sm90::smem_u32(vs);
  const int k_steps = d / 16;

  sm90::mbar_wait(q_full, 0);
  for (int jt = win.j_lo, it = 0; jt < win.j_hi; ++jt, ++it) {
    const int j0 = jt * KEYS;
    // S = Q . K^T over d: K step kk covers columns 16 kk .. 16 kk + 15, in
    // box kk / 4, 32 bytes further along its 128-byte rows each step.
    float s[sm90::ACC64];
#pragma unroll
    for (int i = 0; i < sm90::ACC64; ++i) s[i] = 0.0f;
    sm90::mbar_wait(k_full, it & 1);
    sm90::fence_acc(s);
    sm90::wgmma_fence();
    for (int kk = 0; kk < k_steps; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      sm90::wgmma_m64n64k16_ss(s, sm90::smem_desc(q_addr + off, 16, 1024),
                               sm90::smem_desc(k_addr + off, 16, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(s);
    // Both warpgroups are past this tile's k rows: the loader refills the
    // k ring with the next tile's (warpgroup 1 arrives, 0 waits).
    if (w == 1) {
      sm90::named_barrier_arrive(1, THREADS);
    } else {
      sm90::named_barrier_sync(1, THREADS);
      if (loader && jt + 1 < win.j_hi) load_k(jt + 1);
    }

    // Scale, then the masks this tile needs: the diagonal (attend_self
    // off), the radius, key columns past n (zero rows of the map).
#pragma unroll
    for (int i = 0; i < sm90::ACC64; ++i) s[i] = __fmul_rn(s[i], scale);
    const bool diag = !attend_self && j0 < i0 + ROWS && i0 < j0 + KEYS;
    if (diag || reach > 0 || j0 + KEYS > n) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * jj + cq + e;
          float& sa = s[4 * jj + e];
          float& sb = s[4 * jj + 2 + e];
          if (diag) {
            if (j == i_a) sa = SELF_VALUE;
            if (j == i_b) sb = SELF_VALUE;
          }
          if (reach > 0) {
            const int rj = j / side, cj = j - rj * side;
            const int da2 = (ri_a - rj) * (ri_a - rj) + (ci_a - cj) * (ci_a - cj);
            const int db2 = (ri_b - rj) * (ri_b - rj) + (ci_b - cj) * (ci_b - cj);
            if ((float)da2 > r2) sa = NEG_MAX;
            if ((float)db2 > r2) sb = NEG_MAX;
          }
          if (j >= n) sa = sb = NEG_MAX;
        }
      }
    }
    // The online softmax's step for rows a and b.
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

    // O = O * corr + P . V over this warpgroup's chunks (64-column boxes of
    // the v ring); K step k covers keys 16k .. 16k + 15, 2048 bytes on. A
    // warp whose rows kept their max skips the product by 1.
    if (__any_sync(0xffffffffu, corr_a != 1.0f || corr_b != 1.0f)) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[c][4 * jj] = __fmul_rn(o[c][4 * jj], corr_a);
          o[c][4 * jj + 1] = __fmul_rn(o[c][4 * jj + 1], corr_a);
          o[c][4 * jj + 2] = __fmul_rn(o[c][4 * jj + 2], corr_b);
          o[c][4 * jj + 3] = __fmul_rn(o[c][4 * jj + 3], corr_b);
        }
    }
    sm90::mbar_wait(v_full, it & 1);
#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_acc(o[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t vb = v_addr + (c_first + c) * BOX_BYTES;
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        sm90::wgmma_m64n64k16_rs(o[c], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                                 sm90::smem_desc(vb + 2048 * kk, BOX_BYTES, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_acc(o[c]);
    if (w == 1) {  // the same for the v ring
      sm90::named_barrier_arrive(2, THREADS);
    } else {
      sm90::named_barrier_sync(2, THREADS);
      if (loader && jt + 1 < win.j_hi) load_v(jt + 1);
    }
  }

  // Epilogue. Both warpgroups are past their last products before the k
  // and v rings become the staging area.
  sm90::named_barrier_sync(3, THREADS);
  const bool top = g == L - 1;
  if (m_out != nullptr && chunk0 == 0 && w == 0 && t % 4 == 0) {
    if (i_a < n) {
      m_out[(size_t)z * n + i_a] = m_a;
      l_out[(size_t)z * n + i_a] = l_a;
    }
    if (i_b < n) {
      m_out[(size_t)z * n + i_b] = m_b;
      l_out[(size_t)z * n + i_b] = l_b;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w16 = 16 * (warp % 4);  // the warp's first row of the block
  float2* stage = reinterpret_cast<float2*>(ks + warp * STAGE_BYTES);  // [16][32] float2
  const int rw_a = lane / 4;  // the warp's rows of r_a and r_b: rw_a, rw_a + 8
  const float inv_a = __frcp_rn(l_a), inv_b = __frcp_rn(l_b);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int chunk = chunk0 + c_first + c;  // 64-column chunk of d
    if (chunk >= lay.boxes) continue;        // past d: its box was not loaded
    // This chunk's bu and td segments (lane k of 8 takes columns 8k .. 8k+7
    // of rows rw, four rows a pass), loaded before the stage is written.
    uint4 bv[4], tv[4];
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int rw = 4 * pass + lane / 8, k = lane % 8, i = i0 + w16 + rw;
      const size_t off = ((size_t)z * n + i) * d + 64 * chunk + 8 * k;
      bv[pass] = tv[pass] = make_uint4(0, 0, 0, 0);
      if (i < n) {
        bv[pass] = __ldg(reinterpret_cast<const uint4*>(bu + off));
        if (!top) tv[pass] = __ldg(reinterpret_cast<const uint4*>(td + off));
      }
    }
    // cons = O / l into the stage, pair slots XOR-swizzled by row.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int slot = (4 * jj + cq / 2) ^ (rw_a << 2);
      stage[rw_a * 32 + slot] =
          make_float2(div_rn(o[c][4 * jj], l_a, inv_a), div_rn(o[c][4 * jj + 1], l_a, inv_a));
      stage[(rw_a + 8) * 32 + slot] =
          make_float2(div_rn(o[c][4 * jj + 2], l_b, inv_b), div_rn(o[c][4 * jj + 3], l_b, inv_b));
    }
    __syncwarp();
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int rw = 4 * pass + lane / 8, k = lane % 8;
      const int i = i0 + w16 + rw;
      if (i < n) {
        const float4* src = reinterpret_cast<const float4*>(stage + rw * 32 + 4 * (k ^ (rw & 7)));
        const float4 c0 = src[0], c1 = src[1];
        const float cons[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const int qrow = w16 + rw;
        const uint4 qv = *reinterpret_cast<const uint4*>(qs + chunk * BOX_BYTES + qrow * 128 +
                                                         ((k ^ (qrow & 7)) * 16));
        const size_t off = ((size_t)z * n + i) * d + 64 * chunk + 8 * k;
        const bf16* qe = reinterpret_cast<const bf16*>(&qv);
        const bf16* be = reinterpret_cast<const bf16*>(&bv[pass]);
        const bf16* te = reinterpret_cast<const bf16*>(&tv[pass]);
        uint4 ov, cv;
        bf16* oe = reinterpret_cast<bf16*>(&ov);
        bf16* ce = reinterpret_cast<bf16*>(&cv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float tt = top ? 0.0f : __bfloat162float(te[e]);
          const float sum = __fadd_rn(
              __fadd_rn(__fadd_rn(__bfloat162float(qe[e]), __bfloat162float(be[e])), tt), cons[e]);
          // x / 4 is x * 0.25 exactly; the top level divides by 3.
          const float v = top ? __fdiv_rn(sum, 3.0f) : __fmul_rn(sum, 0.25f);
          oe[e] = __float2bfloat16(v);
          ce[e] = __float2bfloat16(cons[e]);
        }
        *reinterpret_cast<uint4*>(out + off) = ov;
        if constexpr (SAVE_CONS) *reinterpret_cast<uint4*>(cons_out + off) = cv;
      }
    }
    __syncwarp();
  }
}

// --- host side ----------------------------------------------------------------

template <bool SAVE_CONS>
int launch_f32(const float* lv, const float* bu, const float* td, float* out, float* m_out,
               float* l_out, float* cons_out, int L, int B, int n, int d, int side, int reach,
               float r2, int attend_self, float scale, cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  const cudaError_t err = sm90::lift_smem_cap(consensus_update_kernel_f32<SAVE_CONS>, lifted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / F32_TI, B, L);
  consensus_update_kernel_f32<SAVE_CONS><<<grid, F32_THREADS, F32Layout(d).bytes, stream>>>(
      lv, bu, td, out, m_out, l_out, cons_out, L, B, n, d, side, reach, r2, attend_self, scale);
  return (int)cudaGetLastError();
}

// A [slots, n, d] bf16 map with the kernel's 64 x 64 box, from a small
// cache: a map depends only on the pointer and the extents, and the
// serving and training loops pass the same few buffers again and again,
// so most calls skip cuTensorMapEncodeTiled.
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int d, int n, int slots) {
  struct Entry {
    const void* ptr;
    int d, n, slots;
    CUtensorMap map;
  };
  constexpr int ENTRIES = 16;
  static Entry cache[ENTRIES];
  static int next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : cache)
    if (e.ptr == ptr && e.d == d && e.n == n && e.slots == slots) {
      *map = e.map;
      return cudaSuccess;
    }
  const cudaError_t err = sm90::make_map(map, ptr, d, n, slots, 64, 64);
  if (err == cudaSuccess) {
    cache[next] = Entry{ptr, d, n, slots, *map};
    next = (next + 1) % ENTRIES;
  }
  return err;
}

// The pre-pass and the main kernel.
template <bool SAVE_CONS>
int launch_bf16(const bf16* lv, const bf16* bu, const bf16* td, bf16* out, float* m_out,
                float* l_out, bf16* cons_out, bf16* khat, int L, int B, int n, int d, int side,
                int reach, float r2, int attend_self, float scale, cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(consensus_update_kernel_bf16<SAVE_CONS>, lifted);
  CUtensorMap lv_map, k_map;
  if (err == cudaSuccess) err = tile_map(&lv_map, lv, d, n, L * B);
  if (err == cudaSuccess) err = tile_map(&k_map, khat, d, n, L * B);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)L * B * n;
  consensus_update_kernel_khat<<<(unsigned)((rows + KHAT_ROWS - 1) / KHAT_ROWS), 32 * KHAT_ROWS,
                                 0, stream>>>(lv, khat, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + ROWS - 1) / ROWS, (d / 64 + 2 * NC - 1) / (2 * NC), L * B);
  consensus_update_kernel_bf16<SAVE_CONS><<<grid, THREADS, Bf16Layout(d).bytes, stream>>>(
      lv_map, k_map, bu, td, out, m_out, l_out, cons_out, L, B, n, d, side, reach, r2,
      attend_self, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lv, bu, out: [L, B, n, d]; td: [L-1, B, n, d]; contiguous, one dtype
// (is_bf16 selects bf16, else f32); m_out, l_out: f32 [L, B, n], both or
// neither; cons_out: [L, B, n, d] in the levels dtype, or NULL (only with
// m_out and l_out); khat: bf16 [L, B, n, d] scratch for the normalized
// keys (bf16 only; NULL for f32); side: patch-grid side (n = side^2 for a
// local radius); radius <= 0 means global consensus. bf16 needs n % 32 ==
// 0, d % 64 == 0, d <= 640 and 16-byte-aligned tensors; f32 n % 16 == 0
// and d % 64 == 0. Returns a cudaError_t.
int consensus_update_fwd(const void* lv, const void* bu, const void* td, void* out,
                         float* m_out, float* l_out, void* cons_out, void* khat, int L, int B,
                         int n, int d, int side, double radius, int attend_self, int is_bf16,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tile = is_bf16 ? 32 : F32_TI;
  if (L < 2 || B < 1 || n % row_tile != 0 || d % 64 != 0 || side < 1 ||
      (m_out == nullptr) != (l_out == nullptr) || (cons_out != nullptr && m_out == nullptr) ||
      (is_bf16 && (khat == nullptr || d > MAX_D)))
    return (int)cudaErrorInvalidValue;
  const int reach = radius > 0 ? (int)(radius + 1.0) * side : 0;
  const float r2 = (float)(radius * radius);
  const float scale = (float)(1.0 / sqrt((double)d));
  if (is_bf16) {
    const auto* x = static_cast<const bf16*>(lv);
    const auto* b = static_cast<const bf16*>(bu);
    const auto* t = static_cast<const bf16*>(td);
    auto* o = static_cast<bf16*>(out);
    auto* k = static_cast<bf16*>(khat);
    return cons_out != nullptr
               ? launch_bf16<true>(x, b, t, o, m_out, l_out, static_cast<bf16*>(cons_out), k, L,
                                   B, n, d, side, reach, r2, attend_self, scale, s)
               : launch_bf16<false>(x, b, t, o, m_out, l_out, nullptr, k, L, B, n, d, side,
                                    reach, r2, attend_self, scale, s);
  }
  const auto* x = static_cast<const float*>(lv);
  const auto* b = static_cast<const float*>(bu);
  const auto* t = static_cast<const float*>(td);
  auto* o = static_cast<float*>(out);
  return cons_out != nullptr
             ? launch_f32<true>(x, b, t, o, m_out, l_out, static_cast<float*>(cons_out), L, B, n,
                                d, side, reach, r2, attend_self, scale, s)
             : launch_f32<false>(x, b, t, o, m_out, l_out, nullptr, L, B, n, d, side, reach, r2,
                                 attend_self, scale, s);
}

const char* consensus_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
