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
// bf16 design (Hopper, sm_90a; the pre-pass and the key loop are
// sm90_attn.cuh's, shared with K4's bf16 forward, banded_consensus.cu):
//   * A pre-pass writes k = normalize(levels) rounded to bf16, [L, B, n, d],
//     to a scratch the caller allocates (one warp a row, 16-byte loads): the
//     key rows are normalized once a launch, not once for every query block
//     that reads them.
//   * The main kernel gives a block 64 query rows of one (level, image) and
//     up to 512 output columns (d > 512 takes a second block of columns).
//     Up to d = 640 its thread 0 loads the block's q rows once and then,
//     tile after tile of 64 keys, the normalized k rows and the v rows by
//     TMA (128-byte swizzle) into two single-stage rings, each an mbarrier
//     that the load completes and a named barrier both warpgroups pass
//     before it is refilled: k for tile j + 1 loads while tile j's softmax
//     and P . V run, v for tile j + 1 while tile j + 1's scores do; the
//     second block of columns (d = 576, 640) recomputes the same scores.
//   * Past d = 640 (the wide instance, up to d = 1024: glom_tpu's
//     imagenet224-pod width) the two column blocks of each 64 query rows
//     run as a cluster (sm90_attn.cuh's attn_pair_*): block g holds only
//     its 512 columns of q, k and v, sums the partial scores over them, and
//     the pair adds the two partials after an exchange through distributed
//     shared memory, so each score is computed once. Its warpgroups split
//     the keys (32 each) and exchange their row maxima, sums and P; each
//     loads its own k (its 32 keys x the block's 512 columns) and v (64
//     keys x its 256 columns) a tile at a time with one TMA load each, the
//     next tile's as soon as this tile's products retire. The rest below
//     is the narrow form's.
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
//   * Tile shapes, the K order and the rounding points are fixed and
//     nothing is atomic: a row's bits depend neither on B, nor on the grid,
//     nor on which launch computed them. Up to d = 640 no sum is split
//     across blocks; past it each score is split across the cluster's two
//     blocks, columns 0 .. 511 and 512 .. d - 1, each half summed in the
//     tensor core's fixed K order and the two added once, rank 0's first
//     (an addition of two terms, so both blocks form the same bits), and a
//     row's softmax sum across its two warpgroups' 32 keys, keys 0 .. 31
//     first.
// Kept out of device memory: the [n, n] scores and probabilities and the
// f32 output sums; the attention output `cons` unless asked for.
//
// f32 runs on the CUDA cores with FMA (the reference's f32 arithmetic): a
// block owns 16 query rows, normalizes each 16-key tile's k rows as it
// loads them, and keeps the online softmax's accumulator in shared memory.
// Where tiles of 16 keys no longer fit beside the query rows and the
// accumulator (from d = 896 on; 265,856 bytes at d = 1024), key tiles take
// 8 rows.
//
// The output must not alias the input: other row tiles still read it.
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "sm90_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;

using sm90::NEG_MAX;
using sm90::SELF_VALUE;

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
constexpr int F32_TI = 16, F32_PAD = 1;  // PAD spreads rows over banks
// Key rows a tile: 16, or 8 where 16 do not fit (F32_WIDE_TJ).
constexpr int F32_TJ = 16, F32_WIDE_TJ = 8;

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// Shared-memory layout, every section 128-byte aligned.
template <int TJ_>
struct F32Layout {
  static constexpr int TI = F32_TI, TJ = TJ_;
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

template <bool SAVE_CONS, int TJ>
__global__ void __launch_bounds__(F32_THREADS)
consensus_update_kernel_f32(const float* __restrict__ lv, const float* __restrict__ bu,
                            const float* __restrict__ td, float* __restrict__ out,
                            float* __restrict__ m_out, float* __restrict__ l_out,
                            float* __restrict__ cons_out, int L, int B, int n, int d, int side,
                            int reach, float r2, int attend_self, float scale) {
  constexpr int TI = F32_TI;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout<TJ> lay(d);
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

    // S = qs . ks^T (f32), one score per thread (half the threads at TJ = 8).
    static_assert(TI * TJ <= F32_THREADS, "one score per thread");
    if (tid < TI * TJ) {
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

constexpr int ROWS = sm90::ATTN_ROWS;
constexpr int KEYS = sm90::ATTN_KEYS;
constexpr int BOX_BYTES = sm90::ATTN_BOX;
constexpr int NC = sm90::ATTN_NC;  // a warpgroup's 64-column chunks; a block's 2 NC
constexpr int MAX_D = sm90::ATTN_MAX_D;  // the wide instance past sm90::ATTN_NARROW_D

// The wide instance's epilogue operands: bu and td as wide_map maps (2
// chunks x 64 rows a box), loaded into the freed k and v as the key loop
// ends. Unused (zero) in the narrow instance.
struct EpilogueMaps {
  CUtensorMap bu, td;
};

// Grid: (row blocks, column groups of 512, L * B). lv_map and k_map are
// [L * B, n, d] bf16 maps with a 64 x 64 box (tile_map); WIDE: 4-D maps
// of [L * B, d / 64, n, 64] (wide_map) with boxes of 4 chunks x 64 rows
// (lv) and 8 chunks x 32 rows (k), and the two column groups of each (row
// block, slot) run as a cluster.
template <bool SAVE_CONS, bool WIDE>
__global__ void __launch_bounds__(sm90::ATTN_THREADS, 1)
consensus_update_kernel_bf16(const __grid_constant__ CUtensorMap lv_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ EpilogueMaps epi,
                             const bf16* __restrict__ bu, const bf16* __restrict__ td,
                             bf16* __restrict__ out, float* __restrict__ m_out,
                             float* __restrict__ l_out, bf16* __restrict__ cons_out, int L, int B,
                             int n, int d, int side, int reach, float r2, int attend_self,
                             float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int boxes = d / 64;
  const int i0 = blockIdx.x * ROWS;
  const int chunk0 = 2 * NC * blockIdx.y;  // the block's first 64-column chunk
  const int z = blockIdx.z;                // slot g * B + b
  const int g = z / B;
  const Window win = live_tiles(i0, ROWS, KEYS, n, reach);
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const int tiles = win.j_hi - win.j_lo;

  // The thread's two rows (wgmma's accumulator fragment) and column pairs.
  const int r_a = 16 * (t / 32) + (t % 32) / 4, r_b = r_a + 8;
  const int cq = 2 * (t % 4);
  const int i_a = i0 + r_a, i_b = i0 + r_b;
  const int ri_a = i_a / side, ci_a = i_a - ri_a * side;
  const int ri_b = i_b / side, ci_b = i_b - ri_b * side;

  // The masks a key tile needs: the diagonal (attend_self off), the
  // radius, key columns past n (zero rows of the map). s holds keys key0 +
  // 8 jj + cq + {0, 1} of the tile (the accumulator fragment, m64n64 or the
  // wide form's m64n32).
  auto mask = [&](int it, auto& s, int key0 = 0) {
    constexpr int JJ = sizeof(s) / sizeof(float) / 4;
    const int j0 = (win.j_lo + it) * KEYS;
    const bool diag = !attend_self && j0 < i0 + ROWS && i0 < j0 + KEYS;
    if (diag || reach > 0 || j0 + KEYS > n) {
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + key0 + 8 * jj + cq + e;
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
  };

  float o[NC][sm90::ACC64];
  float m_a, m_b, l_a, l_b;
  unsigned char* qs = smem;  // the epilogue's q: box chunk - q_chunk0
  unsigned char* stage_base;
  int q_chunk0;
  if constexpr (WIDE) {
    using S = sm90::AttnPairSmem;
    const uint32_t rank = sm90::cluster_rank();  // == blockIdx.y: the cluster spans y
    const int nb = min(2 * NC, boxes - chunk0);  // the block's boxes of d
    sm90::attn_pair_init(smem);
    if (threadIdx.x == 0) {  // the epilogue's bu and td rows into L2 meanwhile
      const size_t row0 = (size_t)z * n + i0;
      const uint32_t bytes = (uint32_t)(min(ROWS, n - i0) * d * 2);
      sm90::prefetch_l2(bu + row0 * d, bytes);
      if (g < L - 1) sm90::prefetch_l2(td + row0 * d, bytes);
    }
    const int row0 = win.j_lo * KEYS;  // key tile it's first row: row0 + KEYS it
    // Pair `pair` of the warpgroup's chunks of bu and td: [bu 2 chunks][td 2 chunks].
    auto load_epi = [&](unsigned char* dst, int pair, uint64_t* bar) {
      const int chunk = chunk0 + NC * w + 2 * pair;
      sm90::mbar_expect_tx(bar, (g < L - 1 ? 2 : 1) * 2 * BOX_BYTES);
      sm90::tma_load_4d(dst, &epi.bu, 0, i0, chunk, z, bar);
      if (g < L - 1) sm90::tma_load_4d(dst + 2 * BOX_BYTES, &epi.td, 0, i0, chunk, z, bar);
    };
    sm90::attn_pair_loop(
        o, m_a, m_b, l_a, l_b, smem, tiles, nb, scale, rank,
        [&](unsigned char* dst, int half, uint64_t* bar) {
          sm90::tma_load_4d(dst, &lv_map, 0, i0, chunk0 + NC * half, z, bar);
        },
        [&](unsigned char* dst, int it, int kw, uint64_t* bar) {
          sm90::tma_load_4d(dst, &k_map, 0, row0 + KEYS * it + sm90::PAIR_KEYS * kw, chunk0, z,
                            bar);
        },
        [&](unsigned char* dst, int it, int kw, uint64_t* bar) {
          sm90::tma_load_4d(dst, &lv_map, 0, row0 + KEYS * it, chunk0 + NC * kw, z, bar);
        },
        mask,
        // The epilogue's bu (and, below the top level, td) rows of the
        // warpgroup's first two chunks into its freed k, of its last two
        // into its freed v: the first pair's load overlaps the last P . V,
        // the second's the first pair's epilogue.
        [&](unsigned char* dst, uint64_t* bar) { load_epi(dst, 0, bar); },
        [&](unsigned char* dst, uint64_t* bar) { load_epi(dst, 1, bar); });
    stage_base = smem + S::XS_OFF;
    q_chunk0 = chunk0;
  } else {
    using Lay = sm90::AttnSmem;
    const Lay lay(d);
    unsigned char* ks = smem + lay.k_off;
    unsigned char* vs = smem + lay.v_off;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
    uint64_t* q_full = bars;
    uint64_t* k_full = bars + 1;
    uint64_t* v_full = bars + 2;
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
      for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + i, 1);
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
      sm90::prefetch_l2(bu + row0 * d, bytes);
      if (g < L - 1) sm90::prefetch_l2(td + row0 * d, bytes);
    }
    sm90::attn_key_loop(o, m_a, m_b, l_a, l_b, qs, ks, vs, q_full, k_full, v_full, tiles, d,
                        scale, [&](int it) { load_k(win.j_lo + it); },
                        [&](int it) { load_v(win.j_lo + it); }, mask);
    stage_base = ks;
    q_chunk0 = 0;
  }

  const int c_first = NC * w;  // this warpgroup's chunks of the block's O

  // Epilogue (the staging area is free: the key loop ended on a barrier).
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
  float2* stage = reinterpret_cast<float2*>(stage_base + warp * sm90::ATTN_STAGE_BYTES);
  const float inv_a = __frcp_rn(l_a), inv_b = __frcp_rn(l_b);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int chunk = chunk0 + c_first + c;  // 64-column chunk of d
    const unsigned char* epi_base = nullptr;  // the wide form's bu and td of this chunk pair
    if constexpr (WIDE) {  // waited for past d too: no load may land after the block ends
      using S = sm90::AttnPairSmem;
      epi_base = c < 2 ? smem + S::K_OFF + w * sm90::PAIR_KTILE
                       : smem + S::V_OFF + w * sm90::PAIR_VTILE;
      if (c % 2 == 0) sm90::mbar_wait(reinterpret_cast<uint64_t*>(smem + S::BAR_OFF) +
                                      S::E_FULL + 2 * w + c / 2, 0);
    }
    if (chunk >= boxes) continue;  // past d: its box was not loaded
    // This chunk's bu and td segments (lane k of 8 takes columns 8k .. 8k+7
    // of rows rw, four rows a pass), loaded before the stage is written.
    uint4 bv[4], tv[4];
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int rw = 4 * pass + lane / 8, k = lane % 8, i = i0 + w16 + rw;
      bv[pass] = tv[pass] = make_uint4(0, 0, 0, 0);
      if constexpr (WIDE) {  // the warpgroup's rows load_epi loaded (zeros past n)
        const int qrow = w16 + rw;
        const unsigned char* seg = epi_base + (c % 2) * BOX_BYTES + qrow * 128 +
                                   ((k ^ (qrow & 7)) * 16);
        bv[pass] = *reinterpret_cast<const uint4*>(seg);
        if (!top) tv[pass] = *reinterpret_cast<const uint4*>(seg + 2 * BOX_BYTES);
      } else {
        const size_t off = ((size_t)z * n + i) * d + 64 * chunk + 8 * k;
        if (i < n) {
          bv[pass] = __ldg(reinterpret_cast<const uint4*>(bu + off));
          if (!top) tv[pass] = __ldg(reinterpret_cast<const uint4*>(td + off));
        }
      }
    }
    sm90::stage_cons(o[c], l_a, inv_a, l_b, inv_b, stage);  // cons = O / l
    __syncwarp();
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int rw = 4 * pass + lane / 8, k = lane % 8;
      const int i = i0 + w16 + rw;
      if (i < n) {
        float cons[8];
        sm90::staged8(stage, rw, k, cons);
        const int qrow = w16 + rw;
        const uint4 qv = *reinterpret_cast<const uint4*>(
            qs + (chunk - q_chunk0) * BOX_BYTES + qrow * 128 + ((k ^ (qrow & 7)) * 16));
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
  if constexpr (WIDE) sm90::cluster_sync();  // the peer no longer reads or writes here
}

// --- host side ----------------------------------------------------------------

template <bool SAVE_CONS, int TJ>
int launch_f32_tiles(const float* lv, const float* bu, const float* td, float* out,
                     float* m_out, float* l_out, float* cons_out, int L, int B, int n, int d,
                     int side, int reach, float r2, int attend_self, float scale,
                     cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  const cudaError_t err = sm90::lift_smem_cap(consensus_update_kernel_f32<SAVE_CONS, TJ>, lifted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / F32_TI, B, L);
  consensus_update_kernel_f32<SAVE_CONS, TJ><<<grid, F32_THREADS, F32Layout<TJ>(d).bytes,
                                               stream>>>(
      lv, bu, td, out, m_out, l_out, cons_out, L, B, n, d, side, reach, r2, attend_self, scale);
  return (int)cudaGetLastError();
}

template <bool SAVE_CONS>
int launch_f32(const float* lv, const float* bu, const float* td, float* out, float* m_out,
               float* l_out, float* cons_out, int L, int B, int n, int d, int side, int reach,
               float r2, int attend_self, float scale, cudaStream_t stream) {
  return F32Layout<F32_TJ>(d).bytes > sm90::SMEM_OPTIN
             ? launch_f32_tiles<SAVE_CONS, F32_WIDE_TJ>(lv, bu, td, out, m_out, l_out, cons_out,
                                                        L, B, n, d, side, reach, r2,
                                                        attend_self, scale, stream)
             : launch_f32_tiles<SAVE_CONS, F32_TJ>(lv, bu, td, out, m_out, l_out, cons_out, L,
                                                   B, n, d, side, reach, r2, attend_self, scale,
                                                   stream);
}

// A [slots, n, d] bf16 map with the kernel's 64 x 64 box (cached).
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int d, int n, int slots) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)slots};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * n * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return sm90::cached_map(map, ptr, dims, strides, box);
}

// The pre-pass and the main kernel (the wide instance past ATTN_NARROW_D).
template <bool SAVE_CONS, bool WIDE>
int launch_bf16(const bf16* lv, const bf16* bu, const bf16* td, bf16* out, float* m_out,
                float* l_out, bf16* cons_out, bf16* khat, int L, int B, int n, int d, int side,
                int reach, float r2, int attend_self, float scale, cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(consensus_update_kernel_bf16<SAVE_CONS, WIDE>, lifted);
  CUtensorMap lv_map, k_map;
  if constexpr (WIDE) {
    if (err == cudaSuccess) err = sm90::wide_map(&lv_map, lv, d, n, L * B, KEYS, NC);
    if (err == cudaSuccess)
      err = sm90::wide_map(&k_map, khat, d, n, L * B, sm90::PAIR_KEYS, sm90::PAIR_BOXES);
  } else {
    if (err == cudaSuccess) err = tile_map(&lv_map, lv, d, n, L * B);
    if (err == cudaSuccess) err = tile_map(&k_map, khat, d, n, L * B);
  }
  if (err != cudaSuccess) return (int)err;
  err = sm90::launch_khat(lv, khat, (size_t)L * B * n, d, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + ROWS - 1) / ROWS, (d / 64 + 2 * NC - 1) / (2 * NC), L * B);
  EpilogueMaps epi = {};
  if constexpr (WIDE) {
    err = sm90::wide_map(&epi.bu, bu, d, n, L * B, KEYS, 2);
    if (err == cudaSuccess) err = sm90::wide_map(&epi.td, td, d, n, (L - 1) * B, KEYS, 2);
    if (err != cudaSuccess) return (int)err;
    return (int)sm90::launch_pair(consensus_update_kernel_bf16<SAVE_CONS, true>, grid, 1, stream,
                                  lv_map, k_map, epi, bu, td, out, m_out, l_out, cons_out, L, B,
                                  n, d, side, reach, r2, attend_self, scale);
  }
  consensus_update_kernel_bf16<SAVE_CONS, false><<<grid, sm90::ATTN_THREADS,
                                                   sm90::AttnSmem(d).bytes, stream>>>(
      lv_map, k_map, epi, bu, td, out, m_out, l_out, cons_out, L, B, n, d, side, reach, r2,
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
// 0 and 16-byte-aligned tensors, f32 n % 16 == 0; both d % 64 == 0 and d
// <= 1024. Returns a cudaError_t.
int consensus_update_fwd(const void* lv, const void* bu, const void* td, void* out,
                         float* m_out, float* l_out, void* cons_out, void* khat, int L, int B,
                         int n, int d, int side, double radius, int attend_self, int is_bf16,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tile = is_bf16 ? 32 : F32_TI;
  if (L < 2 || B < 1 || n % row_tile != 0 || d % 64 != 0 || d > MAX_D || side < 1 ||
      (m_out == nullptr) != (l_out == nullptr) || (cons_out != nullptr && m_out == nullptr) ||
      (is_bf16 && khat == nullptr))
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
    auto* c = static_cast<bf16*>(cons_out);
    if (sm90::attn_wide(d))
      return c != nullptr ? launch_bf16<true, true>(x, b, t, o, m_out, l_out, c, k, L, B, n, d,
                                                    side, reach, r2, attend_self, scale, s)
                          : launch_bf16<false, true>(x, b, t, o, m_out, l_out, nullptr, k, L, B,
                                                     n, d, side, reach, r2, attend_self, scale,
                                                     s);
    return c != nullptr ? launch_bf16<true, false>(x, b, t, o, m_out, l_out, c, k, L, B, n, d,
                                                   side, reach, r2, attend_self, scale, s)
                        : launch_bf16<false, false>(x, b, t, o, m_out, l_out, nullptr, k, L, B,
                                                    n, d, side, reach, r2, attend_self, scale,
                                                    s);
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

// The wide instance's launch (sm90::launch_pair): blocks of
// sm90::ATTN_THREADS threads and sm90::AttnPairSmem::BYTES of shared
// memory in clusters of two along grid y, and how many such clusters the
// device holds at once (cudaOccupancyMaxActiveClusters). Returns a
// cudaError_t.
int consensus_update_wide_launch(int* threads, int* smem_bytes, int* cluster, int* clusters) {
  static bool lifted[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(consensus_update_kernel_bf16<false, true>, lifted);
  *threads = sm90::ATTN_THREADS;
  *smem_bytes = sm90::AttnPairSmem::BYTES;
  *cluster = sm90::PAIR_CLUSTER;
  if (err == cudaSuccess)
    err = sm90::pair_clusters(consensus_update_kernel_bf16<false, true>, 1, clusters);
  return (int)err;
}

const char* consensus_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
