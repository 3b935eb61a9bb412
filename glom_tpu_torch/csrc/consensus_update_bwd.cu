// K2 backward: the VJP of consensus attention fused with the 4-way mean,
// level-major [L, B, n, d].
//
// With dcons = g / div (div = 4, or 3 at the top level g = L-1), the
// forward's row statistics m, l and p_ij = exp(s_ij - m_i) / l_i:
//
//   dP_ij = dcons_i . v_j                dd_i = sum_j p_ij dP_ij
//   ds_ij = p_ij (dP_ij - dd_i)          (0 on the diagonal without attend_self)
//   dq_i  = scale sum_j ds_ij k_j        dv_j = sum_i p_ij dcons_i
//   dk_j  = scale sum_i ds_ij q_i
//   dlevels = dcons + dq + dv + normVJP(dk),   dmean = dcons (d bu; d td is
//   its first L-1 levels)
//
// with q = v = levels and k = l2norm(levels). dv uses the unmasked p (the
// diagonal's constant score still weights v); masked pairs have p = 0.
//
// The combine (the whole-loop VJP): the output cotangent of level g is not
// one stream but three, read in place from the loop's buffers and summed in
// f32 before the divide, never rounded in between:
//
//   cot[g] = dg[g] + [g < L-1] dx_bu[g+1] + [g >= 1] dx_td[g-1],
//   dcons = cot / div
//
// dg is the previous (later) iteration's dlevels, dx_bu [L, B, n, d] the
// bottom-up FFW's input cotangent by carry slot (slot g+1 is level g; slot
// 0, the tokens, is not read), dx_td [L-1, B, n, d] the top-down one (slot
// g-1 is level g). Level 0 has no top-down stream, the top level no
// bottom-up one (and divides by 3). The loop's first backward iteration
// passes no streams: cot = dg. dmean is the f32 dcons rounded once; the
// f32 dcons itself enters dlevels.
//
// The one-sweep form (long rows, glom_tpu's _consensus_bwd_onesweep): the
// forward also saved the attention output cons, so D_i = sum_j p_ij dP_ij
// equals dcons_i . cons_i, a row-local dot of the unrounded f32 dcons = g *
// (1 / div) with the rounded cons, and the dq pass sweeps the key tiles
// once. Its epilogue rounds the partial g / div + dv + normVJP(dk) to the
// levels type, then adds the f32 dq and rounds again, glom_tpu's rounding
// points; no dmean is written (the caller forms g / div, as glom_tpu's
// _fused_bwd). The TPU kernel keeps the whole row's f32 dq resident in VMEM
// across every key tile (8 MB a level and image at n = 4096, d = 512); here
// the dq pass owns its query rows' dq, so no block shares a sum and no float
// atomics are needed.
//
// Replaces: glom_tpu/kernels/consensus_update.py:_consensus_bwd_small_kernel
// (one tile, n <= 512), :_consensus_bwd_dq_kernel and
// :_consensus_bwd_dkv_kernel (two passes, any n),
// :_consensus_bwd_onesweep_kernel (long rows, with the saved cons), and
// glom_tpu/kernels/fused_loop.py:_cons_bwd_combine_kernel (the three-stream
// combine, single tile there). The single-tile form needs the whole f32 [n,
// n] score tile in fast memory: 256 KB at n = 256, more than a block's 227 KB
// of shared memory. So a dq pass (one block a query tile) and a key-side
// pass (one block a key tile) cover every n, and only f32 dq, dd, (bf16)
// dv and the rounded dcons pass between them. Both skip tiles outside the
// radius band with the forward's window arithmetic. Rounding points are
// the TPU single-tile kernel's: k is normalized in f32 and rounded to the
// compute type, dcons is rounded before the products that take it, p (for
// dv) and ds are rounded before theirs, every sum is f32, and dlevels is
// rounded once (twice in the one-sweep form, as above).
//
// Three instances, which the C entries derive from the dtype and shape
// (instance_for; kernels/consensus_update.py:k2_bwd_instance repeats the
// rule to allocate the scratches):
//
//   * "wgmma", bf16 at n % 32 == 0, d % 64 == 0, d <= 640, on Hopper's
//     tensor cores (sm_90a; the shapes, barriers and pre-pass are
//     sm90_attn.cuh's, as K2's bf16 forward):
//       - a pre-pass, one warp a row, writes k = normalize(levels) rounded
//         to a bf16 scratch the caller allocates, the rounded dcons (from
//         the streams, in the combine) and, in the one-sweep form, D. The
//         attention kernels then TMA-load both and never normalise a tile
//         again (the CUDA-core form normalised each key tile once for every
//         block that read it: 128 times a key row at n = 4096);
//       - the dq pass: a block takes 64 query rows of one (level, image) and
//         two warpgroups. Per tile of NT keys (32; 16 past d = 512, where
//         four tiles of 64 rows exceed shared memory) both warpgroups
//         compute the whole S = Q . k^T and dP = dcons . v^T (wgmma
//         m64nNTk16, both operands K-major), p from the saved m, l (no
//         online softmax) and ds in registers, and each accumulates its half
//         of dq's columns, dq += ds . k with ds rounded as the register A
//         operand and k read MN-major (as the forward reads V). Q and dcons
//         stay resident; k rides a two-stage ring, v a single stage;
//       - the key side in two passes, because dv and dk of 64 keys x 512
//         columns in f32 are 2 x 128 KB, the SM's whole register file: the
//         dv pass (S^T = k_j . Q_i^T, dv += p^T . dcons_i with p^T from the
//         S^T accumulator) writes f32 dv; the dk pass (S^T, dP^T = v_j .
//         dcons_i^T, dk += ds^T . Q_i) applies the norm VJP and writes the
//         complete dlevels (and dmean), reading f32 dq and dv. A block holds
//         64 key rows (k and v resident) and streams NT-row query tiles.
//     Products: the two-pass forms compute ten a pair (s and dP twice, dq;
//     s, dv; s, dP, dk), the one-sweep eight; each warpgroup of the dq and
//     key passes recomputes the block's whole S (and dP), so the tensor
//     cores run 17 (two-pass) or 13 (one-sweep) products' worth, where the
//     TPU kernels need five.
//   * "wgmma_wide", bf16 at 640 < d <= 1024 (glom_tpu's imagenet224-pod
//     width), the same pre-pass and passes with each 64 rows a cluster of
//     two blocks, block g holding columns 512 g .. 512 g + 511 of d (see
//     "the wide instance" below): the pair adds each score tile's two
//     halves once, so the tensor cores run the design's ten (eight)
//     products, and the dk pass applies the norm VJP and writes dlevels;
//   * "fma", f32, the parity instance, on the CUDA cores: the dq pass
//     streams 16-key tiles twice (dd, then ds and dq += ds . k in shared
//     memory), normalising each tile's keys as it loads them; the dkv pass
//     streams 16-query tiles once for dv and dk and applies the norm VJP.
//
// Bound on the H100: tensor-core operations. At the flagship bucket-8 shape
// ([6, 8, 256, 512] bf16) the five products of the single-tile form are
// 16.1 GFLOP, against 50 MB of levels, cotangent, dlevels and dmean (23 MB
// more with the combine's two streams). At the long-row training shape ([6,
// 2, 4096, 512] bf16) the one-sweep kernel's five products are 1031 GFLOP
// against 202 MB of levels, cotangent, cons, m, l and dlevels.
//
// Kept out of device memory: the scores, probabilities and ds, and dk.
// Tile shapes, the K order and the rounding points are fixed and nothing
// is atomic: the results do not depend on the launch.
//
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "sm90_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sm90::NEG_MAX;
using sm90::SELF_VALUE;

// Live tile window [lo, hi) on the other axis for the rows [t0, t0 + extent):
// rows interact only within reach = (floor(radius) + 1) * side positions.
__host__ __device__ __forceinline__ void window(int t0, int extent, int tile, int n_tiles,
                                                int reach, int& lo, int& hi) {
  lo = 0;
  hi = n_tiles;
  if (reach > 0) {
    const int a = t0 - reach, b = t0 + extent + reach;
    lo = a <= 0 ? 0 : a / tile;
    hi = min((b + tile - 1) / tile, n_tiles);
  }
}

// ================================================== f32: "fma", the CUDA cores

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
// dq pass: TI query rows a block, TJ key rows a step. dkv pass: KJ key rows
// a block, KI query rows a step. All are F32_T, or F32_WIDE_T for a pass
// whose layout at F32_T exceeds a block's shared memory (the dkv pass from
// d = 640 on, the dq pass past d = 704). PAD spreads rows over banks.
constexpr int F32_T = 16, F32_WIDE_T = 8, PAD = 1;

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// The forward's masks on the scaled score of query i and key j.
__device__ __forceinline__ float masked(float s, int i, int j, int side, int reach, float r2,
                                       int attend_self) {
  if (!attend_self && i == j) s = SELF_VALUE;
  if (reach > 0) {
    const int ri = i / side, ci = i - ri * side, rj = j / side, cj = j - rj * side;
    const int dist2 = (ri - rj) * (ri - rj) + (ci - cj) * (ci - cj);
    if ((float)dist2 > r2) s = NEG_MAX;
  }
  return s;
}

// The f32 output cotangent of level g at element idx (see the combine
// above); plane = B * n * d elements per level. Without streams it is dg.
__device__ __forceinline__ float cotangent(const float* gout, const float* dx_bu,
                                           const float* dx_td, size_t idx, size_t plane, int g,
                                           int L) {
  float c = gout[idx];
  if (dx_bu != nullptr) {
    if (g < L - 1) c += dx_bu[idx + plane];
    if (g >= 1) c += dx_td[idx - plane];
  }
  return c;
}

// ds on the diagonal is 0 without attend_self: its score was replaced by a
// constant, so no gradient flows through it.
__device__ __forceinline__ float zero_diag(float ds, int i, int j, int attend_self) {
  return (!attend_self && i == j) ? 0.0f : ds;
}

// Raw rows into vs and k = row / max(||row||, 1e-12) into ks, a warp a row,
// exactly as the forward normalizes them.
__device__ __forceinline__ void load_rows_and_k(const float* src, int rows, int d, int ld,
                                                float* vs, float* ks, int warp, int lane) {
  for (int r = warp; r < rows; r += WARPS) {
    const float* row = src + (size_t)r * d;
    float ss = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float v = row[c];
      vs[r * ld + c] = v;
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float denom = fmaxf(sqrtf(ss), 1e-12f);
    for (int c = lane; c < d; c += 32) ks[r * ld + c] = vs[r * ld + c] / denom;
  }
}

// out[R x C] (pitch ldo) = A[R x d] . B[C x d]^T, by all threads.
template <int R, int C>
__device__ __forceinline__ void gemm_abt(const float* A, const float* B, int ld, int d,
                                         float* out, int ldo) {
  for (int e = threadIdx.x; e < R * C; e += THREADS) {
    const int r = e / C, c = e - r * C;
    float s = 0.0f;
    for (int k = 0; k < d; ++k) s = fmaf(A[r * ld + k], B[c * ld + k], s);
    out[r * ldo + c] = s;
  }
}

// acc[R x d] (pitch ldacc) += P[R x K] . V[K x d]. With P2, a second
// product acc2 += P2 . V2 shares the threads.
template <int R, int K>
__device__ __forceinline__ void gemm_acc(const float* P, int ldp, const float* V, int ld, int d,
                                         float* acc, int ldacc, const float* P2, const float* V2,
                                         float* acc2) {
  const int n_products = P2 != nullptr ? 2 : 1;
  for (int e = threadIdx.x; e < n_products * R * d; e += THREADS) {
    const bool second = e >= R * d;
    const int ee = second ? e - R * d : e;
    const int r = ee / d, c = ee - r * d;
    const float* Pp = second ? P2 : P;
    const float* Vp = second ? V2 : V;
    float* a = second ? acc2 : acc;
    float pv = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) pv = fmaf(Pp[r * ldp + k], Vp[k * ld + c], pv);
    a[r * ldacc + c] += pv;
  }
}

template <int TI, int TJ>
struct DqLayout {
  int ld, ldacc, lds;
  size_t dc_off, k_off, v_off, acc_off, s_off, dp_off, ds_off, st_off, bytes;
  __host__ __device__ explicit DqLayout(int d) : ld(d + PAD), ldacc(d + 4), lds(TJ + 4) {
    dc_off = align128(sizeof(float) * TI * ld);  // after the q tile
    k_off = dc_off + align128(sizeof(float) * TI * ld);
    v_off = k_off + align128(sizeof(float) * TJ * ld);
    acc_off = v_off + align128(sizeof(float) * TJ * ld);
    s_off = acc_off + align128(sizeof(float) * TI * ldacc);
    dp_off = s_off + align128(sizeof(float) * TI * lds);
    ds_off = dp_off + align128(sizeof(float) * TI * lds);
    st_off = ds_off + align128(sizeof(float) * TI * lds);
    bytes = st_off + align128(sizeof(float) * 3 * TI);
  }
};

template <bool ONESWEEP, int TI, int TJ>
__global__ void __launch_bounds__(THREADS)
consensus_bwd_dq_kernel(const float* __restrict__ lv, const float* __restrict__ gout,
                        const float* __restrict__ dx_bu, const float* __restrict__ dx_td,
                        const float* __restrict__ cons_in, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, float* __restrict__ dq_out,
                        float* __restrict__ dd_out, float* __restrict__ dcons_out, int L, int B,
                        int n, int d, int side, int reach, float r2, int attend_self,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DqLayout<TI, TJ> lay(d);
  float* qs = reinterpret_cast<float*>(smem);                   // [TI][ld] query rows
  float* dcs = reinterpret_cast<float*>(smem + lay.dc_off);     // [TI][ld] dcons
  float* ks = reinterpret_cast<float*>(smem + lay.k_off);       // [TJ][ld] normalized k
  float* vs = reinterpret_cast<float*>(smem + lay.v_off);       // [TJ][ld] raw rows (v)
  float* acc = reinterpret_cast<float*>(smem + lay.acc_off);    // [TI][ldacc] dq
  float* S = reinterpret_cast<float*>(smem + lay.s_off);        // [TI][lds] scores
  float* dP = reinterpret_cast<float*>(smem + lay.dp_off);      // [TI][lds]
  float* DS = reinterpret_cast<float*>(smem + lay.ds_off);      // [TI][lds]
  float* m_row = reinterpret_cast<float*>(smem + lay.st_off);
  float* l_row = m_row + TI;
  float* dd_row = l_row + TI;

  const int i0 = blockIdx.x * TI, b = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float div = g == L - 1 ? 3.0f : 4.0f;
  const size_t slab = ((size_t)g * B + b) * n;  // row offset of levels[g, b]
  const size_t plane = (size_t)B * n * d;
  const float* row0 = lv + slab * d;

  const float inv_div = 1.0f / div;
  for (int e = tid; e < TI * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const size_t idx = (slab + i0 + r) * d + c;
    qs[r * lay.ld + c] = lv[idx];
    // The one-sweep form scales by 1/div, as glom_tpu's one-sweep kernel.
    const float dc = ONESWEEP ? gout[idx] * inv_div
                              : cotangent(gout, dx_bu, dx_td, idx, plane, g, L) / div;
    dcs[r * lay.ld + c] = dc;
    dcons_out[idx] = dc;
    acc[r * lay.ldacc + c] = 0.0f;
  }
  if (tid < TI) {
    m_row[tid] = m_in[slab + i0 + tid];
    l_row[tid] = l_in[slab + i0 + tid];
    if (!ONESWEEP) dd_row[tid] = 0.0f;
  }
  if constexpr (ONESWEEP) {
    // D_i = sum_c dcons_ic cons_ic, a warp a row: dcons against the
    // forward's saved attention output, so dd needs no sweep.
    for (int r = warp; r < TI; r += WARPS) {
      const size_t row = (slab + i0 + r) * d;
      float D = 0.0f;
      for (int c = lane; c < d; c += 32) D = fmaf(gout[row + c] * inv_div, cons_in[row + c], D);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) D += __shfl_xor_sync(0xffffffffu, D, o);
      if (lane == 0) dd_row[r] = D;
    }
  }
  int j_lo, j_hi;
  window(i0, TI, TJ, n / TJ, reach, j_lo, j_hi);
  __syncthreads();

  // Sweep 0 sums dd (the two-pass form only); sweep 1 forms ds with the
  // finished dd and sums dq.
  for (int sweep = ONESWEEP ? 1 : 0; sweep < 2; ++sweep) {
    for (int jt = j_lo; jt < j_hi; ++jt) {
      const int j0 = jt * TJ;
      load_rows_and_k(row0 + (size_t)j0 * d, TJ, d, lay.ld, vs, ks, warp, lane);
      __syncthreads();
      gemm_abt<TI, TJ>(qs, ks, lay.ld, d, S, lay.lds);
      gemm_abt<TI, TJ>(dcs, vs, lay.ld, d, dP, lay.lds);
      __syncthreads();
      if (sweep == 0) {
        if (tid < TI) {
          const int r = tid, i = i0 + r;
          float dd = dd_row[r];
          for (int j = 0; j < TJ; ++j) {
            const float s = masked(S[r * lay.lds + j] * scale, i, j0 + j, side, reach, r2,
                                   attend_self);
            dd += expf(s - m_row[r]) / l_row[r] * dP[r * lay.lds + j];
          }
          dd_row[r] = dd;
        }
      } else {
        for (int e = tid; e < TI * TJ; e += THREADS) {
          const int r = e / TJ, j = e - r * TJ, i = i0 + r;
          const float s = masked(S[r * lay.lds + j] * scale, i, j0 + j, side, reach, r2,
                                 attend_self);
          const float p = expf(s - m_row[r]) / l_row[r];
          const float ds = p * (dP[r * lay.lds + j] - dd_row[r]);
          DS[r * lay.lds + j] = zero_diag(ds, i, j0 + j, attend_self);
        }
        __syncthreads();
        gemm_acc<TI, TJ>(DS, lay.lds, ks, lay.ld, d, acc, lay.ldacc, nullptr, nullptr, nullptr);
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < TI * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    dq_out[(slab + i0 + r) * d + c] = acc[r * lay.ldacc + c] * scale;
  }
  if (tid < TI) dd_out[slab + i0 + tid] = dd_row[tid];
}

template <int KJ, int KI>
struct DkvLayout {
  int ld, ldacc, lds;
  size_t k_off, dv_off, dk_off, q_off, dc_off, s_off, dp_off, p_off, ds_off, st_off, bytes;
  __host__ __device__ explicit DkvLayout(int d) : ld(d + PAD), ldacc(d + 4), lds(KI + 4) {
    k_off = align128(sizeof(float) * KJ * ld);  // after the raw key rows
    dv_off = k_off + align128(sizeof(float) * KJ * ld);
    dk_off = dv_off + align128(sizeof(float) * KJ * ldacc);
    q_off = dk_off + align128(sizeof(float) * KJ * ldacc);
    dc_off = q_off + align128(sizeof(float) * KI * ld);
    s_off = dc_off + align128(sizeof(float) * KI * ld);
    dp_off = s_off + align128(sizeof(float) * KJ * lds);
    p_off = dp_off + align128(sizeof(float) * KJ * lds);
    ds_off = p_off + align128(sizeof(float) * KJ * lds);
    st_off = ds_off + align128(sizeof(float) * KJ * lds);
    bytes = st_off + align128(sizeof(float) * 3 * KI);
  }
};

template <bool ONESWEEP, int KJ, int KI>
__global__ void __launch_bounds__(THREADS)
consensus_bwd_dkv_kernel(const float* __restrict__ lv, const float* __restrict__ gout,
                         const float* __restrict__ dx_bu, const float* __restrict__ dx_td,
                         const float* __restrict__ m_in, const float* __restrict__ l_in,
                         const float* __restrict__ dq_in, const float* __restrict__ dd_in,
                         const float* __restrict__ dcons_in, float* __restrict__ dlv_out,
                         float* __restrict__ dmean_out, int L, int B, int n, int d, int side,
                         int reach, float r2, int attend_self, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvLayout<KJ, KI> lay(d);
  float* xj = reinterpret_cast<float*>(smem);                   // [KJ][ld] raw key rows (v)
  float* kj = reinterpret_cast<float*>(smem + lay.k_off);       // [KJ][ld] normalized k
  float* dv = reinterpret_cast<float*>(smem + lay.dv_off);      // [KJ][ldacc]
  float* dk = reinterpret_cast<float*>(smem + lay.dk_off);      // [KJ][ldacc]
  float* qs = reinterpret_cast<float*>(smem + lay.q_off);       // [KI][ld] query rows
  float* dcs = reinterpret_cast<float*>(smem + lay.dc_off);     // [KI][ld] dcons
  float* S2 = reinterpret_cast<float*>(smem + lay.s_off);       // [KJ][lds] s transposed
  float* dP2 = reinterpret_cast<float*>(smem + lay.dp_off);     // [KJ][lds]
  float* P2 = reinterpret_cast<float*>(smem + lay.p_off);       // [KJ][lds]
  float* DS2 = reinterpret_cast<float*>(smem + lay.ds_off);     // [KJ][lds]
  float* m_row = reinterpret_cast<float*>(smem + lay.st_off);
  float* l_row = m_row + KI;
  float* dd_row = l_row + KI;

  const int j0 = blockIdx.x * KJ, b = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float div = g == L - 1 ? 3.0f : 4.0f;
  const size_t slab = ((size_t)g * B + b) * n;
  const size_t plane = (size_t)B * n * d;
  const float* row0 = lv + slab * d;

  load_rows_and_k(row0 + (size_t)j0 * d, KJ, d, lay.ld, xj, kj, warp, lane);
  for (int e = tid; e < KJ * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    dv[r * lay.ldacc + c] = 0.0f;
    dk[r * lay.ldacc + c] = 0.0f;
  }
  int i_lo, i_hi;
  window(j0, KJ, KI, n / KI, reach, i_lo, i_hi);
  __syncthreads();

  for (int it = i_lo; it < i_hi; ++it) {
    const int i0 = it * KI;
    for (int e = tid; e < KI * d; e += THREADS) {
      const int r = e / d, c = e - r * d;
      const size_t idx = (slab + i0 + r) * d + c;
      qs[r * lay.ld + c] = lv[idx];
      dcs[r * lay.ld + c] = dcons_in[idx];
    }
    if (tid < KI) {
      m_row[tid] = m_in[slab + i0 + tid];
      l_row[tid] = l_in[slab + i0 + tid];
      dd_row[tid] = dd_in[slab + i0 + tid];
    }
    __syncthreads();
    gemm_abt<KJ, KI>(kj, qs, lay.ld, d, S2, lay.lds);   // S2[j][i] = k_j . q_i
    gemm_abt<KJ, KI>(xj, dcs, lay.ld, d, dP2, lay.lds);  // dP2[j][i] = v_j . dcons_i
    __syncthreads();
    for (int e = tid; e < KJ * KI; e += THREADS) {
      const int jr = e / KI, ic = e - jr * KI, i = i0 + ic, j = j0 + jr;
      const float s = masked(S2[jr * lay.lds + ic] * scale, i, j, side, reach, r2, attend_self);
      const float p = expf(s - m_row[ic]) / l_row[ic];
      const float ds = p * (dP2[jr * lay.lds + ic] - dd_row[ic]);
      P2[jr * lay.lds + ic] = p;
      DS2[jr * lay.lds + ic] = zero_diag(ds, i, j, attend_self);
    }
    __syncthreads();
    // dv += P2 . dcons, dk += DS2 . q.
    gemm_acc<KJ, KI>(P2, lay.lds, dcs, lay.ld, d, dv, lay.ldacc, DS2, qs, dk);
    __syncthreads();
  }

  // Epilogue, a warp a key row: dk through the VJP of k = x / max(|x|, eps),
  // then dlevels = dcons + dq + dv + normVJP(dk). The one-sweep form adds
  // the partial (g / div + dv + normVJP(dk)) and the dq in that order (in
  // f32 the two roundings are exact); it writes no dmean.
  const float inv_div = 1.0f / div;
  for (int r = warp; r < KJ; r += WARPS) {
    float xx = 0.0f, kx = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float x = xj[r * lay.ld + c];
      xx = fmaf(x, x, xx);
      kx = fmaf(dk[r * lay.ldacc + c] * scale, x, kx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      xx += __shfl_xor_sync(0xffffffffu, xx, o);
      kx += __shfl_xor_sync(0xffffffffu, kx, o);
    }
    const float norm = sqrtf(xx);
    const float inv = 1.0f / fmaxf(norm, 1e-12f);
    for (int c = lane; c < d; c += 32) {
      const size_t idx = (slab + j0 + r) * d + c;
      const float x = xj[r * lay.ld + c];
      const float dkc = dk[r * lay.ldacc + c] * scale;
      const float dxn = dkc * inv - (norm >= 1e-12f ? kx * x * inv * inv / norm : 0.0f);
      if constexpr (ONESWEEP) {
        dlv_out[idx] = gout[idx] * inv_div + dv[r * lay.ldacc + c] + dxn + dq_in[idx];
      } else {
        const float dcons = cotangent(gout, dx_bu, dx_td, idx, plane, g, L) / div;
        dlv_out[idx] = dcons + dq_in[idx] + dv[r * lay.ldacc + c] + dxn;
        dmean_out[idx] = dcons;
      }
    }
  }
}

// ====================================== bf16: "wgmma", Hopper's tensor cores

constexpr int NARROW_D = 640;             // 2 warpgroups x NC chunks of 64 columns (WIDE)
constexpr int RBOX = sm90::ATTN_BOX;      // a resident box: 64 rows x 64 bf16 columns
constexpr int ROWS = sm90::ATTN_ROWS;     // rows a block owns: one wgmma m64
constexpr int WG_THREADS = sm90::ATTN_THREADS;  // two warpgroups

// The streamed tiles: NT rows (the wgmma N of S, the K of the accumulating
// products); a warpgroup's NC 64-column chunks of its accumulator. WIDE (d
// > 512) halves the tile so the resident operands of 64 rows x d fit.
template <bool WIDE>
struct Hop {
  static constexpr int NT = WIDE ? 16 : 32;
  static constexpr int NC = WIDE ? 5 : 4;
  static constexpr int ACC = NT / 2;         // f32 sums a thread holds for m64nNT
  static constexpr int TBOX = NT * 128;      // a streamed box: NT rows x 64 columns
  static constexpr int TILE = 2 * NC * TBOX;  // every chunk an accumulating product reads
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

template <int NT>
__device__ __forceinline__ void wgmma_ss(float (&d)[NT / 2], uint64_t da, uint64_t db) {
  if constexpr (NT == 32) {
    sm90::wgmma_m64n32k16_ss(d, da, db);
  } else {
    sm90::wgmma_m64n16k16_ss(d, da, db);
  }
}

// acc[64 x NT] += A[64 x d] . B[NT x d]^T: A a resident operand (64-row
// boxes), B a streamed tile (NT-row boxes), both K-major; K step kk covers
// columns 16 kk .. 16 kk + 15, in box kk / 4, 32 bytes along its rows.
template <int NT>
__device__ __forceinline__ void ss_product(float (&acc)[NT / 2], uint32_t a, uint32_t b,
                                           int k_steps) {
  for (int kk = 0; kk < k_steps; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss<NT>(acc, sm90::smem_desc(a + (kk / 4) * RBOX + col, 16, 1024),
                 sm90::smem_desc(b + (kk / 4) * (NT * 128) + col, 16, 1024));
  }
}

// acc[c] (64 x 64) += A[64 x NT] . B_c[NT x 64] for the warpgroup's NC
// chunks: A in registers (four packed bf16 pairs a K step of 16), B the
// streamed tile's chunk boxes from b on, MN-major (16 rows, 2048 bytes, a
// K step). Every chunk runs, also past d (a wgmma under a branch the
// compiler cannot prove warpgroup-uniform is serialized): the tile holds
// room for all of them and their sums are not stored.
template <int NT, int NC>
__device__ __forceinline__ void rs_product(float (&acc)[NC][sm90::ACC64],
                                           const uint32_t (&a)[NT / 4], uint32_t b) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk)
      sm90::wgmma_m64n64k16_rs(acc[c], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                               sm90::smem_desc(b + c * NT * 128 + 2048 * kk, NT * 128, 1024));
}

// fence_acc over a warpgroup's chunks.
template <int NC>
__device__ __forceinline__ void fence_all(float (&d)[NC][sm90::ACC64]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) sm90::fence_acc(d[c]);
}

// The forward's masks on a thread's scores of an m64nN tile: rows row_a
// and row_a + 8, columns col0 + 8 jj + cq + {0, 1} in s[4 jj .. 4 jj + 3].
// `diag`: the self score is in the tile (attend_self off); the radius mask
// where reach > 0. Rows and columns are flat positions of one image, so
// the rule is the same with queries on either axis.
template <int N>
__device__ __forceinline__ void mask_tile(float (&s)[N / 2], int row_a, int col0, int cq,
                                          bool diag, int side, int reach, float r2) {
  const int row_b = row_a + 8;
  const int ra = row_a / side, ca = row_a - ra * side;
  const int rb = row_b / side, cb = row_b - rb * side;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * jj + cq + e;
      float& sa = s[4 * jj + e];
      float& sb = s[4 * jj + 2 + e];
      if (diag) {
        if (col == row_a) sa = SELF_VALUE;
        if (col == row_b) sb = SELF_VALUE;
      }
      if (reach > 0) {
        const int rc = col / side, cc = col - rc * side;
        const int da2 = (ra - rc) * (ra - rc) + (ca - cc) * (ca - cc);
        const int db2 = (rb - rc) * (rb - rc) + (cb - cc) * (cb - cc);
        if ((float)da2 > r2) sa = NEG_MAX;
        if ((float)db2 > r2) sb = NEG_MAX;
      }
    }
  }
}

// p = exp(s - m) / l, the division exact (Markstein) from inv = RN(1 / l).
__device__ __forceinline__ float prob(float s, float m, float l, float inv) {
  return sm90::div_rn(sm90::exp_f32(__fsub_rn(s, m)), l, inv);
}

// Warpgroup 1 arrives at named barrier `id`, warpgroup 0 waits for it
// (then thread 0 refills the stage both are past). A two-stage ring takes
// one id a stage: warpgroup 1 may run a tile ahead, and the stage's next
// fill (after warpgroup 0's wait) gates its next arrival at the same id, so
// no id ever sees its arrivals twice before the wait.
__device__ __forceinline__ void named_pass(int id, int w) {
  if (w == 1) {
    sm90::named_barrier_arrive(id, WG_THREADS);
  } else {
    sm90::named_barrier_sync(id, WG_THREADS);
  }
}

// Query-side statistics of a tile's columns i0 + 8 jj + cq + {0, 1} (the
// key-side passes): m, l (and its reciprocal) and D, f32 [L * B * n].
template <int NT>
struct ColStats {
  float m[NT / 4], l[NT / 4], inv[NT / 4], D[NT / 4];
  __device__ __forceinline__ void load(const float* m_in, const float* l_in, const float* dd,
                                       size_t base, int cq) {
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      const size_t i = base + 8 * jj + cq;
      const float2 mm = __ldg(reinterpret_cast<const float2*>(m_in + i));
      const float2 ll = __ldg(reinterpret_cast<const float2*>(l_in + i));
      m[2 * jj] = mm.x, m[2 * jj + 1] = mm.y;
      l[2 * jj] = ll.x, l[2 * jj + 1] = ll.y;
      inv[2 * jj] = __frcp_rn(ll.x), inv[2 * jj + 1] = __frcp_rn(ll.y);
      if (dd != nullptr) {
        const float2 dv = __ldg(reinterpret_cast<const float2*>(dd + i));
        D[2 * jj] = dv.x, D[2 * jj + 1] = dv.y;
      }
    }
  }
};

// ---- the pre-pass

// One warp a row of [L, B, n, d]: khat = normalize(levels), rounded; dcons
// = cot / div rounded (two-pass forms: cot the f32 sum of g and, in the
// combine, its streams), or, given cons (the one-sweep form), dcons = g *
// (1 / div) rounded and D = sum_c (g * (1 / div))_c cons_c of the unrounded
// f32 dcons.
__global__ void __launch_bounds__(32 * sm90::KHAT_ROWS)
consensus_bwd_prepass(const bf16* __restrict__ lv, const bf16* __restrict__ gout,
                      const bf16* __restrict__ dx_bu, const bf16* __restrict__ dx_td,
                      const bf16* __restrict__ cons, bf16* __restrict__ khat,
                      bf16* __restrict__ dcons, float* __restrict__ D, int L, int B, int n,
                      int d) {
  const size_t row = (size_t)blockIdx.x * sm90::KHAT_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (size_t)L * B * n) return;
  sm90::khat_row(lv + row * d, khat + row * d, d, lane);
  const int g = (int)(row / ((size_t)B * n));
  const size_t plane = (size_t)B * n * d;
  const float div = g == L - 1 ? 3.0f : 4.0f;
  const float inv_div = __fdiv_rn(1.0f, div);
  const bool bu = dx_bu != nullptr && g < L - 1, td = dx_bu != nullptr && g >= 1;
  float dot = 0.0f;
  for (int c = lane; c < d / 8; c += 32) {
    const size_t off = row * d + 8 * c;
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gout + off));
    uint4 bv = gv, tv = gv, cv = gv;
    if (bu) bv = __ldg(reinterpret_cast<const uint4*>(dx_bu + off + plane));
    if (td) tv = __ldg(reinterpret_cast<const uint4*>(dx_td + off - plane));
    if (cons != nullptr) cv = __ldg(reinterpret_cast<const uint4*>(cons + off));
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
    const bf16* te = reinterpret_cast<const bf16*>(&tv);
    const bf16* ce = reinterpret_cast<const bf16*>(&cv);
    uint4 o;
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float x = __bfloat162float(ge[e]);
      if (cons != nullptr) {
        x = __fmul_rn(x, inv_div);
        dot = fmaf(x, __bfloat162float(ce[e]), dot);
      } else {
        if (bu) x = __fadd_rn(x, __bfloat162float(be[e]));
        if (td) x = __fadd_rn(x, __bfloat162float(te[e]));
        x = __fdiv_rn(x, div);
      }
      oe[e] = __float2bfloat16(x);
    }
    *reinterpret_cast<uint4*>(dcons + off) = o;
  }
  if (cons != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) D[row] = dot;
  }
}

// ---- the dq pass

// Shared memory from a 1024-byte-aligned base: Q and dcons (d/64 resident
// boxes each), two k stages (TILE each), one v stage, the barriers q_full,
// k_full[2], v_full.
template <bool WIDE>
struct DqSmem {
  int boxes, dc_off, k_off, v_off, bar_off, bytes;
  __host__ __device__ explicit DqSmem(int d) {
    boxes = d / 64;
    dc_off = boxes * RBOX;
    k_off = 2 * boxes * RBOX;
    v_off = k_off + 2 * Hop<WIDE>::TILE;
    bar_off = v_off + boxes * Hop<WIDE>::TBOX;
    bytes = 1024 + bar_off + 4 * 8;
  }
};

// Grid: (query blocks of 64, L * B). q_map, dc_map: levels and the rounded
// dcons, [L * B, n, d] with a 64-row box; k_map (khat), v_map (levels): an
// NT-row box. Two-pass forms: sweep 0 sums dd over the live key tiles, then
// sweep 1 forms ds and sums dq; writes f32 dq and dd. The one-sweep form
// reads D from dd and sweeps once.
template <bool WIDE>
__global__ void __launch_bounds__(WG_THREADS, 1)
consensus_bwd_dq_sm90(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap dc_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const float* __restrict__ m_in,
                      const float* __restrict__ l_in, float* __restrict__ dq_out,
                      float* __restrict__ dd, int onesweep, int n, int d, int side, int reach,
                      float r2, int attend_self, float scale) {
  using H = Hop<WIDE>;
  constexpr int NT = H::NT, NC = H::NC, ACC = H::ACC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const DqSmem<WIDE> lay(d);
  unsigned char* qs = smem;
  unsigned char* dcs = smem + lay.dc_off;
  unsigned char* ks = smem + lay.k_off;
  unsigned char* vs = smem + lay.v_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;  // two stages
  uint64_t* v_full = bars + 3;

  const int i0 = blockIdx.x * ROWS, z = blockIdx.y;
  const size_t zn = (size_t)z * n;
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const bool loader = threadIdx.x == 0;  // issues every TMA load of the block
  int j_lo, j_hi;
  window(i0, ROWS, NT, n / NT, reach, j_lo, j_hi);
  const int tiles = j_hi - j_lo;
  const int total = (onesweep ? 1 : 2) * tiles;  // tile loads over both sweeps

  auto load_k = [&](int u) {
    const int s = u & 1, jt = j_lo + u % tiles;
    sm90::mbar_expect_tx(k_full + s, lay.boxes * H::TBOX);
    for (int c = 0; c < lay.boxes; ++c)
      sm90::tma_load_3d(ks + s * H::TILE + c * H::TBOX, &k_map, 64 * c, jt * NT, z, k_full + s);
  };
  auto load_v = [&](int u) {
    const int jt = j_lo + u % tiles;
    sm90::mbar_expect_tx(v_full, lay.boxes * H::TBOX);
    for (int c = 0; c < lay.boxes; ++c)
      sm90::tma_load_3d(vs + c * H::TBOX, &v_map, 64 * c, jt * NT, z, v_full);
  };
  if (loader) {
    for (int i = 0; i < 4; ++i) sm90::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    sm90::mbar_expect_tx(q_full, 2 * lay.boxes * RBOX);
    for (int c = 0; c < lay.boxes; ++c) {
      sm90::tma_load_3d(qs + c * RBOX, &q_map, 64 * c, i0, z, q_full);
      sm90::tma_load_3d(dcs + c * RBOX, &dc_map, 64 * c, i0, z, q_full);
    }
    load_k(0);
    if (total > 1) load_k(1);
    load_v(0);
  }

  // The thread's two query rows (wgmma's accumulator fragment) and column
  // pairs; rows past n (the last block of an n = 32 x odd row) are zeros,
  // computed with m = 0, l = 1 and not stored.
  const int r_a = 16 * (t / 32) + (t % 32) / 4, r_b = r_a + 8, cq = 2 * (t % 4);
  const int i_a = i0 + r_a, i_b = i0 + r_b;
  const bool ok_a = i_a < n, ok_b = i_b < n;
  const float m_a = ok_a ? m_in[zn + i_a] : 0.0f, m_b = ok_b ? m_in[zn + i_b] : 0.0f;
  const float l_a = ok_a ? l_in[zn + i_a] : 1.0f, l_b = ok_b ? l_in[zn + i_b] : 1.0f;
  const float inv_a = __frcp_rn(l_a), inv_b = __frcp_rn(l_b);
  float D_a = 0.0f, D_b = 0.0f;
  if (onesweep) {
    D_a = ok_a ? dd[zn + i_a] : 0.0f;
    D_b = ok_b ? dd[zn + i_b] : 0.0f;
  }
  float acc[NC][sm90::ACC64];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < sm90::ACC64; ++i) acc[c][i] = 0.0f;
  const uint32_t q_addr = sm90::smem_u32(qs), dc_addr = sm90::smem_u32(dcs);
  const uint32_t k_addr = sm90::smem_u32(ks), v_addr = sm90::smem_u32(vs);
  const int k_steps = d / 16;

  // Tile u's S and dP (both warpgroups, the whole tile), then v's stage is
  // released; p in sc, scaled and masked. Returns whether the tile holds
  // self scores.
  auto scores = [&](int u, float (&sc)[ACC], float (&dp)[ACC]) {
    const int s = u & 1;
#pragma unroll
    for (int i = 0; i < ACC; ++i) sc[i] = dp[i] = 0.0f;
    sm90::mbar_wait(k_full + s, (u >> 1) & 1);
    sm90::mbar_wait(v_full, u & 1);
    sm90::fence_acc(sc);
    sm90::fence_acc(dp);
    sm90::wgmma_fence();
    ss_product<NT>(sc, q_addr, k_addr + s * H::TILE, k_steps);
    ss_product<NT>(dp, dc_addr, v_addr, k_steps);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(sc);
    sm90::fence_acc(dp);
    named_pass(1, w);
    if (loader && u + 1 < total) load_v(u + 1);
    const int j0 = (j_lo + u % tiles) * NT;
#pragma unroll
    for (int i = 0; i < ACC; ++i) sc[i] = __fmul_rn(sc[i], scale);
    const bool diag = !attend_self && j0 < i0 + ROWS && i0 < j0 + NT;
    if (diag || reach > 0) mask_tile<NT>(sc, i_a, j0, cq, diag, side, reach, r2);
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * jj + e] = prob(sc[4 * jj + e], m_a, l_a, inv_a);
        sc[4 * jj + 2 + e] = prob(sc[4 * jj + 2 + e], m_b, l_b, inv_b);
      }
    }
    return diag;
  };
  // Tile u's k stage is free once both warpgroups are past its products.
  auto release_k = [&](int u) {
    named_pass(2 + (u & 1), w);
    if (loader && u + 2 < total) load_k(u + 2);
  };

  sm90::mbar_wait(q_full, 0);
  int u = 0;
  for (; u < total - tiles; ++u) {  // sweep 0 (two-pass forms): dd = sum_j p dP
    float sc[ACC], dp[ACC];
    scores(u, sc, dp);
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        D_a = fmaf(sc[4 * jj + e], dp[4 * jj + e], D_a);
        D_b = fmaf(sc[4 * jj + 2 + e], dp[4 * jj + 2 + e], D_b);
      }
    }
    release_k(u);
  }
  if (!onesweep) {  // a row's four threads hold its sums
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      D_a = __fadd_rn(D_a, __shfl_xor_sync(0xffffffffu, D_a, o));
      D_b = __fadd_rn(D_b, __shfl_xor_sync(0xffffffffu, D_b, o));
    }
  }
  for (; u < total; ++u) {  // ds, rounded, and dq += ds . k
    float sc[ACC], dp[ACC];
    const bool diag = scores(u, sc, dp);
    const int j0 = (j_lo + u % tiles) * NT;
    uint32_t a[NT / 4];
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * jj + cq + e;
        ds[e] = __fmul_rn(sc[4 * jj + e], __fsub_rn(dp[4 * jj + e], D_a));
        ds[2 + e] = __fmul_rn(sc[4 * jj + 2 + e], __fsub_rn(dp[4 * jj + 2 + e], D_b));
        if (diag && j == i_a) ds[e] = 0.0f;
        if (diag && j == i_b) ds[2 + e] = 0.0f;
      }
      a[2 * jj] = sm90::pack_bf16(ds[0], ds[1]);
      a[2 * jj + 1] = sm90::pack_bf16(ds[2], ds[3]);
    }
    fence_all(acc);
    sm90::wgmma_fence();
    rs_product<NT, NC>(acc, a, k_addr + (u & 1) * H::TILE + w * NC * H::TBOX);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_all(acc);
    release_k(u);
  }

  if (!onesweep && w == 0 && t % 4 == 0) {
    if (ok_a) dd[zn + i_a] = D_a;
    if (ok_b) dd[zn + i_b] = D_b;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int chunk = w * NC + c;
    if (chunk >= lay.boxes) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 64 * chunk + 8 * jj + cq;
      if (ok_a)
        *reinterpret_cast<float2*>(dq_out + (zn + i_a) * d + col) =
            make_float2(acc[c][4 * jj] * scale, acc[c][4 * jj + 1] * scale);
      if (ok_b)
        *reinterpret_cast<float2*>(dq_out + (zn + i_b) * d + col) =
            make_float2(acc[c][4 * jj + 2] * scale, acc[c][4 * jj + 3] * scale);
    }
  }
}

// ---- the key side: the dv pass and the dk pass

// p^T (or ds^T) of a key block's tile, packed as the register A operand:
// rows are keys, columns queries (ColStats).
template <int NT>
__device__ __forceinline__ void pack_rows(const float (&v)[NT / 2], uint32_t (&a)[NT / 4]) {
#pragma unroll
  for (int jj = 0; jj < NT / 8; ++jj) {
    a[2 * jj] = sm90::pack_bf16(v[4 * jj], v[4 * jj + 1]);
    a[2 * jj + 1] = sm90::pack_bf16(v[4 * jj + 2], v[4 * jj + 3]);
  }
}

// Scale, mask and p^T of a key block's scores against query columns i0t ..
// i0t + NT - 1. Returns whether the tile holds self scores.
template <int NT>
__device__ __forceinline__ bool key_probs(float (&sc)[NT / 2], const ColStats<NT>& st, int j_a,
                                          int j0, int i0t, int cq, int attend_self, int side,
                                          int reach, float r2, float scale) {
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) sc[i] = __fmul_rn(sc[i], scale);
  const bool diag = !attend_self && i0t < j0 + ROWS && j0 < i0t + NT;
  if (diag || reach > 0) mask_tile<NT>(sc, j_a, i0t, cq, diag, side, reach, r2);
#pragma unroll
  for (int jj = 0; jj < NT / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * jj + e;
      sc[4 * jj + e] = prob(sc[4 * jj + e], st.m[k], st.l[k], st.inv[k]);
      sc[4 * jj + 2 + e] = prob(sc[4 * jj + 2 + e], st.m[k], st.l[k], st.inv[k]);
    }
  }
  return diag;
}

// dv pass: k (64-row resident), then two stages of a query tile's levels
// (SS operand, d/64 boxes) and dcons (RS operand, TILE); the barriers
// kj_full, full[2].
template <bool WIDE>
struct DvSmem {
  int boxes, st_off, q_bytes, stage, bar_off, bytes;
  __host__ __device__ explicit DvSmem(int d) {
    boxes = d / 64;
    st_off = boxes * RBOX;
    q_bytes = boxes * Hop<WIDE>::TBOX;
    stage = q_bytes + Hop<WIDE>::TILE;
    bar_off = st_off + 2 * stage;
    bytes = 1024 + bar_off + 3 * 8;
  }
};

// Grid: (key blocks of 64, L * B). kj_map: khat with a 64-row box; q_map
// (levels), dc_map (dcons): an NT-row box. Writes f32 dv = p^T . dcons.
template <bool WIDE>
__global__ void __launch_bounds__(WG_THREADS, 1)
consensus_bwd_dv_sm90(const __grid_constant__ CUtensorMap kj_map,
                      const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap dc_map, const float* __restrict__ m_in,
                      const float* __restrict__ l_in, float* __restrict__ dv_out, int n, int d,
                      int side, int reach, float r2, int attend_self, float scale) {
  using H = Hop<WIDE>;
  constexpr int NT = H::NT, NC = H::NC, ACC = H::ACC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const DvSmem<WIDE> lay(d);
  unsigned char* kjs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* kj_full = bars;
  uint64_t* full = bars + 1;  // two stages

  const int j0 = blockIdx.x * ROWS, z = blockIdx.y;
  const size_t zn = (size_t)z * n;
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const bool loader = threadIdx.x == 0;
  int i_lo, i_hi;
  window(j0, ROWS, NT, n / NT, reach, i_lo, i_hi);
  const int tiles = i_hi - i_lo;

  auto load_tile = [&](int u) {
    const int s = u & 1, it = i_lo + u;
    unsigned char* st = smem + lay.st_off + s * lay.stage;
    sm90::mbar_expect_tx(full + s, 2 * lay.boxes * H::TBOX);
    for (int c = 0; c < lay.boxes; ++c) {
      sm90::tma_load_3d(st + c * H::TBOX, &q_map, 64 * c, it * NT, z, full + s);
      sm90::tma_load_3d(st + lay.q_bytes + c * H::TBOX, &dc_map, 64 * c, it * NT, z, full + s);
    }
  };
  if (loader) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    sm90::mbar_expect_tx(kj_full, lay.boxes * RBOX);
    for (int c = 0; c < lay.boxes; ++c)
      sm90::tma_load_3d(kjs + c * RBOX, &kj_map, 64 * c, j0, z, kj_full);
    load_tile(0);
    if (tiles > 1) load_tile(1);
  }

  // The thread's two key rows; rows past n are zeros and not stored.
  const int r_a = 16 * (t / 32) + (t % 32) / 4, r_b = r_a + 8, cq = 2 * (t % 4);
  const int j_a = j0 + r_a, j_b = j0 + r_b;
  float acc[NC][sm90::ACC64];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < sm90::ACC64; ++i) acc[c][i] = 0.0f;
  const uint32_t kj_addr = sm90::smem_u32(kjs);
  const int k_steps = d / 16;

  sm90::mbar_wait(kj_full, 0);
  for (int u = 0; u < tiles; ++u) {
    const int s = u & 1, i0t = (i_lo + u) * NT;
    const uint32_t st = sm90::smem_u32(smem + lay.st_off + s * lay.stage);
    ColStats<NT> cs;
    cs.load(m_in, l_in, nullptr, zn + i0t, cq);
    float sc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) sc[i] = 0.0f;
    sm90::mbar_wait(full + s, (u >> 1) & 1);
    sm90::fence_acc(sc);
    sm90::wgmma_fence();
    ss_product<NT>(sc, kj_addr, st, k_steps);  // S^T = k_j . Q_i^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(sc);
    key_probs<NT>(sc, cs, j_a, j0, i0t, cq, attend_self, side, reach, r2, scale);
    uint32_t a[NT / 4];
    pack_rows<NT>(sc, a);  // p^T rounded: the diagonal keeps its p
    fence_all(acc);
    sm90::wgmma_fence();
    rs_product<NT, NC>(acc, a, st + lay.q_bytes + w * NC * H::TBOX);  // dv += p^T . dcons_i
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_all(acc);
    named_pass(1 + s, w);
    if (loader && u + 2 < tiles) load_tile(u + 2);
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int chunk = w * NC + c;
    if (chunk >= lay.boxes) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 64 * chunk + 8 * jj + cq;
      if (j_a < n)
        *reinterpret_cast<float2*>(dv_out + (zn + j_a) * d + col) =
            make_float2(acc[c][4 * jj], acc[c][4 * jj + 1]);
      if (j_b < n)
        *reinterpret_cast<float2*>(dv_out + (zn + j_b) * d + col) =
            make_float2(acc[c][4 * jj + 2], acc[c][4 * jj + 3]);
    }
  }
}

// dk pass: k and v (levels) of the key block (64-row resident), two stages
// of a query tile's levels (SS and RS operand, TILE), one of its dcons (SS
// operand), the norm VJP's row sums [2 warpgroups][kx, xx][64], the
// barriers kv_full, q_full[2], dc_full. The epilogue stages dxn over the
// operand tiles.
template <bool WIDE>
struct DkSmem {
  int boxes, vj_off, q_off, dc_off, red_off, bar_off, bytes;
  __host__ __device__ explicit DkSmem(int d) {
    boxes = d / 64;
    vj_off = boxes * RBOX;
    q_off = 2 * boxes * RBOX;
    dc_off = q_off + 2 * Hop<WIDE>::TILE;
    red_off = dc_off + boxes * Hop<WIDE>::TBOX;
    bar_off = red_off + 2 * 2 * ROWS * 4;
    bytes = 1024 + bar_off + 4 * 8;
  }
};

// The bf16 pair of a resident 64-row box at (row, columns 8 jj + cq + {0,
// 1}), through the 128-byte swizzle.
__device__ __forceinline__ float2 resident_pair(const unsigned char* box, int row, int jj,
                                                int cq) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      box + row * 128 + ((jj ^ (row & 7)) * 16) + cq * 2));
}

// Grid: (key blocks of 64, L * B). kj_map (khat), vj_map (levels): a
// 64-row box; q_map (levels), dc_map (dcons): an NT-row box. dk = scale
// ds^T . Q through the norm VJP, then dlevels (and dmean) with f32 dq, dv
// and the cotangent (the streams in the combine); the one-sweep form
// rounds g / div + dv + normVJP(dk) first and writes no dmean.
template <bool WIDE>
__global__ void __launch_bounds__(WG_THREADS, 1)
consensus_bwd_dk_sm90(const __grid_constant__ CUtensorMap kj_map,
                      const __grid_constant__ CUtensorMap vj_map,
                      const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap dc_map, const float* __restrict__ m_in,
                      const float* __restrict__ l_in, const float* __restrict__ dd,
                      const float* __restrict__ dq_in, const float* __restrict__ dv_in,
                      const bf16* __restrict__ gout, const bf16* __restrict__ dx_bu,
                      const bf16* __restrict__ dx_td, bf16* __restrict__ dlv_out,
                      bf16* __restrict__ dmean_out, int onesweep, int L, int B, int n, int d,
                      int side, int reach, float r2, int attend_self, float scale) {
  using H = Hop<WIDE>;
  constexpr int NT = H::NT, NC = H::NC, ACC = H::ACC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const DkSmem<WIDE> lay(d);
  unsigned char* kjs = smem;
  unsigned char* vjs = smem + lay.vj_off;
  unsigned char* qs = smem + lay.q_off;
  unsigned char* dcs = smem + lay.dc_off;
  float* red = reinterpret_cast<float*>(smem + lay.red_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* kv_full = bars;
  uint64_t* q_full = bars + 1;  // two stages
  uint64_t* dc_full = bars + 3;

  const int j0 = blockIdx.x * ROWS, z = blockIdx.y;
  const size_t zn = (size_t)z * n;
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const bool loader = threadIdx.x == 0;
  int i_lo, i_hi;
  window(j0, ROWS, NT, n / NT, reach, i_lo, i_hi);
  const int tiles = i_hi - i_lo;

  auto load_q = [&](int u) {
    const int s = u & 1;
    sm90::mbar_expect_tx(q_full + s, lay.boxes * H::TBOX);
    for (int c = 0; c < lay.boxes; ++c)
      sm90::tma_load_3d(qs + s * H::TILE + c * H::TBOX, &q_map, 64 * c, (i_lo + u) * NT, z,
                        q_full + s);
  };
  auto load_dc = [&](int u) {
    sm90::mbar_expect_tx(dc_full, lay.boxes * H::TBOX);
    for (int c = 0; c < lay.boxes; ++c)
      sm90::tma_load_3d(dcs + c * H::TBOX, &dc_map, 64 * c, (i_lo + u) * NT, z, dc_full);
  };
  if (loader) {
    for (int i = 0; i < 4; ++i) sm90::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    sm90::mbar_expect_tx(kv_full, 2 * lay.boxes * RBOX);
    for (int c = 0; c < lay.boxes; ++c) {
      sm90::tma_load_3d(kjs + c * RBOX, &kj_map, 64 * c, j0, z, kv_full);
      sm90::tma_load_3d(vjs + c * RBOX, &vj_map, 64 * c, j0, z, kv_full);
    }
    load_q(0);
    if (tiles > 1) load_q(1);
    load_dc(0);
  }

  const int r_a = 16 * (t / 32) + (t % 32) / 4, r_b = r_a + 8, cq = 2 * (t % 4);
  const int j_a = j0 + r_a, j_b = j0 + r_b;
  float acc[NC][sm90::ACC64];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < sm90::ACC64; ++i) acc[c][i] = 0.0f;
  const uint32_t kj_addr = sm90::smem_u32(kjs), vj_addr = sm90::smem_u32(vjs);
  const uint32_t q_addr = sm90::smem_u32(qs), dc_addr = sm90::smem_u32(dcs);
  const int k_steps = d / 16;

  sm90::mbar_wait(kv_full, 0);
  for (int u = 0; u < tiles; ++u) {
    const int s = u & 1, i0t = (i_lo + u) * NT;
    ColStats<NT> cs;
    cs.load(m_in, l_in, dd, zn + i0t, cq);
    float sc[ACC], dp[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) sc[i] = dp[i] = 0.0f;
    sm90::mbar_wait(q_full + s, (u >> 1) & 1);
    sm90::mbar_wait(dc_full, u & 1);
    sm90::fence_acc(sc);
    sm90::fence_acc(dp);
    sm90::wgmma_fence();
    ss_product<NT>(sc, kj_addr, q_addr + s * H::TILE, k_steps);  // S^T = k_j . Q_i^T
    ss_product<NT>(dp, vj_addr, dc_addr, k_steps);               // dP^T = v_j . dcons_i^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(sc);
    sm90::fence_acc(dp);
    named_pass(1, w);
    if (loader && u + 1 < tiles) load_dc(u + 1);
    const bool diag =
        key_probs<NT>(sc, cs, j_a, j0, i0t, cq, attend_self, side, reach, r2, scale);
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * jj + e, i = i0t + 8 * jj + cq + e;
        float& da = sc[4 * jj + e];
        float& db = sc[4 * jj + 2 + e];
        da = __fmul_rn(da, __fsub_rn(dp[4 * jj + e], cs.D[k]));
        db = __fmul_rn(db, __fsub_rn(dp[4 * jj + 2 + e], cs.D[k]));
        if (diag && i == j_a) da = 0.0f;
        if (diag && i == j_b) db = 0.0f;
      }
    }
    uint32_t a[NT / 4];
    pack_rows<NT>(sc, a);  // ds^T rounded
    fence_all(acc);
    sm90::wgmma_fence();
    rs_product<NT, NC>(acc, a, q_addr + s * H::TILE + w * NC * H::TBOX);  // dk += ds^T . Q_i
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_all(acc);
    named_pass(2 + s, w);
    if (loader && u + 2 < tiles) load_q(u + 2);
  }
  sm90::named_barrier_sync(4, WG_THREADS);  // every product done: the stages are free

  // The norm VJP's row sums kx = sum_c (scale dk_c) x_c and xx = sum_c x_c^2,
  // each warpgroup over its chunks, then both.
  float kx_a = 0.0f, kx_b = 0.0f, xx_a = 0.0f, xx_b = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int chunk = w * NC + c;
    if (chunk >= lay.boxes) continue;
    const unsigned char* box = vjs + chunk * RBOX;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 xa = resident_pair(box, r_a, jj, cq), xb = resident_pair(box, r_b, jj, cq);
      kx_a = fmaf(acc[c][4 * jj] * scale, xa.x, kx_a);
      kx_a = fmaf(acc[c][4 * jj + 1] * scale, xa.y, kx_a);
      kx_b = fmaf(acc[c][4 * jj + 2] * scale, xb.x, kx_b);
      kx_b = fmaf(acc[c][4 * jj + 3] * scale, xb.y, kx_b);
      xx_a = fmaf(xa.x, xa.x, fmaf(xa.y, xa.y, xx_a));
      xx_b = fmaf(xb.x, xb.x, fmaf(xb.y, xb.y, xx_b));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    kx_a += __shfl_xor_sync(0xffffffffu, kx_a, o);
    kx_b += __shfl_xor_sync(0xffffffffu, kx_b, o);
    xx_a += __shfl_xor_sync(0xffffffffu, xx_a, o);
    xx_b += __shfl_xor_sync(0xffffffffu, xx_b, o);
  }
  if (t % 4 == 0) {
    red[w * 2 * ROWS + r_a] = kx_a;
    red[w * 2 * ROWS + r_b] = kx_b;
    red[w * 2 * ROWS + ROWS + r_a] = xx_a;
    red[w * 2 * ROWS + ROWS + r_b] = xx_b;
  }
  __syncthreads();
  kx_a = red[r_a] + red[2 * ROWS + r_a];
  kx_b = red[r_b] + red[2 * ROWS + r_b];
  const float norm_a = sqrtf(red[ROWS + r_a] + red[3 * ROWS + r_a]);
  const float norm_b = sqrtf(red[ROWS + r_b] + red[3 * ROWS + r_b]);
  const float inv_a = 1.0f / fmaxf(norm_a, 1e-12f), inv_b = 1.0f / fmaxf(norm_b, 1e-12f);

  // dxn = dk inv - kx x inv^2 / norm, in the accumulators.
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int chunk = w * NC + c;
    if (chunk >= lay.boxes) continue;
    const unsigned char* box = vjs + chunk * RBOX;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 xa = resident_pair(box, r_a, jj, cq), xb = resident_pair(box, r_b, jj, cq);
      const float x[4] = {xa.x, xa.y, xb.x, xb.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool a_row = e < 2;
        const float kx = a_row ? kx_a : kx_b, norm = a_row ? norm_a : norm_b;
        const float inv = a_row ? inv_a : inv_b;
        const float dkc = acc[c][4 * jj + e] * scale;
        acc[c][4 * jj + e] = dkc * inv - (norm >= 1e-12f ? kx * x[e] * inv * inv / norm : 0.0f);
      }
    }
  }

  // dxn staged as [64][d + 8] f32 over the operand tiles (free: every
  // product is done and x is read), then dlevels (and dmean) as whole
  // 16-byte segments of 8 columns, consecutive threads on consecutive
  // segments of a row, four segments' loads in flight at a time.
  const int pitch = d + 8;  // floats: rows 8 banks apart, 16-byte aligned
  float* dxn_s = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int chunk = w * NC + c;
    if (chunk >= lay.boxes) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 64 * chunk + 8 * jj + cq;
      *reinterpret_cast<float2*>(dxn_s + r_a * pitch + col) =
          make_float2(acc[c][4 * jj], acc[c][4 * jj + 1]);
      *reinterpret_cast<float2*>(dxn_s + r_b * pitch + col) =
          make_float2(acc[c][4 * jj + 2], acc[c][4 * jj + 3]);
    }
  }
  __syncthreads();
  const int g = z / B;
  const float div = g == L - 1 ? 3.0f : 4.0f;
  const float inv_div = __fdiv_rn(1.0f, div);
  const size_t plane = (size_t)B * n * d;
  const bool bu = dx_bu != nullptr && g < L - 1, td = dx_bu != nullptr && g >= 1;
  const int row_segs = d / 8;
#pragma unroll 4
  for (int seg = threadIdx.x; seg < ROWS * row_segs; seg += WG_THREADS) {
    const int r = seg / row_segs, c8 = seg - r * row_segs, j = j0 + r;
    if (j >= n) continue;
    const float4 x0 = *reinterpret_cast<const float4*>(dxn_s + r * pitch + 8 * c8);
    const float4 x1 = *reinterpret_cast<const float4*>(dxn_s + r * pitch + 8 * c8 + 4);
    const size_t off = (zn + j) * d + 8 * c8;
    const float4 q0 = __ldg(reinterpret_cast<const float4*>(dq_in + off));
    const float4 q1 = __ldg(reinterpret_cast<const float4*>(dq_in + off + 4));
    const float4 v0 = __ldg(reinterpret_cast<const float4*>(dv_in + off));
    const float4 v1 = __ldg(reinterpret_cast<const float4*>(dv_in + off + 4));
    const float dxn[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float dq[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const float dv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gout + off));
    uint4 bv = gv, tv = gv;
    if (bu) bv = __ldg(reinterpret_cast<const uint4*>(dx_bu + off + plane));
    if (td) tv = __ldg(reinterpret_cast<const uint4*>(dx_td + off - plane));
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
    const bf16* te = reinterpret_cast<const bf16*>(&tv);
    uint4 ov, mv;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
    bf16* me = reinterpret_cast<bf16*>(&mv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float x = __bfloat162float(ge[e]);
      if (onesweep) {
        const bf16 partial =
            __float2bfloat16(__fadd_rn(__fadd_rn(__fmul_rn(x, inv_div), dv[e]), dxn[e]));
        oe[e] = __float2bfloat16(__fadd_rn(__bfloat162float(partial), dq[e]));
      } else {
        if (bu) x = __fadd_rn(x, __bfloat162float(be[e]));
        if (td) x = __fadd_rn(x, __bfloat162float(te[e]));
        const float dcons = __fdiv_rn(x, div);
        oe[e] = __float2bfloat16(__fadd_rn(__fadd_rn(__fadd_rn(dcons, dq[e]), dv[e]), dxn[e]));
        me[e] = __float2bfloat16(dcons);
      }
    }
    *reinterpret_cast<uint4*>(dlv_out + off) = ov;
    if (!onesweep) *reinterpret_cast<uint4*>(dmean_out + off) = mv;
  }
}

// ---- the wide instance (640 < d <= 1024)
//
// At glom_tpu's imagenet224-pod width (d = 1024) the resident operands of
// the passes above no longer fit a block (the dq pass's Q and dcons tiles
// alone are 256 KB), and a block's f32 sums of 64 rows x d would take all
// 255 registers a thread. So each pass runs each 64 rows (queries in the dq
// pass, keys in the dv and dk passes) as a cluster of two blocks, as the
// wide forward does (sm90_attn.cuh:attn_pair_loop): block g, its rank,
// holds columns 512 g .. 512 g + 511 of every operand (at d = 704 rank 1
// holds three 64-column boxes; the rest load as zeros), both as its share
// of the scores' contraction and as its share of the output's columns. A
// block holds two resident operands A1 and A2 (its 64 rows, 64 KB each) and
// streams two tiles B1 and B2 (32 rows, 32 KB each, one stage); per tile:
//
//   the dq pass:  S = Q . k^T (A1 . B1^T), dP = dcons . v^T (A2 . B2^T),
//                 dq += ds . k (B1);
//   the dv pass:  S^T = k_j . Q^T (A1 . B1^T), dv += p^T . dcons (B2);
//   the dk pass:  S^T, dP^T = v_j . dcons^T (A2 . B2^T), dk += ds^T . Q (B1).
//
// Each score tile is computed once a cluster and sweep:
//   - in the dq and dk passes warpgroup 0 computes the block's partial S
//     and warpgroup 1 its partial dP (wgmma m64n32k16 over the block's
//     boxes, one instruction stream on operand addresses that depend on
//     the warpgroup); each adds the peer block's same partial after an
//     st.async exchange (sm90::pair_exchange, rank 0's half first);
//     warpgroup 0 turns S into p; the warpgroups swap p and dP through
//     `xq` (named barrier 1), so all four warpgroups of the pair hold the
//     same p, dP, D and ds, bit for bit;
//   - in the dv pass warpgroup w sums S^T over the block's boxes 4 w .. 4 w
//     + 3, the warpgroups add their halves (warpgroup 0's first) through
//     `xq`, and the pair adds the two blocks' sums;
//   - each warpgroup accumulates its four 64-column chunks of the block's
//     output (m64n64k16 with the rounded ds or p^T as the register A
//     operand, B the streamed tile's chunks, MN-major).
// The two-pass forms compute ten products a pair (S and dP twice; S, dP,
// dq; S, dv; S, dP, dk), the one-sweep form eight, each once.
//
// The dk pass applies the norm VJP in its epilogue: each block sums its
// half of every key row's kx and xx (warpgroup 0's chunks first), the pair
// swaps the halves through distributed shared memory (rank 0's first), and
// the block writes the complete bf16 dlevels (and dmean) of its columns
// from the staged dxn, f32 dq and dv and the cotangent (the combine's
// streams): no f32 dk reaches device memory.
//
// Loads (4-D TMA boxes, sm90::wide_map: a resident operand as two boxes of
// 64 rows x 4 chunks, a streamed tile as one of 32 rows x 8 chunks): thread
// 0 loads the resident operands and B1, thread 128 loads B2, each refill as
// soon as the tile's last reader is done with it: B1 after the S product
// in the dq pass's first sweep and in the dv pass, after both warpgroups'
// accumulating products in the dq pass's second sweep and the dk pass
// (named barrier NB_B1); B2 after warpgroup 1's dP product in the dq and
// dk passes, after both accumulating products in the dv pass (NB_B2).

constexpr int WIDE_NT = sm90::PAIR_KEYS;  // rows of a streamed tile: S is m64n32
constexpr int WIDE_NC = sm90::ATTN_NC;    // a warpgroup's chunks of its block's columns
constexpr int WIDE_ACC = sm90::ACC32;     // f32 sums a thread holds for m64n32
constexpr int MAX_D = 1024;               // the wide instance's widest row

// Shared memory from a 1024-byte-aligned base: A1, A2 (PAIR_BOXES boxes
// each), B1, B2 (one 4-D box each), then xs, the peer's partial for each
// warpgroup ([2][4][128] float4: thread t's sums 4i .. 4i + 3 at [w][i][t]),
// and xq, each warpgroup's half for the other ([2][4][128] float4), then the
// barriers. The dk pass's epilogue stages dxn ([64][512 + 8] f32) over A1,
// A2 and B1, and its row sums over xq and xs.
struct WideSmem {
  static constexpr int A_BYTES = sm90::PAIR_BOXES * RBOX;
  static constexpr int B_BYTES = sm90::PAIR_KTILE;
  static constexpr int B_OFF = 2 * A_BYTES;
  static constexpr int XS_OFF = B_OFF + 2 * B_BYTES;
  static constexpr int XQ_OFF = XS_OFF + 2 * 4 * 128 * 16;
  static constexpr int BAR_OFF = XQ_OFF + 2 * 4 * 128 * 16;
  // a_full; b_full [2]; s_full [2]; s_empty [2].
  static constexpr int A_FULL = 0, B_FULL = 1, S_FULL = 3, S_EMPTY = 5, BARS = 7;
  static constexpr int BYTES = 1024 + BAR_OFF + BARS * 8;
  static constexpr int STAGE_PITCH = sm90::PAIR_BOXES * 64 + 8;  // floats a staged dxn row
};
static_assert(WideSmem::BYTES <= 232448, "the wide passes fit a block's shared memory");
static_assert(ROWS * WideSmem::STAGE_PITCH * 4 <= WideSmem::XS_OFF,
              "the dk epilogue's staging stays clear of the row sums");

// Named barriers: the warpgroups' swap through xq; warpgroup w has read the
// peer's sums (the dv pass, its 128 threads); the other warpgroup has read
// xq[w]; B1 and B2 free; the dk pass's products all retired.
constexpr int NB_X = 1, NB_PEER = 2, NB_FREE = 4, NB_B1 = 6, NB_B2 = 7, NB_END = 8;

enum WidePass { PASS_DQ, PASS_DV, PASS_DK };

inline dim3 wide_grid(int n, int slots) {
  return dim3((n + ROWS - 1) / ROWS, sm90::PAIR_CLUSTER, slots);
}

// f32 [64 rows x the warpgroup's chunks] of a warpgroup's sums into out
// (row stride d), times `mul`; rows past n and chunks past d are not stored.
__device__ __forceinline__ void wide_store(const float (&acc)[WIDE_NC][sm90::ACC64], float* out,
                                           size_t row_a, bool ok_a, bool ok_b, int chunk0,
                                           int boxes, int w, int cq, int d, float mul) {
#pragma unroll
  for (int c = 0; c < WIDE_NC; ++c) {
    const int chunk = chunk0 + w * WIDE_NC + c;
    if (chunk >= boxes) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 64 * chunk + 8 * jj + cq;
      if (ok_a)
        *reinterpret_cast<float2*>(out + row_a * d + col) =
            make_float2(acc[c][4 * jj] * mul, acc[c][4 * jj + 1] * mul);
      if (ok_b)
        *reinterpret_cast<float2*>(out + (row_a + 8) * d + col) =
            make_float2(acc[c][4 * jj + 2] * mul, acc[c][4 * jj + 3] * mul);
    }
  }
}

// One wide pass, run by both blocks of each cluster (grid wide_grid: 64-row
// blocks, the pair along y, L * B slots). The maps are the kernels' own
// __grid_constant__ parameters (below): a1_map, a2_map with a box of 64
// rows x 4 chunks, b1_map, b2_map with one of 32 rows x 8 chunks. The dq
// pass writes f32 dq of the block's columns (out) and dd (rank 0; the
// one-sweep form reads D from dd); the dv pass f32 dv (out); the dk pass
// dlevels (and dmean) of the block's columns.
template <int PASS>
__device__ __forceinline__ void wide_pass(
    const CUtensorMap& a1_map, const CUtensorMap& a2_map, const CUtensorMap& b1_map,
    const CUtensorMap& b2_map, const float* __restrict__ m_in, const float* __restrict__ l_in,
    float* __restrict__ dd, float* __restrict__ out, const float* __restrict__ dq_in,
    const float* __restrict__ dv_in, const bf16* __restrict__ gout,
    const bf16* __restrict__ dx_bu, const bf16* __restrict__ dx_td, bf16* __restrict__ dlv_out,
    bf16* __restrict__ dmean_out, int onesweep, int L, int B, int n, int d, int side, int reach,
    float r2, int attend_self, float scale) {
  constexpr bool DQ = PASS == PASS_DQ, DV = PASS == PASS_DV, DK = PASS == PASS_DK;
  constexpr int NT = WIDE_NT, ACC = WIDE_ACC, NC = WIDE_NC;
  using S = WideSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const bool loader = t == 0;  // thread 0: A and B1; thread 128: B2
  uint64_t* a_full = bars + S::A_FULL;
  uint64_t* b_full = bars + S::B_FULL;
  uint64_t* s_full = bars + S::S_FULL + w;
  uint64_t* s_empty = bars + S::S_EMPTY + w;
  const uint32_t rank = sm90::cluster_rank();  // == blockIdx.y: the cluster spans y
  const int r0 = blockIdx.x * ROWS, z = blockIdx.z;
  const int boxes = d / 64, chunk0 = sm90::PAIR_BOXES * (int)rank;
  const int nb = min(sm90::PAIR_BOXES, boxes - chunk0);  // the block's boxes of d
  const size_t zn = (size_t)z * n;
  int lo, hi;
  window(r0, ROWS, NT, n / NT, reach, lo, hi);
  const int tiles = hi - lo;
  const int total = (DQ && !onesweep ? 2 : 1) * tiles;  // tiles over both sweeps
  const int first_acc = total - tiles;  // the first tile with an accumulating product

  // Tile u's B1 (k = 0) or B2 (k = 1): the block's columns of 32 rows.
  auto load_b = [&](int k, int u) {
    sm90::mbar_expect_tx(b_full + k, S::B_BYTES);
    sm90::tma_load_4d(smem + S::B_OFF + k * S::B_BYTES, k ? &b2_map : &b1_map, 0,
                      (lo + u % tiles) * NT, chunk0, z, b_full + k);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::BARS; ++i) sm90::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    if (w == 0) {
      constexpr int A = DV ? 1 : 2;  // the dv pass holds A1 only
      sm90::mbar_expect_tx(a_full, A * S::A_BYTES);
      for (int k = 0; k < A; ++k)
        for (int h = 0; h < 2; ++h)
          sm90::tma_load_4d(smem + k * S::A_BYTES + h * NC * RBOX, k ? &a2_map : &a1_map, 0, r0,
                            chunk0 + NC * h, z, a_full);
    }
    load_b(w, 0);
  }
  sm90::cluster_sync();  // both blocks' barriers are set up

  // The thread's two rows (wgmma's accumulator fragment) and column pairs;
  // rows past n (the last block of an n = 32 x odd row) are zeros and are
  // not stored. The dq pass's row statistics (m = 0, l = 1 past n).
  const int r_a = 16 * (t / 32) + (t % 32) / 4, r_b = r_a + 8, cq = 2 * (t % 4);
  const int row_a = r0 + r_a, row_b = r0 + r_b;
  const bool ok_a = row_a < n, ok_b = row_b < n;
  float m_a = 0.0f, m_b = 0.0f, l_a = 1.0f, l_b = 1.0f, D_a = 0.0f, D_b = 0.0f;
  if constexpr (DQ) {
    if (ok_a) m_a = m_in[zn + row_a], l_a = l_in[zn + row_a];
    if (ok_b) m_b = m_in[zn + row_b], l_b = l_in[zn + row_b];
    if (onesweep) {
      D_a = ok_a ? dd[zn + row_a] : 0.0f;
      D_b = ok_b ? dd[zn + row_b] : 0.0f;
    }
  }
  const float inv_a = __frcp_rn(l_a), inv_b = __frcp_rn(l_b);
  const float4* xs = reinterpret_cast<const float4*>(smem + S::XS_OFF) + w * 4 * 128 + t;
  const uint32_t xs_peer = sm90::cluster_addr(sm90::smem_u32(xs), rank ^ 1);
  const uint32_t s_full_peer = sm90::cluster_addr(sm90::smem_u32(s_full), rank ^ 1);
  const uint32_t s_empty_peer = sm90::cluster_addr(sm90::smem_u32(s_empty), rank ^ 1);
  float4* xq = reinterpret_cast<float4*>(smem + S::XQ_OFF);
  float acc[NC][sm90::ACC64];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < sm90::ACC64; ++i) acc[c][i] = 0.0f;
  // The warpgroup's score operands: A_{w+1} . B_{w+1}^T over the block's
  // boxes (dq, dk), or boxes 4 w .. 4 w + 3 of A1 . B1^T (dv); and the B of
  // its accumulating product: its chunks of B1 (dq, dk) or B2 (dv).
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t sa = base + (DV ? w * NC * RBOX : w * S::A_BYTES);
  const uint32_t sb = base + S::B_OFF + (DV ? w * NC * sm90::PAIR_KBOX : w * S::B_BYTES);
  const int score_boxes = DV ? NC : nb;
  const uint32_t ab = base + S::B_OFF + (DV ? S::B_BYTES : 0) + w * NC * sm90::PAIR_KBOX;

  // Write the warpgroup's 16 sums into xq[w] (once the other warpgroup has
  // read the previous ones), swap, and return the other's in o.
  auto swap = [&](const float (&s)[ACC], float (&o)[ACC], int u) {
    if (u > 0) sm90::named_barrier_sync(NB_FREE + w, WG_THREADS);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xq[(w * 4 + i) * 128 + t] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    sm90::named_barrier_sync(NB_X, WG_THREADS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = xq[((w ^ 1) * 4 + i) * 128 + t];
      o[4 * i] = v.x, o[4 * i + 1] = v.y, o[4 * i + 2] = v.z, o[4 * i + 3] = v.w;
    }
    if (u + 1 < total) sm90::named_barrier_arrive(NB_FREE + (w ^ 1), WG_THREADS);
  };

  sm90::mbar_wait(a_full, 0);
  for (int u = 0; u < total; ++u) {
    const int c0 = (lo + u % tiles) * NT;  // the tile's first key (dq) or query (dv, dk)
    const bool acc_tile = u >= first_acc, last = u + 1 == total;
    const bool diag = !attend_self && c0 < r0 + ROWS && r0 < c0 + NT;
    ColStats<NT> cs;
    if constexpr (!DQ) cs.load(m_in, l_in, DK ? dd : nullptr, zn + c0, cq);
    float sc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) sc[i] = 0.0f;
    sm90::mbar_wait(b_full + (DV ? 0 : w), u & 1);
    sm90::fence_acc(sc);
    sm90::wgmma_fence();
    for (int c = 0; c < score_boxes; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_m64n32k16_ss(sc, sm90::smem_desc(sa + c * RBOX + kk * 32, 16, 1024),
                                 sm90::smem_desc(sb + c * sm90::PAIR_KBOX + kk * 32, 16, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(sc);

    uint32_t a[NT / 4];  // the accumulating product's A: ds or p^T, rounded
    if constexpr (DV) {
      float o[ACC];
      swap(sc, o, u);  // the block's S^T: warpgroup 0's boxes first
#pragma unroll
      for (int i = 0; i < ACC; ++i) sc[i] = __fadd_rn(w == 0 ? sc[i] : o[i], w == 0 ? o[i] : sc[i]);
      if (threadIdx.x == 0 && !last) load_b(0, u + 1);  // both S^T products have retired
      sm90::pair_exchange(sc, xs, xs_peer, s_full, s_full_peer, s_empty, u, rank, loader);
      if (!last) {  // the warpgroup's slot is read: free it in the peer
        sm90::named_barrier_sync(NB_PEER + w, 128);
        if (loader) sm90::mbar_arrive_cluster(s_empty_peer);
      }
      key_probs<NT>(sc, cs, row_a, r0, c0, cq, attend_self, side, reach, r2, scale);
      pack_rows<NT>(sc, a);  // p^T rounded: the diagonal keeps its p
    } else {
      // B2 is free once warpgroup 1's dP has retired; B1 once the dq pass's
      // first-sweep S has.
      if (loader && !last && (w == 1 || !acc_tile)) load_b(w, u + 1);
      sm90::pair_exchange(sc, xs, xs_peer, s_full, s_full_peer, s_empty, u, rank, loader);
      if (w == 0) {  // S -> p, scaled and masked
        if constexpr (DQ) {
#pragma unroll
          for (int i = 0; i < ACC; ++i) sc[i] = __fmul_rn(sc[i], scale);
          if (diag || reach > 0) mask_tile<NT>(sc, row_a, c0, cq, diag, side, reach, r2);
#pragma unroll
          for (int jj = 0; jj < NT / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              sc[4 * jj + e] = prob(sc[4 * jj + e], m_a, l_a, inv_a);
              sc[4 * jj + 2 + e] = prob(sc[4 * jj + 2 + e], m_b, l_b, inv_b);
            }
          }
        } else {
          key_probs<NT>(sc, cs, row_a, r0, c0, cq, attend_self, side, reach, r2, scale);
        }
      }
      float o[ACC];
      swap(sc, o, u);
      // Both warpgroups are past the peer's sums (read before NB_X).
      if (loader && !last) sm90::mbar_arrive_cluster(s_empty_peer);
      float p[ACC], dp[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        p[i] = w == 0 ? sc[i] : o[i];
        dp[i] = w == 0 ? o[i] : sc[i];
      }
      if (!acc_tile) {  // the dq pass's first sweep: dd = sum_j p dP
#pragma unroll
        for (int jj = 0; jj < NT / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            D_a = fmaf(p[4 * jj + e], dp[4 * jj + e], D_a);
            D_b = fmaf(p[4 * jj + 2 + e], dp[4 * jj + 2 + e], D_b);
          }
        }
        if (u + 1 == first_acc) {  // a row's four threads hold its sums
#pragma unroll
          for (int o2 = 1; o2 <= 2; o2 <<= 1) {
            D_a = __fadd_rn(D_a, __shfl_xor_sync(0xffffffffu, D_a, o2));
            D_b = __fadd_rn(D_b, __shfl_xor_sync(0xffffffffu, D_b, o2));
          }
        }
        continue;
      }
      // ds = p (dP - D), 0 on the diagonal without attend_self.
#pragma unroll
      for (int jj = 0; jj < NT / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * jj + e, col = c0 + 8 * jj + cq + e;
          const float Da = DQ ? D_a : cs.D[k], Db = DQ ? D_b : cs.D[k];
          float da = __fmul_rn(p[4 * jj + e], __fsub_rn(dp[4 * jj + e], Da));
          float db = __fmul_rn(p[4 * jj + 2 + e], __fsub_rn(dp[4 * jj + 2 + e], Db));
          if (diag && col == row_a) da = 0.0f;
          if (diag && col == row_b) db = 0.0f;
          sc[4 * jj + e] = da;
          sc[4 * jj + 2 + e] = db;
        }
      }
      pack_rows<NT>(sc, a);
    }

    // dq += ds . k, dk += ds^T . Q (B1) or dv += p^T . dcons (B2) over the
    // warpgroup's chunks.
    sm90::mbar_wait(b_full + (DV ? 1 : 0), u & 1);
    fence_all(acc);
    sm90::wgmma_fence();
    rs_product<NT, NC>(acc, a, ab);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_all(acc);
    if (!last) {  // the accumulating products' B is free once both have retired
      const int id = DV ? NB_B2 : NB_B1, refill = DV ? 1 : 0;
      if (w != refill) {
        sm90::named_barrier_arrive(id, WG_THREADS);
      } else {
        sm90::named_barrier_sync(id, WG_THREADS);
        if (loader) load_b(refill, u + 1);
      }
    }
  }

  if constexpr (DQ) {
    if (!onesweep && rank == 0 && w == 0 && t % 4 == 0) {
      if (ok_a) dd[zn + row_a] = D_a;
      if (ok_b) dd[zn + row_b] = D_b;
    }
    wide_store(acc, out, zn + row_a, ok_a, ok_b, chunk0, boxes, w, cq, d, scale);
    return;
  }
  if constexpr (DV) {
    wide_store(acc, out, zn + row_a, ok_a, ok_b, chunk0, boxes, w, cq, d, 1.0f);
    return;
  }

  // The dk pass's epilogue. The norm VJP's row sums kx = sum_c (scale dk_c)
  // x_c and xx = sum_c x_c^2 (x: A2, the key rows' levels), each warpgroup
  // over its chunks, then the block's (warpgroup 0's first), then the
  // pair's (rank 0's first).
  sm90::named_barrier_sync(NB_END, WG_THREADS);  // every product done: xq is free
  float kx_a = 0.0f, kx_b = 0.0f, xx_a = 0.0f, xx_b = 0.0f;
  const unsigned char* xbox = smem + S::A_BYTES + w * NC * RBOX;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (chunk0 + w * NC + c >= boxes) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 xa = resident_pair(xbox + c * RBOX, r_a, jj, cq);
      const float2 xb = resident_pair(xbox + c * RBOX, r_b, jj, cq);
      kx_a = fmaf(acc[c][4 * jj] * scale, xa.x, kx_a);
      kx_a = fmaf(acc[c][4 * jj + 1] * scale, xa.y, kx_a);
      kx_b = fmaf(acc[c][4 * jj + 2] * scale, xb.x, kx_b);
      kx_b = fmaf(acc[c][4 * jj + 3] * scale, xb.y, kx_b);
      xx_a = fmaf(xa.x, xa.x, fmaf(xa.y, xa.y, xx_a));
      xx_b = fmaf(xb.x, xb.x, fmaf(xb.y, xb.y, xx_b));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    kx_a += __shfl_xor_sync(0xffffffffu, kx_a, o);
    kx_b += __shfl_xor_sync(0xffffffffu, kx_b, o);
    xx_a += __shfl_xor_sync(0xffffffffu, xx_a, o);
    xx_b += __shfl_xor_sync(0xffffffffu, xx_b, o);
  }
  float* red = reinterpret_cast<float*>(smem + S::XQ_OFF);  // [2 warpgroups][kx, xx][64]
  float* half = reinterpret_cast<float*>(smem + S::XS_OFF);  // the block's [kx, xx][64]
  if (t % 4 == 0) {
    red[w * 2 * ROWS + r_a] = kx_a;
    red[w * 2 * ROWS + r_b] = kx_b;
    red[w * 2 * ROWS + ROWS + r_a] = xx_a;
    red[w * 2 * ROWS + ROWS + r_b] = xx_b;
  }
  __syncthreads();
  if (threadIdx.x < 2 * ROWS)
    half[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[2 * ROWS + threadIdx.x]);
  sm90::cluster_sync();  // both blocks' halves are written
  const uint32_t peer_half = sm90::cluster_addr(sm90::smem_u32(half), rank ^ 1);
  auto both = [&](int i) {  // row sum i of the pair, rank 0's half first
    const float own = half[i], other = sm90::ld_cluster_f32(peer_half + 4 * i);
    return __fadd_rn(rank == 0 ? own : other, rank == 0 ? other : own);
  };
  kx_a = both(r_a);
  kx_b = both(r_b);
  const float norm_a = sqrtf(both(ROWS + r_a)), norm_b = sqrtf(both(ROWS + r_b));
  sm90::cluster_sync();  // the peer has read this block's halves
  const float ninv_a = 1.0f / fmaxf(norm_a, 1e-12f), ninv_b = 1.0f / fmaxf(norm_b, 1e-12f);
  const float rnorm_a = __frcp_rn(norm_a), rnorm_b = __frcp_rn(norm_b);

  // dxn = dk inv - kx x inv^2 / norm, in the accumulators; each division
  // rounded as IEEE division from the row's RN(1 / norm) (sm90::div_rn:
  // three operations and no branch, where the division's slow-path check
  // kept 8 warps from overlapping them).
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (chunk0 + w * NC + c >= boxes) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 xa = resident_pair(xbox + c * RBOX, r_a, jj, cq);
      const float2 xb = resident_pair(xbox + c * RBOX, r_b, jj, cq);
      const float x[4] = {xa.x, xa.y, xb.x, xb.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool a_row = e < 2;
        const float kx = a_row ? kx_a : kx_b, norm = a_row ? norm_a : norm_b;
        const float inv = a_row ? ninv_a : ninv_b, rnorm = a_row ? rnorm_a : rnorm_b;
        const float dkc = acc[c][4 * jj + e] * scale;
        acc[c][4 * jj + e] =
            dkc * inv - (norm >= 1e-12f ? sm90::div_rn(kx * x[e] * inv * inv, norm, rnorm) : 0.0f);
      }
    }
  }

  // dxn staged as [64][STAGE_PITCH] f32 over A1, A2 and B1 (free: every
  // product is done and x is read), then dlevels (and dmean) of the block's
  // columns as whole 16-byte segments of 8 columns, consecutive threads on
  // consecutive segments of a row, each thread's SEGS segments' loads
  // issued before any of them is used.
  constexpr int pitch = S::STAGE_PITCH;
  float* dxn_s = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (chunk0 + w * NC + c >= boxes) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 64 * (w * NC + c) + 8 * jj + cq;
      *reinterpret_cast<float2*>(dxn_s + r_a * pitch + col) =
          make_float2(acc[c][4 * jj], acc[c][4 * jj + 1]);
      *reinterpret_cast<float2*>(dxn_s + r_b * pitch + col) =
          make_float2(acc[c][4 * jj + 2], acc[c][4 * jj + 3]);
    }
  }
  __syncthreads();
  const int g = z / B, col0 = 64 * chunk0;
  const size_t plane = (size_t)B * n * d;
  const bool bu = dx_bu != nullptr && g < L - 1, td = dx_bu != nullptr && g >= 1;
  const float div = g == L - 1 ? 3.0f : 4.0f;
  const float inv_div = __fdiv_rn(1.0f, div);
  constexpr int SEGS = 4;
  const int row_segs = nb * 8, segs = ROWS * row_segs;
  for (int s0 = threadIdx.x; s0 < segs; s0 += SEGS * WG_THREADS) {
    float4 xs4[SEGS][2], q4[SEGS][2], v4[SEGS][2];
    uint4 gv[SEGS], bv[SEGS], tv[SEGS];
    size_t off[SEGS];
    bool ok[SEGS];
#pragma unroll
    for (int k = 0; k < SEGS; ++k) {
      const int seg = s0 + k * WG_THREADS, r = seg / row_segs, c8 = seg - r * row_segs;
      ok[k] = seg < segs && r0 + r < n;
      off[k] = (zn + r0 + r) * d + col0 + 8 * c8;
      if (!ok[k]) continue;
      xs4[k][0] = *reinterpret_cast<const float4*>(dxn_s + r * pitch + 8 * c8);
      xs4[k][1] = *reinterpret_cast<const float4*>(dxn_s + r * pitch + 8 * c8 + 4);
      q4[k][0] = __ldg(reinterpret_cast<const float4*>(dq_in + off[k]));
      q4[k][1] = __ldg(reinterpret_cast<const float4*>(dq_in + off[k] + 4));
      v4[k][0] = __ldg(reinterpret_cast<const float4*>(dv_in + off[k]));
      v4[k][1] = __ldg(reinterpret_cast<const float4*>(dv_in + off[k] + 4));
      gv[k] = bv[k] = tv[k] = __ldg(reinterpret_cast<const uint4*>(gout + off[k]));
      if (bu) bv[k] = __ldg(reinterpret_cast<const uint4*>(dx_bu + off[k] + plane));
      if (td) tv[k] = __ldg(reinterpret_cast<const uint4*>(dx_td + off[k] - plane));
    }
#pragma unroll
    for (int k = 0; k < SEGS; ++k) {
      if (!ok[k]) continue;
      const float dxn[8] = {xs4[k][0].x, xs4[k][0].y, xs4[k][0].z, xs4[k][0].w,
                            xs4[k][1].x, xs4[k][1].y, xs4[k][1].z, xs4[k][1].w};
      const float dq[8] = {q4[k][0].x, q4[k][0].y, q4[k][0].z, q4[k][0].w,
                           q4[k][1].x, q4[k][1].y, q4[k][1].z, q4[k][1].w};
      const float dv[8] = {v4[k][0].x, v4[k][0].y, v4[k][0].z, v4[k][0].w,
                           v4[k][1].x, v4[k][1].y, v4[k][1].z, v4[k][1].w};
      const bf16* ge = reinterpret_cast<const bf16*>(&gv[k]);
      const bf16* be = reinterpret_cast<const bf16*>(&bv[k]);
      const bf16* te = reinterpret_cast<const bf16*>(&tv[k]);
      uint4 ov, mv;
      bf16* oe = reinterpret_cast<bf16*>(&ov);
      bf16* me = reinterpret_cast<bf16*>(&mv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float x = __bfloat162float(ge[e]);
        if (onesweep) {
          const bf16 partial =
              __float2bfloat16(__fadd_rn(__fadd_rn(__fmul_rn(x, inv_div), dv[e]), dxn[e]));
          oe[e] = __float2bfloat16(__fadd_rn(__bfloat162float(partial), dq[e]));
        } else {
          if (bu) x = __fadd_rn(x, __bfloat162float(be[e]));
          if (td) x = __fadd_rn(x, __bfloat162float(te[e]));
          const float dcons = sm90::div_rn(x, div, inv_div);  // x / div, rounded as IEEE
          oe[e] = __float2bfloat16(__fadd_rn(__fadd_rn(__fadd_rn(dcons, dq[e]), dv[e]), dxn[e]));
          me[e] = __float2bfloat16(dcons);
        }
      }
      *reinterpret_cast<uint4*>(dlv_out + off[k]) = ov;
      if (!onesweep) *reinterpret_cast<uint4*>(dmean_out + off[k]) = mv;
    }
  }
}

// The wide passes, named apart for the profiles. dq: A levels (q) and the
// rounded dcons, B khat and levels (v). dv: A khat (k_j), B levels (Q) and
// dcons. dk: A khat and levels (v_j), B levels and dcons.
__global__ void __launch_bounds__(WG_THREADS, 1)
consensus_bwd_dq_wide(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap dc_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const float* __restrict__ m_in,
                      const float* __restrict__ l_in, float* __restrict__ dq_out,
                      float* __restrict__ dd, int onesweep, int n, int d, int side, int reach,
                      float r2, int attend_self, float scale) {
  wide_pass<PASS_DQ>(q_map, dc_map, k_map, v_map, m_in, l_in, dd, dq_out, nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, onesweep, 0, 1, n, d, side,
                     reach, r2, attend_self, scale);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
consensus_bwd_dv_wide(const __grid_constant__ CUtensorMap kj_map,
                      const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap dc_map, const float* __restrict__ m_in,
                      const float* __restrict__ l_in, float* __restrict__ dv_out, int n, int d,
                      int side, int reach, float r2, int attend_self, float scale) {
  wide_pass<PASS_DV>(kj_map, kj_map, q_map, dc_map, m_in, l_in, nullptr, dv_out, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 1, n, d, side,
                     reach, r2, attend_self, scale);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
consensus_bwd_dk_wide(const __grid_constant__ CUtensorMap kj_map,
                      const __grid_constant__ CUtensorMap vj_map,
                      const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap dc_map, const float* __restrict__ m_in,
                      const float* __restrict__ l_in, const float* __restrict__ dd,
                      const float* __restrict__ dq_in, const float* __restrict__ dv_in,
                      const bf16* __restrict__ gout, const bf16* __restrict__ dx_bu,
                      const bf16* __restrict__ dx_td, bf16* __restrict__ dlv_out,
                      bf16* __restrict__ dmean_out, int onesweep, int L, int B, int n, int d,
                      int side, int reach, float r2, int attend_self, float scale) {
  wide_pass<PASS_DK>(kj_map, vj_map, q_map, dc_map, m_in, l_in, const_cast<float*>(dd),
                     nullptr, dq_in, dv_in, gout, dx_bu, dx_td, dlv_out, dmean_out, onesweep, L,
                     B, n, d, side, reach, r2, attend_self, scale);
}

// ========================================================= host side

// The instances' names by number; kernels/consensus_update.py reads them
// from this line (K2_BWD_INSTANCES).
const char* const INSTANCE_NAMES[] = {"fma", "wgmma", "wgmma_wide"};
constexpr int INSTANCE_FMA = 0, INSTANCE_WGMMA = 1, INSTANCE_WGMMA_WIDE = 2;

// The instance the C entries run for a shape (the rule that
// kernels/consensus_update.py:k2_bwd_instance repeats for its scratches):
// "fma" for f32 where n % 16 == 0, "wgmma" for bf16 where n % 32 == 0 and
// d <= NARROW_D, "wgmma_wide" for bf16 past it; d % 64 == 0 and d <=
// MAX_D for all; -1 where none takes the shape.
int instance_for(int is_bf16, int n, int d) {
  if (d % 64 != 0 || d > MAX_D) return -1;
  if (!is_bf16) return n % F32_T == 0 ? INSTANCE_FMA : -1;
  if (n % 32 != 0) return -1;
  return d <= NARROW_D ? INSTANCE_WGMMA : INSTANCE_WGMMA_WIDE;
}

struct Geometry {
  int reach;
  float r2, scale;
};

Geometry geometry(int d, int side, double radius) {
  return {radius > 0 ? (int)(radius + 1.0) * side : 0, (float)(radius * radius),
          (float)(1.0 / sqrt((double)d))};
}

// The arguments every entry checks, and the scratches an instance takes:
// khat and dv for both "wgmma" instances (NULL for "fma"). `dv` is passed
// as a "taken" flag where an entry has none.
bool valid(int L, int B, int n, int d, int side, int instance, const void* dx_bu,
           const void* dx_td, bool khat, bool dv) {
  const bool wg = instance == INSTANCE_WGMMA || instance == INSTANCE_WGMMA_WIDE;
  return L >= 2 && B >= 1 && side >= 1 && (dx_bu == nullptr) == (dx_td == nullptr) &&
         instance >= 0 && khat == wg && dv == wg;
}

// ---- f32

template <bool ONESWEEP, int T>
int launch_dq_f32_tiles(const float* lv, const float* gout, const float* dx_bu,
                        const float* dx_td, const float* cons, const float* m, const float* l,
                        float* dq, float* dd, float* dcons, int L, int B, int n, int d,
                        const Geometry& geo, int side, int attend_self, cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  const cudaError_t err = sm90::lift_smem_cap(consensus_bwd_dq_kernel<ONESWEEP, T, T>, lifted);
  if (err != cudaSuccess) return (int)err;
  consensus_bwd_dq_kernel<ONESWEEP, T, T><<<dim3(n / T, B, L), THREADS, DqLayout<T, T>(d).bytes,
                                            stream>>>(
      lv, gout, dx_bu, dx_td, cons, m, l, dq, dd, dcons, L, B, n, d, side, geo.reach, geo.r2,
      attend_self, geo.scale);
  return (int)cudaGetLastError();
}

template <bool ONESWEEP>
int launch_dq_f32(const float* lv, const float* gout, const float* dx_bu, const float* dx_td,
                  const float* cons, const float* m, const float* l, float* dq, float* dd,
                  float* dcons, int L, int B, int n, int d, const Geometry& geo, int side,
                  int attend_self, cudaStream_t stream) {
  return (DqLayout<F32_T, F32_T>(d).bytes <= sm90::SMEM_OPTIN
              ? launch_dq_f32_tiles<ONESWEEP, F32_T>
              : launch_dq_f32_tiles<ONESWEEP, F32_WIDE_T>)(
      lv, gout, dx_bu, dx_td, cons, m, l, dq, dd, dcons, L, B, n, d, geo, side, attend_self,
      stream);
}

template <bool ONESWEEP, int T>
int launch_dkv_f32_tiles(const float* lv, const float* gout, const float* dx_bu,
                         const float* dx_td, const float* m, const float* l, const float* dq,
                         const float* dd, const float* dcons, float* dlv, float* dmean, int L,
                         int B, int n, int d, const Geometry& geo, int side, int attend_self,
                         cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  const cudaError_t err = sm90::lift_smem_cap(consensus_bwd_dkv_kernel<ONESWEEP, T, T>, lifted);
  if (err != cudaSuccess) return (int)err;
  consensus_bwd_dkv_kernel<ONESWEEP, T, T><<<dim3(n / T, B, L), THREADS,
                                             DkvLayout<T, T>(d).bytes, stream>>>(
      lv, gout, dx_bu, dx_td, m, l, dq, dd, dcons, dlv, dmean, L, B, n, d, side, geo.reach,
      geo.r2, attend_self, geo.scale);
  return (int)cudaGetLastError();
}

template <bool ONESWEEP>
int launch_dkv_f32(const float* lv, const float* gout, const float* dx_bu, const float* dx_td,
                   const float* m, const float* l, const float* dq, const float* dd,
                   const float* dcons, float* dlv, float* dmean, int L, int B, int n, int d,
                   const Geometry& geo, int side, int attend_self, cudaStream_t stream) {
  return (DkvLayout<F32_T, F32_T>(d).bytes <= sm90::SMEM_OPTIN
              ? launch_dkv_f32_tiles<ONESWEEP, F32_T>
              : launch_dkv_f32_tiles<ONESWEEP, F32_WIDE_T>)(lv, gout, dx_bu, dx_td, m, l, dq,
                                                            dd, dcons, dlv, dmean, L, B, n, d,
                                                            geo, side, attend_self, stream);
}

// ---- bf16

// A [L * B, n, d] bf16 map with a 64-column box of `rows` rows (cached).
cudaError_t row_map(CUtensorMap* map, const void* ptr, int d, int n, int slots, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)slots};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * n * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return sm90::cached_map(map, ptr, dims, strides, box);
}

cudaError_t launch_prepass(const bf16* lv, const bf16* gout, const bf16* dx_bu,
                           const bf16* dx_td, const bf16* cons, bf16* khat, bf16* dcons,
                           float* D, int L, int B, int n, int d, cudaStream_t stream) {
  const size_t rows = (size_t)L * B * n;
  consensus_bwd_prepass<<<(unsigned)((rows + sm90::KHAT_ROWS - 1) / sm90::KHAT_ROWS),
                          32 * sm90::KHAT_ROWS, 0, stream>>>(lv, gout, dx_bu, dx_td, cons, khat,
                                                             dcons, D, L, B, n, d);
  return cudaGetLastError();
}

// The dq pass proper (after the pre-pass wrote khat and dcons, and D for
// the one-sweep form).
template <bool WIDE>
cudaError_t launch_dq_sm90(const bf16* lv, const bf16* dcons, const bf16* khat, const float* m,
                           const float* l, float* dq, float* dd, int onesweep, int L, int B,
                           int n, int d, const Geometry& geo, int side, int attend_self,
                           cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(consensus_bwd_dq_sm90<WIDE>, lifted);
  CUtensorMap q_map, dc_map, k_map, v_map;
  const int slots = L * B, nt = Hop<WIDE>::NT;
  if (err == cudaSuccess) err = row_map(&q_map, lv, d, n, slots, ROWS);
  if (err == cudaSuccess) err = row_map(&dc_map, dcons, d, n, slots, ROWS);
  if (err == cudaSuccess) err = row_map(&k_map, khat, d, n, slots, nt);
  if (err == cudaSuccess) err = row_map(&v_map, lv, d, n, slots, nt);
  if (err != cudaSuccess) return err;
  consensus_bwd_dq_sm90<WIDE><<<dim3((n + ROWS - 1) / ROWS, slots), WG_THREADS,
                                DqSmem<WIDE>(d).bytes, stream>>>(
      q_map, dc_map, k_map, v_map, m, l, dq, dd, onesweep, n, d, side, geo.reach, geo.r2,
      attend_self, geo.scale);
  return cudaGetLastError();
}

// The key side: the dv pass, then the dk pass (khat and dcons written).
template <bool WIDE>
cudaError_t launch_key_side_sm90(const bf16* lv, const bf16* gout, const bf16* dx_bu,
                                 const bf16* dx_td, const bf16* dcons, const bf16* khat,
                                 const float* m, const float* l, const float* dq,
                                 const float* dd, float* dv, bf16* dlv, bf16* dmean,
                                 int onesweep, int L, int B, int n, int d, const Geometry& geo,
                                 int side, int attend_self, cudaStream_t stream) {
  static bool lifted_dv[sm90::MAX_DEVICES], lifted_dk[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(consensus_bwd_dv_sm90<WIDE>, lifted_dv);
  if (err == cudaSuccess) err = sm90::lift_smem_cap(consensus_bwd_dk_sm90<WIDE>, lifted_dk);
  CUtensorMap kj_map, vj_map, q_map, dc_map;
  const int slots = L * B, nt = Hop<WIDE>::NT;
  if (err == cudaSuccess) err = row_map(&kj_map, khat, d, n, slots, ROWS);
  if (err == cudaSuccess) err = row_map(&vj_map, lv, d, n, slots, ROWS);
  if (err == cudaSuccess) err = row_map(&q_map, lv, d, n, slots, nt);
  if (err == cudaSuccess) err = row_map(&dc_map, dcons, d, n, slots, nt);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + ROWS - 1) / ROWS, slots);
  consensus_bwd_dv_sm90<WIDE><<<grid, WG_THREADS, DvSmem<WIDE>(d).bytes, stream>>>(
      kj_map, q_map, dc_map, m, l, dv, n, d, side, geo.reach, geo.r2, attend_self, geo.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  consensus_bwd_dk_sm90<WIDE><<<grid, WG_THREADS, DkSmem<WIDE>(d).bytes, stream>>>(
      kj_map, vj_map, q_map, dc_map, m, l, dd, dq, dv, gout, dx_bu, dx_td, dlv, dmean, onesweep,
      L, B, n, d, side, geo.reach, geo.r2, attend_self, geo.scale);
  return cudaGetLastError();
}

// The wide instance's dq pass: a cluster of two blocks for each 64 query
// rows (sm90::launch_pair_smem, the pair along grid y).
cudaError_t launch_dq_wide(const bf16* lv, const bf16* dcons, const bf16* khat, const float* m,
                           const float* l, float* dq, float* dd, int onesweep, int L, int B,
                           int n, int d, const Geometry& geo, int side, int attend_self,
                           cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(consensus_bwd_dq_wide, lifted);
  CUtensorMap q_map, dc_map, k_map, v_map;
  const int slots = L * B;
  if (err == cudaSuccess) err = sm90::wide_map(&q_map, lv, d, n, slots, ROWS, WIDE_NC);
  if (err == cudaSuccess) err = sm90::wide_map(&dc_map, dcons, d, n, slots, ROWS, WIDE_NC);
  if (err == cudaSuccess)
    err = sm90::wide_map(&k_map, khat, d, n, slots, WIDE_NT, sm90::PAIR_BOXES);
  if (err == cudaSuccess) err = sm90::wide_map(&v_map, lv, d, n, slots, WIDE_NT, sm90::PAIR_BOXES);
  if (err != cudaSuccess) return err;
  return sm90::launch_pair_smem(consensus_bwd_dq_wide, wide_grid(n, slots), 1, WideSmem::BYTES,
                                stream, q_map, dc_map, k_map, v_map, m, l, dq, dd, onesweep, n,
                                d, side, geo.reach, geo.r2, attend_self, geo.scale);
}

// The wide instance's key side, the dv pass then the dk pass (khat and
// dcons written), each a cluster of two blocks for each 64 key rows; the
// dk pass writes the complete dlevels (and dmean).
cudaError_t launch_key_side_wide(const bf16* lv, const bf16* gout, const bf16* dx_bu,
                                 const bf16* dx_td, const bf16* dcons, const bf16* khat,
                                 const float* m, const float* l, const float* dq,
                                 const float* dd, float* dv, bf16* dlv, bf16* dmean,
                                 int onesweep, int L, int B, int n, int d, const Geometry& geo,
                                 int side, int attend_self, cudaStream_t stream) {
  static bool lifted_dv[sm90::MAX_DEVICES], lifted_dk[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(consensus_bwd_dv_wide, lifted_dv);
  if (err == cudaSuccess) err = sm90::lift_smem_cap(consensus_bwd_dk_wide, lifted_dk);
  CUtensorMap kj_map, vj_map, q_map, dc_map;
  const int slots = L * B;
  if (err == cudaSuccess) err = sm90::wide_map(&kj_map, khat, d, n, slots, ROWS, WIDE_NC);
  if (err == cudaSuccess) err = sm90::wide_map(&vj_map, lv, d, n, slots, ROWS, WIDE_NC);
  if (err == cudaSuccess) err = sm90::wide_map(&q_map, lv, d, n, slots, WIDE_NT, sm90::PAIR_BOXES);
  if (err == cudaSuccess)
    err = sm90::wide_map(&dc_map, dcons, d, n, slots, WIDE_NT, sm90::PAIR_BOXES);
  if (err != cudaSuccess) return err;
  const dim3 grid = wide_grid(n, slots);
  err = sm90::launch_pair_smem(consensus_bwd_dv_wide, grid, 1, WideSmem::BYTES, stream, kj_map,
                               q_map, dc_map, m, l, dv, n, d, side, geo.reach, geo.r2,
                               attend_self, geo.scale);
  if (err != cudaSuccess) return err;
  return sm90::launch_pair_smem(consensus_bwd_dk_wide, grid, 1, WideSmem::BYTES, stream, kj_map,
                                vj_map, q_map, dc_map, m, l, dd, dq, (const float*)dv, gout,
                                dx_bu, dx_td, dlv, dmean, onesweep, L, B, n, d, side, geo.reach,
                                geo.r2, attend_self, geo.scale);
}

cudaError_t launch_dq_bf16(const bf16* lv, const bf16* dcons, const bf16* khat, const float* m,
                           const float* l, float* dq, float* dd, int onesweep, int L, int B,
                           int n, int d, const Geometry& geo, int side, int attend_self,
                           cudaStream_t stream) {
  if (d > NARROW_D)
    return launch_dq_wide(lv, dcons, khat, m, l, dq, dd, onesweep, L, B, n, d, geo, side,
                          attend_self, stream);
  return d > 512 ? launch_dq_sm90<true>(lv, dcons, khat, m, l, dq, dd, onesweep, L, B, n, d, geo,
                                        side, attend_self, stream)
                 : launch_dq_sm90<false>(lv, dcons, khat, m, l, dq, dd, onesweep, L, B, n, d,
                                         geo, side, attend_self, stream);
}

cudaError_t launch_key_side_bf16(const bf16* lv, const bf16* gout, const bf16* dx_bu,
                                 const bf16* dx_td, const bf16* dcons, const bf16* khat,
                                 const float* m, const float* l, const float* dq,
                                 const float* dd, float* dv, bf16* dlv, bf16* dmean,
                                 int onesweep, int L, int B, int n, int d, const Geometry& geo,
                                 int side, int attend_self, cudaStream_t stream) {
  if (d > NARROW_D)
    return launch_key_side_wide(lv, gout, dx_bu, dx_td, dcons, khat, m, l, dq, dd, dv, dlv,
                                dmean, onesweep, L, B, n, d, geo, side, attend_self, stream);
  return d > 512 ? launch_key_side_sm90<true>(lv, gout, dx_bu, dx_td, dcons, khat, m, l, dq, dd,
                                              dv, dlv, dmean, onesweep, L, B, n, d, geo, side,
                                              attend_self, stream)
                 : launch_key_side_sm90<false>(lv, gout, dx_bu, dx_td, dcons, khat, m, l, dq, dd,
                                               dv, dlv, dmean, onesweep, L, B, n, d, geo, side,
                                               attend_self, stream);
}

}  // namespace

extern "C" {

// lv, gout: [L, B, n, d], one dtype (is_bf16 selects bf16, else f32);
// dx_bu [L, B, n, d] and dx_td [L-1, B, n, d] in that dtype, both or
// neither (the combine's streams); m, l: the forward's f32 [L, B, n] row
// statistics; dq: f32 [L, B, n, d] and dd: f32 [L, B, n] outputs; dcons:
// the [L, B, n, d] output, in the levels dtype, of the rounded dcons;
// khat: the "wgmma" instances' bf16 [L, B, n, d] scratch (NULL for "fma").
// The instance follows from is_bf16, n and d (instance_for). Contiguous, on
// the current device, bf16 tensors 16-byte aligned. Returns a cudaError_t.
int consensus_update_bwd_dq(const void* lv, const void* gout, const void* dx_bu,
                            const void* dx_td, const float* m, const float* l, float* dq,
                            float* dd, void* dcons, void* khat, int L, int B, int n, int d,
                            int side, double radius, int attend_self, int is_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int instance = instance_for(is_bf16, n, d);
  const bool wg = instance != INSTANCE_FMA;
  if (!valid(L, B, n, d, side, instance, dx_bu, dx_td, khat != nullptr, wg) ||
      dcons == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(d, side, radius);
  if (instance == INSTANCE_FMA)
    return launch_dq_f32<false>(static_cast<const float*>(lv), static_cast<const float*>(gout),
                                static_cast<const float*>(dx_bu),
                                static_cast<const float*>(dx_td), nullptr, m, l, dq, dd,
                                static_cast<float*>(dcons), L, B, n, d, geo, side, attend_self,
                                s);
  const auto* x = static_cast<const bf16*>(lv);
  auto* dc = static_cast<bf16*>(dcons);
  auto* k = static_cast<bf16*>(khat);
  cudaError_t err = launch_prepass(x, static_cast<const bf16*>(gout),
                                   static_cast<const bf16*>(dx_bu),
                                   static_cast<const bf16*>(dx_td), nullptr, k, dc, nullptr, L,
                                   B, n, d, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dq_bf16(x, dc, k, m, l, dq, dd, 0, L, B, n, d, geo, side, attend_self, s);
}

// The dq pass's inputs plus its dq, dd and rounded dcons; dlv, dmean:
// [L, B, n, d] in the levels dtype; both "wgmma" instances also take khat
// (bf16) and dv (f32 [L, B, n, d]) scratches, NULL for "fma". khat_ready:
// khat already holds the normalised keys (the dq pass of the same call
// wrote them); else the call writes them first.
int consensus_update_bwd_dkv(const void* lv, const void* gout, const void* dx_bu,
                             const void* dx_td, const float* m, const float* l,
                             const float* dq, const float* dd, const void* dcons, void* khat,
                             int khat_ready, float* dv, void* dlv, void* dmean, int L, int B,
                             int n, int d, int side, double radius, int attend_self, int is_bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int instance = instance_for(is_bf16, n, d);
  const bool wg = instance != INSTANCE_FMA;
  if (!valid(L, B, n, d, side, instance, dx_bu, dx_td, khat != nullptr, dv != nullptr) ||
      dcons == nullptr || (khat_ready && !wg))
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(d, side, radius);
  if (!wg)
    return launch_dkv_f32<false>(
        static_cast<const float*>(lv), static_cast<const float*>(gout),
        static_cast<const float*>(dx_bu), static_cast<const float*>(dx_td), m, l, dq, dd,
        static_cast<const float*>(dcons), static_cast<float*>(dlv), static_cast<float*>(dmean),
        L, B, n, d, geo, side, attend_self, s);
  const auto* x = static_cast<const bf16*>(lv);
  auto* k = static_cast<bf16*>(khat);
  if (!khat_ready) {
    const cudaError_t err = sm90::launch_khat(x, k, (size_t)L * B * n, d, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_key_side_bf16(x, static_cast<const bf16*>(gout),
                                   static_cast<const bf16*>(dx_bu),
                                   static_cast<const bf16*>(dx_td),
                                   static_cast<const bf16*>(dcons), k, m, l, dq, dd, dv,
                                   static_cast<bf16*>(dlv), static_cast<bf16*>(dmean), 0, L, B,
                                   n, d, geo, side, attend_self, s);
}

// The one-sweep backward (long rows): the dq pass with D from the saved
// attention output, then the key side, which writes the complete dlevels.
// lv, gout, cons: [L, B, n, d] in the levels dtype; m, l: the forward's f32
// [L, B, n]; dq (f32 [L, B, n, d]), dd (f32 [L, B, n]) and dcons ([L, B, n,
// d], levels dtype), and for the "wgmma" instances khat (bf16) and dv
// (f32): workspaces the launches hand over; dlv: [L, B, n, d].
int consensus_update_bwd_onesweep(const void* lv, const void* gout, const void* cons,
                                  const float* m, const float* l, float* dq, float* dd,
                                  void* dcons, void* khat, float* dv, void* dlv, int L, int B,
                                  int n, int d, int side, double radius, int attend_self,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int instance = instance_for(is_bf16, n, d);
  const bool wg = instance != INSTANCE_FMA;
  if (!valid(L, B, n, d, side, instance, nullptr, nullptr, khat != nullptr, dv != nullptr) ||
      cons == nullptr || dcons == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(d, side, radius);
  if (!wg) {
    const auto* x = static_cast<const float*>(lv);
    const auto* g = static_cast<const float*>(gout);
    auto* dc = static_cast<float*>(dcons);
    const int err = launch_dq_f32<true>(x, g, nullptr, nullptr, static_cast<const float*>(cons),
                                        m, l, dq, dd, dc, L, B, n, d, geo, side, attend_self, s);
    if (err != 0) return err;
    return launch_dkv_f32<true>(x, g, nullptr, nullptr, m, l, dq, dd, dc,
                                static_cast<float*>(dlv), nullptr, L, B, n, d, geo, side,
                                attend_self, s);
  }
  const auto* x = static_cast<const bf16*>(lv);
  const auto* g = static_cast<const bf16*>(gout);
  auto* dc = static_cast<bf16*>(dcons);
  auto* k = static_cast<bf16*>(khat);
  cudaError_t err = launch_prepass(x, g, nullptr, nullptr, static_cast<const bf16*>(cons), k, dc,
                                   dd, L, B, n, d, s);
  if (err == cudaSuccess)
    err = launch_dq_bf16(x, dc, k, m, l, dq, dd, 1, L, B, n, d, geo, side, attend_self, s);
  if (err == cudaSuccess)
    err = launch_key_side_bf16(x, g, nullptr, nullptr, dc, k, m, l, dq, dd, dv,
                               static_cast<bf16*>(dlv), nullptr, 1, L, B, n, d, geo, side,
                               attend_self, s);
  return (int)err;
}

// The wide instance's launches (sm90::launch_pair_smem): blocks of
// `threads` threads and `smem_bytes` of shared memory in clusters of
// `cluster` blocks along grid y, and how many such clusters the device
// holds at once (cudaOccupancyMaxActiveClusters) for the dq, dv and dk
// passes. Returns a cudaError_t.
int consensus_update_bwd_wide_launch(int* threads, int* smem_bytes, int* cluster,
                                     int* clusters_dq, int* clusters_dv, int* clusters_dk) {
  static bool lifted[3][sm90::MAX_DEVICES];
  *threads = WG_THREADS;
  *smem_bytes = WideSmem::BYTES;
  *cluster = sm90::PAIR_CLUSTER;
  cudaError_t err = sm90::lift_smem_cap(consensus_bwd_dq_wide, lifted[0]);
  if (err == cudaSuccess) err = sm90::lift_smem_cap(consensus_bwd_dv_wide, lifted[1]);
  if (err == cudaSuccess) err = sm90::lift_smem_cap(consensus_bwd_dk_wide, lifted[2]);
  if (err == cudaSuccess)
    err = sm90::pair_clusters(consensus_bwd_dq_wide, 1, clusters_dq, WideSmem::BYTES);
  if (err == cudaSuccess)
    err = sm90::pair_clusters(consensus_bwd_dv_wide, 1, clusters_dv, WideSmem::BYTES);
  if (err == cudaSuccess)
    err = sm90::pair_clusters(consensus_bwd_dk_wide, 1, clusters_dk, WideSmem::BYTES);
  return (int)err;
}

// The instance the entries run for these arguments, by name, or NULL
// where none takes them (instance_for).
const char* consensus_update_bwd_instance(int is_bf16, int n, int d) {
  const int instance = instance_for(is_bf16, n, d);
  return instance < 0 ? nullptr : INSTANCE_NAMES[instance];
}

const char* consensus_update_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
