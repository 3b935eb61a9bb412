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
// (1 / div) with the rounded cons. The dq pass takes D from it and sweeps
// the key tiles once (s, dP, dq: three products a pair), the dkv pass is
// unchanged (s, dP, dv, dk: four), seven products a pair where the TPU
// kernel has five and the two-pass form nine. Its epilogue rounds the
// partial g / div + dv + normVJP(dk) to the levels type, then adds the f32
// dq and rounds again, glom_tpu's rounding points; no dmean is written (the
// caller forms g / div, as glom_tpu's _fused_bwd). The TPU kernel keeps the
// whole row's f32 dq resident in VMEM across every key tile (8 MB a level
// and image at n = 4096, d = 512); here the dq pass owns its query rows'
// dq, so no block shares a sum and no float atomics are needed.
//
// The products read dcons rounded to the compute type. The dq pass forms
// it for its query rows and writes it once; the dkv pass reads that copy
// for each streamed query tile and forms the f32 dcons (from the streams,
// in the combine) only in its epilogue, for its own key rows. Forming it
// on every query tile instead (a load, a divide and a rounding per
// element, repeated by each of a slab's n / 16 key-tile blocks) took the
// dkv pass 1.84 ms at the flagship bucket-8 shape (1.96 ms with the
// combine's three streams) against 0.87 ms (0.81 ms) reading the copy
// (bf16, measured on an H100). An f32 copy would carry 4 bytes where the
// products need 2.
//
// Replaces: glom_tpu/kernels/consensus_update.py:_consensus_bwd_small_kernel
// (one tile, n <= 512), :_consensus_bwd_dq_kernel and
// :_consensus_bwd_dkv_kernel (two passes, any n),
// :_consensus_bwd_onesweep_kernel (long rows, with the saved cons), and
// glom_tpu/kernels/fused_loop.py:_cons_bwd_combine_kernel (the three-stream
// combine, single tile there). The single-tile form needs
// the whole f32 [n, n] score tile in fast memory: 256 KB at n = 256, more
// than a block's 227 KB of shared memory. So two kernels cover every n:
//   * the dq pass, one block per (query tile, image, level), streams the
//     key tiles twice: once for dd (the full sum, diagonal included), once
//     for ds and dq += ds . k (f32 in shared memory). It writes f32 dq and
//     dd, and the rounded dcons;
//   * the dkv pass, one block per (key tile, image, level), streams the
//     query tiles once, summing dv and dk in shared memory, and its epilogue
//     applies the norm VJP and writes the complete dlevels and dmean.
// Both skip tiles outside the radius band with the forward's window
// arithmetic. Rounding points are the TPU single-tile kernel's: k is
// normalized in f32 and rounded to the compute type, dcons is rounded before
// the products that take it, p (for dv) and ds are rounded before theirs,
// every sum is f32, and dlevels is rounded once.
//
// Bound on the H100: tensor-core operations. At the flagship bucket-8 shape
// ([6, 8, 256, 512] bf16) the five products of the single-tile form are
// 16.1 GFLOP, against 50 MB of levels, cotangent, dlevels and dmean (23 MB
// more with the combine's two streams); this design computes nine (s and
// dP three times, dq, dv, dk). At the long-row training shape ([6, 2, 4096,
// 512] bf16) the one-sweep kernel's five products are 1031 GFLOP against
// 202 MB of levels, cotangent, cons, m, l and dlevels; the one-sweep form
// here computes seven.
//
// Kept out of device memory: the scores, probabilities and ds, and dv and
// dk; only f32 dq and dd, and the rounded dcons, pass between the two
// kernels.
//
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <type_traits>

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_MAX = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float SELF_VALUE = -5e-4f;               // TOKEN_ATTEND_SELF_VALUE

// dq pass: TI query rows a block, TJ key rows a step. dkv pass: KJ key rows
// a block, KI query rows a step.
template <typename T>
struct Tiles;
template <>
struct Tiles<bf16> {
  static constexpr int TI = 32, TJ = 32, KJ = 16, KI = 32, PAD = 8;
};
template <>
struct Tiles<float> {
  static constexpr int TI = 16, TJ = 16, KJ = 16, KI = 16, PAD = 1;
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

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
template <typename T>
__device__ __forceinline__ float cotangent(const T* gout, const T* dx_bu, const T* dx_td,
                                           size_t idx, size_t plane, int g, int L) {
  float c = to_f(gout[idx]);
  if (dx_bu != nullptr) {
    if (g < L - 1) c += to_f(dx_bu[idx + plane]);
    if (g >= 1) c += to_f(dx_td[idx - plane]);
  }
  return c;
}

// ds on the diagonal is 0 without attend_self: its score was replaced by a
// constant, so no gradient flows through it.
__device__ __forceinline__ float zero_diag(float ds, int i, int j, int attend_self) {
  return (!attend_self && i == j) ? 0.0f : ds;
}

// Raw rows into vs and k = row / max(||row||, 1e-12) in f32 into ks, a warp
// a row, exactly as the forward normalizes them.
template <typename T>
__device__ __forceinline__ void load_rows_and_k(const T* src, int rows, int d, int ld, T* vs,
                                                T* ks, int warp, int lane) {
  for (int r = warp; r < rows; r += WARPS) {
    const T* row = src + (size_t)r * d;
    float ss = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const T v = row[c];
      vs[r * ld + c] = v;
      const float vf = to_f(v);
      ss = fmaf(vf, vf, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float denom = fmaxf(sqrtf(ss), 1e-12f);
    for (int c = lane; c < d; c += 32) ks[r * ld + c] = from_f<T>(to_f(vs[r * ld + c]) / denom);
  }
}

// out[R x C] (f32, pitch ldo) = A[R x d] . B[C x d]^T for R, C in {16, 32}:
// bf16 on tensor cores by warps [w0, w0 + (R/16)(C/16)), f32 by all threads.
template <typename T, int R, int C>
__device__ __forceinline__ void gemm_abt(const T* A, const T* B, int ld, int d, float* out,
                                         int ldo, int w0) {
  const int tid = threadIdx.x, warp = tid / 32;
  if constexpr (std::is_same<T, bf16>::value) {
    const int w = warp - w0;
    if (w >= 0 && w < (R / 16) * (C / 16)) {
      const int rf = w / (C / 16), cf = w % (C / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      for (int k = 0; k < d; k += 16) {
        wmma::load_matrix_sync(af, A + rf * 16 * ld + k, ld);
        wmma::load_matrix_sync(bf, B + cf * 16 * ld + k, ld);
        wmma::mma_sync(s, af, bf, s);
      }
      wmma::store_matrix_sync(out + rf * 16 * ldo + cf * 16, s, ldo, wmma::mem_row_major);
    }
  } else {
    for (int e = tid; e < R * C; e += THREADS) {
      const int r = e / C, c = e - r * C;
      float s = 0.0f;
      for (int k = 0; k < d; ++k) s = fmaf(to_f(A[r * ld + k]), to_f(B[c * ld + k]), s);
      out[r * ldo + c] = s;
    }
  }
}

// acc[R x d] (f32, pitch ldacc) += P[R x K] . V[K x d] for R in {16, 32}, K in
// {16, 32}. With `two`, a second product acc2 += P2 . V2 shares the warps.
template <typename T, int R, int K>
__device__ __forceinline__ void gemm_acc(const T* P, int ldp, const T* V, int ld, int d,
                                         float* acc, int ldacc, const T* P2, const T* V2,
                                         float* acc2) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int n_products = P2 != nullptr ? 2 : 1;
  if constexpr (std::is_same<T, bf16>::value) {
    using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
    using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
    using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
    const int tasks = n_products * (d / 16);
    for (int t = warp; t < tasks; t += WARPS) {
      const bool second = t >= d / 16;
      const int cf = second ? t - d / 16 : t;
      const T* Pp = second ? P2 : P;
      const T* Vp = second ? V2 : V;
      float* a = second ? acc2 : acc;
      FragA pa[R / 16][K / 16];
#pragma unroll
      for (int rf = 0; rf < R / 16; ++rf)
#pragma unroll
        for (int kk = 0; kk < K / 16; ++kk)
          wmma::load_matrix_sync(pa[rf][kk], Pp + rf * 16 * ldp + kk * 16, ldp);
      FragC o[R / 16];
#pragma unroll
      for (int rf = 0; rf < R / 16; ++rf)
        wmma::load_matrix_sync(o[rf], a + rf * 16 * ldacc + cf * 16, ldacc, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        FragB vb;
        wmma::load_matrix_sync(vb, Vp + kk * 16 * ld + cf * 16, ld);
#pragma unroll
        for (int rf = 0; rf < R / 16; ++rf) wmma::mma_sync(o[rf], pa[rf][kk], vb, o[rf]);
      }
#pragma unroll
      for (int rf = 0; rf < R / 16; ++rf)
        wmma::store_matrix_sync(a + rf * 16 * ldacc + cf * 16, o[rf], ldacc, wmma::mem_row_major);
    }
  } else {
    for (int e = tid; e < n_products * R * d; e += THREADS) {
      const bool second = e >= R * d;
      const int ee = second ? e - R * d : e;
      const int r = ee / d, c = ee - r * d;
      const T* Pp = second ? P2 : P;
      const T* Vp = second ? V2 : V;
      float* a = second ? acc2 : acc;
      float pv = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) pv = fmaf(to_f(Pp[r * ldp + k]), to_f(Vp[k * ld + c]), pv);
      a[r * ldacc + c] += pv;
    }
  }
}

// Live tile window [lo, hi) on the other axis for the rows [t0, t0 + extent):
// rows interact only within reach = (floor(radius) + 1) * side positions.
__device__ __forceinline__ void window(int t0, int extent, int tile, int n_tiles, int reach,
                                       int& lo, int& hi) {
  lo = 0;
  hi = n_tiles;
  if (reach > 0) {
    const int a = t0 - reach, b = t0 + extent + reach;
    lo = a <= 0 ? 0 : a / tile;
    hi = min((b + tile - 1) / tile, n_tiles);
  }
}

// ------------------------------------------------------------------ dq pass

template <typename T>
struct DqLayout {
  static constexpr int TI = Tiles<T>::TI, TJ = Tiles<T>::TJ;
  int ld, ldacc, lds, ldp;
  size_t dc_off, k_off, v_off, acc_off, s_off, dp_off, ds_off, st_off, bytes;
  __host__ __device__ explicit DqLayout(int d)
      : ld(d + Tiles<T>::PAD), ldacc(d + 4), lds(TJ + 4), ldp(TJ + 8) {
    dc_off = align128(sizeof(T) * TI * ld);  // after the q tile
    k_off = dc_off + align128(sizeof(T) * TI * ld);
    v_off = k_off + align128(sizeof(T) * TJ * ld);
    acc_off = v_off + align128(sizeof(T) * TJ * ld);
    s_off = acc_off + align128(sizeof(float) * TI * ldacc);
    dp_off = s_off + align128(sizeof(float) * TI * lds);
    ds_off = dp_off + align128(sizeof(float) * TI * lds);
    st_off = ds_off + align128(sizeof(T) * TI * ldp);
    bytes = st_off + align128(sizeof(float) * 3 * TI);
  }
};

template <typename T, bool ONESWEEP>
__global__ void __launch_bounds__(THREADS)
consensus_bwd_dq_kernel(const T* __restrict__ lv, const T* __restrict__ gout,
                        const T* __restrict__ dx_bu, const T* __restrict__ dx_td,
                        const T* __restrict__ cons_in,
                        const float* __restrict__ m_in, const float* __restrict__ l_in,
                        float* __restrict__ dq_out, float* __restrict__ dd_out,
                        T* __restrict__ dcons_out, int L, int B,
                        int n, int d, int side, int reach, float r2, int attend_self,
                        float scale) {
  constexpr int TI = Tiles<T>::TI, TJ = Tiles<T>::TJ;
  extern __shared__ __align__(128) unsigned char smem[];
  const DqLayout<T> lay(d);
  T* qs = reinterpret_cast<T*>(smem);                       // [TI][ld] query rows
  T* dcs = reinterpret_cast<T*>(smem + lay.dc_off);         // [TI][ld] rounded dcons
  T* ks = reinterpret_cast<T*>(smem + lay.k_off);           // [TJ][ld] normalized k
  T* vs = reinterpret_cast<T*>(smem + lay.v_off);           // [TJ][ld] raw rows (v)
  float* acc = reinterpret_cast<float*>(smem + lay.acc_off);  // [TI][ldacc] dq
  float* S = reinterpret_cast<float*>(smem + lay.s_off);      // [TI][lds] scores
  float* dP = reinterpret_cast<float*>(smem + lay.dp_off);    // [TI][lds]
  T* DS = reinterpret_cast<T*>(smem + lay.ds_off);            // [TI][ldp]
  float* m_row = reinterpret_cast<float*>(smem + lay.st_off);
  float* l_row = m_row + TI;
  float* dd_row = l_row + TI;

  const int i0 = blockIdx.x * TI, b = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float div = g == L - 1 ? 3.0f : 4.0f;
  const size_t slab = ((size_t)g * B + b) * n;  // row offset of levels[g, b]
  const size_t plane = (size_t)B * n * d;
  const T* row0 = lv + slab * d;

  const float inv_div = 1.0f / div;
  for (int e = tid; e < TI * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const size_t idx = (slab + i0 + r) * d + c;
    qs[r * lay.ld + c] = lv[idx];
    // The one-sweep form scales by 1/div, as glom_tpu's one-sweep kernel.
    const T dc = ONESWEEP ? from_f<T>(to_f(gout[idx]) * inv_div)
                          : from_f<T>(cotangent(gout, dx_bu, dx_td, idx, plane, g, L) / div);
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
    // D_i = sum_c dcons_ic cons_ic, a warp a row: the unrounded f32 dcons
    // against the forward's saved attention output, so dd needs no sweep.
    for (int r = warp; r < TI; r += WARPS) {
      const size_t row = (slab + i0 + r) * d;
      float D = 0.0f;
      for (int c = lane; c < d; c += 32)
        D = fmaf(to_f(gout[row + c]) * inv_div, to_f(cons_in[row + c]), D);
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
      constexpr int W = (TI / 16) * (TJ / 16);  // warps per product (bf16)
      gemm_abt<T, TI, TJ>(qs, ks, lay.ld, d, S, lay.lds, 0);
      gemm_abt<T, TI, TJ>(dcs, vs, lay.ld, d, dP, lay.lds, W);
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
          DS[r * lay.ldp + j] = from_f<T>(zero_diag(ds, i, j0 + j, attend_self));
        }
        __syncthreads();
        gemm_acc<T, TI, TJ>(DS, lay.ldp, ks, lay.ld, d, acc, lay.ldacc, nullptr, nullptr,
                            nullptr);
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

// ----------------------------------------------------------------- dkv pass

template <typename T>
struct DkvLayout {
  static constexpr int KJ = Tiles<T>::KJ, KI = Tiles<T>::KI;
  int ld, ldacc, lds, ldp;
  size_t k_off, dv_off, dk_off, q_off, dc_off, s_off, dp_off, p_off, ds_off, st_off, bytes;
  __host__ __device__ explicit DkvLayout(int d)
      : ld(d + Tiles<T>::PAD), ldacc(d + 4), lds(KI + 4), ldp(KI + 8) {
    k_off = align128(sizeof(T) * KJ * ld);  // after the raw key rows
    dv_off = k_off + align128(sizeof(T) * KJ * ld);
    dk_off = dv_off + align128(sizeof(float) * KJ * ldacc);
    q_off = dk_off + align128(sizeof(float) * KJ * ldacc);
    dc_off = q_off + align128(sizeof(T) * KI * ld);
    s_off = dc_off + align128(sizeof(T) * KI * ld);
    dp_off = s_off + align128(sizeof(float) * KJ * lds);
    p_off = dp_off + align128(sizeof(float) * KJ * lds);
    ds_off = p_off + align128(sizeof(T) * KJ * ldp);
    st_off = ds_off + align128(sizeof(T) * KJ * ldp);
    bytes = st_off + align128(sizeof(float) * 3 * KI);
  }
};

template <typename T, bool ONESWEEP>
__global__ void __launch_bounds__(THREADS)
consensus_bwd_dkv_kernel(const T* __restrict__ lv, const T* __restrict__ gout,
                         const T* __restrict__ dx_bu, const T* __restrict__ dx_td,
                         const float* __restrict__ m_in, const float* __restrict__ l_in,
                         const float* __restrict__ dq_in, const float* __restrict__ dd_in,
                         const T* __restrict__ dcons_in, T* __restrict__ dlv_out,
                         T* __restrict__ dmean_out, int L, int B,
                         int n, int d, int side, int reach, float r2, int attend_self,
                         float scale) {
  constexpr int KJ = Tiles<T>::KJ, KI = Tiles<T>::KI;
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvLayout<T> lay(d);
  T* xj = reinterpret_cast<T*>(smem);                         // [KJ][ld] raw key rows (v)
  T* kj = reinterpret_cast<T*>(smem + lay.k_off);             // [KJ][ld] normalized k
  float* dv = reinterpret_cast<float*>(smem + lay.dv_off);    // [KJ][ldacc]
  float* dk = reinterpret_cast<float*>(smem + lay.dk_off);    // [KJ][ldacc]
  T* qs = reinterpret_cast<T*>(smem + lay.q_off);             // [KI][ld] query rows
  T* dcs = reinterpret_cast<T*>(smem + lay.dc_off);           // [KI][ld] rounded dcons
  float* S2 = reinterpret_cast<float*>(smem + lay.s_off);     // [KJ][lds] s transposed
  float* dP2 = reinterpret_cast<float*>(smem + lay.dp_off);   // [KJ][lds]
  T* P2 = reinterpret_cast<T*>(smem + lay.p_off);             // [KJ][ldp]
  T* DS2 = reinterpret_cast<T*>(smem + lay.ds_off);           // [KJ][ldp]
  float* m_row = reinterpret_cast<float*>(smem + lay.st_off);
  float* l_row = m_row + KI;
  float* dd_row = l_row + KI;

  const int j0 = blockIdx.x * KJ, b = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float div = g == L - 1 ? 3.0f : 4.0f;
  const size_t slab = ((size_t)g * B + b) * n;
  const size_t plane = (size_t)B * n * d;
  const T* row0 = lv + slab * d;

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
    constexpr int W = (KJ / 16) * (KI / 16);
    gemm_abt<T, KJ, KI>(kj, qs, lay.ld, d, S2, lay.lds, 0);   // S2[j][i] = k_j . q_i
    gemm_abt<T, KJ, KI>(xj, dcs, lay.ld, d, dP2, lay.lds, W);  // dP2[j][i] = v_j . dcons_i
    __syncthreads();
    for (int e = tid; e < KJ * KI; e += THREADS) {
      const int jr = e / KI, ic = e - jr * KI, i = i0 + ic, j = j0 + jr;
      const float s = masked(S2[jr * lay.lds + ic] * scale, i, j, side, reach, r2, attend_self);
      const float p = expf(s - m_row[ic]) / l_row[ic];
      const float ds = p * (dP2[jr * lay.lds + ic] - dd_row[ic]);
      P2[jr * lay.ldp + ic] = from_f<T>(p);
      DS2[jr * lay.ldp + ic] = from_f<T>(zero_diag(ds, i, j, attend_self));
    }
    __syncthreads();
    // dv += P2 . dcons, dk += DS2 . q.
    gemm_acc<T, KJ, KI>(P2, lay.ldp, dcs, lay.ld, d, dv, lay.ldacc, DS2, qs, dk);
    __syncthreads();
  }

  // Epilogue, a warp a key row: dk through the VJP of k = x / max(|x|, eps),
  // then dlevels = dcons + dq + dv + normVJP(dk). The one-sweep form rounds
  // the partial (g / div + dv + normVJP(dk)) to the levels type first and
  // adds the f32 dq after, as glom_tpu joins dq outside its kernel; it
  // writes no dmean.
  const float inv_div = 1.0f / div;
  for (int r = warp; r < KJ; r += WARPS) {
    float xx = 0.0f, kx = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float x = to_f(xj[r * lay.ld + c]);
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
      const float x = to_f(xj[r * lay.ld + c]);
      const float dkc = dk[r * lay.ldacc + c] * scale;
      const float dxn = dkc * inv - (norm >= 1e-12f ? kx * x * inv * inv / norm : 0.0f);
      if constexpr (ONESWEEP) {
        const T partial = from_f<T>(to_f(gout[idx]) * inv_div + dv[r * lay.ldacc + c] + dxn);
        dlv_out[idx] = from_f<T>(to_f(partial) + dq_in[idx]);
      } else {
        const float dcons = cotangent(gout, dx_bu, dx_td, idx, plane, g, L) / div;
        dlv_out[idx] = from_f<T>(dcons + dq_in[idx] + dv[r * lay.ldacc + c] + dxn);
        dmean_out[idx] = from_f<T>(dcons);
      }
    }
  }
}

// Lift a kernel's dynamic shared-memory cap to the device's opt-in limit,
// once per device (`done` flags which devices are set).
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
cudaError_t lift_smem_cap(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

struct Geometry {
  int reach;
  float r2, scale;
};

bool valid(int L, int B, int n, int d, int side, int tile, const void* dx_bu,
           const void* dx_td) {
  return L >= 2 && B >= 1 && n % tile == 0 && d % 64 == 0 && side >= 1 &&
         (dx_bu == nullptr) == (dx_td == nullptr);
}

Geometry geometry(int d, int side, double radius) {
  return {radius > 0 ? (int)(radius + 1.0) * side : 0, (float)(radius * radius),
          (float)(1.0 / sqrt((double)d))};
}

// One instance per (type, form): each lifts its own cap once. The
// one-sweep form (cons given) takes no streams and writes no dmean.
template <typename T, bool ONESWEEP>
int launch_dq(const void* lv, const void* gout, const void* dx_bu, const void* dx_td,
              const void* cons, const float* m, const float* l, float* dq, float* dd,
              void* dcons, int L, int B, int n, int d, int side, double radius, int attend_self,
              cudaStream_t stream) {
  if (!valid(L, B, n, d, side, Tiles<T>::TI, dx_bu, dx_td) || n % Tiles<T>::TJ != 0 ||
      dcons == nullptr || ONESWEEP != (cons != nullptr) || (ONESWEEP && dx_bu != nullptr))
    return (int)cudaErrorInvalidValue;
  static bool lifted[MAX_DEVICES];
  const cudaError_t err = lift_smem_cap(consensus_bwd_dq_kernel<T, ONESWEEP>, lifted);
  if (err != cudaSuccess) return (int)err;
  const Geometry geo = geometry(d, side, radius);
  consensus_bwd_dq_kernel<T, ONESWEEP><<<dim3(n / Tiles<T>::TI, B, L), THREADS,
                                         DqLayout<T>(d).bytes, stream>>>(
      static_cast<const T*>(lv), static_cast<const T*>(gout), static_cast<const T*>(dx_bu),
      static_cast<const T*>(dx_td), static_cast<const T*>(cons), m, l, dq, dd,
      static_cast<T*>(dcons), L, B, n, d, side, geo.reach, geo.r2, attend_self, geo.scale);
  return (int)cudaGetLastError();
}

template <typename T, bool ONESWEEP>
int launch_dkv(const void* lv, const void* gout, const void* dx_bu, const void* dx_td,
               const float* m, const float* l, const float* dq, const float* dd,
               const void* dcons, void* dlv, void* dmean, int L, int B, int n, int d, int side,
               double radius, int attend_self, cudaStream_t stream) {
  if (!valid(L, B, n, d, side, Tiles<T>::KJ, dx_bu, dx_td) || n % Tiles<T>::KI != 0 ||
      dcons == nullptr || ONESWEEP != (dmean == nullptr) || (ONESWEEP && dx_bu != nullptr))
    return (int)cudaErrorInvalidValue;
  static bool lifted[MAX_DEVICES];
  const cudaError_t err = lift_smem_cap(consensus_bwd_dkv_kernel<T, ONESWEEP>, lifted);
  if (err != cudaSuccess) return (int)err;
  const Geometry geo = geometry(d, side, radius);
  consensus_bwd_dkv_kernel<T, ONESWEEP><<<dim3(n / Tiles<T>::KJ, B, L), THREADS,
                                          DkvLayout<T>(d).bytes, stream>>>(
      static_cast<const T*>(lv), static_cast<const T*>(gout), static_cast<const T*>(dx_bu),
      static_cast<const T*>(dx_td), m, l, dq, dd, static_cast<const T*>(dcons),
      static_cast<T*>(dlv), static_cast<T*>(dmean), L, B, n, d, side, geo.reach, geo.r2,
      attend_self, geo.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_onesweep(const void* lv, const void* gout, const void* cons, const float* m,
                    const float* l, float* dq, float* dd, void* dcons, void* dlv, int L, int B,
                    int n, int d, int side, double radius, int attend_self,
                    cudaStream_t stream) {
  const int err = launch_dq<T, true>(lv, gout, nullptr, nullptr, cons, m, l, dq, dd, dcons, L,
                                     B, n, d, side, radius, attend_self, stream);
  if (err != 0) return err;
  return launch_dkv<T, true>(lv, gout, nullptr, nullptr, m, l, dq, dd, dcons, dlv, nullptr, L,
                             B, n, d, side, radius, attend_self, stream);
}

}  // namespace

extern "C" {

// lv, gout: [L, B, n, d], one dtype (is_bf16 selects bf16, else f32);
// dx_bu [L, B, n, d] and dx_td [L-1, B, n, d] in that dtype, both or
// neither (the combine's streams); m, l: the forward's f32 [L, B, n] row
// statistics; dq: f32 [L, B, n, d] and dd: f32 [L, B, n] outputs; dcons:
// the [L, B, n, d] output, in the levels dtype, of the rounded dcons.
// Contiguous, on the current device. Returns a cudaError_t.
int consensus_update_bwd_dq(const void* lv, const void* gout, const void* dx_bu,
                            const void* dx_td, const float* m, const float* l, float* dq,
                            float* dd, void* dcons, int L, int B, int n, int d, int side,
                            double radius, int attend_self, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dq<bf16, false>(lv, gout, dx_bu, dx_td, nullptr, m, l, dq, dd, dcons,
                                          L, B, n, d, side, radius, attend_self, s)
                 : launch_dq<float, false>(lv, gout, dx_bu, dx_td, nullptr, m, l, dq, dd, dcons,
                                           L, B, n, d, side, radius, attend_self, s);
}

// The dq pass's inputs plus its dq, dd and rounded dcons; dlv, dmean:
// [L, B, n, d] in the levels dtype.
int consensus_update_bwd_dkv(const void* lv, const void* gout, const void* dx_bu,
                             const void* dx_td, const float* m, const float* l,
                             const float* dq, const float* dd, const void* dcons, void* dlv,
                             void* dmean, int L, int B, int n, int d, int side, double radius,
                             int attend_self, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dkv<bf16, false>(lv, gout, dx_bu, dx_td, m, l, dq, dd, dcons, dlv,
                                           dmean, L, B, n, d, side, radius, attend_self, s)
                 : launch_dkv<float, false>(lv, gout, dx_bu, dx_td, m, l, dq, dd, dcons, dlv,
                                            dmean, L, B, n, d, side, radius, attend_self, s);
}

// The one-sweep backward (long rows): the dq pass with D from the saved
// attention output, then the dkv pass, which writes the complete dlevels.
// lv, gout, cons: [L, B, n, d] in the levels dtype; m, l: the forward's f32
// [L, B, n]; dq (f32 [L, B, n, d]), dd (f32 [L, B, n]) and dcons ([L, B, n,
// d], levels dtype): workspaces the passes hand over; dlv: [L, B, n, d].
int consensus_update_bwd_onesweep(const void* lv, const void* gout, const void* cons,
                                  const float* m, const float* l, float* dq, float* dd,
                                  void* dcons, void* dlv, int L, int B, int n, int d, int side,
                                  double radius, int attend_self, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_onesweep<bf16>(lv, gout, cons, m, l, dq, dd, dcons, dlv, L, B, n, d,
                                         side, radius, attend_self, s)
                 : launch_onesweep<float>(lv, gout, cons, m, l, dq, dd, dcons, dlv, L, B, n, d,
                                          side, radius, attend_self, s);
}

const char* consensus_update_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
