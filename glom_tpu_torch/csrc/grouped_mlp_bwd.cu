// K1 backward: the VJP of the grouped per-level MLP, level-major.
//
//   z    = xa . w1 + b1   (xa = x (+ a[r mod n]), the forward's rounded input)
//   dh   = g . w2^T                     dpre = round(dh * GELU'(z))
//   dx   = dpre . w1^T                  h    = round(GELU(z))
//   dw1  = xa^T . dpre   db1 = sum_r dpre
//   dw2  = h^T . g       db2 = sum_r g
//   da   = sum over groups and batch copies of dx (f32, addend only)
//
// Replaces: glom_tpu/kernels/grouped_mlp.py:_mlp_bwd_kernel (recompute),
// :_mlp_bwd_kernel_saved (saved pre) and :_mlp_bwd_kernel_saved_add (saved
// pre plus the da reduction), whose shared tail is :_mlp_bwd_tail; in its
// accumulate mode also glom_tpu/kernels/fused_loop.py:_ffw_bwd_acc_kernel
// and :_ffw_bwd_acc_add_kernel (the whole-loop VJP's backward, which seeds
// the weight-gradient sums from the previous iteration's f32 totals), and,
// over the combined grid, :_ffw_bwd_cat_acc_kernel (its unchained twin
// :_ffw_bwd_cat_kernel, like :_mlp_bwd_kernel_saved beside the chained
// kernels, is glom_tpu's VMEM fallback; the port always chains).
//
// The combined td || bu grid (csrc/grouped_mlp.cu says more): group g <
// split takes the addend and reads x slot g + x_lo and cotangent slot g;
// group g >= split reads x slot g - split and cotangent slot g - split. So
// one launch reads the loop's [L+1]-slot carry and its [L]-level dmean in
// place for all 2L-1 groups, and da sums the f32 dx of the groups below
// split only, in the split launch's group order. A plain launch is split =
// G (addend) or 0, x_lo = 0.
//
// Accumulate mode (the whole-loop VJP): dw1, db1, dw2, db2 and da are f32
// and hold the totals of the iterations already done; this call adds its
// own gradients to them in place. Each weight-pass block owns its tile
// (and, in the first tile row, its column sums) across all M rows, and
// each da_reduce thread owns one element, so the update is a
// read-modify-write that no other block touches. The weight pass sums
// this call's gradients from zero exactly as the per-op launch does (a
// template instance, so the per-op instance is unchanged) and adds the
// incoming total in its epilogue: total + this call's sum, the order of
// the plain version. Seeding the WMMA accumulators with the incoming tile
// before the row loop, as the TPU kernel seeds its VMEM sums, kept the
// tile's pointer and the mode live through the loop: 58 registers instead
// of 48, four blocks an SM instead of five, and a weight pass about 5 %
// slower in both modes (measured on the H100). The sums stay f32 across
// the iterations and are rounded to the parameter dtype once, after the
// loop.
//
// Bound on the H100: tensor-core operations. At the flagship bottom-up shape
// (G = 6, M = 2048, d = 512, f = 2048, bf16, saved pre) the four products
// are 103 GFLOP against about 150 MB of inputs and outputs; the accumulate
// mode reads and writes the f32 totals instead of writing bf16 grads (about
// 100 MB more), still far below the operations' time.
//
// Kept out of device memory: dh. The TPU kernel walks the row tiles of a
// group in order and sums dw/db in VMEM across them; CUDA blocks run in
// parallel, so the work is split in two passes with no float atomics (the
// result is the same on every run):
//   * a row pass, one block per (group, row tile): per f chunk, dh = g . w2^T
//     on tensor cores (and, without a saved pre, z = xa . w1 + b1), then the
//     GELU derivative, and dx += dpre . w1^T into an f32 tile in shared
//     memory. It writes dx, and dpre to a [G, M, f] workspace; without a
//     saved pre it also writes h to a second one;
//   * a weight pass, one block per (group, 64 x 64 tile of dw1 or dw2): it
//     walks all M rows, staging xa/dpre (or h/g) chunks in shared memory,
//     with the f32 sums in registers; from a saved pre it forms h as it
//     stages the chunk. The blocks of the first tile row also sum the
//     columns of dpre (db1) or g (db2);
//   * with an addend, a third kernel sums the row pass's f32 dx over groups
//     and batch copies into da.
// Rounding points are the TPU kernel's: h and dpre are rounded to x's type,
// every product accumulates in f32, dx is rounded once. bf16 uses the tanh
// GELU's derivative and tensor cores (WMMA), f32 the erf form and FMA.
//
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int FC = 64;        // hidden columns per chunk of the row pass
constexpr int TMB = 32;       // rows per row-pass block, bf16
constexpr int TMF = 16;       // rows per row-pass block, f32
constexpr int WT = 64;        // weight-pass output tile
constexpr int WK = 32;        // weight-pass rows staged per step

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// GELU value and derivative in f32: the tanh form (bf16) or the erf form (f32).
__device__ __forceinline__ void gelu_tanh_vg(float z, float& val, float& grad) {
  const float c = 0.7978845608028654f, k = 0.044715f;
  const float t = tanhf(c * (z + k * (z * z * z)));
  val = z * (0.5f * (1.0f + t));
  grad = 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * c * (1.0f + 3.0f * k * z * z);
}

__device__ __forceinline__ void gelu_erf_vg(float z, float& val, float& grad) {
  const float Phi = 0.5f * (1.0f + erff(z * 0.7071067811865476f));
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  val = z * Phi;
  grad = Phi + z * phi;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ---------------------------------------------------------------- row pass

// Shared memory of the bf16 row pass; xs only when z is recomputed.
struct RowBf16Layout {
  int ld, ldacc, ldc, ldcb;
  size_t x_off, acc_off, dh_off, z_off, dp_off, bytes;
  __host__ __device__ RowBf16Layout(int d, bool recompute)
      : ld(d + 8), ldacc(d + 4), ldc(FC + 4), ldcb(FC + 8) {
    x_off = align128(sizeof(bf16) * TMB * ld);  // after the g tile
    acc_off = x_off + (recompute ? align128(sizeof(bf16) * TMB * ld) : 0);
    dh_off = acc_off + align128(sizeof(float) * TMB * ldacc);
    z_off = dh_off + align128(sizeof(float) * TMB * ldc);
    dp_off = z_off + align128(sizeof(float) * TMB * ldc);
    bytes = dp_off + align128(sizeof(bf16) * TMB * ldcb);
  }
};

__global__ void __launch_bounds__(THREADS)
mlp_bwd_rows_bf16(const bf16* __restrict__ x, const bf16* __restrict__ a, int n,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ pre,
                  const bf16* __restrict__ gout, bf16* __restrict__ dx,
                  float* __restrict__ dx32, bf16* __restrict__ h_ws,
                  bf16* __restrict__ dpre_ws, int M, int d, int f, int split, int x_lo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool recompute = pre == nullptr;
  const RowBf16Layout lay(d, recompute);
  bf16* gs = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.x_off);
  float* acc = reinterpret_cast<float*>(smem + lay.acc_off);
  float* dhs = reinterpret_cast<float*>(smem + lay.dh_off);
  float* zs = reinterpret_cast<float*>(smem + lay.z_off);
  bf16* dps = reinterpret_cast<bf16*>(smem + lay.dp_off);

  const int m0 = blockIdx.x * TMB;
  const int g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t row0 = (size_t)g * M + m0;
  const size_t xrow0 = (size_t)(g < split ? g + x_lo : g - split) * M + m0;
  const size_t grow0 = (size_t)(g < split ? g : g - split) * M + m0;
  if (g >= split) {
    a = nullptr;
    dx32 = nullptr;  // da sums the groups below split only
  }

  for (int e = tid; e < TMB * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    gs[r * lay.ld + c] = gout[(grow0 + r) * d + c];
    if (recompute) {
      bf16 v = x[(xrow0 + r) * d + c];
      if (a != nullptr)
        v = __float2bfloat16(__bfloat162float(v) +
                             __bfloat162float(a[(size_t)((m0 + r) % n) * d + c]));
      xs[r * lay.ld + c] = v;
    }
    acc[r * lay.ldacc + c] = 0.0f;
  }
  __syncthreads();

  const bf16* w1g = w1 + (size_t)g * d * f;
  const bf16* w2g = w2 + (size_t)g * f * d;
  const bf16* b1g = b1 + (size_t)g * f;

  for (int c0 = 0; c0 < f; c0 += FC) {
    // dh [TM, FC] = g . w2[c0:c0+FC, :]^T (and z = xa . w1[:, c0:c0+FC]):
    // one 16x16 tile a warp.
    {
      const int rf = warp / (FC / 16), cf = warp % (FC / 16);
      FragA af;
      FragC t;
      wmma::fill_fragment(t, 0.0f);
      for (int k = 0; k < d; k += 16) {
        FragBCol bf;
        wmma::load_matrix_sync(af, gs + rf * 16 * lay.ld + k, lay.ld);
        wmma::load_matrix_sync(bf, w2g + (size_t)(c0 + cf * 16) * d + k, d);
        wmma::mma_sync(t, af, bf, t);
      }
      wmma::store_matrix_sync(dhs + rf * 16 * lay.ldc + cf * 16, t, lay.ldc, wmma::mem_row_major);
      if (recompute) {
        wmma::fill_fragment(t, 0.0f);
        for (int k = 0; k < d; k += 16) {
          FragB bf;
          wmma::load_matrix_sync(af, xs + rf * 16 * lay.ld + k, lay.ld);
          wmma::load_matrix_sync(bf, w1g + (size_t)k * f + c0 + cf * 16, f);
          wmma::mma_sync(t, af, bf, t);
        }
        wmma::store_matrix_sync(zs + rf * 16 * lay.ldc + cf * 16, t, lay.ldc,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    // GELU value and derivative; h and dpre rounded to bf16.
    for (int e = tid; e < TMB * FC; e += THREADS) {
      const int r = e / FC, j = e - r * FC;
      const size_t idx = (row0 + r) * f + c0 + j;
      const float z = recompute ? zs[r * lay.ldc + j] + __bfloat162float(b1g[c0 + j])
                                : __bfloat162float(pre[idx]);
      float val, grad;
      gelu_tanh_vg(z, val, grad);
      const bf16 dp = __float2bfloat16(dhs[r * lay.ldc + j] * grad);
      if (recompute) h_ws[idx] = __float2bfloat16(val);
      dpre_ws[idx] = dp;
      dps[r * lay.ldcb + j] = dp;
    }
    __syncthreads();
    // dx tile [TM, d] += dpre . w1[:, c0:c0+FC]^T: a warp owns column tiles
    // cf = warp, warp + 8, ... for both 16-row halves.
    FragA pa[TMB / 16][FC / 16];
#pragma unroll
    for (int rf = 0; rf < TMB / 16; ++rf)
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk)
        wmma::load_matrix_sync(pa[rf][kk], dps + rf * 16 * lay.ldcb + kk * 16, lay.ldcb);
    for (int cf = warp; cf < d / 16; cf += WARPS) {
      FragC o[TMB / 16];
#pragma unroll
      for (int rf = 0; rf < TMB / 16; ++rf)
        wmma::load_matrix_sync(o[rf], acc + rf * 16 * lay.ldacc + cf * 16, lay.ldacc,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk) {
        FragBCol wb;
        wmma::load_matrix_sync(wb, w1g + (size_t)(cf * 16) * f + c0 + kk * 16, f);
#pragma unroll
        for (int rf = 0; rf < TMB / 16; ++rf) wmma::mma_sync(o[rf], pa[rf][kk], wb, o[rf]);
      }
#pragma unroll
      for (int rf = 0; rf < TMB / 16; ++rf)
        wmma::store_matrix_sync(acc + rf * 16 * lay.ldacc + cf * 16, o[rf], lay.ldacc,
                                wmma::mem_row_major);
    }
    // The next chunk's first writes (dhs, zs) are read only after a barrier
    // every warp reaches after finishing this product; dps is rewritten
    // only after the barrier that follows them.
  }
  __syncthreads();
  for (int e = tid; e < TMB * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const float v = acc[r * lay.ldacc + c];
    dx[(row0 + r) * d + c] = __float2bfloat16(v);
    if (dx32 != nullptr) dx32[(row0 + r) * d + c] = v;
  }
}

// f32: the same blocking on the CUDA cores. A thread computes one hidden
// column for TMF / 4 rows in the first phase, then whole dx columns (all
// TMF rows in registers) in the second.
__global__ void __launch_bounds__(THREADS)
mlp_bwd_rows_f32(const float* __restrict__ x, const float* __restrict__ a, int n,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ pre,
                 const float* __restrict__ gout, float* __restrict__ dx,
                 float* __restrict__ dx32, float* __restrict__ h_ws,
                 float* __restrict__ dpre_ws, int M, int d, int f, int split, int x_lo) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);  // [TMF][d]
  float* xs = gs + TMF * d;                     // [TMF][d]
  float* acc = xs + TMF * d;                    // [TMF][d]
  float* dps = acc + TMF * d;                   // [TMF][FC]
  const bool recompute = pre == nullptr;

  const int m0 = blockIdx.x * TMF;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)g * M + m0;
  const size_t xrow0 = (size_t)(g < split ? g + x_lo : g - split) * M + m0;
  const size_t grow0 = (size_t)(g < split ? g : g - split) * M + m0;
  if (g >= split) {
    a = nullptr;
    dx32 = nullptr;  // da sums the groups below split only
  }

  for (int e = tid; e < TMF * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    gs[e] = gout[(grow0 + r) * d + c];
    float v = x[(xrow0 + r) * d + c];
    if (a != nullptr) v = v + a[(size_t)((m0 + r) % n) * d + c];
    xs[e] = v;
    acc[e] = 0.0f;
  }
  __syncthreads();

  const float* w1g = w1 + (size_t)g * d * f;
  const float* w2g = w2 + (size_t)g * f * d;
  constexpr int ROWS_A = TMF * FC / THREADS;  // 4 rows per thread in phase one
  const int j = tid % FC, r0 = (tid / FC) * ROWS_A;

  for (int c0 = 0; c0 < f; c0 += FC) {
    float dh[ROWS_A], z[ROWS_A];
#pragma unroll
    for (int r = 0; r < ROWS_A; ++r) dh[r] = z[r] = 0.0f;
    const float* w2row = w2g + (size_t)(c0 + j) * d;
    for (int k = 0; k < d; ++k) {
      const float w = w2row[k];
#pragma unroll
      for (int r = 0; r < ROWS_A; ++r) dh[r] = fmaf(gs[(r0 + r) * d + k], w, dh[r]);
    }
    if (recompute) {
      for (int k = 0; k < d; ++k) {
        const float w = w1g[(size_t)k * f + c0 + j];
#pragma unroll
        for (int r = 0; r < ROWS_A; ++r) z[r] = fmaf(xs[(r0 + r) * d + k], w, z[r]);
      }
    }
    const float bias = b1[(size_t)g * f + c0 + j];
#pragma unroll
    for (int r = 0; r < ROWS_A; ++r) {
      const size_t idx = (row0 + r0 + r) * f + c0 + j;
      const float zz = recompute ? z[r] + bias : pre[idx];
      float val, grad;
      gelu_erf_vg(zz, val, grad);
      const float dp = dh[r] * grad;
      if (recompute) h_ws[idx] = val;
      dpre_ws[idx] = dp;
      dps[(r0 + r) * FC + j] = dp;
    }
    __syncthreads();
    for (int c = tid; c < d; c += THREADS) {
      float o[TMF];
#pragma unroll
      for (int r = 0; r < TMF; ++r) o[r] = acc[r * d + c];
      const float* w1row = w1g + (size_t)c * f + c0;
      for (int kk = 0; kk < FC; ++kk) {
        const float w = w1row[kk];
#pragma unroll
        for (int r = 0; r < TMF; ++r) o[r] = fmaf(dps[r * FC + kk], w, o[r]);
      }
#pragma unroll
      for (int r = 0; r < TMF; ++r) acc[r * d + c] = o[r];
    }
    __syncthreads();
  }
  for (int e = tid; e < TMF * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    dx[(row0 + r) * d + c] = acc[e];
    if (dx32 != nullptr) dx32[(row0 + r) * d + c] = acc[e];
  }
}

// ------------------------------------------------------------- weight pass
//
// blockIdx.z = 0: dw1 [d, f] = xa^T . dpre, db1 = column sums of dpre;
// blockIdx.z = 1: dw2 [f, d] = h^T . g,     db2 = column sums of g.
// C[i, j] = sum_m A[m, i] B[m, j] over the group's M rows, one WT x WT tile
// a block. h is read from the row pass's workspace, or formed from the
// saved pre as it is staged: GELU(pre) rounded to x's type. With ACC, C
// and the column sums are f32 totals: the block adds its sums to its tile
// of them in place.

struct WeightOperands {
  const void* A;       // [S, M, NA]
  const void* addend;  // [n, NA] or NULL, added to A rows on load
  bool gelu;           // A is the saved pre: stage GELU(A)
  const void* B;       // [S, M, NB]
  void* C;             // [G, NA, NB]
  void* colsum;        // [G, NB]
  int NA, NB;
  int a_slot, b_slot;  // the group's slot of A and of B
};

// Group g's operands under the group rule (see the combined grid above).
__device__ __forceinline__ WeightOperands operands(int z, int g, int split, int x_lo,
                                                   const void* x, const void* a,
                                                   const void* pre, const void* h_ws,
                                                   const void* dpre_ws, const void* gout,
                                                   void* dw1, void* db1, void* dw2, void* db2,
                                                   int d, int f) {
  const bool lo = g < split;
  if (z == 0) return {x, lo ? a : nullptr, false, dpre_ws, dw1, db1, d, f,
                      lo ? g + x_lo : g - split, g};
  const int gslot = lo ? g : g - split;
  if (pre != nullptr) return {pre, nullptr, true, gout, dw2, db2, f, d, g, gslot};
  return {h_ws, nullptr, false, gout, dw2, db2, f, d, g, gslot};
}

template <bool ACC>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_weights_bf16(const bf16* x, const bf16* a, int n, const bf16* pre, const bf16* h_ws,
                     const bf16* dpre_ws, const bf16* gout, void* dw1, void* db1, void* dw2,
                     void* db2, int M, int d, int f, int split, int x_lo) {
  constexpr int LDW = WT + 8, LDC = WT + 4;
  __shared__ __align__(128) unsigned char staged[2 * sizeof(bf16) * WK * LDW];
  __shared__ __align__(128) float Cs[WT * LDC];
  bf16* As = reinterpret_cast<bf16*>(staged);  // [WK][LDW]
  bf16* Bs = As + WK * LDW;                    // [WK][LDW]

  const int g = blockIdx.y;
  const WeightOperands op = operands(blockIdx.z, g, split, x_lo, x, a, pre, h_ws, dpre_ws, gout,
                                     dw1, db1, dw2, db2, d, f);
  const int tiles_b = op.NB / WT;
  if ((int)blockIdx.x >= (op.NA / WT) * tiles_b) return;
  const int i0 = (blockIdx.x / tiles_b) * WT, j0 = (blockIdx.x % tiles_b) * WT;
  const int tid = threadIdx.x, warp = tid / 32;
  const bf16* A = static_cast<const bf16*>(op.A);
  const bf16* addend = static_cast<const bf16*>(op.addend);
  const bf16* Bm = static_cast<const bf16*>(op.B);
  const bool sums = i0 == 0;

  const int rf = warp / 2, cf0 = (warp % 2) * 2;  // a warp owns 2 of the 4 x 4 fragments
  FragC c[2];
  wmma::fill_fragment(c[0], 0.0f);
  wmma::fill_fragment(c[1], 0.0f);
  float csum = 0.0f;

  for (int m0 = 0; m0 < M; m0 += WK) {
    for (int e = tid; e < WK * WT; e += THREADS) {
      const int r = e / WT, cc = e - r * WT;
      const size_t arow = (size_t)op.a_slot * M + m0 + r, brow = (size_t)op.b_slot * M + m0 + r;
      bf16 va = A[arow * op.NA + i0 + cc];
      if (addend != nullptr)
        va = __float2bfloat16(__bfloat162float(va) +
                              __bfloat162float(addend[(size_t)((m0 + r) % n) * op.NA + i0 + cc]));
      if (op.gelu) {
        float val, grad;
        gelu_tanh_vg(__bfloat162float(va), val, grad);
        va = __float2bfloat16(val);
      }
      As[r * LDW + cc] = va;
      Bs[r * LDW + cc] = Bm[brow * op.NB + j0 + cc];
    }
    __syncthreads();
    if (sums && tid < WT)
      for (int r = 0; r < WK; ++r) csum += __bfloat162float(Bs[r * LDW + tid]);
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      FragACol af;  // A^T: element (i, m) read from As[m][i]
      wmma::load_matrix_sync(af, As + kk * LDW + rf * 16, LDW);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        FragB bf;
        wmma::load_matrix_sync(bf, Bs + kk * LDW + (cf0 + q) * 16, LDW);
        wmma::mma_sync(c[q], af, bf, c[q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    wmma::store_matrix_sync(Cs + rf * 16 * LDC + (cf0 + q) * 16, c[q], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < WT * WT; e += THREADS) {
    const int r = e / WT, cc = e - r * WT;
    const size_t at = ((size_t)g * op.NA + i0 + r) * op.NB + j0 + cc;
    if constexpr (ACC)
      static_cast<float*>(op.C)[at] += Cs[r * LDC + cc];
    else
      static_cast<bf16*>(op.C)[at] = __float2bfloat16(Cs[r * LDC + cc]);
  }
  if (sums && tid < WT) {
    const size_t at = (size_t)g * op.NB + j0 + tid;
    if constexpr (ACC)
      static_cast<float*>(op.colsum)[at] += csum;
    else
      static_cast<bf16*>(op.colsum)[at] = __float2bfloat16(csum);
  }
}

// f32: a thread owns a 4 x 4 block of the tile.
template <bool ACC>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_weights_f32(const float* x, const float* a, int n, const float* pre,
                    const float* h_ws, const float* dpre_ws, const float* gout, float* dw1,
                    float* db1, float* dw2, float* db2, int M, int d, int f, int split,
                    int x_lo) {
  __shared__ float As[WK * WT];
  __shared__ float Bs[WK * WT];

  const int g = blockIdx.y;
  const WeightOperands op = operands(blockIdx.z, g, split, x_lo, x, a, pre, h_ws, dpre_ws, gout,
                                     dw1, db1, dw2, db2, d, f);
  const int tiles_b = op.NB / WT;
  if ((int)blockIdx.x >= (op.NA / WT) * tiles_b) return;
  const int i0 = (blockIdx.x / tiles_b) * WT, j0 = (blockIdx.x % tiles_b) * WT;
  const int tid = threadIdx.x;
  const float* A = static_cast<const float*>(op.A);
  const float* addend = static_cast<const float*>(op.addend);
  const float* Bm = static_cast<const float*>(op.B);
  const bool sums = i0 == 0;
  const int ti = (tid / 16) * 4, tj = (tid % 16) * 4;

  float c[4][4] = {};
  float csum = 0.0f;
  for (int m0 = 0; m0 < M; m0 += WK) {
    for (int e = tid; e < WK * WT; e += THREADS) {
      const int r = e / WT, cc = e - r * WT;
      const size_t arow = (size_t)op.a_slot * M + m0 + r, brow = (size_t)op.b_slot * M + m0 + r;
      float va = A[arow * op.NA + i0 + cc];
      if (addend != nullptr) va = va + addend[(size_t)((m0 + r) % n) * op.NA + i0 + cc];
      if (op.gelu) {
        float val, grad;
        gelu_erf_vg(va, val, grad);
        va = val;
      }
      As[e] = va;
      Bs[e] = Bm[brow * op.NB + j0 + cc];
    }
    __syncthreads();
    if (sums && tid < WT)
      for (int r = 0; r < WK; ++r) csum += Bs[r * WT + tid];
    for (int k = 0; k < WK; ++k) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float av = As[k * WT + ti + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) c[p][q] = fmaf(av, Bs[k * WT + tj + q], c[p][q]);
      }
    }
    __syncthreads();
  }
  float* C = static_cast<float*>(op.C);
  float* colsum = static_cast<float*>(op.colsum);
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float& out = C[((size_t)g * op.NA + i0 + ti + p) * op.NB + j0 + tj + q];
      out = ACC ? out + c[p][q] : c[p][q];
    }
  if (sums && tid < WT) {
    float& out = colsum[(size_t)g * op.NB + j0 + tid];
    out = ACC ? out + csum : csum;
  }
}

// da[r, c] = sum over groups g < G and batch copies b of dx32[g, b * n + r, c]
// (G: the launch's split, the groups that take the addend);
// with `accumulate` (f32 only) the sum is added to da's incoming total.
template <typename T>
__global__ void __launch_bounds__(THREADS)
da_reduce(const float* __restrict__ dx32, T* __restrict__ da, int G, int M, int n, int d,
          int accumulate) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n * d) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g)
    for (int b = 0; b < M / n; ++b) s += dx32[((size_t)g * M + (size_t)b * n) * d + e];
  if constexpr (std::is_same<T, float>::value)
    da[e] = accumulate ? da[e] + s : s;
  else
    da[e] = __float2bfloat16(s);
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

}  // namespace

extern "C" {

// x: [S, M, d] slots and gout: [S', M, d] slots, group g reading x slot
// g < split ? g + x_lo : g - split and gout slot g < split ? g : g - split
// (a plain launch: S = S' = G, x_lo = 0, split = G with an addend, else 0);
// dx: [G, M, d]; a: [n, d], taken by the groups below split, or NULL (then
// split = 0 and da, dx32_ws are NULL too); w1, dw1: [G, d, f]; b1, db1:
// [G, f]; w2, dw2: [G, f, d]; db2: [G, d]; pre: the forward's saved [G, M,
// f] pre-activation, or NULL to recompute it; dpre_ws: [G, M, f]
// workspace; h_ws: [G, M, f] workspace when pre is NULL, else unused;
// dx32_ws: f32 [split, M, d]; da: [n, d]. All but dx32_ws of one dtype
// (is_bf16 selects bf16, else f32), contiguous, on the current device.
// With `accumulate`, dw1, db1, dw2, db2 and da are f32 totals that this
// call adds to in place. Returns a cudaError_t.
int grouped_mlp_bwd(const void* x, const void* a, int n, const void* w1, const void* b1,
                    const void* w2, const void* pre, const void* gout, void* dx, void* dw1,
                    void* db1, void* dw2, void* db2, void* da, void* h_ws, void* dpre_ws,
                    void* dx32_ws, int G, int M, int d, int f, int split, int x_lo,
                    int accumulate, int is_bf16, void* stream) {
  const int tm = is_bf16 ? TMB : TMF;
  const bool add = a != nullptr;
  if (G < 1 || M % tm != 0 || M % WK != 0 || d % WT != 0 || f % WT != 0 ||
      (pre == nullptr && h_ws == nullptr) || split < 0 || split > G || x_lo < 0 ||
      add != (split > 0) ||
      (add && (n < 1 || M % n != 0 || da == nullptr || dx32_ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool lifted_bf16[MAX_DEVICES], lifted_f32[MAX_DEVICES];
  const dim3 rows(M / tm, G);
  const dim3 weights((d / WT) * (f / WT), G, 2);
  cudaError_t err;
  if (is_bf16) {
    err = lift_smem_cap(mlp_bwd_rows_bf16, lifted_bf16);
    if (err != cudaSuccess) return (int)err;
    mlp_bwd_rows_bf16<<<rows, THREADS, RowBf16Layout(d, pre == nullptr).bytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(a), n,
        static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(pre),
        static_cast<const bf16*>(gout), static_cast<bf16*>(dx), static_cast<float*>(dx32_ws),
        static_cast<bf16*>(h_ws), static_cast<bf16*>(dpre_ws), M, d, f, split, x_lo);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    auto weights_bf16 = accumulate ? mlp_bwd_weights_bf16<true> : mlp_bwd_weights_bf16<false>;
    weights_bf16<<<weights, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(a), n,
        static_cast<const bf16*>(pre), static_cast<const bf16*>(h_ws),
        static_cast<const bf16*>(dpre_ws), static_cast<const bf16*>(gout), dw1, db1, dw2, db2,
        M, d, f, split, x_lo);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (add && accumulate)
      da_reduce<float><<<(n * d + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          static_cast<const float*>(dx32_ws), static_cast<float*>(da), split, M, n, d, 1);
    else if (add)
      da_reduce<bf16><<<(n * d + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          static_cast<const float*>(dx32_ws), static_cast<bf16*>(da), split, M, n, d, 0);
  } else {
    err = lift_smem_cap(mlp_bwd_rows_f32, lifted_f32);
    if (err != cudaSuccess) return (int)err;
    const size_t bytes = sizeof(float) * (3 * TMF * d + TMF * FC);
    mlp_bwd_rows_f32<<<rows, THREADS, bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(a), n,
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(pre),
        static_cast<const float*>(gout), static_cast<float*>(dx),
        static_cast<float*>(dx32_ws), static_cast<float*>(h_ws),
        static_cast<float*>(dpre_ws), M, d, f, split, x_lo);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    auto weights_f32 = accumulate ? mlp_bwd_weights_f32<true> : mlp_bwd_weights_f32<false>;
    weights_f32<<<weights, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(a), n,
        static_cast<const float*>(pre), static_cast<const float*>(h_ws),
        static_cast<const float*>(dpre_ws),
        static_cast<const float*>(gout), static_cast<float*>(dw1), static_cast<float*>(db1),
        static_cast<float*>(dw2), static_cast<float*>(db2), M, d, f, split, x_lo);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (add)
      da_reduce<float><<<(n * d + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          static_cast<const float*>(dx32_ws), static_cast<float*>(da), split, M, n, d,
          accumulate);
  }
  return (int)cudaGetLastError();
}

const char* grouped_mlp_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
