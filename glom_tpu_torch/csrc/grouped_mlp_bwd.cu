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
// own gradients to them in place. One block (one consumer warpgroup on the
// bf16 saved-pre path) owns each weight tile and its column sums across all
// M rows, and each da_reduce thread owns one element, so the update is a
// read-modify-write that no other block touches. The call sums its own
// gradients from zero exactly as the per-op launch does (a template
// instance, so the per-op instance is unchanged) and adds the incoming
// total in its epilogue: total + this call's sum, the order of the plain
// version. The sums stay f32 across the iterations and are rounded to the
// parameter dtype once, after the loop.
//
// Three paths, picked by is_bf16 and pre alone:
//
// * bf16 with the saved pre (every training route: the per-iteration
//   backward, the loop's accumulate mode, the combined grid, long rows
//   under SAVE_PRE_LIMIT; it replaces :_mlp_bwd_kernel_saved,
//   :_mlp_bwd_kernel_saved_add, :_ffw_bwd_acc(_add)_kernel and
//   :_ffw_bwd_cat_acc_kernel in bf16): three launches of the Hopper GEMM
//   mainloop (sm90_gemm.cuh: a persistent grid of 128 x 128 tiles, two
//   consumer warpgroups on wgmma, each fed by its own producer warp
//   through a 3-stage TMA ring), after the addend's xa scratch when there
//   is one:
//     - dh pass (`mlp_bwd_dh_sm90`), [G, M, f] tiles: A = the cotangent
//       (K-major, read in place at the group rule's slots), B = w2 read
//       K-major as it lies ([f, d]), K = d. The epilogue reads the saved
//       pre through the warp's stage as 16-byte row loads and writes
//       dpre = round(dh * GELU'(pre)) and h = round(GELU(pre)) to two
//       [G, M, f] scratches;
//     - dx pass (`mlp_bwd_dx_sm90`), [G, M, d] tiles: A = dpre, B = w1
//       read K-major ([d, f]), K = f; dx rounded once, and for the addend's
//       groups the f32 dx that da_reduce sums;
//     - weight pass (`mlp_bwd_dw_sm90`), dw1 [d, f] tiles (A = xa^T read
//       MN-major as xa lies, [M, d]; B = dpre) and dw2 [f, d] tiles (A =
//       h^T, MN-major; B = the cotangent at the group rule's slots), both
//       problems in one persistent grid, K = M rounded up to whole 64-row
//       steps (TMA fills the rows past M with zeros, exact for sums and
//       products). The tiles of the first row block sum B's columns from
//       the shared-memory stages (db1 = sum_r dpre, db2 = sum_r g) in f32.
//       TMA cannot add: the addend's groups read an [split, M, d] scratch
//       xa = round(x + a[r mod n]) (`mlp_bwd_addend_bf16`, the forward's
//       rounding point), the others x in place.
//   At d = 1024 (`sm90::pair_instance`) the dx and weight passes run the
//   mainloop's pair instance (two-block clusters that multicast A; the
//   `<true>` kernels): dx is stored by TMA, the weight pass stores its bf16
//   gradients by TMA or, in accumulate mode, adds its tiles to the f32
//   totals by TMA reductions (no load of the totals on the consumer's
//   path). dh runs the single-block grid at every width (PERF.md).
// * bf16 recompute (pre == NULL, past SAVE_PRE_LIMIT only, on no measured
//   route; it replaces :_mlp_bwd_kernel in bf16): glom_tpu's
//   _mlp_bwd_kernel keeps z unrounded in f32, so the first product is
//   recomputed beside dh in a WMMA row pass (one block
//   per 32-row tile, per 64-column chunk of f: dh = g . w2^T and z = xa .
//   w1 + b1, the GELU derivative, dx += dpre . w1^T in shared memory),
//   which writes dx, dpre and h; a WMMA weight pass (one block per 64 x 64
//   tile of dw1 or dw2) walks all M rows.
// * f32 (every site in f32): the same two passes on the CUDA cores with
//   the erf GELU (the saved pre, where there is one, forms h in the weight
//   pass).
//
// Bound on the H100: at 989 TFLOP/s bf16 and 3.35 TB/s, at the flagship
// bucket 8 (G = 6, M = 2048, d = 512, f = 2048), bf16 from the saved pre, the
// function (read x, pre, g, w1, w2; write dx and the grads) is bound by its
// four products, 103 GFLOP, 0.104 ms. Per launch: dh 25.8 GFLOP (0.026 ms)
// against the pre read and the h and dpre writes, 3 x 50 MB, with g and w2
// 176 MB (0.053 ms): bound by bytes, so its epilogue reads pre as whole
// rows, after an L2 prefetch issued when the tile starts, and runs beside
// the other consumer's products; dx 25.8 GFLOP (0.026 ms) against 76 MB
// (0.023 ms); the weight pass 51.5 GFLOP (0.052 ms) against 151 MB (0.045
// ms), 2 x 384 tiles in one grid of 264 consumer slots (2.9 waves where
// each product alone is 1.45); in accumulate mode the f32 totals' read and
// write add 100 MB (0.075 ms: bytes), prefetched to L2 per tile and read
// back in batches.
//
// Kept out of device memory: every f32 sum (in registers from the first
// product to its rounding or its add into the totals) and dh (scaled by
// GELU'(pre) in the dh epilogue). h and dpre go through device memory once
// each way as [G, M, f] bf16 scratch, the price of parallel passes with no
// float atomics (the TPU kernel walks a group's rows in order and keeps its
// dw/db sums in VMEM).
//
// Rounding points are the TPU kernel's: h and dpre are rounded to x's type,
// every product accumulates in f32, dx is rounded once. bf16 uses the tanh
// GELU's derivative, f32 the erf form. With an addend, da_reduce sums the f32
// dx over the addend's groups and batch copies into da.
//
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "sm90_gemm.cuh"

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int FC = 64;        // hidden columns per chunk of the row pass
constexpr int TMB = 32;       // rows per row-pass block, bf16 (M's multiple)
constexpr int WIDE_TMB = 16;  // the same where TMB rows do not fit (RowBf16Layout)
constexpr int MAX_D = 1024;          // the widest d the row tiles are sized for
constexpr int TMF = 16;       // rows per row-pass block, f32
constexpr int WT = 64;        // weight-pass output tile
constexpr int WK = 32;        // weight-pass rows staged per step

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// GELU value and derivative in f32: the tanh form (bf16) or the erf form
// (f32). The tanh form takes t = tanh(u), u = c (z + k z^3), as 2 s - 1
// with s = 1 / (1 + exp(-2u)) from the fast exp and reciprocal: about half
// tanhf's instructions and none of its range branches, for the dh epilogue,
// which runs it on every [G, M, f] element and is bound by instruction
// issue. t rounds to f32 as tanhf's does, so 1 + t keeps the reference's
// rounding where GELU's tail cancels; exp overflows to inf far below 0,
// where t = -1.
__device__ __forceinline__ void gelu_tanh_vg(float z, float& val, float& grad) {
  const float c = 0.7978845608028654f, k = 0.044715f;
  const float s = __fdividef(1.0f, 1.0f + __expf(-2.0f * c * (z + k * (z * z * z))));
  const float t = 2.0f * s - 1.0f;
  val = z * (0.5f * (1.0f + t));
  grad = 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * c * (1.0f + 3.0f * k * z * z);
}

__device__ __forceinline__ void gelu_erf_vg(float z, float& val, float& grad) {
  const float Phi = 0.5f * (1.0f + erff(z * 0.7071067811865476f));
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  val = z * Phi;
  grad = Phi + z * phi;
}

// ------------------------------------------------- bf16, saved pre (sm90)

// xa[g, r, :] = round_bf16(x[g + x_lo, r, :] + a[r mod n, :]) for the
// addend's groups g < split, 8 elements (16 bytes) a thread: the weight
// pass's A operand for those groups (the forward's rounding point; its
// `mlp_fwd_addend_bf16` over one whole-M slab).
__global__ void mlp_bwd_addend_bf16(const bf16* __restrict__ x, const bf16* __restrict__ a, int n,
                                    bf16* __restrict__ xa, int split, int x_lo, int M, int d) {
  const size_t per_group = static_cast<size_t>(M) * d / 8;
  const size_t total = per_group * split;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(i / per_group);
    const size_t e = (i - g * per_group) * 8;
    const int r = static_cast<int>(e / d), c = static_cast<int>(e % d);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + ((size_t)(g + x_lo) * M + r) * d + c);
    const uint4 av = *reinterpret_cast<const uint4*>(a + (size_t)(r % n) * d + c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&av);
    uint4 ov;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 xf = __bfloat1622float2(xp[k]), af = __bfloat1622float2(ap[k]);
      op[k] = __floats2bfloat162_rn(xf.x + af.x, xf.y + af.y);
    }
    *reinterpret_cast<uint4*>(xa + ((size_t)g * M + r) * d + c) = ov;
  }
}

__device__ __forceinline__ __nv_bfloat162 round2(float v0, float v1) {
  return __floats2bfloat162_rn(v0, v1);
}

// The dh pass's epilogue over a [G, M, f] tile half: the warp's 16 rows of
// the saved pre come in through its stage as 16-byte row loads; each pair
// takes GELU and GELU' of pre, leaves h = round(GELU(pre)) in the stage
// (written out as whole rows) and dh * GELU'(pre) in the sums, stored as
// dpre = round(dh * GELU'(pre)).
struct DhEpilogue {
  const bf16* pre;
  bf16* h;
  bf16* dpre;
  int M;
  // The tile's pre, row t: its two 128-byte lines.
  __device__ void prefetch(int g, int abs_row, int col0, int t, const sm90::Shape& s) const {
    if (abs_row + t >= s.row_end) return;
    const bf16* p = pre + ((size_t)g * M + abs_row + t) * s.N + col0;
    sm90::prefetch_l2(p);
    if (col0 + 64 < s.N) sm90::prefetch_l2(p + 64);
  }
  __device__ void operator()(float (&acc)[sm90::ACC], int g, int abs_row, int, int col0, int t,
                             uint32_t* stage, const sm90::Shape& s) const {
    const size_t at = ((size_t)g * M + abs_row) * s.N + col0;
    const int rows = s.row_end - abs_row, cols = s.N - col0;
    const int w16 = 16 * (t / 32);
    sm90::fill_stage(stage, t, pre + at, s.N, rows, cols);
    sm90::for_each_pair(acc, t, [&](int r, int c, float& v0, float& v1) {
      uint32_t& u = sm90::stage_at(stage, r - w16, c);
      const float2 z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
      float h0, h1, d0, d1;
      gelu_tanh_vg(z.x, h0, d0);
      gelu_tanh_vg(z.y, h1, d1);
      const __nv_bfloat162 hv = round2(h0, h1);
      u = *reinterpret_cast<const uint32_t*>(&hv);
      v0 *= d0;
      v1 *= d1;
    });
    __syncwarp();
    sm90::flush_stage(stage, t, h + at, s.N, rows, cols);
    sm90::store_half(acc, t, stage, dpre + at, s.N, rows, cols,
                     [](int, int, float v0, float v1) { return round2(v0, v1); });
  }
};

// The dx pass's epilogue over a [G, M, d] tile half: dx rounded once; the
// addend's groups (g < split) also store the f32 sums for da_reduce.
struct DxEpilogue {
  bf16* dx;
  float* dx32;
  int M, split;
  __device__ void operator()(const float (&acc)[sm90::ACC], int g, int abs_row, int, int col0,
                             int t, uint32_t* stage, const sm90::Shape& s) const {
    const size_t at = ((size_t)g * M + abs_row) * s.N + col0;
    const int rows = s.row_end - abs_row, cols = s.N - col0;
    sm90::store_half(acc, t, stage, dx + at, s.N, rows, cols,
                     [](int, int, float v0, float v1) { return round2(v0, v1); });
    if (g < split)
      sm90::for_each_pair(acc, t, [&](int r, int c, float v0, float v1) {
        if (r < rows && c < cols)
          *reinterpret_cast<float2*>(dx32 + at + (size_t)r * s.N + c) = make_float2(v0, v1);
      });
  }
};

// The weight pass's epilogue: problem 0 is dw1 [G, d, f] with db1 [G, f],
// problem 1 dw2 [G, f, d] with db2 [G, d] (shape.id). A tile's sums are
// stored rounded to bf16, or with ACC added to the f32 totals in place
// (total + this call's sum); so are its column sums.
template <bool ACC>
struct DwEpilogue {
  void* C[2];
  void* colsum[2];
  // With ACC, the tile's f32 totals, row t: its four 128-byte lines.
  __device__ void prefetch(int g, int abs_row, int col0, int t, const sm90::Shape& s) const {
    if constexpr (ACC) {
      if (abs_row + t >= s.row_end) return;
      const float* p = static_cast<const float*>(C[s.id]) +
                       ((size_t)g * s.row_end + abs_row + t) * s.N + col0;
      for (int c = 0; c < sm90::BN && col0 + c < s.N; c += 32) sm90::prefetch_l2(p + c);
    }
  }
  __device__ void operator()(const float (&acc)[sm90::ACC], int g, int abs_row, int, int col0,
                             int t, uint32_t* stage, const sm90::Shape& s) const {
    const size_t at = ((size_t)g * s.row_end + abs_row) * s.N + col0;
    const int rows = s.row_end - abs_row, cols = s.N - col0;
    if constexpr (ACC) {
      // The fragment's pairs (for_each_pair's layout: rows r and r + 8,
      // columns 8j + c) in batches of four j, each batch's eight loads of
      // the totals issued before its stores, so a batch waits on memory
      // once and not once a pair.
      const int r = 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
      float* total = static_cast<float*>(C[s.id]) + at + (size_t)r * s.N + c;
      const bool ok0 = r < rows, ok1 = r + 8 < rows;
#pragma unroll
      for (int j0 = 0; j0 < sm90::BN / 8; j0 += 4) {
        float2 old[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool col_ok = 8 * (j0 + j) + c < cols;
          float* p = total + 8 * (j0 + j);
          if (ok0 && col_ok) old[j][0] = *reinterpret_cast<const float2*>(p);
          if (ok1 && col_ok) old[j][1] = *reinterpret_cast<const float2*>(p + 8 * (size_t)s.N);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool col_ok = 8 * (j0 + j) + c < cols;
          const float* v = acc + 4 * (j0 + j);
          float* p = total + 8 * (j0 + j);
          if (ok0 && col_ok)
            *reinterpret_cast<float2*>(p) = make_float2(old[j][0].x + v[0], old[j][0].y + v[1]);
          if (ok1 && col_ok)
            *reinterpret_cast<float2*>(p + 8 * (size_t)s.N) =
                make_float2(old[j][1].x + v[2], old[j][1].y + v[3]);
        }
      }
    } else {
      sm90::store_half(acc, t, stage, static_cast<bf16*>(C[s.id]) + at, s.N, rows, cols,
                       [](int, int, float v0, float v1) { return round2(v0, v1); });
    }
  }
  __device__ void col_sum(float v, int g, int col, const sm90::Shape& s) const {
    if (col >= s.N) return;
    const size_t at = (size_t)g * s.N + col;
    if constexpr (ACC)
      static_cast<float*>(colsum[s.id])[at] += v;
    else
      static_cast<bf16*>(colsum[s.id])[at] = __float2bfloat16(v);
  }
};

// The pair instance's epilogues (sm90_gemm.cuh): the same arithmetic and
// rounding points as those above, its bf16 outputs stored from the warp
// stage by TMA and its f32 totals added by TMA reductions. The dh pass runs
// the single-block instance at every width (PERF.md: its K loop is
// 16 steps and its epilogue the longer part; on two-block clusters the
// pass ran 4 % slower, with an epilogue that took the saved pre in by
// cp.async and stored h and dpre by TMA 11 % slower).

// dx: rounded once and stored by TMA; the addend's groups (g < split) also
// store the f32 sums for da_reduce.
struct DxPairEpilogue {
  CUtensorMap dx_map;  // [G, M, d], box [64, 16, 1]
  float* dx32;
  int M, split;
  __device__ void operator()(const float (&acc)[sm90::ACC], int g, int abs_row, int, int col0,
                             int t, uint32_t* stage, const sm90::Shape& s) const {
    sm90::pair_store_half(acc, t, stage, &dx_map, col0, abs_row, g,
                          [](int, float v0, float v1) { return round2(v0, v1); });
    if (g < split) {
      const size_t at = ((size_t)g * M + abs_row) * s.N + col0;
      const int rows = s.row_end - abs_row;
      sm90::for_each_pair(acc, t, [&](int r, int c, float v0, float v1) {
        if (r < rows)
          *reinterpret_cast<float2*>(dx32 + at + (size_t)r * s.N + c) = make_float2(v0, v1);
      });
    }
  }
};

// The weight pass: problem 0 is dw1 [G, d, f] with db1 [G, f], problem 1
// dw2 [G, f, d] with db2 [G, d] (shape.id), as DwEpilogue. With ACC the
// tile's sums are added to the f32 totals by TMA reductions from the warp
// stage (`sm90::pair_reduce_half`, cp.reduce.async.bulk .add.f32) and the
// column sums with `red.global.add`, so no load of the totals is on the
// consumer's path. Each element of the totals still takes exactly one add,
// total + this call's sum (one block owns it, and an IEEE add commutes),
// rounded to nearest like the load-add-store. Without ACC the tile is
// rounded and stored by TMA.
template <bool ACC>
struct DwPairEpilogue {
  // ACC: the f32 totals dw1 [G, d, f], dw2 [G, f, d], box [32, 16, 1]; else
  // the bf16 gradients, box [64, 16, 1].
  CUtensorMap out_map[2];
  void* colsum[2];
  __device__ void operator()(const float (&acc)[sm90::ACC], int g, int abs_row, int, int col0,
                             int t, uint32_t* stage, const sm90::Shape& s) const {
    if constexpr (ACC)
      sm90::pair_reduce_half(acc, t, stage, &out_map[s.id], col0, abs_row, g);
    else
      sm90::pair_store_half(acc, t, stage, &out_map[s.id], col0, abs_row, g,
                            [](int, float v0, float v1) { return round2(v0, v1); });
  }
  __device__ void col_sum(float v, int g, int col, const sm90::Shape& s) const {
    if (col >= s.N) return;
    const size_t at = (size_t)g * s.N + col;
    if constexpr (ACC)
      atomicAdd(static_cast<float*>(colsum[s.id]) + at, v);
    else
      static_cast<bf16*>(colsum[s.id])[at] = __float2bfloat16(v);
  }
};

// The three passes' kernels, named for profiles; PAIR: the pair instance.
__global__ void __launch_bounds__(sm90::THREADS, 1)
mlp_bwd_dh_sm90(const __grid_constant__ CUtensorMap g_map,
                const __grid_constant__ CUtensorMap w2_map, const sm90::Shape shape,
                const DhEpilogue epi) {
  sm90::gemm_tiles<false, true>(g_map, g_map, w2_map, shape, epi);
}

template <bool PAIR>
__global__ void __launch_bounds__(sm90::THREADS, 1)
mlp_bwd_dx_sm90(const __grid_constant__ CUtensorMap dpre_map,
                const __grid_constant__ CUtensorMap w1_map, const sm90::Shape shape,
                const __grid_constant__ std::conditional_t<PAIR, DxPairEpilogue, DxEpilogue> epi) {
  sm90::gemm_tiles<false, true, false, PAIR>(dpre_map, dpre_map, w1_map, shape, epi);
}

template <bool ACC, bool PAIR>
__global__ void __launch_bounds__(sm90::THREADS, 1)
mlp_bwd_dw_sm90(const __grid_constant__ CUtensorMap xa_map,
                const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap dpre_map,
                const __grid_constant__ CUtensorMap h_map,
                const __grid_constant__ CUtensorMap g_map,
                const sm90::Shape s1, const sm90::Shape s2,
                const __grid_constant__
                std::conditional_t<PAIR, DwPairEpilogue<ACC>, DwEpilogue<ACC>> epi) {
  const sm90::Operands ops[2] = {{&xa_map, &x_map, &dpre_map, s1}, {&h_map, &h_map, &g_map, s2}};
  sm90::gemm_problems<true, false, true, PAIR>(ops, epi);
}

// Each pass's launch flags (shared-memory cap lifted, per device) and, for
// the pair instance, the clusters each device holds at once.
struct PassLaunch {
  bool lifted[2][sm90::MAX_DEVICES];
  int clusters[sm90::MAX_DEVICES];
};


// The bf16 saved-pre backward: [xa], dh, dx, the weight pass. The
// cotangent has max(split, G - split) slots (every slot a group reads), x
// G - split past x_lo's (the forward's x map). d and f alone pick the
// instance (`sm90::pair_instance`).
PassLaunch launch_dh, launch_dx, launch_dw[2];

cudaError_t bwd_bf16_saved(const bf16* x, const bf16* a, int n, const bf16* w1, const bf16* w2,
                           const bf16* pre, const bf16* gout, bf16* dx, void* dw1, void* db1,
                           void* dw2, void* db2, bf16* h_ws, bf16* dpre_ws, float* dx32,
                           bf16* xa, int G, int M, int d, int f, int split, int x_lo,
                           bool accumulate, cudaStream_t s) {
  const int g_slots = split > G - split ? split : G - split;
  const bool pair = sm90::pair_instance(d, f);
  const int a_box = pair ? 64 : sm90::BM;  // the pair's blocks load half of A each
  CUtensorMap g_a, w2_b, dpre_a, w1_b, xa_mn, x_mn, dpre_b, h_mn, g_b;
  cudaError_t err = sm90::make_kmajor_map(&g_a, gout, d, M, g_slots);
  if (err == cudaSuccess) err = sm90::make_kmajor_map(&w2_b, w2, d, f, G);
  if (err == cudaSuccess) err = sm90::make_kmajor_map(&dpre_a, dpre_ws, f, M, G, a_box);
  if (err == cudaSuccess) err = sm90::make_kmajor_map(&w1_b, w1, f, d, G);
  if (err == cudaSuccess) err = sm90::make_mnmajor_map(&x_mn, x, M, d, split < G ? G - split : 1);
  if (err == cudaSuccess && split > 0) err = sm90::make_mnmajor_map(&xa_mn, xa, M, d, split);
  if (err == cudaSuccess) err = sm90::make_mnmajor_map(&dpre_b, dpre_ws, M, f, G);
  if (err == cudaSuccess) err = sm90::make_mnmajor_map(&h_mn, h_ws, M, f, G);
  if (err == cudaSuccess) err = sm90::make_mnmajor_map(&g_b, gout, M, d, g_slots);
  CUtensorMap dx_st;  // the pair instance's store map of dx
  if (err == cudaSuccess && pair) err = sm90::make_store_map(&dx_st, dx, d, M, G);
  if (err != cudaSuccess) return err;
  if (split == 0) xa_mn = x_mn;  // not read: no group is below split
  if (split > 0) {
    const size_t vecs = static_cast<size_t>(split) * M * d / 8;
    const int blocks = static_cast<int>((vecs + 255) / 256 < 8192 ? (vecs + 255) / 256 : 8192);
    mlp_bwd_addend_bf16<<<blocks, 256, 0, s>>>(x, a, n, xa, split, x_lo, M, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // dh: the cotangent's slots by the group rule, w2 [f, d] K-major.
  const sm90::Shape s_dh{d, f, G, split, 0, M};
  err = sm90::launch_tiles(mlp_bwd_dh_sm90, launch_dh.lifted[0], sm90::tile_count(s_dh), s, g_a,
                           w2_b, s_dh, DhEpilogue{pre, h_ws, dpre_ws, M});
  if (err != cudaSuccess) return err;
  // dx: dpre at slot g for every group (split 0), w1 [d, f] K-major.
  const sm90::Shape s_dx{f, d, G, 0, 0, M};
  const int dx_tiles = sm90::tile_count(s_dx);
  if (pair)
    err = sm90::launch_pairs(mlp_bwd_dx_sm90<true>, launch_dx.lifted[1], launch_dx.clusters,
                             dx_tiles, s, dpre_a, w1_b, s_dx,
                             DxPairEpilogue{dx_st, dx32, M, split});
  else
    err = sm90::launch_tiles(mlp_bwd_dx_sm90<false>, launch_dx.lifted[0], dx_tiles, s, dpre_a,
                             w1_b, s_dx, DxEpilogue{dx, dx32, M, split});
  if (err != cudaSuccess) return err;
  // dw1 = xa^T . dpre (A: xa for the addend's groups, x for the rest);
  // dw2 = h^T . g (A: h at slot g; B: the cotangent by the group rule).
  sm90::Shape s_dw1{M, f, G, split, 0, d};
  sm90::Shape s_dw2{M, d, G, 0, 0, f};
  s_dw2.b_split = split;
  s_dw2.id = 1;
  const int tiles = sm90::tile_count(s_dw1) + sm90::tile_count(s_dw2);
  PassLaunch& dw = launch_dw[accumulate ? 1 : 0];
  if (pair) {
    // The weight gradients' maps: the f32 totals reduced into (accumulate
    // mode), or the bf16 gradients stored.
    CUtensorMap grads[2];
    err = accumulate ? sm90::make_f32_map(&grads[0], dw1, f, d, G)
                     : sm90::make_store_map(&grads[0], dw1, f, d, G);
    if (err == cudaSuccess)
      err = accumulate ? sm90::make_f32_map(&grads[1], dw2, d, f, G)
                       : sm90::make_store_map(&grads[1], dw2, d, f, G);
    if (err != cudaSuccess) return err;
    if (accumulate)
      return sm90::launch_pairs(mlp_bwd_dw_sm90<true, true>, dw.lifted[1], dw.clusters, tiles, s,
                                xa_mn, x_mn, dpre_b, h_mn, g_b, s_dw1, s_dw2,
                                DwPairEpilogue<true>{{grads[0], grads[1]}, {db1, db2}});
    return sm90::launch_pairs(mlp_bwd_dw_sm90<false, true>, dw.lifted[1], dw.clusters, tiles, s,
                              xa_mn, x_mn, dpre_b, h_mn, g_b, s_dw1, s_dw2,
                              DwPairEpilogue<false>{{grads[0], grads[1]}, {db1, db2}});
  }
  if (accumulate)
    return sm90::launch_tiles(mlp_bwd_dw_sm90<true, false>, dw.lifted[0], tiles, s, xa_mn, x_mn,
                              dpre_b, h_mn, g_b, s_dw1, s_dw2,
                              DwEpilogue<true>{{dw1, dw2}, {db1, db2}});
  return sm90::launch_tiles(mlp_bwd_dw_sm90<false, false>, dw.lifted[0], tiles, s, xa_mn, x_mn,
                            dpre_b, h_mn, g_b, s_dw1, s_dw2,
                            DwEpilogue<false>{{dw1, dw2}, {db1, db2}});
}

// ------------------------------------------------ bf16 recompute, f32 (row pass)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Shared memory of the bf16 recompute row pass: TMB rows, or WIDE_TMB from
// d = 832 on, where 32 rows' g, x and f32 dx tiles exceed a block's shared
// memory (285,696 bytes at d = 1024, glom_tpu's imagenet224-pod width).
template <int TMB>
struct RowBf16Layout {
  int ld, ldacc, ldc, ldcb;
  size_t x_off, acc_off, dh_off, z_off, dp_off, bytes;
  __host__ __device__ explicit RowBf16Layout(int d)
      : ld(d + 8), ldacc(d + 4), ldc(FC + 4), ldcb(FC + 8) {
    x_off = align128(sizeof(bf16) * TMB * ld);  // after the g tile
    acc_off = x_off + align128(sizeof(bf16) * TMB * ld);
    dh_off = acc_off + align128(sizeof(float) * TMB * ldacc);
    z_off = dh_off + align128(sizeof(float) * TMB * ldc);
    dp_off = z_off + align128(sizeof(float) * TMB * ldc);
    bytes = dp_off + align128(sizeof(bf16) * TMB * ldcb);
  }
};

template <int TMB>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_rows_bf16(const bf16* __restrict__ x, const bf16* __restrict__ a, int n,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ gout,
                  bf16* __restrict__ dx, float* __restrict__ dx32, bf16* __restrict__ h_ws,
                  bf16* __restrict__ dpre_ws, int M, int d, int f, int split, int x_lo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowBf16Layout<TMB> lay(d);
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
    bf16 v = x[(xrow0 + r) * d + c];
    if (a != nullptr)
      v = __float2bfloat16(__bfloat162float(v) +
                           __bfloat162float(a[(size_t)((m0 + r) % n) * d + c]));
    xs[r * lay.ld + c] = v;
    acc[r * lay.ldacc + c] = 0.0f;
  }
  __syncthreads();

  const bf16* w1g = w1 + (size_t)g * d * f;
  const bf16* w2g = w2 + (size_t)g * f * d;
  const bf16* b1g = b1 + (size_t)g * f;

  for (int c0 = 0; c0 < f; c0 += FC) {
    // dh [TM, FC] = g . w2[c0:c0+FC, :]^T and z = xa . w1[:, c0:c0+FC]:
    // one 16x16 tile a warp (half the warps at WIDE_TMB).
    if (warp < (TMB / 16) * (FC / 16)) {
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
      wmma::fill_fragment(t, 0.0f);
      for (int k = 0; k < d; k += 16) {
        FragB bf;
        wmma::load_matrix_sync(af, xs + rf * 16 * lay.ld + k, lay.ld);
        wmma::load_matrix_sync(bf, w1g + (size_t)k * f + c0 + cf * 16, f);
        wmma::mma_sync(t, af, bf, t);
      }
      wmma::store_matrix_sync(zs + rf * 16 * lay.ldc + cf * 16, t, lay.ldc, wmma::mem_row_major);
    }
    __syncthreads();
    // GELU value and derivative of z = sum + b1 in f32; h and dpre rounded
    // to bf16.
    for (int e = tid; e < TMB * FC; e += THREADS) {
      const int r = e / FC, j = e - r * FC;
      const size_t idx = (row0 + r) * f + c0 + j;
      float val, grad;
      gelu_tanh_vg(zs[r * lay.ldc + j] + __bfloat162float(b1g[c0 + j]), val, grad);
      const bf16 dp = __float2bfloat16(dhs[r * lay.ldc + j] * grad);
      h_ws[idx] = __float2bfloat16(val);
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
// a block. h is read from the row pass's workspace (bf16: recompute only),
// or in f32 formed from the saved pre as it is staged. With ACC, C and the
// column sums are f32 totals: the block adds its sums to its tile of them
// in place.

struct WeightOperands {
  const void* A;       // [S, M, NA]
  const void* addend;  // [n, NA] or NULL, added to A rows on load
  bool gelu;           // A is the saved pre: stage GELU(A) (f32 only)
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
mlp_bwd_weights_bf16(const bf16* x, const bf16* a, int n, const bf16* h_ws, const bf16* dpre_ws,
                     const bf16* gout, void* dw1, void* db1, void* dw2, void* db2, int M, int d,
                     int f, int split, int x_lo) {
  constexpr int LDW = WT + 8, LDC = WT + 4;
  __shared__ __align__(128) unsigned char staged[2 * sizeof(bf16) * WK * LDW];
  __shared__ __align__(128) float Cs[WT * LDC];
  bf16* As = reinterpret_cast<bf16*>(staged);  // [WK][LDW]
  bf16* Bs = As + WK * LDW;                    // [WK][LDW]

  const int g = blockIdx.y;
  const WeightOperands op = operands(blockIdx.z, g, split, x_lo, x, a, nullptr, h_ws, dpre_ws,
                                     gout, dw1, db1, dw2, db2, d, f);
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

}  // namespace

extern "C" {

// x: [S, M, d] slots and gout: [S', M, d] slots, group g reading x slot
// g < split ? g + x_lo : g - split and gout slot g < split ? g : g - split
// (a plain launch: S = S' = G, x_lo = 0, split = G with an addend, else 0);
// dx: [G, M, d]; a: [n, d], taken by the groups below split, or NULL (then
// split = 0 and da, dx32_ws, xa_ws are NULL too); w1, dw1: [G, d, f]; b1,
// db1: [G, f]; w2, dw2: [G, f, d]; db2: [G, d]; pre: the forward's saved
// [G, M, f] pre-activation, or NULL to recompute it; dpre_ws: [G, M, f]
// workspace; h_ws: [G, M, f] workspace, unused in f32 with a saved pre;
// dx32_ws: f32 [split, M, d]; xa_ws: [split, M, d] workspace, bf16 with a
// saved pre and an addend only; da: [n, d]. All but dx32_ws of one dtype
// (is_bf16 selects bf16, else f32), contiguous, on the current device; in
// bf16 with a saved pre x, gout, pre, w1, w2 and the workspaces 16-byte
// aligned (TMA). With `accumulate`, dw1, db1, dw2, db2 and da are f32
// totals that this call adds to in place. Returns a cudaError_t.
int grouped_mlp_bwd(const void* x, const void* a, int n, const void* w1, const void* b1,
                    const void* w2, const void* pre, const void* gout, void* dx, void* dw1,
                    void* db1, void* dw2, void* db2, void* da, void* h_ws, void* dpre_ws,
                    void* dx32_ws, void* xa_ws, int G, int M, int d, int f, int split, int x_lo,
                    int accumulate, int is_bf16, void* stream) {
  const int tm = is_bf16 ? TMB : TMF;
  const bool add = a != nullptr;
  const bool saved_sm90 = is_bf16 && pre != nullptr;
  if (G < 1 || M % tm != 0 || M % WK != 0 || d % WT != 0 || d > MAX_D || f % WT != 0 ||
      dpre_ws == nullptr ||
      ((pre == nullptr || is_bf16) && h_ws == nullptr) || split < 0 || split > G || x_lo < 0 ||
      add != (split > 0) ||
      (add && (n < 1 || M % n != 0 || da == nullptr || dx32_ws == nullptr)) ||
      (saved_sm90 && add && xa_ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (saved_sm90) {
    err = bwd_bf16_saved(static_cast<const bf16*>(x), static_cast<const bf16*>(a), n,
                         static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
                         static_cast<const bf16*>(pre), static_cast<const bf16*>(gout),
                         static_cast<bf16*>(dx), dw1, db1, dw2, db2, static_cast<bf16*>(h_ws),
                         static_cast<bf16*>(dpre_ws), static_cast<float*>(dx32_ws),
                         static_cast<bf16*>(xa_ws), G, M, d, f, split, x_lo, accumulate != 0, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    static bool lifted_bf16[sm90::MAX_DEVICES], lifted_bf16_wide[sm90::MAX_DEVICES];
    static bool lifted_f32[sm90::MAX_DEVICES];
    const dim3 rows(M / tm, G);
    const dim3 weights((d / WT) * (f / WT), G, 2);
    if (is_bf16) {
      const bool narrow = RowBf16Layout<TMB>(d).bytes <= sm90::SMEM_OPTIN;
      err = narrow ? sm90::lift_smem_cap(mlp_bwd_rows_bf16<TMB>, lifted_bf16)
                   : sm90::lift_smem_cap(mlp_bwd_rows_bf16<WIDE_TMB>, lifted_bf16_wide);
      if (err != cudaSuccess) return (int)err;
      auto rows_bf16 = narrow ? mlp_bwd_rows_bf16<TMB> : mlp_bwd_rows_bf16<WIDE_TMB>;
      const dim3 row_grid(M / (narrow ? TMB : WIDE_TMB), G);
      rows_bf16<<<row_grid, THREADS,
                  narrow ? RowBf16Layout<TMB>(d).bytes : RowBf16Layout<WIDE_TMB>(d).bytes, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(a), n,
          static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
          static_cast<const bf16*>(w2), static_cast<const bf16*>(gout), static_cast<bf16*>(dx),
          static_cast<float*>(dx32_ws), static_cast<bf16*>(h_ws), static_cast<bf16*>(dpre_ws),
          M, d, f, split, x_lo);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      auto weights_bf16 = accumulate ? mlp_bwd_weights_bf16<true> : mlp_bwd_weights_bf16<false>;
      weights_bf16<<<weights, THREADS, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(a), n,
          static_cast<const bf16*>(h_ws), static_cast<const bf16*>(dpre_ws),
          static_cast<const bf16*>(gout), dw1, db1, dw2, db2, M, d, f, split, x_lo);
    } else {
      err = sm90::lift_smem_cap(mlp_bwd_rows_f32, lifted_f32);
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
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (add) {
    // da: an f32 total (accumulate mode, or f32), or bf16.
    const int blocks = (n * d + THREADS - 1) / THREADS;
    if (accumulate || !is_bf16)
      da_reduce<float><<<blocks, THREADS, 0, s>>>(static_cast<const float*>(dx32_ws),
                                                  static_cast<float*>(da), split, M, n, d,
                                                  accumulate);
    else
      da_reduce<bf16><<<blocks, THREADS, 0, s>>>(static_cast<const float*>(dx32_ws),
                                                 static_cast<bf16*>(da), split, M, n, d, 0);
  }
  return (int)cudaGetLastError();
}

// The pair instance's backward launches (sm90::launch_pairs): how many
// clusters of two the device holds at once for the dx and weight passes
// (the weight pass in accumulate mode and plain). Returns a cudaError_t.
int grouped_mlp_bwd_gemm_launch(int* clusters_dx, int* clusters_dw_acc, int* clusters_dw) {
  cudaError_t err = sm90::lift_smem_cap(mlp_bwd_dx_sm90<true>, launch_dx.lifted[1]);
  if (err == cudaSuccess)
    err = sm90::lift_smem_cap(mlp_bwd_dw_sm90<true, true>, launch_dw[1].lifted[1]);
  if (err == cudaSuccess)
    err = sm90::lift_smem_cap(mlp_bwd_dw_sm90<false, true>, launch_dw[0].lifted[1]);
  if (err == cudaSuccess) err = sm90::pair_clusters_resident(mlp_bwd_dx_sm90<true>, clusters_dx);
  if (err == cudaSuccess)
    err = sm90::pair_clusters_resident(mlp_bwd_dw_sm90<true, true>, clusters_dw_acc);
  if (err == cudaSuccess)
    err = sm90::pair_clusters_resident(mlp_bwd_dw_sm90<false, true>, clusters_dw);
  return (int)err;
}

const char* grouped_mlp_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
