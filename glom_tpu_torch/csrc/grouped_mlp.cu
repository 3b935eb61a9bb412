// K1 forward: the grouped per-level MLP, level-major.
//
//   out[g, r] = GELU((x[g, r] (+ a[r mod n])) . w1[g] + b1[g]) . w2[g] + b2[g]
//
// For training it can also write the pre-activation pre = xa . w1 + b1,
// [G, M, f] in x's type, for the backward (csrc/grouped_mlp_bwd.cu). The
// store is a template parameter, so the serving launch compiles it out.
// The pre-only entry (grouped_mlp_pre, the whole-loop VJP's remat
// recompute) runs the first product alone and writes pre and nothing else.
// It forms and stores pre with the very code the training forward saves
// it with, so the recomputed pre is bit for bit the one the forward would
// have saved, and remat gradients equal non-remat ones exactly.
//
// The combined td || bu grid (the whole-loop VJP's one launch a phase):
// one launch over 2L-1 groups whose weights are the top-down groups'
// followed by the bottom-up ones'. A group rule replaces the caller's slot
// views: group g < split takes the addend and reads x slot g + x_lo, group
// g >= split reads slot g - split, so the launch reads the loop's [L+1]-slot
// carry in place (split = L-1, x_lo = 2: top-down reads slots 2..L,
// bottom-up slots 0..L-1). A plain launch is split = G (addend) or 0, x_lo =
// 0. Each group's arithmetic is the split launches', so the two grids give
// the same bits.
//
// Replaces: glom_tpu/kernels/grouped_mlp.py:_mlp_kernel (bottom-up) and
// :_mlp_kernel_add (top-down, with the positional addend folded into the
// tile load); also glom_tpu/kernels/fused_loop.py:_ffw_fwd_ext (the same
// kernels reading a slot of the loop's carry: here the caller passes the
// slot's pointer) and :_pre_kernel / :_pre_add_kernel (the pre-only entry),
// and, over the combined grid, :_ffw_fwd_cat and :_pre_fwd_cat.
//
// Bound on the H100: tensor-core operations. At the flagship bottom-up
// shape (G = 6, M = 2048, d = 512, f = 2048) the two products are 51.5
// GFLOP (0.052 ms at 989 TFLOP/s) against about 50 MB of weights, input and
// output (0.015 ms at 3.35 TB/s). The pre-only launch does one product
// (25.8 GFLOP, 0.026 ms) and moves about 75 MB, the [G, M, f] pre included
// (0.022 ms): still bound by operations, barely.
//
// bf16 design: two passes of the Hopper GEMM mainloop (sm90_gemm.cuh: a
// persistent grid of 128 x 128 tiles, two consumer warpgroups on wgmma
// with f32 sums in registers, each fed by its own producer warp through a
// 3-stage shared-memory ring of TMA loads, so one tile's epilogue runs
// beside the other consumer's products).
//   * Pass 1 computes xa . w1; its epilogue adds b1, stores pre rounded to
//     bf16 (training), takes the tanh GELU of the f32 sum and stores h
//     rounded to bf16, as the reference rounds it, to a [G, R, f] scratch.
//     The pre-only entry is pass 1 with the pre store and no h.
//   * Pass 2 computes h . w2; its epilogue adds b2 and rounds.
//   * TMA cannot add, so the addend groups' A operand xa = round_bf16(x +
//     a[r mod n]) is written first by a small elementwise kernel to a
//     [split, R, d] scratch, the rounding point the reference has; pass 1
//     reads that scratch for groups below split and x in place for the
//     rest (the mainloop's group rule).
// Rows past M and columns past f or d are zero-filled by TMA on load and
// masked on store, so any M % 32 == 0 and d, f % 64 == 0 run.
//
// Kept out of device memory: every f32 sum (in registers from the first
// product to its rounding) and, in f32, the [G, M, f] hidden layer (in
// shared memory, below). In bf16 the rounded hidden goes through device
// memory once each way (100 MB at the flagship bucket 8, about 0.03 ms):
// the TPU kernel keeps it in VMEM, but a fused form would need a [rows, d]
// f32 output accumulator in registers, which 128-row tiles at d = 512 do
// not leave room for. The caller bounds that scratch: past its cap the
// pass pair runs over row slabs of R rows (the wrapper's `slab_rows`),
// each slab's h in the same [G, R, f] buffer.
//
// f32: the exact erf GELU and FMA on the CUDA cores (below), the reference
// kernel's rules for that dtype.
//
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_gemm.cuh"

namespace {

constexpr int TM = 32;        // f32: rows of x per block
constexpr int FC = 64;        // f32: hidden columns per chunk
constexpr int THREADS = 256;  // f32: 8 warps

__device__ __forceinline__ float gelu_tanh(float z) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return z * (0.5f * (1.0f + tanhf(c * (z + 0.044715f * (z * z * z)))));
}

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.7071067811865476f));
}

using bf16 = __nv_bfloat16;

// xa[g, r - r0, :] = round_bf16(x[g + x_lo, r, :] + a[r mod n, :]) for the
// slab's rows r0 <= r < r0 + rows and the addend's groups g < split; 8
// elements (16 bytes) a thread. xa is [split, R, d].
__global__ void mlp_fwd_addend_bf16(const bf16* __restrict__ x, const bf16* __restrict__ a, int n,
                           bf16* __restrict__ xa, int split, int x_lo, int M, int d, int R,
                           int r0, int rows) {
  const size_t per_group = static_cast<size_t>(rows) * d / 8;
  const size_t total = per_group * split;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(i / per_group);
    const size_t e = (i - g * per_group) * 8;
    const int r = static_cast<int>(e / d), c = static_cast<int>(e % d);
    const uint4 xv =
        *reinterpret_cast<const uint4*>(x + ((size_t)(g + x_lo) * M + r0 + r) * d + c);
    const uint4 av = *reinterpret_cast<const uint4*>(a + (size_t)((r0 + r) % n) * d + c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&av);
    uint4 ov;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 xf = __bfloat1622float2(xp[k]), af = __bfloat1622float2(ap[k]);
      op[k] = __floats2bfloat162_rn(xf.x + af.x, xf.y + af.y);
    }
    *reinterpret_cast<uint4*>(xa + ((size_t)g * R + r) * d + c) = ov;
  }
}

// Pass 1's epilogue: z = sum + b1 in f32; pre = round(z) at absolute rows
// of [G, M, f] (SAVE_PRE), h = round(GELU_tanh(z)) at slab rows of the
// [G, R, f] scratch (STORE_H). The pre-only entry is <true, false>.
template <bool SAVE_PRE, bool STORE_H>
struct HiddenEpilogue {
  const bf16* b1;
  bf16* pre;
  bf16* h;
  int M, R;
  __device__ void operator()(const float (&acc)[sm90::ACC], int g, int abs_row, int rel_row,
                             int col0, int t, uint32_t* stage, const sm90::Shape& s) const {
    const bf16* bias = b1 + (size_t)g * s.N + col0;
    const int rows = s.row_end - abs_row, cols = s.N - col0;
    // + b1, in f32, for the pair (c, c + 1). store_half evaluates every
    // column of the tile and masks only its stores, so in a tile narrower
    // than BN (the last, where f is not a multiple of BN) the pairs past
    // `cols` read the bias at the tile's last pair instead of past its end
    // (in the last group, past its buffer); their values are not stored.
    // c is even and cols a multiple of 64, so a stored pair reads its own.
    auto b = [&](int c) {
      const int cc = min(c, cols - 2);
      return make_float2(__bfloat162float(bias[cc]), __bfloat162float(bias[cc + 1]));
    };
    if constexpr (SAVE_PRE)
      sm90::store_half(acc, t, stage, pre + ((size_t)g * M + abs_row) * s.N + col0, s.N, rows,
                       cols, [&](int, int c, float v0, float v1) {
                         const float2 z = b(c);
                         return __floats2bfloat162_rn(v0 + z.x, v1 + z.y);
                       });
    if constexpr (STORE_H)
      sm90::store_half(acc, t, stage, h + ((size_t)g * R + rel_row) * s.N + col0, s.N, rows,
                       cols, [&](int, int c, float v0, float v1) {
                         const float2 z = b(c);
                         return __floats2bfloat162_rn(gelu_tanh(v0 + z.x), gelu_tanh(v1 + z.y));
                       });
  }
};

// Pass 2's epilogue: out = round(sum + b2) at absolute rows of [G, M, d].
struct OutEpilogue {
  const bf16* b2;
  bf16* out;
  int M;
  __device__ void operator()(const float (&acc)[sm90::ACC], int g, int abs_row, int, int col0,
                             int t, uint32_t* stage, const sm90::Shape& s) const {
    const bf16* bias = b2 + (size_t)g * s.N + col0;
    const int cols = s.N - col0;
    // The bias at the tile's last pair past `cols` (see HiddenEpilogue).
    sm90::store_half(acc, t, stage, out + ((size_t)g * M + abs_row) * s.N + col0, s.N,
                     s.row_end - abs_row, cols, [&](int, int c, float v0, float v1) {
                       const int cc = min(c, cols - 2);
                       return __floats2bfloat162_rn(v0 + __bfloat162float(bias[cc]),
                                                    v1 + __bfloat162float(bias[cc + 1]));
                     });
  }
};

// The two passes' kernels, named for profiles.
template <bool SAVE_PRE, bool STORE_H>
__global__ void __launch_bounds__(sm90::THREADS, 1)
mlp_fwd_hidden_bf16(const __grid_constant__ CUtensorMap a_lo,
                    const __grid_constant__ CUtensorMap a_hi,
                    const __grid_constant__ CUtensorMap b, const sm90::Shape shape,
                    const HiddenEpilogue<SAVE_PRE, STORE_H> epi) {
  sm90::gemm_tiles(a_lo, a_hi, b, shape, epi);
}

__global__ void __launch_bounds__(sm90::THREADS, 1)
mlp_fwd_out_bf16(const __grid_constant__ CUtensorMap a_lo, const __grid_constant__ CUtensorMap a_hi,
                 const __grid_constant__ CUtensorMap b, const sm90::Shape shape,
                 const OutEpilogue epi) {
  sm90::gemm_tiles(a_lo, a_hi, b, shape, epi);
}

// Pass 1 over one slab: pre and h (training), h (serving) or pre alone.
template <bool SAVE_PRE, bool STORE_H>
cudaError_t hidden_pass(const CUtensorMap& xa_map, const CUtensorMap& x_map,
                        const CUtensorMap& w1_map, const sm90::Shape& shape,
                        const HiddenEpilogue<SAVE_PRE, STORE_H>& epi, cudaStream_t s) {
  static bool lifted[sm90::MAX_DEVICES];
  return sm90::launch_tiles(mlp_fwd_hidden_bf16<SAVE_PRE, STORE_H>, lifted,
                            sm90::tile_count(shape), s, xa_map, x_map, w1_map, shape, epi);
}

// The bf16 forward over row slabs of R rows: per slab, the addend's xa
// (split > 0), pass 1, and pass 2 unless out is NULL (the pre-only entry).
// h: [G, R, f] scratch (NULL for pre-only); xa: [split, R, d] scratch.
cudaError_t fwd_bf16(const bf16* x, const bf16* a, int n, const bf16* w1, const bf16* b1,
                     const bf16* w2, const bf16* b2, bf16* out, bf16* pre, bf16* h, bf16* xa,
                     int G, int M, int d, int f, int split, int x_lo, int R, cudaStream_t s) {
  CUtensorMap x_map, xa_map, w1_map, h_map, w2_map;
  const bool pre_only = out == nullptr;
  cudaError_t err = sm90::make_kmajor_map(&x_map, x, d, M, split < G ? G - split : 1);
  if (err == cudaSuccess) err = split > 0 ? sm90::make_kmajor_map(&xa_map, xa, d, R, split) : err;
  if (err == cudaSuccess) err = sm90::make_mnmajor_map(&w1_map, w1, d, f, G);
  if (err == cudaSuccess && !pre_only) err = sm90::make_kmajor_map(&h_map, h, f, R, G);
  if (err == cudaSuccess && !pre_only) err = sm90::make_mnmajor_map(&w2_map, w2, f, d, G);
  if (err != cudaSuccess) return err;
  if (split == 0) xa_map = x_map;  // not read: no group is below split
  for (int r0 = 0; r0 < M && err == cudaSuccess; r0 += R) {
    const int rows = M - r0 < R ? M - r0 : R;
    if (split > 0) {
      const size_t vecs = static_cast<size_t>(split) * rows * d / 8;
      const int blocks = static_cast<int>((vecs + 255) / 256 < 8192 ? (vecs + 255) / 256 : 8192);
      mlp_fwd_addend_bf16<<<blocks, 256, 0, s>>>(x, a, n, xa, split, x_lo, M, d, R, r0, rows);
      err = cudaGetLastError();
      if (err != cudaSuccess) break;
    }
    const sm90::Shape s1{d, f, G, split, r0, r0 + rows};
    if (pre_only)
      err = hidden_pass(xa_map, x_map, w1_map, s1, HiddenEpilogue<true, false>{b1, pre, h, M, R}, s);
    else if (pre != nullptr)
      err = hidden_pass(xa_map, x_map, w1_map, s1, HiddenEpilogue<true, true>{b1, pre, h, M, R}, s);
    else
      err = hidden_pass(xa_map, x_map, w1_map, s1, HiddenEpilogue<false, true>{b1, pre, h, M, R}, s);
    if (err != cudaSuccess || pre_only) continue;
    const sm90::Shape s2{f, d, G, G, r0, r0 + rows};  // every group reads the h scratch
    static bool lifted_out[sm90::MAX_DEVICES];
    err = sm90::launch_tiles(mlp_fwd_out_bf16, lifted_out, sm90::tile_count(s2), s, h_map, h_map,
                             w2_map, s2, OutEpilogue{b2, out, M});
  }
  return err;
}

// f32, on the CUDA cores with the exact erf GELU: a block owns TM rows of
// one group and walks f in FC-wide chunks, keeping the chunk of the hidden
// layer and an f32 [TM, d] output tile in shared memory. Phase one gives
// each thread one hidden column and 8 rows; phase two gives each thread
// whole output columns (all TM rows in registers) so every w2 value is
// read once.
template <bool SAVE_PRE, bool PRE_ONLY>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_f32(const float* __restrict__ x, const float* __restrict__ a, int n,
            const float* __restrict__ w1, const float* __restrict__ b1,
            const float* __restrict__ w2, const float* __restrict__ b2,
            float* __restrict__ out, float* __restrict__ pre, int M, int d, int f, int split,
            int x_lo) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [TM][d]
  float* acc = xs + TM * d;                     // [TM][d]
  float* hs = acc + TM * d;                     // [TM][FC]

  const int m0 = blockIdx.x * TM;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t xoff = ((size_t)(g < split ? g + x_lo : g - split) * M + m0) * d;
  const size_t ooff = ((size_t)g * M + m0) * d;
  if (g >= split) a = nullptr;

  for (int e = tid; e < TM * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    float v = x[xoff + (size_t)r * d + c];
    if (a != nullptr) v = v + a[(size_t)((m0 + r) % n) * d + c];
    xs[e] = v;
    acc[e] = 0.0f;
  }
  __syncthreads();

  const float* w1g = w1 + (size_t)g * d * f;
  const float* w2g = w2 + (size_t)g * f * d;
  constexpr int ROWS_A = TM * FC / THREADS;  // 8 rows per thread in phase one
  const int j = tid % FC, r0 = (tid / FC) * ROWS_A;

  for (int c0 = 0; c0 < f; c0 += FC) {
    float s[ROWS_A];
#pragma unroll
    for (int r = 0; r < ROWS_A; ++r) s[r] = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float w = w1g[(size_t)k * f + c0 + j];
#pragma unroll
      for (int r = 0; r < ROWS_A; ++r) s[r] = fmaf(xs[(r0 + r) * d + k], w, s[r]);
    }
    const float bias = b1[(size_t)g * f + c0 + j];
#pragma unroll
    for (int r = 0; r < ROWS_A; ++r) {
      const float z = s[r] + bias;
      if constexpr (SAVE_PRE) pre[((size_t)g * M + m0 + r0 + r) * f + c0 + j] = z;
      if constexpr (!PRE_ONLY) hs[(r0 + r) * FC + j] = gelu_erf(z);
    }
    if constexpr (PRE_ONLY) continue;
    __syncthreads();
    for (int c = tid; c < d; c += THREADS) {
      float o[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) o[r] = acc[r * d + c];
      for (int kk = 0; kk < FC; ++kk) {
        const float w = w2g[(size_t)(c0 + kk) * d + c];
#pragma unroll
        for (int r = 0; r < TM; ++r) o[r] = fmaf(hs[r * FC + kk], w, o[r]);
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r * d + c] = o[r];
    }
    __syncthreads();
  }
  if constexpr (PRE_ONLY) return;
  for (int e = tid; e < TM * d; e += THREADS) {
    const int c = e % d;
    out[ooff + e] = acc[e] + b2[(size_t)g * d + c];
  }
}

size_t f32_smem_bytes(int d) { return sizeof(float) * (2 * TM * d + TM * FC); }

// One f32 launch of the forward, with the pre-activation store compiled in
// (training) or out (serving), or of the pre-only recompute.
template <bool SAVE_PRE, bool PRE_ONLY = false>
cudaError_t launch_f32(const void* x, const void* a, int n, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, void* pre, int G, int M,
                       int d, int f, int split, int x_lo, cudaStream_t s) {
  static bool lifted[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(mlp_fwd_f32<SAVE_PRE, PRE_ONLY>, lifted);
  if (err != cudaSuccess) return err;
  mlp_fwd_f32<SAVE_PRE, PRE_ONLY><<<dim3(M / TM, G), THREADS, f32_smem_bytes(d), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), n,
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out),
      static_cast<float*>(pre), M, d, f, split, x_lo);
  return cudaGetLastError();
}

bool valid(const void* a, int n, int G, int M, int d, int f, int split, int x_lo) {
  return G >= 1 && M % TM == 0 && d % 64 == 0 && f % FC == 0 && split >= 0 && split <= G &&
         x_lo >= 0 && (a != nullptr) == (split > 0) && (a == nullptr || (n >= 1 && M % n == 0));
}

// bf16 needs its scratch: h [G, R, f] unless pre-only, xa [split, R, d]
// when an addend is taken, 1 <= R.
bool valid_scratch(bool pre_only, const void* h, const void* xa, int split, int R) {
  return R >= 1 && (pre_only || h != nullptr) && (split == 0 || xa != nullptr);
}

}  // namespace

extern "C" {

// x: [S, M, d] slots, group g reading slot g < split ? g + x_lo : g - split
// (see the combined grid above; a plain launch: S = G, x_lo = 0, split = G
// with an addend, else 0); a: [n, d], taken by the groups below split, or
// NULL (then split = 0); out: [G, M, d]; w1: [G, d, f]; b1: [G, f]; w2:
// [G, f, d]; b2: [G, d]; pre: [G, M, f] or NULL. bf16 (is_bf16) also takes
// the scratch h: [G, R, f] and, with an addend, xa: [split, R, d], and runs
// over row slabs of R rows; f32 ignores them. All contiguous, on the
// current device, of one dtype; x, a, w1, w2 and the scratch 16-byte
// aligned. Returns a cudaError_t.
int grouped_mlp_fwd(const void* x, const void* a, int n, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, void* pre, void* h, void* xa,
                    int G, int M, int d, int f, int split, int x_lo, int R, int is_bf16,
                    void* stream) {
  if (!valid(a, n, G, M, d, f, split, x_lo) || out == nullptr ||
      (is_bf16 && !valid_scratch(false, h, xa, split, R)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)fwd_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(a), n,
                         static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                         static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
                         static_cast<bf16*>(out), static_cast<bf16*>(pre), static_cast<bf16*>(h),
                         static_cast<bf16*>(xa), G, M, d, f, split, x_lo, R, s);
  return (int)(pre != nullptr ? launch_f32<true>(x, a, n, w1, b1, w2, b2, out, pre, G, M, d, f,
                                                 split, x_lo, s)
                              : launch_f32<false>(x, a, n, w1, b1, w2, b2, out, pre, G, M, d, f,
                                                  split, x_lo, s));
}

// The pre-only recompute: pre [G, M, f] = (x (+ a)) . w1 + b1 in x's dtype,
// bit for bit what grouped_mlp_fwd saves. Arguments as grouped_mlp_fwd's
// (bf16: the xa scratch with an addend; no h).
int grouped_mlp_pre(const void* x, const void* a, int n, const void* w1, const void* b1,
                    void* pre, void* xa, int G, int M, int d, int f, int split, int x_lo, int R,
                    int is_bf16, void* stream) {
  if (!valid(a, n, G, M, d, f, split, x_lo) || pre == nullptr ||
      (is_bf16 && !valid_scratch(true, nullptr, xa, split, R)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)fwd_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(a), n,
                         static_cast<const bf16*>(w1), static_cast<const bf16*>(b1), nullptr,
                         nullptr, nullptr, static_cast<bf16*>(pre), nullptr,
                         static_cast<bf16*>(xa), G, M, d, f, split, x_lo, R, s);
  return (int)launch_f32<true, true>(x, a, n, w1, b1, nullptr, nullptr, nullptr, pre, G, M, d,
                                     f, split, x_lo, s);
}

const char* grouped_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
