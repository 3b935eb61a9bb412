// K1 forward: the grouped per-level MLP, level-major.
//
//   out[g, r] = GELU((x[g, r] (+ a[r mod n])) . w1[g] + b1[g]) . w2[g] + b2[g]
//
// For training it can also write the pre-activation pre = xa . w1 + b1,
// [G, M, f] in x's type, for the backward (csrc/grouped_mlp_bwd.cu). The
// store is a template parameter, so the serving launch compiles it out.
// A third instance, PRE_ONLY, stops after the first product: it writes pre
// and nothing else (the whole-loop VJP's remat recompute). It forms and
// stores z with the very code the training forward saves it with, so the
// recomputed pre is bit for bit the one the forward would have saved, and
// remat gradients equal non-remat ones exactly.
//
// The combined td || bu grid (the whole-loop VJP's `loop_grid="combined"`):
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
// tile load), as one kernel with an optional addend pointer; also
// glom_tpu/kernels/fused_loop.py:_ffw_fwd_ext (the same kernels reading a
// slot of the loop's carry: here the caller passes the slot's pointer) and
// :_pre_kernel / :_pre_add_kernel (the PRE_ONLY instance), and, over the
// combined grid, :_ffw_fwd_cat and :_pre_fwd_cat (there through a zero
// addend for the bottom-up groups; here the group rule skips the add).
//
// Bound on the H100: tensor-core operations. At the flagship bottom-up
// shape (G = 6, M = 2048, d = 512, f = 2048) the two products are 51.5
// GFLOP against about 50 MB of weights, input and output. PRE_ONLY does
// one product (25.8 GFLOP, 0.026 ms) and moves about 75 MB, the [G, M, f]
// pre included (0.022 ms): still bound by operations, barely.
//
// Kept out of device memory: the [G, M, f] hidden activation. A block owns
// TM rows of one group; it walks f in FC-wide chunks, computes the chunk of
// the hidden layer into shared memory (f32, then GELU, then rounded to the
// input type exactly as the reference rounds it) and accumulates that
// chunk's product with w2 into an f32 output tile that also lives in
// shared memory. The addend sum x + a is formed once per tile on load.
//
// Arithmetic follows the reference kernel per dtype: bf16 uses the tanh
// GELU and tensor cores (WMMA, f32 accumulators); f32 uses the exact erf
// GELU and FMA on the CUDA cores. Weights are read straight from global
// memory (they stay resident in the 50 MB L2 across the row tiles).
//
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TM = 32;        // rows of x per block
constexpr int FC = 64;        // hidden columns per chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float gelu_tanh(float z) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return z * (0.5f * (1.0f + tanhf(c * (z + 0.044715f * (z * z * z)))));
}

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.7071067811865476f));
}

// Shared-memory layout of the bf16 kernel (row pitches padded so every
// WMMA fragment pointer stays 32-byte aligned and rows spread over banks).
struct Bf16Layout {
  int ldx, ldacc, ldhf, ldhb;
  size_t acc_off, hf_off, hb_off, bytes;
  __host__ __device__ explicit Bf16Layout(int d)
      : ldx(d + 8), ldacc(d + 4), ldhf(FC + 4), ldhb(FC + 8) {
    acc_off = sizeof(__nv_bfloat16) * TM * ldx;
    hf_off = acc_off + sizeof(float) * TM * ldacc;
    hb_off = hf_off + sizeof(float) * TM * ldhf;
    bytes = hb_off + sizeof(__nv_bfloat16) * TM * ldhb;
  }
};

template <bool SAVE_PRE, bool PRE_ONLY>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
             int n, const __nv_bfloat16* __restrict__ w1,
             const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
             const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out,
             __nv_bfloat16* __restrict__ pre, int M, int d, int f, int split, int x_lo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Layout lay(d);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* acc = reinterpret_cast<float*>(smem + lay.acc_off);
  float* hf = reinterpret_cast<float*>(smem + lay.hf_off);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem + lay.hb_off);

  const int m0 = blockIdx.x * TM;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const size_t xoff = ((size_t)(g < split ? g + x_lo : g - split) * M + m0) * d;
  const size_t ooff = ((size_t)g * M + m0) * d;
  if (g >= split) a = nullptr;

  // x tile (+ addend, rounded once to bf16) and a zeroed f32 output tile.
  for (int e = tid; e < TM * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    __nv_bfloat16 v = x[xoff + (size_t)r * d + c];
    if (a != nullptr) {
      const float s = __bfloat162float(v) +
                      __bfloat162float(a[(size_t)((m0 + r) % n) * d + c]);
      v = __float2bfloat16(s);
    }
    xs[r * lay.ldx + c] = v;
    acc[r * lay.ldacc + c] = 0.0f;
  }
  __syncthreads();

  const __nv_bfloat16* w1g = w1 + (size_t)g * d * f;
  const __nv_bfloat16* w2g = w2 + (size_t)g * f * d;
  const __nv_bfloat16* b1g = b1 + (size_t)g * f;

  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  for (int c0 = 0; c0 < f; c0 += FC) {
    // Hidden chunk [TM, FC] = xs . w1g[:, c0:c0+FC]: one 16x16 tile a warp.
    {
      const int rf = warp / (FC / 16), cf = warp % (FC / 16);
      FragC h;
      wmma::fill_fragment(h, 0.0f);
      FragA af;
      FragB bf;
      for (int k = 0; k < d; k += 16) {
        wmma::load_matrix_sync(af, xs + rf * 16 * lay.ldx + k, lay.ldx);
        wmma::load_matrix_sync(bf, w1g + (size_t)k * f + c0 + cf * 16, f);
        wmma::mma_sync(h, af, bf, h);
      }
      wmma::store_matrix_sync(hf + rf * 16 * lay.ldhf + cf * 16, h, lay.ldhf,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // + b1 (saved, rounded, when training), GELU in f32, round to bf16.
    for (int e = tid; e < TM * FC; e += THREADS) {
      const int r = e / FC, j = e - r * FC;
      const float z = hf[r * lay.ldhf + j] + __bfloat162float(b1g[c0 + j]);
      if constexpr (SAVE_PRE) pre[((size_t)g * M + m0 + r) * f + c0 + j] = __float2bfloat16(z);
      if constexpr (!PRE_ONLY) hb[r * lay.ldhb + j] = __float2bfloat16(gelu_tanh(z));
    }
    __syncthreads();
    if constexpr (PRE_ONLY) continue;
    // Output tile [TM, d] += hb . w2g[c0:c0+FC, :]: a warp owns column
    // tiles cf = warp, warp + 8, ... for both 16-row halves.
    FragA ha[TM / 16][FC / 16];
#pragma unroll
    for (int rf = 0; rf < TM / 16; ++rf)
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk)
        wmma::load_matrix_sync(ha[rf][kk], hb + rf * 16 * lay.ldhb + kk * 16, lay.ldhb);
    for (int cf = warp; cf < d / 16; cf += WARPS) {
      FragC o[TM / 16];
#pragma unroll
      for (int rf = 0; rf < TM / 16; ++rf)
        wmma::load_matrix_sync(o[rf], acc + rf * 16 * lay.ldacc + cf * 16, lay.ldacc,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk) {
        FragB bf;
        wmma::load_matrix_sync(bf, w2g + (size_t)(c0 + kk * 16) * d + cf * 16, d);
#pragma unroll
        for (int rf = 0; rf < TM / 16; ++rf) wmma::mma_sync(o[rf], ha[rf][kk], bf, o[rf]);
      }
#pragma unroll
      for (int rf = 0; rf < TM / 16; ++rf)
        wmma::store_matrix_sync(acc + rf * 16 * lay.ldacc + cf * 16, o[rf], lay.ldacc,
                                wmma::mem_row_major);
    }
    // The next chunk's first write (hf) is read only after a barrier that
    // every warp reaches after finishing this product, so none is needed.
  }
  if constexpr (PRE_ONLY) return;
  __syncthreads();
  for (int e = tid; e < TM * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const float v = acc[r * lay.ldacc + c] + __bfloat162float(b2[(size_t)g * d + c]);
    out[ooff + (size_t)r * d + c] = __float2bfloat16(v);
  }
}

// f32: the same blocking on the CUDA cores. Phase one gives each thread one
// hidden column and 8 rows; phase two gives each thread whole output
// columns (all TM rows in registers) so every w2 value is read once.
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

// Lift a kernel's dynamic shared-memory cap to the device's opt-in limit,
// once per device (`done` flags which devices are set). A launch that
// needs more than the card has then fails, and the entry point returns
// that error.
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

// One launch of the forward, with the pre-activation store compiled in
// (training) or out (serving), or of the pre-only recompute.
template <bool SAVE_PRE, bool PRE_ONLY = false>
cudaError_t launch_fwd(const void* x, const void* a, int n, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, void* pre, int G, int M,
                       int d, int f, int split, int x_lo, int is_bf16, cudaStream_t s) {
  static bool lifted_bf16[MAX_DEVICES], lifted_f32[MAX_DEVICES];
  const dim3 grid(M / TM, G);
  cudaError_t err;
  if (is_bf16) {
    err = lift_smem_cap(mlp_fwd_bf16<SAVE_PRE, PRE_ONLY>, lifted_bf16);
    if (err != cudaSuccess) return err;
    mlp_fwd_bf16<SAVE_PRE, PRE_ONLY><<<grid, THREADS, Bf16Layout(d).bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(a), n,
        static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(b1),
        static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(b2),
        static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(pre), M, d, f, split,
        x_lo);
  } else {
    err = lift_smem_cap(mlp_fwd_f32<SAVE_PRE, PRE_ONLY>, lifted_f32);
    if (err != cudaSuccess) return err;
    mlp_fwd_f32<SAVE_PRE, PRE_ONLY><<<grid, THREADS, f32_smem_bytes(d), s>>>(
        static_cast<const float*>(x), static_cast<const float*>(a), n,
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<float*>(out), static_cast<float*>(pre), M, d, f, split, x_lo);
  }
  return cudaGetLastError();
}

bool valid(const void* a, int n, int G, int M, int d, int f, int split, int x_lo) {
  return G >= 1 && M % TM == 0 && d % 64 == 0 && f % FC == 0 && split >= 0 && split <= G &&
         x_lo >= 0 && (a != nullptr) == (split > 0) && (a == nullptr || (n >= 1 && M % n == 0));
}

}  // namespace

extern "C" {

// x: [S, M, d] slots, group g reading slot g < split ? g + x_lo : g - split
// (see the combined grid above; a plain launch: S = G, x_lo = 0, split = G
// with an addend, else 0); a: [n, d], taken by the groups below split, or
// NULL (then split = 0); out: [G, M, d]; w1: [G, d, f]; b1: [G, f]; w2:
// [G, f, d]; b2: [G, d]; pre: [G, M, f] or NULL. All contiguous, on the
// current device, of one dtype (is_bf16 selects bf16, else f32). Returns a
// cudaError_t.
int grouped_mlp_fwd(const void* x, const void* a, int n, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, void* pre, int G, int M, int d,
                    int f, int split, int x_lo, int is_bf16, void* stream) {
  if (!valid(a, n, G, M, d, f, split, x_lo)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pre != nullptr ? launch_fwd<true>(x, a, n, w1, b1, w2, b2, out, pre, G, M, d, f,
                                                 split, x_lo, is_bf16, s)
                              : launch_fwd<false>(x, a, n, w1, b1, w2, b2, out, pre, G, M, d, f,
                                                  split, x_lo, is_bf16, s));
}

// The pre-only recompute: pre [G, M, f] = (x (+ a)) . w1 + b1 in x's dtype,
// bit for bit what grouped_mlp_fwd saves. Arguments as grouped_mlp_fwd's.
int grouped_mlp_pre(const void* x, const void* a, int n, const void* w1, const void* b1,
                    void* pre, int G, int M, int d, int f, int split, int x_lo, int is_bf16,
                    void* stream) {
  if (!valid(a, n, G, M, d, f, split, x_lo) || pre == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_fwd<true, true>(x, a, n, w1, b1, nullptr, nullptr, nullptr, pre, G, M, d,
                                     f, split, x_lo, is_bf16, static_cast<cudaStream_t>(stream));
}

const char* grouped_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
