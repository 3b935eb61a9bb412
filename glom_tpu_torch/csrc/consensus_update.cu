// K2 forward: consensus attention fused with the 4-way mean column update,
// level-major [L, B, n, d].
//
//   cons_i = softmax_j(q_i . normalize(k_j) * d^-1/2 [masks]) . v_j
//   out_i  = (levels_i + bu_i + td_i + cons_i) / (g < L-1 ? 4 : 3)
//
// with q = v = levels and td = 0 at the top level g = L-1.
//
// Replaces: glom_tpu/kernels/consensus_update.py:_consensus_update_kernel
// (resident k/v row) and :_consensus_update_kernel_streamed (streamed j
// tiles). The TPU split between the two is a VMEM-residency matter; here
// one kernel streams j tiles through shared memory at any n.
//
// Bound on the H100: device-memory bytes. At the flagship bucket-8 shape
// ([6, 8, 256, 512] bf16) the op must read levels, bu and td and write out,
// 48 MB, against 6.4 GFLOP of products.
//
// Kept out of device memory: the [n, n] similarity and probabilities, the
// normalized k, and the attention output `cons`. A block owns TI query rows
// of one (level, image); it walks the j tiles with an online softmax
// (running max m, sum l and f32 accumulator in shared memory) and writes
// only the updated levels. Under a local radius, j tiles wholly outside the
// band are skipped by the reference's window arithmetic.
//
// Arithmetic follows the reference kernel: k is normalized in f32 and
// rounded to the compute type; scores are f32; the diagonal is replaced by
// -5e-4 when attend_self is off; pairs past the radius get the finite
// finfo(float32).min (never -inf, so a fully masked tile cannot make
// inf - inf); p is rounded to the compute type before p . v. bf16 runs the
// two products on tensor cores (WMMA, f32 accumulators), f32 on FMA.
//
// The output must not alias the input: other row tiles still read it.
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_MAX = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float SELF_VALUE = -5e-4f;               // TOKEN_ATTEND_SELF_VALUE

template <typename T>
struct Tiles;
template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int TI = 32, TJ = 32, PAD = 8;  // PAD keeps WMMA pitches legal
};
template <>
struct Tiles<float> {
  static constexpr int TI = 16, TJ = 16, PAD = 1;  // PAD spreads rows over banks
};

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// Shared-memory layout, every section 128-byte aligned.
template <typename T>
struct Layout {
  static constexpr int TI = Tiles<T>::TI, TJ = Tiles<T>::TJ;
  int ld, ldacc, lds, ldp;
  size_t q_off, k_off, v_off, acc_off, s_off, p_off, st_off, bytes;
  __host__ __device__ explicit Layout(int d)
      : ld(d + Tiles<T>::PAD), ldacc(d + 4), lds(TJ + 4), ldp(TJ + 8) {
    q_off = 0;
    k_off = q_off + align128(sizeof(T) * TI * ld);
    v_off = k_off + align128(sizeof(T) * TJ * ld);
    acc_off = v_off + align128(sizeof(T) * TJ * ld);
    s_off = acc_off + align128(sizeof(float) * TI * ldacc);
    p_off = s_off + align128(sizeof(float) * TI * lds);
    st_off = p_off + align128(sizeof(T) * TI * ldp);
    bytes = st_off + align128(sizeof(float) * 3 * TI);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
consensus_update_kernel(const T* __restrict__ lv, const T* __restrict__ bu,
                        const T* __restrict__ td, T* __restrict__ out, int L, int B,
                        int n, int d, int side, int reach, float r2, int attend_self,
                        float scale) {
  constexpr int TI = Tiles<T>::TI, TJ = Tiles<T>::TJ;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> lay(d);
  T* qs = reinterpret_cast<T*>(smem + lay.q_off);     // [TI][ld] levels rows (q)
  T* ks = reinterpret_cast<T*>(smem + lay.k_off);     // [TJ][ld] normalized k
  T* vs = reinterpret_cast<T*>(smem + lay.v_off);     // [TJ][ld] raw rows (v)
  float* acc = reinterpret_cast<float*>(smem + lay.acc_off);  // [TI][ldacc]
  float* S = reinterpret_cast<float*>(smem + lay.s_off);      // [TI][lds]
  T* P = reinterpret_cast<T*>(smem + lay.p_off);              // [TI][ldp]
  float* m_row = reinterpret_cast<float*>(smem + lay.st_off);
  float* l_row = m_row + TI;
  float* corr_row = l_row + TI;

  const int i0 = blockIdx.x * TI;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* row0 = lv + ((size_t)g * B + b) * n * d;  // levels[g, b]

  for (int e = tid; e < TI * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    qs[r * lay.ld + c] = row0[(size_t)(i0 + r) * d + c];
    acc[r * lay.ldacc + c] = 0.0f;
  }
  if (tid < TI) {
    m_row[tid] = NEG_MAX;
    l_row[tid] = 0.0f;
  }

  // Live j-tile window (glom_tpu consensus_update.py:_window): rows i and j
  // interact only within (floor(radius) + 1) * side flat positions.
  const int n_tiles = n / TJ;
  int j_lo = 0, j_hi = n_tiles;
  if (reach > 0) {
    const int lo = i0 - reach, hi = i0 + TI + reach;
    j_lo = lo <= 0 ? 0 : lo / TJ;
    j_hi = min((hi + TJ - 1) / TJ, n_tiles);
  }
  __syncthreads();

  for (int jt = j_lo; jt < j_hi; ++jt) {
    const int j0 = jt * TJ;
    // Raw rows into vs; k = row / max(||row||, 1e-12) in f32 into ks.
    for (int r = warp; r < TJ; r += WARPS) {
      const T* src = row0 + (size_t)(j0 + r) * d;
      float ss = 0.0f;
      for (int c = lane; c < d; c += 32) {
        const T v = src[c];
        vs[r * lay.ld + c] = v;
        const float vf = to_f(v);
        ss = fmaf(vf, vf, ss);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float denom = fmaxf(sqrtf(ss), 1e-12f);
      for (int c = lane; c < d; c += 32)
        ks[r * lay.ld + c] = from_f<T>(to_f(vs[r * lay.ld + c]) / denom);
    }
    __syncthreads();

    // S = qs . ks^T (f32).
    if constexpr (kBf16) {
      if (warp < (TI / 16) * (TJ / 16)) {
        const int rf = warp / (TJ / 16), cf = warp % (TJ / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
        wmma::fill_fragment(s, 0.0f);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        for (int k = 0; k < d; k += 16) {
          wmma::load_matrix_sync(af, qs + rf * 16 * lay.ld + k, lay.ld);
          wmma::load_matrix_sync(bf, ks + cf * 16 * lay.ld + k, lay.ld);
          wmma::mma_sync(s, af, bf, s);
        }
        wmma::store_matrix_sync(S + rf * 16 * lay.lds + cf * 16, s, lay.lds,
                                wmma::mem_row_major);
      }
    } else {
      static_assert(kBf16 || TI * TJ == THREADS, "one score per thread");
      const int r = tid / TJ, j = tid % TJ;
      float s = 0.0f;
      for (int c = 0; c < d; ++c) s = fmaf(to_f(qs[r * lay.ld + c]), to_f(ks[j * lay.ld + c]), s);
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
        P[r * lay.ldp + j] = from_f<T>(p);
      }
      l_row[r] = l_row[r] * corr + psum;
      m_row[r] = m_new;
      corr_row[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P . vs.
    if constexpr (kBf16) {
      for (int e = tid; e < TI * d; e += THREADS) {
        const int r = e / d, c = e - r * d;
        acc[r * lay.ldacc + c] *= corr_row[r];
      }
      __syncthreads();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa[TI / 16][TJ / 16];
#pragma unroll
      for (int rf = 0; rf < TI / 16; ++rf)
#pragma unroll
        for (int kk = 0; kk < TJ / 16; ++kk)
          wmma::load_matrix_sync(pa[rf][kk], P + rf * 16 * lay.ldp + kk * 16, lay.ldp);
      for (int cf = warp; cf < d / 16; cf += WARPS) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[TI / 16];
#pragma unroll
        for (int rf = 0; rf < TI / 16; ++rf)
          wmma::load_matrix_sync(o[rf], acc + rf * 16 * lay.ldacc + cf * 16, lay.ldacc,
                                 wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < TJ / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
          wmma::load_matrix_sync(vb, vs + kk * 16 * lay.ld + cf * 16, lay.ld);
#pragma unroll
          for (int rf = 0; rf < TI / 16; ++rf) wmma::mma_sync(o[rf], pa[rf][kk], vb, o[rf]);
        }
#pragma unroll
        for (int rf = 0; rf < TI / 16; ++rf)
          wmma::store_matrix_sync(acc + rf * 16 * lay.ldacc + cf * 16, o[rf], lay.ldacc,
                                  wmma::mem_row_major);
      }
    } else {
      for (int e = tid; e < TI * d; e += THREADS) {
        const int r = e / d, c = e - r * d;
        float pv = 0.0f;
#pragma unroll
        for (int k = 0; k < TJ; ++k)
          pv = fmaf(to_f(P[r * lay.ldp + k]), to_f(vs[k * lay.ld + c]), pv);
        acc[r * lay.ldacc + c] = acc[r * lay.ldacc + c] * corr_row[r] + pv;
      }
    }
    __syncthreads();
  }

  // Epilogue: the 4-way mean (3-way with no top-down at the top level).
  const bool top = g == L - 1;
  const float div = top ? 3.0f : 4.0f;
  const size_t base = (((size_t)g * B + b) * n + i0) * d;
  const size_t td_base = top ? 0 : base;  // td is [L-1, B, n, d]: same offsets below the top
  for (int e = tid; e < TI * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const float cons = acc[r * lay.ldacc + c] / l_row[r];
    const float t = top ? 0.0f : to_f(td[td_base + e]);
    const float v = (((to_f(qs[r * lay.ld + c]) + to_f(bu[base + e])) + t) + cons) / div;
    out[base + e] = from_f<T>(v);
  }
}

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

template <typename T>
int launch(const void* lv, const void* bu, const void* td, void* out, int L, int B, int n,
           int d, int side, double radius, int attend_self, cudaStream_t stream) {
  constexpr int TI = Tiles<T>::TI, TJ = Tiles<T>::TJ;
  if (L < 2 || B < 1 || n % TI != 0 || n % TJ != 0 || d % 64 != 0 || side < 1)
    return (int)cudaErrorInvalidValue;
  static bool lifted[MAX_DEVICES];
  const cudaError_t err = lift_smem_cap(consensus_update_kernel<T>, lifted);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = Layout<T>(d).bytes;
  const int reach = radius > 0 ? (int)(radius + 1.0) * side : 0;
  const float r2 = (float)(radius * radius);
  const float scale = (float)(1.0 / sqrt((double)d));
  const dim3 grid(n / TI, B, L);
  consensus_update_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(lv), static_cast<const T*>(bu), static_cast<const T*>(td),
      static_cast<T*>(out), L, B, n, d, side, reach, r2, attend_self, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lv, bu, out: [L, B, n, d]; td: [L-1, B, n, d]; contiguous, one dtype
// (is_bf16 selects bf16, else f32); side: patch-grid side (n = side^2 for a
// local radius); radius <= 0 means global consensus. Returns a cudaError_t.
int consensus_update_fwd(const void* lv, const void* bu, const void* td, void* out, int L,
                         int B, int n, int d, int side, double radius, int attend_self,
                         int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(lv, bu, td, out, L, B, n, d, side, radius,
                                         attend_self, s)
                 : launch<float>(lv, bu, td, out, L, B, n, d, side, radius, attend_self, s);
}

const char* consensus_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
