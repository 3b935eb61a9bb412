// K4: block-banded ragged consensus attention over a flat, page-aligned
// token axis [T, L, d] (T = P pages of pt tokens; rows of the ragged serving
// route occupy whole pages).
//
//   out[t, l] = sum_w softmax_w(s[t, l, w]) . v[band(t, w), l]
//   s[t, l, w] = q[t, l] . khat[band(t, w), l] * d^-1/2
//
// with q = v = levels and khat = kv / max(||kv||, 1e-12) in f32. Token t of
// page p attends over the W = n_band * pt slots of its row's page band:
// slot w = j * pt + u reads token min(band_page0[p] + j, P - 1) * pt + u.
// When attend_self is off the self slot ((band_page0[p] + j) * pt + u == t)
// scores -5e-4; then every slot w >= len_page[p] scores finfo(float32).min.
//
// Replaces: glom_tpu/kernels/banded_consensus.py:_banded_kernel (the
// pallas_call at :174). It computes what that kernel computes, not block for
// block: the Pallas grid step is a whole [pt, L, d] page and its f32
// accumulator (768 KB at the flagship's pt = 64, L = 6, d = 512), past a
// block's 227 KB of shared memory. Levels never mix in this function, so a
// block here owns one level of up to 32 query rows of one page and streams
// its row's band, 32 key rows at a time, through shared memory, with a
// running max, sum and accumulator per query row (an online softmax, as the
// Pallas kernel's over band pages).
//
// Bound on the H100: operations. At the largest flagship ragged signature
// (P = 32, pt = 64, T = 2048, W = 256, bf16) one launch reads and writes
// 12.6 MB each (7.5 us at 3.35 TB/s) against 2 * 2 * T * L * W * d = 6.4
// GFLOP of f32 products (96 us at 67 TFLOP/s).
//
// Kept out of device memory: the gathered band, the normalised k, the [W]
// scores and probabilities of each query row. The per-page maps
// (band_page0, len_page: int32 [P]) stay on the device; each block reads
// its page's two.
//
// Arithmetic follows the Pallas body: everything after the load is f32 (k
// normalised in f32, f32 scores, p kept in f32, f32 products and sums;
// FMA, no tensor cores), the output is cast once. Each warp owns four query
// rows: its lanes hold one key each for the scores and the softmax step,
// and 4 x 4 x (d / 128) accumulator values each for p . v, with p handed
// across lanes by shuffles. Key tiles wholly past the row length are
// skipped when the row has a valid slot (they would add exactly 0); a page
// with len_page 0 (an unused trailing page) walks the whole band, every
// slot masked, so its output is the uniform average of the clamped band:
// finite, as in the Pallas kernel.
//
// The output must not alias the input: other blocks still read it.
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;        // query rows per warp
constexpr int TILE = 32;       // query rows per block, key rows per step
constexpr int MAX_CHUNKS = 4;  // d / 128 at most: d <= 512
constexpr float NEG_MAX = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float SELF_VALUE = -5e-4f;               // TOKEN_ATTEND_SELF_VALUE
static_assert(WARPS * ROWS == TILE, "each warp owns four query rows of the tile");

// Four consecutive elements: raw copies and conversion to f32 (exact).
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using raw = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using raw = uint2;
};

template <typename T>
__device__ __forceinline__ typename Vec4<T>::raw load_raw(const T* p) {
  return *reinterpret_cast<const typename Vec4<T>::raw*>(p);
}
template <typename T>
__device__ __forceinline__ void store_raw(T* p, typename Vec4<T>::raw v) {
  *reinterpret_cast<typename Vec4<T>::raw*>(p) = v;
}

__device__ __forceinline__ float4 to_f4(float4 v) { return v; }
__device__ __forceinline__ float4 to_f4(uint2 v) {
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &v.x, sizeof(lo));
  memcpy(&hi, &v.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float4 load_f4(const T* p) {
  return to_f4(load_raw(p));
}

__device__ __forceinline__ void store_f4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_f4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(lo));
  memcpy(&raw.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// Shared-memory layout: q rows [TILE][ldq] (T), normalised k [TILE][ldk]
// (f32), raw v [TILE][ldv] (T). The pads keep 16-byte rows and spread the
// k rows that a warp's lanes read over the banks.
template <typename T>
struct Layout {
  int ldq, ldk, ldv;
  size_t k_off, v_off, bytes;
  __host__ __device__ explicit Layout(int d) : ldq(d + 8), ldk(d + 4), ldv(d + 8) {
    k_off = align128(sizeof(T) * TILE * ldq);
    v_off = k_off + align128(sizeof(float) * TILE * ldk);
    bytes = v_off + align128(sizeof(T) * TILE * ldv);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
banded_consensus_kernel(const T* __restrict__ lv, T* __restrict__ out,
                        const int* __restrict__ band_page0, const int* __restrict__ len_page,
                        int P, int pt, int L, int d, int n_band, int tile, int attend_self,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> lay(d);
  T* qs = reinterpret_cast<T*>(smem);
  float* ks = reinterpret_cast<float*>(smem + lay.k_off);
  T* vs = reinterpret_cast<T*>(smem + lay.v_off);

  const int q0 = blockIdx.x * tile;  // first query token of the tile
  const int l = blockIdx.y;
  const int p = q0 / pt;  // a tile never crosses a page
  const int band0 = band_page0[p];
  const int len = len_page[p];
  const size_t tstride = (size_t)L * d;  // token stride of [T, L, d]
  const T* lv_l = lv + (size_t)l * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = d / 128;
  const int row0 = warp * ROWS;  // this warp's first query row in the tile

  // Query rows of this level; rows past the tile are zeros (never written).
  for (int e = tid * 4; e < TILE * d; e += THREADS * 4) {
    const int r = e / d, c = e - r * d;
    typename Vec4<T>::raw v{};
    if (r < tile) v = load_raw(lv_l + (size_t)(q0 + r) * tstride + c);
    store_raw(qs + r * lay.ldq + c, v);
  }

  float m[ROWS], lsum[ROWS];
  float4 acc[ROWS][MAX_CHUNKS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_MAX;
    lsum[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Slots to walk: the whole band for an unused page (len 0), else up to the
  // key tile holding the row's last valid slot.
  const int W = n_band * pt;
  const int n_slots = len > 0 ? min(W, (len + tile - 1) / tile * tile) : W;

  for (int w0 = 0; w0 < n_slots; w0 += tile) {
    const int j = w0 / pt, u0 = w0 - j * pt;
    const int raw_page = band0 + j;
    const int kv0 = min(raw_page, P - 1) * pt + u0;  // first key token of the step
    const int self0 = raw_page * pt + u0;           // band position of slot w0
    __syncthreads();  // the previous step's k and v are no longer read

    // Stage the key rows: raw v, and khat = kv / max(||kv||, 1e-12) in f32.
    for (int r = warp; r < tile; r += WARPS) {
      const T* src = lv_l + (size_t)(kv0 + r) * tstride;
      float4 x[MAX_CHUNKS];
      float ss = 0.0f;
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) {
        if (c < nc) {
          const int col = lane * 4 + c * 128;
          const typename Vec4<T>::raw raw = load_raw(src + col);
          store_raw(vs + r * lay.ldv + col, raw);
          x[c] = to_f4(raw);
          ss = fmaf(x[c].x, x[c].x, ss);
          ss = fmaf(x[c].y, x[c].y, ss);
          ss = fmaf(x[c].z, x[c].z, ss);
          ss = fmaf(x[c].w, x[c].w, ss);
        }
      }
      const float denom = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) {
        if (c < nc) {
          const int col = lane * 4 + c * 128;
          store_f4(ks + r * lay.ldk + col, make_float4(x[c].x / denom, x[c].y / denom,
                                                       x[c].z / denom, x[c].w / denom));
        }
      }
    }
    __syncthreads();

    // Scores: lane = key row of the step, four query rows per warp.
    float s[ROWS] = {0.f, 0.f, 0.f, 0.f};
    if (lane < tile) {
      const float* kr = ks + lane * lay.ldk;
      const T* qr = qs + row0 * lay.ldq;
      for (int c = 0; c < d; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 qq = load_f4(qr + i * lay.ldq + c);
          s[i] = fmaf(qq.x, kk.x, s[i]);
          s[i] = fmaf(qq.y, kk.y, s[i]);
          s[i] = fmaf(qq.z, kk.z, s[i]);
          s[i] = fmaf(qq.w, kk.w, s[i]);
        }
      }
    }

    // Masks and the online-softmax step, in registers. Lanes past the step
    // score -inf: they move neither the max nor the sum.
    float pr[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float si = -INFINITY;
      if (lane < tile) {
        si = s[i] * scale;
        if (!attend_self && self0 + lane == q0 + row0 + i) si = SELF_VALUE;
        if (w0 + lane >= len) si = NEG_MAX;
      }
      const float m_new = fmaxf(m[i], warp_max(si));
      const float corr = expf(m[i] - m_new);
      pr[i] = expf(si - m_new);
      lsum[i] = lsum[i] * corr + warp_sum(pr[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }

    // acc += p . v: lane owns columns lane * 4 + 128 c of its warp's rows.
    for (int kk = 0; kk < tile; ++kk) {
      float pk[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pk[i] = __shfl_sync(0xffffffffu, pr[i], kk);
      const T* vr = vs + kk * lay.ldv + lane * 4;
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) {
        if (c < nc) {
          const float4 v = load_f4(vr + c * 128);
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            acc[i][c].x = fmaf(pk[i], v.x, acc[i][c].x);
            acc[i][c].y = fmaf(pk[i], v.y, acc[i][c].y);
            acc[i][c].z = fmaf(pk[i], v.z, acc[i][c].z);
            acc[i][c].w = fmaf(pk[i], v.w, acc[i][c].w);
          }
        }
      }
    }
  }

  // out = acc / l, cast once.
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (row0 + i < tile) {
      T* dst = out + (size_t)(q0 + row0 + i) * tstride + (size_t)l * d + lane * 4;
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) {
        if (c < nc) {
          store_f4(dst + c * 128, make_float4(acc[i][c].x / lsum[i], acc[i][c].y / lsum[i],
                                              acc[i][c].z / lsum[i], acc[i][c].w / lsum[i]));
        }
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

template <typename T>
int launch(const void* lv, void* out, const int* band_page0, const int* len_page, int P, int pt,
           int L, int d, int n_band, int attend_self, cudaStream_t stream) {
  if (P < 1 || pt < 1 || L < 1 || n_band < 1 || d < 128 || d % 128 != 0 ||
      d > 128 * MAX_CHUNKS || (pt > TILE && pt % TILE != 0))
    return (int)cudaErrorInvalidValue;
  static bool lifted[MAX_DEVICES];
  const cudaError_t err = lift_smem_cap(banded_consensus_kernel<T>, lifted);
  if (err != cudaSuccess) return (int)err;
  const int tile = pt < TILE ? pt : TILE;
  const dim3 grid(P * pt / tile, L);
  const float scale = (float)(1.0 / sqrt((double)d));
  banded_consensus_kernel<T><<<grid, THREADS, Layout<T>(d).bytes, stream>>>(
      static_cast<const T*>(lv), static_cast<T*>(out), band_page0, len_page, P, pt, L, d,
      n_band, tile, attend_self, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lv, out: [P * pt, L, d], contiguous, one dtype (is_bf16 selects bf16,
// else f32), not aliased; band_page0, len_page: int32 [P] on the device;
// n_band = window / pt. pt <= 32 or a multiple of 32; d a multiple of 128,
// at most 512. Returns a cudaError_t.
int banded_consensus_fwd(const void* lv, void* out, const int* band_page0, const int* len_page,
                         int P, int pt, int L, int d, int n_band, int attend_self, int is_bf16,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(lv, out, band_page0, len_page, P, pt, L, d, n_band,
                                         attend_self, s)
                 : launch<float>(lv, out, band_page0, len_page, P, pt, L, d, n_band,
                                 attend_self, s);
}

const char* banded_consensus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
