// K4: block-banded ragged consensus attention over a flat, page-aligned
// token axis [T, L, d] (T = P pages of pt tokens; rows of the ragged serving
// route occupy whole pages).
//
//   out[t, l] = sum_w softmax_w(s[t, l, w]) . v[band(t, w), l]
//   s[t, l, w] = q[t, l] . khat[band(t, w), l] * d^-1/2
//
// with q = v = levels and khat = kv / max(||kv||, 1e-12), the norm in f32. Token t of
// page p attends over the W = n_band * pt slots of its row's page band:
// slot w = j * pt + u reads token min(band_page0[p] + j, P - 1) * pt + u.
// When attend_self is off the self slot ((band_page0[p] + j) * pt + u == t)
// scores -5e-4; then every slot w >= len_page[p] scores finfo(float32).min.
// The kernels take the per-token maps row_start and row_len (int32 [T]):
// rows start on a page boundary, so band_page0[p] = row_start[p * pt] / pt
// and len_page[p] = row_len[p * pt], which each block reads for its page.
//
// Replaces: glom_tpu/kernels/banded_consensus.py:_banded_kernel (the
// pallas_call at :174). It computes what that kernel computes, not block for
// block: the Pallas grid step is a whole [pt, L, d] page and its f32
// accumulator (768 KB at the flagship's pt = 64, L = 6, d = 512), past a
// block's 227 KB of shared memory. Levels never mix in this function, so a
// block here owns one level of the query rows of one page and streams its
// row's band, a key tile at a time, through shared memory, with a running
// max, sum and accumulator per query row (an online softmax, as the
// Pallas kernel's over band pages). Three instances, which the C entry
// derives from the dtype, pt and d (instance_for; the wrapper's
// glom_tpu_torch/kernels/banded_consensus.py:k4_instance repeats the rule
// to allocate the scratch):
//
// "wgmma" (bf16, pt a multiple of 64: the flagship's pages of 64 and
// their multiples, d <= 512), Hopper's tensor cores on sm90_attn.cuh:
//   * a pre-pass (sm90::khat_kernel) writes khat = kv / max(||kv||, 1e-12),
//     rounded once to bf16, for all T * L rows into a [T, L, d] scratch
//     the caller allocates: a key row is normalised once a launch, not once
//     for each of the (window / 64) query blocks whose bands cover it;
//   * a block owns 64 query rows of one page (pt % 64 == 0: a block never
//     spans two pages, so it has one band) and one level; grid (T / 64, L).
//     Key tile it is band slots 64 it .. 64 it + 63, inside band page j =
//     64 it / pt, read at token min(band_page0[p] + j, P - 1) * pt + 64 it %
//     pt (the Pallas index map's clamp, never TMA's zero fill: an unused
//     page averages the clamped pages). Q, then each tile's khat rows and v
//     rows, come by TMA (128-byte swizzle) through maps of [T, L, d] as {d,
//     L, T} with a 64 x 1 x 64 box (the level a coordinate, the token stride
//     L * d), into single-stage rings;
//   * sm90::attn_key_loop: two warpgroups each compute the whole S = Q .
//     khat^T (wgmma m64n64k16), the masks, the online softmax in
//     registers, and O += P . V over their halves of the columns with P
//     rounded to bf16 (the RS form); O stays in registers;
//   * masks as _banded_kernel's (:83-90): the self slot is found from the
//     unclamped page index, so it lies in the tile whose band position
//     (band_page0[p] + j) * pt + 64 it % pt equals the block's first token,
//     on its diagonal; the length mask is applied on the tile holding len
//     (on every tile of an unused page). Tiles wholly past len are skipped
//     when the row has a valid slot;
//   * the epilogue forms out = O / l, stages each warp's rows through
//     shared memory and writes them as 16-byte row segments at the token
//     stride L * d.
// Rounding: khat and p are rounded to bf16 (as glom_tpu's bf16 K2 rounds
// them, consensus_update.py:505 and :184); scores, the softmax statistics
// and the sums are f32; the output is cast once.
//
// "wgmma_wide" (bf16, pt a multiple of 64, 512 < d <= 1024: glom_tpu's
// imagenet224-pod width): the same attention on sm90_attn.cuh's wide form
// (attn_pair_*), a third grid dimension of 512-column groups whose two
// blocks for each (query block, level) run as a cluster: block g holds only
// its 512 columns of Q, khat and V, sums the partial scores over them, and
// the pair adds the two partials (rank 0's first) after an exchange through
// distributed shared memory, so each score is computed once; the two
// warpgroups split the keys (32 each), exchange their row maxima, sums and
// P, and each loads its own khat (its 32 keys x the block's 512 columns)
// and V (64 keys x its 256 columns) a tile at a time with one TMA load
// each. Both
// blocks walk the same tiles (the page's band and len), so neither waits on
// an exchange its peer skips.
//
// "fma" (f32, and bf16 at pt < 64), the CUDA cores: everything after the
// load is f32, as in the Pallas body (k normalised in f32, f32 scores, p
// kept in f32, f32 products and sums; FMA), the output is cast once, with
// two sums taken in f64 and rounded once: a key's squared norm and each
// score's d products. Two f32 summation orders of the same scores differ
// by up to three times K4's f32 bar at d = 1024 on peaked levels (an f32
// plain version against an f64 one, NVIDIA H100), so the kernel and its
// plain version (`banded_ragged_consensus_plain`) round the exact sums. A
// block owns up to 32 query rows and streams 32 key rows a step,
// normalising each key row as it loads it. Each warp owns four query rows:
// its lanes hold one key each for the scores and the softmax step, and 4 x
// 4 x (d / 128) accumulator values each for p . v, with p handed across
// lanes by shuffles. Past d = 512 (up to 1024) a block owns 16 query rows
// and streams 16 key rows (three tiles of 32 rows x d in f32 would take
// 396 KB of shared memory at d = 1024), and a lane holds up to 8 chunks.
// A page with len_page 0 walks the whole band, every slot masked, so its
// output is the uniform average of the clamped band: finite, as in the
// Pallas kernel.
//
// Bound on the H100: bytes, for "wgmma". At the largest flagship ragged
// signature (P = 32, pt = 64, T = 2048, W = 256, bf16) one launch reads and
// writes 12.6 MB each (7.5 us at 3.35 TB/s) against 2 * 2 * T * L * W * d =
// 6.4 GFLOP of products (6.5 us at 989 TFLOP/s bf16; 96 us at 67 TFLOP/s
// f32 for "fma", which operations bound).
//
// Kept out of device memory: the gathered band, the [W] scores and
// probabilities of each query row, the f32 sums; the normalised k in
// "fma". The maps stay on the device.
//
// The output must not alias the input: other blocks still read it.
// Plain C interface (no PyTorch headers), bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

#include "sm90_attn.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;        // query rows per warp
constexpr int TILE = 32;       // query rows per block, key rows per step
constexpr int WIDE_TILE = 16;  // the same past NARROW_D
constexpr int NARROW_D = 512;  // d of the narrow instances: 4 chunks of 128, one column group
constexpr int MAX_D = sm90::ATTN_MAX_D;  // 8 chunks of 128
using sm90::NEG_MAX;
using sm90::SELF_VALUE;
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

// Shared-memory layout: q rows [TQ][ldq] (T), normalised k [TQ][ldk]
// (f32), raw v [TQ][ldv] (T). The pads keep 16-byte rows and spread the
// k rows that a warp's lanes read over the banks.
template <typename T, int TQ>
struct Layout {
  int ldq, ldk, ldv;
  size_t k_off, v_off, bytes;
  __host__ __device__ explicit Layout(int d) : ldq(d + 8), ldk(d + 4), ldv(d + 8) {
    k_off = align128(sizeof(T) * TQ * ldq);
    v_off = k_off + align128(sizeof(float) * TQ * ldk);
    bytes = v_off + align128(sizeof(T) * TQ * ldv);
  }
};

// MAX_CHUNKS: a lane's 128-column chunks (d / 128 at most); TQ: query rows
// a block and key rows a step (`tile` is min(pt, TQ)).
template <typename T, int MAX_CHUNKS, int TQ>
__global__ void __launch_bounds__(THREADS)
banded_consensus_kernel(const T* __restrict__ lv, T* __restrict__ out,
                        const int* __restrict__ row_start, const int* __restrict__ row_len,
                        int P, int pt, int L, int d, int n_band, int tile, int attend_self,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T, TQ> lay(d);
  T* qs = reinterpret_cast<T*>(smem);
  float* ks = reinterpret_cast<float*>(smem + lay.k_off);
  T* vs = reinterpret_cast<T*>(smem + lay.v_off);

  const int q0 = blockIdx.x * tile;  // first query token of the tile
  const int l = blockIdx.y;
  const int p = q0 / pt;  // a tile never crosses a page
  const int band0 = row_start[p * pt] / pt;
  const int len = row_len[p * pt];
  const size_t tstride = (size_t)L * d;  // token stride of [T, L, d]
  const T* lv_l = lv + (size_t)l * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = d / 128;
  const int row0 = warp * ROWS;  // this warp's first query row in the tile

  // Query rows of this level; rows past the tile are zeros (never written).
  for (int e = tid * 4; e < TQ * d; e += THREADS * 4) {
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
      double ss = 0.0;  // the squared norm in f64, its sqrt rounded once
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) {
        if (c < nc) {
          const int col = lane * 4 + c * 128;
          const typename Vec4<T>::raw raw = load_raw(src + col);
          store_raw(vs + r * lay.ldv + col, raw);
          x[c] = to_f4(raw);
          ss = fma((double)x[c].x, (double)x[c].x, ss);
          ss = fma((double)x[c].y, (double)x[c].y, ss);
          ss = fma((double)x[c].z, (double)x[c].z, ss);
          ss = fma((double)x[c].w, (double)x[c].w, ss);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float denom = fmaxf((float)sqrt(ss), 1e-12f);
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
    if (row0 >= TQ) continue;  // TQ = 16: warps 4 .. 7 only stage keys

    // Scores: lane = key row of the step, four query rows per warp, each an
    // f64 sum of f32 products, rounded once (as the plain version's).
    double s[ROWS] = {0.0, 0.0, 0.0, 0.0};
    if (lane < tile) {
      const float* kr = ks + lane * lay.ldk;
      const T* qr = qs + row0 * lay.ldq;
      for (int c = 0; c < d; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 qq = load_f4(qr + i * lay.ldq + c);
          s[i] = fma((double)qq.x, (double)kk.x, s[i]);
          s[i] = fma((double)qq.y, (double)kk.y, s[i]);
          s[i] = fma((double)qq.z, (double)kk.z, s[i]);
          s[i] = fma((double)qq.w, (double)kk.w, s[i]);
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
        si = (float)s[i] * scale;
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

template <typename T, int MAX_CHUNKS, int TQ>
int launch_fma_tiles(const void* lv, void* out, const int* row_start, const int* row_len, int P,
                     int pt, int L, int d, int n_band, int attend_self, cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  const cudaError_t err =
      sm90::lift_smem_cap(banded_consensus_kernel<T, MAX_CHUNKS, TQ>, lifted);
  if (err != cudaSuccess) return (int)err;
  const int tile = pt < TQ ? pt : TQ;
  const dim3 grid(P * pt / tile, L);
  const float scale = (float)(1.0 / sqrt((double)d));
  banded_consensus_kernel<T, MAX_CHUNKS, TQ><<<grid, THREADS, Layout<T, TQ>(d).bytes, stream>>>(
      static_cast<const T*>(lv), static_cast<T*>(out), row_start, row_len, P, pt, L, d,
      n_band, tile, attend_self, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma(const void* lv, void* out, const int* row_start, const int* row_len, int P,
               int pt, int L, int d, int n_band, int attend_self, cudaStream_t stream) {
  return d > NARROW_D ? launch_fma_tiles<T, MAX_D / 128, WIDE_TILE>(
                            lv, out, row_start, row_len, P, pt, L, d, n_band, attend_self, stream)
                      : launch_fma_tiles<T, NARROW_D / 128, TILE>(
                            lv, out, row_start, row_len, P, pt, L, d, n_band, attend_self, stream);
}

// --- "wgmma": bf16, pt a multiple of 64, on sm90_attn.cuh --------------------

using bf16 = __nv_bfloat16;
// The instances' names by number; kernels/banded_consensus.py reads them
// from this line (K4_INSTANCES).
const char* const INSTANCE_NAMES[] = {"fma", "wgmma", "wgmma_wide"};
constexpr int INSTANCE_FMA = 0, INSTANCE_WGMMA = 1, INSTANCE_WGMMA_WIDE = 2;

// The rule kernels/banded_consensus.py:k4_instance repeats for its scratch.
int instance_for(int is_bf16, int pt, int d) {
  if (!is_bf16 || pt % sm90::ATTN_ROWS != 0) return INSTANCE_FMA;
  return d > NARROW_D ? INSTANCE_WGMMA_WIDE : INSTANCE_WGMMA;
}

// Grid: (T / 64, L, 512-column groups: one unless WIDE). lv_map and k_map:
// the levels and khat [T, L, d] as {d, L, T} maps with a 64 x 1 x 64 box
// (token_map); WIDE: 4-D maps of [d / 64, T, L, 64] (wide_token_map) with
// boxes of 4 chunks x 64 tokens (lv) and 8 chunks x 32 tokens (k), and the
// two column groups of each (query block, level) run as a cluster.
template <bool WIDE>
__global__ void __launch_bounds__(sm90::ATTN_THREADS, 1)
banded_consensus_kernel_wgmma(const __grid_constant__ CUtensorMap lv_map,
                              const __grid_constant__ CUtensorMap k_map, bf16* __restrict__ out,
                              const int* __restrict__ row_start,
                              const int* __restrict__ row_len, int P, int pt, int L, int d,
                              int n_band, int attend_self, float scale) {
  constexpr int BOX = sm90::ATTN_BOX, KEYS = sm90::ATTN_KEYS, NC = sm90::ATTN_NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int boxes = d / 64;
  // The block's first 64-column chunk of the output (its column group).
  const int chunk0 = WIDE ? 2 * NC * blockIdx.z : 0;

  const int t0 = blockIdx.x * sm90::ATTN_ROWS;  // the block's first query token
  const int l = blockIdx.y;
  const int p = t0 / pt;  // a block never spans two pages (pt % 64 == 0)
  const int band0 = row_start[p * pt] / pt;
  const int len = row_len[p * pt];
  // Slots to walk: the whole band for an unused page (len 0), else up to
  // the key tile holding the row's last valid slot.
  const int W = n_band * pt;
  const int n_slots = len > 0 ? min(W, (len + KEYS - 1) / KEYS * KEYS) : W;
  const int tiles = n_slots / KEYS;

  // Key tile it's first key token: its band page clamped to the last page.
  auto key_token = [&](int it) {
    const int w0 = KEYS * it, j = w0 / pt;
    return min(band0 + j, P - 1) * pt + (w0 - j * pt);
  };

  // The thread's two rows of the block (wgmma's accumulator fragment) and
  // its column pairs.
  const int lane = threadIdx.x % 32, cq = 2 * (lane % 4);
  const int r_a = 16 * ((threadIdx.x % 128) / 32) + lane / 4, r_b = r_a + 8;
  // s holds slots w0 + key0 + 8 jj + cq + {0, 1} of the tile (the
  // accumulator fragment, m64n64 or the wide form's m64n32).
  auto mask = [&](int it, auto& s, int key0 = 0) {
    constexpr int JJ = sizeof(s) / sizeof(float) / 4;
    const int w0 = KEYS * it, j = w0 / pt;
    // Slot w0 + col sits at band position (band0 + j) * pt + w0 % pt + col
    // (unclamped); both that and t0 are multiples of 64, so the self slots
    // lie on this tile's diagonal exactly when the two are equal.
    const bool diag = !attend_self && (band0 + j) * pt + (w0 - j * pt) == t0;
    const bool edge = w0 + KEYS > len;  // the tile holding len; every tile when len = 0
    if (diag || edge) {
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = key0 + 8 * jj + cq + e;
          float& sa = s[4 * jj + e];
          float& sb = s[4 * jj + 2 + e];
          if (diag) {
            if (col == r_a) sa = SELF_VALUE;
            if (col == r_b) sb = SELF_VALUE;
          }
          if (w0 + col >= len) sa = sb = NEG_MAX;
        }
      }
    }
  };
  float o[sm90::ATTN_NC][sm90::ACC64];
  float m_a, m_b, l_a, l_b;
  unsigned char* stage_base;
  if constexpr (WIDE) {
    const uint32_t rank = sm90::cluster_rank();  // == blockIdx.z: the cluster spans z
    const int nb = min(2 * NC, boxes - chunk0);  // the block's boxes of d
    sm90::attn_pair_init(smem);
    sm90::attn_pair_loop(
        o, m_a, m_b, l_a, l_b, smem, tiles, nb, scale, rank,
        [&](unsigned char* dst, int half, uint64_t* bar) {
          sm90::tma_load_4d(dst, &lv_map, 0, l, t0, chunk0 + NC * half, bar);
        },
        [&](unsigned char* dst, int it, int kw, uint64_t* bar) {
          sm90::tma_load_4d(dst, &k_map, 0, l, key_token(it) + sm90::PAIR_KEYS * kw, chunk0,
                            bar);
        },
        [&](unsigned char* dst, int it, int kw, uint64_t* bar) {
          sm90::tma_load_4d(dst, &lv_map, 0, l, key_token(it), chunk0 + NC * kw, bar);
        },
        mask, [](unsigned char*, uint64_t*) {}, [](unsigned char*, uint64_t*) {});
    stage_base = smem + sm90::AttnPairSmem::K_OFF;
  } else {
    using Lay = sm90::AttnSmem;
    const Lay lay(d);
    unsigned char* qs = smem;
    unsigned char* ks = smem + lay.k_off;
    unsigned char* vs = smem + lay.v_off;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
    uint64_t* q_full = bars;
    uint64_t* k_full = bars + 1;
    uint64_t* v_full = bars + 2;
    auto load_k = [&](int it) {
      const int row = key_token(it);
      sm90::mbar_expect_tx(k_full, lay.boxes * BOX);
      for (int c = 0; c < lay.boxes; ++c)
        sm90::tma_load_3d(ks + c * BOX, &k_map, 64 * c, l, row, k_full);
    };
    auto load_v = [&](int it) {
      const int row = key_token(it);
      sm90::mbar_expect_tx(v_full, lay.boxes * BOX);
      for (int c = 0; c < lay.boxes; ++c)
        sm90::tma_load_3d(vs + c * BOX, &lv_map, 64 * c, l, row, v_full);
    };
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(q_full, lay.boxes * BOX);
      for (int c = 0; c < lay.boxes; ++c)
        sm90::tma_load_3d(qs + c * BOX, &lv_map, 64 * c, l, t0, q_full);
      load_k(0);
      load_v(0);
    }
    sm90::attn_key_loop(o, m_a, m_b, l_a, l_b, qs, ks, vs, q_full, k_full, v_full, tiles, d,
                        scale, load_k, load_v, mask);
    stage_base = ks;
  }

  // Epilogue: out = O / l through the warp's stage (k and v are free),
  // 16-byte row segments at the token stride L * d.
  const int warp = threadIdx.x / 32;
  const int w16 = 16 * (warp % 4);  // the warp's first row of the block
  float2* stage = reinterpret_cast<float2*>(stage_base + warp * sm90::ATTN_STAGE_BYTES);
  const float inv_a = __frcp_rn(l_a), inv_b = __frcp_rn(l_b);
  const size_t ld = (size_t)L * d;
  bf16* dst = out + (size_t)(t0 + w16) * ld + (size_t)l * d;
#pragma unroll
  for (int c = 0; c < sm90::ATTN_NC; ++c) {
    const int chunk = chunk0 + NC * (threadIdx.x / 128) + c;  // 64-column chunk of d
    if (chunk >= boxes) continue;  // past d: its box was not loaded
    sm90::stage_cons(o[c], l_a, inv_a, l_b, inv_b, stage);
    __syncwarp();
#pragma unroll
    for (int pass = 0; pass < 4; ++pass) {
      const int rw = 4 * pass + lane / 8, k = lane % 8;  // lane k of 8: columns 8k .. 8k+7
      float v[8];
      sm90::staged8(stage, rw, k, v);
      *reinterpret_cast<uint4*>(dst + rw * ld + 64 * chunk + 8 * k) =
          make_uint4(sm90::pack_bf16(v[0], v[1]), sm90::pack_bf16(v[2], v[3]),
                     sm90::pack_bf16(v[4], v[5]), sm90::pack_bf16(v[6], v[7]));
    }
    __syncwarp();
  }
  if constexpr (WIDE) sm90::cluster_sync();  // the peer no longer reads or writes here
}

// [T, L, d] bf16 as a {d, L, T} map with a 64 x 1 x 64 box: a box is 64
// tokens of one level, 64 columns (cached).
cudaError_t token_map(CUtensorMap* map, const void* ptr, int d, int L, int T) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)L, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)L * d * 2};
  const cuuint32_t box[3] = {64, 1, 64};
  return sm90::cached_map(map, ptr, dims, strides, box);
}

// [T, L, d] bf16 as a 4-D map {64, L, T, d / 64} (a column within its
// 64-column chunk, the level, the token, the chunk) whose box is `chunks`
// chunks x `tokens` tokens of one level: one load lands them as `chunks`
// swizzled 64-column boxes (cached).
cudaError_t wide_token_map(CUtensorMap* map, const void* ptr, int d, int L, int T, int tokens,
                           int chunks) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)L, (cuuint64_t)T, (cuuint64_t)d / 64};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)L * d * 2, 128};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)tokens, (cuuint32_t)chunks};
  return sm90::cached_map(map, ptr, dims, strides, box);
}

// The pre-pass and the attention.
template <bool WIDE>
int launch_wgmma(const bf16* lv, bf16* out, bf16* khat, const int* row_start,
                 const int* row_len, int P, int pt, int L, int d, int n_band, int attend_self,
                 cudaStream_t stream) {
  static bool lifted[sm90::MAX_DEVICES];
  const int T = P * pt;
  cudaError_t err = sm90::lift_smem_cap(banded_consensus_kernel_wgmma<WIDE>, lifted);
  CUtensorMap lv_map, k_map;
  if constexpr (WIDE) {
    if (err == cudaSuccess)
      err = wide_token_map(&lv_map, lv, d, L, T, sm90::ATTN_KEYS, sm90::ATTN_NC);
    if (err == cudaSuccess)
      err = wide_token_map(&k_map, khat, d, L, T, sm90::PAIR_KEYS, sm90::PAIR_BOXES);
  } else {
    if (err == cudaSuccess) err = token_map(&lv_map, lv, d, L, T);
    if (err == cudaSuccess) err = token_map(&k_map, khat, d, L, T);
  }
  if (err == cudaSuccess) err = sm90::launch_khat(lv, khat, (size_t)T * L, d, stream);
  if (err != cudaSuccess) return (int)err;
  const int groups = (d / 64 + 2 * sm90::ATTN_NC - 1) / (2 * sm90::ATTN_NC);
  const dim3 grid(T / sm90::ATTN_ROWS, L, groups);
  const float scale = (float)(1.0 / sqrt((double)d));
  if constexpr (WIDE)
    return (int)sm90::launch_pair(banded_consensus_kernel_wgmma<true>, grid, 2, stream, lv_map,
                                  k_map, out, row_start, row_len, P, pt, L, d, n_band,
                                  attend_self, scale);
  banded_consensus_kernel_wgmma<false><<<grid, sm90::ATTN_THREADS, sm90::AttnSmem(d).bytes,
                                         stream>>>(
      lv_map, k_map, out, row_start, row_len, P, pt, L, d, n_band, attend_self, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The instance a launch of these arguments runs, by name (instance_for).
const char* banded_consensus_instance(int is_bf16, int pt, int d) {
  return INSTANCE_NAMES[instance_for(is_bf16, pt, d)];
}

// lv, out: [P * pt, L, d], contiguous, one dtype (is_bf16 selects bf16,
// else f32), not aliased; row_start, row_len: int32 [P * pt] on the device;
// n_band = window / pt; d a multiple of 128, at most 1024; pt <= 32 or a
// multiple of 32 (past d = 512 for "fma": <= 16 or a multiple of 16). The
// instance follows from is_bf16, pt and d (instance_for): "wgmma" and
// "wgmma_wide" take khat, a bf16 [P * pt, L, d] scratch, and lv 16-byte
// aligned; "fma" takes khat NULL. A mismatch returns
// cudaErrorInvalidValue. Returns a cudaError_t.
int banded_consensus_fwd(const void* lv, void* out, void* khat, const int* row_start,
                         const int* row_len, int P, int pt, int L, int d, int n_band,
                         int attend_self, int is_bf16, void* stream) {
  const int instance = instance_for(is_bf16, pt, d);
  const int tile = instance == INSTANCE_FMA && d > NARROW_D ? WIDE_TILE : TILE;
  if (P < 1 || pt < 1 || L < 1 || n_band < 1 || d < 128 || d % 128 != 0 || d > MAX_D ||
      (pt > tile && pt % tile != 0) || (khat != nullptr) != (instance != INSTANCE_FMA))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance != INSTANCE_FMA)
    return (instance == INSTANCE_WGMMA_WIDE ? launch_wgmma<true> : launch_wgmma<false>)(
        static_cast<const bf16*>(lv), static_cast<bf16*>(out), static_cast<bf16*>(khat),
        row_start, row_len, P, pt, L, d, n_band, attend_self, s);
  return is_bf16 ? launch_fma<bf16>(lv, out, row_start, row_len, P, pt, L, d, n_band,
                                    attend_self, s)
                 : launch_fma<float>(lv, out, row_start, row_len, P, pt, L, d, n_band,
                                     attend_self, s);
}

// "wgmma_wide"'s launch (sm90::launch_pair): blocks of sm90::ATTN_THREADS
// threads and sm90::AttnPairSmem::BYTES of shared memory in clusters of two
// along grid z, and how many such clusters the device holds at once
// (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
int banded_consensus_wide_launch(int* threads, int* smem_bytes, int* cluster, int* clusters) {
  static bool lifted[sm90::MAX_DEVICES];
  cudaError_t err = sm90::lift_smem_cap(banded_consensus_kernel_wgmma<true>, lifted);
  *threads = sm90::ATTN_THREADS;
  *smem_bytes = sm90::AttnPairSmem::BYTES;
  *cluster = sm90::PAIR_CLUSTER;
  if (err == cudaSuccess) err = sm90::pair_clusters(banded_consensus_kernel_wgmma<true>, 2, clusters);
  return (int)err;
}

const char* banded_consensus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
