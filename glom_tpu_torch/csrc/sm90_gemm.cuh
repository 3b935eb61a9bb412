// The port's Hopper GEMM mainloop (sm_90a): TMA loads into rings of
// shared-memory stages, mbarrier hand-offs, wgmma with f32 sums in
// registers, and an epilogue functor run on those registers.
//
//   C[g] (rows x N) = A[g] (rows x K) . B[g] (K x N)
//
// bf16 in, f32 out to the epilogue, which owns every rounding point and
// every store. The grid is persistent (one block an SM at most), each
// block walking its share of the BM x BN tiles of every group in a fixed
// order, and each block holds two pipelines that share its tensor cores:
//
//   * two consumer warpgroups take the block's tiles in turn, each with its
//     own ring of STAGES shared-memory stages. A consumer runs a tile's K
//     loop -- wait on the stage's `full` mbarrier, wgmma.mma_async
//     m64n128k16 for both 64-row halves of the tile over the stage's BK
//     columns of K, free the stage on its `empty` mbarrier once the
//     products that read it have retired -- and then the tile's epilogue,
//     while the other consumer's K loop keeps the tensor cores busy. The
//     epilogue (`store_half`) passes each warp's rows through shared
//     memory and writes them as whole 16-byte row segments;
//   * two producer warps, one a ring, in a warpgroup after the consumers
//     that hands its registers to them (setmaxnreg: a consumer thread holds
//     128 f32 sums): one thread each keeps its ring filled with TMA loads
//     (cp.async.bulk.tensor) for its consumer's tiles one after another,
//     each load completing on its stage's `full` mbarrier with the bytes it
//     carries, so a tile's first loads overlap the previous tile's
//     epilogue.
//
// A ring serves one consumer, which waits on its stages in the order they
// are filled, so a wait can never mistake an older fill for the one it
// wants.
//
// Layouts: A is K-major (row-major [rows, K], as activations lie), B is
// MN-major (row-major [K, N], as the weights lie, read with wgmma's
// transposed-B form). Both land in shared memory through TMA's 128-byte
// swizzle, which the wgmma descriptors name. A comes from one of two
// tensor maps per group (the group rule): groups below `split` read `a_lo`
// at slot g with slab-relative rows, the others `a_hi` at slot g - split
// with absolute rows. A caller can so read a scratch for some groups and
// its input in place for the rest.
//
// Tile shape, K order and rounding points are compile-time constants: the
// K loop always runs k = 0, BK, 2 BK, ... and the tensor core sums each
// step in its fixed order, so a row's result depends neither on G, nor on
// the row count, nor on which block or warpgroup computes its tile. There
// is no split-K and no tile choice by shape. Rows and columns past the end
// of a map load as zeros (TMA fills out-of-bounds elements); the epilogue
// masks its stores. K must be a multiple of BK, N of 64.
//
// A user writes a __global__ wrapper that calls `gemm_tiles` with its
// epilogue (so profiles name the kernel), encodes its maps on the host with
// `make_a_map` / `make_b_map` (cuTensorMapEncodeTiled, looked up at run
// time with cudaGetDriverEntryPoint, so the library links only the CUDA
// runtime), and
// starts it with `launch`.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int BM = 128;  // tile rows: two m64 halves, one consumer warpgroup
constexpr int BN = 128;  // tile columns: m64n128k16 per half and K step of 16
constexpr int BK = 64;   // K columns a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 3;     // a ring
constexpr int CONSUMERS = 2;  // warpgroups 0 and 1, each with its ring
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producers' warpgroup
// Registers a thread after the producers hand theirs to the consumers
// (setmaxnreg; 168 a thread at launch, THREADS of them on the SM).
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int A_STAGE = BM * BK * 2;             // bytes
constexpr int B_BOX = BK * 64 * 2;               // one 64-column TMA box of B
constexpr int B_STAGE = (BN / 64) * B_BOX;
constexpr int RING_BYTES = STAGES * (A_STAGE + B_STAGE);
constexpr int STAGE_OUT = 16 * BN * 2;  // a consumer warp's 16 output rows in bf16
constexpr int SMEM_BYTES =
    1024 + CONSUMERS * RING_BYTES + CONSUMERS * 4 * STAGE_OUT + CONSUMERS * 2 * STAGES * 8;
constexpr int ACC = BN / 2;  // f32 sums a consumer thread holds for one 64-row half

// One launch's extent. Rows are counted in absolute terms (row0, row_end);
// a_lo's row coordinate is slab-relative (row - row0).
struct Shape {
  int K, N;
  int G;        // groups
  int split;    // groups below it read a_lo, the others a_hi
  int row0;     // the slab's first row
  int row_end;  // one past its last row
};

// --- device primitives ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// A wait this long is a broken barrier protocol, not a slow load (the
// longest launch here takes tens of milliseconds): trap, so the launch
// fails with an error instead of hanging the card.
constexpr uint64_t WAIT_LIMIT_NS = 10000000000ull;

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint64_t start = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 4096 == 0) {  // read the clock now and then
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > WAIT_LIMIT_NS) __trap();
    }
  }
}

// One 3-D TMA tile load, global -> shared, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// Keep the compiler from moving accumulator registers across the points
// where wgmma is started and awaited.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]: A K-major, B MN-major
// (imm-trans-b = 1), bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The accumulator fragment of m64n128: consumer thread t holds, for j = 0
// .. BN/8-1, columns 8j + 2(t%4) + {0, 1} of rows 16(t/32) + (t%32)/4 and
// that + 8 of its warpgroup's 64, in d[4j .. 4j+3]. f(row, col, v0, v1)
// sees each pair, row and col relative to the warpgroup's first row and
// the tile's first column.
template <class F>
__device__ __forceinline__ void for_each_pair(const float (&d)[ACC], int t, F&& f) {
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int c = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    f(r, 8 * j + c, d[4 * j], d[4 * j + 1]);
    f(r + 8, 8 * j + c, d[4 * j + 2], d[4 * j + 3]);
  }
}

// Store one bf16 output of a 64-row half: f(r, c, v0, v1) gives the
// __nv_bfloat162 of each pair (r, c as for_each_pair), which goes through
// the warp's STAGE_OUT bytes of shared memory (`stage`, XOR-swizzled by row
// so neither side conflicts on banks) and leaves as 16-byte stores, a
// warp writing two whole rows an instruction: row r at dst + r * ld, its
// rows from `rows` on and columns from `cols` on (multiples of 8) left out.
template <class F>
__device__ __forceinline__ void store_half(const float (&d)[ACC], int t, uint32_t* stage,
                                           __nv_bfloat16* dst, size_t ld, int rows, int cols,
                                           F&& f) {
  const int w16 = 16 * (t / 32), lane = t % 32;
  for_each_pair(d, t, [&](int r, int c, float v0, float v1) {
    const int rw = r - w16;  // the warp's row, 0..15
    const __nv_bfloat162 v = f(r, c, v0, v1);
    stage[rw * (BN / 2) + ((c / 2) ^ ((rw & 7) << 2))] = *reinterpret_cast<const uint32_t*>(&v);
  });
  __syncwarp();
  const uint4* rows16 = reinterpret_cast<const uint4*>(stage);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rw = 2 * i + lane / 16, k = lane % 16;  // row of the warp, 16-byte chunk
    const uint4 v = rows16[rw * (BN / 8) + (k ^ (rw & 7))];
    if (w16 + rw < rows && 8 * k < cols)
      *reinterpret_cast<uint4*>(dst + (size_t)(w16 + rw) * ld + 8 * k) = v;
  }
  __syncwarp();
}

// --- the tiles -----------------------------------------------------------

// A tile's place: group, first slab-relative row, first column.
struct TilePos {
  int g, row, col;
};

__device__ __forceinline__ TilePos tile_pos(int tile, int m_tiles, int n_tiles) {
  const int per_group = m_tiles * n_tiles;
  const int g = tile / per_group, r = tile - g * per_group;
  return {g, (r / n_tiles) * BM, (r % n_tiles) * BN};
}

// The block's share of the launch, called from a __global__ wrapper
// launched by `launch` (THREADS threads, SMEM_BYTES of dynamic shared
// memory). Block b takes tiles b, b + gridDim.x, ...; consumer warpgroup c
// (and its ring and producer) the c-th, (c+2)-th, ... of those.
// Epilogue::operator()(acc, g, abs_row, rel_row, col0, t, stage, shape) gets the
// sums of one 64-row half starting at abs_row (rel_row within the slab) and
// the tile's columns from col0, as thread t of the warpgroup holds them,
// and `stage`, the warp's STAGE_OUT bytes for `store_half`. The maps must
// be the wrapper's __grid_constant__ parameters.
template <class Epilogue>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap& a_lo, const CUtensorMap& a_hi,
                                           const CUtensorMap& b, const Shape& shape,
                                           const Epilogue& epi) {
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: stages start on that.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int n_tiles = (shape.N + BN - 1) / BN;
  const int m_tiles = (shape.row_end - shape.row0 + BM - 1) / BM;
  const int tiles = shape.G * m_tiles * n_tiles;
  const int k_tiles = shape.K / BK;
  // Warpgroup c < CONSUMERS is a consumer; the last warpgroup holds the
  // producers, its warp r serving ring r.
  const bool producer = threadIdx.x >= 128 * CONSUMERS;
  const int ring = producer ? (threadIdx.x - 128 * CONSUMERS) / 32 : threadIdx.x / 128;
  const int t = producer ? threadIdx.x % 32 : threadIdx.x % 128;
  unsigned char* sa = smem + ring * RING_BYTES;
  unsigned char* sb = sa + STAGES * A_STAGE;
  unsigned char* stages_out = smem + CONSUMERS * RING_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages_out + CONSUMERS * 4 * STAGE_OUT);
  uint64_t* full = bars + ring * 2 * STAGES;
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < CONSUMERS * 2 * STAGES; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (producer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (ring >= CONSUMERS || t != 0) return;
    int it = 0;  // the ring's K steps so far, over all its tiles
    for (int tile = blockIdx.x + ring * gridDim.x; tile < tiles;
         tile += CONSUMERS * gridDim.x) {
      const TilePos p = tile_pos(tile, m_tiles, n_tiles);
      const bool lo = p.g < shape.split;
      const CUtensorMap* am = lo ? &a_lo : &a_hi;
      const int slot = lo ? p.g : p.g - shape.split;
      const int arow = lo ? p.row : shape.row0 + p.row;
      // A 64-column box of B wholly past N is not loaded (its sums are
      // masked at the store).
      const int boxes = min(BN / 64, (shape.N - p.col) / 64);
      const uint32_t bytes = A_STAGE + boxes * B_BOX;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + s, (it / STAGES - 1) & 1);
        mbar_expect_tx(full + s, bytes);
        tma_load_3d(sa + s * A_STAGE, am, kt * BK, arow, slot, full + s);
        for (int j = 0; j < boxes; ++j)
          tma_load_3d(sb + s * B_STAGE + j * B_BOX, &b, p.col + 64 * j, kt * BK, p.g, full + s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  int it = 0;  // the ring's K steps so far, as its producer counts them
  for (int tile = blockIdx.x + ring * gridDim.x; tile < tiles; tile += CONSUMERS * gridDim.x) {
    const TilePos p = tile_pos(tile, m_tiles, n_tiles);
    float acc0[ACC], acc1[ACC];  // rows 0-63 and 64-127 of the tile
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc0[i] = acc1[i] = 0.0f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + s, (it / STAGES) & 1);
      // The A stage's two 64-row halves (128 bytes a row), and the B
      // stage's two 64-column boxes (BK rows of 128 bytes each).
      const uint32_t a0 = smem_u32(sa + s * A_STAGE), a1 = a0 + 64 * BK * 2;
      const uint32_t b0 = smem_u32(sb + s * B_STAGE);
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K advances 16 elements (32 bytes) inside the swizzle row;
        // 8-row groups 1024 bytes apart. B: K advances 16 rows (2048
        // bytes); 8-row groups 1024 bytes apart, 64-column boxes B_BOX.
        const uint64_t db = smem_desc(b0 + 2048 * kk, B_BOX, 1024);
        wgmma_m64n128k16(acc0, smem_desc(a0 + 32 * kk, 16, 1024), db);
        wgmma_m64n128k16(acc1, smem_desc(a1 + 32 * kk, 16, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products have retired
      fence_acc(acc0);
      fence_acc(acc1);
      if (kt > 0 && t == 0) mbar_arrive(empty + (it - 1) % STAGES);
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (t == 0) mbar_arrive(empty + (it - 1) % STAGES);
    const int abs_row = shape.row0 + p.row;
    uint32_t* stage = reinterpret_cast<uint32_t*>(stages_out + (threadIdx.x / 32) * STAGE_OUT);
    epi(acc0, p.g, abs_row, p.row, p.col, t, stage, shape);
    epi(acc1, p.g, abs_row + 64, p.row + 64, p.col, t, stage, shape);
  }
}

// --- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 map with the 128-byte swizzle: extents dims (innermost
// first), the byte strides of dims 1 and 2, and the box (box[0] = 64).
// Out-of-bounds elements load as zeros.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[3],
                               const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3]) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                          strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 tensor [slots, rows, inner], contiguous, as a 3-D map whose box is
// [1, box_rows, box_inner] (box_inner = 64).
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int inner, int rows, int slots,
                            int box_inner, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slots)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * rows * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  return make_map_3d(map, ptr, dims, strides, box);
}

// An A operand map ([slots, rows, K], box BM x BK) and a B operand map
// ([G, K, N], box BK x 64).
inline cudaError_t make_a_map(CUtensorMap* map, const void* ptr, int K, int rows, int slots) {
  return make_map(map, ptr, K, rows, slots, BK, BM);
}
inline cudaError_t make_b_map(CUtensorMap* map, const void* ptr, int K, int N, int G) {
  return make_map(map, ptr, N, K, G, 64, BK);
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

// The device's SM count, read once per device.
inline int sm_count() {
  static int counts[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= MAX_DEVICES) {
    int n = 0;
    return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess ? n : 0;
  }
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

// One persistent grid of `kernel` (a __global__ wrapper of gemm_tiles)
// over the launch's tiles: a block an SM, or a block a tile where there are
// fewer. `lifted` is the kernel's own per-device flags.
template <class Kernel, class Epilogue>
cudaError_t launch(Kernel kernel, bool* lifted, const CUtensorMap& a_lo, const CUtensorMap& a_hi,
                   const CUtensorMap& b, const Shape& shape, const Epilogue& epi,
                   cudaStream_t stream) {
  cudaError_t err = lift_smem_cap(kernel, lifted);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int tiles = shape.G * ((shape.row_end - shape.row0 + BM - 1) / BM) *
                    ((shape.N + BN - 1) / BN);
  kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES, stream>>>(a_lo, a_hi, b, shape, epi);
  return cudaGetLastError();
}

}  // namespace sm90
