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
// Layouts, compile-time per instance (A_MN, B_KMAJOR). By default A is
// K-major (row-major [rows, K], as activations lie: one [BM x BK] box a
// stage) and B MN-major (row-major [K, N], as the weights lie, read with
// wgmma's transposed-B form: two [BK x 64] boxes a stage). A_MN reads A
// MN-major instead (row-major [K, rows], as an activation lies when it is
// contracted over its rows, A^T . B: two [BK x 64] boxes, the B form of
// descriptor, imm-trans-a = 1), and B_KMAJOR reads B K-major (row-major
// [N, K], as a weight lies in x . W^T: one [BN x BK] box, the A form of
// descriptor, imm-trans-b = 0). Every stage lands in shared memory through
// TMA's 128-byte swizzle, which the wgmma descriptors name. A comes from
// one of two tensor maps per group (the group rule): groups below `split`
// read `a_lo` at slot g with slab-relative rows, the others `a_hi` at slot
// g - split with absolute rows. A caller can so read a scratch for some
// groups and its input in place for the rest. B is read at slot g, or with
// `b_split` > 0 at slot g < b_split ? g : g - b_split (a cotangent shared
// by two group ranges).
//
// Tile shape, K order and rounding points are compile-time constants: the
// K loop always runs k = 0, BK, 2 BK, ... and the tensor core sums each
// step in its fixed order, so a row's result depends neither on G, nor on
// the row count, nor on which block or warpgroup computes its tile. There
// is no split-K and no tile choice by shape. Rows and columns past the end
// of a map load as zeros (TMA fills out-of-bounds elements); the epilogue
// masks its stores. N must be a multiple of 64. K rounds up to whole BK
// steps: the K elements past the map's extent load as zeros, which add
// nothing to the products (and nothing to COLSUM's column sums).
//
// COLSUM (B MN-major only): the tiles of the first row block also sum each
// of B's columns over K, in f32, from the shared-memory stages before they
// are freed (consumer thread t, column t, after issuing the stage's
// products), and hand the sums to the epilogue's `col_sum`.
//
// An epilogue that reads device memory (the saved pre, f32 totals) may
// define `prefetch(g, abs_row, col0, t, shape)`: each consumer thread calls
// it when its tile starts, to bring the tile's lines into L2 while the K
// loop runs.
//
// A user writes a __global__ wrapper that calls `gemm_tiles` (one problem)
// or `gemm_problems` (up to two problems of one instance in one persistent
// grid, the second's tiles after the first's) with its epilogue (so
// profiles name the kernel), encodes its maps on the host with
// `make_kmajor_map` / `make_mnmajor_map` (cuTensorMapEncodeTiled, looked up
// at run time with cudaGetDriverEntryPoint, so the library links only the
// CUDA runtime), and starts it with `launch_tiles`.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int A_BOX = BK * 64 * 2;               // one 64-column box of an MN-major A
constexpr int B_BOX = BK * 64 * 2;               // one 64-column TMA box of B
constexpr int B_STAGE = (BN / 64) * B_BOX;
static_assert(A_STAGE == (BM / 64) * A_BOX && B_STAGE == BN * BK * 2,
              "either operand order fills the same stage bytes");
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
  int b_split = 0;  // B slot: g < b_split ? g : g - b_split (0: slot g)
  int id = 0;       // which problem of a gemm_problems launch, for the epilogue
};

// A problem's tensor maps (the wrapper's __grid_constant__ parameters) and
// extent.
struct Operands {
  const CUtensorMap* a_lo;
  const CUtensorMap* a_hi;
  const CUtensorMap* b;
  Shape shape;
};

__host__ __device__ __forceinline__ int tile_count(const Shape& s) {
  return s.G * ((s.row_end - s.row0 + BM - 1) / BM) * ((s.N + BN - 1) / BN);
}

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

// d[64 x 128] += A[64 x 16] . B[16 x 128], bf16 in, f32 sums: A K-major
// (TRANS_A = 0) or MN-major (1), B K-major (TRANS_B = 0) or MN-major (1).
template <int TRANS_A, int TRANS_B>
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
      "%64, %65, p, 1, 1, %67, %68;\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// The accumulator fragment of m64n128: consumer thread t holds, for j = 0
// .. BN/8-1, columns 8j + 2(t%4) + {0, 1} of rows 16(t/32) + (t%32)/4 and
// that + 8 of its warpgroup's 64, in d[4j .. 4j+3]. f(row, col, v0, v1)
// sees each pair, row and col relative to the warpgroup's first row and
// the tile's first column. Over a non-const fragment f may take v0, v1 by
// reference and rewrite the sums in place.
template <class Acc, class F>
__device__ __forceinline__ void for_each_pair(Acc& d, int t, F&& f) {
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int c = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    f(r, 8 * j + c, d[4 * j], d[4 * j + 1]);
    f(r + 8, 8 * j + c, d[4 * j + 2], d[4 * j + 3]);
  }
}

// A consumer warp's STAGE_OUT bytes of shared memory (`stage`) hold 16 rows
// x BN bf16 columns, XOR-swizzled by row so that neither the accumulator
// fragment's pairs nor whole 16-byte row segments conflict on banks. The
// u32 of the pair at (warp row rw, column c):
__device__ __forceinline__ uint32_t& stage_at(uint32_t* stage, int rw, int c) {
  return stage[rw * (BN / 2) + ((c / 2) ^ ((rw & 7) << 2))];
}

// Write the warp's staged rows out as 16-byte stores, a warp writing two
// whole rows an instruction: row r at dst + r * ld, its rows from `rows` on
// and columns from `cols` on (multiples of 8) left out.
__device__ __forceinline__ void flush_stage(const uint32_t* stage, int t, __nv_bfloat16* dst,
                                            size_t ld, int rows, int cols) {
  const int w16 = 16 * (t / 32), lane = t % 32;
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

// The inverse: read the warp's 16 rows of a bf16 [rows, ld] tensor from src
// into the stage as 16-byte loads (rows and columns past the end are not
// read; their stage entries are left as they were).
__device__ __forceinline__ void fill_stage(uint32_t* stage, int t, const __nv_bfloat16* src,
                                           size_t ld, int rows, int cols) {
  const int w16 = 16 * (t / 32), lane = t % 32;
  uint4* rows16 = reinterpret_cast<uint4*>(stage);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rw = 2 * i + lane / 16, k = lane % 16;
    if (w16 + rw < rows && 8 * k < cols)
      rows16[rw * (BN / 8) + (k ^ (rw & 7))] =
          *reinterpret_cast<const uint4*>(src + (size_t)(w16 + rw) * ld + 8 * k);
  }
  __syncwarp();
}

// Store one bf16 output of a 64-row half: f(r, c, v0, v1) gives the
// __nv_bfloat162 of each pair (r, c as for_each_pair), which goes through
// the warp's stage and leaves through flush_stage.
template <class F>
__device__ __forceinline__ void store_half(const float (&d)[ACC], int t, uint32_t* stage,
                                           __nv_bfloat16* dst, size_t ld, int rows, int cols,
                                           F&& f) {
  const int w16 = 16 * (t / 32);
  for_each_pair(d, t, [&](int r, int c, float v0, float v1) {
    const __nv_bfloat162 v = f(r, c, v0, v1);
    stage_at(stage, r - w16, c) = *reinterpret_cast<const uint32_t*>(&v);
  });
  __syncwarp();
  flush_stage(stage, t, dst, ld, rows, cols);
}

// Bring the 128-byte line at p into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Whether an epilogue defines prefetch().
template <class E, class = void>
struct has_prefetch : std::false_type {};
template <class E>
struct has_prefetch<E, std::void_t<decltype(&E::prefetch)>> : std::true_type {};

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
// launched by `launch_tiles` (THREADS threads, SMEM_BYTES of
// dynamic shared memory) over P problems of one instance, problem q's tiles
// numbered after problem q-1's. Block b takes tiles b, b + gridDim.x, ...;
// consumer warpgroup c (and its ring and producer) the c-th, (c+2)-th, ...
// of those. Epilogue::operator()(acc, g, abs_row, rel_row, col0, t, stage,
// shape) gets the sums of one 64-row half starting at abs_row (rel_row
// within the slab) and the tile's columns from col0, as thread t of the
// warpgroup holds them, `stage`, the warp's STAGE_OUT bytes for
// `store_half`, and the problem's shape. With COLSUM, a tile of the first
// row block first calls Epilogue::col_sum(sum, g, col, shape) with the sum
// over K of its column col = col0 + t of B. The maps must be the wrapper's
// __grid_constant__ parameters.
template <bool A_MN, bool B_KMAJOR, bool COLSUM, int P, class Epilogue>
__device__ __forceinline__ void gemm_problems(const Operands (&ops)[P], const Epilogue& epi) {
  static_assert(P == 1 || P == 2, "one or two problems a launch");
  static_assert(!(COLSUM && B_KMAJOR), "column sums read B's MN-major stages");
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: stages start on that.
  // The offset applies to the shared array itself, so every pointer below
  // stays visibly shared and its accesses compile to LDS/STS, not generic
  // loads and stores.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tiles0 = tile_count(ops[0].shape);
  const int tiles = P == 1 ? tiles0 : tiles0 + tile_count(ops[P - 1].shape);
  // Problem and tile within it of a tile of the launch.
  auto locate = [&](int tile, Operands& op, TilePos& p) {
    const bool second = P == 2 && tile >= tiles0;
    op = second ? ops[P - 1] : ops[0];
    const Shape& s = op.shape;
    p = tile_pos(second ? tile - tiles0 : tile, (s.row_end - s.row0 + BM - 1) / BM,
                 (s.N + BN - 1) / BN);
  };
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
      Operands op;
      TilePos p;
      locate(tile, op, p);
      const Shape& sh = op.shape;
      const bool lo = p.g < sh.split;
      const CUtensorMap* am = lo ? op.a_lo : op.a_hi;
      const int slot = lo ? p.g : p.g - sh.split;
      const int arow = lo ? p.row : sh.row0 + p.row;
      const int bslot = p.g < sh.b_split ? p.g : p.g - sh.b_split;
      // A 64-column box wholly past the rows (MN-major A) or past N
      // (MN-major B) is not loaded (its sums are masked at the store).
      const int a_boxes = A_MN ? min(BM / 64, (sh.row_end - sh.row0 - p.row + 63) / 64) : 0;
      const int b_boxes = B_KMAJOR ? 0 : min(BN / 64, (sh.N - p.col) / 64);
      const uint32_t bytes = (A_MN ? a_boxes * A_BOX : A_STAGE) +
                             (B_KMAJOR ? B_STAGE : b_boxes * B_BOX);
      const int k_tiles = (sh.K + BK - 1) / BK;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + s, (it / STAGES - 1) & 1);
        mbar_expect_tx(full + s, bytes);
        if constexpr (A_MN) {
          for (int j = 0; j < a_boxes; ++j)
            tma_load_3d(sa + s * A_STAGE + j * A_BOX, am, arow + 64 * j, kt * BK, slot, full + s);
        } else {
          tma_load_3d(sa + s * A_STAGE, am, kt * BK, arow, slot, full + s);
        }
        if constexpr (B_KMAJOR) {
          tma_load_3d(sb + s * B_STAGE, op.b, kt * BK, p.col, bslot, full + s);
        } else {
          for (int j = 0; j < b_boxes; ++j)
            tma_load_3d(sb + s * B_STAGE + j * B_BOX, op.b, p.col + 64 * j, kt * BK, bslot,
                        full + s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  int it = 0;  // the ring's K steps so far, as its producer counts them
  for (int tile = blockIdx.x + ring * gridDim.x; tile < tiles; tile += CONSUMERS * gridDim.x) {
    Operands op;
    TilePos p;
    locate(tile, op, p);
    const int k_tiles = (op.shape.K + BK - 1) / BK;
    const int abs_row = op.shape.row0 + p.row;
    if constexpr (has_prefetch<Epilogue>::value) epi.prefetch(p.g, abs_row, p.col, t, op.shape);
    const bool sums = COLSUM && p.row == 0;
    // COLSUM: column t of B summed over K, as four partial sums (rows r %
    // 4) so the adds do not wait on each other, combined in a fixed order.
    float csum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc0[ACC], acc1[ACC];  // rows 0-63 and 64-127 of the tile
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc0[i] = acc1[i] = 0.0f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + s, (it / STAGES) & 1);
      // The A stage's two 64-row halves: K-major, 64 rows of 128 bytes
      // each; MN-major, two 64-column boxes of BK rows of 128 bytes (8192
      // bytes either way). The B stage: MN-major, two 64-column boxes of BK
      // rows; K-major, BN rows of 128 bytes.
      const uint32_t a0 = smem_u32(sa + s * A_STAGE), a1 = a0 + A_BOX;
      const uint32_t b0 = smem_u32(sb + s * B_STAGE);
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major: K advances 16 elements (32 bytes) inside the swizzle
        // row; 8-row groups 1024 bytes apart. MN-major: K advances 16 rows
        // (2048 bytes); 8-row groups 1024 bytes apart, 64-column boxes a
        // box apart.
        const uint64_t db = B_KMAJOR ? smem_desc(b0 + 32 * kk, 16, 1024)
                                     : smem_desc(b0 + 2048 * kk, B_BOX, 1024);
        const uint64_t da0 = A_MN ? smem_desc(a0 + 2048 * kk, A_BOX, 1024)
                                  : smem_desc(a0 + 32 * kk, 16, 1024);
        const uint64_t da1 = A_MN ? smem_desc(a1 + 2048 * kk, A_BOX, 1024)
                                  : smem_desc(a1 + 32 * kk, 16, 1024);
        wgmma_m64n128k16<A_MN ? 1 : 0, B_KMAJOR ? 0 : 1>(acc0, da0, db);
        wgmma_m64n128k16<A_MN ? 1 : 0, B_KMAJOR ? 0 : 1>(acc1, da1, db);
      }
      wgmma_commit();
      if constexpr (COLSUM) {
        if (sums) {  // column t: box t / 64, byte 2 (t % 64) of each swizzled row
          const unsigned char* box = sb + s * B_STAGE + (t / 64) * B_BOX;
          const int cb = 2 * (t % 64);
#pragma unroll 16
          for (int r = 0; r < BK; ++r)
            csum[r % 4] += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                box + r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15))));
        }
      }
      wgmma_wait<1>();  // the previous step's products have retired
      fence_acc(acc0);
      fence_acc(acc1);
      if (kt > 0 && t == 0) mbar_arrive(empty + (it - 1) % STAGES);
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (t == 0) mbar_arrive(empty + (it - 1) % STAGES);
    if constexpr (COLSUM) {
      if (sums) epi.col_sum((csum[0] + csum[1]) + (csum[2] + csum[3]), p.g, p.col + t, op.shape);
    }
    uint32_t* stage = reinterpret_cast<uint32_t*>(stages_out + (threadIdx.x / 32) * STAGE_OUT);
    epi(acc0, p.g, abs_row, p.row, p.col, t, stage, op.shape);
    epi(acc1, p.g, abs_row + 64, p.row + 64, p.col, t, stage, op.shape);
  }
}

// One problem (the forward's passes): A K-major and B MN-major unless the
// instance says otherwise.
template <bool A_MN = false, bool B_KMAJOR = false, bool COLSUM = false, class Epilogue>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap& a_lo, const CUtensorMap& a_hi,
                                           const CUtensorMap& b, const Shape& shape,
                                           const Epilogue& epi) {
  const Operands ops[1] = {{&a_lo, &a_hi, &b, shape}};
  gemm_problems<A_MN, B_KMAJOR, COLSUM>(ops, epi);
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

// A K-major operand map ([slots, rows, K], box BM x BK: A, or B of a
// B_KMAJOR instance with rows = N, BN = BM) and an MN-major one ([slots, K,
// rows], box BK x 64: B, or A of an A_MN instance with rows = its rows).
static_assert(BM == BN, "one K-major box serves A and B");
inline cudaError_t make_kmajor_map(CUtensorMap* map, const void* ptr, int K, int rows,
                                   int slots) {
  return make_map(map, ptr, K, rows, slots, BK, BM);
}
inline cudaError_t make_mnmajor_map(CUtensorMap* map, const void* ptr, int K, int rows,
                                    int slots) {
  return make_map(map, ptr, rows, K, slots, 64, BK);
}

// Lift a kernel's dynamic shared-memory cap to the device's opt-in limit,
// once per device (`done` flags which devices are set).
constexpr int MAX_DEVICES = 64;
// That limit on sm_90 (227 KB): the layouts that hold d-wide tiles pick
// their smaller tiles where the larger exceed it.
constexpr size_t SMEM_OPTIN = 232448;

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

// One persistent grid of `kernel` (a __global__ wrapper of gemm_tiles or
// gemm_problems) over `tiles` tiles: a block an SM, or a block a tile where
// there are fewer. `lifted` is the kernel's own per-device flags; `args`
// are the kernel's parameters.
template <class Kernel, class... Args>
cudaError_t launch_tiles(Kernel kernel, bool* lifted, int tiles, cudaStream_t stream,
                         const Args&... args) {
  cudaError_t err = lift_smem_cap(kernel, lifted);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  if (tiles <= 0) return cudaSuccess;
  kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace sm90
