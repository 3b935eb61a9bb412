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
// The pair instance (PAIR): the same tiles, K order and rounding points on
// a persistent grid of two-block clusters. The two blocks of a cluster take
// the two tiles of a pair, tiles 2i and 2i + 1 of the launch: the same
// rows of A and adjacent column blocks (the launch's every N a multiple of
// 2 BN, so no pair straddles a row block, a group or a problem), and for
// each K step each block TMA-loads one 64-row half of A's stage with
// .multicast::cluster into both blocks' stages, and its own B. A stage's
// `full` barrier so completes on both halves' bytes, and its `empty`
// barrier counts two releases, its own consumer's and the peer's (a remote
// arrive), before the producer refills it: each block's L2 reads of A are
// halved, a quarter of the operand bytes (PERF.md: the 128 x 128 tiles fed
// from L2 at 64 FLOP a byte wait on their loads). Cluster c's ring r takes
// pairs c + (r + 2k) * clusters, so both blocks walk the same pairs in the
// same order. A producer drains its ring's `empty` barriers before it
// exits, so no block leaves while the peer may still write into it or
// arrive on it. Its epilogues may store through TMA (`pair_store_half`,
// from a warp stage laid out as two swizzled 64-column boxes, `pair_at`)
// and add to f32 totals through TMA reductions (`pair_reduce_half`), so a
// consumer's results leave without LSU round trips: a result is the same
// bits as the single-block instance's, tile for tile.
//
// A user writes a __global__ wrapper that calls `gemm_tiles` (one problem)
// or `gemm_problems` (up to two problems of one instance in one persistent
// grid, the second's tiles after the first's) with its epilogue (so
// profiles name the kernel), encodes its maps on the host with
// `make_kmajor_map` / `make_mnmajor_map` (cuTensorMapEncodeTiled, looked up
// at run time with cudaGetDriverEntryPoint, so the library links only the
// CUDA runtime), and starts it with `launch_tiles` (`launch_pairs` for the
// pair instance).

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

// The block's rank in its cluster, and the shared::cluster address of the
// same offset in block `rank`'s shared memory.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Every thread of the cluster arrives, then waits (release and acquire at
// cluster scope). Not the .aligned form: a warp's lanes may reach it apart.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrive on another block's mbarrier at `bar` (a shared::cluster address)
// with the default release at CTA scope: the pair instance's consumers
// free a stage in both blocks this way once their products that read it
// have retired (wgmma_wait). A release at cluster scope
// (`mbar_arrive_cluster`, sm90_attn.cuh) fences every K step and stalls the
// warpgroup's next wgmma (PERF.md: the K loops' products took 2.5x as
// long with it).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// The same load into the same offset of both blocks of a two-block
// cluster, completing on the mbarrier at `bar`'s offset in each.
__device__ __forceinline__ void tma_load_3d_pair(void* dst, const CUtensorMap* map, int c0, int c1,
                                                 int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "h"(static_cast<uint16_t>(3))
      : "memory");
}

// One 3-D TMA tile store, shared -> global, in this thread's bulk group;
// elements past the map's extent are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// One 3-D TMA reduction, shared -> global: the f32 box at `src` added
// element by element to the map's box (cp.reduce.async.bulk .add), in this
// thread's bulk group.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk stores have read their shared memory (it may be
// written again) / have completed.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Order this thread's shared-memory writes before a later TMA read of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// The pair instance's warp stage: the same 16 rows x BN bf16 columns as
// two 64-column boxes [2][16 rows][128 bytes], each in TMA's 128-byte
// swizzle (16-byte chunk k of row rw at chunk k ^ (rw % 8)), so a TMA store
// takes a box as it lies; neither the fragment's pairs nor whole 16-byte
// row segments conflict on banks. The u32 of the pair at (warp row rw,
// column c):
constexpr int PAIR_BOX_ROWS = 16;  // a warp's rows: a store box is [64 columns x 16 rows]
__device__ __forceinline__ uint32_t& pair_at(uint32_t* stage, int rw, int c) {
  return stage[(c / 64) * 512 + rw * 32 + (((c % 64) / 2) ^ ((rw & 7) << 2))];
}

// Store the warp's staged rows through TMA: its two 64-column boxes at
// columns col0, col0 + 64 and rows row0 + 16 (warp) .. of slot `slot` of
// `map` (a [slots, rows, N] bf16 map with box [64, 16, 1]). Lane 0 issues
// them after every lane's writes are fenced for the async proxy; the warp
// writes its stage again only after `pair_reuse`.
__device__ __forceinline__ void pair_flush(const uint32_t* stage, int t, const CUtensorMap* map,
                                           int col0, int row0, int slot) {
  fence_proxy_async();
  __syncwarp();
  if (t % 32 == 0) {
    const int row = row0 + 16 * (t / 32);
    tma_store_3d(map, stage, col0, row, slot);
    tma_store_3d(map, stage + 512, col0 + 64, row, slot);
    bulk_commit();
  }
}

// Before a warp writes its stage again: its last TMA stores have read it.
__device__ __forceinline__ void pair_reuse(int t) {
  if (t % 32 == 0) bulk_wait_read();
  __syncwarp();
}

// store_half for the pair instance: f(j, v0, v1) gives the __nv_bfloat162
// of each of the thread's pairs (columns 8 j + 2 (t % 4) + {0, 1}, j a
// constant of the unrolled loop, of both its rows), which goes through the
// warp's stage (pair_at) and leaves by TMA (pair_flush) at (col0, row0,
// slot) of `map`.
template <class F>
__device__ __forceinline__ void pair_store_half(const float (&d)[ACC], int t, uint32_t* stage,
                                                const CUtensorMap* map, int col0, int row0,
                                                int slot, F&& f) {
  const int rw = (t % 32) / 4, c = 2 * (t % 4);
  pair_reuse(t);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const __nv_bfloat162 a = f(j, d[4 * j], d[4 * j + 1]), b = f(j, d[4 * j + 2], d[4 * j + 3]);
    pair_at(stage, rw, 8 * j + c) = *reinterpret_cast<const uint32_t*>(&a);
    pair_at(stage, rw + 8, 8 * j + c) = *reinterpret_cast<const uint32_t*>(&b);
  }
  pair_flush(stage, t, map, col0, row0, slot);
}

// The pair instance's f32 warp stage for a reduction: 16 rows x 64
// columns of f32 as two 32-column boxes [2][16 rows][128 bytes] in TMA's
// 128-byte swizzle. The float at (warp row rw, column c < 64):
__device__ __forceinline__ float* pair_f32_at(uint32_t* stage, int rw, int c) {
  return reinterpret_cast<float*>(stage) + (c / 32) * 512 + rw * 32 +
         ((((c % 32) / 4) ^ (rw & 7)) * 4) + c % 4;
}

// Add one 64-row half of f32 sums to an f32 [slots, rows, N] tensor through
// TMA reductions (`map`: box [32, 16, 1] f32): per 64-column round the
// warp stages its 16 rows and lane 0 adds the two boxes at (col0 + 64
// round (+ 32), row0 + 16 warp, slot).
__device__ __forceinline__ void pair_reduce_half(const float (&d)[ACC], int t, uint32_t* stage,
                                                 const CUtensorMap* map, int col0, int row0,
                                                 int slot) {
  const int rw = (t % 32) / 4, c = 2 * (t % 4);
#pragma unroll
  for (int round = 0; round < BN / 64; ++round) {
    pair_reuse(t);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * round + jj;
      *reinterpret_cast<float2*>(pair_f32_at(stage, rw, 8 * jj + c)) =
          make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(pair_f32_at(stage, rw + 8, 8 * jj + c)) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
    fence_proxy_async();
    __syncwarp();
    if (t % 32 == 0) {
      const int row = row0 + 16 * (t / 32);
      tma_reduce_add_3d(map, stage, col0 + 64 * round, row, slot);
      tma_reduce_add_3d(map, stage + 512, col0 + 64 * round + 32, row, slot);
      bulk_commit();
    }
  }
}

// Bring the 128-byte line at p into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Whether an epilogue defines prefetch() or tile() (both halves in one
// call, in place of two calls of operator()).
template <class E, class = void>
struct has_prefetch : std::false_type {};
template <class E>
struct has_prefetch<E, std::void_t<decltype(&E::prefetch)>> : std::true_type {};
template <class E, class = void>
struct has_tile : std::false_type {};
template <class E>
struct has_tile<E, std::void_t<decltype(&E::tile)>> : std::true_type {};

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
// of those. PAIR (launched by `launch_pairs`): cluster b / 2 takes pairs b /
// 2, b / 2 + clusters, ... in the same way, rank q tile 2 i + q of pair i.
// Epilogue::operator()(acc, g, abs_row, rel_row, col0, t, stage, shape)
// gets the sums of one 64-row half starting at abs_row (rel_row within the
// slab) and the tile's columns from col0, as thread t of the warpgroup
// holds them, `stage`, the warp's STAGE_OUT bytes for `store_half` (PAIR:
// `pair_store_half`), and the problem's shape. With COLSUM, a tile of the
// first row block first calls Epilogue::col_sum(sum, g, col, shape) with
// the sum over K of its column col = col0 + t of B. The maps must be the
// wrapper's __grid_constant__ parameters; PAIR takes a K-major A map whose
// box is 64 rows (`make_kmajor_map(..., 64)`).
template <bool A_MN, bool B_KMAJOR, bool COLSUM, bool PAIR, int P, class Epilogue>
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
  // The work items (tiles, or PAIR's pairs) and this block's unit of the
  // grid that walks them (the block, or its cluster).
  const uint32_t rank = PAIR ? cluster_rank() : 0;
  const int items = PAIR ? tiles / 2 : tiles;
  const int units = PAIR ? gridDim.x / 2 : gridDim.x;
  const int unit = PAIR ? blockIdx.x / 2 : blockIdx.x;
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
    // PAIR: a stage's `empty` takes both blocks' consumers' releases.
    for (int i = 0; i < CONSUMERS * 2 * STAGES; ++i)
      mbar_init(bars + i, PAIR && i % (2 * STAGES) >= STAGES ? 2 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // PAIR: neither block loads into or arrives at the other before both are
  // set up.
  if constexpr (PAIR) cluster_sync();
  else __syncthreads();

  if (producer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (ring >= CONSUMERS || t != 0) return;
    int it = 0;  // the ring's K steps so far, over all its tiles
    for (int item = unit + ring * units; item < items; item += CONSUMERS * units) {
      const int tile = PAIR ? 2 * item + rank : item;
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
      // PAIR: both halves of A arrive, one from each block.
      const uint32_t bytes = (A_MN ? a_boxes * A_BOX : A_STAGE) +
                             (B_KMAJOR ? B_STAGE : b_boxes * B_BOX);
      const int k_tiles = (sh.K + BK - 1) / BK;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + s, (it / STAGES - 1) & 1);
        mbar_expect_tx(full + s, bytes);
        if constexpr (PAIR) {  // this block's half of A, into both blocks
          if constexpr (A_MN) {
            if (static_cast<int>(rank) < a_boxes)
              tma_load_3d_pair(sa + s * A_STAGE + rank * A_BOX, am, arow + 64 * rank, kt * BK,
                               slot, full + s);
          } else {
            tma_load_3d_pair(sa + s * A_STAGE + rank * A_BOX, am, kt * BK, arow + 64 * rank, slot,
                             full + s);
          }
        } else if constexpr (A_MN) {
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
    if constexpr (PAIR) {
      // Drain: both blocks' consumers have released every stage this ring
      // filled, so the peer neither writes into nor arrives at this block
      // after it exits.
      for (int j = 0; j < STAGES; ++j, ++it)
        if (it >= STAGES) mbar_wait(empty + it % STAGES, (it / STAGES - 1) & 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // PAIR: the peer's `empty` barriers, which this consumer also releases.
  const uint32_t peer_empty = PAIR ? cluster_addr(smem_u32(empty), rank ^ 1) : 0;
  auto release = [&](int s) {
    mbar_arrive(empty + s);
    if constexpr (PAIR) mbar_arrive_remote(peer_empty + 8 * s);
  };
  int it = 0;  // the ring's K steps so far, as its producer counts them
  for (int item = unit + ring * units; item < items; item += CONSUMERS * units) {
    const int tile = PAIR ? 2 * item + rank : item;
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
      if (kt > 0 && t == 0) release((it - 1) % STAGES);
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (t == 0) release((it - 1) % STAGES);
    if constexpr (COLSUM) {
      if (sums) epi.col_sum((csum[0] + csum[1]) + (csum[2] + csum[3]), p.g, p.col + t, op.shape);
    }
    uint32_t* stage = reinterpret_cast<uint32_t*>(stages_out + (threadIdx.x / 32) * STAGE_OUT);
    if constexpr (has_tile<Epilogue>::value) {
      epi.tile(acc0, acc1, p.g, abs_row, p.row, p.col, t, stage, op.shape);
    } else {
      epi(acc0, p.g, abs_row, p.row, p.col, t, stage, op.shape);
      epi(acc1, p.g, abs_row + 64, p.row + 64, p.col, t, stage, op.shape);
    }
  }
  // PAIR: the epilogues' TMA stores have completed before the block exits.
  if constexpr (PAIR) {
    if (t % 32 == 0) bulk_wait();
  }
}

// One problem (the forward's passes): A K-major and B MN-major unless the
// instance says otherwise.
template <bool A_MN = false, bool B_KMAJOR = false, bool COLSUM = false, bool PAIR = false,
          class Epilogue>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap& a_lo, const CUtensorMap& a_hi,
                                           const CUtensorMap& b, const Shape& shape,
                                           const Epilogue& epi) {
  const Operands ops[1] = {{&a_lo, &a_hi, &b, shape}};
  gemm_problems<A_MN, B_KMAJOR, COLSUM, PAIR>(ops, epi);
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

// A 3-D map (bf16 unless `type` says otherwise) with the 128-byte swizzle:
// extents dims (innermost first), the byte strides of dims 1 and 2, and the
// box (box[0] elements: 128 bytes). Out-of-bounds elements load as zeros.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[3],
                               const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3],
                               CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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
// B_KMAJOR instance with rows = N, BN = BM; the pair instance's A: box 64 x
// BK, a block's half) and an MN-major one ([slots, K, rows], box BK x 64:
// B, or A of an A_MN instance with rows = its rows).
static_assert(BM == BN, "one K-major box serves A and B");
inline cudaError_t make_kmajor_map(CUtensorMap* map, const void* ptr, int K, int rows,
                                   int slots, int box_rows = BM) {
  return make_map(map, ptr, K, rows, slots, BK, box_rows);
}
inline cudaError_t make_mnmajor_map(CUtensorMap* map, const void* ptr, int K, int rows,
                                    int slots) {
  return make_map(map, ptr, rows, K, slots, 64, BK);
}

// The pair instance's reduction map of an f32 total [slots, rows, N]: box
// [32 columns x PAIR_BOX_ROWS rows] (`pair_reduce_half`).
inline cudaError_t make_f32_map(CUtensorMap* map, const void* ptr, int N, int rows, int slots) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slots)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 4,
                                 static_cast<cuuint64_t>(N) * rows * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(PAIR_BOX_ROWS), 1};
  return make_map_3d(map, ptr, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The pair instance's store map of a bf16 output [slots, rows, N]: box [64
// columns x PAIR_BOX_ROWS rows] (a warp stage's box, `pair_flush`).
inline cudaError_t make_store_map(CUtensorMap* map, const void* ptr, int N, int rows, int slots) {
  return make_map(map, ptr, N, rows, slots, 64, PAIR_BOX_ROWS);
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

// --- the pair instance's launch ------------------------------------------------

// Blocks a cluster of the pair instance.
constexpr int PAIR_BLOCKS = 2;

// The pair instance takes K1's forward passes, the pre-only launch and the
// backward's dx and weight passes (its dh pass runs the single-block grid
// at every width) where every N of those passes, d or f, is a whole number
// of tile pairs: d and f multiples of 2 BN. Of those widths it takes the
// one it was measured at against the single-block grid, d = 1024 (the
// imagenet224-pod width; PERF.md): the flagship's d = 512, f = 2048 fits
// but keeps the single-block grid until port_ab.py shows the pair no
// slower there. The rule reads d and f alone: every launch of a pass at
// one width (plain, addend, combined grid, any G, M, split or slab) runs
// the same instance (kernels/grouped_mlp.py gemm_instance states it too).
inline bool pair_instance(int d, int f) {
  return d % (2 * BN) == 0 && f % (2 * BN) == 0 && d == 1024;
}

// The pair instance's launch config: `blocks` blocks in clusters of two
// along x.
inline cudaLaunchConfig_t pair_launch_config(int blocks, cudaStream_t stream,
                                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = PAIR_BLOCKS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of `kernel` (a pair-instance wrapper, its shared-memory
// cap lifted) the device holds at once.
template <class... Params>
cudaError_t pair_clusters_resident(void (*kernel)(Params...), int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_launch_config(PAIR_BLOCKS, 0, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// One persistent grid of the pair instance over `tiles` tiles (even): a
// cluster for each cluster the device holds at once (read once per device
// into `clusters`), or one a pair where there are fewer pairs.
template <class... Params, class... Args>
cudaError_t launch_pairs(void (*kernel)(Params...), bool* lifted, int* clusters, int tiles,
                         cudaStream_t stream, const Args&... args) {
  cudaError_t err = lift_smem_cap(kernel, lifted);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int resident = 0;
  if (dev < MAX_DEVICES && clusters[dev] > 0) {
    resident = clusters[dev];
  } else {
    if ((err = pair_clusters_resident(kernel, &resident)) != cudaSuccess) return err;
    if (dev < MAX_DEVICES) clusters[dev] = resident;
  }
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  if (tiles % PAIR_BLOCKS != 0) return cudaErrorInvalidValue;
  if (tiles <= 0) return cudaSuccess;
  const int pairs = tiles / PAIR_BLOCKS;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      pair_launch_config(PAIR_BLOCKS * (pairs < resident ? pairs : resident), stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

}  // namespace sm90
