// The wgmma shapes the port's Hopper attention needs, beside the GEMM
// mainloop's (sm90_gemm.cuh, whose barriers, TMA loads, descriptors and
// host helpers they share):
//
//   * S = Q . K^T: m64n64k16 with both operands in shared memory, B
//     K-major (K [keys, d] row-major, wgmma's non-transposed B);
//   * O += P . V: m64n64k16 with A in registers (P, the rounded softmax
//     probabilities, straight from the S accumulator: the RS form) and B
//     MN-major (V [keys, d] row-major, the transposed B sm90_gemm.cuh reads).
//
// The m64n64 accumulator fragment is the m64n128 one's first half
// (sm90_gemm.cuh, for_each_pair): thread t holds, for j = 0..7, columns
// 8j + 2(t%4) + {0, 1} of rows 16(t/32) + (t%32)/4 and that + 8, in
// d[4j .. 4j+3]. Its bf16 pairs are also wgmma's register A fragment: for
// K step k (columns 16k .. 16k+15) the four registers are the packed pairs
// of d[8k .. 8k+7] in order.

#pragma once

#include "sm90_gemm.cuh"

namespace sm90 {

constexpr int ACC64 = 32;  // f32 sums a thread holds for m64n64

#define SM90_ACC64_OUTS                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_ACC64_REGS                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A and B K-major in shared memory
// (imm-trans-b = 0), bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[ACC64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC64_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC64_OUTS
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers (four packed
// bf16 pairs a thread), B MN-major in shared memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[ACC64], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC64_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_ACC64_OUTS
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef SM90_ACC64_OUTS
#undef SM90_ACC64_REGS

// Wait at named barrier `id` (1..15; 0 is __syncthreads') until `count`
// threads, a multiple of 32, have arrived; or arrive without waiting.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace sm90
