// Shared device helpers for the hand-written kernels: the bf16 type, a
// warp reduction, and the warp-level tensor-core product of K1
// (double_conv.cu), mma.sync.m16n8k16 (bf16 inputs, f32 accumulators;
// K3 and K4 use wgmma, hopper.cuh). Fragment layout
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with g = lane / 4 and
// t = lane % 4:
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col"):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16x8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Both operands are therefore kept in shared memory with the reduction
// dimension contiguous, so every fragment register is one 32-bit load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace istpu {

using bf16 = __nv_bfloat16;

// Rows in shared memory are padded by 8 bf16 (16 bytes): a row stride of
// 4 (mod 32) banks puts the 8 rows of one fragment load on distinct banks.
constexpr int kPad = 8;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16x8x16(float c[4], const uint32_t a[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0+16) and columns [k0, k0+16) of a row-major
// bf16 tile with row stride `ld` (elements).
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const bf16* base, int ld,
                                            int r0, int k0, int g, int t) {
  a[0] = ld32(base + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(base + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(base + (r0 + g) * ld + k0 + 8 + 2 * t);
  a[3] = ld32(base + (r0 + g + 8) * ld + k0 + 8 + 2 * t);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace istpu
