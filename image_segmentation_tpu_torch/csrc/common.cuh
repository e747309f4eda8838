// Shared device helpers for the hand-written kernels: the bf16 type and a
// warp reduction. The Hopper helpers (mbarriers, TMA, wgmma) are in
// hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace istpu {

using bf16 = __nv_bfloat16;

// The sum of v over the aligned group of L lanes that holds this lane (the
// whole warp at L 32), by xor shuffles from L / 2 down; every lane of the
// warp calls it together.
template <int L = 32>
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace istpu
