// Shared device helpers for the hand-written kernels: the bf16 type and a
// warp reduction. The Hopper helpers (mbarriers, TMA, wgmma) are in
// hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace istpu {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace istpu
