// Warp-wide helpers shared by the port's attention kernels.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;  // the reference's finite mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

}  // namespace repro
