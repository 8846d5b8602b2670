// Warp-wide helpers shared by the port's attention kernels.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;  // the reference's finite mask value
constexpr unsigned FULL = 0xffffffffu;

// Sum and max over each aligned group of W lanes (the whole warp by
// default; 16 for the half-warp that shares a row of the attention tiles).
template <int W = 32>
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int W = 32>
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

}  // namespace repro
