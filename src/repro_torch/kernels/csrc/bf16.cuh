// bf16 loads and stores shared by the attention kernels. A bf16 operand is
// upcast to f32 exactly, everything is computed in f32, and an output is
// rounded to bf16 once, to nearest even, where the reference rounds it
// (`.astype(o_ref.dtype)` in the Pallas kernels, `.to(q.dtype)` in
// kernels/ref.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// 4 consecutive bf16 (8 bytes, element 0 in the low half of .x) as f32
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint2 float4_to_bf16x4(float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  return u;
}

// 4 elements of T at src as f32: one 16- or 8-byte load where `vec` (src
// aligned to it), else one element at a time
template <typename T>
__device__ __forceinline__ float4 load4(const T* src, bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) return *reinterpret_cast<const float4*>(src);
  } else {
    if (vec) return bf16x4_to_float4(*reinterpret_cast<const uint2*>(src));
  }
  return make_float4(to_f32(src[0]), to_f32(src[1]), to_f32(src[2]),
                     to_f32(src[3]));
}

// the first n (at most 4) of v's elements to dst as T: one 16- or 8-byte
// store where `vec` and n == 4 (dst aligned to it), else one at a time
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v, int n, bool vec) {
  if (vec && n >= 4) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(dst) = v;
    else
      *reinterpret_cast<uint2*>(dst) = float4_to_bf16x4(v);
    return;
  }
  const float a[4] = {v.x, v.y, v.z, v.w};
  for (int e = 0; e < 4 && e < n; ++e) {
    if constexpr (sizeof(T) == 4)
      dst[e] = a[e];
    else
      dst[e] = __float2bfloat16_rn(a[e]);
  }
}

}  // namespace repro
