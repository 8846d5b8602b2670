// cp.async helpers shared by the port's kernels: 16-, 8- and 4-byte copies
// from device memory into shared memory that run while the block computes,
// committed in groups and waited for by count.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16, 8 or 4 bytes; `in` false fills the destination with zeros
// (nothing is read, but `src` must still be a valid address).
// With PREFETCH the 16-byte copy asks L2 for the whole 128-byte line, so
// a row read 64 bytes per ring stage comes from device memory in 128-byte
// stretches (the next stage's 64 bytes then hit in L2).
template <bool PREFETCH = false>
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  if constexpr (PREFETCH)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(in ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro
