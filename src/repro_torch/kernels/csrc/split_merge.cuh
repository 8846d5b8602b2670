// The merge of an attention split over keys, shared by the paged attention
// kernels (paged_attention.cu: K1 / K3; paged_attention_latent.cu: K4).
//
// A call that does not fill the card divides each query row's keys among
// `splits` blocks. Each split leaves its unnormalised output O_s and its
// online-softmax state (m_s, l_s) per row in scratch the wrapper allocates:
// part_o (B, splits, n_q, d_v) and part_ml (B, splits, n_q, 2), f32, rows
// in the output's order. This kernel, launched after the split's on the
// same stream, combines them by log-sum-exp into out (B, n_q, d_v), f32 or
// bf16 (rounded once, at the store).
#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "warp.cuh"

namespace repro {
namespace {

constexpr int MERGE_THREADS = 512;  // a thread per value column at d_v 512
constexpr int MAX_SPLITS = 1024;

// out[b, row] = sum_s w_s O_s / max(sum_s w_s l_s, 1e-30) with
// w_s = exp(m_s - max m) over the splits s that saw a key (l_s > 0); a
// split that saw none has w_s = 0 and its O_s is never read, so a row no
// split saw is exactly 0. One block per (row, b); a thread per column.
// OutT: float or bf16.
template <typename OutT>
__global__ void __launch_bounds__(MERGE_THREADS)
split_merge_kernel(const float* __restrict__ part_o,
                   const float* __restrict__ part_ml,
                   OutT* __restrict__ out, int n_q, int d_v, int splits) {
  __shared__ float m_s[MAX_SPLITS], l_s[MAX_SPLITS], w_s[MAX_SPLITS];
  const int row = blockIdx.x, b = blockIdx.y;
  const int threads = blockDim.x;
  const size_t base = (size_t)b * splits * n_q + row;  // split 0's row
  for (int s = threadIdx.x; s < splits; s += threads) {
    const float* ml = part_ml + (base + (size_t)s * n_q) * 2;
    m_s[s] = ml[0];
    l_s[s] = ml[1];
  }
  __syncthreads();
  float m_max = NEG_INF;
  for (int s = 0; s < splits; ++s)
    if (l_s[s] > 0.f) m_max = fmaxf(m_max, m_s[s]);
  for (int s = threadIdx.x; s < splits; s += threads)
    w_s[s] = l_s[s] > 0.f ? expf(m_s[s] - m_max) : 0.f;
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < splits; ++s)
    if (w_s[s] > 0.f) l = fmaf(w_s[s], l_s[s], l);
  const float denom = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < d_v; d += threads) {
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s)
      if (w_s[s] > 0.f)
        acc = fmaf(w_s[s], part_o[(base + (size_t)s * n_q) * d_v + d], acc);
    const float o = acc / denom;
    if constexpr (sizeof(OutT) == 4)
      out[((size_t)b * n_q + row) * d_v + d] = o;
    else
      out[((size_t)b * n_q + row) * d_v + d] = __float2bfloat16_rn(o);
  }
}

// Launches the merge of B x n_q rows of d_v columns on `s`: a block per
// row, as many threads as d_v needs (a multiple of 32, at most 512; every
// output is one thread's sum in split order, so the count does not change
// a bit of it).
template <typename OutT>
inline cudaError_t launch_split_merge(const float* part_o,
                                      const float* part_ml, OutT* out,
                                      int B, int n_q, int d_v, int splits,
                                      cudaStream_t s) {
  const int threads = d_v >= MERGE_THREADS ? MERGE_THREADS
                                           : (d_v + 31) / 32 * 32;
  split_merge_kernel<OutT><<<dim3(n_q, B), threads, 0, s>>>(
      part_o, part_ml, out, n_q, d_v, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro
