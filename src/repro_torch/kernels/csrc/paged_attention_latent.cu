// Paged attention over MLA latent pages, written for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention.py::_kernel_latent (K4), the
// Pallas TPU kernel behind ops.paged_decode_latent (Sq = 1) and
// ops.paged_prefill_latent (Sq = C). Each token's cache entry is ONE latent
// row of L = c + r floats shared by every query head; the absorbed queries
// q (B, Sq, H, L) dot the whole row, the scores are scaled by
// 1/sqrt(scale_dim) (the logical head width, not L), and the values are the
// leading d_v (= c) columns of the same rows. Causal mask only; the output
// (B, Sq, H, d_v) stays in latent space.
//
// Bound: at decode the bytes of each slot's live latent rows, which every
// head shares; at prefill the fp32 FMAs, (L + d_v) per visible (row, head,
// key). fp32 FMA throughout, no tensor cores and no TF32.
//
// Design. It is not an instantiation of the per-head kernel: a latent row
// is up to 1024 floats wide (576 at full width) where K1 stops at 256, and
// there is a single shared "kv head", so G = H. One block owns one (slot b,
// tile of ROWS of the H * Sq flattened query rows, row = i * H + h) and
// walks the slot's pages in a loop, skipping under the TPU predicate
// (unallocated, or wholly beyond the causal frontier of the block's last
// row). A page is staged in shared memory in tiles of at most 32 rows, once
// for all the block's query rows, and serves both the scores (all L
// columns) and the values (the first d_v columns of the same staged rows),
// so a page is read from memory once per block. Lane d of a warp holds
// columns d, d + 32, ... of its query rows and accumulators; a score is a
// warp-wide dot product and lane j keeps key j's score, as in K1. Widths
// that are not a multiple of 4 are staged with scalar loads.
//
// Known limit of this first design: a decode launch runs only
// B * ceil(H / ROWS) blocks (24 at 8 slots and 40 heads) on 132 SMs.
//
// Numerics as the reference: dot, then scale; masked probabilities set to
// 0; NEG_INF = -1e30; output acc / max(l, 1e-30), so a freed slot (all -1
// block table) is exactly 0.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp.cuh"

namespace {

using repro::FULL;
using repro::NEG_INF;
using repro::warp_max;
using repro::warp_sum;

constexpr int ROWS = 16;               // flattened query rows per block
constexpr int TILE_BYTES = 48 * 1024;  // staged latent rows per tile
constexpr int MAX_WIDTH = 1024;

// NC = the columns each lane holds per query row (a bucket >= ceil(L / 32));
// RPW query rows per warp, ROWS / RPW warps.
template <int NC, int RPW>
__global__ void __launch_bounds__(ROWS / RPW * 32)
latent_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ pool,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ start,
                        float* __restrict__ out,
                        int Sq, int H, int Lw, int d_v, int P, int ps, int mps,
                        int kt, int vec, float scale) {
  constexpr int WARPS = ROWS / RPW;
  constexpr int THREADS = WARPS * 32;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kt][Lw]

  const int b = blockIdx.y;
  const int n_q = H * Sq;
  const int row0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int st = start[b];
  const int pos_last = st + (min(row0 + ROWS, n_q) - 1) / H;

  float qr[RPW][NC];
  float acc[RPW][NC];
  float m[RPW];
  float l[RPW];
  int qpos[RPW];
  bool live[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + warp + WARPS * r;
    live[r] = row < n_q;
    const int i = live[r] ? row / H : 0;
    const int h = live[r] ? row % H : 0;
    qpos[r] = st + i;
    const float* qp = q + ((size_t)(b * Sq + i) * H + h) * Lw;
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const int d = lane + 32 * t;
      qr[r][t] = (live[r] && d < Lw) ? qp[d] : 0.f;
      acc[r][t] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  const int* bt = block_tables + (size_t)b * mps;
  for (int j = 0; j < mps; ++j) {
    const int k_start = j * ps;
    if (k_start > pos_last) break;  // pages come in order: all later ones too
    const int page = bt[j];
    if (page < 0 || page >= P) continue;  // unallocated (or outside the pool)
    for (int o0 = 0; o0 < ps; o0 += kt) {
      const int n = min(kt, ps - o0);
      const float* src = pool + ((size_t)page * ps + o0) * Lw;
      __syncthreads();  // the previous tile is no longer read
      if (vec) {        // rows of a multiple of 4 floats, 16-byte aligned
        const float4* s4 = reinterpret_cast<const float4*>(src);
        for (int e = threadIdx.x; e < n * (Lw >> 2); e += THREADS)
          smem4[e] = s4[e];
      } else {
        for (int e = threadIdx.x; e < n * Lw; e += THREADS) ks[e] = src[e];
      }
      __syncthreads();
      const int kpos = k_start + o0 + lane;  // the key whose score lane holds
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (!live[r]) continue;  // warp-uniform
        float my_s = NEG_INF;
        for (int jj = 0; jj < n; ++jj) {
          const float* kr = ks + jj * Lw;
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < NC; ++t) {
            const int d = lane + 32 * t;
            if (d < Lw) part = fmaf(qr[r][t], kr[d], part);
          }
          const float dot = warp_sum(part);
          if (lane == jj) my_s = dot * scale;
        }
        const bool ok = lane < n && kpos <= qpos[r];
        const float s = ok ? my_s : NEG_INF;
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
        for (int t = 0; t < NC; ++t) acc[r][t] *= corr;
        for (int jj = 0; jj < n; ++jj) {
          const float pj = __shfl_sync(FULL, p, jj);
          const float* vr = ks + jj * Lw;  // values: the first d_v columns
#pragma unroll
          for (int t = 0; t < NC; ++t) {
            const int d = lane + 32 * t;
            if (d < d_v) acc[r][t] = fmaf(pj, vr[d], acc[r][t]);
          }
        }
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (!live[r]) continue;
    const int row = row0 + warp + WARPS * r;
    const int i = row / H;
    const int h = row % H;
    float* op = out + ((size_t)(b * Sq + i) * H + h) * d_v;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const int d = lane + 32 * t;
      if (d < d_v) op[d] = acc[r][t] / denom;
    }
  }
}

}  // namespace

// q (B, Sq, H, Lw), pool (P, ps, 1, Lw), out (B, Sq, H, d_v): fp32,
// contiguous. block_tables (B, mps) and start (B,): int32. Lw <= 1024 and
// 1 <= d_v <= Lw. Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int repro_paged_attention_latent_f32(
    const float* q, const float* pool, const int* block_tables,
    const int* start, float* out, int B, int Sq, int H, int Lw, int d_v,
    int P, int ps, int mps, float scale, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || H < 1 || Lw < 1 || Lw > MAX_WIDTH ||
      d_v < 1 || d_v > Lw || P < 1 || ps < 1 || mps < 1)
    return (int)cudaErrorInvalidValue;
  const int kt = min(32, min(ps, TILE_BYTES / (Lw * (int)sizeof(float))));
  const size_t smem = (size_t)kt * Lw * sizeof(float);
  const int vec = Lw % 4 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  const dim3 grid((H * Sq + ROWS - 1) / ROWS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (Lw + 31) / 32;
#define LAUNCH(NC, RPW)                                                    \
  latent_attention_kernel<NC, RPW><<<grid, ROWS / RPW * 32, smem, s>>>(   \
      q, pool, block_tables, start, out, Sq, H, Lw, d_v, P, ps, mps, kt,   \
      vec, scale)
  if (nc <= 1) LAUNCH(1, 4);
  else if (nc <= 2) LAUNCH(2, 4);
  else if (nc <= 4) LAUNCH(4, 4);
  else if (nc <= 8) LAUNCH(8, 4);
  else if (nc <= 12) LAUNCH(12, 4);
  else if (nc <= 18) LAUNCH(18, 4);  // 576-wide rows at full width
  else if (nc <= 24) LAUNCH(24, 2);
  else LAUNCH(32, 2);
#undef LAUNCH
  return (int)cudaGetLastError();
}
