// Blockwise GQA flash attention in fp32, written for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::_kernel, the Pallas TPU kernel
// behind ops.flash_attention (the full-sequence forward) and
// ops.flash_prefill (a serving prefill's first chunk, whose K/V export is
// a passthrough of the inputs and needs no kernel). For every batch row b,
// query head h and query row i it computes attention over the key rows of
// kv head h / (H / KV), with positions taken from the row indices (query i
// at position i, key j at position j): key j is visible when
// `!causal || i >= j` and `window == 0 || i - j < window`.
//
// Bound: the fp32 FMAs of the score and value products for a full-sequence
// forward (O(S^2)), the bytes of q, K, V and the output for a short serving
// chunk. Scores, the online softmax and the accumulator stay in fp32
// registers with plain FMA: no tensor cores and no TF32, because fp32 is
// what the reference holds.
//
// Design. The TPU grid (B, H, Sq/bq, Sk/bk) runs its key axis in order on
// one core and carries (m, l, acc) in VMEM between grid steps; CUDA blocks
// run in no order. So one block owns (b, kv head, ROWS of the kv group's
// G * Sq query rows, flattened as row = i * G + g) and a loop inside the
// block walks the key rows in tiles of at most 32 (16 at head_dim 256),
// staged in shared memory once for all G query heads of the group. A tile
// is skipped under the TPU kernel's predicate (flash_attention.py:77-81)
// applied to the block's own rows: wholly past the causal frontier of the
// block's last row, or wholly behind the window of its first row.
//
// Inside a warp, lane d holds head-dim entries d, d + 32, ... of its query
// rows and accumulators. The operation order follows the TPU kernel: q is
// scaled by 1/sqrt(hd) as it is loaded, then dotted with each key (a
// warp-wide sum; lane j keeps key j's score). Masked probabilities are set
// to exactly 0, so a tile whose keys are all masked for a row (the first
// tile a windowed row visits, say) adds nothing; NEG_INF is -1e30 and the
// output is acc / max(l, 1e-30), so a row with no visible key is exactly 0.
// Pipelined loads (cp.async or TMA) and register-tiled or wgmma products
// are later work.

#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

using repro::FULL;
using repro::NEG_INF;
using repro::warp_max;
using repro::warp_sum;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block
constexpr int TILE_FLOATS = 8192;            // K + V tile: 32 KB of shared memory

// HC = ceil(hd / 32): the head-dim entries each lane holds per query row.
template <int HC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       float* __restrict__ out,
                       int Sq, int Sk, int H, int KV, int hd, int kt,
                       int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kt][hd]
  float* vs = ks + kt * hd;                     // [kt][hd]

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int G = H / KV;
  const int n_q = G * Sq;
  const int row0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos_first = row0 / G;
  const int pos_last = (min(row0 + ROWS, n_q) - 1) / G;

  float qr[ROWS_PER_WARP][HC];
  float acc[ROWS_PER_WARP][HC];
  float m[ROWS_PER_WARP];
  float l[ROWS_PER_WARP];
  int qpos[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row0 + warp + WARPS * r;
    live[r] = row < n_q;
    const int i = live[r] ? row / G : 0;
    const int h = kh * G + (live[r] ? row % G : 0);
    qpos[r] = i;
    const float* qp = q + ((size_t)(b * Sq + i) * H + h) * hd;
#pragma unroll
    for (int t = 0; t < HC; ++t) {
      const int d = lane + 32 * t;
      qr[r][t] = (live[r] && d < hd) ? qp[d] * scale : 0.f;
      acc[r][t] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  const int hd4 = hd >> 2;
  for (int k0 = 0; k0 < Sk; k0 += kt) {
    if (causal && k0 > pos_last) break;  // tiles come in order: later ones too
    const int n = min(kt, Sk - k0);
    if (window > 0 && k0 + n - 1 <= pos_first - window) continue;
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < n * hd4; e += THREADS) {
      const int rr = e / hd4;
      const int c = e - rr * hd4;
      const size_t src = (((size_t)b * Sk + k0 + rr) * KV + kh) * hd + 4 * c;
      smem4[e] = *reinterpret_cast<const float4*>(k + src);
      reinterpret_cast<float4*>(vs)[e] = *reinterpret_cast<const float4*>(v + src);
    }
    __syncthreads();
    const int kpos = k0 + lane;  // the key whose score lane holds
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      if (!live[r]) continue;  // warp-uniform
      float my_s = NEG_INF;
      for (int jj = 0; jj < n; ++jj) {
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < HC; ++t) {
          const int d = lane + 32 * t;
          if (d < hd) part = fmaf(qr[r][t], ks[jj * hd + d], part);
        }
        const float dot = warp_sum(part);
        if (lane == jj) my_s = dot;
      }
      bool ok = lane < n;
      if (causal) ok = ok && qpos[r] >= kpos;
      if (window > 0) ok = ok && qpos[r] - kpos < window;
      const float s = ok ? my_s : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int t = 0; t < HC; ++t) acc[r][t] *= corr;
      for (int jj = 0; jj < n; ++jj) {
        const float pj = __shfl_sync(FULL, p, jj);
#pragma unroll
        for (int t = 0; t < HC; ++t) {
          const int d = lane + 32 * t;
          if (d < hd) acc[r][t] = fmaf(pj, vs[jj * hd + d], acc[r][t]);
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    if (!live[r]) continue;
    const int row = row0 + warp + WARPS * r;
    const int i = row / G;
    const int h = kh * G + row % G;
    float* op = out + ((size_t)(b * Sq + i) * H + h) * hd;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < HC; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) op[d] = acc[r][t] / denom;
    }
  }
}

}  // namespace

// q (B, Sq, H, hd), k / v (B, Sk, KV, hd), out (B, Sq, H, hd): fp32,
// contiguous, 16-byte aligned. causal is 0 or 1; window 0 means none.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int repro_flash_attention_f32(
    const float* q, const float* k, const float* v, float* out, int B,
    int Sq, int Sk, int H, int KV, int hd, int causal, int window,
    float scale, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || KV < 1 || KV > 65535 ||
      H % KV != 0 || hd < 4 || hd > 256 || hd % 4 != 0 || window < 0 ||
      (long long)(H / KV) * Sq > 0x7fffffffLL - ROWS)
    return (int)cudaErrorInvalidValue;
  const int kt = min(32, TILE_FLOATS / (2 * hd));
  const size_t smem = 2 * (size_t)kt * hd * sizeof(float);
  const dim3 grid((H / KV * Sq + ROWS - 1) / ROWS, KV, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(HC)                                                        \
  flash_attention_kernel<HC><<<grid, THREADS, smem, s>>>(                 \
      q, k, v, out, Sq, Sk, H, KV, hd, kt, causal != 0, window, scale)
  switch ((hd + 31) / 32) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    case 5: LAUNCH(5); break;
    case 6: LAUNCH(6); break;
    case 7: LAUNCH(7); break;
    default: LAUNCH(8); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
