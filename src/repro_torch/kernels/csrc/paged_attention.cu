// Paged attention over an fp32 or an int8 KV page pool, written for Hopper
// (sm_90a).
//
// Replaces two Pallas TPU kernels of repro/kernels/paged_attention.py:
// _kernel (K1, fp32 pools) and _kernel_q8 (K3, int8 pools with per-page
// f32 scales), behind ops.paged_decode(_q8) (Sq = 1) and
// ops.paged_prefill(_q8) (Sq = C). It computes, for every slot b and query
// row i at position start[b] + i, causal (optionally sliding-window) GQA
// attention over the slot's logical key rows, which live in the pages named
// by block_tables[b, :] (-1 = none).
//
// Bound: the bytes of the live K/V pages it reads (decode) and the fp32
// FMAs of the score and value products (long prefill chunks). Scores,
// online softmax and the accumulator stay in fp32 registers with plain FMA,
// no tensor cores and no TF32, because fp32 is what the reference holds.
// The int8 variant moves a quarter of the page bytes: pages are staged in
// shared memory as int8 and dequantized on the way into registers, in the
// TPU kernel's order (int8 -> f32, times the page's scale, then the dot,
// then times 1/sqrt(hd); V the same before the p.V product).
//
// Design. The TPU grid (B, H, mps) runs its page axis in order on one core
// and carries (m, l, acc) in VMEM scratch between grid steps. Blocks on a
// GPU run in parallel and in no order, so one block owns one (slot b,
// kv head, tile of ROWS flattened query rows) and a loop inside the block
// walks the slot's pages. The block reads block_tables[b, j] itself and
// skips a page under the TPU kernel's predicate (paged_attention.py:99-101)
// applied to the block's own rows: unallocated, wholly beyond the causal
// frontier of the block's last row, or wholly behind the window of its
// first row; a skipped page's scale is never read. A visited page is staged
// in shared memory in tiles of at most 32 rows, K and V each, so that all G
// query heads of the kv group read one copy. In this first design each
// block stages every page it visits once; row tiles of the same kv group
// therefore re-read a page from L2, and a decode launch runs only B * KV
// blocks. Pipelining the page loads (cp.async or TMA) and wgmma for the
// prefill shape are later work.
//
// Inside a warp, lane d holds head-dim entries d, d + 32, ... of its query
// rows and accumulators. A score is a warp-wide dot product; lane j then
// keeps the score of key j of the tile, so the tile's max, exp and sum are
// warp reductions. The operation order follows the reference: dot, then
// scale; masked probabilities set to 0 explicitly; NEG_INF = -1e30; window
// predicate k_pos > q_pos - window; output acc / max(l, 1e-30), so a row
// with no valid key (a freed slot) is exactly 0.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
constexpr int TILE_BYTES = 32768;            // K + V tile in shared memory

// One staged pool element as f32: fp32 pools as they are, int8 pools
// converted and multiplied by the page's scale (the reference's order).
__device__ __forceinline__ float dequant(float x, float) { return x; }
__device__ __forceinline__ float dequant(int8_t x, float s) {
  return static_cast<float>(x) * s;
}

// HC = ceil(hd / 32): the head-dim entries each lane holds per query row.
// T: the pool element, float (K1) or int8_t (K3, k_scale / v_scale given).
template <int HC, typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ start,
                       float* __restrict__ out,
                       int Sq, int H, int KV, int hd, int P, int ps, int mps,
                       int kt, int window, float scale) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  // 16-byte (4 floats) or 4-byte (4 int8) units of a staged row
  using Vec = typename std::conditional<Q8, char4, float4>::type;
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);  // [kt][hd]
  T* vs = ks + kt * hd;                 // [kt][hd]

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int G = H / KV;
  const int n_q = G * Sq;  // flattened rows of this kv group: row = i * G + g
  const int row0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int st = start[b];
  const int pos_first = st + row0 / G;
  const int pos_last = st + (min(row0 + ROWS, n_q) - 1) / G;

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
    qpos[r] = st + i;
    const float* qp = q + ((size_t)(b * Sq + i) * H + h) * hd;
#pragma unroll
    for (int t = 0; t < HC; ++t) {
      const int d = lane + 32 * t;
      qr[r][t] = (live[r] && d < hd) ? qp[d] : 0.f;
      acc[r][t] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  const int* bt = block_tables + (size_t)b * mps;
  const int hd4 = hd >> 2;
  for (int j = 0; j < mps; ++j) {
    const int k_start = j * ps;
    if (k_start > pos_last) break;  // pages come in order: all later ones too
    const int page = bt[j];
    if (page < 0 || page >= P) continue;  // unallocated (or outside the pool)
    if (window > 0 && k_start + ps - 1 <= pos_first - window) continue;
    // the page's scales, read only for a page that is visited
    const float ksc = Q8 ? k_scale[page] : 1.f;
    const float vsc = Q8 ? v_scale[page] : 1.f;
    for (int o0 = 0; o0 < ps; o0 += kt) {
      const int n = min(kt, ps - o0);
      __syncthreads();  // the previous tile is no longer read
      for (int e = threadIdx.x; e < n * hd4; e += THREADS) {
        const int rr = e / hd4;
        const int c = e - rr * hd4;
        const size_t src = (((size_t)page * ps + o0 + rr) * KV + kh) * hd + 4 * c;
        reinterpret_cast<Vec*>(ks)[e] = *reinterpret_cast<const Vec*>(pool_k + src);
        reinterpret_cast<Vec*>(vs)[e] = *reinterpret_cast<const Vec*>(pool_v + src);
      }
      __syncthreads();
      const int kpos = k_start + o0 + lane;  // the key whose score lane holds
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        if (!live[r]) continue;  // warp-uniform
        float my_s = NEG_INF;
        for (int jj = 0; jj < n; ++jj) {
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < HC; ++t) {
            const int d = lane + 32 * t;
            if (d < hd) part = fmaf(qr[r][t], dequant(ks[jj * hd + d], ksc), part);
          }
          const float dot = warp_sum(part);
          if (lane == jj) my_s = dot * scale;
        }
        bool ok = lane < n && kpos <= qpos[r];
        if (window > 0) ok = ok && kpos > qpos[r] - window;
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
            if (d < hd) acc[r][t] = fmaf(pj, dequant(vs[jj * hd + d], vsc), acc[r][t]);
          }
        }
        m[r] = m_new;
      }
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

template <typename T>
int launch(const float* q, const T* pool_k, const T* pool_v,
           const float* k_scale, const float* v_scale, const int* block_tables,
           const int* start, float* out, int B, int Sq, int H, int KV, int hd,
           int P, int ps, int mps, int window, float scale, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || KV < 1 || KV > 65535 || H % KV != 0 ||
      hd < 4 || hd > 256 || hd % 4 != 0 || P < 1 || ps < 1 || mps < 1)
    return (int)cudaErrorInvalidValue;
  const int kt = min(32, min(ps, TILE_BYTES / (2 * hd * (int)sizeof(T))));
  const size_t smem = 2 * (size_t)kt * hd * sizeof(T);
  const dim3 grid((H / KV * Sq + ROWS - 1) / ROWS, KV, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(HC)                                                        \
  paged_attention_kernel<HC, T><<<grid, THREADS, smem, s>>>(              \
      q, pool_k, pool_v, k_scale, v_scale, block_tables, start, out, Sq,  \
      H, KV, hd, P, ps, mps, kt, window, scale)
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

}  // namespace

// q (B, Sq, H, hd), pools (P, ps, KV, hd), out (B, Sq, H, hd): fp32,
// contiguous, 16-byte aligned. block_tables (B, mps) and start (B,): int32.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int repro_paged_attention_f32(
    const float* q, const float* pool_k, const float* pool_v,
    const int* block_tables, const int* start, float* out, int B, int Sq,
    int H, int KV, int hd, int P, int ps, int mps, int window, float scale,
    void* stream) {
  return launch<float>(q, pool_k, pool_v, nullptr, nullptr, block_tables,
                       start, out, B, Sq, H, KV, hd, P, ps, mps, window, scale,
                       stream);
}

// The int8 pools of K3: pools (P, ps, KV, hd) int8, 4-byte aligned;
// k_scale / v_scale (P,) f32, the per-page symmetric scales; everything
// else as repro_paged_attention_f32.
extern "C" int repro_paged_attention_i8(
    const float* q, const int8_t* pool_k, const int8_t* pool_v,
    const float* k_scale, const float* v_scale, const int* block_tables,
    const int* start, float* out, int B, int Sq, int H, int KV, int hd,
    int P, int ps, int mps, int window, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch<int8_t>(q, pool_k, pool_v, k_scale, v_scale, block_tables,
                        start, out, B, Sq, H, KV, hd, P, ps, mps, window,
                        scale, stream);
}
