// Blockwise GQA flash attention over fp32 or bf16 operands, computed in
// fp32, written for Hopper (sm_90a).
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
// what the reference holds. So the design feeds the FMA units from
// registers and keeps shared memory off the critical path.
//
// Design. The TPU grid (B, H, Sq/bq, Sk/bk) runs its key axis in order on
// one core and carries (m, l, acc) in VMEM between grid steps; CUDA blocks
// run in no order. So one block of 8 warps owns (b, kv head, BR of the kv
// group's G * Sq query rows, flattened as row = i * G + g) and a loop
// inside the block walks the key rows in tiles of BC, each staged once for
// all G query heads of the group: BR = 128 and BC = 128 at head_dim 128
// (qwen), BR = BC = 64 at head_dim 64 (hymba) and 256, and at head_dim 128
// on a grid of fewer than two blocks per SM (the wrapper passes the card's
// SM count, kernels/_build.py's SMS). Row tiles are handed
// out last-first, so the causal diagonal's longest blocks start first and
// the short ones fill the tail.
//   - Both products are register-tiled. A warp owns RW rows (16, or 8);
//     lane (lr, lk) = (lane / 16, lane % 16) owns rows lr + 2 i, in
//     S = Q K^T the keys lk + 16 j and in O += P V the head-dim columns
//     lk * 4 + 64 c: 8 x 8 micro-tiles at head_dim 128, where per 4 d 16
//     float4 reads of shared memory feed 256 score FMAs and per key 4
//     float4 reads feed 64 value FMAs. The 16 lanes that share a row are a
//     half-warp, so the online softmax's row max and row sum are 4
//     shuffles each. P goes through shared memory 32 keys at a time, each
//     warp writing and reading only its own rows, so it needs no barrier.
//   - Shared memory holds Q (scaled, staged once), one K tile, one V tile
//     and the P chunk: 215 KB at head_dim 128, one block per SM (8 warps,
//     255 registers a thread), 60 KB and two blocks at head_dim 64. The
//     copies are cp.async (16 bytes): V(t) lands while the scores of tile t
//     are taken, K(t + 1) while its softmax and P V run.
//   - Keys past Sk, and past the causal frontier of the block's last row,
//     are not multiplied (half a tile of scores, the P V loop's bound); a
//     tile every row of the block sees whole takes the softmax without
//     masks. head_dim is padded to 64, 128 or 256 (zeros in shared memory);
//     the score loop stops at hd and threads whose columns lie past hd skip
//     the value product.
// Live key tiles form one range (the TPU kernel's skip predicate,
// flash_attention.py:75-82, applied to the block's own rows: wholly past
// the causal frontier of its last row, or wholly behind the window of its
// first row), so the loop walks that range only.
//
// bf16 (q, k, v and the output all bf16, as a bf16 serving path gives
// them): K and V are staged as bf16, half the bytes and half the shared
// memory, by 8-byte copies into rows of HDP + 4 elements (the 16 lanes
// reading 16 key rows hit distinct banks), and each element is upcast as
// the products read it; q is upcast and scaled in f32 as it is staged;
// the output is rounded once, at the store. That is the TPU kernel's
// `.astype(jnp.float32)` of each operand and `.astype(o_ref.dtype)` of its
// output.
//
// Numerics as the TPU kernel: q is scaled by 1/sqrt(hd) as it is staged,
// then dotted with each key. Masked probabilities are exactly 0, so a tile
// whose keys are all masked for a row adds nothing; NEG_INF is -1e30 and
// the output is acc / max(l, 1e-30), so a row with no visible key is
// exactly 0. The sums run in another order than the plain version's.

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "cp_async.cuh"
#include "warp.cuh"

namespace {

using repro::bf16;
using repro::cp_async16;
using repro::cp_async8;
using repro::cp_commit;
using repro::cp_wait;
using repro::NEG_INF;
using repro::warp_max;
using repro::warp_sum;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_MAX = 232448;
constexpr int PC = 32;  // keys of P staged at a time

// Lanes: 2 along rows (lr), 16 along keys and value columns (lk).
// WIDE: 16 rows a warp and 128-key tiles (head_dim 128 on a grid that
// fills the card); else 8 rows and 64 keys. T: the element of q, K, V and
// the output (float or bf16); Q and P are f32 in shared memory.
template <int HDP, bool WIDE, typename T>
struct Tiles {
  static_assert(!WIDE || HDP == 128, "wide tiles are for head_dim 128");
  static constexpr int RW = WIDE ? 16 : 8;        // query rows per warp
  static constexpr int BR = WARPS * RW;           // query rows per block
  static constexpr int MI = RW / 2;               // rows per thread
  static constexpr int BC = WIDE ? 128 : 64;      // keys per tile
  static constexpr int NJ = BC / 16;              // keys per thread
  static constexpr int NC = HDP / 64;             // float4 columns a thread
  static constexpr int QP = HDP + 4;              // row pitch of Q, K, V
  static constexpr int PP = BR + 4;               // row pitch of P
  // Q, K, V and PC keys of P at a time
  static constexpr size_t BYTES = (BR * QP + PC * PP) * sizeof(float) +
                                  2 * BC * QP * sizeof(T);
  static_assert(BYTES <= SMEM_MAX, "flash attention tiles exceed smem");
};

// 4 elements of a staged K or V row as f32 (16- or 8-byte aligned)
__device__ __forceinline__ float4 tile4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 tile4(const bf16* p) {
  return repro::bf16x4_to_float4(*reinterpret_cast<const uint2*>(p));
}

// s[i][j] += Q[rows lr + 2 i] . K[keys lk + 16 j] over d < hd, for the
// first NJA of the thread's NJ keys: per 4 d, MI + NJA 16- (8-) byte reads
// of shared memory feed 4 MI NJA FMAs.
template <int MI, int NJ, int NJA, int QP, typename T>
__device__ __forceinline__ void scores(float (&s)[MI][NJ], const float* qr,
                                       const T* kr, int hd) {
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      a[i] = *reinterpret_cast<const float4*>(qr + 2 * i * QP + d);
#pragma unroll
    for (int j = 0; j < NJA; ++j) {
      const float4 k = tile4(kr + 16 * j * QP + d);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        s[i][j] = fmaf(a[i].x, k.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, k.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, k.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, k.w, s[i][j]);
      }
    }
  }
}

// The online softmax step for the thread's rows over its keys key0 +
// 16 j (of which those below n_own are in the tile): the row max and sum
// over the half-warp, m, l and acc rescaled, s turned into P. MASK false:
// every key is visible to every row.
template <bool MASK, int MI, int NJ, int NA>
__device__ __forceinline__ void softmax(float (&s)[MI][NJ], float (&m)[MI],
                                        float (&l)[MI],
                                        float (&acc)[MI][NA],
                                        const int (&qpos)[MI], int key0,
                                        int n_own, int Sq, int causal,
                                        int window) {
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    bool ok[NJ];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      ok[j] = true;
      if (MASK) {
        const int key = key0 + 16 * j;
        ok[j] = qpos[i] < Sq && 16 * j < n_own;
        if (causal) ok[j] = ok[j] && qpos[i] >= key;
        if (window > 0) ok[j] = ok[j] && qpos[i] - key < window;
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
      }
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(m[i], warp_max<16>(mx));
    const float corr = expf(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      sum += s[i][j];
    }
    l[i] = l[i] * corr + warp_sum<16>(sum);
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] *= corr;
  }
}

template <int HDP, bool WIDE, typename T>
__global__ void __launch_bounds__(THREADS, WIDE || HDP > 128 ? 1 : 2)
flash_attention_kernel(const T* __restrict__ q,
                       const T* __restrict__ k,
                       const T* __restrict__ v,
                       T* __restrict__ out,
                       int Sq, int Sk, int H, int KV, int hd,
                       int causal, int window, float scale) {
  using Tl = Tiles<HDP, WIDE, T>;
  constexpr int RW = Tl::RW, BR = Tl::BR, MI = Tl::MI, BC = Tl::BC,
                NJ = Tl::NJ, NC = Tl::NC, QP = Tl::QP, PP = Tl::PP;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BR][QP]
  T* ks = reinterpret_cast<T*>(qs + BR * QP);   // [BC][QP]
  T* vs = ks + BC * QP;                         // [BC][QP]
  float* ps = reinterpret_cast<float*>(vs + BC * QP);  // [PC][PP]

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int G = H / KV;
  const int n_q = G * Sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BR;  // longest first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int lr = lane >> 4, lk = lane & 15;
  const int wrow = warp * RW;  // the warp's first row in the block
  const int pos_first = row0 / G;
  const int pos_last = (min(row0 + BR, n_q) - 1) / G;

  // the live key tiles [t_lo, t_hi]
  const int n_tiles = (Sk + BC - 1) / BC;
  int t_hi = n_tiles - 1;
  if (causal) t_hi = min(t_hi, pos_last / BC);
  int t_lo = 0;
  if (window > 0) {
    const int x = pos_first - window + 1;  // keys before x are out of window
    t_lo = Sk - 1 < x ? n_tiles : (x > 0 ? x / BC : 0);
  }

  // rows [t * BC, t * BC + BC) of K (or V) into dst, zeros past Sk and hd:
  // 4 elements a copy (16 bytes of f32, 8 of bf16)
  constexpr int hd4 = HDP / 4;
  auto issue = [&](const T* src, T* dst, int t) {
    const int k0 = t * BC;
    for (int e = tid; e < BC * hd4; e += THREADS) {
      const int r = e / hd4, c = (e - r * hd4) * 4;
      const bool in = k0 + r < Sk && c < hd;
      const size_t at = (((size_t)b * Sk + k0 + r) * KV + kh) * hd + c;
      if constexpr (sizeof(T) == 4)
        cp_async16(dst + r * QP + c, in ? src + at : src, in);
      else
        cp_async8(dst + r * QP + c, in ? src + at : src, in);
    }
    cp_commit();
  };
  if (t_lo <= t_hi) issue(k, ks, t_lo);

  // Q rows, scaled as the TPU kernel scales them, zeros past hd and n_q
  for (int e = tid; e < BR * hd4; e += THREADS) {
    const int r = e / hd4, c = (e - r * hd4) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_q && c < hd) {
      const int i = row / G, h = kh * G + row % G;
      val = repro::load4(q + ((size_t)(b * Sq + i) * H + h) * hd + c, true);
      val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + r * QP + c) = val;
  }

  // this thread's rows wrow + lr + 2 i, keys lk + 16 j, value columns
  // lk * 4 + 64 c; P keeps its MI rows together at wrow + lr * MI
  int qpos[MI];  // a row past n_q has qpos >= Sq
  float m[MI], l[MI], acc[MI][NC * 4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    qpos[i] = (row0 + wrow + lr + 2 * i) / G;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }
  bool on[NC];  // this thread's value columns lie inside hd
#pragma unroll
  for (int c = 0; c < NC; ++c) on[c] = lk * 4 + 64 * c < hd;
  const float* my_q = qs + (wrow + lr) * QP;
  float* my_p = ps + wrow + lr * MI;

  // Per tile: K(t) landed (it was fetched behind the previous tile's
  // softmax and P V); V(t) is fetched behind the scores, K(t + 1) behind
  // this tile's softmax and P V.
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BC;
    // keys past Sk, and past the block's last row when causal, are skipped
    int n_keys = min(BC, Sk - k0);
    if (causal) n_keys = min(n_keys, pos_last - k0 + 1);
    cp_wait<0>();     // this thread's copies of K(t) have landed
    __syncthreads();  // everyone's (Q too); every warp is done with V(t - 1)
    issue(v, vs, t);

    // S = Q K^T, an MI x NJ micro-tile per thread
    float s[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    if (n_keys > BC / 2)
      scores<MI, NJ, NJ, QP>(s, my_q, ks + lk * QP, hd);
    else
      scores<MI, NJ, NJ / 2, QP>(s, my_q, ks + lk * QP, hd);
    __syncthreads();  // every warp is done with K(t)
    if (t < t_hi)
      issue(k, ks, t + 1);
    else
      cp_commit();  // an empty group keeps the count

    // online softmax, one row per half-warp. A tile every row of the block
    // sees whole (inside the causal frontier and the window, no edge)
    // needs no mask.
    const bool whole = (!causal || k0 + BC - 1 <= pos_first) &&
                       (window == 0 || pos_last - k0 < window) &&
                       n_keys == BC && row0 + BR <= n_q;
    if (whole)
      softmax<false>(s, m, l, acc, qpos, k0 + lk, n_keys - lk, Sq, causal,
                     window);
    else
      softmax<true>(s, m, l, acc, qpos, k0 + lk, n_keys - lk, Sq, causal,
                    window);
    cp_wait<1>();     // this thread's copies of V(t) have landed
    __syncthreads();  // and everyone's

    // O += P V, an MI x (4 NC) micro-tile, PC keys at a time: each warp
    // writes and reads only its own rows of P
#pragma unroll
    for (int c0 = 0; c0 < BC; c0 += PC) {
      if (c0 >= n_keys) break;
#pragma unroll
      for (int j = c0 / 16; j < (c0 + PC) / 16; ++j)
#pragma unroll
        for (int i = 0; i < MI; i += 4)
          *reinterpret_cast<float4*>(my_p + (lk + 16 * j - c0) * PP + i) =
              make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
      __syncwarp();
      const int c1 = min(PC, n_keys - c0);
#pragma unroll 4
      for (int c = 0; c < c1; ++c) {
        float pr[MI];
#pragma unroll
        for (int i = 0; i < MI; i += 4) {
          const float4 p =
              *reinterpret_cast<const float4*>(my_p + c * PP + i);
          pr[i] = p.x; pr[i + 1] = p.y; pr[i + 2] = p.z; pr[i + 3] = p.w;
        }
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          if (!on[cc]) continue;
          const float4 w = tile4(vs + (c0 + c) * QP + lk * 4 + 64 * cc);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            acc[i][cc * 4 + 0] = fmaf(pr[i], w.x, acc[i][cc * 4 + 0]);
            acc[i][cc * 4 + 1] = fmaf(pr[i], w.y, acc[i][cc * 4 + 1]);
            acc[i][cc * 4 + 2] = fmaf(pr[i], w.z, acc[i][cc * 4 + 2]);
            acc[i][cc * 4 + 3] = fmaf(pr[i], w.w, acc[i][cc * 4 + 3]);
          }
        }
      }
      __syncwarp();  // this chunk of P is read
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    if (qpos[i] >= Sq) continue;
    const int row = row0 + wrow + lr + 2 * i;
    const int h = kh * G + row % G;
    T* op = out + ((size_t)(b * Sq + qpos[i]) * H + h) * hd;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      if (!on[cc]) continue;
      repro::store4(op + lk * 4 + 64 * cc,
                    make_float4(acc[i][cc * 4 + 0] / denom,
                                acc[i][cc * 4 + 1] / denom,
                                acc[i][cc * 4 + 2] / denom,
                                acc[i][cc * 4 + 3] / denom),
                    4, true);
    }
  }
}

template <typename T, int HDP, bool WIDE = false>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int B,
                   int Sq, int Sk, int H, int KV, int hd, int causal,
                   int window, float scale, cudaStream_t s) {
  using Tl = Tiles<HDP, WIDE, T>;
  static const cudaError_t ready = cudaFuncSetAttribute(
      flash_attention_kernel<HDP, WIDE, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::BYTES);
  if (ready != cudaSuccess) return ready;
  const dim3 grid((H / KV * Sq + Tl::BR - 1) / Tl::BR, KV, B);
  flash_attention_kernel<HDP, WIDE, T><<<grid, THREADS, Tl::BYTES, s>>>(
      q, k, v, out, Sq, Sk, H, KV, hd, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int run(const T* q, const T* k, const T* v, T* out, int B, int Sq, int Sk,
        int H, int KV, int hd, int causal, int window, int sms, float scale,
        void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || KV < 1 || KV > 65535 ||
      H % KV != 0 || hd < 4 || hd > 256 || hd % 4 != 0 || window < 0 ||
      sms < 1 || (long long)(H / KV) * Sq > 0x7fffffffLL - 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0;
  if (hd <= 64)
    return (int)launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, hd, c, window,
                              scale, s);
  if (hd <= 128) {
    // wide tiles where their grid gives every SM two blocks or more
    const long long wide = (H / KV * (long long)Sq + 127) / 128 * KV * B;
    if (wide >= 2LL * sms)
      return (int)launch<T, 128, true>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                       c, window, scale, s);
    return (int)launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, hd, c,
                               window, scale, s);
  }
  return (int)launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KV, hd, c, window,
                             scale, s);
}

}  // namespace

// q (B, Sq, H, hd), k / v (B, Sk, KV, hd), out (B, Sq, H, hd): all fp32
// (_f32) or all bf16 (_bf16), contiguous, 16-byte aligned. causal is 0 or
// 1; window 0 means none. sms is the card's SM count, which decides the
// tiles at head_dim 128. Launches on `stream` and returns
// cudaGetLastError() (0 = launched) or cudaErrorInvalidValue for shapes
// the kernel cannot take.
extern "C" int repro_flash_attention_f32(
    const float* q, const float* k, const float* v, float* out, int B,
    int Sq, int Sk, int H, int KV, int hd, int causal, int window,
    int sms, float scale, void* stream) {
  return run<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window, sms,
                    scale, stream);
}

extern "C" int repro_flash_attention_bf16(
    const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Sq,
    int Sk, int H, int KV, int hd, int causal, int window, int sms,
    float scale, void* stream) {
  return run<bf16>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window, sms,
                   scale, stream);
}
