// Paged attention over an fp32, a bf16 or an int8 KV page pool, written for
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of repro/kernels/paged_attention.py:
// _kernel (K1, fp32 or bf16 pools) and _kernel_q8 (K3, int8 pools with
// per-page f32 scales), behind ops.paged_decode(_q8) (Sq = 1) and
// ops.paged_prefill(_q8) (Sq = C). It computes, for every slot b and query
// row i at position start[b] + i, causal (optionally sliding-window) GQA
// attention over the slot's logical key rows, which live in the pages named
// by block_tables[b, :] (-1 = none).
//
// Bound. A decode tick (qwen2.5-32b: 8 slots, 40 heads over 8 kv heads,
// hd 128, 100-732 live rows a slot) reads each slot's live K/V rows once
// and does 10 FMAs per byte of fp32 pages: it is bound by bytes (7.4 us at
// 3.35 TB/s), but its 64 (slot, kv head) pairs cannot keep 132 SMs reading.
// A prefill chunk (64 rows a slot) does 640 FMAs per byte: it is bound by
// the fp32 FMAs of the score and value products (53 us at 67 TFLOP/s), and
// its slots' lengths differ up to 7x, so the longest slot's blocks can set
// the tail. fp32 FMA throughout, no tensor cores and no TF32, because fp32
// is what the reference holds.
//
// Design. One block of 8 warps owns (slot b, kv head, a tile of BR of the
// kv group's G * Sq query rows flattened as row = i * G + g, a range of the
// slot's key tiles), so a staged K/V row serves all G query heads of its
// group. BR is 64 (8 rows a warp) or 16 (2 rows a warp: decode, where G is
// 5); warps whose rows are all past the group's skip the products.
//   - Key tiles of BC = 64 (with BR 64) or 32 logical key rows are gathered
//     row by row through the block table (any page size works) into a 2- or
//     3-stage cp.async ring, 16-byte copies where the rows and pointers
//     allow, else 4-byte ones; the next tiles are in flight while one is
//     multiplied. Per staged row the ring also keeps whether it was read
//     and, for int8 pools, the page's two scales (cp.async too). Where some
//     warps have no rows (decode), those warps alone stage the tiles, so
//     the copies run beside the products instead of before them. Q comes
//     with the first tile, by cp.async too.
//   - Both products are register-tiled as in flash_attention.cu: lane
//     (lr, lk) = (lane / 16, lane % 16) owns rows lr + 2 i of its warp, in
//     S = Q K^T the keys lk + 16 j (a 4 x 4 micro-tile at BR 64 and BC 64)
//     and in O += P V the head-dim columns lk * 4 + 64 c. The 16 lanes that
//     share a row are a half-warp, so the online softmax's row max and sum
//     are 4 shuffles each; P goes through shared memory 32 keys at a time,
//     each warp writing and reading only its own rows (no block barrier).
//   - Int8 pools (K3) are staged as int8, a quarter of the bytes, and each
//     staged element is dequantized once, float(x) * its page's scale, into
//     an f32 K/V tile that the same product code reads. That is the
//     reference's one rounding, so the values equal dequantizing at every
//     use bit for bit. The pass costs a barrier a tile; 32-key tiles leave
//     room for a second block on the SM to run beside it. Bf16 pools take
//     the same path, half the bytes of fp32 staged and upcast exactly
//     (the TPU kernel's `.astype(jnp.float32)`), with no scale.
//   - q and the output are fp32 or bf16 (`qbf`, a flag and not a template
//     parameter: Q is read once and the output written once per block, so
//     the branch costs nothing and the source builds half the kernels). A
//     bf16 q is upcast as it is staged; the output is rounded once, at the
//     store (the TPU kernel's `.astype(o_ref.dtype)`); the split partials
//     stay f32 and the merge rounds.
//   - A call whose (slot, kv head, row tile) blocks do not fill the card (a
//     decode tick) divides each slot's live key tiles among `splits` blocks
//     on the device. Each split leaves (m, l, unnormalised O) per row in
//     scratch the wrapper allocates, and split_merge_kernel
//     (split_merge.cuh, shared with paged_attention_latent.cu) combines
//     them by log-sum-exp in a second launch. A split that sees no key
//     leaves l = 0 and the merge skips it, so a freed slot is exactly 0.
//   - Blocks start in grid order, and each block maps its grid slot index
//     to the slots ranked by start, longest first (up to 1024 slots), so
//     the longest slot's blocks start first and the short ones fill the
//     tail.
//   - kernels/paged_attention.py paged_plan picks BR, BC, the ring depth,
//     the splits and the staging width from the shapes; this file checks
//     the plan and refuses one it cannot run.
// A key row is read only if it lies in the block's live range and its page
// id is in [0, P): at or before the causal frontier of the block's last
// row, and (with a window) after the window's start of its first row; a
// key tile with no row to read is skipped, and a split divides only the
// live tiles. That is the TPU kernel's whole-page skip
// (paged_attention.py:99-101) applied row by row; every row not read is
// zero-filled and masked, and a skipped page's scale is never read.
//
// Numerics as the reference: every product and sum in f32 whatever the
// operands' types; dot, then scale by 1/sqrt(hd); masked
// probabilities set to 0 explicitly; NEG_INF = -1e30; window predicate
// k_pos > q_pos - window; output acc / max(l, 1e-30). The sums run in
// another order than the plain version's (micro-tiles, splits).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "cp_async.cuh"
#include "split_merge.cuh"
#include "warp.cuh"

namespace {

using repro::bf16;
using repro::cp_async16;
using repro::cp_async4;
using repro::cp_commit;
using repro::cp_wait;
using repro::MAX_SPLITS;
using repro::NEG_INF;
using repro::warp_max;
using repro::warp_sum;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_MAX = 232448;
constexpr int PC = 32;  // keys of P staged at a time
constexpr int MAX_KEYS = 1 << 30;  // keys a slot, rows a call, window

// A block's shared memory in bytes (kernels/paged_attention.py
// _paged_smem mirrors it): Q (BR rows of HDP + 4 floats), P (PC x BR + 4),
// the ring's per-row read flags; then the ring of K/V tiles, in f32 rows of
// HDP + 4 floats, or for bf16 and int8 pools (elem 2 or 1 bytes) rows of
// HDP elements, the f32 K/V tiles they are upcast into and, for int8, the
// ring's per-row scales. 16 bytes after the flags hold the block's slot.
struct Layout {
  size_t p, flags, slot, ring, tile, scales, total;
};

__host__ __device__ inline Layout layout(int rows, int kt, int hdp,
                                         int stages, int elem) {
  const size_t qp = hdp + 4;
  Layout o;
  o.p = 4 * rows * qp;
  o.flags = o.p + 4 * (size_t)PC * (rows + 4);
  o.slot = o.flags + 4 * (size_t)stages * kt;
  o.ring = o.slot + 16;
  if (elem != 4) {
    o.tile = o.ring + (size_t)stages * 2 * kt * hdp * elem;
    o.scales = o.tile + 4 * 2 * kt * qp;
    o.total = o.scales + (elem == 1 ? 4 * (size_t)stages * 2 * kt : 0);
  } else {
    o.tile = o.scales = o.ring;
    o.total = o.ring + 4 * (size_t)stages * 2 * kt * qp;
  }
  return o;
}

// s[i][j] += Q[rows lr + 2 i] . K[keys lk + 16 j] over d < hd, for the
// first NJA of the thread's NJ keys: per 4 d, MI + NJA float4 reads of
// shared memory feed 4 MI NJA FMAs.
template <int MI, int NJ, int NJA, int QP>
__device__ __forceinline__ void scores(float (&s)[MI][NJ], const float* qr,
                                       const float* kr, int hd) {
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      a[i] = *reinterpret_cast<const float4*>(qr + 2 * i * QP + d);
#pragma unroll
    for (int j = 0; j < NJA; ++j) {
      const float4 k = *reinterpret_cast<const float4*>(kr + 16 * j * QP + d);
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

// HDP: head_dim padded to 64, 128 or 256. RW: query rows a warp (BR = 8
// RW). BC: keys a tile. T: the pool element, float or bf16 (K1) or int8_t
// (K3). q and out: float, or bf16 where qbf. Two blocks an SM where the
// plan sizes shared memory for it (128 registers a thread), else one.
template <int HDP, int RW, int BC, typename T>
__global__ void __launch_bounds__(THREADS,
                                  RW == 8 && (BC == 64 || HDP == 256) ? 1 : 2)
paged_attention_kernel(const void* __restrict__ q_in,
                       const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ start,
                       void* __restrict__ out_in,
                       float* __restrict__ part_o,
                       float* __restrict__ part_ml,
                       int Sq, int H, int KV, int hd, int P, int ps, int mps,
                       int window, int stages, int splits, int vec, int qbf,
                       float scale) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  constexpr bool CONV = !std::is_same<T, float>::value;  // staged, upcast
  constexpr int BR = WARPS * RW;  // query rows per block
  constexpr int MI = RW / 2;      // rows per thread
  constexpr int NJ = BC / 16;     // keys per thread
  constexpr int NC = HDP / 64;    // float4 value columns per thread
  constexpr int QP = HDP + 4;     // row pitch of Q and the f32 K/V tiles
  constexpr int PP = BR + 4;      // row pitch of P
  static_assert(MI == 1 || MI % 4 == 0, "P is stored by 1 or 4 rows");
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const Layout lay = layout(BR, BC, HDP, stages, (int)sizeof(T));
  float* qs = reinterpret_cast<float*>(sm);                 // [BR][QP]
  float* pbuf = reinterpret_cast<float*>(sm + lay.p);       // [PC][PP]
  int* read_s = reinterpret_cast<int*>(sm + lay.flags);     // [stages][BC]
  char* ring = sm + lay.ring;  // [stages][K, V][BC][QP f32 | HDP T]
  float* tile = reinterpret_cast<float*>(sm + lay.tile);    // [K, V][BC][QP]
  float* scl = reinterpret_cast<float*>(sm + lay.scales);   // [stages][2][BC]
  int* slot_s = reinterpret_cast<int*>(sm + lay.slot);      // the slot
  constexpr int RB = CONV ? HDP * (int)sizeof(T) : QP * 4;  // a staged row

  const int tid = threadIdx.x;
  // blocks start in grid order, so the slots are taken longest first (by
  // start, descending; ties by index): the longest slot's blocks then do
  // not set the tail (up to 1024 slots, else in order)
  const int B = gridDim.z;
  int b = blockIdx.z;
  if (B > 1 && B <= 1024) {
    for (int c = tid; c < B; c += THREADS) {
      const int sc = start[c];
      int rank = 0;
      for (int o = 0; o < B; ++o) {
        const int so = start[o];
        rank += so > sc || (so == sc && o < c);
      }
      if (rank == blockIdx.z) *slot_s = c;  // the ranks are distinct
    }
    __syncthreads();
    b = *slot_s;
  }
  const int kh = blockIdx.y % KV, split = blockIdx.y / KV;
  const int G = H / KV;
  const int n_q = G * Sq;  // rows of this kv group: row = i * G + g
  const int row0 = blockIdx.x * BR;
  const int warp = tid >> 5, lane = tid & 31;
  const int lr = lane >> 4, lk = lane & 15;
  const int wrow = warp * RW;  // the warp's first row in the block
  const int n_keys = mps * ps;  // at most MAX_KEYS: the entry point checks
  const long long st = start[b];
  const long long pos_first = st + row0 / G;
  const long long pos_last = st + (min(row0 + BR, n_q) - 1) / G;
  // the block's live keys: [key_lo, key_end); before key_lo every row's
  // window has passed, from key_end on every row's causal frontier
  const int key_end = (int)max(0LL, min((long long)n_keys, pos_last + 1));
  const int key_lo =
      window > 0
          ? (int)max(0LL, min((long long)n_keys, pos_first - window + 1))
          : 0;
  const int* bt = block_tables + (size_t)b * mps;

  // this split's share of the live key tiles
  const int t_lo = key_lo / BC;
  const int n_live = key_end > key_lo ? (key_end - 1) / BC - t_lo + 1 : 0;
  const int t_end = t_lo + (int)((long long)(split + 1) * n_live / splits);

  // the page holding key row `key`, or -1 when the row is not read
  auto page_of = [&](int key) -> int {
    if (key < key_lo || key >= key_end) return -1;
    const int pg = bt[key / ps];
    return pg >= 0 && pg < P ? pg : -1;
  };
  auto tile_live = [&](int t) {
    const int k0 = max(t * BC, key_lo), k1 = min((t + 1) * BC, key_end);
    for (int j = k0 / ps; j * ps < k1; ++j) {
      const int pg = bt[j];
      if (pg >= 0 && pg < P) return true;
    }
    return false;
  };
  auto next_live = [&](int t) {
    while (t < t_end && !tile_live(t)) ++t;
    return t;
  };
  // The warps that stage the K/V tiles: every warp where all have rows to
  // multiply, else only those that have none (a decode's 5 rows leave 5
  // of 8 warps idle), so that the copies of the next tiles do not delay
  // the products of this one.
  const int live_warps = (min(BR, n_q - row0) + RW - 1) / RW;
  const int prod0 = live_warps < WARPS ? live_warps * 32 : 0;
  const int ptid = tid - prod0, pthreads = THREADS - prod0;

  // key tile t into ring slot `slot`: copies of CW bytes, zeros where a row
  // is not read and past hd; the row's read flag and (int8) its scales. The
  // pool rows of a group of copies are looked up before any is issued, so
  // their block-table reads overlap.
  auto stage = [&](auto cw_tag, int t, int slot) {
    constexpr int CW = decltype(cw_tag)::value;
    constexpr int CPR = HDP * (int)sizeof(T) / CW;  // copies a row
    constexpr int EW = CW / (int)sizeof(T);        // elements a copy
    // copies a thread issues where all warps stage, looked up 8 at most
    constexpr int NCP = (BC * CPR + THREADS - 1) / THREADS;
    constexpr int GRP = NCP < 8 ? NCP : 8;
    if (ptid < 0) return;
    char* kd = ring + (size_t)slot * 2 * BC * RB;
    char* vd = kd + BC * RB;
    for (int e0 = ptid; e0 < BC * CPR; e0 += GRP * pthreads) {
      int prow[GRP];  // the pool row (page * ps + offset), -1: not read
#pragma unroll
      for (int k = 0; k < GRP; ++k) {
        const int e = e0 + k * pthreads;
        const int key = t * BC + e / CPR;
        const int pg = e < BC * CPR ? page_of(key) : -1;
        prow[k] = pg >= 0 ? pg * ps + key % ps : -1;
      }
#pragma unroll
      for (int k = 0; k < GRP; ++k) {
        const int e = e0 + k * pthreads;
        if (e >= BC * CPR) break;
        const int r = e / CPR, c = (e - r * CPR) * EW;
        const bool in = prow[k] >= 0 && c < hd;
        const size_t at = in ? ((size_t)prow[k] * KV + kh) * hd + c : 0;
        if constexpr (CW == 16) {
          cp_async16(kd + r * RB + c * sizeof(T), pool_k + at, in);
          cp_async16(vd + r * RB + c * sizeof(T), pool_v + at, in);
        } else {
          cp_async4(kd + r * RB + c * sizeof(T), pool_k + at, in);
          cp_async4(vd + r * RB + c * sizeof(T), pool_v + at, in);
        }
        if (c == 0) {
          const bool rd = prow[k] >= 0;
          read_s[slot * BC + r] = rd;
          if constexpr (Q8) {
            const int pg = rd ? prow[k] / ps : 0;
            float* ss = scl + slot * 2 * BC;
            cp_async4(ss + r, k_scale + pg, rd);
            cp_async4(ss + BC + r, v_scale + pg, rd);
          }
        }
      }
    }
  };
  auto issue = [&](int t, int slot) {
    if (vec)
      stage(std::integral_constant<int, 16>(), t, slot);
    else
      stage(std::integral_constant<int, 4>(), t, slot);
  };

  // Q rows, zeros past hd and past the group's rows: fp32 copied with the
  // first live tile (cp.async group 0), bf16 loaded and upcast here (the
  // loop's first barrier publishes both)
  for (int e = tid; e < BR * (HDP / 4); e += THREADS) {
    const int r = e / (HDP / 4), c = (e % (HDP / 4)) * 4;
    const int row = row0 + r;
    const bool in = row < n_q && c < hd;
    const size_t at =
        in ? (((size_t)b * Sq + row / G) * H + kh * G + row % G) * hd + c : 0;
    float* dst = qs + r * QP + c;
    if (qbf) {
      *reinterpret_cast<float4*>(dst) =
          in ? repro::load4(static_cast<const bf16*>(q_in) + at, vec)
             : make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* q = static_cast<const float*>(q_in);
    if (vec) {
      cp_async16(dst, q + at, in);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) cp_async4(dst + u, q + at + u, in);
    }
  }

  // prologue: the first stages - 1 live tiles in flight
  int t_cur =
      next_live(t_lo + (int)((long long)split * n_live / splits));
  int t_next = t_cur;
  for (int s = 0; s < stages - 1; ++s) {
    if (t_next < t_end) {
      issue(t_next, s);
      t_next = next_live(t_next + 1);
    }
    cp_commit();
  }

  // this thread's rows wrow + lr + 2 i (a row past the group's has qpos
  // -1 and sees no key; a position far past the keys is clamped where it
  // changes no predicate), keys lk + 16 j, value columns lk * 4 + 64 c; P
  // keeps its MI rows together at wrow + lr * MI
  int qpos[MI];
  float m[MI], l[MI], acc[MI][NC * 4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = row0 + wrow + lr + 2 * i;
    qpos[i] = row < n_q ? (int)min(st + row / G, (long long)n_keys + window)
                        : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }
  bool on[NC];  // this thread's value columns lie inside hd
#pragma unroll
  for (int c = 0; c < NC; ++c) on[c] = lk * 4 + 64 * c < hd;
  const bool warp_live = row0 + wrow < n_q;
  const float* my_q = qs + (wrow + lr) * QP;
  float* my_p = pbuf + wrow + lr * MI;

  for (int n = 0; t_cur < t_end; ++n) {
    if (stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();   // this thread's copies of tile t_cur have landed
    __syncthreads();  // everyone's (Q too); every warp is done with n - 1
    if (t_next < t_end) {
      issue(t_next, (n + stages - 1) % stages);
      t_next = next_live(t_next + 1);
    }
    cp_commit();
    const int slot = n % stages;
    const float* kt;
    if constexpr (CONV) {
      // upcast the staged tile once: int8 float(x) * the row's page scale,
      // bf16 exactly
      const char* kb = ring + (size_t)slot * 2 * BC * RB;
      const float* ss = scl + slot * 2 * BC;
      for (int e = tid; e < 2 * BC * (HDP / 4); e += THREADS) {
        const int r = e / (HDP / 4), c = (e % (HDP / 4)) * 4;  // r < 2 BC
        float4 f;
        if constexpr (Q8) {
          const char4 x = *reinterpret_cast<const char4*>(kb + r * HDP + c);
          const float sc = ss[r];
          f = make_float4((float)x.x * sc, (float)x.y * sc, (float)x.z * sc,
                          (float)x.w * sc);
        } else {
          f = repro::bf16x4_to_float4(
              *reinterpret_cast<const uint2*>(kb + (r * HDP + c) * 2));
        }
        *reinterpret_cast<float4*>(tile + r * QP + c) = f;
      }
      __syncthreads();
      kt = tile;
    } else {
      kt = reinterpret_cast<const float*>(ring + (size_t)slot * 2 * BC * RB);
    }
    const float* vt = kt + BC * QP;
    const int* rd = read_s + slot * BC;
    const int k0 = t_cur * BC;
    const int n_tile = min(BC, key_end - k0);  // keys past it: never read

    if (warp_live) {
      // S = Q K^T, an MI x NJ micro-tile per thread
      float s[MI][NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
      if (n_tile > BC / 2)
        scores<MI, NJ, NJ, QP>(s, my_q, kt + lk * QP, hd);
      else
        scores<MI, NJ, NJ / 2, QP>(s, my_q, kt + lk * QP, hd);

      // online softmax, one row per half-warp: dot, then scale; masked
      // probabilities exactly 0
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        bool ok[NJ];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int kpos = k0 + lk + 16 * j;
          ok[j] = rd[lk + 16 * j] && kpos <= qpos[i] &&
                  (window == 0 || kpos > qpos[i] - window);
          s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
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
        for (int c = 0; c < NC * 4; ++c) acc[i][c] *= corr;
      }

      // O += P V, an MI x (4 NC) micro-tile, PC keys at a time: each warp
      // writes and reads only its own rows of P
#pragma unroll
      for (int c0 = 0; c0 < BC; c0 += PC) {
        if (c0 >= n_tile) break;
#pragma unroll
        for (int j = c0 / 16; j < (c0 + PC) / 16; ++j) {
          float* dst = my_p + (lk + 16 * j - c0) * PP;
          if constexpr (MI == 1) {
            dst[0] = s[0][j];
          } else {
#pragma unroll
            for (int i = 0; i < MI; i += 4)
              *reinterpret_cast<float4*>(dst + i) =
                  make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
          }
        }
        __syncwarp();
        const int c1 = min(PC, n_tile - c0);
#pragma unroll 4
        for (int c = 0; c < c1; ++c) {
          float pr[MI];
          if constexpr (MI == 1) {
            pr[0] = my_p[c * PP];
          } else {
#pragma unroll
            for (int i = 0; i < MI; i += 4) {
              const float4 p =
                  *reinterpret_cast<const float4*>(my_p + c * PP + i);
              pr[i] = p.x; pr[i + 1] = p.y; pr[i + 2] = p.z; pr[i + 3] = p.w;
            }
          }
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            if (!on[cc]) continue;
            const float4 w = *reinterpret_cast<const float4*>(
                vt + (c0 + c) * QP + lk * 4 + 64 * cc);
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
    t_cur = next_live(t_cur + 1);
  }
  cp_wait<0>();

  // one split: out = acc / max(l, 1e-30), in out's type; several: the
  // split's unnormalised O (f32) and (m, l), rows in the output's order,
  // for the merge
  const int n_out = Sq * H;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = row0 + wrow + lr + 2 * i;
    if (row >= n_q) continue;
    const int orow = row / G * H + kh * G + row % G;
    const size_t at = splits == 1
        ? (size_t)b * n_out + orow
        : ((size_t)b * splits + split) * n_out + orow;
    const float denom = splits == 1 ? fmaxf(l[i], 1e-30f) : 1.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      if (!on[cc]) continue;
      const float4 o = make_float4(
          acc[i][cc * 4 + 0] / denom, acc[i][cc * 4 + 1] / denom,
          acc[i][cc * 4 + 2] / denom, acc[i][cc * 4 + 3] / denom);
      const size_t d4 = at * hd + lk * 4 + 64 * cc;
      if (splits > 1)
        *reinterpret_cast<float4*>(part_o + d4) = o;
      else if (qbf)
        repro::store4(static_cast<bf16*>(out_in) + d4, o, 4, vec);
      else
        repro::store4(static_cast<float*>(out_in) + d4, o, 4, vec);
    }
    if (splits > 1 && lk == 0) {
      part_ml[at * 2] = m[i];
      part_ml[at * 2 + 1] = l[i];
    }
  }
}

template <int HDP, int RW, int BC, typename T>
cudaError_t launch(const void* q, const T* pool_k, const T* pool_v,
                   const float* k_scale, const float* v_scale, const int* bt,
                   const int* start, void* out, float* part_o,
                   float* part_ml, int B, int Sq, int H, int KV, int hd,
                   int P, int ps, int mps, int window, int stages,
                   int splits, int vec, int qbf, float scale, size_t smem,
                   cudaStream_t s) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      paged_attention_kernel<HDP, RW, BC, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (ready != cudaSuccess) return ready;
  constexpr int BR = WARPS * RW;
  const dim3 grid((H / KV * Sq + BR - 1) / BR, KV * splits, B);
  paged_attention_kernel<HDP, RW, BC, T><<<grid, THREADS, smem, s>>>(
      q, pool_k, pool_v, k_scale, v_scale, bt, start, out, part_o, part_ml,
      Sq, H, KV, hd, P, ps, mps, window, stages, splits, vec, qbf, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  if (qbf)
    return repro::launch_split_merge(part_o, part_ml, static_cast<bf16*>(out),
                                     B, Sq * H, hd, splits, s);
  return repro::launch_split_merge(part_o, part_ml, static_cast<float*>(out),
                                   B, Sq * H, hd, splits, s);
}

template <typename T>
int run(const void* q, const T* pool_k, const T* pool_v,
        const float* k_scale, const float* v_scale, const int* bt,
        const int* start, void* out, float* part_o, float* part_ml, int B,
        int Sq, int H, int KV, int hd, int P, int ps, int mps, int window,
        int rows, int key_tile, int stages, int splits, int vec, int qbf,
        float scale, void* stream) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || Sq < 1 || KV < 1 || H < KV || H % KV != 0 ||
      hd < 4 || hd > 256 || hd % 4 != 0 || P < 1 || ps < 1 || mps < 1 ||
      window < 0 || window >= MAX_KEYS || (long long)mps * ps >= MAX_KEYS ||
      (long long)P * ps > 0x7fffffffLL ||
      (long long)H * Sq >= MAX_KEYS)
    return bad;
  if ((rows != 16 && rows != 64) || (key_tile != 32 && key_tile != 64) ||
      (rows == 16 && key_tile != 32) ||
      (stages != 2 && stages != 3) || splits < 1 || splits > MAX_SPLITS ||
      (long long)KV * splits > 65535)
    return bad;
  const int hdp = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  const size_t smem =
      layout(rows, key_tile, hdp, stages, (int)sizeof(T)).total;
  if (smem > SMEM_MAX) return bad;
  if (splits > 1 && (part_o == nullptr || part_ml == nullptr)) return bad;
  if (Q8 && (k_scale == nullptr || v_scale == nullptr)) return bad;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // 16-byte copies of whole 16-byte pieces of a row
  if (vec && !(aligned(q) && aligned(pool_k) && aligned(pool_v) &&
               aligned(out) && hd * sizeof(T) % 16 == 0))
    return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(HDP, RW, BC)                                                  \
  return (int)launch<HDP, RW, BC, T>(q, pool_k, pool_v, k_scale, v_scale,    \
                                     bt, start, out, part_o, part_ml, B, Sq, \
                                     H, KV, hd, P, ps, mps, window, stages,  \
                                     splits, vec, qbf, scale, smem, s)
#define BY_TILES(HDP)                       \
  if (key_tile == 64) LAUNCH(HDP, 8, 64);    \
  if (rows == 64) LAUNCH(HDP, 8, 32);        \
  LAUNCH(HDP, 2, 32)
  if (hdp == 64) {
    BY_TILES(64);
  }
  if (hdp == 128) {
    BY_TILES(128);
  }
  BY_TILES(256);
#undef BY_TILES
#undef LAUNCH
}

}  // namespace

// q (B, Sq, H, hd) and out (B, Sq, H, hd): fp32 (QT f32) or bf16 (QT bf16);
// pools (P, ps, KV, hd): fp32, bf16 or int8 (PT); all contiguous.
// block_tables (B, mps) and start (B,): int32. The plan (rows, key_tile,
// stages, splits, vec) is kernels/paged_attention.py paged_plan's; with
// splits > 1, part_o (B, splits, Sq * H, hd) and part_ml (B, splits,
// Sq * H, 2) f32 are the splits' scratch and a merge kernel follows. vec:
// q, the pools and out 16-byte aligned and a pool row a multiple of 16
// bytes. Launches on `stream` and returns 0, cudaErrorInvalidValue for
// shapes or a plan the kernel cannot run, or cudaGetLastError().
// repro_paged_attention_<QT>_<PT> for QT in {f32, bf16}, PT in {f32, bf16}.
#define REPRO_PAGED_ENTRY(NAME, QBF, PT)                                    \
  extern "C" int NAME(const void* q, const PT* pool_k, const PT* pool_v,   \
                      const int* block_tables, const int* start, void* out, \
                      float* part_o, float* part_ml, int B, int Sq, int H,  \
                      int KV, int hd, int P, int ps, int mps, int window,   \
                      int rows, int key_tile, int stages, int splits,       \
                      int vec, float scale, void* stream) {                 \
    return run<PT>(q, pool_k, pool_v, nullptr, nullptr, block_tables,       \
                   start, out, part_o, part_ml, B, Sq, H, KV, hd, P, ps,    \
                   mps, window, rows, key_tile, stages, splits, vec, QBF,   \
                   scale, stream);                                          \
  }
REPRO_PAGED_ENTRY(repro_paged_attention_f32_f32, 0, float)
REPRO_PAGED_ENTRY(repro_paged_attention_f32_bf16, 0, bf16)
REPRO_PAGED_ENTRY(repro_paged_attention_bf16_f32, 1, float)
REPRO_PAGED_ENTRY(repro_paged_attention_bf16_bf16, 1, bf16)
#undef REPRO_PAGED_ENTRY

// The int8 pools of K3: pools (P, ps, KV, hd) int8; k_scale / v_scale (P,)
// f32, the per-page symmetric scales; vec also needs hd % 16 == 0;
// everything else as above. repro_paged_attention_<QT>_i8.
#define REPRO_PAGED_I8_ENTRY(NAME, QBF)                                     \
  extern "C" int NAME(const void* q, const int8_t* pool_k,                  \
                      const int8_t* pool_v, const float* k_scale,           \
                      const float* v_scale, const int* block_tables,        \
                      const int* start, void* out, float* part_o,           \
                      float* part_ml, int B, int Sq, int H, int KV, int hd, \
                      int P, int ps, int mps, int window, int rows,         \
                      int key_tile, int stages, int splits, int vec,        \
                      float scale, void* stream) {                          \
    return run<int8_t>(q, pool_k, pool_v, k_scale, v_scale, block_tables,   \
                       start, out, part_o, part_ml, B, Sq, H, KV, hd, P,    \
                       ps, mps, window, rows, key_tile, stages, splits,     \
                       vec, QBF, scale, stream);                            \
  }
REPRO_PAGED_I8_ENTRY(repro_paged_attention_f32_i8, 0)
REPRO_PAGED_I8_ENTRY(repro_paged_attention_bf16_i8, 1)
#undef REPRO_PAGED_I8_ENTRY
