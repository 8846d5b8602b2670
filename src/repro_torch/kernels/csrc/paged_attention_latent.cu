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
// q and the output are fp32 or bf16, the pool fp32 or bf16, in any
// pairing (the Pallas kernel upcasts both with `.astype(jnp.float32)` and
// writes its output in q's dtype). A bf16 pool is staged as bf16, half the
// bytes, and each staged tile is upcast once into an f32 tile that the
// same product code reads (a barrier a tile); a bf16 q is upcast as it is
// staged; the output is rounded once, at the store; split partials stay
// f32 and the merge rounds. Both types are template parameters: a flag
// for q's type cost the fp32 decode (its 16-row tile) registers and ~9 %.
//
// Bound: at decode the bytes of each slot's live latent rows, which every
// head shares; at prefill the fp32 FMAs, (L + d_v) per visible (row, head,
// key). fp32 FMA throughout, no tensor cores and no TF32. So the design
// feeds the FMA units from registers, reads each staged row for every
// query row of the block, and splits a decode over the slot's keys so
// that the card fills.
//
// Design. There is a single shared "kv head", so G = H: one block of 512
// threads owns one (slot b, tile of BR = 32 or 16 of the H * Sq flattened
// query rows, row = i * H + h, a range of the slot's key tiles). A key
// tile is KT = 16 logical key rows, each gathered from the page its block
// table names (a warp a row), so any page size works; the block walks its
// range through a 2- or 3-stage cp.async ring (16-byte copies where rows
// allow), the next tiles in flight while one is multiplied. A staged row
// serves the scores (all L columns) and the values (its first d_v), so it
// is read once for all the block's query rows. Q is staged once.
//   - S = Q K^T is BR x 16 per tile, too small to give 512 threads a 4 x 4
//     micro-tile each, so L is cut into 512 / BR slices: the BR threads of
//     a slice own 4 x 4 micro-tiles (rows rg + BR/4 i, keys kg + 4 j) over
//     their slice's columns (8 float4 reads of shared memory feed 64 FMAs),
//     and the slices' partial scores are summed in order through shared
//     memory. The 16 threads summing one row's keys are a half-warp, so the
//     online softmax's row max and sum are 4 shuffles each.
//   - O += P V: thread (rg, cg) owns rows rg * 8 .. + 7 and the float4 of
//     columns cg * 4 (2 float4 of P and 1 of V feed 32 FMAs); 512 / (BR /
//     8) column groups cover d_v <= 512 at BR 32 and <= 1024 at BR 16.
//     P and the per-row (m, l, correction) go through shared memory.
//   - Shared memory at the full width (L 576, BR 32, 3 stages): Q 74 KB,
//     ring 111 KB, partial scores 32 KB: one block per SM, 16 warps of at
//     most 128 registers. Wider rows take BR 16 and, past 3 stages' room,
//     2 (L 1024: 226 KB).
//   - Decode (Sq = 1) has H rows a slot, 8 slots give 24 (slot, row tile)
//     pairs for 132 SMs, so the slot's key tiles up to its last query's
//     frontier are divided among `splits` blocks on the device (each
//     block reads the slot's start); every row tile divides them alike.
//     Each split leaves (m, l, unnormalised O) per row in scratch the
//     wrapper allocates, and split_merge_kernel (split_merge.cuh, shared
//     with paged_attention.cu) combines the splits by log-sum-exp. A
//     split with no live key leaves l = 0 and the merge
//     skips it, so an empty split adds exactly nothing and a slot whose
//     splits are all empty gets exact zeros. One split writes the output
//     itself. kernels/paged_attention.py latent_plan picks BR, the ring
//     depth and the splits; this file checks the plan. Key indices are
//     32-bit (the entry point checks mps * page_size): a 64-bit division
//     in the per-row gather is tens of instructions a copy.
// A key row is read only if its page id is in [0, P) and it is at or
// before the causal frontier of the block's last row; every other staged
// row is zero-filled and masked, and a key tile with no row to read is
// skipped, so unallocated pages and pages wholly past the frontier are
// never read (the TPU kernel's predicate).
//
// Numerics as the reference: dot, then scale; masked probabilities set to
// 0; NEG_INF = -1e30; output acc / max(l, 1e-30), so a freed slot (all -1
// block table) is exactly 0. The sums run in another order than the plain
// version's (L slices, splits).

#include <cuda_runtime.h>

#include <cstdint>

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

constexpr int THREADS = 512;
constexpr int KT = 16;  // key rows per tile
constexpr int SMEM_MAX = 232448;
constexpr int MAX_WIDTH = 1024;

// A block's shared memory (kernels/paged_attention.py _latent_smem mirrors
// it), offsets in floats: Q (BR rows), the ring (stages x KT rows; for a
// bf16 pool the one f32 tile it is upcast into), the slices' partial
// scores, P (KT x BR) and the rows' m, l, correction; for a bf16 pool then
// the bf16 ring (stages x KT rows of pitch bp) at byte ring16. Staged rows
// are `width` = slices * sw elements (zeros past L), pitch lp (f32).
struct Layout {
  int slices, sw, width, lp, ring, part, p, stats, total, bp;
  size_t ring16, bytes;
};

__host__ __device__ inline Layout layout(int rows, int Lw, int stages,
                                         int elem) {
  Layout o;
  o.slices = THREADS / rows;
  o.sw = ((Lw + 3) / 4 + o.slices - 1) / o.slices * 4;
  o.width = o.slices * o.sw;
  o.lp = o.width + 4;
  o.ring = rows * o.lp;
  o.part = o.ring + (elem == 4 ? stages : 1) * KT * o.lp;
  o.p = o.part + o.slices * rows * KT;
  o.stats = o.p + KT * (rows + 4);
  o.total = o.stats + 3 * rows;
  o.bp = o.width + 8;  // 16-byte aligned bf16 rows
  o.ring16 = (size_t)o.total * 4;
  o.bytes = elem == 4 ? o.ring16 : o.ring16 + (size_t)stages * KT * o.bp * 2;
  return o;
}

// TP: the pool element, TQ: q's and the output's; each float or bf16
template <int BR, typename TP, typename TQ>
__global__ void __launch_bounds__(THREADS, 1)
latent_attention_kernel(const TQ* __restrict__ q,
                        const TP* __restrict__ pool,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ start,
                        TQ* __restrict__ out,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml,
                        int Sq, int H, int Lw, int d_v, int P, int ps,
                        int mps, int stages, int splits, int vec,
                        float scale) {
  constexpr bool BF = sizeof(TP) == 2;
  constexpr int RG = BR / 8;        // row groups of the value product
  constexpr int CG = THREADS / RG;  // its column groups (a float4 each)
  constexpr int NE = (BR * KT + THREADS - 1) / THREADS;  // softmax entries
  constexpr int PP = BR + 4;        // row pitch of P
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout lay = layout(BR, Lw, stages, (int)sizeof(TP));
  const int lp = lay.lp;
  float* qs = sm;                   // [BR][lp]
  float* ring = sm + lay.ring;      // [stages | 1][KT][lp]
  bf16* ring16 = reinterpret_cast<bf16*>(
      reinterpret_cast<char*>(smem4) + lay.ring16);  // [stages][KT][bp]
  float* part = sm + lay.part;      // [slices][BR][KT]
  float* pt = sm + lay.p;           // [KT][PP]
  float* m_s = sm + lay.stats;      // [BR]
  float* l_s = m_s + BR;            // [BR]
  float* c_s = l_s + BR;            // [BR]

  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int n_q = H * Sq;
  const int row0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const long long st = start[b];
  const long long pos_last = st + (min(row0 + BR, n_q) - 1) / H;
  const int* bt = block_tables + (size_t)b * mps;
  const int n_keys = mps * ps;  // fits an int: the entry point checks
  // keys at or past key_end are never read
  const int key_end = (int)min((long long)n_keys, pos_last + 1);

  // this split's share of the slot's key tiles up to its LAST query's
  // frontier: the same tiles for every row tile of the slot, so a row's
  // keys divide among the splits alike whichever row tile holds it (a
  // launch on a slab of the heads, whose row tiles hold other rows, then
  // gives the whole launch's bits); tiles past this block's key_end are
  // not live and are skipped
  const long long slot_end = min((long long)n_keys, st + Sq);
  const int n_live = slot_end > 0 ? (int)((slot_end + KT - 1) / KT) : 0;
  const int t_end = (int)((long long)(split + 1) * n_live / splits);

  // the page holding logical key row `key`, or -1 when the row is not read
  auto page_of = [&](int key) -> int {
    if (key >= key_end) return -1;
    const int pg = bt[key / ps];
    return pg >= 0 && pg < P ? pg : -1;
  };
  auto tile_live = [&](int t) {
    const int k1 = min((t + 1) * KT, key_end);
    for (int j = t * KT / ps; j * ps < k1; ++j) {
      const int pg = bt[j];
      if (pg >= 0 && pg < P) return true;
    }
    return false;
  };
  auto next_live = [&](int t) {
    while (t < t_end && !tile_live(t)) ++t;
    return t;
  };
  // key tile t into ring slot `slot`, zeros where a row is not read and
  // past L: a warp a row, each lane its columns lane * 4 + 128 c (16-byte
  // copies; 4-byte ones at lane + 32 c where rows are not a multiple of 4
  // floats); bf16 rows by 16-byte copies at lane * 8 + 256 c, or 4-byte
  // ones at lane * 2 + 64 c (L even)
  const int r_own = tid >> 5, c_own = tid & 31;
  auto issue = [&](int t, int slot) {
    const int key = t * KT + r_own;
    const int pg = page_of(key);
    const TP* src =
        pg >= 0 ? pool + ((size_t)pg * ps + key % ps) * Lw : pool;
    if constexpr (BF) {
      bf16* dst = ring16 + (size_t)(slot * KT + r_own) * lay.bp;
      if (vec) {
        for (int c = c_own * 8; c < lay.width; c += 256)
          cp_async16(dst + c, pg >= 0 && c < Lw ? src + c : pool,
                     pg >= 0 && c < Lw);
      } else {
        for (int c = c_own * 2; c < lay.width; c += 64)
          cp_async4(dst + c, pg >= 0 && c < Lw ? src + c : pool,
                    pg >= 0 && c < Lw);
      }
      return;
    }
    float* dst = ring + slot * KT * lp + r_own * lp;
    if (vec) {
      for (int c = c_own * 4; c < lay.width; c += 128)
        cp_async16(dst + c, pg >= 0 && c < Lw ? src + c : pool,
                   pg >= 0 && c < Lw);
    } else {
      for (int c = c_own; c < lay.width; c += 32)
        cp_async4(dst + c, pg >= 0 && c < Lw ? src + c : pool,
                  pg >= 0 && c < Lw);
    }
  };

  // prologue: the first stages - 1 live tiles in flight
  int t_cur = next_live((int)((long long)split * n_live / splits));
  int t_next = t_cur;
  for (int s = 0; s < stages - 1; ++s) {
    if (t_next < t_end) {
      issue(t_next, s);
      t_next = next_live(t_next + 1);
    }
    cp_commit();
  }

  // Q rows, zeros past L and past the last row (bf16 upcast here)
  const int w4 = lay.width / 4;
  if (vec) {
    for (int e = tid; e < BR * w4; e += THREADS) {
      const int r = e / w4, c = (e - r * w4) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      const size_t at = ((size_t)b * n_q + row0 + r) * Lw + c;
      if (row0 + r < n_q && c < Lw)
        val = repro::load4(q + at, true);
      *reinterpret_cast<float4*>(qs + r * lp + c) = val;
    }
  } else {
    for (int e = tid; e < BR * lay.width; e += THREADS) {
      const int r = e / lay.width, c = e - r * lay.width;
      const size_t at = ((size_t)b * n_q + row0 + r) * Lw + c;
      qs[r * lp + c] = row0 + r < n_q && c < Lw
                           ? repro::to_f32(q[at])
                           : 0.f;
    }
  }
  if (tid < BR) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // the score product's thread: slice, rows rg + BR/4 i, keys kg + 4 j
  const int slice = tid / BR, loc = tid % BR;
  const int srg = loc >> 2, skg = loc & 3;
  const int d_lo = slice * lay.sw, d_hi = d_lo + lay.sw;
  // the value product's thread: rows vrg * 8 + i, columns vcg * 4 .. + 3
  const int vrg = tid / CG, vcg = tid % CG;
  const bool on = vcg * 4 < d_v;
  float acc[8][4];
  // the positions of the rows this thread takes in the softmax
  long long qpos[NE];
#pragma unroll
  for (int u = 0; u < NE; ++u)
    qpos[u] = st + (row0 + (tid + u * THREADS) / KT) / H;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int n = 0; t_cur < t_end; ++n) {
    if (stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();   // this thread's copies of tile t_cur have landed
    __syncthreads();  // everyone's, Q and the stats; all done with n - 1
    if (t_next < t_end) {
      issue(t_next, (n + stages - 1) % stages);
      t_next = next_live(t_next + 1);
    }
    cp_commit();
    const float* ks;
    if constexpr (BF) {
      // upcast the staged bf16 tile once into the f32 tile
      const bf16* kb = ring16 + (size_t)(n % stages) * KT * lay.bp;
      for (int e = tid; e < KT * w4; e += THREADS) {
        const int r = e / w4, c = (e - r * w4) * 4;
        *reinterpret_cast<float4*>(ring + r * lp + c) =
            repro::load4(kb + (size_t)r * lay.bp + c, true);
      }
      __syncthreads();
      ks = ring;
    } else {
      ks = ring + (n % stages) * KT * lp;
    }

    // partial scores over this thread's slice of L
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int d = d_lo; d < d_hi; d += 4) {
        float4 a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              qs + (srg + BR / 4 * i) * lp + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kk[j] = *reinterpret_cast<const float4*>(ks + (skg + 4 * j) * lp +
                                                   d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[(slice * BR + srg + BR / 4 * i) * KT + skg + 4 * j] = s[i][j];
    }
    __syncthreads();

    // the slices summed in order, then scaled; the online softmax, one row
    // per half-warp; P and the row statistics into shared memory
#pragma unroll
    for (int u = 0; u < NE; ++u) {
      const int e = tid + u * THREADS;
      if (e >= BR * KT) break;  // whole warps
      const int row = e / KT, key = e % KT;
      float dot = 0.f;
      for (int sl = 0; sl < lay.slices; ++sl)
        dot += part[(sl * BR + row) * KT + key];
      const float sc = dot * scale;
      const int kpos = t_cur * KT + key;
      const bool ok = row0 + row < n_q && kpos <= qpos[u] &&
                      page_of(kpos) >= 0;
      const float s = ok ? sc : NEG_INF;
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max<16>(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float sum = warp_sum<16>(p);
      pt[key * PP + row] = p;
      __syncwarp();  // every lane has read m_s[row] before it changes
      if (key == 0) {
        const float corr = expf(m_old - m_new);
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + sum;
        c_s[row] = corr;
      }
    }
    __syncthreads();

    // O = O * corr + P V over the tile's keys
    {
      float corr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) corr[i] = c_s[vrg * 8 + i];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= corr[i];
      if (on) {
#pragma unroll 4
        for (int key = 0; key < KT; ++key) {
          const float4 p0 =
              *reinterpret_cast<const float4*>(pt + key * PP + vrg * 8);
          const float4 p1 =
              *reinterpret_cast<const float4*>(pt + key * PP + vrg * 8 + 4);
          const float pr[8] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
          const float4 w =
              *reinterpret_cast<const float4*>(ks + key * lp + vcg * 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][0] = fmaf(pr[i], w.x, acc[i][0]);
            acc[i][1] = fmaf(pr[i], w.y, acc[i][1]);
            acc[i][2] = fmaf(pr[i], w.z, acc[i][2]);
            acc[i][3] = fmaf(pr[i], w.w, acc[i][3]);
          }
        }
      }
    }
    t_cur = next_live(t_cur + 1);
  }
  cp_wait<0>();
  __syncthreads();  // the stats are final (also where no tile ran)

  const bool vec_out = d_v % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = vrg * 8 + i;
    if (row0 + row >= n_q) continue;
    const size_t orow = splits == 1
        ? (size_t)b * n_q + row0 + row
        : ((size_t)b * splits + split) * n_q + row0 + row;
    const size_t at = orow * d_v + vcg * 4;
    const float denom = splits == 1 ? fmaxf(l_s[row], 1e-30f) : 1.f;
    if (!on) continue;
    const float4 o = make_float4(acc[i][0] / denom, acc[i][1] / denom,
                                 acc[i][2] / denom, acc[i][3] / denom);
    if (splits > 1)
      repro::store4(part_o + at, o, d_v - vcg * 4, vec_out);
    else
      repro::store4(out + at, o, d_v - vcg * 4, vec_out);
  }
  if (splits > 1 && tid < BR && row0 + tid < n_q) {
    float* ml = part_ml +
        (((size_t)b * splits + split) * n_q + row0 + tid) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

template <int BR, typename TP, typename TQ>
cudaError_t launch(const TQ* q, const TP* pool, const int* bt,
                   const int* start, TQ* out, float* part_o,
                   float* part_ml, int B, int Sq, int H, int Lw, int d_v,
                   int P, int ps, int mps, int stages, int splits, int vec,
                   float scale, size_t smem, cudaStream_t s) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      latent_attention_kernel<BR, TP, TQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (ready != cudaSuccess) return ready;
  const int n_q = H * Sq;
  const dim3 grid((n_q + BR - 1) / BR, splits, B);
  latent_attention_kernel<BR, TP, TQ><<<grid, THREADS, smem, s>>>(
      q, pool, bt, start, out, part_o, part_ml, Sq, H, Lw, d_v, P, ps, mps,
      stages, splits, vec, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return repro::launch_split_merge(part_o, part_ml, out, B, n_q, d_v, splits,
                                   s);
}

template <typename TP, typename TQ>
int run(const TQ* q, const TP* pool, const int* block_tables,
        const int* start, TQ* out, float* part_o, float* part_ml, int B,
        int Sq, int H, int Lw, int d_v, int P, int ps, int mps, int rows,
        int stages, int splits, int vec, float scale, void* stream) {
  constexpr bool BF = sizeof(TP) == 2;
  const cudaError_t bad = cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || Sq < 1 || H < 1 || Lw < 1 || Lw > MAX_WIDTH ||
      d_v < 1 || d_v > Lw || P < 1 || ps < 1 || mps < 1 ||
      (long long)H * Sq > 0x7fffffffLL - 32 ||
      (long long)mps * ps > 0x7fffffffLL - KT || (BF && Lw % 2 != 0))
    return (int)bad;
  if ((rows != 16 && rows != 32) || (stages != 2 && stages != 3) ||
      splits < 1 || splits > MAX_SPLITS)
    return (int)bad;
  // a float4 column for each of THREADS / (rows / 8) threads covers d_v
  if (THREADS / (rows / 8) * 4 < d_v) return (int)bad;
  const size_t smem = layout(rows, Lw, stages, (int)sizeof(TP)).bytes;
  if (smem > SMEM_MAX) return (int)bad;
  if (splits > 1 && (part_o == nullptr || part_ml == nullptr)) return (int)bad;
  if (vec && (Lw % (BF ? 8 : 4) != 0 ||
              reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(pool) % 16 != 0))
    return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(rows == 32
                   ? launch<32>(q, pool, block_tables, start, out, part_o,
                                part_ml, B, Sq, H, Lw, d_v, P, ps, mps,
                                stages, splits, vec, scale, smem, s)
                   : launch<16>(q, pool, block_tables, start, out, part_o,
                                part_ml, B, Sq, H, Lw, d_v, P, ps, mps,
                                stages, splits, vec, scale, smem, s));
}

}  // namespace

// q (B, Sq, H, Lw) and out (B, Sq, H, d_v): fp32 (QT f32) or bf16 (QT
// bf16); pool (P, ps, 1, Lw): fp32 or bf16 (PT, Lw even for bf16); all
// contiguous. block_tables (B, mps) and start (B,): int32. Lw <= 1024 and
// 1 <= d_v <= Lw. The plan (rows, stages, splits, vec) is
// kernels/paged_attention.py latent_plan's; with splits > 1, part_o
// (B, splits, H * Sq, d_v) and part_ml (B, splits, H * Sq, 2) f32 are the
// splits' scratch and a merge kernel follows. vec: Lw a multiple of 4 (8
// for bf16 pools) and q and pool 16-byte aligned. Launches on `stream` and
// returns 0, cudaErrorInvalidValue for shapes or a plan the kernel cannot
// run, or cudaGetLastError(). repro_paged_attention_latent_<QT>_<PT>.
#define REPRO_LATENT_ENTRY(NAME, QT, PT)                                   \
  extern "C" int NAME(const QT* q, const PT* pool,                         \
                      const int* block_tables, const int* start, QT* out,  \
                      float* part_o, float* part_ml, int B, int Sq, int H, \
                      int Lw, int d_v, int P, int ps, int mps, int rows,   \
                      int stages, int splits, int vec, float scale,        \
                      void* stream) {                                      \
    return run<PT, QT>(q, pool, block_tables, start, out, part_o, part_ml, \
                       B, Sq, H, Lw, d_v, P, ps, mps, rows, stages,        \
                       splits, vec, scale, stream);                        \
  }
REPRO_LATENT_ENTRY(repro_paged_attention_latent_f32_f32, float, float)
REPRO_LATENT_ENTRY(repro_paged_attention_latent_f32_bf16, float, bf16)
REPRO_LATENT_ENTRY(repro_paged_attention_latent_bf16_f32, bf16, float)
REPRO_LATENT_ENTRY(repro_paged_attention_latent_bf16_bf16, bf16, bf16)
#undef REPRO_LATENT_ENTRY
