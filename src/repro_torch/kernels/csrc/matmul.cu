// The systolic tiled GEMM (K7) and the int8-weight GEMM (K8), written for
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels: repro/kernels/matmul.py _os_kernel and
// _acc_kernel (K7, behind ops.matmul: out = x @ w, fp32 accumulation, in
// the output-, weight- or input-stationary dataflow the TPU selects by grid
// order) and repro/kernels/quant_matmul.py _kernel (K8, behind
// ops.quant_matmul: out = x @ (float(w_q) * scale[n]), fp32 accumulation).
// x is (M, K), w (K, N), out (M, N) row-major in x's type (fp32 or bf16);
// x and w are read through any strides, so a transposed view (the
// gradient GEMMs of the autograd Function) costs no copy.
//
// Bound: at the ResNet20 shapes (K = 16..576, N = 16..64) the bytes of the
// im2col'd x, about N / 2 FMAs per byte against the fp32 ridge of 20; at
// N = 64 and K = 576 the fp32 FMAs. The backward's GEMMs are bound the
// same way: dW reads the im2col'd X and g once (N / 2 FMAs per byte under
// a 27-576 x 16-64 output), dX writes an output as large as X from a g of
// N columns (up to N FMAs per byte written). The math is plain fp32 FMA in
// registers, no tensor cores and no TF32, because fp32 is what the
// reference holds; bf16 inputs are converted to f32 as they are staged.
// So the design works on Hopper's memory side.
//
// Design. The TPU grid runs in order on one core and carries the tile's
// accumulator in VMEM scratch (output-stationary) or in the revisited output
// block (weight-/input-stationary). Here a block of 256 threads owns a BM x
// BN output tile, with BN in {16, 32, 64} sized to N (one N-tile covers
// N <= 64; wider N takes 64-wide tiles) and BM = TM * 1024 / BN, so that
// each thread keeps a TM x 4 register micro-tile (TM in {8, 4, 1}, chosen
// with the grid by kernels/matmul.py tile_plan, which this file checks:
// the largest TM whose grid still fills the card; split and wide take the
// TM that reads the least shared memory per SM, TM >= 4 as float4 groups).
//   output-stationary: the block stages w's K x BN slice once into dynamic
//     shared memory (as f32; K8 dequantizes it there from int8) and streams
//     its BM rows of x through a 3-stage ring of 16-deep tiles with
//     cp.async (16-byte copies where x's rows allow, each asking L2 for its
//     whole 128-byte line so that rows come from device memory in longer
//     stretches; else 4-byte ones), so two tiles load while one is
//     multiplied; accumulators stay in registers. Where the slice does not
//     fit, K is walked in the largest chunks that do.
//   weight-stationary: the same resident w chunk, and the block sweeps
//     `group` M-tiles under it; the fp32 running sum is re-streamed through
//     `acc` once per K-chunk (never at ResNet20's shapes, where K fits).
//   input-stationary: the block keeps its BM x K-chunk of x resident
//     (staged on the first N-tile's pass) and sweeps `group` N-tiles,
//     streaming w's tiles through the ring; the same re-streaming.
//   skinny (M <= 16, e.g. K8 at an LM's wo with 8 slots): a block of 4
//     warps covers 32 columns; x's M x K-chunk is resident, w streams raw
//     (int8, bf16 or f32) through a 4-stage ring of 8 KB 16-byte copies,
//     each lane owns one column and each warp rows m = warp + 4 i.
//   split (a long reduction under an output of too few tiles to fill the
//     card: the backward's dW = X^T g, reductions of 8,192-131,072 rows
//     under 16-576 x 16-64 outputs): the reduction is cut into S
//     contiguous ranges of kc rows (a multiple of BK, fixed by M, K, N and
//     the tile alone), one block per (tile, range), two to an SM where
//     they fit; both operands stream through a 4-stage ring (stages of 64
//     rows for TM = 1's narrow tiles, else 16), x into a k-major tile
//     (X^T's unit stride runs along m, so 16-byte copies where its strides
//     allow), and the block writes its partial tile to an f32 (S, M, N)
//     scratch, each element once; a second launch adds the S partials in
//     the order s = 0 .. S-1 (a block's partials copied to shared memory
//     all at once, then summed by one warp, a lane per element).
//   wide (a reduction of K <= 64 under an output wider than one N-tile:
//     the backward's dX = g W^T): all of w stays resident, staged once per
//     block as N-panels of row pitch BN + 4 along w's unit stride (so the
//     staging's float4 stores and the FMA's float4 reads meet no bank
//     conflict); each block sweeps `group` M-tiles, double-buffering x's
//     rows by 16-byte copies, and writes each tile's whole output rows,
//     one N-panel after another, so x is read once.
// Every output element (every partial, under split) is written by exactly
// one block, and one thread carries its sum as a single FMA chain that
// starts at 0.f and runs over its k in order in every schedule (zero-padded
// k past K adds only 0 * 0); split then adds its ranges in a fixed order.
// So all dataflows (the split, wide and skinny schedules are the same for
// every dataflow) give the same bits, a GEMM run twice gives the same bits,
// and no result depends on scheduling (no float atomics). K8's weight
// is dequantized in the TPU order, w = float(q) * scale[n] (one rounding,
// as K7 is given it), then the FMA with x: the scale is never moved out of
// the sum, which would round differently.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_commit;
using repro::cp_wait;

constexpr int THREADS = 256;
constexpr int BK = 16;                // k-depth of one ring stage
constexpr int STAGES = 3;             // ring depth of the streamed operand
constexpr int LDX = BK + 4;           // row pitch (floats) of a streamed x tile
constexpr int SMEM_MAX = 232448;      // a block's dynamic shared memory
constexpr int SK_THREADS = 128;       // skinny: 4 warps
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_COLS = 32;           // columns per skinny block
constexpr int SK_STAGES = 4;
constexpr int SK_STAGE_BYTES = 8192;  // raw w per skinny stage
constexpr int SK_MAX_M = 16;
constexpr int SPLIT_STAGES = 4;       // split: ring depth of x and w
// split: reduction rows per ring stage, more for TM = 1's narrow tiles (the
// small outputs, whose stages would otherwise carry little work each)
template <int TM>
__host__ __device__ constexpr int split_bk() { return TM == 1 ? 64 : BK; }
constexpr int SUM_COLS = 32;          // split's sum: elements per block

enum Dataflow { OUTPUT_STATIONARY = 0, WEIGHT_STATIONARY = 1,
                INPUT_STATIONARY = 2 };
// kernels/matmul.py SCHEDULES
enum Schedule { TILED = 0, SKINNY = 1, SPLIT = 2, WIDE = 3 };

// Ring slots a K-chunk of kc needs: tile kt sits in slot kt % STAGES, so a
// chunk of fewer than STAGES tiles (the stem's K = 27) uses only its own.
__host__ __device__ __forceinline__ int ring_slots(int kc) {
  return kc / BK < STAGES ? kc / BK : STAGES;
}

struct Geometry {
  int M, K, N;
  long long sxm, sxk, swk, swn;       // element strides of x and w
};

// The launch plan (kernels/matmul.py tile_plan): N-tile, rows per thread,
// K-chunk depth, swept tiles per block, 16-byte (x) and vector (w) staging.
struct Plan {
  int dataflow, bn, tm, kc, group, vec_x, vec_w;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// A weight element as the FMA takes it: K8 dequantizes float(q) * scale.
__device__ __forceinline__ float weight(float v, float) { return v; }
__device__ __forceinline__ float weight(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float weight(int8_t q, float scale) {
  return __fmul_rn(static_cast<float>(q), scale);
}

// Four consecutive weight elements as one aligned load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

// rows x cols of x at (m0, k0) as f32 into dst (row pitch `pitch`), zeros
// past M and past kend. fp32 by cp.async: 16 bytes along k when `vec`
// (unit k stride, K % 4 == 0, 16-byte rows; with the L2 prefetch for the
// streamed ring), else 4 bytes with consecutive threads along x's
// unit-stride axis; bf16 by plain loads.
template <int NTHREADS, bool PREFETCH = false, typename TX>
__device__ __forceinline__ void load_x(float* dst, int pitch, const TX* x,
                                       const Geometry& g, int m0, int k0,
                                       int kend, int rows, int cols,
                                       bool vec) {
  if constexpr (std::is_same<TX, float>::value) {
    if (vec) {
      const int c4 = cols / 4;
      for (int e = threadIdx.x; e < rows * c4; e += NTHREADS) {
        const int r = e / c4, c = (e % c4) * 4;
        const int m = m0 + r, k = k0 + c;
        const bool in = m < g.M && k < kend;
        cp_async16<PREFETCH>(dst + r * pitch + c, in ? x + m * g.sxm + k : x,
                             in);
      }
      return;
    }
  }
  const bool along_k = g.sxk == 1 || g.sxm != 1;
  for (int e = threadIdx.x; e < rows * cols; e += NTHREADS) {
    const int r = along_k ? e / cols : e % rows;
    const int c = along_k ? e % cols : e / rows;
    const int m = m0 + r, k = k0 + c;
    const bool in = m < g.M && k < kend;
    const TX* src = in ? x + m * g.sxm + k * g.sxk : x;
    if constexpr (std::is_same<TX, float>::value)
      cp_async4(dst + r * pitch + c, src, in);
    else
      dst[r * pitch + c] = in ? to_f32(*src) : 0.f;
  }
}

// rows x BN of w at (k0, n0) as f32 into dst (row pitch BN), zeros past N
// and past kend. K7's fp32 w by cp.async (16 bytes along n when `vec`, else
// 4 bytes along w's unit-stride axis); bf16 and K8's int8 by plain loads,
// four per thread in flight before any is converted (four consecutive n
// per load when `vec`), K8's dequantized as `weight` does.
template <int BN, typename TW>
__device__ __forceinline__ void load_w(float* dst, const TW* w,
                                       const float* scales, const Geometry& g,
                                       int k0, int kend, int rows, int n0,
                                       bool vec) {
  constexpr int U = 4;
  const bool along_n = g.swn == 1 || g.swk != 1;
  if constexpr (std::is_same<TW, float>::value) {
    if (vec) {
      for (int e = threadIdx.x; e < rows * (BN / 4); e += THREADS) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int k = k0 + r, n = n0 + c;
        const bool in = k < kend && n < g.N;
        cp_async16(dst + r * BN + c, in ? w + k * g.swk + n : w, in);
      }
    } else {
      for (int e = threadIdx.x; e < rows * BN; e += THREADS) {
        const int r = along_n ? e / BN : e % rows;
        const int c = along_n ? e % BN : e / rows;
        const int k = k0 + r, n = n0 + c;
        const bool in = k < kend && n < g.N;
        cp_async4(dst + r * BN + c, in ? w + k * g.swk + n * g.swn : w, in);
      }
    }
  } else if (vec) {
    const int total = rows * (BN / 4);
    for (int base = threadIdx.x; base < total; base += THREADS * U) {
      float v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * THREADS;
        const int k = k0 + e / (BN / 4), n = n0 + (e % (BN / 4)) * 4;
        if (e < total && k < kend && n < g.N) load4(w + k * g.swk + n, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * THREADS;
        if (e >= total) break;
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int k = k0 + r, n = n0 + c;
        float o[4] = {0.f, 0.f, 0.f, 0.f};
        if (k < kend && n < g.N) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = std::is_same<TW, int8_t>::value
                       ? __fmul_rn(v[u][j], scales[n + j])
                       : v[u][j];
        }
        put4(dst + r * BN + c, o);
      }
    }
  } else {
    const int total = rows * BN;
    for (int base = threadIdx.x; base < total; base += THREADS * U) {
      TW v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * THREADS;
        const int r = along_n ? e / BN : e % rows;
        const int c = along_n ? e % BN : e / rows;
        const int k = k0 + r, n = n0 + c;
        v[u] = TW{};
        if (e < total && k < kend && n < g.N) v[u] = w[k * g.swk + n * g.swn];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * THREADS;
        if (e >= total) break;
        const int r = along_n ? e / BN : e % rows;
        const int c = along_n ? e % BN : e / rows;
        const int k = k0 + r, n = n0 + c;
        dst[r * BN + c] = (k < kend && n < g.N)
                              ? weight(v[u], scales ? scales[n] : 0.f)
                              : 0.f;
      }
    }
  }
}

// `depth` k (a multiple of 4) of x rows (pitch ldx) and w rows (pitch ldw)
// into the thread's TM x 4 micro-tile, k ascending. The thread's rows are
// tm + i * MT (MT threads along m, so a warp's float4 reads of x fall in
// distinct banks), its columns tn * 4 .. tn * 4 + 3.
template <int BN, int TM>
__device__ __forceinline__ void fma_rows(float (&acc)[TM][4],
                                         const float* xs, int ldx,
                                         const float* ws, int ldw, int tm,
                                         int tn, int depth) {
  constexpr int MT = THREADS / (BN / 4);
#pragma unroll 4
  for (int kk = 0; kk < depth; kk += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(xs + (tm + i * MT) * ldx + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b =
          *reinterpret_cast<const float4*>(ws + (kk + q) * ldw + tn * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float v = q == 0 ? a[i].x : q == 1 ? a[i].y
                      : q == 2 ? a[i].z : a[i].w;
        acc[i][0] = __fmaf_rn(v, b.x, acc[i][0]);
        acc[i][1] = __fmaf_rn(v, b.y, acc[i][1]);
        acc[i][2] = __fmaf_rn(v, b.z, acc[i][2]);
        acc[i][3] = __fmaf_rn(v, b.w, acc[i][3]);
      }
    }
  }
}

// The micro-tile from / to an (M, N) row-major array: float4 (or four
// packed bf16) per row when N % 4 == 0, else element by element.
template <int BN, int TM>
__device__ __forceinline__ void load_acc(float (&acc)[TM][4],
                                         const float* src, const Geometry& g,
                                         int m0, int n0, int tm, int tn,
                                         bool vec) {
  constexpr int MT = THREADS / (BN / 4);
  const int n = n0 + tn * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i * MT;
    const float* p = src + (long long)m * g.N + n;
    if (m < g.M && n < g.N && vec) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = (m < g.M && n + j < g.N) ? p[j] : 0.f;
    }
  }
}

template <int BN, int TM, typename TO>
__device__ __forceinline__ void store_acc(TO* dst, const float (&acc)[TM][4],
                                          const Geometry& g, int m0, int n0,
                                          int tm, int tn, bool vec) {
  constexpr int MT = THREADS / (BN / 4);
  const int n = n0 + tn * 4;
  if (n >= g.N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i * MT;
    if (m >= g.M) break;
    TO* p = dst + (long long)m * g.N + n;
    if (vec) {
      put4(p, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < g.N) put(p + j, acc[i][j]);
    }
  }
}

// Ring stage kt of K-chunk [k0, kend) for output tile (m0, n0): the
// streamed operand's BK-deep tile into its ring slot, and for
// input-stationary on the first pass (`stage`) x's tile into the resident
// chunk.
template <int BN, int TM, typename TX, typename TW>
__device__ __forceinline__ void issue_tile(float* xbuf, float* wbuf,
                                           const TX* x, const TW* w,
                                           const float* scales,
                                           const Geometry& g, const Plan& p,
                                           int k0, int kend, int kt, int m0,
                                           int n0, bool stage) {
  constexpr int BM = TM * THREADS / (BN / 4);
  const int kb = k0 + kt * BK;
  if (p.dataflow == INPUT_STATIONARY) {
    if (stage)
      load_x<THREADS>(xbuf + kt * BK, p.kc + 4, x, g, m0, kb, kend, BM, BK,
                      p.vec_x);
    load_w<BN>(wbuf + (kt % STAGES) * BK * BN, w, scales, g, kb, kend, BK,
               n0, p.vec_w);
  } else {
    load_x<THREADS, true>(xbuf + (kt % STAGES) * BM * LDX, LDX, x, g, m0, kb,
                          kend, BM, BK, p.vec_x);
  }
}

// K-chunk c of output tile (m0, n0) into acc: the streamed operand through
// the ring, STAGES - 1 tiles in flight while one is multiplied; the
// resident one staged on the way when `stage` (its first pass of the
// chunk), w with the ring's first tile.
template <int BN, int TM, typename TX, typename TW>
__device__ __forceinline__ void chunk_pass(float (&acc)[TM][4], float* xbuf,
                                           float* wbuf, const TX* x,
                                           const TW* w, const float* scales,
                                           const Geometry& g, const Plan& p,
                                           int c, int m0, int n0, bool stage,
                                           int tm, int tn) {
  constexpr int BM = TM * THREADS / (BN / 4);
  const bool xres = p.dataflow == INPUT_STATIONARY;
  const int k0 = c * p.kc, kend = min(g.K, k0 + p.kc);
  const int nk = (kend - k0 + BK - 1) / BK;
  __syncthreads();  // the previous pass no longer reads the buffers
  // step it issues tile it and multiplies tile kt = it - (STAGES - 1)
  for (int it = 0; it < nk + STAGES - 1; ++it) {
    const int kt = it - (STAGES - 1);
    if (kt >= 0) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // tile kt is in; tile kt - 1 is no longer read
    }
    if (it < nk)
      issue_tile<BN, TM>(xbuf, wbuf, x, w, scales, g, p, k0, kend, it, m0,
                         n0, stage);
    if (it == 0 && stage && !xres)
      load_w<BN>(wbuf, w, scales, g, k0, kend, nk * BK, n0, p.vec_w);
    cp_commit();
    if (kt >= 0) {
      const float* xs =
          xres ? xbuf + kt * BK : xbuf + (kt % STAGES) * BM * LDX;
      const float* ws =
          xres ? wbuf + (kt % STAGES) * BK * BN : wbuf + kt * BK * BN;
      fma_rows<BN, TM>(acc, xs, xres ? p.kc + 4 : LDX, ws, BN, tm, tn, BK);
    }
  }
}

// K7 in all three dataflows and, with TW = int8_t and per-column scales,
// K8 (output-stationary). Dynamic shared memory: the x ring (STAGES x BM x
// LDX) then the resident w chunk (kc x BN), or for input-stationary the
// resident x chunk (BM x (kc + 4)) then the w ring (STAGES x BK x BN).
template <int BN, int TM, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
    systolic_gemm_tiled(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ scales, float* acc_buf,
                        TX* out, Geometry g, Plan p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NT = BN / 4, MT = THREADS / NT, BM = TM * MT;
  const int tn = threadIdx.x % NT, tm = threadIdx.x / NT;
  const bool xres = p.dataflow == INPUT_STATIONARY;
  // output-stationary keeps its sums in registers across K-chunks (chunk
  // inner); weight- / input-stationary re-stream them through acc_buf
  // (out itself when out is f32) from one chunk to the next (chunk outer)
  const bool restream = p.dataflow != OUTPUT_STATIONARY;
  float* xbuf = smem;
  float* wbuf =
      smem + (xres ? BM * (p.kc + 4) : ring_slots(p.kc) * BM * LDX);
  const bool vec_out = (g.N & 3) == 0;
  const int mtiles = (g.M + BM - 1) / BM, ntiles = (g.N + BN - 1) / BN;
  const int chunks = (g.K + p.kc - 1) / p.kc;
  // the block's resident tile index and the tiles it sweeps
  const int fixed = xres ? blockIdx.x : blockIdx.y;
  const int t0 = (xres ? blockIdx.y : blockIdx.x) * p.group;
  const int nt = min(t0 + p.group, xres ? ntiles : mtiles) - t0;
  const int steps = nt * max(chunks, 1);  // K = 0: one step of zeros
  float acc[TM][4];
  for (int s = 0; s < steps; ++s) {
    const int t = t0 + (restream ? s % nt : s / max(chunks, 1));
    const int c = restream ? s / nt : s % max(chunks, 1);
    const int m0 = (xres ? fixed : t) * BM, n0 = (xres ? t : fixed) * BN;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    } else if (restream) {
      load_acc<BN, TM>(acc, acc_buf, g, m0, n0, tm, tn, vec_out);
    }
    if (chunks > 0)
      chunk_pass<BN, TM>(acc, xbuf, wbuf, x, w, scales, g, p, c, m0, n0,
                         t == t0 || (!restream && chunks > 1), tm, tn);
    if (c >= chunks - 1)
      store_acc<BN, TM>(out, acc, g, m0, n0, tm, tn, vec_out);
    else if (restream)
      store_acc<BN, TM>(acc_buf, acc, g, m0, n0, tm, tn, vec_out);
  }
}

// KT x 32 raw elements of w at (k0, n0) into a skinny ring stage, zeros
// past N and kend: 16-byte cp.async along n when `vec`; else fp32 by
// 4-byte cp.async and int8 / bf16 by plain loads.
template <typename TW>
__device__ __forceinline__ void load_w_raw(TW* dst, const TW* w,
                                           const Geometry& g, int k0,
                                           int kend, int n0, bool vec) {
  constexpr int KT = SK_STAGE_BYTES / (SK_COLS * (int)sizeof(TW));
  constexpr int PER16 = 16 / (int)sizeof(TW);
  if (vec) {
    for (int e = threadIdx.x; e < KT * SK_COLS / PER16; e += SK_THREADS) {
      const int r = e / (SK_COLS / PER16), c = (e % (SK_COLS / PER16)) * PER16;
      const int k = k0 + r, n = n0 + c;
      const bool in = k < kend && n < g.N;
      cp_async16(dst + r * SK_COLS + c, in ? w + k * g.swk + n : w, in);
    }
    return;
  }
  const bool along_n = g.swn == 1 || g.swk != 1;
  for (int e = threadIdx.x; e < KT * SK_COLS; e += SK_THREADS) {
    const int r = along_n ? e / SK_COLS : e % KT;
    const int c = along_n ? e % SK_COLS : e / KT;
    const int k = k0 + r, n = n0 + c;
    const bool in = k < kend && n < g.N;
    const TW* src = in ? w + k * g.swk + n * g.swn : w;
    if constexpr (std::is_same<TW, float>::value)
      cp_async4(dst + r * SK_COLS + c, src, in);
    else
      dst[r * SK_COLS + c] = in ? *src : TW{};
  }
}

// M <= 16 (K7 and K8): x's M x K-chunk resident as f32 (row pitch kc), w
// streamed raw through the ring and converted as it is read.
template <typename TX, typename TW>
__global__ void __launch_bounds__(SK_THREADS)
    systolic_gemm_skinny(const TX* __restrict__ x, const TW* __restrict__ w,
                         const float* __restrict__ scales,
                         TX* __restrict__ out, Geometry g, int kc, int vec_x,
                         int vec_w) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KT = SK_STAGE_BYTES / (SK_COLS * (int)sizeof(TW));
  constexpr int CH = SK_MAX_M / SK_WARPS;  // rows (chains) per lane
  TW* ring = reinterpret_cast<TW*>(smem);
  float* xs = smem + SK_STAGES * SK_STAGE_BYTES / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * SK_COLS, n = n0 + lane;
  const float sc = (scales != nullptr && n < g.N) ? scales[n] : 0.f;
  float acc[CH];
#pragma unroll
  for (int r = 0; r < CH; ++r) acc[r] = 0.f;
  const int chunks = (g.K + kc - 1) / kc;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kc, kend = min(g.K, k0 + kc);
    const int nk = (kend - k0 + KT - 1) / KT;
    __syncthreads();  // the previous chunk no longer reads the buffers
    for (int s = 0; s < SK_STAGES - 1; ++s) {
      if (s < nk)
        load_w_raw(ring + s * (KT * SK_COLS), w, g, k0 + s * KT, kend, n0,
                   vec_w);
      if (s == 0)
        load_x<SK_THREADS>(xs, kc, x, g, 0, k0, kend, g.M, nk * KT, vec_x);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<SK_STAGES - 2>();
      __syncthreads();
      const int next = kt + SK_STAGES - 1;
      if (next < nk)
        load_w_raw(ring + (next % SK_STAGES) * (KT * SK_COLS), w, g,
                   k0 + next * KT, kend, n0, vec_w);
      cp_commit();
      const TW* wt = ring + (kt % SK_STAGES) * (KT * SK_COLS);
      const float* xt = xs + kt * KT;
#pragma unroll 2
      for (int k = 0; k < KT; k += 4) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = weight(wt[(k + q) * SK_COLS + lane], sc);
#pragma unroll
        for (int r = 0; r < CH; ++r) {
          const int m = warp + r * SK_WARPS;
          if (m < g.M) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xt + m * kc + k);
            acc[r] = __fmaf_rn(xv.x, wv[0], acc[r]);
            acc[r] = __fmaf_rn(xv.y, wv[1], acc[r]);
            acc[r] = __fmaf_rn(xv.z, wv[2], acc[r]);
            acc[r] = __fmaf_rn(xv.w, wv[3], acc[r]);
          }
        }
      }
    }
  }
  if (n >= g.N) return;
#pragma unroll
  for (int r = 0; r < CH; ++r) {
    const int m = warp + r * SK_WARPS;
    if (m < g.M) put(out + (long long)m * g.N + n, acc[r]);
  }
}

// ------------------------------------------------------------------ split
// rows (k) x cols (m) of x at (m0, k0) as f32 into dst, k-major (row pitch
// `pitch`), zeros past kend: a ring stage of the split schedule. Columns
// past M are left as they are (only sums that are never stored read
// them). fp32 by cp.async: 16 bytes along m when `vec` (unit m stride, k
// stride and M multiples of 4, a 16-byte base: the backward's X^T of an
// im2col'd X with K % 4 == 0), else 4 bytes with consecutive threads along
// x's unit-stride axis; bf16 by plain loads.
template <typename TX>
__device__ __forceinline__ void load_xt(float* dst, int pitch, const TX* x,
                                        const Geometry& g, int m0, int k0,
                                        int kend, int rows, int cols,
                                        bool vec) {
  const int live = min(cols, g.M - m0);
  if constexpr (std::is_same<TX, float>::value) {
    if (vec) {
      const int c4 = live / 4;
      for (int e = threadIdx.x; e < rows * c4; e += THREADS) {
        const int r = e / c4, c = (e % c4) * 4;
        const int k = k0 + r;
        cp_async16(dst + r * pitch + c, x + (k < kend ? k * g.sxk : 0) +
                                            m0 + c, k < kend);
      }
      return;
    }
  }
  const bool along_m = g.sxm == 1 && g.sxk != 1;
  for (int e = threadIdx.x; e < rows * live; e += THREADS) {
    const int r = along_m ? e / live : e % rows;
    const int c = along_m ? e % live : e / rows;
    const int k = k0 + r, m = m0 + c;
    const bool in = k < kend;
    const TX* src = in ? x + m * g.sxm + k * g.sxk : x;
    if constexpr (std::is_same<TX, float>::value)
      cp_async4(dst + r * pitch + c, src, in);
    else
      dst[r * pitch + c] = in ? to_f32(*src) : 0.f;
  }
}

// Row i of the thread's split micro-tile: tm for TM = 1, else four
// consecutive rows per group of four, tm * 4 + i % 4 in group i / 4 (MT
// threads along m, so a warp's float4 reads of the k-major x tile are
// consecutive).
template <int BN, int TM>
__device__ __forceinline__ int split_row(int i, int tm) {
  constexpr int MT = THREADS / (BN / 4);
  return TM == 1 ? tm : (i / 4) * 4 * MT + tm * 4 + i % 4;
}

// A stage's k (split_bk<TM>()) of a k-major x tile (pitch ldm) and a w
// tile (pitch BN) into the thread's TM x 4 micro-tile, k ascending: per k
// one float4 of w and one float of x (TM = 1) or one float4 of x per four
// rows.
template <int BN, int TM>
__device__ __forceinline__ void fma_cols(float (&acc)[TM][4],
                                         const float* xs, int ldm,
                                         const float* ws, int tm, int tn) {
  constexpr int MT = THREADS / (BN / 4);
#pragma unroll 16
  for (int k = 0; k < split_bk<TM>(); ++k) {
    const float4 b = *reinterpret_cast<const float4*>(ws + k * BN + tn * 4);
    float a[TM];
    if constexpr (TM == 1) {
      a[0] = xs[k * ldm + tm];
    } else {
#pragma unroll
      for (int j = 0; j < TM / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + k * ldm + j * 4 * MT + tm * 4);
        a[4 * j] = v.x; a[4 * j + 1] = v.y;
        a[4 * j + 2] = v.z; a[4 * j + 3] = v.w;
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      acc[i][0] = __fmaf_rn(a[i], b.x, acc[i][0]);
      acc[i][1] = __fmaf_rn(a[i], b.y, acc[i][1]);
      acc[i][2] = __fmaf_rn(a[i], b.z, acc[i][2]);
      acc[i][3] = __fmaf_rn(a[i], b.w, acc[i][3]);
    }
  }
}

// The split schedule (K7 and K8): block (tile, s) runs its tile's FMA
// chains over reduction rows [s kc, min(K, (s + 1) kc)) in order and
// writes the partial tile to part[s] (each element of part once). Dynamic
// shared memory: SPLIT_STAGES ring stages, each a k-major x tile (SBK x
// (BM + 4)) then a w tile (SBK x BN), SBK = split_bk<TM>(). At most 128
// registers a thread, so that two blocks fit on an SM where their shared
// memory does.
template <int BN, int TM, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS, 2)
    systolic_gemm_split(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ scales,
                        float* __restrict__ part, Geometry g, Plan p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NT = BN / 4, MT = THREADS / NT, BM = TM * MT;
  constexpr int SBK = split_bk<TM>(), STAGES = SPLIT_STAGES;
  constexpr int LDM = BM + 4, STAGE = SBK * (LDM + BN);
  const int tn = threadIdx.x % NT, tm = threadIdx.x / NT;
  const int mtiles = (g.M + BM - 1) / BM;
  const int m0 = (blockIdx.x % mtiles) * BM, n0 = (blockIdx.x / mtiles) * BN;
  const int k0 = blockIdx.y * p.kc, kend = min(g.K, k0 + p.kc);
  const int nk = (kend - k0 + SBK - 1) / SBK;
  // a thread whose rows (or columns) all lie past the output only stages
  const int n = n0 + tn * 4;
  const bool live = m0 + split_row<BN, TM>(0, tm) < g.M && n < g.N;
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // step it issues tile it and multiplies tile kt = it - (STAGES - 1)
  for (int it = 0; it < nk + STAGES - 1; ++it) {
    const int kt = it - (STAGES - 1);
    if (kt >= 0) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // tile kt is in; tile kt - 1 is no longer read
    }
    if (it < nk) {
      float* st = smem + (it % STAGES) * STAGE;
      const int kb = k0 + it * SBK;
      load_xt(st, LDM, x, g, m0, kb, kend, SBK, BM, p.vec_x);
      load_w<BN>(st + SBK * LDM, w, scales, g, kb, kend, SBK, n0, p.vec_w);
    }
    cp_commit();
    if (kt >= 0 && live) {
      const float* st = smem + (kt % STAGES) * STAGE;
      fma_cols<BN, TM>(acc, st, LDM, st + SBK * LDM, tm, tn);
    }
  }
  if (!live) return;
  float* dst = part + (long long)blockIdx.y * g.M * g.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + split_row<BN, TM>(i, tm);
    if (m >= g.M) continue;
    float* q = dst + (long long)m * g.N + n;
    if ((g.N & 3) == 0) {
      put4(q, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < g.N) q[j] = acc[i][j];
    }
  }
}

// The split's second launch: out = part[0] + part[1] + ... + part[S - 1]
// for each of the M N elements, added in that order, then converted to
// out's type. A block takes SUM_COLS elements: its threads copy all S of
// their partials into shared memory at once (cp.async, so no thread waits
// on one load before the next), then one warp adds them, each lane its
// element's S in order. Dynamic shared memory: S x SUM_COLS floats.
template <typename TO>
__global__ void __launch_bounds__(THREADS)
    systolic_gemm_split_sum(const float* __restrict__ part,
                            TO* __restrict__ out, long long mn, int splits) {
  extern __shared__ __align__(16) float buf[];
  const long long e0 = (long long)blockIdx.x * SUM_COLS;
  const int lane = threadIdx.x % SUM_COLS;
  const bool in = e0 + lane < mn;
  for (int s = threadIdx.x / SUM_COLS; s < splits;
       s += THREADS / SUM_COLS)
    cp_async4(buf + s * SUM_COLS + lane, in ? part + s * mn + e0 + lane
                                            : part, in);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  if (threadIdx.x >= SUM_COLS || !in) return;
  float sum = buf[lane];
#pragma unroll 16
  for (int s = 1; s < splits; ++s)
    sum = __fadd_rn(sum, buf[s * SUM_COLS + lane]);
  put(out + e0 + lane, sum);
}

// ------------------------------------------------------------------- wide
// All of w (K x N; zeros past K, up to kc rows, and past N) as f32 into
// N-panels of kc x BN at row pitch BN + 4 (panel j holds columns j BN ..),
// four consecutive n per thread and step, stored as one float4, U steps'
// loads in flight before any is stored. Threads run along w's unit-stride
// axis, so the loads coalesce (the backward's W^T runs along k), and
// neither these stores nor the FMA's float4 reads of a row meet a bank
// conflict. Four n by one vector load when `vec`; K8's dequantized as
// `weight` does.
template <int BN, typename TW>
__device__ __forceinline__ void load_w_panels(float* dst, const TW* w,
                                              const float* scales,
                                              const Geometry& g, int kc,
                                              bool vec) {
  constexpr int LDW = BN + 4, C4 = BN / 4, U = 4;
  const int groups = (g.N + BN - 1) / BN * C4;  // float4 columns
  const int total = kc * groups;
  const bool along_n = g.swn == 1 || g.swk != 1;
  for (int base = threadIdx.x; base < total; base += THREADS * U) {
    float v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * THREADS;
      const int k = along_n ? e / groups : e % kc;
      const int n = (along_n ? e % groups : e / kc) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[u][j] = 0.f;
      if (e >= total || k >= g.K || n >= g.N) continue;
      if (vec) {
        load4(w + k * g.swk + n, v[u]);
        if constexpr (std::is_same<TW, int8_t>::value) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[u][j] = __fmul_rn(v[u][j], scales[n + j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < g.N)
            v[u][j] = weight(w[k * g.swk + (n + j) * g.swn],
                             scales ? scales[n + j] : 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * THREADS;
      if (e >= total) break;
      const int k = along_n ? e / groups : e % kc;
      const int q = along_n ? e % groups : e / kc;
      put4(dst + (q / C4) * kc * LDW + k * LDW + (q % C4) * 4, v[u]);
    }
  }
}

// The wide schedule (K7 and K8): the block stages all of w once, then
// sweeps its `group` M-tiles: x's BM x kc rows (pitch kc + 4)
// double-buffered, the next tile's copy in flight while the current one is
// multiplied with every N-panel in turn and its whole output rows are
// written. Dynamic shared memory: the panels (ceil(N / BN) x kc x (BN + 4))
// then two x tiles.
template <int BN, int TM, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
    systolic_gemm_wide(const TX* __restrict__ x, const TW* __restrict__ w,
                       const float* __restrict__ scales, TX* __restrict__ out,
                       Geometry g, Plan p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NT = BN / 4, MT = THREADS / NT, BM = TM * MT;
  const int tn = threadIdx.x % NT, tm = threadIdx.x / NT;
  const int ntiles = (g.N + BN - 1) / BN, mtiles = (g.M + BM - 1) / BM;
  const int ldx = p.kc + 4, panel = p.kc * (BN + 4);
  float* xbuf = smem + ntiles * panel;
  const int t0 = blockIdx.x * p.group, t1 = min(mtiles, t0 + p.group);
  const bool vec_out = (g.N & 3) == 0;
  load_x<THREADS>(xbuf, ldx, x, g, t0 * BM, 0, g.K, BM, p.kc, p.vec_x);
  cp_commit();
  load_w_panels<BN>(smem, w, scales, g, p.kc, p.vec_w);
  for (int t = t0; t < t1; ++t) {
    const float* xs = xbuf + ((t - t0) & 1) * BM * ldx;
    if (t + 1 < t1)
      load_x<THREADS>(xbuf + ((t + 1 - t0) & 1) * BM * ldx, ldx, x, g,
                      (t + 1) * BM, 0, g.K, BM, p.kc, p.vec_x);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // tile t (and, at the first, w) is in
    for (int j = 0; j < ntiles; ++j) {
      float acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
      fma_rows<BN, TM>(acc, xs, ldx, smem + j * panel, BN + 4, tm, tn, p.kc);
      store_acc<BN, TM>(out, acc, g, t * BM, j * BN, tm, tn, vec_out);
    }
    __syncthreads();  // tile t is no longer read: its buffer takes t + 2
  }
}

// ------------------------------------------------------------------ host
int skinny_rows_per_stage(int w_bytes) {
  return SK_STAGE_BYTES / (SK_COLS * w_bytes);
}

int block_rows(const Plan& p) { return p.tm * THREADS / (p.bn / 4); }

int tiled_smem(const Plan& p) {
  const int bm = block_rows(p);
  if (p.dataflow == INPUT_STATIONARY)
    return 4 * (bm * (p.kc + 4) + ring_slots(p.kc) * BK * p.bn);
  return 4 * (ring_slots(p.kc) * bm * LDX + p.kc * p.bn);
}

int split_smem(const Plan& p) {
  const int sbk = p.tm == 1 ? split_bk<1>() : split_bk<4>();
  return 4 * SPLIT_STAGES * sbk * (block_rows(p) + 4 + p.bn);
}

long long wide_smem(const Geometry& g, const Plan& p) {
  return 4LL * ((g.N + p.bn - 1) / p.bn * (long long)p.kc * (p.bn + 4) +
                2LL * block_rows(p) * (p.kc + 4));
}

int skinny_smem(int M, int kc) {
  return SK_STAGES * SK_STAGE_BYTES + 4 * M * kc;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan against what the kernels assume; cudaErrorInvalidValue if not.
cudaError_t check_plan(const Geometry& g, const Plan& p, int schedule,
                       int x_bytes, int w_bytes, const void* x,
                       const void* w, const float* part) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (g.M < 1 || g.N < 1 || g.K < 0 || p.group < 1 || p.dataflow < 0 ||
      p.dataflow > INPUT_STATIONARY || schedule < TILED || schedule > WIDE)
    return bad;
  if (schedule == SPLIT) {
    // x: 16-byte cp.async along m needs fp32, a unit m stride, a k stride
    // and M that are multiples of 4 and a 16-byte base
    if (p.vec_x && (x_bytes != 4 || g.sxm != 1 || g.sxk % 4 != 0 ||
                    g.M % 4 != 0 || !aligned(x, 16)))
      return bad;
  } else if (p.vec_x && (x_bytes != 4 || g.sxk != 1 || g.K % 4 != 0 ||
                         g.sxm % 4 != 0 || !aligned(x, 16))) {
    // x: 16-byte cp.async along k needs fp32, unit k stride, K % 4 == 0
    // and 16-byte rows
    return bad;
  }
  if (schedule == SKINNY) {
    const int kt = skinny_rows_per_stage(w_bytes);
    if (g.M > SK_MAX_M || p.kc < kt || p.kc % kt != 0 ||
        skinny_smem(g.M, p.kc) > SMEM_MAX)
      return bad;
    if (p.vec_w && (g.swn != 1 || g.N % (16 / w_bytes) != 0 ||
                    (g.swk * w_bytes) % 16 != 0 || !aligned(w, 16)))
      return bad;
    return cudaSuccess;
  }
  if ((p.bn != 16 && p.bn != 32 && p.bn != 64) ||
      (p.tm != 8 && p.tm != 4 && p.tm != 1) || (x_bytes != 4 && p.tm != 1) ||
      p.kc < BK || p.kc % BK != 0)
    return bad;
  // w: four consecutive n in one aligned load
  if (p.vec_w && (g.swn != 1 || g.N % 4 != 0 || g.swk % 4 != 0 ||
                  !aligned(w, 4 * w_bytes)))
    return bad;
  if (schedule == SPLIT) {
    // a partial per range in part; the grid is (tiles, ranges)
    const long long tiles = (long long)((g.M + block_rows(p) - 1) /
                                        block_rows(p)) *
                            ((g.N + p.bn - 1) / p.bn);
    // the sum's partials of SUM_COLS elements fit its default 48 KB
    const int splits = (g.K + p.kc - 1) / p.kc;
    if (part == nullptr || g.K < 1 || split_smem(p) > SMEM_MAX ||
        splits * SUM_COLS * 4 > 48 * 1024 || tiles > 0x7fffffff)
      return bad;
    return cudaSuccess;
  }
  if (schedule == WIDE)  // all of w resident: kc covers K
    return g.K <= p.kc && wide_smem(g, p) <= SMEM_MAX ? cudaSuccess : bad;
  if (tiled_smem(p) > SMEM_MAX || (g.N + p.bn - 1) / p.bn > 65535)
    return bad;
  return cudaSuccess;
}

template <int BN, int TM, typename TX, typename TW>
cudaError_t launch_tiled(const TX* x, const TW* w, const float* scales,
                         float* acc, TX* out, const Geometry& g,
                         const Plan& p, cudaStream_t s) {
  constexpr int BM = TM * THREADS / (BN / 4);
  static const cudaError_t ready = cudaFuncSetAttribute(
      systolic_gemm_tiled<BN, TM, TX, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (ready != cudaSuccess) return ready;
  const int mt = (g.M + BM - 1) / BM, nt = (g.N + BN - 1) / BN;
  const dim3 grid = p.dataflow == INPUT_STATIONARY
                        ? dim3(mt, (nt + p.group - 1) / p.group)
                        : dim3((mt + p.group - 1) / p.group, nt);
  systolic_gemm_tiled<BN, TM, TX, TW><<<grid, THREADS, tiled_smem(p), s>>>(
      x, w, scales, acc, out, g, p);
  return cudaGetLastError();
}

// The split schedule's two launches: the partials into part, their sum.
template <int BN, int TM, typename TX, typename TW>
cudaError_t launch_split(const TX* x, const TW* w, const float* scales,
                         float* part, TX* out, const Geometry& g,
                         const Plan& p, cudaStream_t s) {
  constexpr int BM = TM * THREADS / (BN / 4);
  static const cudaError_t ready = cudaFuncSetAttribute(
      systolic_gemm_split<BN, TM, TX, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (ready != cudaSuccess) return ready;
  const int tiles = (g.M + BM - 1) / BM * ((g.N + BN - 1) / BN);
  const int splits = (g.K + p.kc - 1) / p.kc;
  systolic_gemm_split<BN, TM, TX, TW>
      <<<dim3(tiles, splits), THREADS, split_smem(p), s>>>(x, w, scales, part,
                                                            g, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long mn = (long long)g.M * g.N;
  systolic_gemm_split_sum<TX>
      <<<(unsigned)((mn + SUM_COLS - 1) / SUM_COLS), THREADS,
         splits * SUM_COLS * 4, s>>>(part, out, mn, splits);
  return cudaGetLastError();
}

template <int BN, int TM, typename TX, typename TW>
cudaError_t launch_wide(const TX* x, const TW* w, const float* scales,
                        TX* out, const Geometry& g, const Plan& p,
                        cudaStream_t s) {
  constexpr int BM = TM * THREADS / (BN / 4);
  static const cudaError_t ready = cudaFuncSetAttribute(
      systolic_gemm_wide<BN, TM, TX, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (ready != cudaSuccess) return ready;
  const int mt = (g.M + BM - 1) / BM;
  systolic_gemm_wide<BN, TM, TX, TW>
      <<<(mt + p.group - 1) / p.group, THREADS, (int)wide_smem(g, p), s>>>(
          x, w, scales, out, g, p);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const TX* x, const TW* w, const float* scales, float* acc,
                   TX* out, const Geometry& g, const Plan& p, int schedule,
                   cudaStream_t s) {
  const cudaError_t err = check_plan(g, p, schedule, sizeof(TX), sizeof(TW),
                                     x, w, acc);
  if (err != cudaSuccess) return err;
  if (schedule == SKINNY) {
    static const cudaError_t ready = cudaFuncSetAttribute(
        systolic_gemm_skinny<TX, TW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (ready != cudaSuccess) return ready;
    systolic_gemm_skinny<TX, TW><<<(g.N + SK_COLS - 1) / SK_COLS,
                                   SK_THREADS, skinny_smem(g.M, p.kc), s>>>(
        x, w, scales, out, g, p.kc, p.vec_x, p.vec_w);
    return cudaGetLastError();
  }
#define REPRO_TILE(BN_, TM_)                                               \
  if (p.bn == BN_ && p.tm == TM_) {                                        \
    if (schedule == SPLIT)                                                 \
      return launch_split<BN_, TM_>(x, w, scales, acc, out, g, p, s);      \
    if (schedule == WIDE)                                                  \
      return launch_wide<BN_, TM_>(x, w, scales, out, g, p, s);            \
    return launch_tiled<BN_, TM_>(x, w, scales, acc, out, g, p, s);        \
  }
  // bf16 x (off the timed paths) is built for TM = 1 only
  if constexpr (std::is_same<TX, float>::value) {
    REPRO_TILE(16, 8) REPRO_TILE(16, 4)
    REPRO_TILE(32, 8) REPRO_TILE(32, 4)
    REPRO_TILE(64, 8) REPRO_TILE(64, 4)
  }
  REPRO_TILE(16, 1) REPRO_TILE(32, 1) REPRO_TILE(64, 1)
#undef REPRO_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// K7. x (M, K) and w (K, N) through element strides (sxm, sxk), (swk, swn);
// out (M, N) contiguous; all fp32 (bf16 = 0) or all bf16 (bf16 = 1).
// acc is f32 scratch: under the split schedule the (S, M, N) partials;
// under the tiled one the weight-/input-stationary running sum (M, N)
// between K-chunks (out itself when out is fp32; unused with one chunk).
// The plan (schedule, bn, tm, kc, group, vec_x, vec_w) is kernels/matmul.py
// tile_plan's. Launches on `stream` (two kernels under split) and returns
// 0, cudaErrorInvalidValue for a plan the kernels cannot run, or
// cudaGetLastError().
extern "C" int repro_matmul(const void* x, const void* w, float* acc,
                            void* out, int M, int K, int N, long long sxm,
                            long long sxk, long long swk, long long swn,
                            int bf16, int dataflow, int schedule, int bn,
                            int tm, int kc, int group, int vec_x, int vec_w,
                            void* stream) {
  const Geometry g{M, K, N, sxm, sxk, swk, swn};
  const Plan p{dataflow, bn, tm, kc, group, vec_x, vec_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(w),
                       static_cast<const float*>(nullptr), acc,
                       static_cast<__nv_bfloat16*>(out), g, p, schedule, s);
  return (int)launch(static_cast<const float*>(x),
                     static_cast<const float*>(w),
                     static_cast<const float*>(nullptr), acc,
                     static_cast<float*>(out), g, p, schedule, s);
}

// K8. x (M, K) fp32 or bf16 through strides (sxm, sxk); w_q (K, N) int8
// through (swk, swn); scales (N,) f32 contiguous; part the split
// schedule's f32 (S, M, N) partials (else unused); out (M, N) contiguous in
// x's type. Output-stationary; otherwise as repro_matmul.
extern "C" int repro_quant_matmul(const void* x, const int8_t* w_q,
                                  const float* scales, float* part, void* out,
                                  int M, int K, int N, long long sxm,
                                  long long sxk, long long swk, long long swn,
                                  int bf16, int schedule, int bn, int tm,
                                  int kc, int group, int vec_x, int vec_w,
                                  void* stream) {
  if (scales == nullptr) return (int)cudaErrorInvalidValue;
  const Geometry g{M, K, N, sxm, sxk, swk, swn};
  const Plan p{OUTPUT_STATIONARY, bn, tm, kc, group, vec_x, vec_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch(static_cast<const __nv_bfloat16*>(x), w_q, scales,
                       part, static_cast<__nv_bfloat16*>(out), g, p,
                       schedule, s);
  return (int)launch(static_cast<const float*>(x), w_q, scales, part,
                     static_cast<float*>(out), g, p, schedule, s);
}
