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
// N = 64 and K = 576 the fp32 FMAs. The math is plain fp32 FMA in
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
// the largest TM whose grid still fills the card).
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
// Every output element is written by exactly one block, and one thread
// carries its sum as a single FMA chain that starts at 0.f and runs over
// k = 0, 1, ..., K-1 in order in every schedule (zero-padded k past K adds
// only 0 * 0), so all dataflows and schedules give the same bits and no
// result depends on scheduling (no split-K, no float atomics). K8's weight
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

enum Dataflow { OUTPUT_STATIONARY = 0, WEIGHT_STATIONARY = 1,
                INPUT_STATIONARY = 2 };

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

// `depth` k (a multiple of 4) of x rows (pitch ldx) and w rows (pitch BN)
// into the thread's TM x 4 micro-tile, k ascending. The thread's rows are
// tm + i * MT (MT threads along m, so a warp's float4 reads of x fall in
// distinct banks), its columns tn * 4 .. tn * 4 + 3.
template <int BN, int TM>
__device__ __forceinline__ void fma_rows(float (&acc)[TM][4],
                                         const float* xs, int ldx,
                                         const float* ws, int tm, int tn,
                                         int depth) {
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
          *reinterpret_cast<const float4*>(ws + (kk + q) * BN + tn * 4);
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
      fma_rows<BN, TM>(acc, xs, xres ? p.kc + 4 : LDX, ws, tm, tn, BK);
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

// ------------------------------------------------------------------ host
int skinny_rows_per_stage(int w_bytes) {
  return SK_STAGE_BYTES / (SK_COLS * w_bytes);
}

int tiled_smem(const Plan& p) {
  const int bm = p.tm * THREADS / (p.bn / 4);
  if (p.dataflow == INPUT_STATIONARY)
    return 4 * (bm * (p.kc + 4) + ring_slots(p.kc) * BK * p.bn);
  return 4 * (ring_slots(p.kc) * bm * LDX + p.kc * p.bn);
}

int skinny_smem(int M, int kc) {
  return SK_STAGES * SK_STAGE_BYTES + 4 * M * kc;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan against what the kernels assume; cudaErrorInvalidValue if not.
cudaError_t check_plan(const Geometry& g, const Plan& p, int skinny,
                       int x_bytes, int w_bytes, const void* x,
                       const void* w) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (g.M < 1 || g.N < 1 || g.K < 0 || p.group < 1 || p.dataflow < 0 ||
      p.dataflow > INPUT_STATIONARY)
    return bad;
  // x: 16-byte cp.async along k needs fp32, unit k stride, K % 4 == 0 and
  // 16-byte rows
  if (p.vec_x && (x_bytes != 4 || g.sxk != 1 || g.K % 4 != 0 ||
                  g.sxm % 4 != 0 || !aligned(x, 16)))
    return bad;
  if (skinny) {
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
      p.kc < BK || p.kc % BK != 0 || tiled_smem(p) > SMEM_MAX)
    return bad;
  // w: four consecutive n in one aligned load
  if (p.vec_w && (g.swn != 1 || g.N % 4 != 0 || g.swk % 4 != 0 ||
                  !aligned(w, 4 * w_bytes)))
    return bad;
  if ((g.N + p.bn - 1) / p.bn > 65535) return bad;
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

template <typename TX, typename TW>
cudaError_t launch(const TX* x, const TW* w, const float* scales, float* acc,
                   TX* out, const Geometry& g, const Plan& p, int skinny,
                   cudaStream_t s) {
  const cudaError_t err = check_plan(g, p, skinny, sizeof(TX), sizeof(TW),
                                     x, w);
  if (err != cudaSuccess) return err;
  if (skinny) {
    static const cudaError_t ready = cudaFuncSetAttribute(
        systolic_gemm_skinny<TX, TW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (ready != cudaSuccess) return ready;
    systolic_gemm_skinny<TX, TW><<<(g.N + SK_COLS - 1) / SK_COLS,
                                   SK_THREADS, skinny_smem(g.M, p.kc), s>>>(
        x, w, scales, out, g, p.kc, p.vec_x, p.vec_w);
    return cudaGetLastError();
  }
#define REPRO_TILED(BN_, TM_)                                              \
  if (p.bn == BN_ && p.tm == TM_)                                          \
    return launch_tiled<BN_, TM_>(x, w, scales, acc, out, g, p, s);
  // bf16 x (off the timed paths) is built for TM = 1 only
  if constexpr (std::is_same<TX, float>::value) {
    REPRO_TILED(16, 8) REPRO_TILED(16, 4)
    REPRO_TILED(32, 8) REPRO_TILED(32, 4)
    REPRO_TILED(64, 8) REPRO_TILED(64, 4)
  }
  REPRO_TILED(16, 1) REPRO_TILED(32, 1) REPRO_TILED(64, 1)
#undef REPRO_TILED
  return cudaErrorInvalidValue;
}

}  // namespace

// K7. x (M, K) and w (K, N) through element strides (sxm, sxk), (swk, swn);
// out (M, N) contiguous; all fp32 (bf16 = 0) or all bf16 (bf16 = 1).
// acc (M, N) f32 is the weight-/input-stationary running sum between
// K-chunks (out itself when out is fp32; unused with one chunk). The plan
// (skinny, bn, tm, kc, group, vec_x, vec_w) is kernels/matmul.py
// tile_plan's. Launches on `stream` and returns 0, cudaErrorInvalidValue
// for a plan the kernels cannot run, or cudaGetLastError().
extern "C" int repro_matmul(const void* x, const void* w, float* acc,
                            void* out, int M, int K, int N, long long sxm,
                            long long sxk, long long swk, long long swn,
                            int bf16, int dataflow, int skinny, int bn,
                            int tm, int kc, int group, int vec_x, int vec_w,
                            void* stream) {
  const Geometry g{M, K, N, sxm, sxk, swk, swn};
  const Plan p{dataflow, bn, tm, kc, group, vec_x, vec_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(w),
                       static_cast<const float*>(nullptr), acc,
                       static_cast<__nv_bfloat16*>(out), g, p, skinny, s);
  return (int)launch(static_cast<const float*>(x),
                     static_cast<const float*>(w),
                     static_cast<const float*>(nullptr), acc,
                     static_cast<float*>(out), g, p, skinny, s);
}

// K8. x (M, K) fp32 or bf16 through strides (sxm, sxk); w_q (K, N) int8
// through (swk, swn); scales (N,) f32 contiguous; out (M, N) contiguous in
// x's type. Output-stationary; otherwise as repro_matmul.
extern "C" int repro_quant_matmul(const void* x, const int8_t* w_q,
                                  const float* scales, void* out, int M,
                                  int K, int N, long long sxm, long long sxk,
                                  long long swk, long long swn, int bf16,
                                  int skinny, int bn, int tm, int kc,
                                  int group, int vec_x, int vec_w,
                                  void* stream) {
  if (scales == nullptr) return (int)cudaErrorInvalidValue;
  const Geometry g{M, K, N, sxm, sxk, swk, swn};
  const Plan p{OUTPUT_STATIONARY, bn, tm, kc, group, vec_x, vec_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch(static_cast<const __nv_bfloat16*>(x), w_q, scales,
                       static_cast<float*>(nullptr),
                       static_cast<__nv_bfloat16*>(out), g, p, skinny, s);
  return (int)launch(static_cast<const float*>(x), w_q, scales,
                     static_cast<float*>(nullptr), static_cast<float*>(out),
                     g, p, skinny, s);
}
