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
// im2col'd x; at large square shapes the fp32 FMAs. The math is plain fp32
// FMA in registers, no tensor cores and no TF32, because fp32 is what the
// reference holds; bf16 inputs are converted to f32 as they are staged.
//
// Design. The TPU grid runs in order on one core and carries the tile's
// accumulator in VMEM scratch (output-stationary) or in the revisited output
// block (weight-/input-stationary) from one grid step to the next. Here
// one block of 256 threads computes a 64 x 64 output tile, walking K in
// 16-deep tiles staged in shared memory; each thread keeps a 4 x 4
// register micro-tile of accumulators. All three dimensions are ragged:
// out-of-range elements are staged as 0 and never stored.
//   output-stationary: a block owns one output tile and walks K with its
//     accumulators in registers (_os_kernel).
//   weight-stationary: a block owns one N-tile and a group of M-tiles. For
//     each K-tile it stages the weight tile once and sweeps its M-tiles,
//     reading each output tile's running sum from global memory and writing
//     it back (the output re-streaming _acc_kernel pays).
//   input-stationary: the same with M and N swapped.
// Every output element is written by exactly one block, and each thread
// carries one element's sum as a single FMA chain over k = 0, 1, ..., K-1
// in every dataflow, so the three dataflows give the same bits and no
// result depends on scheduling (no float atomics). K8 is the
// output-stationary body with the weight tile staged as int8 and
// dequantized on the way into registers in the TPU order: w = float(q) *
// scale[n] per element, then the FMA with x (the scale is not moved out of
// the sum, which would round differently). Double-buffered cp.async/TMA
// staging, wgmma, and a tile sized for N <= 64 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;          // 16 x 16 threads
constexpr int TM = BM / 16, TN = BN / 16;
constexpr int XS_LD = BM + 1;         // x tile stored k-major, padded row

enum Dataflow { OUTPUT_STATIONARY = 0, WEIGHT_STATIONARY = 1,
                INPUT_STATIONARY = 2 };

struct Geometry {
  int M, K, N;
  long long sxm, sxk, swk, swn;       // element strides of x and w
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The (BM x BK) tile of x at (m0, k0), as f32, k-major. Consecutive threads
// take consecutive addresses along x's unit-stride axis.
template <typename TX>
__device__ __forceinline__ void stage_x(float* xs, const TX* x,
                                        const Geometry& g, int m0, int k0) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    int r, c;
    if (g.sxk == 1) { r = e / BK; c = e % BK; } else { r = e % BM; c = e / BM; }
    const int m = m0 + r, k = k0 + c;
    xs[c * XS_LD + r] =
        (m < g.M && k < g.K)
            ? to_f32(x[(long long)m * g.sxm + (long long)k * g.sxk])
            : 0.f;
  }
}

// The (BK x BN) tile of w at (k0, n0): f32 for K7, int8 as stored for K8.
template <typename TW, typename TS>
__device__ __forceinline__ void stage_w(TS* ws, const TW* w,
                                        const Geometry& g, int k0, int n0) {
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    int r, c;
    if (g.swn == 1) { r = e / BN; c = e % BN; } else { r = e % BK; c = e / BK; }
    const int k = k0 + r, n = n0 + c;
    const bool in = k < g.K && n < g.N;
    const long long at = (long long)k * g.swk + (long long)n * g.swn;
    if constexpr (std::is_same<TS, int8_t>::value)
      ws[r * BN + c] = in ? w[at] : int8_t(0);
    else
      ws[r * BN + c] = in ? to_f32(w[at]) : 0.f;
  }
}

// One K-tile into the thread's micro-tile, k ascending.
template <typename TS>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN],
                                         const float* xs, const TS* ws,
                                         const float (&sc)[TN], int ty,
                                         int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = xs[k * XS_LD + ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if constexpr (std::is_same<TS, int8_t>::value)
        b[j] = __fmul_rn((float)ws[k * BN + tx * TN + j], sc[j]);
      else
        b[j] = ws[k * BN + tx * TN + j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void load_tile(float (&acc)[TM][TN],
                                          const float* buf, int M, int N,
                                          int m0, int n0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      acc[i][j] = (m < M && n < N) ? buf[(long long)m * N + n] : 0.f;
    }
  }
}

template <typename TO>
__device__ __forceinline__ void store_tile(TO* out,
                                           const float (&acc)[TM][TN], int M,
                                           int N, int m0, int n0, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) put(out + (long long)m * N + n, acc[i][j]);
    }
  }
}

// Output-stationary (K7) and, with TS = int8_t and per-column scales, K8.
template <typename TX, typename TW, typename TS>
__global__ void __launch_bounds__(THREADS)
    gemm_os(const TX* __restrict__ x, const TW* __restrict__ w,
            const float* __restrict__ scales, TX* __restrict__ out,
            Geometry g) {
  __shared__ float xs[BK * XS_LD];
  __shared__ TS ws[BK * BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float sc[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx * TN + j;
    sc[j] = (scales != nullptr && n < g.N) ? scales[n] : 0.f;
  }
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < g.K; k0 += BK) {
    stage_x(xs, x, g, m0, k0);
    stage_w(ws, w, g, k0, n0);
    __syncthreads();
    fma_tile(acc, xs, ws, sc, ty, tx);
    __syncthreads();
  }
  store_tile(out, acc, g.M, g.N, m0, n0, ty, tx);
}

// Weight-stationary (STATIONARY_W) or input-stationary: the block keeps one
// operand's K-tile staged while it sweeps `group` tiles of the other,
// re-streaming each output tile's running f32 sum through `acc_buf` (which
// is `out` itself when out is f32); the last K-tile writes `out`.
template <typename TX, bool STATIONARY_W>
__global__ void __launch_bounds__(THREADS)
    gemm_acc(const TX* __restrict__ x, const TX* __restrict__ w,
             float* acc_buf, TX* out, Geometry g, int group) {
  __shared__ float xs[BK * XS_LD];
  __shared__ float ws[BK * BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float sc[TN] = {};
  const int mtiles = (g.M + BM - 1) / BM, ntiles = (g.N + BN - 1) / BN;
  const int ktiles = g.K > 0 ? (g.K + BK - 1) / BK : 1;
  // the resident tile index and the swept range
  const int fixed = STATIONARY_W ? blockIdx.y : blockIdx.x;
  const int t0 = (STATIONARY_W ? blockIdx.x : blockIdx.y) * group;
  const int t1 = min(t0 + group, STATIONARY_W ? mtiles : ntiles);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * BK;
    if (STATIONARY_W) stage_w(ws, w, g, k0, fixed * BN);
    else stage_x(xs, x, g, fixed * BM, k0);
    for (int t = t0; t < t1; ++t) {
      const int m0 = STATIONARY_W ? t * BM : fixed * BM;
      const int n0 = STATIONARY_W ? fixed * BN : t * BN;
      if (STATIONARY_W) stage_x(xs, x, g, m0, k0);
      else stage_w(ws, w, g, k0, n0);
      __syncthreads();
      float acc[TM][TN];
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      } else {
        load_tile(acc, acc_buf, g.M, g.N, m0, n0, ty, tx);
      }
      fma_tile(acc, xs, ws, sc, ty, tx);
      if (kt == ktiles - 1) store_tile(out, acc, g.M, g.N, m0, n0, ty, tx);
      else store_tile(acc_buf, acc, g.M, g.N, m0, n0, ty, tx);
      __syncthreads();
    }
  }
}

template <typename TX>
int launch_matmul(const TX* x, const TX* w, float* acc_buf, TX* out,
                  const Geometry& g, int dataflow, int group,
                  cudaStream_t s) {
  const int mt = (g.M + BM - 1) / BM, nt = (g.N + BN - 1) / BN;
  if (group < 1) return (int)cudaErrorInvalidValue;
  switch (dataflow) {
    case OUTPUT_STATIONARY:
      gemm_os<TX, TX, float><<<dim3(mt, nt), THREADS, 0, s>>>(
          x, w, nullptr, out, g);
      break;
    case WEIGHT_STATIONARY:
      gemm_acc<TX, true><<<dim3((mt + group - 1) / group, nt), THREADS, 0,
                           s>>>(x, w, acc_buf, out, g, group);
      break;
    case INPUT_STATIONARY:
      gemm_acc<TX, false><<<dim3(mt, (nt + group - 1) / group), THREADS, 0,
                            s>>>(x, w, acc_buf, out, g, group);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K7. x (M, K) and w (K, N) through element strides (sxm, sxk), (swk, swn);
// out (M, N) contiguous; all fp32 (bf16 = 0) or all bf16 (bf16 = 1).
// acc (M, N) f32 is the weight-/input-stationary running sum (out itself
// when out is fp32; unused by output-stationary); group = tiles of the
// swept operand per block. M, N >= 1 and N <= 65535 * 64. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int repro_matmul(const void* x, const void* w, float* acc,
                            void* out, int M, int K, int N, long long sxm,
                            long long sxk, long long swk, long long swn,
                            int bf16, int dataflow, int group, void* stream) {
  const Geometry g{M, K, N, sxm, sxk, swk, swn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_matmul(static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(w), acc,
                         static_cast<__nv_bfloat16*>(out), g, dataflow, group,
                         s);
  return launch_matmul(static_cast<const float*>(x),
                       static_cast<const float*>(w), acc,
                       static_cast<float*>(out), g, dataflow, group, s);
}

// K8. x (M, K) fp32 or bf16 through strides (sxm, sxk); w_q (K, N) int8
// through (swk, swn); scales (N,) f32 contiguous; out (M, N) contiguous in
// x's type. Output-stationary; otherwise as repro_matmul.
extern "C" int repro_quant_matmul(const void* x, const int8_t* w_q,
                                  const float* scales, void* out, int M,
                                  int K, int N, long long sxm, long long sxk,
                                  long long swk, long long swn, int bf16,
                                  void* stream) {
  if (scales == nullptr) return (int)cudaErrorInvalidValue;
  const Geometry g{M, K, N, sxm, sxk, swk, swn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (bf16)
    gemm_os<__nv_bfloat16, int8_t, int8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w_q, scales,
        static_cast<__nv_bfloat16*>(out), g);
  else
    gemm_os<float, int8_t, int8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), w_q, scales, static_cast<float*>(out),
        g);
  return (int)cudaGetLastError();
}
