// The two linear recurrences of the recurrent families in fp32, written for
// Hopper (sm_90a): the RWKV6 wkv scan (K5) and the mamba selective scan
// (K6).
//
// K5 replaces repro/kernels/linear_scan.py::_wkv6_kernel, the Pallas TPU
// kernel behind ops.wkv6. Per batch row b and head h, with the (N, N)
// state S (row i = key channel, column j = value channel), every time
// step t computes
//     kv[i][j] = k[i] * v[j]
//     y[j]     = sum_i r[i] * (S[i][j] + u[i] * kv[i][j])
//     S[i][j]  = w[i] * S[i][j] + kv[i][j]
// in that order per element (ref.wkv6). The TPU kernel walks T in chunks
// along a sequential grid axis with S in VMEM and a log-space closed form
// inside each chunk; that form exists for the TPU's matrix unit and costs
// exps of differences the plain recurrence does not need, so it is not
// carried over: a loop over t inside the block takes the place of the
// sequential grid axis.
//
// K5 bound. Bytes: r, k, v, w and y move once (4 B * B*T*H*N each), s0
// and sT once (4 B * B*H*N*N each): the forward at B=4, T=1024, H=64,
// N=64 is 344 MB, 0.103 ms at 3.35 TB/s; a decode tick at B=8, T=1 is
// 17.4 MB, almost all state, 5.2 us per layer; a 64-token prefill chunk at
// B=8 is 58.7 MB, 17.5 us. Operations: the recurrence's 7 fp32 operations
// per state element and step take 0.112 ms at the forward shape, just
// above its bytes, and less than the bytes at the serving shapes.
// Design: one block per (b, h) (the forward's grid is
// 4 x 64 = 256 blocks, a decode tick's 512) of 4 * NMAX threads: thread
// (g, j) holds rows [g*NMAX/4, (g+1)*NMAX/4) of state column j in
// registers, so the 16 KB state of a head never leaves the chip between
// steps, and the four row groups give each SM about 16 warps at the
// forward shape (a thread per column alone would give 4). Up to 16 steps of
// r, k, v, w are staged in shared memory with coalesced loads (a step's N
// values of one head are contiguous); the per-step inner loop reads them as
// float4 broadcasts. Each group's partial y of a step goes to shared memory
// and, once per staged chunk, the four partials are summed and written out
// coalesced. Each element keeps the reference's order with __fmul_rn and
// __fadd_rn (no contraction); only the sum over i, which the reference
// leaves to its einsum, is taken as four sequential FMA chains added in
// order. What bounds it in practice is the T dependent steps per block:
// cp.async double buffering of the staged chunk is later work.
//
// K6 replaces repro/kernels/linear_scan.py::_sscan_kernel, the Pallas
// kernel behind ops.selective_scan: per batch row b, channel d and state
// index n,
//     h = exp(a[d][n] * dt_t[d]) * h + (dt_t[d] * x_t[d]) * b_t[n]
//     y_t[d] = sum_n h[n] * c_t[n]
// in the TPU kernel's per-element order (linear_scan.py:121-123).
//
// K6 bound: bytes. x, dt and y (B*T*D), b and c (B*T*N), a (D*N), h0 and
// hT (B*D*N) once: the forward at B=4, T=1024, D=1600, N=16 is 80 MB,
// 0.024 ms; a decode tick at B=8 is 1.9 MB, 0.6 us; a 64-token prefill
// chunk at B=8 is 11.5 MB, 3.4 us. Design: one thread per (b, d, n), a
// group of G lanes (the power of two >= N, <= 32) per (b, d), 256 threads a
// block covering 256 / G channels: at the forward shape that is 102,400
// threads over 400 blocks (a thread per (b, d) holding N registers would
// give 6,400 threads, too few for 132 SMs). b_t and c_t, shared by every
// channel, and x_t and dt_t, read coalesced along d, are staged in shared
// memory per chunk of steps; y is reduced over n by xor shuffles inside
// the group, collected in shared memory and written once per chunk. The T
// dependent steps, each with an exp, make it latency-bound well above its
// bytes bound.
//
// Both kernels take any T >= 1 and any B (up to 65535) and H or D; K5
// takes N <= 64, K6 N <= 32. Lanes past N (and channels past D) run on
// zeros and are never written, so a padded lane adds exact zeros. A
// launch that cannot be made returns its CUDA error; nothing is clamped.

#include <cuda_runtime.h>

namespace {

constexpr int WKV_GROUPS = 4;       // row groups of a K5 block
constexpr int WKV_MAX_STAGE = 16;   // steps staged per chunk: <= 33 KB smem
constexpr int SS_THREADS = 256;
constexpr int SS_SMEM_FLOATS = 12288;   // 48 KB of staged steps

__device__ __forceinline__ void wkv_elem(float& s, float r, float k, float w,
                                         float u, float vj, float& acc) {
  const float kv = __fmul_rn(k, vj);
  acc = __fmaf_rn(r, __fadd_rn(s, __fmul_rn(u, kv)), acc);
  s = __fadd_rn(__fmul_rn(w, s), kv);
}

// NMAX: 16, 32 or 64, the padded head size; the block is WKV_GROUPS * NMAX
// threads, thread (g, j) = (threadIdx.x / NMAX, threadIdx.x % NMAX).
template <int NMAX>
__global__ void __launch_bounds__(WKV_GROUPS * NMAX)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int T, int H,
            int N, int stage) {
  constexpr int THREADS = WKV_GROUPS * NMAX;
  constexpr int R = NMAX / WKV_GROUPS;   // state rows per thread
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);   // [stage][NMAX]
  float* ks = rs + stage * NMAX;
  float* vs = ks + stage * NMAX;
  float* ws = vs + stage * NMAX;
  float* us = ws + stage * NMAX;                 // [NMAX]
  float* yp = us + NMAX;                         // [stage][GROUPS][NMAX]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x / NMAX;
  const int j = threadIdx.x % NMAX;
  const int row0 = g * R;
  const size_t step = (size_t)H * N;                  // between time steps
  const size_t base = ((size_t)b * T * H + h) * N;   // (b, 0, h, 0)
  const size_t sbase = ((size_t)b * H + h) * N * N;  // (b, h, 0, 0)

  if (threadIdx.x < NMAX)
    us[threadIdx.x] = threadIdx.x < N ? u[(size_t)h * N + threadIdx.x] : 0.f;
  float S[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    S[i] = (row0 + i < N && j < N) ? s0[sbase + (size_t)(row0 + i) * N + j]
                                   : 0.f;

  for (int t0 = 0; t0 < T; t0 += stage) {
    const int nt = min(stage, T - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nt * NMAX; idx += THREADS) {
      const int t = idx / NMAX, i = idx % NMAX;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (i < N) {
        const size_t off = base + (size_t)(t0 + t) * step + i;
        rv = r[off];
        kv = k[off];
        vv = v[off];
        wv = w[off];
      }
      rs[idx] = rv;
      ks[idx] = kv;
      vs[idx] = vv;
      ws[idx] = wv;
    }
    __syncthreads();
    const float4* u4 = reinterpret_cast<const float4*>(us + row0);
    for (int t = 0; t < nt; ++t) {
      const float vj = vs[t * NMAX + j];
      const float4* r4 = reinterpret_cast<const float4*>(rs + t * NMAX + row0);
      const float4* k4 = reinterpret_cast<const float4*>(ks + t * NMAX + row0);
      const float4* w4 = reinterpret_cast<const float4*>(ws + t * NMAX + row0);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q], uu = u4[q];
        wkv_elem(S[4 * q + 0], rr.x, kk.x, ww.x, uu.x, vj, acc[0]);
        wkv_elem(S[4 * q + 1], rr.y, kk.y, ww.y, uu.y, vj, acc[1]);
        wkv_elem(S[4 * q + 2], rr.z, kk.z, ww.z, uu.z, vj, acc[2]);
        wkv_elem(S[4 * q + 3], rr.w, kk.w, ww.w, uu.w, vj, acc[3]);
      }
      yp[(t * WKV_GROUPS + g) * NMAX + j] =
          __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nt * NMAX; idx += THREADS) {
      const int t = idx / NMAX, jj = idx % NMAX;
      if (jj < N) {
        const float* p = yp + t * WKV_GROUPS * NMAX + jj;
        float sum = p[0];
#pragma unroll
        for (int gg = 1; gg < WKV_GROUPS; ++gg)
          sum = __fadd_rn(sum, p[gg * NMAX]);
        y[base + (size_t)(t0 + t) * step + jj] = sum;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (row0 + i < N && j < N) sT[sbase + (size_t)(row0 + i) * N + j] = S[i];
}

// G: lanes per (b, d) group, a power of two >= N and <= 32; the block's
// 256 threads cover DB = 256 / G channels.
template <int G>
__global__ void __launch_bounds__(SS_THREADS)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int T, int D, int N,
                      int stage) {
  constexpr int DB = SS_THREADS / G;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [stage][DB]
  float* dts = xs + stage * DB;                  // [stage][DB]
  float* ys = dts + stage * DB;                  // [stage][DB]
  float* bs = ys + stage * DB;                   // [stage][G]
  float* cs = bs + stage * G;                    // [stage][G]

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * DB;
  const int dl = threadIdx.x / G;
  const int n = threadIdx.x % G;
  const int d = d0 + dl;
  const bool live = d < D && n < N;
  const float a_dn = live ? a[(size_t)d * N + n] : 0.f;
  float h = live ? h0[((size_t)b * D + d) * N + n] : 0.f;
  const size_t xbase = (size_t)b * T * D;   // x[b, t, d] at xbase + t*D + d
  const size_t bbase = (size_t)b * T * N;

  for (int t0 = 0; t0 < T; t0 += stage) {
    const int nt = min(stage, T - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nt * DB; idx += SS_THREADS) {
      const int t = idx / DB, c = idx % DB;
      const bool ok = d0 + c < D;
      const size_t off = xbase + (size_t)(t0 + t) * D + d0 + c;
      xs[idx] = ok ? x[off] : 0.f;
      dts[idx] = ok ? dt[off] : 0.f;
    }
    for (int idx = threadIdx.x; idx < nt * G; idx += SS_THREADS) {
      const int t = idx / G, c = idx % G;
      const bool ok = c < N;
      const size_t off = bbase + (size_t)(t0 + t) * N + c;
      bs[idx] = ok ? bm[off] : 0.f;
      cs[idx] = ok ? cm[off] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float dtt = dts[t * DB + dl];
      const float xt = xs[t * DB + dl];
      const float decay = expf(__fmul_rn(a_dn, dtt));
      h = __fadd_rn(__fmul_rn(decay, h),
                    __fmul_rn(__fmul_rn(dtt, xt), bs[t * G + n]));
      float p = __fmul_rn(h, cs[t * G + n]);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, o));
      if (n == 0) ys[t * DB + dl] = p;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nt * DB; idx += SS_THREADS) {
      const int t = idx / DB, c = idx % DB;
      if (d0 + c < D) y[xbase + (size_t)(t0 + t) * D + d0 + c] = ys[idx];
    }
  }
  if (live) hT[((size_t)b * D + d) * N + n] = h;
}

}  // namespace

// r, k, v, w, y: (B, T, H, N); u: (H, N); s0, sT: (B, H, N, N); all fp32,
// contiguous. ``chunk``: the steps staged per pass (at most 16 are used;
// the result does not depend on it).
extern "C" int repro_wkv6_f32(const float* r, const float* k, const float* v,
                              const float* w, const float* u,
                              const float* s0, float* y, float* sT, int B,
                              int T, int H, int N, int chunk, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || H < 1 || N < 1 || N > 64 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int stage = min(chunk, WKV_MAX_STAGE);
  const dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(NMAX)                                                      \
  wkv6_kernel<NMAX><<<grid, WKV_GROUPS * NMAX,                            \
                      (size_t)(8 * stage * NMAX + NMAX) * sizeof(float),  \
                      s>>>(r, k, v, w, u, s0, y, sT, T, H, N, stage)
  if (N <= 16)
    LAUNCH(16);
  else if (N <= 32)
    LAUNCH(32);
  else
    LAUNCH(64);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// x, dt, y: (B, T, D); b, c: (B, T, N); a: (D, N); h0, hT: (B, D, N); all
// fp32, contiguous. ``chunk``: the steps staged per pass (capped so the
// staged steps fit 48 KB; the result does not depend on it).
extern "C" int repro_selective_scan_f32(const float* x, const float* dt,
                                        const float* b, const float* c,
                                        const float* a, const float* h0,
                                        float* y, float* hT, int B, int T,
                                        int D, int N, int chunk,
                                        void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || N < 1 || N > 32 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < N) G <<= 1;
  const int DB = SS_THREADS / G;
  const int stage = min(chunk, SS_SMEM_FLOATS / (3 * DB + 2 * G));
  const size_t smem = (size_t)stage * (3 * DB + 2 * G) * sizeof(float);
  const dim3 grid((D + DB - 1) / DB, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(GG)                                                        \
  selective_scan_kernel<GG><<<grid, SS_THREADS, smem, s>>>(               \
      x, dt, b, c, a, h0, y, hT, T, D, N, stage)
  switch (G) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 4: LAUNCH(4); break;
    case 8: LAUNCH(8); break;
    case 16: LAUNCH(16); break;
    default: LAUNCH(32); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
