// The two linear recurrences of the recurrent families in fp32, written for
// Hopper (sm_90a): the RWKV6 wkv scan (K5) and the mamba selective scan
// (K6). Each call is one launch; the block shape, the split over value
// columns or channels and the staging depth come from
// kernels/linear_scan.py::scan_plan, and the entry points below check them.
// No plan changes a bit of the result.
//
// K5 replaces repro/kernels/linear_scan.py::_wkv6_kernel, the Pallas TPU
// kernel behind ops.wkv6. Per batch row b and head h, with the (N, N)
// state S (row i = key channel, column j = value channel), every time
// step t computes
//     kv[i][j] = k[i] * v[j]
//     y[j]     = sum_i r[i] * (S[i][j] + u[i] * kv[i][j])
//     S[i][j]  = w[i] * S[i][j] + kv[i][j]
// in that order per element (ref.wkv6), with __fmul_rn / __fadd_rn (no
// contraction). The TPU kernel walks T in chunks along a sequential grid
// axis with S in VMEM and a log-space closed form inside each chunk; that
// form exists for the TPU's matrix unit and costs exps the plain
// recurrence does not need, so a loop over t inside the block takes the
// place of the sequential grid axis.
//
// K5 bound. Bytes: r, k, v, w and y move once (4 B * B*T*H*N each), s0
// and sT once (4 B * B*H*N*N each): the forward at B=4, T=1024, H=64,
// N=64 is 344 MB, 0.103 ms at 3.35 TB/s; a decode tick at B=8, T=1 is
// 17.4 MB, almost all state, 5.2 us per layer; a 64-token prefill chunk
// is 58.7 MB (17.5 us) at B=8 and 7.4 MB (2.2 us) at B=1, the shape of
// most serving chunks. Kept in this order, an element is 6 fp32
// instructions a step, so the forward and the B=8 chunk are issue-bound
// near 0.22 ms and 27 us once every SM is busy.
// Design. Block (h, b, column block z) owns value columns [z*cols,
// (z+1)*cols) of one head; thread (g, jq) holds rows [g*R, (g+1)*R) (R =
// NMAX / 8) of C = 1 or 2 state columns in registers, so the state never
// leaves the chip between steps. Column j of S and y[j] depend on v[j]
// alone, so neither the split over columns (grid z) nor C changes a bit;
// the plan takes C = 2 where that still gives every SM sub-partition a
// warp (a staged r, k, w read then feeds twice the FMAs), then the widest
// column block that gives every SM a block (a B=1 chunk of 64 heads
// splits each head 4 ways). The staged steps' r, k, w (all N rows) and v
// (the block's columns) stream through a two-stage cp.async ring
// (csrc/cp_async.cuh): stage s+1 is in flight while stage s computes, and
// at a B=1 chunk's default depth the whole 64-step chunk is in flight at
// once; within a stage each step's operands are read from shared memory
// one step ahead. Sum order of y[j]: each thread keeps two FMA chains per
// column, chain c over its rows g*R + c, g*R + c + 2, ... in increasing
// order, and adds chain 0 + chain 1; the eight row groups' partials then
// go through shared memory and thread (g, jq) adds them, in order g' = 0,
// 1, ..., 7, for its own columns at steps t = g, g + 8, ... So y[j] is 16
// partial chains summed in a fixed order, for every N, plan and staging
// depth. On an H100 (PERF.md) a warp spends most of a B=1 chunk in the
// step loop at under one instruction a cycle: with two warps per SM
// sub-partition the step's dependent loads and FMA chains are not hidden.
//
// K6 replaces repro/kernels/linear_scan.py::_sscan_kernel, the Pallas
// kernel behind ops.selective_scan: per batch row b, channel d and state
// index n,
//     h = exp(a[d][n] * dt_t[d]) * h + (dt_t[d] * x_t[d]) * b_t[n]
//     y_t[d] = sum_n h[n] * c_t[n]
// in the TPU kernel's per-element order (linear_scan.py:121-123), with
// expf, __fmul_rn and __fadd_rn.
//
// K6 bound: bytes. x, dt and y (B*T*D), b and c (B*T*N), a (D*N), h0 and
// hT (B*D*N) once: the forward at B=4, T=1024, D=1600, N=16 is 80 MB,
// 0.024 ms; a decode tick at B=8 is 1.9 MB, 0.6 us; a 64-token prefill
// chunk is 11.5 MB (3.4 us) at B=8 and 1.5 MB (0.46 us) at B=1.
// Design. One thread per (b, d, n), a group of G lanes (the power of two
// >= N, <= 32) per (b, d), blocks of `cols` channels (the plan makes a B=1
// chunk launch at least a block per SM). Passes of staged steps of dt, x,
// b and c stream through a two-pass cp.async ring into shared memory with
// t contiguous, so a lane reads 4 steps per float4; pass p+1 is in flight
// while pass p computes (the first port loaded each staged step with a
// dependent global load, so a 64-step chunk waited on a dozen round
// trips). Only h = decay * h + bx is serial: per group of SS_U = 16 staged
// steps a thread first computes every step's decay exp(a * dt) and input
// term (dt * x) * b, independent of h, then runs the 16 dependent updates,
// then reduces the 16 outputs over n together. Sum order of y_t[d]: the
// xor tree of a per-step butterfly over the group's G lanes (level o =
// G/2, ..., 1 adds lane n's value to lane n^o's), as the first port of
// this kernel summed them, so the new outputs equal its bits; the 16
// steps' trees are taken at once, each level handing half of a lane's
// remaining steps to its partner (one shuffle per pair of values instead
// of one per value).
// T = 1 (the decode tick) runs a kernel with no staging and no barrier.
//
// Both kernels take any T >= 1 and any B (up to 65535) and H or D; K5
// takes N <= 64, K6 N <= 32. Rows, lanes and channels past N or D run on
// zeros and are never written, so a padded row adds exact zeros. A launch
// that cannot be made returns its CUDA error; nothing is clamped.

#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int SMEM_MAX = 232448;    // a block's dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr int WKV_GROUPS = 8;       // row groups of a K5 block
constexpr int WKV_RING = 2;         // stages of K5's cp.async ring
constexpr int SS_U = 16;            // K6 steps reduced together
constexpr int SS_MAX_THREADS = 256;

// ------------------------------------------------------------------ K5
__device__ __forceinline__ void wkv_elem(float& s, float r, float k, float w,
                                         float u, float vj, float& acc) {
  const float kv = __fmul_rn(k, vj);
  acc = __fmaf_rn(r, __fadd_rn(s, __fmul_rn(u, kv)), acc);
  s = __fadd_rn(__fmul_rn(w, s), kv);
}

template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&o)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      o[4 * q] = f.x;
      o[4 * q + 1] = f.y;
      o[4 * q + 2] = f.z;
      o[4 * q + 3] = f.w;
    }
  } else {
    static_assert(R == 2, "rows per thread: 2, 4 or 8");
    const float2 f = *reinterpret_cast<const float2*>(p);
    o[0] = f.x;
    o[1] = f.y;
  }
}

__host__ __device__ constexpr size_t wkv_smem(int nmax, int cols,
                                              int steps) {
  // the ring [WKV_RING][steps][3 * nmax + cols], the row groups' partial
  // outputs [2][steps][WKV_GROUPS][cols]
  return sizeof(float) * ((size_t)WKV_RING * steps * (3 * nmax + cols)
                          + (size_t)2 * steps * WKV_GROUPS * cols);
}

// Copies of stage [t0, t0 + nt) into `dst` ([nt][row_f]): per step r, k, w
// (NMAX floats each, zeros past N) then v's `cols` columns from j0, in
// W-float copies (W = 4: 16 bytes).
template <int NMAX, int W>
__device__ __forceinline__ void wkv_stage(
    float* dst, const float* r, const float* k, const float* w,
    const float* v, size_t base, size_t step, int t0, int nt, int N, int j0,
    int cols, int row_f) {
  constexpr int PER = 3 * NMAX / W;
  const int nthr = blockDim.x;
  for (int idx = threadIdx.x; idx < nt * PER; idx += nthr) {
    const int t = idx / PER, q = (idx % PER) * W;
    const int a = q / NMAX, col = q % NMAX;
    const float* src = a == 0 ? r : a == 1 ? k : w;
    const bool in = col < N;
    const float* from = src + base + (size_t)(t0 + t) * step + (in ? col : 0);
    if constexpr (W == 4)
      repro::cp_async16(dst + t * row_f + q, from, in);
    else
      repro::cp_async4(dst + t * row_f + q, from, in);
  }
  const int vper = cols / W, vshift = __ffs(vper) - 1;   // cols: power of 2
  for (int idx = threadIdx.x; idx < nt * vper; idx += nthr) {
    const int t = idx >> vshift, q = (idx & (vper - 1)) * W;
    const bool in = j0 + q < N;
    const float* from = v + base + (size_t)(t0 + t) * step + (in ? j0 + q : 0);
    if constexpr (W == 4)
      repro::cp_async16(dst + t * row_f + 3 * NMAX + q, from, in);
    else
      repro::cp_async4(dst + t * row_f + 3 * NMAX + q, from, in);
  }
}

template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&o)[C]) {
  if constexpr (C == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    o[0] = f.x; o[1] = f.y;
  } else {
    o[0] = *p;
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&o)[C]) {
  if constexpr (C == 2)
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  else
    *p = o[0];
}

// NMAX: 16, 32 or 64, the padded head size; C: value columns per thread
// (1 or 2; no bit depends on it). Block (h, b, z) of WKV_GROUPS * cols
// / C threads, thread (g, jq) = (threadIdx.x / (cols / C), threadIdx.x %
// (cols / C)) on value columns j = z * cols + jq * C + c, c < C.
template <int NMAX, int C>
__global__ void __launch_bounds__(WKV_GROUPS * NMAX / C)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int T, int H,
            int N, int cols, int steps, int vec) {
  constexpr int R = NMAX / WKV_GROUPS;   // state rows per thread
  const int row_f = 3 * NMAX + cols;     // floats of one staged step
  const int lanes = cols / C;            // threads per row group
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [RING][steps][row_f]
  float* yp = ring + WKV_RING * steps * row_f;    // [2][steps][GROUPS][cols]

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int j0 = blockIdx.z * cols;
  const int g = threadIdx.x / lanes;
  const int jc = (threadIdx.x % lanes) * C;   // first column in the block
  const int j = j0 + jc;
  const int row0 = g * R;
  const size_t step = (size_t)H * N;                   // between time steps
  const size_t base = ((size_t)bi * T * H + h) * N;    // (b, 0, h, 0)
  const size_t sbase = ((size_t)bi * H + h) * N * N;   // (b, h, 0, 0)
  const int nst = (T + steps - 1) / steps;

  // stage s into ring slot s % WKV_RING; always commits a group, so
  // stage s is group s
  auto issue = [&](int s) {
    if (s < nst) {
      const int t0 = s * steps, nt = min(steps, T - t0);
      float* dst = ring + (s % WKV_RING) * steps * row_f;
      if (vec)
        wkv_stage<NMAX, 4>(dst, r, k, w, v, base, step, t0, nt, N, j0, cols,
                           row_f);
      else
        wkv_stage<NMAX, 1>(dst, r, k, w, v, base, step, t0, nt, N, j0, cols,
                           row_f);
    }
    repro::cp_commit();
  };

  // y of stage s: the row groups' partials added in order g = 0..7; thread
  // (g, jq) sums its own C columns at steps t = g, g + 8, ...
  auto write_y = [&](int s) {
    const int t0 = s * steps, nt = min(steps, T - t0);
    const float* p = yp + (s & 1) * steps * WKV_GROUPS * cols + jc;
#pragma unroll 4
    for (int t = g; t < nt; t += WKV_GROUPS) {
      const float* q = p + t * WKV_GROUPS * cols;
      float sum[C], part[C];
      load_cols(q, sum);
#pragma unroll
      for (int gg = 1; gg < WKV_GROUPS; ++gg) {
        load_cols(q + gg * cols, part);
#pragma unroll
        for (int c = 0; c < C; ++c) sum[c] = __fadd_rn(sum[c], part[c]);
      }
      float* out = y + base + (size_t)(t0 + t) * step + j;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (j + c < N) out[c] = sum[c];
    }
  };

  issue(0);
  // the state columns and the bonus, loaded while stage 0 is in flight
  float S[R][C], uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i;
    uu[i] = row < N ? u[(size_t)h * N + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      S[i][c] = (row < N && j + c < N)
                    ? s0[sbase + (size_t)row * N + j + c] : 0.f;
  }

  for (int s = 0; s < nst; ++s) {
    __syncthreads();    // stage s-1 is computed: its slot may be refilled
    issue(s + 1);
    repro::cp_wait<WKV_RING - 1>();
    __syncthreads();    // stage s has landed for every thread
    if (s > 0) write_y(s - 1);
    const int nt = min(steps, T - s * steps);
    const float* st = ring + (s % WKV_RING) * steps * row_f;
    float* yo = yp + (s & 1) * steps * WKV_GROUPS * cols + g * cols + jc;
    // each step's operands are read from shared memory one step ahead,
    // so their latency overlaps the step before
    float rr[R], kk[R], ww[R], vv[C];
    load_rows(st + row0, rr);
    load_rows(st + NMAX + row0, kk);
    load_rows(st + 2 * NMAX + row0, ww);
    load_cols(st + 3 * NMAX + jc, vv);
#pragma unroll 2
    for (int t = 0; t < nt; ++t) {
      const float* nx = st + min(t + 1, nt - 1) * row_f;
      float rn[R], kn[R], wn[R], vn[C];
      load_rows(nx + row0, rn);
      load_rows(nx + NMAX + row0, kn);
      load_rows(nx + 2 * NMAX + row0, wn);
      load_cols(nx + 3 * NMAX + jc, vn);
      float out[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float acc[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < R; ++i)
          wkv_elem(S[i][c], rr[i], kk[i], ww[i], uu[i], vv[c], acc[i & 1]);
        out[c] = __fadd_rn(acc[0], acc[1]);
      }
      store_cols(yo + t * WKV_GROUPS * cols, out);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        rr[i] = rn[i];
        kk[i] = kn[i];
        ww[i] = wn[i];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vn[c];
    }
  }
  __syncthreads();
  write_y(nst - 1);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (row0 + i < N && j + c < N)
        sT[sbase + (size_t)(row0 + i) * N + j + c] = S[i][c];
}

// ------------------------------------------------------------------ K6
// The sum over each aligned group of G lanes of CNT values a lane holds
// (one per step), in the xor-tree order of a per-step butterfly: level O
// adds a lane's value to lane ^ O's value of the same step, O = G/2, ...,
// 1. While a lane holds more than one value, a level halves them: the
// lane keeps the half of the steps its O bit selects and receives its
// partner's values of those steps. On return v[0, CNT >> halvings) hold
// the sums of steps base + i; of the lanes that end with the same steps
// only one keeps `writer`.
template <int O, int CNT, int U>
__device__ __forceinline__ void tree_sum(float (&v)[U], int n, int& base,
                                         bool& writer) {
  if constexpr (O >= 1) {
    if constexpr (CNT > 1) {
      constexpr int HALF = CNT / 2;
      const bool up = (n & O) != 0;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = up ? v[i] : v[i + HALF];
        const float keep = up ? v[i + HALF] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, O));
      }
      if (up) base += HALF;
      tree_sum<O / 2, HALF>(v, n, base, writer);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], O));
      if (n & O) writer = false;
      tree_sum<O / 2, 1>(v, n, base, writer);
    }
  }
}

// One group of SS_U staged steps of one (b, d, n): the parallel pass
// (every step's decay and input term), the serial pass (h), then the
// outputs reduced over n into ys. dts, xs: this channel's dt and x from the
// group's first step; bs, cs: lane n's b and c likewise; ys: this
// channel's first output row (rows `cols` apart). PART: only the first nv
// steps are real and h must not move past them.
template <int G, bool PART>
__device__ __forceinline__ void ss_group(const float* dts, const float* xs,
                                         const float* bs, const float* cs,
                                         float a_dn, float& h, int nv, int n,
                                         float* ys, int cols) {
  float decay[SS_U], bx[SS_U], v[SS_U];
#pragma unroll
  for (int q = 0; q < SS_U / 4; ++q) {
    const float4 d4 = reinterpret_cast<const float4*>(dts)[q];
    const float4 x4 = reinterpret_cast<const float4*>(xs)[q];
    const float4 b4 = reinterpret_cast<const float4*>(bs)[q];
    const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
    const float xx[4] = {x4.x, x4.y, x4.z, x4.w};
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      decay[4 * q + e] = expf(__fmul_rn(a_dn, dd[e]));
      bx[4 * q + e] = __fmul_rn(__fmul_rn(dd[e], xx[e]), bb[e]);
    }
  }
#pragma unroll
  for (int q = 0; q < SS_U / 4; ++q) {
    const float4 c4 = reinterpret_cast<const float4*>(cs)[q];
    const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 4 * q + e;
      const float hn = __fadd_rn(__fmul_rn(decay[t], h), bx[t]);
      h = (!PART || t < nv) ? hn : h;
      v[t] = __fmul_rn(h, cc[e]);
    }
  }
  int base = 0;
  bool writer = true;
  tree_sum<G / 2, SS_U>(v, n, base, writer);
  constexpr int LEFT = SS_U / (G < SS_U ? G : SS_U);
  if (writer) {
#pragma unroll
    for (int i = 0; i < LEFT; ++i) ys[(base + i) * cols] = v[i];
  }
}

__host__ __device__ constexpr int ss_round(int steps) {
  return (steps + SS_U - 1) / SS_U * SS_U;
}

__host__ __device__ constexpr size_t ss_smem(int G, int cols, int steps) {
  // two passes' dt and x [cols][pitch] and b and c [G][pitch] (pitch: the
  // steps rounded up to SS_U, plus 4), the outputs [rounded steps][cols]
  return sizeof(float) * ((size_t)2 * (ss_round(steps) + 4)
                              * (2 * cols + 2 * G)
                          + (size_t)ss_round(steps) * cols);
}

// G: lanes per (b, d) group, a power of two >= N and <= 32; the block's
// cols * G threads cover `cols` channels, thread (dl, n) = (threadIdx.x /
// G, threadIdx.x % G). Passes of `steps` steps stream through a two-pass
// cp.async ring: pass p+1 is in flight while pass p computes.
template <int G>
__global__ void __launch_bounds__(SS_MAX_THREADS)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int T, int D, int N, int cols,
                      int steps) {
  const int pitch = ss_round(steps) + 4;
  const int pass_f = pitch * (2 * cols + 2 * G);   // floats of one pass
  const int nthr = cols * G;
  const int cshift = __ffs(cols) - 1;              // cols: power of 2
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [2][pass_f]
  float* ys = ring + 2 * pass_f;                  // [rounded steps][cols]

  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * cols;
  const int dl = threadIdx.x / G;
  const int n = threadIdx.x % G;
  const int d = d0 + dl;
  const bool live = d < D && n < N;
  const size_t xbase = (size_t)bi * T * D;   // x[b, t, d] at xbase + t*D + d
  const size_t bbase = (size_t)bi * T * N;
  const int npass = (T + steps - 1) / steps;

  // pass p into ring slot p & 1, laid out dt [cols][pitch], x [cols][pitch],
  // b [G][pitch], c [G][pitch]; steps from nt up to the next multiple of
  // SS_U, channels past D and lanes past N are zeros. Always commits a
  // group, so pass p is group p.
  auto issue = [&](int p) {
    if (p < npass) {
      const int t0 = p * steps, nt = min(steps, T - t0);
      const int ntp = ss_round(nt);
      float* dts = ring + (p & 1) * pass_f;
      float* xs = dts + cols * pitch;
      float* bs = xs + cols * pitch;
      float* cs = bs + G * pitch;
      for (int idx = threadIdx.x; idx < ntp * cols; idx += nthr) {
        const int t = idx >> cshift, c = idx & (cols - 1);
        const bool in = t < nt && d0 + c < D;
        const size_t off = in ? xbase + (size_t)(t0 + t) * D + d0 + c : 0;
        repro::cp_async4(dts + c * pitch + t, dt + off, in);
        repro::cp_async4(xs + c * pitch + t, x + off, in);
      }
      for (int idx = threadIdx.x; idx < ntp * G; idx += nthr) {
        const int t = idx / G, c = idx % G;
        const bool in = t < nt && c < N;
        const size_t off = in ? bbase + (size_t)(t0 + t) * N + c : 0;
        repro::cp_async4(bs + c * pitch + t, bm + off, in);
        repro::cp_async4(cs + c * pitch + t, cm + off, in);
      }
    }
    repro::cp_commit();
  };

  issue(0);
  const float a_dn = live ? a[(size_t)d * N + n] : 0.f;
  float h = live ? h0[((size_t)bi * D + d) * N + n] : 0.f;
  for (int p = 0; p < npass; ++p) {
    // pass p-1's groups are done (the barrier after them): its slot may
    // be refilled
    issue(p + 1);
    repro::cp_wait<1>();
    __syncthreads();    // pass p has landed for every thread
    const int t0 = p * steps, nt = min(steps, T - t0);
    const float* dts = ring + (p & 1) * pass_f;
    const float* xs = dts + cols * pitch;
    const float* bs = xs + cols * pitch;
    const float* cs = bs + G * pitch;
    for (int g0 = 0; g0 < nt; g0 += SS_U) {
      const float* dp = dts + dl * pitch + g0;
      const float* xp = xs + dl * pitch + g0;
      const float* bp = bs + n * pitch + g0;
      const float* cp = cs + n * pitch + g0;
      float* yo = ys + g0 * cols + dl;
      if (nt - g0 >= SS_U)
        ss_group<G, false>(dp, xp, bp, cp, a_dn, h, SS_U, n, yo, cols);
      else
        ss_group<G, true>(dp, xp, bp, cp, a_dn, h, nt - g0, n, yo, cols);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nt * cols; idx += nthr) {
      const int t = idx >> cshift, c = idx & (cols - 1);
      if (d0 + c < D) y[xbase + (size_t)(t0 + t) * D + d0 + c] = ys[idx];
    }
  }
  if (live) hT[((size_t)bi * D + d) * N + n] = h;
}

// T = 1: the same thread layout, every operand read straight from device
// memory, no staging and no barrier.
template <int G>
__global__ void __launch_bounds__(SS_MAX_THREADS)
selective_scan_tick_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ bm,
                           const float* __restrict__ cm,
                           const float* __restrict__ a,
                           const float* __restrict__ h0,
                           float* __restrict__ y, float* __restrict__ hT,
                           int D, int N, int cols) {
  const int bi = blockIdx.y;
  const int d = blockIdx.x * cols + threadIdx.x / G;
  const int n = threadIdx.x % G;
  const bool dok = d < D;
  const bool live = dok && n < N;
  const float dv = dok ? dt[(size_t)bi * D + d] : 0.f;
  const float xv = dok ? x[(size_t)bi * D + d] : 0.f;
  const float bv = n < N ? bm[(size_t)bi * N + n] : 0.f;
  const float cv = n < N ? cm[(size_t)bi * N + n] : 0.f;
  const float a_dn = live ? a[(size_t)d * N + n] : 0.f;
  float h = live ? h0[((size_t)bi * D + d) * N + n] : 0.f;
  const float decay = expf(__fmul_rn(a_dn, dv));
  h = __fadd_rn(__fmul_rn(decay, h), __fmul_rn(__fmul_rn(dv, xv), bv));
  float p[1] = {__fmul_rn(h, cv)};
  int base = 0;
  bool writer = true;
  tree_sum<G / 2, 1>(p, n, base, writer);
  if (writer && dok) y[(size_t)bi * D + d] = p[0];
  if (live) hT[((size_t)bi * D + d) * N + n] = h;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <int NMAX, int C>
int launch_wkv6(const float* r, const float* k, const float* v,
                const float* w, const float* u, const float* s0, float* y,
                float* sT, int B, int T, int H, int N, int cols, int steps,
                int vec, cudaStream_t s) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      wkv6_kernel<NMAX, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (ready != cudaSuccess) return ready;
  const dim3 grid(H, B, NMAX / cols);
  wkv6_kernel<NMAX, C><<<grid, WKV_GROUPS * cols / C,
                         wkv_smem(NMAX, cols, steps), s>>>(
      r, k, v, w, u, s0, y, sT, T, H, N, cols, steps, vec);
  return (int)cudaGetLastError();
}

template <int NMAX>
int launch_wkv6(int C, const float* r, const float* k, const float* v,
                const float* w, const float* u, const float* s0, float* y,
                float* sT, int B, int T, int H, int N, int cols, int steps,
                int vec, cudaStream_t s) {
  if (C == 2)
    return launch_wkv6<NMAX, 2>(r, k, v, w, u, s0, y, sT, B, T, H, N, cols,
                                steps, vec, s);
  return launch_wkv6<NMAX, 1>(r, k, v, w, u, s0, y, sT, B, T, H, N, cols,
                              steps, vec, s);
}

template <int G>
int launch_sscan(const float* x, const float* dt, const float* b,
                 const float* c, const float* a, const float* h0, float* y,
                 float* hT, int B, int T, int D, int N, int cols, int steps,
                 cudaStream_t s) {
  const dim3 grid((D + cols - 1) / cols, B);
  if (T == 1) {
    selective_scan_tick_kernel<G><<<grid, cols * G, 0, s>>>(
        x, dt, b, c, a, h0, y, hT, D, N, cols);
  } else {
    static const cudaError_t ready = cudaFuncSetAttribute(
        selective_scan_kernel<G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (ready != cudaSuccess) return ready;
    selective_scan_kernel<G><<<grid, cols * G, ss_smem(G, cols, steps), s>>>(
        x, dt, b, c, a, h0, y, hT, T, D, N, cols, steps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: (B, T, H, N); u: (H, N); s0, sT: (B, H, N, N); all fp32,
// contiguous. The plan (scan_plan): `cols` value columns per block (a
// power of two up to the padded N), `thread_cols` of them per thread (1
// or 2; a block has at least 32 threads), `steps` staged per ring
// stage, `vec` 16-byte copies (N a multiple of 4 and r, k, v, w 16-byte
// aligned).
extern "C" int repro_wkv6_f32(const float* r, const float* k, const float* v,
                              const float* w, const float* u,
                              const float* s0, float* y, float* sT, int B,
                              int T, int H, int N, int cols, int thread_cols,
                              int steps, int vec, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || H < 1 || N < 1 || N > 64 || steps < 1)
    return (int)cudaErrorInvalidValue;
  const int nmax = N <= 16 ? 16 : N <= 32 ? 32 : 64;
  const int C = thread_cols;
  if (!pow2(cols) || cols > nmax || (C != 1 && C != 2)
      || WKV_GROUPS * cols / C < 32
      || wkv_smem(nmax, cols, steps) > (size_t)SMEM_MAX
      || (vec && (N % 4 || !aligned16(r) || !aligned16(k) || !aligned16(v)
                  || !aligned16(w))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nmax == 16)
    return launch_wkv6<16>(C, r, k, v, w, u, s0, y, sT, B, T, H, N, cols,
                           steps, vec, s);
  if (nmax == 32)
    return launch_wkv6<32>(C, r, k, v, w, u, s0, y, sT, B, T, H, N, cols,
                           steps, vec, s);
  return launch_wkv6<64>(C, r, k, v, w, u, s0, y, sT, B, T, H, N, cols, steps,
                         vec, s);
}

// x, dt, y: (B, T, D); b, c: (B, T, N); a: (D, N); h0, hT: (B, D, N); all
// fp32, contiguous. The plan (scan_plan): `cols` channels per block (a
// power of two, cols * G from 32 to 256 threads), `steps` staged per pass.
extern "C" int repro_selective_scan_f32(const float* x, const float* dt,
                                        const float* b, const float* c,
                                        const float* a, const float* h0,
                                        float* y, float* hT, int B, int T,
                                        int D, int N, int cols, int steps,
                                        void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || N < 1 || N > 32 || steps < 1)
    return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < N) G <<= 1;
  if (!pow2(cols) || cols * G < 32 || cols * G > SS_MAX_THREADS
      || ss_smem(G, cols, steps) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch_sscan<1>(x, dt, b, c, a, h0, y, hT, B, T, D, N,
                                   cols, steps, s);
    case 2: return launch_sscan<2>(x, dt, b, c, a, h0, y, hT, B, T, D, N,
                                   cols, steps, s);
    case 4: return launch_sscan<4>(x, dt, b, c, a, h0, y, hT, B, T, D, N,
                                   cols, steps, s);
    case 8: return launch_sscan<8>(x, dt, b, c, a, h0, y, hT, B, T, D, N,
                                   cols, steps, s);
    case 16: return launch_sscan<16>(x, dt, b, c, a, h0, y, hT, B, T, D, N,
                                     cols, steps, s);
    default: return launch_sscan<32>(x, dt, b, c, a, h0, y, hT, B, T, D, N,
                                     cols, steps, s);
  }
}
