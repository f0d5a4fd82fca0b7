// LayerNorm forward and backward over the rows of an (N, E) matrix, Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of ofasys_tpu/ops/pallas_layernorm.py:
//   * `_ln_fwd_kernel` (kernel B6-fwd): per row, in fp32,
//       mu = mean(x),  var = mean(x * x) - mu * mu   (the fast-variance form)
//       rstd = 1 / sqrt(var + eps),  y = (x - mu) * rstd * g + b
//     y in x's dtype, mu and rstd (N,) fp32 saved for the backward.
//   * `_ln_bwd_kernel` (kernel B6-bwd): per row, xhat = (x - mu) * rstd,
//       dxhat = dy * g,  m1 = mean(dxhat),  m2 = mean(dxhat * xhat)
//       dx = (dxhat - m1 - xhat * m2) * rstd   (in x's dtype)
//     and dg = sum_rows dy * xhat, db = sum_rows dy in fp32.
// x and dy are bf16 or fp32; g and b fp32 (E,).
//
// What bounds them on the H100: both are bound by bytes. At the training
// shape N = 12,288, E = 768 in bf16 the forward moves 37.8 MB (x read, y
// written, g, b, mu and rstd), 11 us at 3.35 TB/s, and 151 MB at fc2_ln's
// E = 3,072, 45 us; the backward 56.7 MB (x and dy read, dx written), 17
// us. About ten fp32 operations per element is far below what the card
// could do in that time.
//
// Forward design: each row of x is read from device memory once and held in
// registers between the sums and the normalisation. A group of W warps
// takes a row (W = 1 up to E = 1,024; 2-8 above, about three vectors a
// lane), each lane P 16-byte vectors (8 bf16 or 4 fp32), P a compile-time
// constant so that all of a lane's loads are issued before the first add;
// the group's warp sums meet in shared memory in warp order. g and b come
// as 16-byte vectors, once per lane, and y goes out in 16-byte stores. The
// geometry (W, P) is ops/layer_norm.py `ln_fwd_plan`, instantiated for the
// widths of the arch table and their FFN widths (256 to 11,264) in bf16 and
// fp32. Any other E, or a row off a 16-byte boundary, takes the two-walk
// kernel: one warp per row (eight rows a block), each lane walking the row
// in 16-byte vectors (one element at a time where E or an address does not
// allow it), the sums by warp shuffles, then a second walk (from L1) that
// writes y.
//
// Backward design, at the forward's widths: the row in registers, read
// from device memory once (ln_bwd_rows_kernel). A group of W warps takes a
// row, each lane P 16-byte vectors of x and of dy in ln_fwd_rows_kernel's
// layout; the group's two row sums meet in shared memory in warp order, and
// dx is formed from the registers and stored in 16-byte stores. The kernel
// moves x and dy once and dx once, where the two-walk kernel reads x and dy
// twice (at E = 3,072 its second walk misses L1). The loads of the rows to
// come are in flight while a row is worked on: each lane copies its own
// vectors one row ahead into a ring of two row buffers in shared memory
// (cp.async), which hold no registers while in flight. A lane owns the same
// columns in every row of its group, so g is read once a block and the
// lane's dg and db are fp32 sums carried across the group's rows: in
// registers, or in the lane's own words of shared memory where the
// registers would not hold them (ops/layer_norm.py `ln_bwd_plan`). The grid
// is persistent: one or two blocks a SM, each owning a fixed chunk of
// consecutive rows that its groups take in a fixed order
// (`ln_bwd_partition`); a block sums its groups in group order into one
// (2, E) partial. The TPU accumulates dg and db across a grid walked in
// order, in VMEM; Hopper blocks run in no order, so a second launch, part of
// B6-bwd, sums the partials in chunk order, 32 columns a block and four
// fixed-order accumulators a thread. No atomics: the bits are the same from
// run to run.
//
// Any other E, or a row off a 16-byte boundary, takes the two-walk kernel:
// one warp per row, eight rows a block (fewer where E is large), the sums on
// a first walk, dx on a second; each warp sums dg and db for its rows into
// its own fp32 columns in shared memory, and the block writes the sum of its
// warps, in warp order, as its partial.
//
// C interface, loaded with ctypes; every entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may opt in to

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive elements: one 16-byte access when V > 1, else one element
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_float(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "vectors are 16 bytes");
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_float(e[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (V == 1) {
    p[0] = from_float<T>(v[0]);
  } else {
    alignas(16) T e[V];
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_float<T>(v[k]);
    *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(e);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu_out,
              float* __restrict__ rstd_out, int N, int E, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= N) return;
  const T* xr = x + (size_t)row * E;
  T* yr = y + (size_t)row * E;
  const int nv = E / V;
  float s = 0.f, s2 = 0.f;
  for (int i = lane; i < nv; i += 32) {
    float v[V];
    load_vec<T, V>(xr + (size_t)i * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s += v[k];
      s2 = fmaf(v[k], v[k], s2);
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = __fdiv_rn(s, (float)E);
  const float var = __fsub_rn(__fdiv_rn(s2, (float)E), __fmul_rn(mean, mean));
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = lane; i < nv; i += 32) {
    float v[V];
    load_vec<T, V>(xr + (size_t)i * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = i * V + k;
      const float xhat = __fmul_rn(__fsub_rn(v[k], mean), rstd);
      v[k] = __fadd_rn(__fmul_rn(xhat, g[c]), b[c]);
    }
    store_vec<T, V>(yr + (size_t)i * V, v);
  }
  if (lane == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// The row held in registers: a group of W warps per row, P 16-byte vectors
// a lane; vector i of the row sits in lane i % 32 of warp (i / 32) % W of
// the group, slot i / (32 W). Slots past the row's end hold zeros.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ln_fwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu_out,
                   float* __restrict__ rstd_out, int N, int E, float eps, int W) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float part[2][kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = warp / W, wig = warp % W;
  const int row = blockIdx.x * (blockDim.x / (32 * W)) + grp;
  const bool live = row < N;
  const int nv = E / V, stride = 32 * W;
  const size_t base = (size_t)(live ? row : 0) * E;
  int4 raw[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = p * stride + wig * 32 + lane;
    raw[p] = live && i < nv ? *reinterpret_cast<const int4*>(x + base + (size_t)i * V)
                            : make_int4(0, 0, 0, 0);
  }
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const T* e = reinterpret_cast<const T*>(&raw[p]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = to_float(e[k]);
      s += v;
      s2 = fmaf(v, v, s2);
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (W > 1) {
    if (lane == 0) {
      part[0][warp] = s;
      part[1][warp] = s2;
    }
    __syncthreads();
    s = 0.f;
    s2 = 0.f;
    for (int w = grp * W; w < grp * W + W; ++w) {
      s += part[0][w];
      s2 += part[1][w];
    }
  }
  if (!live) return;
  const float mean = __fdiv_rn(s, (float)E);
  const float var = __fsub_rn(__fdiv_rn(s2, (float)E), __fmul_rn(mean, mean));
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = p * stride + wig * 32 + lane;
    if (i >= nv) continue;
    float gv[V], bv[V];
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      *reinterpret_cast<float4*>(gv + k) = *reinterpret_cast<const float4*>(g + i * V + k);
      *reinterpret_cast<float4*>(bv + k) = *reinterpret_cast<const float4*>(b + i * V + k);
    }
    const T* e = reinterpret_cast<const T*>(&raw[p]);
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xhat = __fmul_rn(__fsub_rn(to_float(e[k]), mean), rstd);
      v[k] = __fadd_rn(__fmul_rn(xhat, gv[k]), bv[k]);
    }
    store_vec<T, V>(y + base + (size_t)i * V, v);
  }
  if (wig == 0 && lane == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
              int N, int E, int rows_per_block) {
  extern __shared__ float acc[];      // per warp: dg (E), db (E)
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ag = acc + (size_t)warp * 2 * E;
  float* ab = ag + E;
  for (int c = lane; c < 2 * E; c += 32) ag[c] = 0.f;
  __syncwarp();
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(N, r0 + rows_per_block);
  const int nv = E / V;
  for (int row = r0 + warp; row < r1; row += warps) {
    const float m = mu[row], rs = rstd[row];
    const T* xr = x + (size_t)row * E;
    const T* dyr = dy + (size_t)row * E;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < nv; i += 32) {
      float xv[V], dv[V];
      load_vec<T, V>(xr + (size_t)i * V, xv);
      load_vec<T, V>(dyr + (size_t)i * V, dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = i * V + k;
        const float xhat = __fmul_rn(__fsub_rn(xv[k], m), rs);
        const float dxhat = __fmul_rn(dv[k], g[c]);
        s1 += dxhat;
        s2 = fmaf(dxhat, xhat, s2);
        ag[c] = fmaf(dv[k], xhat, ag[c]);
        ab[c] += dv[k];
      }
    }
    const float m1 = __fdiv_rn(warp_sum(s1), (float)E);
    const float m2 = __fdiv_rn(warp_sum(s2), (float)E);
    T* dxr = dx + (size_t)row * E;
    for (int i = lane; i < nv; i += 32) {
      float xv[V], dv[V];
      load_vec<T, V>(xr + (size_t)i * V, xv);
      load_vec<T, V>(dyr + (size_t)i * V, dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = i * V + k;
        const float xhat = __fmul_rn(__fsub_rn(xv[k], m), rs);
        const float dxhat = __fmul_rn(dv[k], g[c]);
        dv[k] = __fmul_rn(__fsub_rn(__fsub_rn(dxhat, m1), __fmul_rn(xhat, m2)), rs);
      }
      store_vec<T, V>(dxr + (size_t)i * V, dv);
    }
  }
  __syncthreads();
  // this block's partial: its warps' sums, in warp order
  float* pg = part + (size_t)blockIdx.x * 2 * E;
  for (int c = threadIdx.x; c < 2 * E; c += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += acc[(size_t)w * 2 * E + c];
    pg[c] = t;
  }
}

// bar.sync on barrier `id` (1-15) for `threads` threads: one group's warps
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The row held in registers (B6-bwd at the arch table's widths). A block
// of G = 8 / W groups of W warps owns the chunk of rows [r0, r1); group q
// takes rows r0 + q, r0 + q + G, ... in order. Vector i of a row sits in
// lane i % 32 of warp (i / 32) % W of the group, slot i / (32 W), as in
// ln_fwd_rows_kernel, so a lane owns the same columns in every row:
//   * x and dy: with a ring of S = kRing row buffers a group, each lane
//     copies its own 16-byte vectors of the next row, and that row's mu
//     and rstd, into the ring (cp.async: the copies hold no registers
//     while in flight), then moves the current row into registers; with
//     S = 0 (where the ring does not fit) it loads the row, mu and rstd
//     straight into registers at the top of the row. Either way x and dy
//     are read from device memory once.
//   * g is read from device memory once a block, in 16-byte loads, into
//     shared memory in the lanes' order, where each lane reads its own.
//   * dg and db are fp32 sums carried across the group's rows: in registers
//     (kSmemAcc false) or, where they would not fit, in the lane's own words
//     of shared memory (kSmemAcc true, one group a block).
// Shared memory by lanes: word ((p W + wig) V + k) 32 + lane of an array of
// P W V 32 floats holds column (p 32 W + 32 wig + lane) V + k of the lane's
// slot p, so a lane touches only its own words, on its own bank (g in the
// same order, as float4s). At the end the groups' sums meet in group order
// and the block writes one (2, E) partial. Dynamic shared memory, in this
// order: the row buffers (S G (2 P + 1) 32 W int4s: x, dy, and each lane's
// copy of the row's mu and rstd), g (P 32 W V floats), and the accumulators
// or the buffer the groups meet in (2 P 32 W V floats, when kSmemAcc or
// G > 1); ops/layer_norm.py `ln_bwd_smem` is its size.
constexpr int kRing = 2;   // row buffers a group: the next row in flight

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}

// wait until at most kRing - 1 of this thread's newest copy groups are
// still in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  static_assert(kRing == 2, "the wait below leaves kRing - 1 groups in flight");
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

template <typename T, int P, bool kSmemAcc>
__global__ void __launch_bounds__(kThreads, kSmemAcc ? 1 : 2)
ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ mu, const float* __restrict__ rstd,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                   int N, int E, int W, int S, int rows_per_block) {
  constexpr int V = 16 / sizeof(T);
  constexpr int A = kSmemAcc ? 1 : P;          // slots of register accumulators
  extern __shared__ int4 smem[];
  __shared__ float rsum[2][2][kWarps];         // row sums of each warp, by row parity
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int G = blockDim.x / (32 * W), grp = warp / W, wig = warp % W;
  const int nv = E / V, stride = 32 * W, first = wig * 32 + lane, words = P * stride * V;
  // the block's rows: row_of(t) for t < count, group grp taking t = grp, grp + G, ...
  const int r0 = blockIdx.x * rows_per_block, count = min(N, r0 + rows_per_block) - r0;
  auto row_of = [&](int t) { return r0 + t; };
  const int bufsz = (2 * P + 1) * stride;      // a row buffer: x, dy, each lane's mu and rstd
  int4* ring = smem + (size_t)grp * S * bufsz;  // this group's row buffers
  float4* gs = reinterpret_cast<float4*>(smem + (size_t)G * S * bufsz);
  float* sacc = reinterpret_cast<float*>(gs) + words;
  auto word = [&](int p, int k) { return ((p * W + wig) * V + k) * 32 + lane; };
  auto gword = [&](int p, int k4) { return ((p * W + wig) * (V / 4) + k4) * 32 + lane; };

  if (grp == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = p * stride + first;
#pragma unroll
      for (int k4 = 0; k4 < V / 4; ++k4)
        gs[gword(p, k4)] = i < nv ? *reinterpret_cast<const float4*>(g + i * V + 4 * k4)
                                  : make_float4(0, 0, 0, 0);
    }
  }
  float ag[A][V], ab[A][V];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (kSmemAcc) {
        sacc[word(p, k)] = 0.f;
        sacc[words + word(p, k)] = 0.f;
      } else {
        ag[p][k] = 0.f;
        ab[p][k] = 0.f;
      }
    }
  }
  __syncthreads();

  // copies of the group's j-th row into ring buffer j % S (`fill`, which
  // turns round with j): one commit group a row
  int4* lane_ring = ring + first;
  int fill = 0;
  auto issue = [&](int j) {
    const int t = grp + j * G;
    if (t < count) {
      int4* buf = lane_ring + fill * bufsz;
      const int row = row_of(t);
      const T* xrow = x + (size_t)row * E + first * V;
      const T* dyrow = dy + (size_t)row * E + first * V;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (p * stride + first < nv) {
          cp_async16(buf + p * stride, xrow + p * stride * V);
          cp_async16(buf + (P + p) * stride, dyrow + p * stride * V);
        }
      }
      float* stats = reinterpret_cast<float*>(buf + 2 * P * stride);
      cp_async4(stats, mu + row);
      cp_async4(stats + 1, rstd + row);
    }
    cp_async_commit();
    fill = fill + 1 == S ? 0 : fill + 1;
  };
  for (int j = 0; j < S - 1; ++j) issue(j);

  int4 xr[P], dr[P];
  int it = 0, drain = 0;               // drain: the buffer of row it
  for (int t = grp; t < count; t += G, ++it) {
    const int row = row_of(t);
    float m, rs;
    if (S > 0) {
      issue(it + S - 1);             // into the buffer row it - 1 was read from
      cp_async_wait_ring();
      const int4* buf = lane_ring + drain * bufsz;
      drain = drain + 1 == S ? 0 : drain + 1;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool in = p * stride + first < nv;
        xr[p] = in ? buf[p * stride] : make_int4(0, 0, 0, 0);
        dr[p] = in ? buf[(P + p) * stride] : make_int4(0, 0, 0, 0);
      }
      const int4 stats = buf[2 * P * stride];
      m = __int_as_float(stats.x);
      rs = __int_as_float(stats.y);
    } else {                         // all loads issued before any is used
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = p * stride + first;
        const size_t at = (size_t)row * E + (size_t)i * V;
        xr[p] = i < nv ? *reinterpret_cast<const int4*>(x + at) : make_int4(0, 0, 0, 0);
        dr[p] = i < nv ? *reinterpret_cast<const int4*>(dy + at) : make_int4(0, 0, 0, 0);
      }
      m = mu[row];
      rs = rstd[row];
    }
    // xhat = x rs - mu rs and dx = dxhat rs - m1 rs - xhat m2 rs, each an fma
    const float mrs = m * rs;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const T* xe = reinterpret_cast<const T*>(&xr[p]);
      const T* de = reinterpret_cast<const T*>(&dr[p]);
#pragma unroll
      for (int k4 = 0; k4 < V / 4; ++k4) {
        const float4 g4 = gs[gword(p, k4)];
        const float gk[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * k4 + kk;
          const float d = to_float(de[k]);
          const float xhat = fmaf(to_float(xe[k]), rs, -mrs);
          const float dxhat = d * gk[kk];
          s1 += dxhat;
          s2 = fmaf(dxhat, xhat, s2);
          if constexpr (kSmemAcc) {
            sacc[word(p, k)] = fmaf(d, xhat, sacc[word(p, k)]);
            sacc[words + word(p, k)] += d;
          } else {
            ag[p][k] = fmaf(d, xhat, ag[p][k]);
            ab[p][k] += d;
          }
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (W > 1) {                                 // the group's warps, in warp order
      float* rp = rsum[it & 1][0];
      if (lane == 0) {
        rp[warp] = s1;
        rp[kWarps + warp] = s2;
      }
      group_sync(1 + grp, 32 * W);
      s1 = 0.f;
      s2 = 0.f;
      for (int w = grp * W; w < grp * W + W; ++w) {
        s1 += rp[w];
        s2 += rp[kWarps + w];
      }
    }
    const float m1 = __fdiv_rn(s1, (float)E), m2 = __fdiv_rn(s2, (float)E);
    const float c0 = -(m1 * rs), c1 = -(m2 * rs);
    T* dxrow = dx + (size_t)row * E + first * V;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p * stride + first >= nv) continue;
      const T* xe = reinterpret_cast<const T*>(&xr[p]);
      const T* de = reinterpret_cast<const T*>(&dr[p]);
      float v[V];
#pragma unroll
      for (int k4 = 0; k4 < V / 4; ++k4) {
        const float4 g4 = gs[gword(p, k4)];
        const float gk[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * k4 + kk;
          const float xhat = fmaf(to_float(xe[k]), rs, -mrs);
          v[k] = fmaf(to_float(de[k]) * gk[kk], rs, fmaf(xhat, c1, c0));
        }
      }
      store_vec<T, V>(dxrow + p * stride * V, v);
    }
  }

  // the block's partial: its groups' sums in group order (G = 1 with kSmemAcc)
  float* pg = part + (size_t)blockIdx.x * 2 * E;
  for (int q = 0; q < G; ++q) {
    if (grp == q) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = p * stride + first;
        if (i >= nv) continue;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int w = word(p, k);
          float tg, tb;
          if constexpr (kSmemAcc) {
            tg = sacc[w];
            tb = sacc[words + w];
          } else {
            tg = q > 0 ? sacc[w] + ag[p][k] : ag[p][k];
            tb = q > 0 ? sacc[words + w] + ab[p][k] : ab[p][k];
          }
          if (q == G - 1) {
            pg[i * V + k] = tg;
            pg[E + i * V + k] = tb;
          } else {
            sacc[w] = tg;
            sacc[words + w] = tb;
          }
        }
      }
    }
    if (G > 1) __syncthreads();
  }
}

// dg and db: the blocks' (2, E) partials summed in chunk order. A block
// takes 32 of the 2E columns; thread (c, y) of its 32 x 8 sums the chunks
// y, y + 8, ... in four fixed-order accumulators (chunk 32 j + 8 a + y in
// accumulator a), adds them in order, and the eight y's meet in shared memory
// in y order.
constexpr int kRedCols = 32, kRedRows = 8, kRedAcc = 4;

__global__ void __launch_bounds__(kRedCols * kRedRows)
ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dg,
                     float* __restrict__ db, int chunks, int E) {
  __shared__ float sums[kRedRows][kRedCols];
  const int tx = threadIdx.x % kRedCols, ty = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + tx;
  float a[kRedAcc] = {};
  if (c < 2 * E) {
    const float* col = part + c;
    int k = ty;
    for (; k + (kRedAcc - 1) * kRedRows < chunks; k += kRedAcc * kRedRows) {
#pragma unroll
      for (int j = 0; j < kRedAcc; ++j) a[j] += col[(size_t)(k + j * kRedRows) * 2 * E];
    }
#pragma unroll
    for (int j = 0; j < kRedAcc - 1; ++j)
      if (k + j * kRedRows < chunks) a[j] += col[(size_t)(k + j * kRedRows) * 2 * E];
  }
  float t = a[0];
#pragma unroll
  for (int j = 1; j < kRedAcc; ++j) t += a[j];
  sums[ty][tx] = t;
  __syncthreads();
  if (ty != 0 || c >= 2 * E) return;
  t = sums[0][tx];
  for (int y = 1; y < kRedRows; ++y) t += sums[y][tx];
  if (c < E) dg[c] = t;
  else db[c - E] = t;
}

template <typename T>
cudaError_t fwd_two_walk(const void* x, const void* g, const void* b, void* y, void* mu,
                         void* rstd, int N, int E, float eps, int vec, cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    ln_fwd_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<T*>(y), static_cast<float*>(mu), static_cast<float*>(rstd), N, E, eps);
  } else {
    ln_fwd_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<T*>(y), static_cast<float*>(mu), static_cast<float*>(rstd), N, E, eps);
  }
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t fwd_rows_launch(const void* x, const void* g, const void* b, void* y, void* mu,
                            void* rstd, int N, int E, float eps, int W, cudaStream_t stream) {
  const int rows = W < kWarps ? kWarps / W : 1;       // rows a block
  ln_fwd_rows_kernel<T, P><<<(N + rows - 1) / rows, 32 * W * rows, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(mu), static_cast<float*>(rstd), N, E, eps, W);
  return cudaGetLastError();
}

// the slot counts P that ops/layer_norm.py `ln_fwd_plan` gives the widths
// it takes (LN_SLOTS there)
template <typename T>
cudaError_t fwd_rows(const void* x, const void* g, const void* b, void* y, void* mu, void* rstd,
                     int N, int E, float eps, int W, int P, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (W < 1 || W > kWarps || E % V || 32 * W * P < E / V || 32 * W * (P - 1) >= E / V)
    return cudaErrorInvalidValue;
  switch (P) {
    case 1: return fwd_rows_launch<T, 1>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    case 2: return fwd_rows_launch<T, 2>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    case 3: return fwd_rows_launch<T, 3>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    case 4: return fwd_rows_launch<T, 4>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    case 5: return fwd_rows_launch<T, 5>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    case 6: return fwd_rows_launch<T, 6>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    case 8: return fwd_rows_launch<T, 8>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    case 10: return fwd_rows_launch<T, 10>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    case 11: return fwd_rows_launch<T, 11>(x, g, b, y, mu, rstd, N, E, eps, W, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int V>
cudaError_t bwd_launch(const void* x, const void* g, const void* mu, const void* rstd,
                       const void* dy, void* dx, void* part, int N, int E, int chunks,
                       int rows_per_block, int warps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)E * warps;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ln_bwd_kernel<T, V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  ln_bwd_kernel<T, V><<<chunks, warps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part), N, E, rows_per_block);
  return cudaGetLastError();
}

// the two-walk pass (any E): as many warps a block as their (2, E) fp32
// accumulators let fit in shared memory
template <typename T>
cudaError_t bwd_two_walk(const void* x, const void* g, const void* mu, const void* rstd,
                         const void* dy, void* dx, void* part, int N, int E, int chunks,
                         int rows_per_block, int vec, cudaStream_t stream) {
  int warps = kWarps;
  while (warps > 1 && sizeof(float) * 2 * (size_t)E * warps > kMaxSmem) warps /= 2;
  if (sizeof(float) * 2 * (size_t)E * warps > kMaxSmem) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  return vec
      ? bwd_launch<T, V>(x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, warps, stream)
      : bwd_launch<T, 1>(x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, warps, stream);
}

template <typename T, int P, bool kSmemAcc>
cudaError_t bwd_rows_launch(const void* x, const void* g, const void* mu, const void* rstd,
                            const void* dy, void* dx, void* part, int N, int E, int chunks,
                            int rows_per_block, int W, int S, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int G = kWarps / W;
  const size_t stride = 32 * W;
  // the row buffers, g, and the accumulators or the buffer the groups meet in
  const size_t smem = 16 * stride * (2 * P + 1) * S * G +
                      sizeof(float) * stride * P * V * (kSmemAcc || G > 1 ? 3 : 1);
  if (smem + sizeof(float) * 2 * 2 * kWarps > kMaxSmem)     // and the static row sums
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ln_bwd_rows_kernel<T, P, kSmemAcc>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  ln_bwd_rows_kernel<T, P, kSmemAcc><<<chunks, 32 * W * G, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part), N, E, W, S, rows_per_block);
  return cudaGetLastError();
}

// the (slots, accumulator) pairs that ops/layer_norm.py `ln_bwd_plan` gives
// the widths it takes, per dtype (LN_BWD_SLOTS there); the shared-memory
// accumulators take one group of eight warps a block
#define LN_BWD_ARGS x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, W, S, s
cudaError_t bwd_rows_bf16(const void* x, const void* g, const void* mu, const void* rstd,
                          const void* dy, void* dx, void* part, int N, int E, int chunks,
                          int rows_per_block, int W, int P, int smem_acc, int S,
                          cudaStream_t s) {
  using T = __nv_bfloat16;
  if (!smem_acc) {
    switch (P) {
      case 1: return bwd_rows_launch<T, 1, false>(LN_BWD_ARGS);
      case 2: return bwd_rows_launch<T, 2, false>(LN_BWD_ARGS);
      case 3: return bwd_rows_launch<T, 3, false>(LN_BWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (P) {
    case 5: return bwd_rows_launch<T, 5, true>(LN_BWD_ARGS);
    case 6: return bwd_rows_launch<T, 6, true>(LN_BWD_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t bwd_rows_fp32(const void* x, const void* g, const void* mu, const void* rstd,
                          const void* dy, void* dx, void* part, int N, int E, int chunks,
                          int rows_per_block, int W, int P, int smem_acc, int S,
                          cudaStream_t s) {
  using T = float;
  if (!smem_acc) {
    switch (P) {
      case 2: return bwd_rows_launch<T, 2, false>(LN_BWD_ARGS);
      case 3: return bwd_rows_launch<T, 3, false>(LN_BWD_ARGS);
      case 4: return bwd_rows_launch<T, 4, false>(LN_BWD_ARGS);
      case 5: return bwd_rows_launch<T, 5, false>(LN_BWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (P) {
    case 10: return bwd_rows_launch<T, 10, true>(LN_BWD_ARGS);
    case 11: return bwd_rows_launch<T, 11, true>(LN_BWD_ARGS);
    default: return cudaErrorInvalidValue;
  }
}
#undef LN_BWD_ARGS

template <typename T>
cudaError_t bwd_rows(const void* x, const void* g, const void* mu, const void* rstd,
                     const void* dy, void* dx, void* part, int N, int E, int chunks,
                     int rows_per_block, int W, int P, int smem_acc, int S, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (W < 1 || W > kWarps || E % V || 32 * W * P < E / V || 32 * W * (P - 1) >= E / V ||
      (smem_acc && W != kWarps) || !(S == 0 || S == kRing))
    return cudaErrorInvalidValue;
  return sizeof(T) == 2
      ? bwd_rows_bf16(x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, W, P, smem_acc,
                      S, s)
      : bwd_rows_fp32(x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, W, P, smem_acc,
                      S, s);
}

// parts: 1 the per-chunk pass (dx and the partials), 2 the reduction of
// the partials into dg and db, 3 both (what B6-bwd runs)
template <typename T>
cudaError_t bwd(const void* x, const void* g, const void* mu, const void* rstd, const void* dy,
                void* dx, void* dg, void* db, void* part, int N, int E, int chunks,
                int rows_per_block, int W, int P, int smem_acc, int ring, int vec, int parts,
                cudaStream_t stream) {
  if (parts & 1) {
    cudaError_t err = W > 0
        ? bwd_rows<T>(x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, W, P, smem_acc,
                      ring, stream)
        : bwd_two_walk<T>(x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, vec,
                          stream);
    if (err != cudaSuccess) return err;
  }
  if (parts & 2) {
    ln_bwd_reduce_kernel<<<(2 * E + kRedCols - 1) / kRedCols, kRedCols * kRedRows, 0, stream>>>(
        static_cast<const float*>(part), static_cast<float*>(dg), static_cast<float*>(db),
        chunks, E);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x and y share it). warps > 0: the row
// held in registers, `warps` warps a row and `slots` 16-byte vectors a
// lane (x, y, g and b 16-byte aligned); warps = 0: the two-walk kernel,
// with vec = 1 when E is a multiple of 16 bytes' worth of elements and
// every row pointer is 16-byte aligned. mu and rstd are fp32 (N,).
extern "C" int layer_norm_fwd(const void* x, const void* g, const void* b, void* y, void* mu,
                              void* rstd, int N, int E, float eps, int warps, int slots, int vec,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  if (warps > 0) {
    if (dtype == 0)
      return (int)fwd_rows<__nv_bfloat16>(x, g, b, y, mu, rstd, N, E, eps, warps, slots, s);
    if (dtype == 1) return (int)fwd_rows<float>(x, g, b, y, mu, rstd, N, E, eps, warps, slots, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return (int)fwd_two_walk<__nv_bfloat16>(x, g, b, y, mu, rstd, N, E, eps, vec, s);
  if (dtype == 1) return (int)fwd_two_walk<float>(x, g, b, y, mu, rstd, N, E, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}

// part is fp32 scratch (chunks, 2, E); block k owns rows
// [k * rows_per_block, (k + 1) * rows_per_block). dg and db are fp32 (E,).
// warps > 0: the row held in registers, `warps` warps a row, `slots`
// 16-byte vectors a lane, dg and db carried in registers (smem_acc = 0) or
// in shared memory (1), `ring` row buffers a group (kRing, or 0: loads
// straight into registers); x, dy, dx and g 16-byte aligned. warps = 0:
// the two-walk kernel, vec as for layer_norm_fwd. parts as in `bwd`.
extern "C" int layer_norm_bwd(const void* x, const void* g, const void* mu, const void* rstd,
                              const void* dy, void* dx, void* dg, void* db, void* part, int N,
                              int E, int chunks, int rows_per_block, int warps, int slots,
                              int smem_acc, int ring, int vec, int dtype, int parts,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || E <= 0 || chunks <= 0 || (long long)chunks * rows_per_block < N ||
      (long long)(chunks - 1) * rows_per_block >= N || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd<__nv_bfloat16>(x, g, mu, rstd, dy, dx, dg, db, part, N, E, chunks,
                                   rows_per_block, warps, slots, smem_acc, ring, vec, parts, s);
  if (dtype == 1)
    return (int)bwd<float>(x, g, mu, rstd, dy, dx, dg, db, part, N, E, chunks, rows_per_block,
                           warps, slots, smem_acc, ring, vec, parts, s);
  return (int)cudaErrorInvalidValue;
}
