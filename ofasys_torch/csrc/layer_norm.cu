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
// Backward design: one warp per row for every E (eight rows a block), as
// the forward's two-walk kernel; the second walk writes dx. The TPU
// accumulates dg and db across a grid walked in order, in VMEM; Hopper
// blocks run in no order. Here each block owns a fixed chunk of consecutive
// rows, each of its warps sums dy * xhat and dy for its rows into its own
// fp32 columns in shared memory, and the block writes the sum of its warps,
// in warp order, as one (2, E) partial. A second launch, part of B6-bwd,
// sums the partials in chunk order. No atomics: the bits are the same from
// run to run.
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

// dg and db: the partials summed in chunk order, one thread per column
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dg,
                                     float* __restrict__ db, int chunks, int E) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * E) return;
  float t = 0.f;
  for (int k = 0; k < chunks; ++k) t += part[(size_t)k * 2 * E + c];
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

template <typename T>
cudaError_t bwd(const void* x, const void* g, const void* mu, const void* rstd, const void* dy,
                void* dx, void* dg, void* db, void* part, int N, int E, int chunks,
                int rows_per_block, int vec, cudaStream_t stream) {
  int warps = kWarps;
  while (warps > 1 && sizeof(float) * 2 * (size_t)E * warps > kMaxSmem) warps /= 2;
  if (sizeof(float) * 2 * (size_t)E * warps > kMaxSmem) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  cudaError_t err = vec
      ? bwd_launch<T, V>(x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, warps, stream)
      : bwd_launch<T, 1>(x, g, mu, rstd, dy, dx, part, N, E, chunks, rows_per_block, warps, stream);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  ln_bwd_reduce_kernel<<<(2 * E + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dg), static_cast<float*>(db),
      chunks, E);
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
extern "C" int layer_norm_bwd(const void* x, const void* g, const void* mu, const void* rstd,
                              const void* dy, void* dx, void* dg, void* db, void* part, int N,
                              int E, int chunks, int rows_per_block, int vec, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || E <= 0 || chunks <= 0 || (long long)chunks * rows_per_block < N)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd<__nv_bfloat16>(x, g, mu, rstd, dy, dx, dg, db, part, N, E, chunks,
                                   rows_per_block, vec, s);
  if (dtype == 1)
    return (int)bwd<float>(x, g, mu, rstd, dy, dx, dg, db, part, N, E, chunks, rows_per_block,
                           vec, s);
  return (int)cudaErrorInvalidValue;
}
