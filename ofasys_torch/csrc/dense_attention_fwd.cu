// Dense (whole-row) attention forward for short sequences, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_fwd_kernel_g` of
// ofasys_tpu/ops/pallas_dense_attention.py (kernel B1). Same function:
// for every sample b, head h and query row i,
//   s_j   = q_i . k_j  (fp32 sum of the storage-dtype products; q arrives
//           pre-scaled, the scale inside the kernel is 1)
//         + bias[h, i, j]            (bf16, shared by the batch)
//   s_j   = -1e9 where mask[b, j] == 0  (the row max includes these values)
//   m     = max_j s_j,  p_j = exp(s_j - m),  l = sum_j p_j  (all fp32)
//   out_i = (sum_j round(p_j) v_j) / l   with round() to the storage dtype,
//           the sum in fp32, the result stored in the storage dtype
//   lse_i = m + log(l)                   (fp32; the backward, B2, needs it)
// q/out are (B, Tq, E) and k/v (B, Tk, E) with E = H * D: heads are sliced
// inside the kernel, so the projection GEMMs' outputs are used as they are.
//
// What bounds it on the H100: at the serving shape B = 8, T = 128, E = 768,
// H = 12 it moves about 6.7 MB (q, k, v and out in bf16 plus the bf16 bias),
// about 2 us at 3.35 TB/s, and does 0.4 GFLOP, about 0.4 us at 989 TFLOP/s.
// It is bound by memory traffic and, at this size, by the launch itself.
//
// Design: one block per (query tile of kRows rows, head, sample). The block
// stages its q rows and one chunk of K (then V) rows at a time in shared
// memory as fp32 (row stride D + 1 floats, so the threads of a warp walking
// down the keys hit distinct banks), keeps the tile's whole score rows
// (Tk <= 256) in shared memory, and writes nothing but out and lse to device
// memory: scores and probabilities never leave the SM, and every input byte
// is read from device memory once per query tile (the repeats of K and V
// across the Tq / kRows tiles of one (b, h) hit the 50 MB L2). The score and
// p.V products run on the CUDA cores in fp32; tensor cores (mma.sync /
// wgmma) and TMA staging are later work. Softmax is one warp per row.
//
// C interface, loaded with ctypes; returns cudaGetLastError() so the caller
// can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRows = 16;       // query rows per block
constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const __nv_bfloat16* __restrict__ bias,
                           const int8_t* __restrict__ mask, T* __restrict__ out,
                           float* __restrict__ lse, int H, int Tq, int Tk, int D, int kc) {
  extern __shared__ float smem[];
  const int E = H * D;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, Tq - row0);
  const int ld = D + 1;
  const int tid = threadIdx.x;

  float* qs = smem;                   // kRows x D: q rows, later the p.V sums
  float* ss = qs + kRows * D;         // kRows x Tk: scores, then rounded p
  float* kv = ss + kRows * Tk;        // kc x (D + 1): one chunk of K or V rows
  float* ls = kv + kc * ld;           // kRows: softmax denominators

  const size_t q_base = ((size_t)b * Tq + row0) * E + (size_t)h * D;
  const size_t kv_base = (size_t)b * Tk * E + (size_t)h * D;

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qs[i] = to_float(q[q_base + (size_t)r * E + d]);
  }

  // scores, one chunk of keys at a time
  for (int j0 = 0; j0 < Tk; j0 += kc) {
    const int n = min(kc, Tk - j0);
    __syncthreads();
    for (int i = tid; i < n * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      kv[j * ld + d] = to_float(k[kv_base + (size_t)(j0 + j) * E + d]);
    }
    __syncthreads();
    for (int i = tid; i < rows * n; i += kThreads) {
      const int r = i / n, j = i - r * n;
      const float* qr = qs + r * D;
      const float* kr = kv + j * ld;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      ss[r * Tk + j0 + j] = acc;
    }
  }
  __syncthreads();

  // softmax: one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const int row = row0 + r;
    float* sr = ss + r * Tk;
    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      float s = sr[j];
      if (bias != nullptr) s += __bfloat162float(bias[((size_t)h * Tq + row) * Tk + j]);
      if (mask != nullptr && mask[(size_t)b * Tk + j] == 0) s = kMaskValue;
      sr[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float p = expf(sr[j] - m);
      l += p;
      sr[j] = to_float(from_float<T>(p));
    }
    l = warp_sum(l);
    if (lane == 0) {
      ls[r] = l;
      lse[((size_t)b * H + h) * Tq + row] = m + logf(l);
    }
  }

  // p.V, one chunk of value rows at a time; thread i owns output i
  for (int i = tid; i < rows * D; i += kThreads) qs[i] = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += kc) {
    const int n = min(kc, Tk - j0);
    __syncthreads();
    for (int i = tid; i < n * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      kv[j * ld + d] = to_float(v[kv_base + (size_t)(j0 + j) * E + d]);
    }
    __syncthreads();
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* pr = ss + r * Tk + j0;
      float acc = qs[i];
      for (int j = 0; j < n; ++j) acc = fmaf(pr[j], kv[j * ld + d], acc);
      qs[i] = acc;
    }
  }

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    out[q_base + (size_t)r * E + d] = from_float<T>(qs[i] / ls[r]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, void* out, void* lse, int B, int H, int Tq, int Tk,
                   int D, cudaStream_t stream) {
  const int kc = std::max(1, std::min(Tk, 4096 / (D + 1)));
  const size_t smem = sizeof(float) * ((size_t)kRows * D + (size_t)kRows * Tk +
                                       (size_t)kc * (D + 1) + kRows);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(dense_attention_fwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  dense_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const int8_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, Tk, D, kc);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, k, v and out share it). bias is bf16
// (H, Tq, Tk) or null; mask is int8 (B, Tk) or null; lse is fp32 (B, H, Tq).
extern "C" int dense_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, void* lse,
                                   int B, int H, int Tq, int Tk, int D, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<__nv_bfloat16>(q, k, v, bias, mask, out, lse, B, H, Tq, Tk, D, s);
  } else if (dtype == 1) {
    err = launch<float>(q, k, v, bias, mask, out, lse, B, H, Tq, Tk, D, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
