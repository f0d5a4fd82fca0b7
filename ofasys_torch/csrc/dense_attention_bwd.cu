// Dense (whole-row) attention backward for short sequences, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_bwd_kernel_t` and `_bwd_kernel_tg` of
// ofasys_tpu/ops/pallas_dense_attention.py (kernel B2; the G-blocking and
// the transposed orientation there are Mosaic/VMEM workarounds). Same
// function: for every sample b, head h, query row i and key j,
//   s_ij  = (q_i . k_j) * scale + bias[h, i, j]   (fp32; the model's path passes
//                                        a pre-scaled q and scale 1)
//   s_ij  = -1e9 where mask[b, j] == 0
//   p_ij  = exp(s_ij - lse_i)           (lse from the forward, B1)
//   dv_j  = sum_i round(p_ij) do_i      (round() to the storage dtype)
//   dp_ij = do_i . v_j
//   dd_i  = sum_j dp_ij p_ij            (as the TPU kernel: not do_i . o_i,
//                                        because o was made from a rounded p)
//   ds_ij = p_ij (dp_ij - dd_i)         (fp32)
//   dbias[h, i, j] = sum_b ds_ij        (fp32, unrounded ds)
//   dq_i  = sum_j round(ds_ij * scale) k_j,   dk_j = sum_i round(ds_ij * scale) q_i
// with every sum in fp32 and dq, dk, dv stored in the storage dtype.
// q, k, v, do, dq, dk, dv are (B, T, E) with E = H * D; heads are sliced here.
//
// What bounds it on the H100: at the caption encoder's training shape
// B = 64, T = 228, E = 768, H = 12 it must move about 161 MB (read q, k, v,
// do, lse, bias, mask; write dq, dk, dv, dbias), 0.048 ms at 3.35 TB/s, and
// do 25.5 GFLOP (five (Tq, Tk, D) products, 10 B Tq Tk E), 0.026 ms at 989
// TFLOP/s: bound by bytes.
//
// Design (bf16, the model's dtype): one pass per (b, h) on the tensor cores
// (mma.sync m16n8k16 fed by ldmatrix, see dense_mma.cuh), five products.
// On the TPU one program walks the batch in order and carries dbias in
// VMEM; Hopper blocks run in parallel and in no order. So one block of 8
// warps per (range of keys, head, chunk of samples) walks its samples in
// order, keeps the range's fp32 dK and dV sums in shared memory, and walks
// the query rows 32 at a time; dbias goes through per-chunk partials summed
// in chunk order, dq through per-range partials where the keys are split.
// The kernel lives in dense_attention_bwd_mma.cuh (its header holds the
// whole design), which kernel B2r shares with the causal mask switched on;
// B2 is its instance without it.
//
// The fp32 instantiation (not on the model's path) keeps the first design
// on the CUDA cores: two passes over recomputed scores,
//   pass 1 (rows): one block per (tile of kRows query rows, head, chunk of
//     samples). For each sample of its chunk it recomputes the tile's full
//     score and dp rows (Tk <= 256 keys fit in shared memory), writes dq and
//     dd, and adds ds into a shared-memory dbias tile; at the end it stores
//     that tile as the chunk's partial sum.
//   pass 2 (cols): one block per (tile of kRows keys, head, sample). It
//     recomputes p and ds for its keys against all queries (the orientation
//     of `_bwd_kernel_t`), using pass 1's dd, and writes dk and dv.
//   reduce: dbias = the sum of the chunk partials, in chunk order.
// Operand rows are staged in shared memory as fp32 with row stride D + 1.
//
// C interface, loaded with ctypes; returns cudaGetLastError() so the caller
// can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "dense_attention_bwd_mma.cuh"

namespace {

constexpr int kRows = 16;       // query rows (pass 1) or keys (pass 2) per block
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

// x rounded to the storage dtype and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dst[r * ld + d] = src rows [row0, row0 + n) of head slice `col` in a
// (rows, E) matrix, as fp32
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                                           size_t base, int n, int D, int E) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = to_float(src[base + (size_t)r * E + d]);
  }
}

// out[r * lo + off + j] = a_r . c_j for r < na rows of a (stride la) and the
// j < nc staged rows of c (stride ld)
__device__ __forceinline__ void dot_rows(float* out, int lo, int off, const float* a, int la,
                                         int na, const float* c, int ld, int nc, int D) {
  for (int i = threadIdx.x; i < na * nc; i += kThreads) {
    const int r = i / nc, j = i - r * nc;
    const float* ar = a + r * la;
    const float* cr = c + j * ld;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(ar[d], cr[d], acc);
    out[r * lo + off + j] = acc;
  }
}

// acc[r * D + d] += sum_j w[r * lw + off + j] * c[j * ld + d] over the nc
// staged rows of c
__device__ __forceinline__ void accumulate_rows(float* acc, const float* w, int lw, int off,
                                                int na, const float* c, int ld, int nc, int D) {
  for (int i = threadIdx.x; i < na * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float* wr = w + r * lw + off;
    float a = acc[i];
    for (int j = 0; j < nc; ++j) a = fmaf(wr[j], c[j * ld + d], a);
    acc[i] = a;
  }
}

// ---------------------------------------------------------------- pass 1
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const __nv_bfloat16* __restrict__ bias, const int8_t* __restrict__ mask,
                T* __restrict__ dq, float* __restrict__ dd_out, float* __restrict__ dbias_part,
                int B, int H, int Tq, int Tk, int D, int kc, int per_chunk,
                float scale) {
  extern __shared__ float smem[];
  const int E = H * D;
  const int h = blockIdx.y;
  const int chunk = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, Tq - row0);
  const int ld = D + 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  float* qs = smem;                     // kRows x D: q rows, then the dq sums
  float* ds_ = qs + kRows * D;          // kRows x D: do rows
  float* ss = ds_ + kRows * D;          // kRows x Tk: scores, then rounded ds
  float* ps = ss + kRows * Tk;          // kRows x Tk: dp
  float* acc = ps + kRows * Tk;         // kRows x Tk: dbias partial (if wanted)
  float* kv = acc + (dbias_part != nullptr ? kRows * Tk : 0);   // kc x (D + 1)

  if (dbias_part != nullptr)
    for (int i = tid; i < rows * Tk; i += kThreads) acc[i] = 0.f;

  const int b_begin = chunk * per_chunk;
  const int b_end = min(B, b_begin + per_chunk);
  for (int b = b_begin; b < b_end; ++b) {
    const size_t q_base = ((size_t)b * Tq + row0) * E + (size_t)h * D;
    const size_t kv_base = (size_t)b * Tk * E + (size_t)h * D;
    __syncthreads();                    // the previous sample is done with qs, ds_
    stage_rows(qs, D, q, q_base, rows, D, E);
    stage_rows(ds_, D, dout, q_base, rows, D, E);

    // scores and dp, one chunk of key (value) rows at a time
    for (int j0 = 0; j0 < Tk; j0 += kc) {
      const int n = min(kc, Tk - j0);
      __syncthreads();
      stage_rows(kv, ld, k, kv_base + (size_t)j0 * E, n, D, E);
      __syncthreads();
      dot_rows(ss, Tk, j0, qs, D, rows, kv, ld, n, D);
      __syncthreads();
      stage_rows(kv, ld, v, kv_base + (size_t)j0 * E, n, D, E);
      __syncthreads();
      dot_rows(ps, Tk, j0, ds_, D, rows, kv, ld, n, D);
    }
    __syncthreads();

    // p, dd and ds: one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      const int row = row0 + r;
      const float l = lse[((size_t)b * H + h) * Tq + row];
      float* sr = ss + r * Tk;
      const float* pr = ps + r * Tk;
      float dd = 0.f;
      for (int j = lane; j < Tk; j += 32) {
        float s = sr[j] * scale;
        if (bias != nullptr) s += __bfloat162float(bias[((size_t)h * Tq + row) * Tk + j]);
        if (mask != nullptr && mask[(size_t)b * Tk + j] == 0) s = kMaskValue;
        const float p = expf(s - l);
        sr[j] = p;
        dd = fmaf(pr[j], p, dd);
      }
      dd = warp_sum(dd);
      for (int j = lane; j < Tk; j += 32) {
        const float ds = sr[j] * (pr[j] - dd);
        if (dbias_part != nullptr) acc[r * Tk + j] += ds;
        sr[j] = round_to<T>(ds * scale);
      }
      if (lane == 0) dd_out[((size_t)b * H + h) * Tq + row] = dd;
    }

    // dq = round(ds) . K, one chunk of key rows at a time (qs is free now)
    for (int i = tid; i < rows * D; i += kThreads) qs[i] = 0.f;
    for (int j0 = 0; j0 < Tk; j0 += kc) {
      const int n = min(kc, Tk - j0);
      __syncthreads();
      stage_rows(kv, ld, k, kv_base + (size_t)j0 * E, n, D, E);
      __syncthreads();
      accumulate_rows(qs, ss, Tk, j0, rows, kv, ld, n, D);
    }
    __syncthreads();
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      dq[q_base + (size_t)r * E + d] = from_float<T>(qs[i]);
    }
  }

  if (dbias_part != nullptr) {
    __syncthreads();
    float* out = dbias_part + ((size_t)chunk * H + h) * Tq * Tk + (size_t)row0 * Tk;
    for (int i = tid; i < rows * Tk; i += kThreads) out[i] = acc[i];
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dd_in, const __nv_bfloat16* __restrict__ bias,
                const int8_t* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv,
                int H, int Tq, int Tk, int D, int kc, float scale) {
  extern __shared__ float smem[];
  const int E = H * D;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int col0 = blockIdx.x * kRows;
  const int cols = min(kRows, Tk - col0);
  const int ld = D + 1;
  const int tid = threadIdx.x;

  float* ks = smem;                     // kRows x D: k rows, then the dk sums
  float* vs = ks + kRows * D;           // kRows x D: v rows, then the dv sums
  float* pt = vs + kRows * D;           // kRows x Tq: s^T, then rounded p^T
  float* dpt = pt + kRows * Tq;         // kRows x Tq: dp^T, then rounded ds^T
  float* ls = dpt + kRows * Tq;         // Tq: lse
  float* dds = ls + Tq;                 // Tq: dd
  float* qc = dds + Tq;                 // kc x (D + 1): one chunk of q or do rows

  const size_t k_base = ((size_t)b * Tk + col0) * E + (size_t)h * D;
  const size_t q_base = (size_t)b * Tq * E + (size_t)h * D;
  stage_rows(ks, D, k, k_base, cols, D, E);
  stage_rows(vs, D, v, k_base, cols, D, E);
  for (int i = tid; i < Tq; i += kThreads) {
    ls[i] = lse[((size_t)b * H + h) * Tq + i];
    dds[i] = dd_in[((size_t)b * H + h) * Tq + i];
  }

  // s^T and dp^T, one chunk of query rows at a time
  for (int i0 = 0; i0 < Tq; i0 += kc) {
    const int n = min(kc, Tq - i0);
    __syncthreads();
    stage_rows(qc, ld, q, q_base + (size_t)i0 * E, n, D, E);
    __syncthreads();
    dot_rows(pt, Tq, i0, ks, D, cols, qc, ld, n, D);
    __syncthreads();
    stage_rows(qc, ld, dout, q_base + (size_t)i0 * E, n, D, E);
    __syncthreads();
    dot_rows(dpt, Tq, i0, vs, D, cols, qc, ld, n, D);
  }
  __syncthreads();

  // p and ds, elementwise (the row sums dd come from pass 1)
  for (int i = tid; i < cols * Tq; i += kThreads) {
    const int c = i / Tq, r = i - c * Tq;
    const int col = col0 + c;
    float s = pt[i] * scale;
    if (bias != nullptr) s += __bfloat162float(bias[((size_t)h * Tq + r) * Tk + col]);
    if (mask != nullptr && mask[(size_t)b * Tk + col] == 0) s = kMaskValue;
    const float p = expf(s - ls[r]);
    pt[i] = round_to<T>(p);
    dpt[i] = round_to<T>(p * (dpt[i] - dds[r]) * scale);
  }

  // dv = round(p)^T . dO and dk = round(ds)^T . Q (ks, vs are free now)
  for (int i = tid; i < cols * D; i += kThreads) ks[i] = vs[i] = 0.f;
  for (int i0 = 0; i0 < Tq; i0 += kc) {
    const int n = min(kc, Tq - i0);
    __syncthreads();
    stage_rows(qc, ld, dout, q_base + (size_t)i0 * E, n, D, E);
    __syncthreads();
    accumulate_rows(vs, pt, Tq, i0, cols, qc, ld, n, D);
    __syncthreads();
    stage_rows(qc, ld, q, q_base + (size_t)i0 * E, n, D, E);
    __syncthreads();
    accumulate_rows(ks, dpt, Tq, i0, cols, qc, ld, n, D);
  }
  __syncthreads();
  for (int i = tid; i < cols * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    dk[k_base + (size_t)c * E + d] = from_float<T>(ks[i]);
    dv[k_base + (size_t)c * E + d] = from_float<T>(vs[i]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* bias, const void* mask, void* dq, void* dk,
                   void* dv, void* dbias, void* dd, void* dbias_part, int B, int H, int Tq,
                   int Tk, int D, int chunks, float scale, cudaStream_t stream) {
  const int kc = std::max(1, std::min(std::max(Tq, Tk), 4096 / (D + 1)));
  const bool want_dbias = dbias != nullptr && bias != nullptr;
  const int per_chunk = (B + chunks - 1) / chunks;
  chunks = (B + per_chunk - 1) / per_chunk;   // no empty chunk
  float* part = nullptr;
  if (want_dbias) part = static_cast<float*>(chunks > 1 ? dbias_part : dbias);

  const size_t smem1 = sizeof(float) * (2 * (size_t)kRows * D + 2 * (size_t)kRows * Tk +
                                        (want_dbias ? (size_t)kRows * Tk : 0) +
                                        (size_t)kc * (D + 1));
  cudaError_t err = allow_smem(bwd_rows_kernel<T>, smem1);
  if (err != cudaSuccess) return err;
  const dim3 grid1((Tq + kRows - 1) / kRows, H, chunks);
  bwd_rows_kernel<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const int8_t*>(mask),
      static_cast<T*>(dq), static_cast<float*>(dd), part, B, H, Tq, Tk, D, kc, per_chunk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem2 = sizeof(float) * (2 * (size_t)kRows * D + 2 * (size_t)kRows * Tq +
                                        2 * (size_t)Tq + (size_t)kc * (D + 1));
  err = allow_smem(bwd_cols_kernel<T>, smem2);
  if (err != cudaSuccess) return err;
  const dim3 grid2((Tk + kRows - 1) / kRows, H, B);
  bwd_cols_kernel<T><<<grid2, kThreads, smem2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const int8_t*>(mask), static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk,
      D, kc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (want_dbias && chunks > 1) {
    const size_t n = (size_t)H * Tq * Tk;
    const int threads = 256;
    const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 4096);
    dense_bwd_mma::dbias_reduce_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(dbias_part), static_cast<float*>(dbias), n, chunks);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Keys per block range of the bf16 kernel at (Tk, D): Tk when the fp32 dk/dv
// sums of a whole (b, h) fit a block, else fewer; the caller then allocates
// the ranges' fp32 scratch (see dense_attention_bwd).
extern "C" int dense_attention_bwd_key_range(int Tk, int D) {
  return dense_bwd_mma::key_range(Tk, D);
}

// dtype: 0 = bfloat16 (the tensor-core kernel), 1 = float32 (the CUDA-core
// kernels); q, k, v, dout, dq, dk, dv share it. lse is fp32 (B, H, Tq); bias
// is bf16 (H, Tq, Tk) or null; mask is int8 (B, Tk) or null. dbias is fp32
// (H, Tq, Tk), or null when it is not wanted. `chunks` splits the batch
// over blocks (see the design note). Scratch from the caller: dbias_part
// fp32 (chunks, H, Tq, Tk) when dbias is wanted and chunks > 1; for float32
// dd fp32 (B, H, Tq); for bfloat16 dq_part fp32 (ranges * (B * Tq * E +
// B * H * Tq)) when dense_attention_bwd_key_range(Tk, D) < Tk: the ranges'
// dq partials, then their parts of dd.
extern "C" int dense_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* bias,
                                   const void* mask, void* dq, void* dk, void* dv, void* dbias,
                                   void* dd, void* dbias_part, void* dq_part, int B, int H,
                                   int Tq, int Tk, int D, int chunks, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks < 1 || chunks > B) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = dense_bwd_mma::launch<false>(q, k, v, dout, lse, bias, mask, dq, dk, dv, dbias,
                                       dbias_part, dq_part, B, H, Tq, Tk, D, chunks, scale, s);
  } else if (dtype == 1) {
    err = launch<float>(q, k, v, dout, lse, bias, mask, dq, dk, dv, dbias, dd, dbias_part, B,
                        H, Tq, Tk, D, chunks, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
