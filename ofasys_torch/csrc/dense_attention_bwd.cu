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
// order. For each sample it copies the range's K and V rows into shared
// memory as bf16 (16-byte cp.async, a head dim that is no multiple of 16
// zero-filled), keeps fp32 dK and dV sums of the range in shared memory, and
// walks the query rows 32 at a time:
//   * q, do (bf16) and lse of the 32 rows into shared memory;
//   * each warp takes up to two 16-key tiles and computes S^T = K q^T and
//     dP^T = V do^T (keys as rows), p = exp(S^T * scale + bias - lse) in
//     fp32 registers (0 on padded keys and rows), and its part of the row
//     sums dd = sum_j dp p; the parts of the 8 warps are summed in shared
//     memory in warp order;
//   * ds = p (dp - dd) in fp32 goes into the chunk's dbias partial (device
//     memory, L2: the first sample of the chunk stores, the rest add; one
//     thread owns each element); round(p) and round(ds * scale), still in
//     registers, are the A fragments of dV += round(p)^T do and
//     dK += round(ds * scale)^T q, added into the shared-memory sums;
//   * round(ds * scale)^T goes to shared memory, and dQ = round(ds * scale) K
//     over the range's keys is finished by the block and stored once.
// A range holds every key (Tk <= 256) unless the block's shared memory
// needs several (D = 64 from Tk = 241, D = 88 from 161, D = 128 from 129,
// D = 256 from 49; the model's shapes at D = 64 stay whole): then dd,
// a sum over every key, needs a first pass that writes each range's part
// of it (S^T and dP^T only); the second pass sums the parts in range order,
// each range writes an fp32 dq partial, and a third kernel sums the
// partials in range order. A last kernel sums the chunks' dbias partials in
// chunk order (none with one chunk: the block writes dbias). No atomics:
// the same bits run to run.
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

#include "dense_mma.cuh"

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

// --------------------------------------------------------------- reduce
__global__ void dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                    size_t n, int chunks) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[(size_t)c * n + i];
    dbias[i] = s;
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
    dbias_reduce_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(dbias_part), static_cast<float*>(dbias), n, chunks);
    err = cudaGetLastError();
  }
  return err;
}

// ------------------------------------------------------------ bf16: tensor cores
constexpr int kMmaWarps = 8;
constexpr int kQTile = 32;                     // query rows per step
constexpr int kKeyTiles = 2;                   // 16-key tiles per warp, at most
constexpr int kMaxRange = kMmaWarps * kKeyTiles * 16;   // 256 keys per block
constexpr int kLds = kQTile + 8;               // row stride of the ds^T tile
constexpr size_t kMaxSmem = 232448;            // 227 KB, the opt-in limit of a block

// shared memory of a block whose range holds KR keys
size_t mma_smem_bytes(int KR, int D) {
  using dense_mma::round_up;
  const size_t krp = round_up(KR, 16), ld = round_up(D, 16) + 8, dacc = round_up(D, 32);
  return 2 * (2 * krp * ld + 2 * (size_t)kQTile * ld + krp * kLds) + 4 * (2 * krp * dacc) +
         4 * (size_t)(2 + kMmaWarps) * kQTile + krp;
}

// keys per range: all Tk when a block's sums fit, else the largest multiple
// of 16 that fits (0 if none)
int key_range(int Tk, int D) {
  for (int KR = std::min(dense_mma::round_up(Tk, 16), kMaxRange); KR > 0; KR -= 16)
    if (mma_smem_bytes(KR, D) <= kMaxSmem) return std::min(KR, Tk);
  return 0;
}

// the fp32 dK / dV sum of key row r, columns c and c + 1 (c even): float2
// slots XOR-swizzled by the row so the 8 rows a warp adds to hit distinct banks
__device__ __forceinline__ float2* acc_at(float* base, int dacc, int r, int c) {
  return reinterpret_cast<float2*>(base + (size_t)r * dacc) + ((c >> 1) ^ ((r & 3) << 2));
}

// two bf16 values at o, o + 1 (the second only where d + 1 < D)
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float x, float y, int d, int D) {
  if ((D & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
  } else {
    o[0] = __float2bfloat16_rn(x);
    if (d + 1 < D) o[1] = __float2bfloat16_rn(y);
  }
}

__global__ void __launch_bounds__(kMmaWarps * 32, 1)
bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const __nv_bfloat16* __restrict__ bias,
               const int8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
               float* __restrict__ dq_part, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, float* __restrict__ dbias_part, int B, int H,
               int Tq, int Tk, int D, int KR, int per_chunk, float scale, int vec, int pass) {
  // pass 0: every key in one range. With several ranges, pass 1 only writes
  // each range's part of dd (dd_part, after the dq partials in dq_part) and
  // pass 2 does the rest with dd = the parts summed in range order.
  using namespace dense_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = H * D, Dp = round_up(D, 16), ld = Dp + 8, Dacc = round_up(D, 32);
  const int split = blockIdx.x, h = blockIdx.y, chunk = blockIdx.z;
  const int j0 = split * KR, nk = min(KR, Tk - j0), nkp = round_up(nk, 16), nmt = nkp / 16;
  const int KRp = round_up(KR, 16);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // KRp x ld
  __nv_bfloat16* vs = ks + KRp * ld;                                 // KRp x ld
  __nv_bfloat16* qs = vs + KRp * ld;                                 // kQTile x ld
  __nv_bfloat16* dos = qs + kQTile * ld;                             // kQTile x ld
  __nv_bfloat16* dst = dos + kQTile * ld;                            // KRp x kLds: ds^T
  float* dka = reinterpret_cast<float*>(dst + KRp * kLds);           // KRp x Dacc
  float* dva = dka + KRp * Dacc;                                     // KRp x Dacc
  float* lse_s = dva + KRp * Dacc;                                   // kQTile
  float* dd_s = lse_s + kQTile;                                      // kQTile
  float* ddp = dd_s + kQTile;                                        // kMmaWarps x kQTile
  int8_t* ms = reinterpret_cast<int8_t*>(ddp + kMmaWarps * kQTile);  // KRp: keep-mask
  // the bias tile of the 32 rows, kQTile x KRp bf16, lives in ds^T's buffer
  // until the scores are done
  __nv_bfloat16* bs = dst;

  float* part = dbias_part == nullptr ? nullptr : dbias_part + (size_t)h * Tq * Tk;
  if (part != nullptr) part += (size_t)chunk * H * Tq * Tk;
  const int b_begin = chunk * per_chunk, b_end = min(B, b_begin + per_chunk);
  for (int b = b_begin; b < b_end; ++b) {
    const size_t kv_base = ((size_t)b * Tk + j0) * E + (size_t)h * D;
    __syncthreads();                      // the previous sample's dk, dv are stored
    stage_tile(ks, ld, k + kv_base, E, nk, nkp, D, vec);
    stage_tile(vs, ld, v + kv_base, E, nk, nkp, D, vec);
    for (int i = threadIdx.x; i < 2 * KRp * Dacc; i += blockDim.x) dka[i] = 0.f;
    for (int j = threadIdx.x; j < nkp; j += blockDim.x)
      ms[j] = j < nk && (mask == nullptr || mask[(size_t)b * Tk + j0 + j] != 0);

    for (int i0 = 0; i0 < Tq; i0 += kQTile) {
      const int rows = min(kQTile, Tq - i0);
      const size_t q_base = ((size_t)b * Tq + i0) * E + (size_t)h * D;
      __syncthreads();                    // the previous tile is done with qs, dos, dst
      stage_tile(qs, ld, q + q_base, E, rows, kQTile, D, vec);
      stage_tile(dos, ld, dout + q_base, E, rows, kQTile, D, vec);
      if (threadIdx.x < kQTile)
        lse_s[threadIdx.x] =
            threadIdx.x < rows ? lse[((size_t)b * H + h) * Tq + i0 + threadIdx.x] : 0.f;
      if (bias != nullptr) {              // 4-byte copies where they are aligned
        const bool pairs = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % 4 == 0;
        const int np = (nk + 1) / 2;
        for (int i = threadIdx.x; i < rows * np; i += blockDim.x) {
          const int r = i / np, c = (i - r * np) * 2;
          const __nv_bfloat16* src = bias + ((size_t)h * Tq + i0 + r) * Tk + j0 + c;
          if (pairs) {
            cp_async4(bs + r * KRp + c, src);
          } else {
            bs[r * KRp + c] = src[0];
            if (c + 1 < nk) bs[r * KRp + c + 1] = src[1];
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T = K q^T and dP^T = V do^T on this warp's key tiles
      float st[kKeyTiles][4][4] = {}, dpt[kKeyTiles][4][4] = {};
#pragma unroll
      for (int m = 0; m < kKeyTiles; ++m) {
        const int mt = warp + m * kMmaWarps;
        if (mt >= nmt) continue;
        for (int kk = 0; kk < Dp; kk += 16) {
          uint32_t ak[4], av[4];
          const int aoff = (mt * 16 + lane % 16) * ld + kk + (lane / 16) * 8;
          uint32_t bq[2][4], bo[2][4];
          const int boff = ((lane / 16) * 8 + lane % 8) * ld + kk + ((lane / 8) % 2) * 8;
          ldmatrix_x4(ak, ks + aoff);
          ldmatrix_x4(av, vs + aoff);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            ldmatrix_x4(bq[np], qs + boff + np * 16 * ld);
            ldmatrix_x4(bo[np], dos + boff + np * 16 * ld);
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma_bf16(st[m][2 * np], ak, bq[np][0], bq[np][1]);
            mma_bf16(st[m][2 * np + 1], ak, bq[np][2], bq[np][3]);
            mma_bf16(dpt[m][2 * np], av, bo[np][0], bo[np][1]);
            mma_bf16(dpt[m][2 * np + 1], av, bo[np][2], bo[np][3]);
          }
        }
      }

      // p in fp32 (0 on padded keys and rows) and this warp's part of dd
      float ddc[4][2] = {};
#pragma unroll
      for (int m = 0; m < kKeyTiles; ++m) {
        const int mt = warp + m * kMmaWarps;
        if (mt >= nmt) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jl = mt * 16 + g + (e >= 2 ? 8 : 0), il = nt * 8 + 2 * t + (e & 1);
            float p = 0.f;
            if (jl < nk && il < rows) {
              float s = st[m][nt][e] * scale;
              if (bias != nullptr) s += __bfloat162float(bs[il * KRp + jl]);
              if (!ms[jl]) s = kMaskValue;
              p = __expf(s - lse_s[il]);
            }
            st[m][nt][e] = p;
            ddc[nt][e & 1] = fmaf(dpt[m][nt][e], p, ddc[nt][e & 1]);
          }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = ddc[nt][c];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if (g == 0) ddp[warp * kQTile + nt * 8 + 2 * t + c] = x;
        }
      __syncthreads();
      float* dd_part = dq_part == nullptr ? nullptr : dq_part + (size_t)gridDim.x * B * Tq * E;
      if (threadIdx.x < kQTile) {
        float x = 0.f;
        const size_t row = ((size_t)b * H + h) * Tq + i0 + threadIdx.x;
        if (pass == 2) {
          if ((int)threadIdx.x < rows)
            for (int r = 0; r < (int)gridDim.x; ++r) x += dd_part[(size_t)r * B * H * Tq + row];
        } else {
          for (int w = 0; w < kMmaWarps; ++w) x += ddp[w * kQTile + threadIdx.x];
        }
        dd_s[threadIdx.x] = x;
        if (pass == 1 && (int)threadIdx.x < rows) dd_part[(size_t)split * B * H * Tq + row] = x;
      }
      __syncthreads();
      if (pass == 1) continue;

      // ds, the dbias partial, and dV, dK of this warp's key tiles
#pragma unroll
      for (int m = 0; m < kKeyTiles; ++m) {
        const int mt = warp + m * kMmaWarps;
        if (mt >= nmt) continue;
        // the partial sums so far, all loads issued before the first store
        float old[4][4] = {};
        if (part != nullptr && b != b_begin) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jl = mt * 16 + g + (e >= 2 ? 8 : 0), il = nt * 8 + 2 * t + (e & 1);
              if (jl < nk && il < rows) old[nt][e] = part[(size_t)(i0 + il) * Tk + j0 + jl];
            }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jl = mt * 16 + g + (e >= 2 ? 8 : 0), il = nt * 8 + 2 * t + (e & 1);
            const float ds = st[m][nt][e] * (dpt[m][nt][e] - dd_s[il]);
            if (part != nullptr && jl < nk && il < rows)
              part[(size_t)(i0 + il) * Tk + j0 + jl] = b == b_begin ? ds : old[nt][e] + ds;
            dpt[m][nt][e] = ds * scale;
          }
        uint32_t ap[2][4], ads[2][4];      // round(p)^T, round(ds * scale)^T: k = queries
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          ap[kq][0] = pack_bf16(st[m][2 * kq][0], st[m][2 * kq][1]);
          ap[kq][1] = pack_bf16(st[m][2 * kq][2], st[m][2 * kq][3]);
          ap[kq][2] = pack_bf16(st[m][2 * kq + 1][0], st[m][2 * kq + 1][1]);
          ap[kq][3] = pack_bf16(st[m][2 * kq + 1][2], st[m][2 * kq + 1][3]);
          ads[kq][0] = pack_bf16(dpt[m][2 * kq][0], dpt[m][2 * kq][1]);
          ads[kq][1] = pack_bf16(dpt[m][2 * kq][2], dpt[m][2 * kq][3]);
          ads[kq][2] = pack_bf16(dpt[m][2 * kq + 1][0], dpt[m][2 * kq + 1][1]);
          ads[kq][3] = pack_bf16(dpt[m][2 * kq + 1][2], dpt[m][2 * kq + 1][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {     // round(ds * scale)^T for dQ
          const int col = nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(dst + (mt * 16 + g) * kLds + col) = ads[nt / 2][(nt & 1) * 2];
          *reinterpret_cast<uint32_t*>(dst + (mt * 16 + g + 8) * kLds + col) =
              ads[nt / 2][(nt & 1) * 2 + 1];
        }
        for (int dn = 0; dn < Dp; dn += 16) {
          float av2[2][4] = {}, ak2[2][4] = {};
          uint32_t bo[2][4], bq[2][4];
#pragma unroll
          for (int kq = 0; kq < 2; ++kq) {
            const int off = (kq * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ld + dn + (lane / 16) * 8;
            ldmatrix_x4_trans(bo[kq], dos + off);
            ldmatrix_x4_trans(bq[kq], qs + off);
          }
#pragma unroll
          for (int kq = 0; kq < 2; ++kq) {
            mma_bf16(av2[0], ap[kq], bo[kq][0], bo[kq][1]);
            mma_bf16(av2[1], ap[kq], bo[kq][2], bo[kq][3]);
            mma_bf16(ak2[0], ads[kq], bq[kq][0], bq[kq][1]);
            mma_bf16(ak2[1], ads[kq], bq[kq][2], bq[kq][3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = mt * 16 + g + half * 8, c = dn + nt * 8 + 2 * t;
              float2* pv = acc_at(dva, Dacc, r, c);
              float2* pk = acc_at(dka, Dacc, r, c);
              float2 x = *pv, y = *pk;
              x.x += av2[nt][2 * half];
              x.y += av2[nt][2 * half + 1];
              y.x += ak2[nt][2 * half];
              y.y += ak2[nt][2 * half + 1];
              *pv = x;
              *pk = y;
            }
        }
      }
      __syncthreads();                    // ds^T is complete

      // dQ = round(ds * scale) K over the range: 2 row tiles x Dp / 16 column pairs
      const int mq = warp & 1;
      for (int dn = (warp >> 1) * 16; dn < Dp; dn += (kMmaWarps / 2) * 16) {
        float acc[2][4] = {};
        for (int kt = 0; kt < nmt; ++kt) {
          uint32_t a[4], bk[4];
          ldmatrix_x4_trans(a, dst + (kt * 16 + (lane / 16) * 8 + lane % 8) * kLds + mq * 16 +
                                   ((lane / 8) % 2) * 8);
          ldmatrix_x4_trans(bk, ks + (kt * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ld + dn +
                                    (lane / 16) * 8);
          mma_bf16(acc[0], a, bk[0], bk[1]);
          mma_bf16(acc[1], a, bk[2], bk[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int il = mq * 16 + g + half * 8, d = dn + nt * 8 + 2 * t;
            if (il >= rows || d >= D) continue;
            const size_t o = q_base + (size_t)il * E + d;
            const float x = acc[nt][2 * half], y = acc[nt][2 * half + 1];
            if (dq_part != nullptr) {
              float* pp = dq_part + (size_t)split * B * Tq * E + o;
              pp[0] = x;
              if (d + 1 < D) pp[1] = y;
            } else {
              store_pair(dq + o, x, y, d, D);
            }
          }
      }
    }

    __syncthreads();                      // the sums of this sample are complete
    if (pass == 1) continue;
    for (int i = threadIdx.x; i < nk * (Dp / 2); i += blockDim.x) {
      const int r = i / (Dp / 2), c = (i - r * (Dp / 2)) * 2;
      if (c >= D) continue;
      const float2 x = *acc_at(dka, Dacc, r, c), y = *acc_at(dva, Dacc, r, c);
      store_pair(dk + kv_base + (size_t)r * E + c, x.x, x.y, c, D);
      store_pair(dv + kv_base + (size_t)r * E + c, y.x, y.y, c, D);
    }
  }
}

// dq = the range partials summed in range order, rounded once
__global__ void dq_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dq,
                                 size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < splits; ++c) s += part[(size_t)c * n + i];
    dq[i] = __float2bfloat16_rn(s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* bias, const void* mask, void* dq, void* dk,
                       void* dv, void* dbias, void* dbias_part, void* dq_part, int B, int H,
                       int Tq, int Tk, int D, int chunks, float scale, cudaStream_t stream) {
  const int KR = key_range(Tk, D);
  if (KR == 0) return cudaErrorInvalidValue;
  const int splits = (Tk + KR - 1) / KR;
  if (splits > 1 && dq_part == nullptr) return cudaErrorInvalidValue;
  const bool want_dbias = dbias != nullptr && bias != nullptr;
  const int per_chunk = (B + chunks - 1) / chunks;
  chunks = (B + per_chunk - 1) / per_chunk;   // no empty chunk
  if (want_dbias && chunks > 1 && dbias_part == nullptr) return cudaErrorInvalidValue;
  float* part = nullptr;
  if (want_dbias) part = static_cast<float*>(chunks > 1 ? dbias_part : dbias);

  const size_t smem = mma_smem_bytes(KR, D);
  cudaError_t err = dense_mma::allow_smem_carveout(bwd_mma_kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  const dim3 grid(splits, H, chunks);
  for (int pass = splits > 1 ? 1 : 0; pass <= (splits > 1 ? 2 : 0); ++pass) {
    bwd_mma_kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const __nv_bfloat16*>(bias),
        static_cast<const int8_t*>(mask), static_cast<__nv_bfloat16*>(dq),
        splits > 1 ? static_cast<float*>(dq_part) : nullptr, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), pass == 1 ? nullptr : part, B, H, Tq, Tk, D, KR,
        per_chunk, scale, vec, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int threads = 256;
  if (splits > 1) {
    const size_t n = (size_t)B * Tq * H * D;
    const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 4096);
    dq_reduce_kernel<<<blocks, threads, 0, stream>>>(static_cast<const float*>(dq_part),
                                                     static_cast<__nv_bfloat16*>(dq), n, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (want_dbias && chunks > 1) {
    const size_t n = (size_t)H * Tq * Tk;
    const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 4096);
    dbias_reduce_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(dbias_part), static_cast<float*>(dbias), n, chunks);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Keys per block range of the bf16 kernel at (Tk, D): Tk when the fp32 dk/dv
// sums of a whole (b, h) fit a block, else fewer; the caller then allocates
// the ranges' fp32 scratch (see dense_attention_bwd).
extern "C" int dense_attention_bwd_key_range(int Tk, int D) { return key_range(Tk, D); }

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
    err = launch_mma(q, k, v, dout, lse, bias, mask, dq, dk, dv, dbias, dbias_part, dq_part, B, H,
                     Tq, Tk, D, chunks, scale, s);
  } else if (dtype == 1) {
    err = launch<float>(q, k, v, dout, lse, bias, mask, dq, dk, dv, dbias, dd, dbias_part, B,
                        H, Tq, Tk, D, chunks, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
