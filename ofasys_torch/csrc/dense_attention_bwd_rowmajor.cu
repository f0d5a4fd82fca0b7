// Dense (whole-row) attention backward with the scale and the causal mask
// inside the kernel. Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// ofasys_tpu/ops/pallas_dense_attention.py (kernel B2r, the row-major
// variant behind OFASYS_DENSE_BWD=rowmajor and every causal=True call of
// `_dense_attention`). Same function: for every sample b, head h, query row i
// and key j,
//   s_ij  = (q_i . k_j) * scale + bias[h, i, j]     (fp32)
//   s_ij  = -1e9 where mask[b, j] == 0
//   s_ij  = -1e9 where causal and j > i + (Tk - Tq)
//   p_ij  = exp(s_ij - lse_i)            (lse from the forward, B1)
//   dv_j  = sum_i round(p_ij) do_i       (round() to the storage dtype)
//   dp_ij = do_i . v_j
//   dd_i  = sum_j dp_ij p_ij
//   ds_ij = p_ij (dp_ij - dd_i)          (fp32)
//   dbias[h, i, j] = sum_b ds_ij         (fp32, unrounded, before the scale)
//   dq_i  = sum_j round(ds_ij * scale) k_j
//   dk_j  = sum_i round(ds_ij * scale) q_i          (q as given, not scaled)
// with every sum in fp32 and dq, dk, dv stored in the storage dtype.
// q, k, v, do, dq, dk, dv are (B, T, E) with E = H * D; heads are sliced here.
//
// What bounds it on the H100: the same bytes and operations as kernel B2
// (dense_attention_bwd.cu). At the caption encoder's training shape B = 64,
// T = 228, E = 768, H = 12 it must move about 161 MB (q, k, v, do, dq, dk,
// dv in bf16, lse, bias, mask, fp32 dbias), 0.048 ms at 3.35 TB/s, and do
// 25.5 GFLOP (10 B Tq Tk E), 0.026 ms at 989 TFLOP/s: bound by bytes; under
// causal about half the operations and bias.
//
// Design (bf16, the model's dtype): B2's tensor-core kernel
// (dense_attention_bwd_mma.cuh) with the causal mask switched on where the
// call asks for it. The TPU kernel is one program per sample that walks the
// heads and carries dbias in VMEM; here one block of 8 warps per (range of
// keys, head, chunk of samples) walks its samples in order, keeps the fp32
// dK and dV sums of its keys in shared memory and walks the query rows 32
// at a time: S and dP on the tensor cores, dd summed across warps in a fixed
// order, round(p) and round(ds * scale) straight from the accumulators into
// the dV, dK and dQ products, dbias through per-chunk partials summed in
// chunk order. Under causal a (32 query rows, 16 keys) pair wholly above the
// diagonal is neither computed nor read, and only tiles that cross a row's
// diagonal mask element by element. Wide heads split the keys into ranges
// with a dd pre-pass and ordered dq partials, at B2's thresholds (the bf16
// shared-memory budget). No atomics: the same bits run to run.
//
// The fp32 instantiation (not on the model's path: the model runs bf16 on
// the card) keeps the first CUDA-core design:
//   * one block per (head, chunk of samples); it walks its samples in order.
//   * for each sample it keeps the fp32 dk and dv sums of its keys,
//     2 * Tk * D floats, in shared memory while it walks the query-row
//     tiles of 16 rows, so the scores of a (b, h) are recomputed once.
//   * where the sums of every key do not fit (D = 88 from Tk = 247, D = 128
//     from Tk = 174, D = 256 from Tk = 85), the keys are split into ranges
//     of KR keys, one block per (range, head, chunk of samples), with a dd
//     pre-pass and fp32 dq partials summed in range order.
//   * under causal, a row tile computes only the keys up to its last row's
//     diagonal and writes the dbias of the keys beyond as 0.
//   * dbias through per-chunk partials, summed in chunk order.
// Operand rows are staged in shared memory as fp32; K and V chunks with row
// stride D + 1, so the threads of a warp walking down keys hit distinct banks.
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

constexpr int kRows = 16;       // query rows per tile
constexpr int kThreads = 512;   // 16 warps: one block per SM at the long shapes
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = -1e9f;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the opt-in limit of a block

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dst[r * ld + d] = rows [0, n) of a head slice starting at src[base] in a
// (rows, E) matrix, as fp32
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* __restrict__ src,
                                           size_t base, int n, int D, int E) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = src[base + (size_t)r * E + d];
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

// acc[j * D + d] += sum_r w[r * lw + j] * a[r * D + d] for j < nk keys: the
// transposed products dk += ds^T q and dv += p^T do of one row tile
__device__ __forceinline__ void accumulate_cols(float* acc, const float* w, int lw, int nk,
                                                const float* a, int rows, int D) {
  for (int i = threadIdx.x; i < nk * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    float s = acc[i];
    for (int r = 0; r < rows; ++r) s = fmaf(w[r * lw + j], a[r * D + d], s);
    acc[i] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_rowmajor_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const __nv_bfloat16* __restrict__ bias, const int8_t* __restrict__ mask,
                    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dbias_part, float* __restrict__ dq_part, int B, int H,
                    int Tq, int Tk, int D, int KR, int kc, int per_chunk, float scale,
                    int causal, int pass) {
  // pass 0: every key in one range. With several ranges, pass 1 only writes
  // each range's part of dd (dd_part, after the dq partials in dq_part) and
  // pass 2 does the rest with dd = the parts summed in range order.
  extern __shared__ float smem[];
  const int E = H * D;
  const int h = blockIdx.x;
  const int chunk = blockIdx.y;
  const int j0 = blockIdx.z * KR;            // this block's keys: [j0, j0 + nr)
  const int nr = min(KR, Tk - j0);
  const int ld = D + 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  float* dks = smem;                    // KR x D: dk sums of this block's keys
  float* dvs = dks + KR * D;            // KR x D: dv sums
  float* qs = dvs + KR * D;             // kRows x D: q rows, then the dq sums
  float* dos = qs + kRows * D;          // kRows x D: do rows
  float* ss = dos + kRows * D;          // kRows x KR: scores, p, then round(ds * scale)
  float* ps = ss + kRows * KR;          // kRows x KR: dp, then round(p)
  float* kv = ps + kRows * KR;          // kc x (D + 1): one chunk of K or V rows

  float* part = dbias_part == nullptr
                    ? nullptr
                    : dbias_part + ((size_t)chunk * H + h) * Tq * Tk;
  float* dd_part = dq_part == nullptr ? nullptr : dq_part + (size_t)gridDim.z * B * Tq * E;

  const int b_begin = chunk * per_chunk;
  const int b_end = min(B, b_begin + per_chunk);
  for (int b = b_begin; b < b_end; ++b) {
    const size_t kv_base = ((size_t)b * Tk + j0) * E + (size_t)h * D;
    __syncthreads();                    // the previous sample's dk, dv are stored
    for (int i = tid; i < 2 * KR * D; i += kThreads) dks[i] = 0.f;

    for (int row0 = 0; row0 < Tq; row0 += kRows) {
      const int rows = min(kRows, Tq - row0);
      // keys of the range this tile computes: all, or up to its last row's diagonal
      const int nk = min(nr, max(0, (causal ? min(Tk, row0 + rows + (Tk - Tq)) : Tk) - j0));
      const size_t q_base = ((size_t)b * Tq + row0) * E + (size_t)h * D;
      __syncthreads();                  // the previous tile is done with qs, dos, ss, ps
      stage_rows(qs, D, q, q_base, rows, D, E);
      stage_rows(dos, D, dout, q_base, rows, D, E);

      // raw scores and dp, one chunk of key (value) rows at a time
      for (int c0 = 0; c0 < nk; c0 += kc) {
        const int n = min(kc, nk - c0);
        __syncthreads();
        stage_rows(kv, ld, k, kv_base + (size_t)c0 * E, n, D, E);
        __syncthreads();
        dot_rows(ss, KR, c0, qs, D, rows, kv, ld, n, D);
        __syncthreads();
        stage_rows(kv, ld, v, kv_base + (size_t)c0 * E, n, D, E);
        __syncthreads();
        dot_rows(ps, KR, c0, dos, D, rows, kv, ld, n, D);
      }
      __syncthreads();

      // p, dd, ds and the dbias partial: one warp per row
      for (int r = warp; r < rows; r += kWarps) {
        const int row = row0 + r;
        const int limit = row + (Tk - Tq);          // last visible key under causal
        const float l = lse[((size_t)b * H + h) * Tq + row];
        float* sr = ss + r * KR;
        float* pr = ps + r * KR;
        float dd = 0.f;
        for (int jj = lane; jj < nk; jj += 32) {
          const int j = j0 + jj;
          float s = sr[jj] * scale;
          if (bias != nullptr) s += __bfloat162float(bias[((size_t)h * Tq + row) * Tk + j]);
          if (mask != nullptr && mask[(size_t)b * Tk + j] == 0) s = kMaskValue;
          if (causal && j > limit) s = kMaskValue;
          const float p = expf(s - l);
          sr[jj] = p;
          dd = fmaf(pr[jj], p, dd);
        }
        dd = warp_sum(dd);
        const size_t dd_row = ((size_t)b * H + h) * Tq + row;
        if (pass == 1) {
          if (lane == 0) dd_part[(size_t)blockIdx.z * B * H * Tq + dd_row] = dd;
          continue;
        }
        if (pass == 2) {
          dd = 0.f;
          for (int c = 0; c < (int)gridDim.z; ++c) dd += dd_part[(size_t)c * B * H * Tq + dd_row];
        }
        float* gr = part == nullptr ? nullptr : part + (size_t)row * Tk + j0;
        for (int jj = lane; jj < nr; jj += 32) {
          float ds = 0.f;
          if (jj < nk) {
            const float p = sr[jj];
            ds = p * (pr[jj] - dd);
            sr[jj] = ds * scale;
            pr[jj] = p;
          }
          if (gr != nullptr) gr[jj] = (b == b_begin) ? ds : gr[jj] + ds;
        }
      }
      __syncthreads();
      if (pass == 1) continue;

      // dk += round(ds * scale)^T q and dv += round(p)^T do over this tile's rows
      accumulate_cols(dks, ss, KR, nk, qs, rows, D);
      accumulate_cols(dvs, ps, KR, nk, dos, rows, D);
      __syncthreads();

      // dq = round(ds * scale) . K, one chunk of key rows at a time (qs is free now)
      for (int i = tid; i < rows * D; i += kThreads) qs[i] = 0.f;
      for (int c0 = 0; c0 < nk; c0 += kc) {
        const int n = min(kc, nk - c0);
        __syncthreads();
        stage_rows(kv, ld, k, kv_base + (size_t)c0 * E, n, D, E);
        __syncthreads();
        accumulate_rows(qs, ss, KR, c0, rows, kv, ld, n, D);
      }
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        if (dq_part != nullptr)
          dq_part[(size_t)blockIdx.z * B * Tq * E + q_base + (size_t)r * E + d] = qs[i];
        else
          dq[q_base + (size_t)r * E + d] = qs[i];
      }
    }

    __syncthreads();
    if (pass == 1) continue;
    for (int i = tid; i < nr * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      dk[kv_base + (size_t)j * E + d] = dks[i];
      dv[kv_base + (size_t)j * E + d] = dvs[i];
    }
  }
}

// dq = the key ranges' partial sums in range order (fp32 kernel)
__global__ void dq_reduce_kernel(const float* __restrict__ part, float* __restrict__ dq, size_t n,
                                 int ranges) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < ranges; ++c) s += part[(size_t)c * n + i];
    dq[i] = s;
  }
}

int key_chunk(int KR, int D) { return std::max(1, std::min(KR, 4096 / (D + 1))); }

// shared memory of a block whose range holds KR keys
size_t smem_bytes(int KR, int D) {
  return sizeof(float) * (2 * (size_t)KR * D + 2 * (size_t)kRows * D + 2 * (size_t)kRows * KR +
                          (size_t)key_chunk(KR, D) * (D + 1));
}

// keys per range: Tk when the sums of every key fit a block, else the
// largest multiple of 16 that fits
int key_range(int Tk, int D) {
  if (smem_bytes(Tk, D) <= kMaxSmem) return Tk;
  for (int KR = (Tk - 1) / 16 * 16; KR > 0; KR -= 16)
    if (smem_bytes(KR, D) <= kMaxSmem) return KR;
  return 0;
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* bias, const void* mask, void* dq, void* dk,
                   void* dv, void* dbias, void* dbias_part, void* dq_part, int B, int H, int Tq,
                   int Tk, int D, int chunks, float scale, int causal, cudaStream_t stream) {
  const bool want_dbias = dbias != nullptr && bias != nullptr;
  const int per_chunk = (B + chunks - 1) / chunks;
  chunks = (B + per_chunk - 1) / per_chunk;   // no empty chunk
  float* part = nullptr;
  if (want_dbias) part = static_cast<float*>(chunks > 1 ? dbias_part : dbias);
  const int KR = key_range(Tk, D);
  if (KR == 0) return cudaErrorInvalidValue;
  const int ranges = (Tk + KR - 1) / KR;
  if (ranges > 1 && dq_part == nullptr) return cudaErrorInvalidValue;

  const size_t smem = smem_bytes(KR, D);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(bwd_rowmajor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, chunks, ranges);
  for (int pass = ranges > 1 ? 1 : 0; pass <= (ranges > 1 ? 2 : 0); ++pass) {
    bwd_rowmajor_kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const __nv_bfloat16*>(bias), static_cast<const int8_t*>(mask),
        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
        pass == 1 ? nullptr : part,
        ranges > 1 ? static_cast<float*>(dq_part) : nullptr, B, H, Tq, Tk, D, KR,
        key_chunk(KR, D), per_chunk, scale, causal, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int threads = 256;
  if (ranges > 1) {
    const size_t n = (size_t)B * Tq * H * D;
    const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 4096);
    dq_reduce_kernel<<<blocks, threads, 0, stream>>>(static_cast<const float*>(dq_part),
                                                    static_cast<float*>(dq), n, ranges);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (want_dbias && chunks > 1) {
    const size_t n = (size_t)H * Tq * Tk;
    const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 4096);
    dense_bwd_mma::dbias_reduce_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(dbias_part), static_cast<float*>(dbias), n, chunks);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Keys per block range at (Tk, D) of the bf16 (dtype 0) or fp32 (dtype 1)
// kernel: Tk where the fp32 dk/dv sums of every key fit a block's 227 KB,
// else fewer; the caller then allocates the ranges' fp32 scratch (see
// dense_attention_bwd_rowmajor). Shared memory of an fp32 block:
// dense_attention_bwd_rowmajor_smem(range, D).
extern "C" int dense_attention_bwd_rowmajor_key_range(int Tk, int D, int dtype) {
  return dtype == 0 ? dense_bwd_mma::key_range(Tk, D) : key_range(Tk, D);
}

extern "C" long long dense_attention_bwd_rowmajor_smem(int KR, int D) {
  return (long long)smem_bytes(KR, D);
}

// dtype: 0 = bfloat16 (the tensor-core kernel), 1 = float32 (the CUDA-core
// kernel); q, k, v, dout, dq, dk, dv share it. lse is fp32 (B, H, Tq); bias
// is bf16 (H, Tq, Tk) or null; mask is int8 (B, Tk) or null. dbias is fp32
// (H, Tq, Tk), or null when it is not wanted. Scratch from the caller:
// dbias_part fp32 (chunks, H, Tq, Tk) when dbias is wanted and chunks > 1;
// dq_part fp32 (ranges * (B * Tq * E + B * H * Tq)) when the keys are split
// into ranges: their dq partials, then their parts of dd. `chunks` splits
// the batch over blocks (see the design note). causal needs Tq <= Tk (no
// row without a visible key).
extern "C" int dense_attention_bwd_rowmajor(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* bias,
                                            const void* mask, void* dq, void* dk, void* dv,
                                            void* dbias, void* dbias_part, void* dq_part, int B,
                                            int H, int Tq, int Tk, int D, int chunks, float scale,
                                            int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks < 1 || chunks > B || (causal && Tq > Tk)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = causal ? dense_bwd_mma::launch<true>(q, k, v, dout, lse, bias, mask, dq, dk, dv, dbias,
                                               dbias_part, dq_part, B, H, Tq, Tk, D, chunks,
                                               scale, s)
                 : dense_bwd_mma::launch<false>(q, k, v, dout, lse, bias, mask, dq, dk, dv, dbias,
                                                dbias_part, dq_part, B, H, Tq, Tk, D, chunks,
                                                scale, s);
  } else if (dtype == 1) {
    err = launch(q, k, v, dout, lse, bias, mask, dq, dk, dv, dbias, dbias_part, dq_part, B,
                        H, Tq, Tk, D, chunks, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
