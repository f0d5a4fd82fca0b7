// Flash attention backward for long sequences, Hopper (sm_90a): three kernels,
// each with its own C entry point.
//
//   flash_attention_bwd_dq    replaces `_flash_bwd_dq_kernel`    (kernel B4, dQ)
//   flash_attention_bwd_dkv   replaces `_flash_bwd_dkv_kernel`   (kernel B4, dK/dV)
//   flash_attention_bwd_dbias replaces `_flash_bwd_dbias_kernel` (kernel B5)
// of ofasys_tpu/ops/pallas_attention.py (launched by `_flash_backward` and
// `_shared_dbias`). All three recompute, per (query row i, key j) of a tile,
// what `_recompute_p` does on the TPU:
//   s_ij  = (q_i . k_j) * scale + bias_ij, -1e9 where mask[b, j] == 0 and
//           where j > i under `causal`            (fp32)
//   p_ij  = exp(s_ij - lse_i)                     (lse from the forward, B3)
//   dp_ij = do_i . v_j                            (fp32)
//   ds_ij = p_ij (dp_ij - dd_i)                   (fp32)
// with dd_i = rowsum(do_i * o_i) (minus the lse cotangent) computed by the
// caller outside the kernels, as `_flash_backward` does; p and ds are 0
// outside the (Tq, Tk) extent. Then
//   dq  kernel: dq_i = scale * sum_j round(ds_ij) k_j, and for a bias of
//               one matrix per (b, h) also ds itself as fp32 (B H, Tq, Tk),
//               with the tiles that causal skips written as 0;
//   dkv kernel: dv_j = sum_i round(p_ij) do_i, dk_j = scale * sum_i round(ds_ij) q_i;
//   dbias kernel (bias shared by the batch): dbias[h] = sum_b ds (fp32,
//               unrounded), zero on the tiles that causal skips;
// with round() to the storage dtype and every sum in fp32. q, do, dq are
// (B, Tq, E), k, v, dk, dv (B, Tk, E) with E = H * D (heads sliced here);
// lse and dd are fp32 (B, H, Tq); bias is bf16 (H or B H, Tq, Tk); mask int8
// (B, Tk). `causal` (Tq == Tk, start-aligned) skips the tiles strictly above
// the diagonal, whose inputs are never read.
//
// What bounds it on the H100: at the gigaword_long encoder shape B = 16,
// T = 1000, H = 12, D = 64 the dq kernel must move about 148 MB and do
// 74 GFLOP (three (Tq, Tk, D) products: s, dp, dq; 6 B H Tq Tk D), 0.075 ms
// at 989 TFLOP/s; dkv 173 MB and 98 GFLOP (s, dp, dv, dk), 0.099 ms; both
// bound by operations. dbias must move 172 MB (0.051 ms at 3.35 TB/s) and
// do 49 GFLOP (s, dp; 0.050 ms): bound by bytes. These first versions run their
// products on the CUDA cores in fp32 (register tiles as in B3), so they are
// bound by fp32 FMA issue and shared-memory loads; tensor cores and TMA
// staging are later work.
//
// Design. The TPU walks its grids in order and carries dq, dk/dv and the
// batch sum of dbias in VMEM across steps; Hopper blocks run in parallel
// in no order, so each accumulation is owned by one block and walked by a
// loop inside it, and nothing is accumulated across blocks (no atomics;
// results are the same bits run to run):
//   dq:    one block per (tile of R query rows, b H + h), looping over key tiles;
//   dkv:   one block per (tile of R keys, b H + h), looping over query tiles;
//   dbias: one block per (key tile, query tile, h), looping over the batch,
//          so the per-sample ds is never staged (B times the output's size).
// Operand tiles are staged in shared memory as fp32 (row stride D + 1,
// score tiles R + 8, so a warp's threads hit distinct banks); thread
// (ty, tx) = (tid / 8, tid % 8) owns tile rows ty + 16 i and columns
// tx + 8 j, and the products are register tiles on the CUDA cores.
//
// C interface, loaded with ctypes; every entry returns cudaGetLastError()
// so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr float kMaskValue = -1e9f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// dst[r * ld + d] = rows [0, n) of head slice `base` of a (rows, E) matrix as
// fp32, zero for rows n..R-1
template <typename T, int R>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                                           size_t base, int n, int D, int E) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r < n ? to_float(src[base + (size_t)r * E + d]) : 0.f;
  }
}

// dst[r * lp + c] = the (nr, nc) bias block at (row0, col0) of a (Tq, Tk)
// matrix as fp32, zero outside it
template <int R>
__device__ __forceinline__ void stage_bias(float* dst, int lp, const __nv_bfloat16* __restrict__ src,
                                           int row0, int col0, int nr, int nc, int Tk) {
  for (int i = threadIdx.x; i < R * R; i += kThreads) {
    const int r = i / R, c = i - r * R;
    dst[r * lp + c] = (r < nr && c < nc) ? __bfloat162float(src[(size_t)(row0 + r) * Tk + col0 + c])
                                         : 0.f;
  }
}

// 1 where key col0 + c is kept, 0 where it is masked (or past Tk)
template <int R>
__device__ __forceinline__ void stage_mask(float* dst, const int8_t* __restrict__ mask, size_t base,
                                           int nc) {
  const int c = threadIdx.x;
  if (c < R) dst[c] = (c < nc && (mask == nullptr || mask[base + c] != 0)) ? 1.f : 0.f;
}

// s[i][j] += a_row(ty + 16 i) . c_row(tx + 8 j) and t[i][j] += a2 . c2 over d < D
template <int RM, int CN>
__device__ __forceinline__ void two_tile_dots(float (&s)[RM][CN], float (&t)[RM][CN],
                                              const float* a, const float* c, const float* a2,
                                              const float* c2, int ld, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = t[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float x[RM], y[CN], x2[RM], y2[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      x[i] = a[(ty + 16 * i) * ld + d];
      x2[i] = a2[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      y[j] = c[(tx + 8 * j) * ld + d];
      y2[j] = c2[(tx + 8 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(x[i], y[j], s[i][j]);
        t[i][j] = fmaf(x2[i], y2[j], t[i][j]);
      }
  }
}

// p and ds of one score entry; `in` says whether (row, col) lies inside
// (Tq, Tk). s is the raw q.k sum, bias the staged bias, keep the staged mask.
__device__ __forceinline__ void p_and_ds(float s, float dp, float bias, float keep, bool masked_causal,
                                         float scale, float lse, float dd, bool in, float& p,
                                         float& ds) {
  float x = s * scale + bias;
  if (keep == 0.f || masked_causal) x = kMaskValue;
  p = in ? expf(x - lse) : 0.f;
  ds = in ? p * (dp - dd) : 0.f;
}

// ------------------------------------------------------------------ dq
template <typename T, int DT, int R>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dd, const __nv_bfloat16* __restrict__ bias,
                    const int8_t* __restrict__ mask, T* __restrict__ dq, float* __restrict__ ds_out,
                    int H, int Tq, int Tk, int D, int bias_per_bh, float scale, int causal) {
  constexpr int RM = R / 16, CN = R / 8, DN = DT / 8, lp = R + 8;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;             // R x ld: q rows
  float* dos = qs + R * ld;     // R x ld: do rows
  float* ks = dos + R * ld;     // R x ld: K tile
  float* vs = ks + R * ld;      // R x ld: V tile
  float* ts = vs + R * ld;      // R x lp: bias tile, then rounded ds
  float* ms = ts + R * lp;      // R: key mask of the tile

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int E = H * D;
  const int q0 = blockIdx.x * R;
  const int rows = min(R, Tq - q0);
  const size_t q_base = ((size_t)b * Tq + q0) * E + (size_t)h * D;
  const size_t kv_base = (size_t)b * Tk * E + (size_t)h * D;
  const __nv_bfloat16* bias_bh =
      bias != nullptr ? bias + (size_t)(bias_per_bh ? bh : h) * Tq * Tk : nullptr;

  stage_rows<T, R>(qs, ld, q, q_base, rows, D, E);
  stage_rows<T, R>(dos, ld, dout, q_base, rows, D, E);
  float lr[RM], dr[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    lr[i] = r < rows ? lse[(size_t)bh * Tq + q0 + r] : 0.f;
    dr[i] = r < rows ? dd[(size_t)bh * Tq + q0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(Tk, q0 + R) : Tk;
  for (int j0 = 0; j0 < k_end; j0 += R) {
    const int n = min(R, Tk - j0);
    __syncthreads();            // the previous tile is done with ks, vs, ts
    stage_rows<T, R>(ks, ld, k, kv_base + (size_t)j0 * E, n, D, E);
    stage_rows<T, R>(vs, ld, v, kv_base + (size_t)j0 * E, n, D, E);
    if (bias_bh != nullptr) stage_bias<R>(ts, lp, bias_bh, q0, j0, rows, n, Tk);
    stage_mask<R>(ms, mask, (size_t)b * Tk + j0, n);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
    two_tile_dots<RM, CN>(s, dp, qs, ks, dos, vs, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 8 * j;
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], bias_bh != nullptr ? ts[r * lp + c] : 0.f, ms[c],
                 causal && j0 + c > q0 + r, scale, lr[i], dr[i], r < rows && c < n, p, ds);
        s[i][j] = ds;
        if (ds_out != nullptr && r < rows && c < n)
          ds_out[((size_t)bh * Tq + q0 + r) * Tk + j0 + c] = ds;
      }
    }
    __syncthreads();            // every thread is done with the bias tile
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) ts[(ty + 16 * i) * lp + tx + 8 * j] = round_to<T>(s[i][j]);
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      float w[RM], kk[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) w[i] = ts[(ty + 16 * i) * lp + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int d = tx + 8 * j;
        kk[j] = d < D ? ks[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(w[i], kk[j], acc[i][j]);
    }
  }

  // the tiles that causal skipped still own their ds entries
  if (ds_out != nullptr && k_end < Tk) {
    const int width = Tk - k_end;
    for (int i = tid; i < rows * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      ds_out[((size_t)bh * Tq + q0 + r) * Tk + k_end + c] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = tx + 8 * j;
      if (d < D) dq[q_base + (size_t)r * E + d] = from_float<T>(acc[i][j] * scale);
    }
  }
}

// ----------------------------------------------------------------- dkv
// Thread (ty, tx) owns keys ty + 16 i of the block's tile and, in a score
// tile, queries tx + 8 j: the scores are computed transposed.
template <typename T, int DT, int R>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dd, const __nv_bfloat16* __restrict__ bias,
                     const int8_t* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Tq, int Tk, int D, int bias_per_bh, float scale, int causal) {
  constexpr int RM = R / 16, CN = R / 8, DN = DT / 8, lp = R + 8;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;             // R x ld: this block's keys
  float* vs = ks + R * ld;      // R x ld: their values
  float* qs = vs + R * ld;      // R x ld: q rows of the query tile
  float* dos = qs + R * ld;     // R x ld: do rows of the query tile
  float* ts = dos + R * ld;     // R x lp: bias tile [query][key], then rounded p^T [key][query]
  float* us = ts + R * lp;      // R x lp: rounded ds^T [key][query]
  float* ms = us + R * lp;      // R: key mask
  float* ls = ms + R;           // R: lse of the query tile
  float* dds = ls + R;          // R: dd of the query tile

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int E = H * D;
  const int k0 = blockIdx.x * R;
  const int nk = min(R, Tk - k0);
  const size_t k_base = ((size_t)b * Tk + k0) * E + (size_t)h * D;
  const size_t q_base = (size_t)b * Tq * E + (size_t)h * D;
  const __nv_bfloat16* bias_bh =
      bias != nullptr ? bias + (size_t)(bias_per_bh ? bh : h) * Tq * Tk : nullptr;

  stage_rows<T, R>(ks, ld, k, k_base, nk, D, E);
  stage_rows<T, R>(vs, ld, v, k_base, nk, D, E);
  stage_mask<R>(ms, mask, (size_t)b * Tk + k0, nk);
  float dka[RM][DN], dva[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) dka[i][j] = dva[i][j] = 0.f;

  // under causal, query tiles that end before the first key are above the
  // diagonal: start at the diagonal tile
  for (int i0 = causal ? k0 : 0; i0 < Tq; i0 += R) {
    const int nq = min(R, Tq - i0);
    __syncthreads();            // the previous tile is done with qs, dos, ts, us, ls, dds
    stage_rows<T, R>(qs, ld, q, q_base + (size_t)i0 * E, nq, D, E);
    stage_rows<T, R>(dos, ld, dout, q_base + (size_t)i0 * E, nq, D, E);
    if (bias_bh != nullptr) stage_bias<R>(ts, lp, bias_bh, i0, k0, nq, nk, Tk);
    if (tid < R) {
      ls[tid] = tid < nq ? lse[(size_t)bh * Tq + i0 + tid] : 0.f;
      dds[tid] = tid < nq ? dd[(size_t)bh * Tq + i0 + tid] : 0.f;
    }
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
    two_tile_dots<RM, CN>(s, dp, ks, qs, vs, dos, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int c = ty + 16 * i;          // key
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int r = tx + 8 * j;         // query
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], bias_bh != nullptr ? ts[r * lp + c] : 0.f, ms[c],
                 causal && k0 + c > i0 + r, scale, ls[r], dds[r], r < nq && c < nk, p, ds);
        dp[i][j] = round_to<T>(p);
        s[i][j] = round_to<T>(ds);
      }
    }
    __syncthreads();            // every thread is done with the bias tile
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        ts[(ty + 16 * i) * lp + tx + 8 * j] = dp[i][j];
        us[(ty + 16 * i) * lp + tx + 8 * j] = s[i][j];
      }
    __syncthreads();

    for (int r = 0; r < nq; ++r) {
      float pw[RM], sw[RM], od[DN], qd[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pw[i] = ts[(ty + 16 * i) * lp + r];
        sw[i] = us[(ty + 16 * i) * lp + r];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int d = tx + 8 * j;
        od[j] = d < D ? dos[r * ld + d] : 0.f;
        qd[j] = d < D ? qs[r * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          dva[i][j] = fmaf(pw[i], od[j], dva[i][j]);
          dka[i][j] = fmaf(sw[i], qd[j], dka[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int c = ty + 16 * i;
    if (c >= nk) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = tx + 8 * j;
      if (d < D) {
        dk[k_base + (size_t)c * E + d] = from_float<T>(dka[i][j] * scale);
        dv[k_base + (size_t)c * E + d] = from_float<T>(dva[i][j]);
      }
    }
  }
}

// --------------------------------------------------------------- dbias
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dd, const __nv_bfloat16* __restrict__ bias,
                       const int8_t* __restrict__ mask, float* __restrict__ dbias, int B, int H,
                       int Tq, int Tk, int D, float scale, int causal) {
  constexpr int RM = R / 16, CN = R / 8, lp = R + 8;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;             // R x ld: q rows of sample b
  float* dos = qs + R * ld;     // R x ld: do rows
  float* ks = dos + R * ld;     // R x ld: K tile
  float* vs = ks + R * ld;      // R x ld: V tile
  float* ts = vs + R * ld;      // R x lp: the shared bias tile
  float* ms = ts + R * lp;      // R: key mask of sample b
  float* ls = ms + R;           // R: lse rows of sample b
  float* dds = ls + R;          // R: dd rows of sample b

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int h = blockIdx.z;
  const int E = H * D;
  const int q0 = blockIdx.y * R, j0 = blockIdx.x * R;
  const int rows = min(R, Tq - q0), n = min(R, Tk - j0);
  float* out = dbias + (size_t)h * Tq * Tk;

  if (causal && j0 > q0 + R - 1) {
    // above the diagonal: the gradient is 0 and nothing is read
    for (int i = tid; i < rows * n; i += kThreads) {
      const int r = i / n, c = i - r * n;
      out[(size_t)(q0 + r) * Tk + j0 + c] = 0.f;
    }
    return;
  }
  stage_bias<R>(ts, lp, bias + (size_t)h * Tq * Tk, q0, j0, rows, n, Tk);
  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  for (int b = 0; b < B; ++b) {
    const int bh = b * H + h;
    const size_t q_base = ((size_t)b * Tq + q0) * E + (size_t)h * D;
    const size_t kv_base = ((size_t)b * Tk + j0) * E + (size_t)h * D;
    __syncthreads();            // the previous sample is done with the tiles
    stage_rows<T, R>(qs, ld, q, q_base, rows, D, E);
    stage_rows<T, R>(dos, ld, dout, q_base, rows, D, E);
    stage_rows<T, R>(ks, ld, k, kv_base, n, D, E);
    stage_rows<T, R>(vs, ld, v, kv_base, n, D, E);
    stage_mask<R>(ms, mask, (size_t)b * Tk + j0, n);
    if (tid < R) {
      ls[tid] = tid < rows ? lse[(size_t)bh * Tq + q0 + tid] : 0.f;
      dds[tid] = tid < rows ? dd[(size_t)bh * Tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
    two_tile_dots<RM, CN>(s, dp, qs, ks, dos, vs, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 8 * j;
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], ts[r * lp + c], ms[c], causal && j0 + c > q0 + r, scale,
                 ls[r], dds[r], r < rows && c < n, p, ds);
        acc[i][j] += ds;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = tx + 8 * j;
      if (c < n) out[(size_t)(q0 + r) * Tk + j0 + c] = acc[i][j];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the row tile R and head-dim bound DT for a head dim D (0 when D > 256)
inline int tile_rows(int D) { return D <= 128 ? 64 : (D <= 256 ? 32 : 0); }

template <typename T, int DT, int R>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dd, const void* bias, const void* mask,
                      void* dq, void* ds, int B, int H, int Tq, int Tk, int D, int bias_per_bh,
                      float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * (size_t)R * (D + 1) + (size_t)R * (R + 8) + R);
  auto kernel = flash_bwd_dq_kernel<T, DT, R>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tq + R - 1) / R, B * H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const int8_t*>(mask), static_cast<T*>(dq), static_cast<float*>(ds), H, Tq, Tk,
      D, bias_per_bh, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DT, int R>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dd, const void* bias, const void* mask,
                       void* dk, void* dv, int B, int H, int Tq, int Tk, int D, int bias_per_bh,
                       float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * (size_t)R * (D + 1) + 2 * (size_t)R * (R + 8) + 3 * (size_t)R);
  auto kernel = flash_bwd_dkv_kernel<T, DT, R>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tk + R - 1) / R, B * H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const int8_t*>(mask), static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, D,
      bias_per_bh, scale, causal);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_dbias(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dd, const void* bias, const void* mask,
                         void* dbias, int B, int H, int Tq, int Tk, int D, float scale, int causal,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * (size_t)R * (D + 1) + (size_t)R * (R + 8) + 3 * (size_t)R);
  auto kernel = flash_bwd_dbias_kernel<T, R>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tk + R - 1) / R, (Tq + R - 1) / R, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const int8_t*>(mask), static_cast<float*>(dbias), B, H, Tq, Tk, D, scale,
      causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Tq, int Tk, int D, int causal) {
  return B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || tile_rows(D) == 0 ||
         (causal && Tq != Tk);
}

}  // namespace

// q, k, v, dout and the gradients are bf16 (the storage dtype T of the
// kernels, built for bf16 only). lse and dd are fp32 (B, H, Tq); bias is
// bf16 (H, Tq, Tk) shared by the batch (bias_per_bh = 0) or (B * H, Tq, Tk)
// (bias_per_bh = 1), or null; mask is int8 (B, Tk) or null. ds, when not
// null, is fp32 (B * H, Tq, Tk).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dd,
                                      const void* bias, const void* mask, void* dq, void* ds,
                                      int B, int H, int Tq, int Tk, int D, int bias_per_bh,
                                      int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, Tq, Tk, D, causal)) return (int)cudaErrorInvalidValue;
#define OFA_DQ(DT, R)                                                                   \
  launch_dq<__nv_bfloat16, DT, R>(q, k, v, dout, lse, dd, bias, mask, dq, ds, B, H, Tq, Tk, D, \
                                  bias_per_bh, scale, causal, s)
  const cudaError_t err = D <= 64 ? OFA_DQ(64, 64) : (D <= 128 ? OFA_DQ(128, 64) : OFA_DQ(256, 32));
#undef OFA_DQ
  return (int)err;
}

// as flash_attention_bwd_dq; dk and dv are (B, Tk, E) in the storage dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dd,
                                       const void* bias, const void* mask, void* dk, void* dv,
                                       int B, int H, int Tq, int Tk, int D, int bias_per_bh,
                                       int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, Tq, Tk, D, causal)) return (int)cudaErrorInvalidValue;
#define OFA_DKV(DT, R)                                                                   \
  launch_dkv<__nv_bfloat16, DT, R>(q, k, v, dout, lse, dd, bias, mask, dk, dv, B, H, Tq, Tk, D, \
                                   bias_per_bh, scale, causal, s)
  const cudaError_t err =
      D <= 64 ? OFA_DKV(64, 64) : (D <= 128 ? OFA_DKV(128, 64) : OFA_DKV(256, 32));
#undef OFA_DKV
  return (int)err;
}

// bias (H, Tq, Tk) shared by the batch is required; dbias is fp32 (H, Tq, Tk).
extern "C" int flash_attention_bwd_dbias(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* dd,
                                         const void* bias, const void* mask, void* dbias, int B,
                                         int H, int Tq, int Tk, int D, int causal, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, Tq, Tk, D, causal) || bias == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      tile_rows(D) == 64 ? launch_dbias<__nv_bfloat16, 64>(q, k, v, dout, lse, dd, bias, mask,
                                                           dbias, B, H, Tq, Tk, D, scale, causal, s)
                         : launch_dbias<__nv_bfloat16, 32>(q, k, v, dout, lse, dd, bias, mask,
                                                           dbias, B, H, Tq, Tk, D, scale, causal, s);
  return (int)err;
}
