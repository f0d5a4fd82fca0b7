// Flash attention forward for long sequences, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// ofasys_tpu/ops/pallas_attention.py (kernel B3, launched by
// `_flash_forward`). Same function: for every sample b, head h and query
// row i, over the keys j in tiles,
//   s_j   = (q_i . k_j) * scale          (fp32 sum of the storage-dtype products)
//         + bias[h or b*H + h, i, j]     (read from bf16, added in fp32)
//   s_j   = -1e9 where mask[b, j] == 0, and where j > i under `causal`
//   online softmax: m starts at -inf; per tile m' = max(m, max_j s_j),
//           p_j = exp(s_j - m'), l = l * exp(m - m') + sum_j p_j (unrounded p),
//           acc = acc * exp(m - m') + sum_j round(p_j) v_j   (round() to the
//           storage dtype, the sum in fp32)
//   out_i = acc / max(l, 1e-30)          (stored in the storage dtype)
//   lse_i = m + log(max(l, 1e-30))       (fp32; the backward, B4/B5, needs it)
// q/out are (B, Tq, E) and k/v (B, Tk, E) with E = H * D: heads are sliced
// inside the kernel, so the projection GEMMs' outputs are used as they are.
// Under `causal` (Tq == Tk, start-aligned: key j <= row i) the key tiles
// strictly above the diagonal are skipped and their K/V/bias never read, as
// `_causal_kmap` skips their DMA on the TPU.
// The TPU wrapper pads Tq to 16 and Tk to 128 and masks the padded keys;
// here the last key tile is ragged and its missing keys are left out of the
// softmax (p = 0, V rows zeroed), which gives the same result on every row
// that keeps at least one key.
//
// What bounds it on the H100: at the gigaword_long encoder shape B = 16,
// T = 1000, H = 12, D = 64 it must move about 123 MB (q, k, v, out in bf16,
// the shared bf16 bias, mask, lse), 0.037 ms at 3.35 TB/s, and do 49 GFLOP
// (4 B H Tq Tk D), 0.050 ms at 989 TFLOP/s: bound by operations.
// This first version runs both products on the CUDA cores in fp32 (a
// register tile of 4 x 8 scores and 4 x D/8 outputs per thread), so it is
// bound by fp32 FMA issue and shared-memory loads instead; tensor cores
// (mma.sync / wgmma) and TMA staging are later work.
//
// Design: one block of 128 threads per (tile of R query rows, b * H + h),
// looping over key tiles of R keys. The block keeps its q rows, one K (then
// V) tile, the tile's bias and its rounded p in shared memory (fp32, row
// stride D + 1 for the operands and R + 8 for the score tile, so the
// threads of a warp hit distinct banks), the running m, l and the output
// accumulator in registers. Scores and probabilities never leave the SM.
// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16 i and keys
// (or output columns) tx + 8 j; the 8 threads of a row are neighbours in
// one warp, so row max and row sum are three shuffles.
//
// C interface, loaded with ctypes; returns cudaGetLastError() so the caller
// can raise on a refused launch.

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

// reductions over the 8 threads (tx = 0..7) that share a row
__device__ __forceinline__ float row_max(float x) {
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// DT: head dim rounded up (64, 128 or 256); R: query rows and keys per tile
template <typename T, int DT, int R>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const __nv_bfloat16* __restrict__ bias, const int8_t* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 int bias_per_bh, float scale, int causal) {
  constexpr int RM = R / 16;    // query rows per thread
  constexpr int CN = R / 8;     // keys per thread in a score tile
  constexpr int DN = DT / 8;    // output columns per thread
  constexpr int lp = R + 8;     // row stride of the score tile
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;             // R x ld: q rows
  float* kv = qs + R * ld;      // R x ld: K tile, then V tile
  float* ps = kv + R * ld;      // R x lp: bias tile, then rounded p
  float* ms = ps + R * lp;      // R: 1 where the key is kept, 0 where masked

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

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  // under causal, tiles whose first key lies past the block's last row are
  // above the diagonal: skipped, nothing of them is read
  const int k_end = causal ? min(Tk, q0 + R) : Tk;
  for (int j0 = 0; j0 < k_end; j0 += R) {
    const int n = min(R, Tk - j0);
    __syncthreads();            // the previous tile is done with kv and ps
    stage_rows<T, R>(kv, ld, k, kv_base + (size_t)j0 * E, n, D, E);
    if (bias_bh != nullptr) {
      for (int i = tid; i < R * R; i += kThreads) {
        const int r = i / R, c = i - r * R;
        ps[r * lp + c] = (r < rows && c < n)
                             ? __bfloat162float(bias_bh[(size_t)(q0 + r) * Tk + j0 + c]) : 0.f;
      }
    }
    if (tid < R)
      ms[tid] = (mask == nullptr || (tid < n && mask[(size_t)b * Tk + j0 + tid] != 0)) ? 1.f : 0.f;
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RM], c[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) c[j] = kv[(tx + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // online softmax over this tile
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 8 * j;
        float x = -INFINITY;    // keys past Tk take no part
        if (c < n) {
          x = s[i][j] * scale;
          if (bias_bh != nullptr) x += ps[r * lp + c];
          if (ms[c] == 0.f) x = kMaskValue;
          if (causal && j0 + c > q0 + r) x = kMaskValue;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // key 0 of every tile is in range, so m_new is finite
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();            // every thread is done with the K and bias tiles

    // rounded p over the bias tile, V over the K tile (rows past Tk zeroed)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) ps[(ty + 16 * i) * lp + tx + 8 * j] = round_to<T>(s[i][j]);
    stage_rows<T, R>(kv, ld, v, kv_base + (size_t)j0 * E, n, D, E);
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ps[(ty + 16 * i) * lp + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int d = tx + 8 * j;
        vv[j] = d < D ? kv[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = tx + 8 * j;
      if (d < D) out[q_base + (size_t)r * E + d] = from_float<T>(acc[i][j] / lc);
    }
    if (tx == 0) lse[(size_t)bh * Tq + q0 + r] = m[i] + logf(lc);
  }
}

template <typename T, int DT, int R>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, void* out, void* lse, int B, int H, int Tq, int Tk, int D,
                   int bias_per_bh, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)R * (D + 1) + (size_t)R * (R + 8) + R);
  auto kernel = flash_fwd_kernel<T, DT, R>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Tq + R - 1) / R, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const int8_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, Tk, D, bias_per_bh, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and out are bf16 (the storage dtype T of the kernel, built for
// bf16 only). bias is bf16 (H, Tq, Tk) shared by the batch (bias_per_bh = 0)
// or (B * H, Tq, Tk) (bias_per_bh = 1), or null; mask is int8 (B, Tk) or
// null; lse is fp32 (B, H, Tq). `causal` needs Tq == Tk.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                   const void* mask, void* out, void* lse, int B, int H, int Tq,
                                   int Tk, int D, int bias_per_bh, int causal, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > 256 || (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const cudaError_t err =
      D <= 64 ? launch<T, 64, 64>(q, k, v, bias, mask, out, lse, B, H, Tq, Tk, D, bias_per_bh,
                                  scale, causal, s)
      : D <= 128 ? launch<T, 128, 64>(q, k, v, bias, mask, out, lse, B, H, Tq, Tk, D, bias_per_bh,
                                      scale, causal, s)
                 : launch<T, 256, 32>(q, k, v, bias, mask, out, lse, B, H, Tq, Tk, D, bias_per_bh,
                                      scale, causal, s);
  return (int)err;
}
