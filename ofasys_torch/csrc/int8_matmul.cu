// W8A8 matrix product with the dequantizing epilogue fused, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of ofasys_tpu/ops/pallas_int8.py
// (kernel B7). Same function: for every row m and column n,
//   acc       = sum_k xq[m, k] * q[n, k]        (int8 x int8 -> int32, exact)
//   out[m, n] = ((float)acc * sx[m]) * sc[n]    (fp32, in that order), then
//               rounded to the output dtype (bf16 or fp32)
// xq is (M, K) int8 with its per-row scales sx (M,) fp32; the weight q is
// (N, K) int8, K contiguous like nn.Linear's (out, in), with per-output
// scales sc (N,) fp32; out is (M, N). The integer product is exact and the
// epilogue has no add (so nothing to contract into an FMA): the kernel
// equals its plain version bit for bit.
//
// What bounds it on the H100: at the tied logits of a beam-5 decode step,
// M = 40, K = 768, N = 50,048, it reads the 38.4 MB int8 table once
// (11.5 us at 3.35 TB/s) and does 3.1 G int8 operations (1.6 us at 1,979
// TOP/s on the tensor cores): bound by bytes. The encoder's projections
// at B*T in the thousands are bound by operations.
//
// Design: one block of 256 threads per 64 x 64 output tile. K is staged
// through shared memory 64 bytes at a time: each thread brings one 16-byte
// piece of the A tile and one of the B tile (one vector load where K is a
// multiple of 16, bytes with a zero fill at a ragged K tail or edge). Rows
// are kept as 17 words of 4 bytes so the 16 threads of a half-warp that read
// 16 different B rows at the same word hit distinct banks. Each thread owns
// a 4 x 4 block of the tile (rows ty + 16 i, columns tx + 16 j) and keeps
// its 16 int32 sums in registers; the contraction runs on the CUDA cores,
// four int8 pairs per `__dp4a`. Tensor cores (mma.sync s8 or wgmma) and a
// pipelined TMA staging are later work. Ragged M, N and K are handled in
// the kernel.
//
// C interface, loaded with ctypes; returns cudaGetLastError() so the caller
// can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // output rows and columns per block
constexpr int kStep = 64;        // K bytes per shared-memory stage
constexpr int kWords = kStep / 4;
constexpr int kPitch = kWords + 1;
constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One 16-byte piece of a tile row: k0 is the first of its 16 K indices.
__device__ __forceinline__ void stage_piece(const int8_t* __restrict__ src, int rows, int K,
                                            int row, int k0, bool vec, int32_t* dst) {
  if (row < rows && vec && k0 + 16 <= K) {
    const int4 v = *reinterpret_cast<const int4*>(src + (size_t)row * K + k0);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
    return;
  }
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0;
    for (int b = 0; b < 4; ++b) {
      const int k = k0 + 4 * w + b;
      const uint8_t byte = (row < rows && k < K) ? (uint8_t)src[(size_t)row * K + k] : 0;
      word |= (uint32_t)byte << (8 * b);
    }
    dst[w] = (int32_t)word;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                   const int8_t* __restrict__ q, const float* __restrict__ sc,
                   T* __restrict__ out, int M, int N, int K, int vec) {
  __shared__ int32_t as[kTile * kPitch];
  __shared__ int32_t bs[kTile * kPitch];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  // the piece this thread stages: tile row tid / 4, bytes 16 * (tid % 4)
  const int prow = tid / 4, pcol = tid % 4;
  const int8_t* a_src = xq + (size_t)m0 * K;
  const int8_t* b_src = q + (size_t)n0 * K;
  const int a_rows = min(kTile, M - m0), b_rows = min(kTile, N - n0);

  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kStep) {
    int32_t piece[4];
    stage_piece(a_src, a_rows, K, prow, k0 + 16 * pcol, vec != 0, piece);
#pragma unroll
    for (int w = 0; w < 4; ++w) as[prow * kPitch + 4 * pcol + w] = piece[w];
    stage_piece(b_src, b_rows, K, prow, k0 + 16 * pcol, vec != 0, piece);
#pragma unroll
    for (int w = 0; w < 4; ++w) bs[prow * kPitch + 4 * pcol + w] = piece[w];
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * kPitch + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[(tx + 16 * j) * kPitch + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float s_row = sx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), s_row), sc[n]);
      out[(size_t)m * N + n] = from_float<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* xq, const void* sx, const void* q, const void* sc, void* out,
                   int M, int N, int K, int vec, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(q), static_cast<const float*>(sc), static_cast<T*>(out),
      M, N, K, vec);
  return cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = bfloat16, 1 = float32. vec = 1 when K is a multiple of 16
// and both int8 operands start on a 16-byte boundary (vector loads).
extern "C" int int8_matmul(const void* xq, const void* sx, const void* q, const void* sc,
                           void* out, int M, int N, int K, int vec, int out_dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 0 || N <= 0 || K <= 0) {
    err = cudaErrorInvalidValue;
  } else if (out_dtype == 0) {
    err = launch<__nv_bfloat16>(xq, sx, q, sc, out, M, N, K, vec, s);
  } else if (out_dtype == 1) {
    err = launch<float>(xq, sx, q, sc, out, M, N, K, vec, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
