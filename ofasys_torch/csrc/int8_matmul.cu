// W8A8 matrix product with the dequantizing epilogue fused, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of ofasys_tpu/ops/pallas_int8.py
// (kernel B7). Same function: for every row m and column n,
//   acc       = sum_k xq[m, k] * q[n, k]        (int8 x int8 -> int32, exact)
//   out[m, n] = ((float)acc * sx[m]) * sc[n]    (fp32, in that order), then
//               rounded to the output dtype (bf16 or fp32)
// xq is (M, K) int8 with its per-row scales sx (M,) fp32; the weight q is
// (N, K) int8, K contiguous like nn.Linear's (out, in), with per-output
// scales sc (N,) fp32; out is (M, N). The integer product is exact in any
// order and the epilogue has no add (so nothing to contract into an FMA):
// every plan equals the plain version bit for bit.
//
// What bounds it on the H100, and what the design does about it:
//   * Decode steps (M = batch x beam, at most 64 rows) are bound by bytes:
//     the tied logits, 40 x 768 x 50,048, read the 38.4 MB int8 table once
//     (11.5 us at 3.35 TB/s; 3.1 G int8 operations are 1.6 us on the
//     tensor cores). The small-M plan holds all M rows in one block and
//     walks 32 or 64 columns of the weight per block through a ring of
//     three cp.async stages of 128 bytes of K (a whole 128-byte line of each
//     weight row per copy; 64-byte stages measured 1.3x slower at the
//     logits on the H100), so each SM keeps tens of KB of the table in
//     flight. Where the columns alone give fewer than about 100 blocks
//     (decode q/k/v/out and fc2 have N = 768: 24 blocks), K is split over
//     a thread-block cluster of 2-8 blocks: the leader sums the other
//     ranks' int32 tiles through distributed shared memory, in rank order,
//     and alone runs the epilogue. One launch, no scratch in device memory.
//   * The encoder's projections (B*T in the thousands) are bound by
//     operations: 128 x 128 tiles, 8 warps of 64 x 32, a ring of four
//     stages of 64 bytes, and the same split where the tiles are too few.
//   Products run on the int8 tensor cores (mma.sync m16n8k32 s8, fragments
//   by ldmatrix from rows padded by 16 bytes, which keeps ldmatrix free of
//   bank conflicts); ragged M, N and K are zero-filled by cp.async with a
//   source size of 0, never read past an end. The epilogue stages the tile
//   in shared memory and writes 16-byte rows where N allows it.
//   * K % 16 != 0, or an operand off a 16-byte boundary, rules out 16-byte
//     copies: there the first kernel of this file runs (__dp4a on the CUDA
//     cores, 64 x 64 tiles, bytes staged with a zero fill). No shape of the
//     model's path takes it (K is 768 or 3,072).
// The host-side plan (which kernel, tile and split) is
// ofasys_torch/ops/int8_matmul.py `int8_plan`.
//
// C interface, loaded with ctypes; returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan the kernels do not take) so the caller
// can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using dense_mma::cp_async16_zfill;
using dense_mma::cp_async_commit;
using dense_mma::cp_async_wait_group;
using dense_mma::ldmatrix_x2;
using dense_mma::ldmatrix_x4;
using dense_mma::mma_s8;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dequant(int32_t acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}

// ------------------------------------------------- __dp4a (any K, any address)
constexpr int kTile = 64;        // output rows and columns per block
constexpr int kStep = 64;        // K bytes per shared-memory stage
constexpr int kWords = kStep / 4;
constexpr int kPitch = kWords + 1;
constexpr int kThreads = 256;

// One 16-byte piece of a tile row, byte by byte with a zero fill: k0 is the
// first of its 16 K indices.
__device__ __forceinline__ void stage_piece(const int8_t* __restrict__ src, int rows, int K,
                                            int row, int k0, int32_t* dst) {
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

// One block of 256 threads per 64 x 64 output tile; rows kept as 17 words
// so the 16 threads of a half-warp that read 16 B rows at one word hit
// distinct banks; each thread owns a 4 x 4 block of the tile (rows ty + 16 i,
// columns tx + 16 j), four int8 pairs per __dp4a.
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_dp4a_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ q, const float* __restrict__ sc,
                 T* __restrict__ out, int M, int N, int K) {
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
    stage_piece(a_src, a_rows, K, prow, k0 + 16 * pcol, piece);
#pragma unroll
    for (int w = 0; w < 4; ++w) as[prow * kPitch + 4 * pcol + w] = piece[w];
    stage_piece(b_src, b_rows, K, prow, k0 + 16 * pcol, piece);
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
      out[(size_t)m * N + n] = from_float<T>(dequant(acc[i][j], s_row, sc[n]));
    }
  }
}

// ---------------------------------------------- tensor cores (K % 16 == 0)
// A stage holds BK bytes of K of every tile row, at a pitch of BK + 16
// bytes (80 or 144: the 8 rows an ldmatrix reads fall in distinct banks).
template <int BM, int BN, int BK, int STAGES, bool kSplit, typename T>
constexpr size_t mma_smem_bytes() {
  constexpr size_t ring = (size_t)STAGES * (BM + BN) * (BK + 16);
  constexpr size_t red = kSplit ? (size_t)BM * (BN + 8) * 4 : 0;
  constexpr size_t epi = (size_t)BM * (BN + 16 / sizeof(T)) * sizeof(T);
  return ring > red ? (ring > epi ? ring : epi) : (red > epi ? red : epi);
}

// A block of WM x WN warps computes a (BM = WM*MT*16) x (BN = WN*NT*8)
// output tile through a ring of STAGES stages of BK bytes of K; warp
// (wm, wn) owns rows wm*MT*16 + [0, MT*16) and columns wn*NT*8 + [0, NT*8).
// gridDim.z ranks split K in 16-byte chunks; with kSplit they form one
// cluster along z and rank 0 sums and writes.
template <int WM, int WN, int MT, int NT, int BK, int STAGES, bool kSplit, typename T>
__global__ void __launch_bounds__(WM * WN * 32)
int8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const int8_t* __restrict__ q, const float* __restrict__ sc,
                T* __restrict__ out, int M, int N, int K) {
  constexpr int kThreadsB = WM * WN * 32;
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int kLds = BK + 16;
  constexpr int kCpr = BK / 16;                         // 16-byte chunks per row and stage
  constexpr int kLoads = (BM + BN) * kCpr / kThreadsB;  // chunks per thread and stage
  static_assert((BM + BN) * kCpr % kThreadsB == 0, "whole chunks per thread");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments come in pairs of n-tiles");
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;
  uint8_t* Bs = smem + STAGES * BM * kLds;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // rows of A that hold data, rounded to whole m-tiles: the others are
  // neither staged nor multiplied (a decode step's 4 or 40 rows)
  const int a_rows = min(BM, M - m0);
  const int a_pad = (a_rows + 15) / 16 * 16;
  const int mt_live = min(MT, max(0, (a_rows - wm * MT * 16 + 15) / 16));
  // this rank's share of K, in whole 16-byte chunks
  const int chunks = K / 16;
  const int k0 = 16 * (int)((long long)blockIdx.z * chunks / gridDim.z);
  const int k1 = 16 * (int)((long long)(blockIdx.z + 1) * chunks / gridDim.z);
  const int nk = (k1 - k0 + BK - 1) / BK;

  auto load_stage = [&](int slot, int ks) {
    const int kb = k0 + ks * BK;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreadsB;
      const int row = i / kCpr, c = i % kCpr;
      const int k = kb + 16 * c;
      if (row < BM) {
        if (row >= a_pad) continue;
        const bool full = m0 + row < M && k < k1;
        cp_async16_zfill(As + (slot * BM + row) * kLds + 16 * c,
                         full ? xq + (size_t)(m0 + row) * K + k : xq, full);
      } else {
        const int r = row - BM;
        const bool full = n0 + r < N && k < k1;
        cp_async16_zfill(Bs + (slot * BN + r) * kLds + 16 * c,
                         full ? q + (size_t)(n0 + r) * K + k : q, full);
      }
    }
  };

  int32_t acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait_group<STAGES - 2>();
    __syncthreads();  // stage ks has landed, and every warp is done with ks - 1's slot
    const int nx = ks + STAGES - 1;
    if (nx < nk) load_stage(nx % STAGES, nx);
    cp_async_commit();
    const int slot = ks % STAGES;
    const uint8_t* as = As + (slot * BM + wm * MT * 16) * kLds;
    const uint8_t* bs = Bs + (slot * BN + wn * NT * 8) * kLds;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t b[NT][2];
      if constexpr (NT == 1) {
        ldmatrix_x2(b[0], bs + (lane % 8) * kLds + kk + 16 * ((lane / 8) % 2));
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, bs + (16 * p + lane % 8 + 8 * (lane / 16)) * kLds + kk +
                             16 * ((lane / 8) % 2));
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mt_live) {
          uint32_t a[4];
          ldmatrix_x4(a, as + (16 * mt + lane % 16) * kLds + kk + 16 * (lane / 16));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
  }
  cp_async_wait_group<0>();
  __syncthreads();  // the ring is free: its bytes take the partial or the output tile

  const int g = lane / 4, t = lane % 4;
  if constexpr (kSplit) {
    // rank r > 0 leaves its int32 tile in its shared memory; the leader adds
    // the tiles of ranks 1, 2, ... to its registers, then every rank waits
    // until the leader has read (a block's shared memory ends with it)
    constexpr int RS = BN + 8;
    int32_t* red = reinterpret_cast<int32_t*>(smem);
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned crank = cluster.block_rank();
    if (crank != 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= mt_live) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = wm * MT * 16 + 16 * mt + g, c = wn * NT * 8 + 8 * nt + 2 * t;
          *reinterpret_cast<int2*>(red + r * RS + c) = make_int2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<int2*>(red + (r + 8) * RS + c) =
              make_int2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
    }
    cluster.sync();
    if (crank == 0) {
      for (unsigned src = 1; src < cluster.num_blocks(); ++src) {
        const int32_t* rem = cluster.map_shared_rank(red, src);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt >= mt_live) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int r = wm * MT * 16 + 16 * mt + g, c = wn * NT * 8 + 8 * nt + 2 * t;
            const int2 lo = *reinterpret_cast<const int2*>(rem + r * RS + c);
            const int2 hi = *reinterpret_cast<const int2*>(rem + (r + 8) * RS + c);
            acc[mt][nt][0] += lo.x;
            acc[mt][nt][1] += lo.y;
            acc[mt][nt][2] += hi.x;
            acc[mt][nt][3] += hi.y;
          }
        }
      }
    }
    cluster.sync();
    if (crank != 0) return;
  }

  // epilogue: (acc * sx) * sc rounded to T into a shared tile, then rows out
  constexpr int ES = BN + 16 / (int)sizeof(T);
  T* st = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mt_live) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * MT * 16 + 16 * mt + g + 8 * h;
      const float s_row = m0 + r < M ? sx[m0 + r] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = wn * NT * 8 + 8 * nt + 2 * t;
        const int n = n0 + c;
        const float s0 = n < N ? sc[n] : 0.f, s1 = n + 1 < N ? sc[n + 1] : 0.f;
        st[r * ES + c] = from_float<T>(dequant(acc[mt][nt][2 * h], s_row, s0));
        st[r * ES + c + 1] = from_float<T>(dequant(acc[mt][nt][2 * h + 1], s_row, s1));
      }
    }
  }
  __syncthreads();
  const int cols = min(BN, N - n0);
  if ((N * (int)sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T), kCprOut = BN / kPer;
    for (int i = tid; i < a_rows * kCprOut; i += kThreadsB) {
      const int r = i / kCprOut, c = (i % kCprOut) * kPer;
      if (c < cols)
        *reinterpret_cast<int4*>(out + (size_t)(m0 + r) * N + n0 + c) =
            *reinterpret_cast<const int4*>(st + r * ES + c);
    }
  } else {
    for (int i = tid; i < a_rows * BN; i += kThreadsB) {
      const int r = i / BN, c = i % BN;
      if (c < cols) out[(size_t)(m0 + r) * N + n0 + c] = st[r * ES + c];
    }
  }
}

template <typename T>
cudaError_t launch_dp4a(const void* xq, const void* sx, const void* q, const void* sc, void* out,
                        int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  int8_dp4a_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(q), static_cast<const float*>(sc), static_cast<T*>(out), M, N,
      K);
  return cudaGetLastError();
}

template <int WM, int WN, int MT, int NT, int BK, int STAGES, bool kSplit, typename T>
cudaError_t launch_mma(const void* xq, const void* sx, const void* q, const void* sc, void* out,
                       int M, int N, int K, int split, cudaStream_t stream) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr size_t smem = mma_smem_bytes<BM, BN, BK, STAGES, kSplit, T>();
  auto kernel = int8_mma_kernel<WM, WN, MT, NT, BK, STAGES, kSplit, T>;
  static const cudaError_t attr = dense_mma::allow_smem_carveout(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  const auto* a = static_cast<const int8_t*>(xq);
  const auto* b = static_cast<const int8_t*>(q);
  const auto* sa = static_cast<const float*>(sx);
  const auto* sb = static_cast<const float*>(sc);
  T* o = static_cast<T*>(out);
  if constexpr (kSplit) {
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = split;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(WM * WN * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, sa, b, sb, o, M, N, K);
    if (err != cudaSuccess) return err;
  } else {
    kernel<<<grid, WM * WN * 32, smem, stream>>>(a, sa, b, sb, o, M, N, K);
  }
  return cudaGetLastError();
}

// kernel: 0 = __dp4a, 1 = small M (4 warps, all M <= 64 rows, tile_n 32 or
// 64 columns; stages of 128 bytes, three deep: a whole 128-byte line of
// each weight row a copy), 2 = large M (8 warps, 128 x 128; stages of 64
// bytes, four deep); split = cluster ranks on K.
template <typename T>
cudaError_t run(const void* xq, const void* sx, const void* q, const void* sc, void* out, int M,
                int N, int K, int kernel, int tile_n, int split, cudaStream_t s) {
  if (kernel == 0) return launch_dp4a<T>(xq, sx, q, sc, out, M, N, K, s);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(q);
  const bool aligned = (addr & 15) == 0;
  if (K % 16 || !aligned || split < 1 || split > 8 || split > K / 16) return cudaErrorInvalidValue;
  const bool many = split > 1;
  if (kernel == 1 && M <= 64 && tile_n == 32)
    return many ? launch_mma<1, 4, 4, 1, 128, 3, true, T>(xq, sx, q, sc, out, M, N, K, split, s)
                : launch_mma<1, 4, 4, 1, 128, 3, false, T>(xq, sx, q, sc, out, M, N, K, split, s);
  if (kernel == 1 && M <= 64 && tile_n == 64)
    return many ? launch_mma<1, 4, 4, 2, 128, 3, true, T>(xq, sx, q, sc, out, M, N, K, split, s)
                : launch_mma<1, 4, 4, 2, 128, 3, false, T>(xq, sx, q, sc, out, M, N, K, split, s);
  if (kernel == 2 && tile_n == 128)
    return many ? launch_mma<2, 4, 4, 4, 64, 4, true, T>(xq, sx, q, sc, out, M, N, K, split, s)
                : launch_mma<2, 4, 4, 4, 64, 4, false, T>(xq, sx, q, sc, out, M, N, K, split, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// out_dtype: 0 = bfloat16, 1 = float32. kernel, tile_n and split are the
// plan of ops/int8_matmul.py `int8_plan`.
extern "C" int int8_matmul(const void* xq, const void* sx, const void* q, const void* sc,
                           void* out, int M, int N, int K, int kernel, int tile_n, int split,
                           int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return (int)run<__nv_bfloat16>(xq, sx, q, sc, out, M, N, K, kernel, tile_n, split, s);
  if (out_dtype == 1)
    return (int)run<float>(xq, sx, q, sc, out, M, N, K, kernel, tile_n, split, s);
  return (int)cudaErrorInvalidValue;
}
