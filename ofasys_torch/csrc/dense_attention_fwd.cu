// Dense (whole-row) attention forward for short sequences, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_fwd_kernel_g` of
// ofasys_tpu/ops/pallas_dense_attention.py (kernel B1). Same function:
// for every sample b, head h and query row i,
//   s_j   = (q_i . k_j) * scale  (fp32 sum of the storage-dtype products; the
//           model's path passes a pre-scaled q and scale 1)
//         + bias[h, i, j]            (bf16, shared by the batch)
//   s_j   = -1e9 where mask[b, j] == 0  (the row max includes these values)
//   s_j   = -1e9 where causal and j > i + (Tk - Tq)
//   m     = max_j s_j,  p_j = exp(s_j - m),  l = sum_j p_j  (all fp32)
//   out_i = (sum_j round(p_j) v_j) / l   with round() to the storage dtype,
//           the sum in fp32, the result stored in the storage dtype
//   lse_i = m + log(l)                   (fp32; the backward, B2, needs it)
// q/out are (B, Tq, E) and k/v (B, Tk, E) with E = H * D: heads are sliced
// inside the kernel, so the projection GEMMs' outputs are used as they are.
//
// What bounds it on the H100: at the caption encoder's shape B = 64,
// T = 228, E = 768, H = 12 it must move about 91.6 MB (q, k, v and out in
// bf16, the bias, the mask, the lse), 0.027 ms at 3.35 TB/s, and do 5.1
// GFLOP (two (Tq, Tk, D) products), 0.005 ms at 989 TFLOP/s: bound by bytes.
//
// Design (bf16, the model's dtype). Query rows go in tiles of 16 * W rows,
// W warps of 16 rows each: W = 8 unless 64-row tiles pad fewer rows (then
// 4), fewer where a wide head's shared memory needs it. A block copies the
// (b, h)'s K into shared memory with cp.async (bf16, 16-byte copies; a head
// dim that is no multiple of 16 zero-filled) and then walks either all the
// row tiles of its (b, h), with V in a buffer of its own copied under the
// first tile's scores, or one tile, with V copied into K's buffer after the
// scores; the launcher takes the first unless it fills the SMs' last wave of
// blocks worse. For each tile the block copies its q rows and each lane's
// bias values, and each warp runs on the tensor cores (mma.sync m16n8k16,
// operands through ldmatrix, see dense_mma.cuh):
//   1. S = q K^T for its 16 rows over every key, 32 keys at a time; scale,
//      bias, mask and causal applied to the fp32 accumulators, which go to
//      the warp's own scratch in shared memory (one float4 per lane per
//      8-key tile; each lane reads back only what it wrote); the row max is
//      taken on the way. Key columns past Tk (padding to 16) are -inf: out
//      of the max and the sums, unlike a masked key's -1e9. Under causal,
//      the 16-key chunks past the warp's last diagonal are skipped.
//   2. p = exp(s - m) and l = sum p (fp32, unrounded); round(p) is packed in
//      place as the A fragments of the next product.
//   3. out = (round(p) V) / l on the tensor cores, 64 output columns at a
//      time, and lse = m + log l.
// What holds it back (PERF.md, section 6): the score scratch (64 KB for 64
// rows at Tk = 256) keeps a block's warps to 8 per SM, and a tile's phases
// (copies, scores, softmax, P V) run one after another. A kernel that swept
// the keys twice from registers, one 16-warp block per (b, h), measured
// slower.
// The fp32 instantiation (not on the model's path: the model runs bf16 on
// the card) keeps the first CUDA-core design: one block per 16 query rows,
// operands staged as fp32, scalar products.
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
                           float* __restrict__ lse, int H, int Tq, int Tk, int D, int kc,
                           float scale, int causal) {
  extern __shared__ float smem[];
  const int E = H * D;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, Tq - row0);
  const int ld = D + 1;
  const int tid = threadIdx.x;
  // keys this tile computes: all, or up to its last row's diagonal
  const int nk = causal ? max(0, min(Tk, row0 + rows + (Tk - Tq))) : Tk;

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
  for (int j0 = 0; j0 < nk; j0 += kc) {
    const int n = min(kc, nk - j0);
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
      ss[r * Tk + j0 + j] = acc * scale;
    }
  }
  __syncthreads();

  // softmax: one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const int row = row0 + r;
    const int limit = row + (Tk - Tq);            // last visible key under causal
    float* sr = ss + r * Tk;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      float s = sr[j];
      if (bias != nullptr) s += __bfloat162float(bias[((size_t)h * Tq + row) * Tk + j]);
      if (mask != nullptr && mask[(size_t)b * Tk + j] == 0) s = kMaskValue;
      if (causal && j > limit) s = kMaskValue;
      sr[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
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
  for (int j0 = 0; j0 < nk; j0 += kc) {
    const int n = min(kc, nk - j0);
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
                   int D, float scale, int causal, cudaStream_t stream) {
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
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, Tk, D, kc,
      scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16: tensor cores
constexpr int kMmaWarps = 8;             // warps of the largest block, 16 query rows each
constexpr size_t kMaxSmem = 232448;      // 227 KB, the opt-in limit of a block

// shared memory of a block of `warps` warps: q rows, K (then V, unless V
// has its own buffer), the score scratch, the keep-mask
size_t mma_smem_bytes(int warps, int Tk, int D, bool split_kv) {
  const size_t ld = dense_mma::round_up(D, 16) + 8, tkp = dense_mma::round_up(Tk, 16);
  return 2 * ((size_t)warps * 16 * ld + (1 + split_kv) * tkp * ld) +
         4 * (size_t)warps * 16 * tkp + tkp;
}

__global__ void __launch_bounds__(kMmaWarps * 32)
dense_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ bias,
                               const int8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                               float* __restrict__ lse, int H, int Tq, int Tk, int D,
                               float scale, int causal, int vec, int row_tiles, int split_kv) {
  using namespace dense_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int E = H * D, Dp = round_up(D, 16), ld = Dp + 8, Tkp = round_up(Tk, 16);
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // warps * 16 x ld
  __nv_bfloat16* ks = qs + warps * 16 * ld;                          // Tkp x ld: K (then V)
  __nv_bfloat16* vs = split_kv ? ks + Tkp * ld : ks;                 // Tkp x ld: V
  float4* scratch_all = reinterpret_cast<float4*>(vs + Tkp * ld);
  int8_t* ms = reinterpret_cast<int8_t*>(scratch_all + (size_t)warps * (Tkp / 8) * 32);   // Tkp
  // this warp's scratch: one float4 per lane per 8-key column tile, for its
  // scores, then its rounded p (each lane reads back only what it wrote)
  float4* scratch = scratch_all + (size_t)warp * (Tkp / 8) * 32;
  uint4* packed = reinterpret_cast<uint4*>(scratch);

  const size_t kv_base = (size_t)b * Tk * E + (size_t)h * D;
  for (int j = threadIdx.x; j < Tkp; j += blockDim.x)
    ms[j] = (j < Tk && (mask == nullptr || mask[(size_t)b * Tk + j] != 0)) ? 1 : 0;
  stage_tile(ks, ld, k + kv_base, E, Tk, Tkp, D, vec);
  // the block's row tiles, one after another, against one copy of K (and V)
  for (int tile = 0; tile < row_tiles; ++tile) {
    const int row0 = (blockIdx.x * row_tiles + tile) * warps * 16;
    if (row0 >= Tq) break;
    if (tile > 0) __syncthreads();       // the previous tile is done with qs
    const int wrow0 = row0 + warp * 16;
    const bool active = wrow0 < Tq;
    // keys this warp computes: all, or (causal) up to its last row's diagonal
    int nkw = Tk;
    if (causal) nkw = max(1, min(Tk, min(wrow0 + 15, Tq - 1) + (Tk - Tq) + 1));
    const int nc = active ? round_up(nkw, 16) / 16 : 0;    // 16-key chunks
    const int ra = wrow0 + g, rb = ra + 8;                  // this thread's two rows

    stage_tile(qs, ld, q + ((size_t)b * Tq + row0) * E + (size_t)h * D, E,
               min(warps * 16, Tq - row0), warps * 16, D, vec);
    // the bias values this lane adds, rows ra and rb, columns 2t and 2t + 1 of
    // each 8-key tile, in the first 8 bytes of the lane's scratch slot of that
    // tile (read just before the slot takes the tile's scores)
    if (bias != nullptr) {
      const bool pairs = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % 4 == 0;
      for (int tt = 0; tt < 2 * nc; ++tt) {
        const int j = tt * 8 + 2 * t;
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(scratch + tt * 32 + lane);
  #pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? rb : ra;
          if (row >= Tq || j >= Tk) continue;
          const __nv_bfloat16* src = bias + ((size_t)h * Tq + row) * Tk + j;
          if (pairs) {
            cp_async4(dst + 2 * half, src);
          } else {
            dst[2 * half] = src[0];
            if (j + 1 < Tk) dst[2 * half + 1] = src[1];
          }
        }
      }
    }
    if (tile == 0 && split_kv) {           // V's copy runs under the first tile's scores
      cp_async_commit();
      stage_tile(vs, ld, v + kv_base, E, Tk, Tkp, D, vec);
      cp_async_wait_all_but_last();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    // 1. scores, the row max; two 16-key chunks at a time
    const __nv_bfloat16* qw = qs + warp * 16 * ld;
    float m_a = -INFINITY, m_b = -INFINITY;
    for (int c0 = 0; c0 < nc; c0 += 2) {
      const bool two = c0 + 1 < nc;
      float acc[4][4] = {};
      for (int kk = 0; kk < Dp; kk += 16) {
        uint32_t a[4], bk[4], bk2[4];
        const __nv_bfloat16* kp = ks + (c0 * 16 + (lane / 16) * 8 + lane % 8) * ld + kk + ((lane / 8) % 2) * 8;
        ldmatrix_x4(a, qw + (lane % 16) * ld + kk + (lane / 16) * 8);
        ldmatrix_x4(bk, kp);
        if (two) ldmatrix_x4(bk2, kp + 16 * ld);
        mma_bf16(acc[0], a, bk[0], bk[1]);
        mma_bf16(acc[1], a, bk[2], bk[3]);
        if (two) {
          mma_bf16(acc[2], a, bk2[0], bk2[1]);
          mma_bf16(acc[3], a, bk2[2], bk2[3]);
        }
      }
  #pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        if (tt >= 2 && !two) break;
        const int tile = 2 * c0 + tt;
        const uint2 bb = bias != nullptr ? *reinterpret_cast<const uint2*>(scratch + tile * 32 + lane)
                                         : make_uint2(0u, 0u);
        const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bb);
  #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb;
          const int j = tile * 8 + 2 * t + (e & 1);
          float s = -INFINITY;                      // padding past Tk: out of max and sums
          if (j < Tk) {
            s = acc[tt][e] * scale + __bfloat162float(bv[e]);
            if (!ms[j]) s = kMaskValue;
            if (causal && j > row + (Tk - Tq)) s = kMaskValue;
          }
          acc[tt][e] = s;
          if (e < 2) m_a = fmaxf(m_a, s); else m_b = fmaxf(m_b, s);
        }
        scratch[tile * 32 + lane] = make_float4(acc[tt][0], acc[tt][1], acc[tt][2], acc[tt][3]);
      }
    }
  #pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, o));
      m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, o));
    }

    // 2. V into K's buffer unless it has its own (the copy runs under the
    //    softmax); p = exp(s - m) and l from the unrounded p; round(p) packed
    //    as A fragments
    if (!split_kv) {
      __syncthreads();
      stage_tile(vs, ld, v + kv_base, E, Tk, Tkp, D, vec);
      cp_async_commit();
    }
    float l_a = 0.f, l_b = 0.f;
  #pragma unroll 2
    for (int c = 0; c < nc; ++c) {
      const float4 x = scratch[(2 * c) * 32 + lane], y = scratch[(2 * c + 1) * 32 + lane];
      const float p0 = expf(x.x - m_a), p1 = expf(x.y - m_a), p2 = expf(x.z - m_b),
                  p3 = expf(x.w - m_b), p4 = expf(y.x - m_a), p5 = expf(y.y - m_a),
                  p6 = expf(y.z - m_b), p7 = expf(y.w - m_b);
      l_a += (p0 + p1) + (p4 + p5);
      l_b += (p2 + p3) + (p6 + p7);
      packed[(2 * c) * 32 + lane] =
          make_uint4(pack_bf16(p0, p1), pack_bf16(p2, p3), pack_bf16(p4, p5), pack_bf16(p6, p7));
    }
  #pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
    }

    // 3. out = round(p) V / l
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    for (int d0 = 0; d0 < Dp; d0 += 64) {
      float acc[8][4] = {};
      for (int c = 0; c < nc; ++c) {
        const uint4 pk = packed[(2 * c) * 32 + lane];
        const uint32_t a[4] = {pk.x, pk.y, pk.z, pk.w};
        uint32_t bv[4][4];
        const __nv_bfloat16* vp = vs + (c * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ld + (lane / 16) * 8;
  #pragma unroll
        for (int np = 0; np < 4; ++np)
          if (d0 + np * 16 < Dp) ldmatrix_x4_trans(bv[np], vp + d0 + np * 16);
  #pragma unroll
        for (int np = 0; np < 4; ++np)
          if (d0 + np * 16 < Dp) {
            mma_bf16(acc[2 * np], a, bv[np][0], bv[np][1]);
            mma_bf16(acc[2 * np + 1], a, bv[np][2], bv[np][3]);
          }
      }
  #pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = d0 + nt * 8 + 2 * t;
  #pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? rb : ra;
          const float l = half ? l_b : l_a;
          if (row >= Tq || d >= D) continue;
          const float x = acc[nt][2 * half] / l, y = acc[nt][2 * half + 1] / l;
          __nv_bfloat16* o = out + ((size_t)b * Tq + row) * E + (size_t)h * D + d;
          if ((D & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
          } else {
            o[0] = __float2bfloat16_rn(x);
            if (d + 1 < D) o[1] = __float2bfloat16_rn(y);
          }
        }
      }
    }
    if (t == 0) {
      if (ra < Tq) lse[((size_t)b * H + h) * Tq + ra] = m_a + logf(l_a);
      if (rb < Tq) lse[((size_t)b * H + h) * Tq + rb] = m_b + logf(l_b);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* bias,
                       const void* mask, void* out, void* lse, int B, int H, int Tq, int Tk,
                       int D, float scale, int causal, cudaStream_t stream) {
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  // 128-row tiles unless 64-row ones pad fewer query rows; fewer rows where
  // a wide head's shared memory needs it
  int warps = dense_mma::round_up(Tq, 128) - Tq <= dense_mma::round_up(Tq, 64) - Tq ? 8 : 4;
  while (warps > 1 && mma_smem_bytes(warps, Tk, D, false) > kMaxSmem) warps /= 2;
  // One block walks all the row tiles of a (b, h) against one copy of K and
  // V (in its own buffer), or one block takes each tile: the first unless it
  // fills the SMs' last wave of blocks worse (a block per (b, h) is several
  // times longer, so a ragged last wave costs more).
  const int tiles = (Tq + warps * 16 - 1) / (warps * 16);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto fill = [&](bool split, long blocks) {   // share of the block slots the waves use
    const size_t bytes = mma_smem_bytes(warps, Tk, D, split);
    const long slots = bytes > kMaxSmem ? 0 : (long)sms * (long)(233472 / (bytes + 1024));
    return slots == 0 ? 0.0 : (double)blocks / ((double)((blocks + slots - 1) / slots) * slots);
  };
  const int split_kv = tiles > 1 && fill(true, (long)H * B) >= fill(false, (long)tiles * H * B);
  const int row_tiles = split_kv ? tiles : 1;
  const size_t smem = mma_smem_bytes(warps, Tk, D, split_kv);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = dense_mma::allow_smem_carveout(dense_attention_fwd_mma_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles / row_tiles, H, B);
  dense_attention_fwd_mma_kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const int8_t*>(mask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Tq, Tk, D, scale, causal, vec, row_tiles, split_kv);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16 (the tensor-core kernel), 1 = float32 (the CUDA-core
// kernel); q, k, v and out share it. bias is bf16
// (H, Tq, Tk) or null; mask is int8 (B, Tk) or null; lse is fp32 (B, H, Tq).
// causal needs Tq <= Tk (no row without a visible key).
extern "C" int dense_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, void* lse,
                                   int B, int H, int Tq, int Tk, int D, float scale,
                                   int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (causal && Tq > Tk) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_mma(q, k, v, bias, mask, out, lse, B, H, Tq, Tk, D, scale, causal, s);
  } else if (dtype == 1) {
    err = launch<float>(q, k, v, bias, mask, out, lse, B, H, Tq, Tk, D, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
