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
// (4 B H Tq Tk D), 0.050 ms at 989 TFLOP/s: bound by operations. Both
// products run on the tensor cores; the softmax between them (scale, bias,
// mask, exp, row max and sum: about a dozen fp32 instructions per score)
// runs on the CUDA cores and is, as in every flash forward on mma.sync, the
// larger part of the time at D = 64.
//
// Design (bf16; the kernel is built for bf16 only): one block of 4 warps per
// (tile of 64 query rows, b, h), 16 rows per warp, walking the key tiles of
// KT keys (64 at D <= 64; 32 above, where the fp32 output accumulators, D / 2
// a thread, need the registers):
//   * the q rows, and two stages of K, V, the tile's bias (64 x KT) and its
//     keep-mask, in shared memory as bf16 (row stride a multiple of 16 plus
//     8 elements, see dense_mma.cuh; a head dim that is no multiple of 16
//     zero-filled). 16-byte cp.async copies the next tile while the block
//     computes on this one.
//   * S = q K^T per warp with mma.sync m16n8k16 (q and K through ldmatrix);
//     scale, bias, mask and (on tiles that cross the diagonal only) the
//     causal mask on the fp32 accumulators; the online softmax in fp32
//     registers, exp as one FFMA and one exp2, row max and row sum over the
//     4 lanes of a quad (each lane keeps its part of l until the end).
//   * round(p) goes from the accumulators straight into the A fragments of
//     O += round(p) V (V through ldmatrix.trans); O stays in registers.
// Under causal a warp skips the key tiles past its last row, and the longest
// query tiles (most key tiles) start first. The grid runs the B samples of
// one (query tile, head) side by side, so a bias shared by the batch (24 MB
// at H = 12, T = 1,000) is read from HBM once and from the 50 MB L2 by the
// other samples.
// What holds it back (PERF.md, section 6): three blocks of 4 warps per SM
// (64.6 KB of shared memory each at D = 64), two barriers per key tile, and
// the softmax's CUDA-core instructions between the two products. Two 16-row
// tiles per warp (K and V fragments read once for 32 rows) took 222
// registers and measured slower.
//
// C interface, loaded with ctypes; returns cudaGetLastError() so the caller
// can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kRows = kWarps * 16;   // query rows per block, 16 per warp

// shared memory of a block: the q rows, and two stages of the K and V
// tiles, the bias tile and the tile's keep-mask
size_t smem_bytes(int KT, int D) {
  const size_t ld = dense_mma::round_up(D, 16) + 8, lb = KT + 8;
  return 2 * ((size_t)kRows * ld + 4 * (size_t)KT * ld + 2 * (size_t)kRows * lb) + 2 * (size_t)KT;
}

// the bias tile: rows [0, rows) and columns [0, n) of a (., Tk) bf16 matrix
// from src, into dst (kRows x KT, row stride lb), zero elsewhere. `vec`: 16-byte
// copies are aligned (Tk a multiple of 8, the base 16-byte aligned).
template <int KT>
__device__ __forceinline__ void stage_bias(__nv_bfloat16* dst, int lb,
                                           const __nv_bfloat16* __restrict__ src, int Tk,
                                           int rows, int n, int vec) {
  if (vec) {
    constexpr int cpr = KT / 8;
    for (int i = threadIdx.x; i < kRows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      __nv_bfloat16* d = dst + r * lb + c;
      if (r < rows && c < n)
        dense_mma::cp_async16(d, src + (size_t)r * Tk + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < kRows * KT; i += kThreads) {
      const int r = i / KT, c = i - r * KT;
      dst[r * lb + c] = (r < rows && c < n) ? src[(size_t)r * Tk + c] : zero;
    }
  }
}

// DMAX: the largest head dim of the instance (64, 128, 256); KT: keys per tile
template <int DMAX, int KT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bias,
                     const int8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ out32, float* __restrict__ lse, int H, int Tq, int Tk,
                     int D, int bias_per_bh, float scale, int causal, int vec, int bias_vec) {
  using namespace dense_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int lb = KT + 8;
  const int Dp = round_up(D, 16), ld = Dp + 8, E = H * D;
  const int b = blockIdx.x, h = blockIdx.z, bh = b * H + h;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRows, rows = min(kRows, Tq - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rl_a = warp * 16 + g, rl_b = rl_a + 8;   // this thread's rows in the block

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kRows x ld
  __nv_bfloat16* ks = qs + kRows * ld;                               // 2 x KT x ld
  __nv_bfloat16* vs = ks + 2 * KT * ld;                              // 2 x KT x ld
  __nv_bfloat16* bs = vs + 2 * KT * ld;                              // 2 x kRows x lb
  int8_t* ms = reinterpret_cast<int8_t*>(bs + 2 * kRows * lb);       // 2 x KT

  const size_t q_base = ((size_t)b * Tq + q0) * E + (size_t)h * D;
  const size_t kv_base = (size_t)b * Tk * E + (size_t)h * D;
  const __nv_bfloat16* bias_t =
      bias != nullptr ? bias + ((size_t)(bias_per_bh ? bh : h) * Tq + q0) * Tk : nullptr;

  // tile `it` of K, V, bias and mask into stage st (the mask by plain loads)
  auto load_tile = [&](int it, int st) {
    const int j0 = it * KT, n = min(KT, Tk - j0);
    stage_tile(ks + st * KT * ld, ld, k + kv_base + (size_t)j0 * E, E, n, KT, D, vec);
    stage_tile(vs + st * KT * ld, ld, v + kv_base + (size_t)j0 * E, E, n, KT, D, vec);
    if (bias_t != nullptr)
      stage_bias<KT>(bs + st * kRows * lb, lb, bias_t + j0, Tk, rows, n, bias_vec);
    if (threadIdx.x < KT)
      ms[st * KT + threadIdx.x] =
          threadIdx.x < n && (mask == nullptr || mask[(size_t)b * Tk + j0 + threadIdx.x] != 0);
  };

  // under causal, tiles whose first key lies past the block's last row are
  // above the diagonal: skipped, nothing of them is read
  const int k_end = causal ? min(Tk, q0 + kRows) : Tk;
  const int n_tiles = (k_end + KT - 1) / KT;
  stage_tile(qs, ld, q + q_base, E, rows, kRows, D, vec);
  load_tile(0, 0);
  cp_async_commit();

  const bool active = warp * 16 < rows;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;   // l: this thread's part
  float acc[DMAX / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, st ^ 1);       // overlaps this tile's products
      cp_async_wait_all_but_last();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int j0 = it * KT, n = min(KT, Tk - j0);
    // under causal a warp whose last row lies before the tile's first key sees none of it
    if (active && !(causal && j0 > q0 + warp * 16 + 15)) {
      const __nv_bfloat16* kst = ks + st * KT * ld;
      const __nv_bfloat16* vst = vs + st * KT * ld;
      const __nv_bfloat16* bst = bs + st * kRows * lb;
      const int8_t* mst = ms + st * KT;

      // S = q K^T
      float s[KT / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < DMAX; kk += 16) {
        if (kk < Dp) {
          uint32_t a[4];
          ldmatrix_x4(a, qs + (warp * 16 + lane % 16) * ld + kk + (lane / 16) * 8);
#pragma unroll
          for (int c = 0; c < KT / 16; ++c) {
            uint32_t bk[4];
            ldmatrix_x4(bk, kst + (c * 16 + (lane / 16) * 8 + lane % 8) * ld + kk +
                                ((lane / 8) % 2) * 8);
            mma_bf16(s[2 * c], a, bk[0], bk[1]);
            mma_bf16(s[2 * c + 1], a, bk[2], bk[3]);
          }
        }
      }

      // the keys of this thread's columns: bit 2 nt + e of `keep` for key
      // nt * 8 + 2 t + e, 0 where masked or past Tk
      uint32_t keep = 0;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        const uint32_t pair = *reinterpret_cast<const uint16_t*>(mst + nt * 8 + 2 * t);
        keep |= ((pair & 1u) | ((pair >> 7) & 2u)) << (2 * nt);
      }
      // scale, bias, mask (-1e9); keys past Tk -inf (out of the max and
      // sums); on tiles that cross a row's diagonal, -1e9 past it
      const bool ragged = n < KT;
      const bool diag = causal && j0 + KT - 1 > q0 + warp * 16;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        float2 ba = make_float2(0.f, 0.f), bb = ba;
        if (bias_t != nullptr) {
          ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bst + rl_a * lb + c));
          bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bst + rl_b * lb + c));
        }
        const float bv[4] = {ba.x, ba.y, bb.x, bb.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[nt][e], scale, bv[e]);
          if (!((keep >> (2 * nt + (e & 1))) & 1u)) x = kMaskValue;
          if (diag && j0 + c + (e & 1) > q0 + (e < 2 ? rl_a : rl_b)) x = kMaskValue;
          if (ragged && c + (e & 1) >= n) x = -INFINITY;
          s[nt][e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      // key j0 of every tile is in range, so the new maxima are finite;
      // exp(x - m) as exp2(x log2e - m log2e)
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f((m_a - mn_a) * kLog2e), al_b = exp2f((m_b - mn_b) * kLog2e);
      const float ml_a = mn_a * kLog2e, ml_b = mn_b * kLog2e;
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        s[nt][0] = exp2f(fmaf(s[nt][0], kLog2e, -ml_a));
        s[nt][1] = exp2f(fmaf(s[nt][1], kLog2e, -ml_a));
        s[nt][2] = exp2f(fmaf(s[nt][2], kLog2e, -ml_b));
        s[nt][3] = exp2f(fmaf(s[nt][3], kLog2e, -ml_b));
        sum_a += s[nt][0] + s[nt][1];
        sum_b += s[nt][2] + s[nt][3];
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int nt = 0; nt < DMAX / 8; ++nt) {
        acc[nt][0] *= al_a;
        acc[nt][1] *= al_a;
        acc[nt][2] *= al_b;
        acc[nt][3] *= al_b;
      }

      // O += round(p) V, p packed from the accumulators as A fragments
#pragma unroll
      for (int c = 0; c < KT / 16; ++c) {
        const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]), pack_bf16(s[2 * c][2], s[2 * c][3]),
                               pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                               pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
        const __nv_bfloat16* vp = vst + (c * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ld + (lane / 16) * 8;
#pragma unroll
        for (int dn = 0; dn < DMAX / 16; ++dn) {
          if (dn * 16 < Dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vp + dn * 16);
            mma_bf16(acc[2 * dn], a, bv[0], bv[1]);
            mma_bf16(acc[2 * dn + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();                   // every warp is done with this stage
  }

  if (!active) return;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int nt = 0; nt < DMAX / 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = half ? rl_b : rl_a;
      if (rl >= rows) continue;
      const float lc = half ? lc_b : lc_a;
      const float x = acc[nt][2 * half] / lc, y = acc[nt][2 * half + 1] / lc;
      __nv_bfloat16* o = out + q_base + (size_t)rl * E + d;
      if ((D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
      } else {
        o[0] = __float2bfloat16_rn(x);
        if (d + 1 < D) o[1] = __float2bfloat16_rn(y);
      }
      if (out32 != nullptr) {          // the output before rounding (the backward's dd)
        float* o32 = out32 + q_base + (size_t)rl * E + d;
        o32[0] = x;
        if (d + 1 < D) o32[1] = y;
      }
    }
  }
  if (t == 0) {
    if (rl_a < rows) lse[(size_t)bh * Tq + q0 + rl_a] = m_a + logf(lc_a);
    if (rl_b < rows) lse[(size_t)bh * Tq + q0 + rl_b] = m_b + logf(lc_b);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int DMAX, int KT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, void* out, void* out32, void* lse, int B, int H, int Tq,
                   int Tk, int D, int bias_per_bh, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(KT, D);
  auto kernel = flash_fwd_mma_kernel<DMAX, KT>;
  cudaError_t err = dense_mma::allow_smem_carveout(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const int bias_vec = bias != nullptr && Tk % 8 == 0 && aligned16(bias);
  // the samples of one (query tile, head) next to each other: a shared bias
  // tile is read once from HBM and then from L2
  const dim3 grid(B, (Tq + kRows - 1) / kRows, H);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const int8_t*>(mask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(out32), static_cast<float*>(lse), H, Tq, Tk, D, bias_per_bh, scale,
      causal, vec, bias_vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and out are bf16 (the kernel is built for bf16 only). bias is bf16
// (H, Tq, Tk) shared by the batch (bias_per_bh = 0) or (B * H, Tq, Tk)
// (bias_per_bh = 1), or null; mask is int8 (B, Tk) or null; out32 is fp32
// (B, Tq, E), the output before its rounding to bf16, or null; lse is fp32
// (B, H, Tq). `causal` needs Tq == Tk.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                   const void* mask, void* out, void* out32, void* lse, int B,
                                   int H, int Tq, int Tk, int D, int bias_per_bh, int causal,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > 256 || (causal && Tq != Tk))
    return (int)cudaErrorInvalidValue;
  // 64-key tiles at D <= 64; 32-key tiles above, where the output
  // accumulators take more registers (an A/B on one H100 at D = 88 and 128:
  // 0.057 vs 0.097 and 0.058 vs 0.091 ms)
  cudaError_t err;
  if (D <= 64)
    err = launch<64, 64>(q, k, v, bias, mask, out, out32, lse, B, H, Tq, Tk, D, bias_per_bh, scale,
                         causal, s);
  else if (D <= 128)
    err = launch<128, 32>(q, k, v, bias, mask, out, out32, lse, B, H, Tq, Tk, D, bias_per_bh, scale,
                          causal, s);
  else
    err = launch<256, 32>(q, k, v, bias, mask, out, out32, lse, B, H, Tq, Tk, D, bias_per_bh, scale,
                          causal, s);
  return (int)err;
}
