// The bf16 tensor-core attention backward shared by kernel B2
// (dense_attention_bwd.cu), kernel B2r (dense_attention_bwd_rowmajor.cu) and
// the flash backward B4-dq + B4-dkv + B5 (flash_attention_bwd.cu), Hopper
// (sm_90a). Two template flags tell them apart: kCausal applies the causal
// mask (key j > i + (Tk - Tq) gets -1e9) inside the kernel, as the row-major
// Pallas kernel `_bwd_kernel` does, and skips every (query tile, key tile)
// pair that lies wholly above the diagonal; kFlash computes the flash
// backward's function. B2 is the <false, false> instance; B2r takes both
// kCausal; the flash backward <false, true> and <true, true>.
//
// For every sample b, head h, query row i and key j (see the sources'
// headers for the whole function):
//   s = (q_i . k_j) * scale + bias[h, i, j]; -1e9 where masked (or, under
//   kCausal, past the diagonal); p = exp(s - lse_i); dp = do_i . v_j;
//   ds = p (dp - dd_i); dv = round(p)^T do; and
//   * B2, B2r: dd_i = sum_j dp p; dbias = sum_b ds (fp32, before the scale);
//     dq = round(ds * scale) k, dk = round(ds * scale)^T q;
//   * kFlash: dd comes in (rowsum(do o) minus the lse cotangent, formed by
//     the caller as `_flash_backward` does); dq = scale (round(ds) k) and
//     dk = scale (round(ds)^T q), rounded before the scale as the flash
//     reference does; the bias gradient is sum_b ds for a bias shared by the
//     batch, or ds itself (fp32, B H, Tq, Tk) for a bias per (b, h)
//     (`bias_per_bh`, which also reads bias[b H + h]).
//
// Design: one block of 8 warps per (range of keys, head, chunk of samples)
// walks its samples in order. For each sample it copies the range's K and V
// rows into shared memory as bf16 (16-byte cp.async, a head dim that is no
// multiple of 16 zero-filled), keeps fp32 dK and dV sums of the range in
// shared memory, and walks the query rows 32 at a time:
//   * q, do (bf16), lse (and, kFlash, dd) of the 32 rows into shared
//     memory, and the bias of the keys the rows see (kFlash: in 16-byte
//     copies where Tk % 8 == 0);
//   * each warp takes up to two 16-key tiles and computes S^T = K q^T and
//     dP^T = V do^T (keys as rows) on the tensor cores (mma.sync m16n8k16
//     fed by ldmatrix, see dense_mma.cuh), p = exp(S^T * scale + bias - lse)
//     in fp32 registers (0 on padded keys and rows), and (not kFlash) its
//     part of the row sums dd = sum_j dp p; the parts of the 8 warps are
//     summed in shared memory in warp order;
//   * ds = p (dp - dd) in fp32 goes into the bias gradient (device memory,
//     L2: for a shared bias the chunk's partial, where the first sample of
//     the chunk stores and the rest add, one thread owning each element; for
//     a bias per (b, h) every sample stores its own); round(p) and
//     round(ds * scale) (kFlash: round(ds)), still in registers, are the A
//     fragments of dV += round(p)^T do and dK += round(ds ...)^T q, added
//     into the shared-memory sums;
//   * round(ds ...)^T goes to shared memory, and dQ = round(ds ...) K over
//     the range's keys is finished by the block and stored once.
// Under kCausal a 16-key tile past the last row's diagonal of the 32 rows is
// neither computed nor read (its p and ds are exactly 0, as in the
// reference): its warp skips the products, its bias is not copied, dQ stops
// at the last visible tile, and only its bias gradient is stored, as 0, by
// the first sample of the chunk. Only tiles that cross a row's diagonal mask
// element by element.
// A range holds every key (Tk <= 256) unless the block's shared memory
// needs several (D = 64 from Tk = 241, D = 88 from 161, D = 128 from 129,
// D = 256 from 49; the model's shapes at D = 64 stay whole in B2): then each
// range writes an fp32 dq partial and a reduction kernel sums the partials
// in range order. B2 and B2r form dd, a sum over every key, in a first pass
// that writes each range's part of it (S^T and dP^T only); the second pass
// sums the parts in range order. A last kernel sums the chunks' dbias
// partials in chunk order (none with one chunk: the block writes dbias). No
// atomics: the same bits run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "dense_mma.cuh"

namespace dense_bwd_mma {

constexpr int kMmaWarps = 8;
constexpr int kQTile = 32;                     // query rows per step
constexpr int kKeyTiles = 2;                   // 16-key tiles per warp, at most
constexpr int kMaxRange = kMmaWarps * kKeyTiles * 16;   // 256 keys per block
constexpr int kLds = kQTile + 8;               // row stride of the ds^T tile
constexpr size_t kMaxSmem = 232448;            // 227 KB, the opt-in limit of a block
constexpr float kMaskValue = -1e9f;

// dbias = the chunk partials summed in chunk order
__global__ void dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                    size_t n, int chunks) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[(size_t)c * n + i];
    dbias[i] = s;
  }
}

// shared memory of a block whose range holds KR keys
inline size_t smem_bytes(int KR, int D) {
  using dense_mma::round_up;
  const size_t krp = round_up(KR, 16), ld = round_up(D, 16) + 8, dacc = round_up(D, 32);
  return 2 * (2 * krp * ld + 2 * (size_t)kQTile * ld + krp * kLds) + 4 * (2 * krp * dacc) +
         4 * (size_t)(2 + kMmaWarps) * kQTile + krp;
}

// keys per range: all Tk when a block's sums fit, else the largest multiple
// of 16 that fits (0 if none)
inline int key_range(int Tk, int D) {
  for (int KR = std::min(dense_mma::round_up(Tk, 16), kMaxRange); KR > 0; KR -= 16)
    if (smem_bytes(KR, D) <= kMaxSmem) return std::min(KR, Tk);
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

template <bool kCausal, bool kFlash>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dd_in,
               const __nv_bfloat16* __restrict__ bias, const int8_t* __restrict__ mask,
               __nv_bfloat16* __restrict__ dq, float* __restrict__ dq_part,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ dbias_part, int B, int H, int Tq, int Tk, int D, int KR,
               int split0, int per_chunk, float scale, int vec, int pass, int bias_per_bh,
               int dbias_add) {
  // pass 0: every key in one range, or (kFlash) the ranges split0 +
  // blockIdx.x, each writing its dq partial into slot blockIdx.x of dq_part.
  // Not kFlash, with several ranges, pass 1 only writes each range's part of
  // dd (dd_part, after the dq partials in dq_part) and pass 2 does the rest
  // with dd = the parts summed in range order. kFlash reads dd from dd_in.
  // dbias_part is the bias gradient's destination: the chunks' partials of a
  // shared bias (dbias_add: the first sample of a chunk adds as well, for a
  // later group of samples), or the per-(b, h) ds (bias_per_bh).
  using namespace dense_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = H * D, Dp = round_up(D, 16), ld = Dp + 8, Dacc = round_up(D, 32);
  const int slot = blockIdx.x, split = split0 + slot, h = blockIdx.y, chunk = blockIdx.z;
  const int j0 = split * KR, nk = min(KR, Tk - j0), nkp = round_up(nk, 16), nmt = nkp / 16;
  const int KRp = round_up(KR, 16);
  const int off = Tk - Tq;                       // the causal diagonal's offset
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

  const int b_begin = chunk * per_chunk, b_end = min(B, b_begin + per_chunk);
  for (int b = b_begin; b < b_end; ++b) {
    const size_t kv_base = ((size_t)b * Tk + j0) * E + (size_t)h * D;
    // this sample's bias matrix and bias-gradient destination; `first`: it
    // stores (the rest add)
    const size_t bh = bias_per_bh ? (size_t)b * H + h : (size_t)chunk * H + h;
    float* part = dbias_part == nullptr ? nullptr : dbias_part + bh * Tq * Tk;
    const __nv_bfloat16* bias_b =
        bias == nullptr ? nullptr : bias + (bias_per_bh ? bh : (size_t)h) * Tq * Tk;
    const bool first = bias_per_bh || (b == b_begin && !dbias_add);
    __syncthreads();                      // the previous sample's dk, dv are stored
    stage_tile(ks, ld, k + kv_base, E, nk, nkp, D, vec);
    stage_tile(vs, ld, v + kv_base, E, nk, nkp, D, vec);
    for (int i = threadIdx.x; i < 2 * KRp * Dacc; i += blockDim.x) dka[i] = 0.f;
    for (int j = threadIdx.x; j < nkp; j += blockDim.x)
      ms[j] = j < nk && (mask == nullptr || mask[(size_t)b * Tk + j0 + j] != 0);

    for (int i0 = 0; i0 < Tq; i0 += kQTile) {
      const int rows = min(kQTile, Tq - i0);
      // keys of the range that some row of the tile sees: all, or (kCausal)
      // up to the last row's diagonal; 16-key tiles past them are skipped
      const int nvis = kCausal ? max(0, min(nk, i0 + rows + off - j0)) : nk;
      const int nmv = kCausal ? round_up(nvis, 16) / 16 : nmt;
      const size_t q_base = ((size_t)b * Tq + i0) * E + (size_t)h * D;
      __syncthreads();                    // the previous tile is done with qs, dos, dst
      stage_tile(qs, ld, q + q_base, E, rows, kQTile, D, vec);
      stage_tile(dos, ld, dout + q_base, E, rows, kQTile, D, vec);
      if (threadIdx.x < kQTile) {
        const size_t row = ((size_t)b * H + h) * Tq + i0 + threadIdx.x;
        lse_s[threadIdx.x] = threadIdx.x < rows ? lse[row] : 0.f;
        if (kFlash) dd_s[threadIdx.x] = threadIdx.x < rows ? dd_in[row] : 0.f;
      }
      if (kFlash && bias_b != nullptr && Tk % 8 == 0 &&
          reinterpret_cast<uintptr_t>(bias_b) % 16 == 0) {
        // 16-byte copies: every row of the range starts on 8 elements (j0 is a
        // multiple of 16), and a last chunk past nvis stays inside the row
        const int nc = (nvis + 7) / 8;
        for (int i = threadIdx.x; i < rows * nc; i += blockDim.x) {
          const int r = i / nc, c = (i - r * nc) * 8;
          cp_async16(bs + r * KRp + c, bias_b + (size_t)(i0 + r) * Tk + j0 + c);
        }
      } else if (bias_b != nullptr) {     // 4-byte copies where they are aligned
        const bool pairs = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(bias_b) % 4 == 0;
        const int np = (nvis + 1) / 2;
        for (int i = threadIdx.x; i < rows * np; i += blockDim.x) {
          const int r = i / np, c = (i - r * np) * 2;
          const __nv_bfloat16* src = bias_b + (size_t)(i0 + r) * Tk + j0 + c;
          if (pairs) {
            cp_async4(bs + r * KRp + c, src);
          } else {
            bs[r * KRp + c] = src[0];
            if (c + 1 < nvis) bs[r * KRp + c + 1] = src[1];
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
        if (mt >= nmv) continue;
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

      // p in fp32 (0 on padded keys and rows) and (not kFlash) this warp's
      // part of dd
      float ddc[4][2] = {};
#pragma unroll
      for (int m = 0; m < kKeyTiles; ++m) {
        const int mt = warp + m * kMmaWarps;
        if (mt >= nmv) continue;
        // under kCausal, whether some key of the tile lies past some row's diagonal
        const bool diag = kCausal && j0 + mt * 16 + 15 > i0 + off;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jl = mt * 16 + g + (e >= 2 ? 8 : 0), il = nt * 8 + 2 * t + (e & 1);
            float p = 0.f;
            if (jl < nk && il < rows) {
              float s = st[m][nt][e] * scale;
              if (bias_b != nullptr) s += __bfloat162float(bs[il * KRp + jl]);
              if (!ms[jl]) s = kMaskValue;
              if (diag && j0 + jl > i0 + il + off) s = kMaskValue;
              p = __expf(s - lse_s[il]);
            }
            st[m][nt][e] = p;
            if constexpr (!kFlash) ddc[nt][e & 1] = fmaf(dpt[m][nt][e], p, ddc[nt][e & 1]);
          }
      }
      if constexpr (!kFlash) {
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
      } else {
        __syncthreads();                  // every warp is done with the bias tile in dst
      }

      // ds, the dbias partial, and dV, dK of this warp's key tiles
#pragma unroll
      for (int m = 0; m < kKeyTiles; ++m) {
        const int mt = warp + m * kMmaWarps;
        if (mt >= nmt) continue;
        if (kCausal && mt >= nmv) {       // past the diagonal: ds = 0
          if (part != nullptr && first) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int jl = mt * 16 + g + (e >= 2 ? 8 : 0), il = nt * 8 + 2 * t + (e & 1);
                if (jl < nk && il < rows) part[(size_t)(i0 + il) * Tk + j0 + jl] = 0.f;
              }
          }
          continue;
        }
        // the partial sums so far, all loads issued before the first store
        float old[4][4] = {};
        if (part != nullptr && !first) {
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
              part[(size_t)(i0 + il) * Tk + j0 + jl] = first ? ds : old[nt][e] + ds;
            if constexpr (kFlash)
              dpt[m][nt][e] = ds;
            else
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
            const int off2 = (kq * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ld + dn + (lane / 16) * 8;
            ldmatrix_x4_trans(bo[kq], dos + off2);
            ldmatrix_x4_trans(bq[kq], qs + off2);
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

      // dQ = round(ds * scale) K over the range's visible key tiles: 2 row
      // tiles x Dp / 16 column pairs
      const int mq = warp & 1;
      for (int dn = (warp >> 1) * 16; dn < Dp; dn += (kMmaWarps / 2) * 16) {
        float acc[2][4] = {};
        for (int kt = 0; kt < nmv; ++kt) {
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
              float* pp = dq_part + (size_t)slot * B * Tq * E + o;
              pp[0] = x;
              if (d + 1 < D) pp[1] = y;
            } else if constexpr (kFlash) {
              store_pair(dq + o, x * scale, y * scale, d, D);
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
      float2 x = *acc_at(dka, Dacc, r, c);
      const float2 y = *acc_at(dva, Dacc, r, c);
      if constexpr (kFlash) x = make_float2(x.x * scale, x.y * scale);
      store_pair(dk + kv_base + (size_t)r * E + c, x.x, x.y, c, D);
      store_pair(dv + kv_base + (size_t)r * E + c, y.x, y.y, c, D);
    }
  }
}

// dq = the range partials summed in range order after acc (the sum of the
// earlier ranges) where acc_in, times scale, rounded once; or, with dq
// null, that sum stored back into acc (more ranges follow)
__global__ void dq_reduce_kernel(const float* __restrict__ part, float* __restrict__ acc,
                                 __nv_bfloat16* __restrict__ dq, size_t n, int splits,
                                 float scale, int acc_in) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = acc_in ? acc[i] : 0.f;
    for (int c = 0; c < splits; ++c) s += part[(size_t)c * n + i];
    if (dq != nullptr)
      dq[i] = __float2bfloat16_rn(s * scale);
    else
      acc[i] = s;
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The whole bf16 backward of B2 and B2r: the kernel (one pass, or the dd
// pre-pass and the main pass over key ranges), then the reductions of the dq range partials
// and of the dbias chunk partials where they were split. Scratch from the
// caller: dbias_part fp32 (chunks, H, Tq, Tk) when dbias is wanted and
// chunks > 1; dq_part fp32 (ranges * (B * Tq * E + B * H * Tq)) when
// key_range(Tk, D) < Tk. Under kCausal, Tq <= Tk.
template <bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* bias, const void* mask, void* dq, void* dk, void* dv, void* dbias,
                   void* dbias_part, void* dq_part, int B, int H, int Tq, int Tk, int D,
                   int chunks, float scale, cudaStream_t stream) {
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

  const size_t smem = smem_bytes(KR, D);
  cudaError_t err = dense_mma::allow_smem_carveout(bwd_mma_kernel<kCausal, false>, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  const dim3 grid(splits, H, chunks);
  for (int pass = splits > 1 ? 1 : 0; pass <= (splits > 1 ? 2 : 0); ++pass) {
    bwd_mma_kernel<kCausal, false><<<grid, kMmaWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), nullptr, static_cast<const __nv_bfloat16*>(bias),
        static_cast<const int8_t*>(mask), static_cast<__nv_bfloat16*>(dq),
        splits > 1 ? static_cast<float*>(dq_part) : nullptr, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), pass == 1 ? nullptr : part, B, H, Tq, Tk, D, KR, 0,
        per_chunk, scale, vec, pass, 0, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int threads = 256;
  if (splits > 1) {
    const size_t n = (size_t)B * Tq * H * D;
    const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 4096);
    dq_reduce_kernel<<<blocks, threads, 0, stream>>>(static_cast<const float*>(dq_part), nullptr,
                                                     static_cast<__nv_bfloat16*>(dq), n, splits,
                                                     1.f, 0);
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

}  // namespace dense_bwd_mma
