// Flash attention backward for long sequences, Hopper (sm_90a): one bf16
// tensor-core pass for the whole backward, one C entry point.
//
// Replaces the three Pallas TPU kernels that `_flash_backward` and
// `_shared_dbias` of ofasys_tpu/ops/pallas_attention.py launch:
//   `_flash_bwd_dq_kernel`    (kernel B4-dq: dq, and ds for a per-(b, h) bias)
//   `_flash_bwd_dkv_kernel`   (kernel B4-dkv: dk, dv)
//   `_flash_bwd_dbias_kernel` (kernel B5: the gradient of a bias shared by the batch)
// Same function. For every sample b, head h, query row i and key j, what
// `_recompute_p` and the three kernels compute:
//   s_ij  = (q_i . k_j) * scale + bias_ij, -1e9 where mask[b, j] == 0 and
//           where j > i under `causal`            (fp32)
//   p_ij  = exp(s_ij - lse_i)                     (lse from the forward, B3)
//   dp_ij = do_i . v_j                            (fp32)
//   ds_ij = p_ij (dp_ij - dd_i)                   (fp32)
// with dd_i = rowsum(do_i * o_i) (minus the lse cotangent) computed by the
// caller and passed in, as `_flash_backward` does; p and ds are 0 outside
// the (Tq, Tk) extent. Then
//   dv_j = sum_i round(p_ij) do_i,   dk_j = scale * sum_i round(ds_ij) q_i,
//   dq_i = scale * sum_j round(ds_ij) k_j,
// and the bias gradient: for a bias (H, Tq, Tk) shared by the batch
// dbias[h] = sum_b ds (fp32, unrounded), for a bias (B H, Tq, Tk), one per
// (b, h), ds itself (fp32; a batch of one counts as per-(b, h)); 0 on the
// entries that causal skips. round() is to bf16, every sum fp32. q, do, dq
// are (B, Tq, E), k, v, dk, dv (B, Tk, E) with E = H * D (heads sliced
// here); lse and dd fp32 (B, H, Tq); mask int8 (B, 1, Tk). `causal` needs
// Tq == Tk (start-aligned).
//
// What bounds it on the H100: at the gigaword_long encoder shape B = 16,
// T = 1000, H = 12, D = 64 with a shared bias it must move about 246 MB
// (read q, k, v, do, lse, dd, bias, mask; write dq, dk, dv, dbias), 0.073
// ms at 3.35 TB/s, and do 123 GFLOP (five (Tq, Tk, D) products: q.k, do.v,
// p.do, ds.q, ds.k; 10 B H Tq Tk D), 0.124 ms at 989 TFLOP/s: bound by
// operations. The three CUDA-core kernels this replaces did nine products.
//
// Design: the kernel of B2 (dense_attention_bwd_mma.cuh, whose header holds
// the whole design) with kFlash set: one block of 8 warps per (range of at
// most 240 keys at D = 64, head, chunk of samples), mma.sync m16n8k16 for
// all five products, fp32 dK/dV sums of the range in shared memory, ds
// rounded before the scale as the reference does, dd read and not formed.
// Every flash call splits its keys into ranges (Tk >= 256), so each range
// writes an fp32 dq partial and a reduction kernel sums them in range order
// and applies the scale; a shared bias's gradient goes through per-chunk
// partials summed in chunk order (none with one chunk). The caller plans
// the launch (ofasys_torch/ops/flash_attention.py, `backward_plan`): the
// key range, the chunks, and, where the fp32 scratch would pass its cap,
// groups of samples (and, for one long sample, groups of ranges whose dq
// sum is carried in an fp32 accumulator), launched one after the other on
// the stream, so scratch stays bounded at long T. No atomics: the same bits
// run to run.
//
// C interface, loaded with ctypes; returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan the kernel cannot take) so the caller
// can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dense_attention_bwd_mma.cuh"

namespace {

using dense_bwd_mma::bwd_mma_kernel;

template <bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* dd, const void* bias, const void* mask, void* dq, void* dk,
                   void* dv, void* dbias, void* dbias_part, void* dq_part, int B, int H, int Tq,
                   int Tk, int D, int bias_per_bh, int KR, int chunks, int group_samples,
                   int group_ranges, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int ranges = (Tk + KR - 1) / KR;
  if (group_ranges > ranges || (ranges > 1 && dq_part == nullptr)) return cudaErrorInvalidValue;
  const bool want_dbias = dbias != nullptr && bias != nullptr;
  const bool shared = want_dbias && !bias_per_bh;
  const int per_chunk = (group_samples + chunks - 1) / chunks;
  chunks = (group_samples + per_chunk - 1) / per_chunk;      // no empty chunk
  if (shared && chunks > 1 && dbias_part == nullptr) return cudaErrorInvalidValue;
  float* part = nullptr;
  if (want_dbias) part = static_cast<float*>(shared && chunks > 1 ? dbias_part : dbias);

  auto kernel = bwd_mma_kernel<kCausal, true>;
  const size_t smem = dense_bwd_mma::smem_bytes(KR, D);
  cudaError_t err = dense_mma::allow_smem_carveout(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && dense_bwd_mma::aligned16(q) && dense_bwd_mma::aligned16(k) &&
                  dense_bwd_mma::aligned16(v) && dense_bwd_mma::aligned16(dout);
  const size_t E = (size_t)H * D, qn = (size_t)Tq * E, kn = (size_t)Tk * E;
  const size_t rows = (size_t)H * Tq, bias_n = (size_t)Tq * Tk;
  float* parts = static_cast<float*>(dq_part);
  // the fp32 dq sum of the ranges so far, after the slots, when the ranges
  // come in groups
  float* acc = group_ranges < ranges ? parts + (size_t)group_ranges * group_samples * qn : nullptr;
  const int threads = 256;

  for (int s0 = 0; s0 < B; s0 += group_samples) {
    const int nb = std::min(group_samples, B - s0);
    const int nchunks = (nb + per_chunk - 1) / per_chunk;
    const bf16* bias_s = static_cast<const bf16*>(bias);
    if (bias_s != nullptr && bias_per_bh) bias_s += (size_t)s0 * H * bias_n;
    float* part_s = part;
    if (part_s != nullptr && bias_per_bh) part_s += (size_t)s0 * H * bias_n;
    bf16* dq_s = static_cast<bf16*>(dq) + s0 * qn;
    for (int r0 = 0; r0 < ranges; r0 += group_ranges) {
      const int nr = std::min(group_ranges, ranges - r0);
      kernel<<<dim3(nr, H, nchunks), dense_bwd_mma::kMmaWarps * 32, smem, stream>>>(
          static_cast<const bf16*>(q) + s0 * qn, static_cast<const bf16*>(k) + s0 * kn,
          static_cast<const bf16*>(v) + s0 * kn, static_cast<const bf16*>(dout) + s0 * qn,
          static_cast<const float*>(lse) + s0 * rows, static_cast<const float*>(dd) + s0 * rows,
          bias_s, mask == nullptr ? nullptr : static_cast<const int8_t*>(mask) + (size_t)s0 * Tk,
          dq_s, ranges > 1 ? parts : nullptr, static_cast<bf16*>(dk) + s0 * kn,
          static_cast<bf16*>(dv) + s0 * kn, part_s, nb, H, Tq, Tk, D, KR, r0, per_chunk, scale,
          vec, 0, bias_per_bh, shared && s0 > 0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      if (ranges > 1) {
        const size_t n = (size_t)nb * qn;
        const bool last = r0 + nr == ranges;
        const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 4096);
        dense_bwd_mma::dq_reduce_kernel<<<blocks, threads, 0, stream>>>(
            parts, acc, last ? dq_s : nullptr, n, nr, scale, r0 > 0);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
    }
  }
  if (shared && chunks > 1) {
    const size_t n = (size_t)H * bias_n;
    const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 4096);
    dense_bwd_mma::dbias_reduce_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(dbias_part), static_cast<float*>(dbias), n, chunks);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// The largest key range the kernel takes at (Tk, D): Tk, or the largest
// multiple of 16 whose fp32 dK/dV sums fit a block's shared memory. The
// caller's plan picks a range no larger (ops/flash_attention.py mirrors
// the rule; a card test holds the two equal).
extern "C" int flash_attention_bwd_max_key_range(int Tk, int D) {
  return dense_bwd_mma::key_range(Tk, D);
}

// q, k, v, dout, dq, dk, dv bf16; lse and dd fp32 (B, H, Tq); bias bf16
// (H, Tq, Tk) shared by the batch (bias_per_bh = 0) or (B * H, Tq, Tk)
// (bias_per_bh = 1), or null; mask int8 (B, 1, Tk) or null. dbias, when not
// null (and a bias is given), is fp32 and shaped as the bias. The plan:
// key_range keys per block (a multiple of 16, or Tk, at most
// flash_attention_bwd_max_key_range), `chunks` chunks of each group of
// group_samples samples, group_ranges ranges per launch. Scratch from the
// caller: dbias_part fp32 (chunks, H, Tq, Tk) for a shared bias's gradient
// when chunks > 1; dq_part fp32 (group_ranges + (group_ranges < ranges)) *
// group_samples * Tq * E when there are several ranges.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* dd, const void* bias,
                                   const void* mask, void* dq, void* dk, void* dv, void* dbias,
                                   void* dbias_part, void* dq_part, int B, int H, int Tq, int Tk,
                                   int D, int bias_per_bh, int causal, int key_range, int chunks,
                                   int group_samples, int group_ranges, float scale,
                                   void* stream) {
  const int max_range = dense_bwd_mma::key_range(Tk, D);
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > 256 || (causal && Tq != Tk) ||
      max_range == 0 || key_range < 1 || key_range > max_range ||
      (key_range % 16 != 0 && key_range < Tk) || chunks < 1 || group_samples < 1 ||
      group_samples > B || chunks > group_samples || group_ranges < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      causal ? launch<true>(q, k, v, dout, lse, dd, bias, mask, dq, dk, dv, dbias, dbias_part,
                            dq_part, B, H, Tq, Tk, D, bias_per_bh, key_range, chunks,
                            group_samples, group_ranges, scale, s)
             : launch<false>(q, k, v, dout, lse, dd, bias, mask, dq, dk, dv, dbias, dbias_part,
                             dq_part, B, H, Tq, Tk, D, bias_per_bh, key_range, chunks,
                             group_samples, group_ranges, scale, s);
  return (int)err;
}
