// Tensor-core building blocks shared by the bf16 dense-attention kernels
// (dense_attention_fwd.cu, B1; dense_attention_bwd.cu, B2) and the int8
// GEMM (int8_matmul.cu, B7). Hopper (sm_90a).
//
// Products use mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: A is a
// 16 x 16 bf16 tile (4 registers), B a 16 x 8 bf16 tile (2 registers), C a
// 16 x 8 fp32 tile (4 registers). With g = lane / 4 and t = lane % 4:
//   A: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B: b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C: c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// so two neighbouring C tiles (columns 0-7 and 8-15) are, rounded to bf16,
// the A tile of the next product whose k runs over those 16 columns.
// Operands are staged in shared memory as bf16 with a row stride of
// (a multiple of 16) + 8 elements: the 8 rows an ldmatrix reads then fall in
// 8 distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dense_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b (registers only: not volatile, so the compiler may schedule it)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on the int8 tensor cores:
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. The fragments hold the
// same bytes as m16n8k16 bf16's (A 16 x 32 bytes, B 32 x 8 bytes, C 16 x 8
// int32 at the fp32 positions), so the b16 ldmatrix loads them unchanged.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two 8 x 8 b16 matrices; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// two fp32 values rounded to bf16 and packed, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 16 bytes when `full`, else 16 zero bytes and nothing read (src-size 0)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait for this thread's copies but those of its last committed group
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
}

// wait for every copy this thread issued
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Let `kernel` take `bytes` of dynamic shared memory, and ask for the whole
// 228 KB carve-out of the SM so that as many blocks fit as the bytes allow.
template <typename K>
cudaError_t allow_smem_carveout(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

// Stage rows [0, n) of one head's slice of a (rows, E) bf16 matrix, from
// src (the slice's first element), into dst (n_pad rows of stride ld):
// columns [0, D) copied, columns [D, Dp) and rows [n, n_pad) zero, with
// Dp = round_up(D, 16). `vec` says that 16-byte copies are aligned (D, E
// and the base a multiple of 8 elements): then cp.async, else plain loads.
// The caller waits (cp_async_wait_all) and synchronises.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* __restrict__ src, size_t stride,
                                           int n, int n_pad, int D, int vec) {
  const int Dp = round_up(D, 16);
  if (vec) {
    const int cpr = Dp / 8;                       // 16-byte chunks per row
    for (int i = threadIdx.x; i < n_pad * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      __nv_bfloat16* d = dst + r * ld + c;
      if (r < n && c < D)
        cp_async16(d, src + (size_t)r * stride + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < n_pad * Dp; i += blockDim.x) {
      const int r = i / Dp, c = i - r * Dp;
      dst[r * ld + c] = (r < n && c < D) ? src[(size_t)r * stride + c] : zero;
    }
  }
}

}  // namespace dense_mma
