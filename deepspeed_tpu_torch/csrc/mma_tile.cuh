// The tensor-core tile shared by the port's attention kernels on Hopper
// (sm_90a): cp.async staging and mma.sync m16n8k16 bf16 products whose
// operands are read from shared memory with ldmatrix.
//
// Included by csrc/paged_attention.cu (K3, paged_attention_tc_kernel),
// csrc/flash_attention.cu (K1 flash_fwd_kernel_tc, K2a flash_dq_kernel_tc,
// K2b flash_dkv_kernel_tc) and csrc/sparse_attention.cu (K6a
// sparse_fwd_kernel_tc, K6b sparse_dq_kernel_tc, K6c sparse_dkv_kernel_tc;
// the float32 kernels take its cp.async helpers).
// phase 2 of chip_smoke.py holds one product through these loaders against
// torch.matmul (mma_probe_kernel in paged_attention.cu).
//
// The three loaders cover every operand the attention products take, with
// rows padded by 16 bytes in shared memory so that ldmatrix's eight row
// reads of one matrix hit distinct banks:
//   load_a_frag   A of a product, rows of a row-major tile (Q, K, V rows);
//   load_k_frags  B of a product "against rows": C = A·Rᵀ, R row-major
//                 [n][depth] (K for Q·Kᵀ, V for dO·Vᵀ, Q for K·Qᵀ, dO for
//                 V·dOᵀ);
//   load_v_frags  B of a product "times rows": C = A·R, R row-major
//                 [depth][n] (V for P·V, K for dS·K, dO for Pᵀ·dO, Q for
//                 dSᵀ·Q).
// A C fragment of S blocks 2j and 2j + 1 (columns 16j..16j+15) becomes the
// A fragment of a product of depth 16 by pack_bf16, with no shared memory:
//   a[0] = pack(c_2j[0], c_2j[1])   a[1] = pack(c_2j[2], c_2j[3])
//   a[2] = pack(c_2j+1[0], c_2j+1[1])   a[3] = pack(c_2j+1[2], c_2j+1[3]).

#pragma once

#include <cuda_bf16.h>

namespace ds_tile {

using bf16 = __nv_bfloat16;

// global -> shared, 16 bytes; pred false fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}
// global -> shared, 4 bytes (a float32 row statistic); pred false writes a zero
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds row l/4, columns 2(l%4), 2(l%4)+1 of it
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// the same, each matrix transposed: register i of lane l holds rows
// 2(l%4), 2(l%4)+1 of column l/4
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c[16x8] += a[16x16] · b[16x8], bf16 in, f32 accumulate.  Fragments (g =
// lane / 4, t = lane % 4): a = {(g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8,
// 2t+8..)}, b = {(k 2t.., n g), (k 2t+8.., n g)}, c = {(g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A fragment of rows 0..15, columns 0..15 of a row-major tile at p (row stride ld)
__device__ __forceinline__ void load_a_frag(unsigned (&a)[4], const bf16* p, int ld, int lane) {
  ldsm_x4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}
// B fragments of S = A·Kᵀ for keys 0..7 (r[0], r[1]) and 8..15 (r[2], r[3]),
// depth 0..15, from K rows [key][depth] at p
__device__ __forceinline__ void load_k_frags(unsigned (&r)[4], const bf16* p, int ld, int lane) {
  ldsm_x4(r, p + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);
}
// B fragments of O = P·V for columns 0..7 (r[0], r[1]) and 8..15 (r[2], r[3]),
// keys 0..15, from V rows [key][column] at p
__device__ __forceinline__ void load_v_frags(unsigned (&r)[4], const bf16* p, int ld, int lane) {
  ldsm_x4_trans(r, p + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8);
}

}  // namespace ds_tile
