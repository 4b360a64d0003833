// bf16 products on the tensor cores: the mma.sync primitives of the
// GEMM tile's bf16 form (gemm_tile.cuh: K6 under AMP), and the rounding
// and hi + lo split that the wgmma kernels' bf16 forms take too
// (wgmma_gemm.cuh: K4; flash_bf16.cuh: K1, K9; flash_bwd.cu: K2, K3).
//
// mma.sync.m16n8k16.bf16 multiplies bf16 operands exactly (an 8-bit
// by 8-bit significand product fits float32) and sums into float32
// fragments, whose layout is the m16n8k8 one: element e of a thread's C
// fragment holds row g + 8 (e / 2), column 2t + e % 2 (g = lane / 4,
// t = lane % 4).  An A fragment packs two k a register: a0 row g, k 2t
// and 2t + 1 (the lower k in the low 16 bits), a1 row g + 8, a2 and a3
// the same at k + 8; a B fragment b0 holds k 2t, 2t + 1 of column g,
// b1 the same at k + 8.  So two adjacent n8 C fragments of one row
// block are exactly one k16 A fragment of the next product: a float32
// tile computed in C layout (the flash kernels' P and dS) goes into a
// product without a shuffle.
//
// An f32 operand that must keep more than bf16's 8 bits (P, dS) is
// split: hi = x rounded to bf16, lo = (x - hi) rounded to bf16, each
// multiplied exactly, so hi*b + lo*b keeps x to 2^-17 relative, where
// one bf16 rounding keeps 2^-9.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 matrices of 16-bit elements from shared memory; lanes 8 i
// .. 8 i + 7 give the row addresses of matrix i, and register i of lane
// l holds elements 2 (l % 4), + 1 of row l / 4 of matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// the same, each matrix transposed: register i of lane l holds elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of matrix i
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// two floats rounded to bf16 (to nearest), x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) = hi + lo, both packed bf16 pairs: hi rounded to nearest,
// lo the rest rounded to nearest
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

}  // namespace tc
