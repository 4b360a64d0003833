// Split-TF32 products on the tensor cores, and the cp.async copies that
// feed them: the primitives shared by the flash tile loop
// (flash_tile.cuh: K1, K9; flash_bwd.cu: K2, K3) and the GEMM tile
// (gemm_tile.cuh: K4, K8).
//
// Split-TF32: an operand x is split into hi = x rounded to TF32 and
// lo = x - hi, and a product is lo*hi + hi*lo + hi*hi on
// mma.sync.m16n8k8.tf32 with float32 accumulation; what is lost, lo*lo
// and lo's bits past TF32, is ~2^-21 relative, so the products keep
// float32's accuracy, where single-pass TF32 keeps ~2^-11.  An operand
// exact in TF32 (an int8 weight) has lo = 0: two MMAs a product.
//
// The tensor cores' float32 accumulation truncates to the
// accumulator's magnitude, so a long sum loses a bit of the running
// total at every MMA.  The callers keep each run of MMAs short (a fresh
// fragment, or one accumulator per term of the split) and add the runs
// with float32 adds, which round to nearest.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo exactly, hi = x rounded to TF32; the MMA reads lo's top
// 11 significant bits (it ignores a TF32 operand's low 13), so the
// split keeps x to 2^-21 relative for two instructions
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split-TF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

template <int NJ>
__device__ __forceinline__ void zero(float (&c)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// 16 bytes global -> shared, zero-filled when !ok (src must still be a
// valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// 8 bytes global -> shared, zero-filled when !ok (rows with 8-byte
// alignment only)
__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(s), "l"(src), "r"(ok ? 8 : 0) : "memory");
}

// 4 bytes global -> shared, zero-filled when !ok (rows with no 16-byte
// alignment)
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The SM count of the card that launches first, queried once.  It
// only picks a tile form, and every form computes the same, so a host
// of mixed cards would lose speed, never correctness.
struct SmCount {
  cudaError_t err;
  int sms;
};
inline const SmCount& sm_count() {
  static const SmCount c = [] {
    SmCount r{cudaSuccess, 0};
    int dev = 0;
    r.err = cudaGetDevice(&dev);
    if (r.err == cudaSuccess)
      r.err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    return r;
  }();
  return c;
}

}  // namespace tc
