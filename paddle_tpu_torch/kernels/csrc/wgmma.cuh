// Hopper's asynchronous copy and product primitives, as inline PTX:
// the mbarrier stage ring, TMA tile loads from a tensor map into
// 128-byte-swizzled shared memory (and im2col loads of a conv's pixels),
// the shared-memory matrix descriptor,
// TMA stores, named barriers, setmaxnreg, and wgmma.mma_async m64n128k16
// (bf16 operands, float32 accumulator) with A from shared memory or from
// registers, and m64n64k16 with both from shared memory.  Shared by K4's
// bf16 form (wgmma_gemm.cuh), K1's and K9's (flash_bf16.cuh) and K2's
// and K3's (flash_bwd.cu).  sm_90a only.
//
// Layouts.  A TMA box whose inner extent is 64 bf16 (128 bytes) lands
// as rows of 128 bytes, each row's eight 16-byte chunks permuted by
// chunk ^= row % 8 (CU_TENSOR_MAP_SWIZZLE_128B); the box must start on
// a 1024-byte boundary so that the pattern's phase is the address's.
// wgmma reads such a box through a descriptor (desc below):
// - K-major (the contraction index contiguous: x [M, K] as A, K [keys,
//   d] as B of Q K^T): a 64-row x 64-k box; eight-row groups are 1024
//   bytes apart (SBO), and the k16 step kk starts 32 kk bytes into the
//   row (the hardware swizzles the absolute address, so a start inside
//   the swizzle row is legal); LBO is unused;
// - MN-major (the output index contiguous: W [K, N] as B, V [keys, d]
//   as B of P V; the transpose bit set): a box of k rows x 64 n; eight
//   k rows are 1024 bytes apart (SBO), the k16 step starts 2048 bytes
//   further, and the next 64 columns of n are in the next box, LBO
//   bytes on.
//
// Accumulator layout of m64n128k16: warp w of the warpgroup owns rows
// 16 w .. 16 w + 15; register 4 j + e of lane (g = lane / 4, t = lane %
// 4) holds row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 -- per
// warp the m16n8 C-fragment layout of mma.sync, 16 fragments side by
// side.  An A operand from registers takes the m16n8k16 A-fragment
// layout (bf16_mma.cuh), so two adjacent C fragments of a float32 tile
// are one k16 A fragment of the next product without a shuffle.
#pragma once

#include <cuda.h>            // CUtensorMap (the types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

// ------------------------------------------------------------ mbarrier

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// count arrivals complete a phase; then every thread of the block may
// use the barrier once fence_init() and a block barrier have run
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed (a barrier
// starts in phase 0; waiting on parity 1 then returns at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------- TMA

// the box at coordinates (c0 innermost, c1[, c2]) of `map` into shared
// memory at dst, completing `bytes` of bar's expected transactions;
// elements past the tensor's edge land as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// im2col mode, a rank-4 map over NHWC x (bf16_im2col_map): the box of
// the map's pixelsPerColumn pixels x channelsPerPixel channels that
// starts at channel c, input pixel (w, h) of image n -- the top-left tap
// of an output pixel, which may lie in the padding -- and walks on by
// the map's element strides through the bounding box (its corners),
// row by row and image by image, each pixel read at (w + ow, h + oh):
// the filter tap.  Pixels and channels past x's edges land as zeros.
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int w,
                                                int h, int n, uint16_t ow,
                                                uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};" ::
          "r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n), "h"(ow),
      "h"(oh)
      : "memory");
}

// a box of shared memory at src to the tensor at coordinates (c0, c1)
// of `map` (elements past its edge are not written), in this thread's
// bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until this thread's committed stores have read their shared memory
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// until they have written global memory
__device__ __forceinline__ void store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// the threads' shared-memory writes, visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// a barrier of `count` threads (a multiple of 32) under id 1..15: wait
// at it, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------- wgmma

// the shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), and
// the layout type 1 (SWIZZLE_128B) in bits 62-63
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// before the first wgmma that reads registers (an accumulator, an A
// fragment) or shared memory the threads wrote
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// after wait(): the compiler must not read an accumulator (or reuse an
// A fragment's registers) before that point
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the registers a thread of this warpgroup may hold from here on, moved
// between warpgroups of the block (R a multiple of 8 in [24, 256]): a
// producer gives up what its consumers take
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// d (+)= A B on the tensor cores for one k16 step of a 64 x 128 tile,
// summed in float32; scale_d = 0 overwrites d.  TB = 1 reads B
// MN-major (W [K, N], V [keys, d]), 0 K-major.

// A and B from shared memory
template <int TB>
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// the m64n64k16 form, A and B from shared memory: d (+)= A B for one k16
// step of a 64 x 64 tile (the flash backward's score tiles, flash_bwd.cu);
// its accumulator layout is the m64n128k16 one cut to 8 fragments
template <int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// A from registers, B from shared memory
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[64],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// ----------------------------------------------------------- host side

// A function of libcuda, looked up by name through the CUDA runtime (so
// that a library needs no -lcuda); nullptr if there is none
inline void* cuda_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(cuda_entry("cuTensorMapEncodeTiled"));
  return fn;
}
inline EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn =
      reinterpret_cast<EncodeIm2col>(cuda_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

// The tensor map of a contiguous bf16 tensor of `rank` dimensions
// (dims[0] innermost; strides[i] the bytes between steps of dims[i + 1])
// read in boxes of `box` elements with 128-byte swizzle, zeros past its
// edges.  TMA needs the base on a 16-byte boundary and every stride a
// multiple of 16 bytes; otherwise cudaErrorInvalidValue.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims,
                            const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16) return cudaErrorInvalidValue;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
         const_cast<void*>(base), dims, strides, box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}


// The im2col map of contiguous NHWC bf16 x [N, H, W, C] (dims {C, W, H,
// N}, strides in bytes of W, H and N steps) for tma_load_im2col: boxes
// of `pixels` pixels x `channels` channels, 128-byte swizzle, zeros past
// its edges.  The bounding box of a walk's top-left taps runs from
// (W, H) corner `lower` to (W - 1, H - 1) + `upper` ({-pw, -ph} and
// {pw - (KW - 1), ph - (KH - 1)} for a conv's padding and filter), in
// steps of `estride` {1, sw, sh, 1}.  A rank-4 map takes corners in
// [-128, 127] and element strides in [1, 8]; TMA needs the base on a
// 16-byte boundary and every stride a multiple of 16 bytes (C % 8 == 0).
inline cudaError_t bf16_im2col_map(CUtensorMap* map, const void* base,
                                   const cuuint64_t (&dims)[4],
                                   const cuuint64_t (&strides)[3],
                                   const int (&lower)[2],
                                   const int (&upper)[2], int channels,
                                   int pixels, const cuuint32_t (&estride)[4]) {
  const EncodeIm2col fn = encode_im2col();
  if (!fn) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 16) return cudaErrorInvalidValue;
  for (int i = 0; i < 2; ++i)
    if (lower[i] < -128 || lower[i] > 127 || upper[i] < -128 ||
        upper[i] > 127)
      return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (estride[i] < 1 || estride[i] > 8) return cudaErrorInvalidValue;
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, lower, upper, (cuuint32_t)channels, (cuuint32_t)pixels,
      estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
