// K8: x @ dequant(int8 W) with the bias / activation / residual epilogue.
//
// Replaces the TPU kernel paddle_tpu/kernels/matmul_fused.py
// _matmul_int8_kernel (launched by matmul_int8_dequant): x f32 [M, K]
// times W = int8 q [K, N] x f32 scales [K/chunk, N] (one scale per
// K-chunk of a column), accumulated in f32, then + bias, act ('' /
// relu / tanh-gelu), + residual.  The f32 weights never exist in device
// memory: int8 values are converted on the SM right before the products.
//
// What bounds it on the H100: at decode (M <= 16) bytes -- every int8
// weight byte is read once per step and used for M products -- and at
// prefill (M up to 2048) the products.  The int8 weights are exact in
// TF32, so a float32-accurate product takes two TF32 MMAs (x hi and x lo
// times q), 494.7 / 2 TFLOP/s at most.  So two forms:
//
// - decode (M <= 16), mm_int8_skinny: a block owns a 32-column slab and
//   one K range.  Its 256 threads are 8 column groups (4 columns) x 32 K
//   lanes, so a warp reads whole 32-byte rows of a step's weights.  K
//   runs in steps of 256 rows; a ring of 4 steps (x's slice and the
//   weight rows, 24 KB of weights a block) is kept in flight in shared
//   memory by cp.async while a step's FMAs run, and the warp partials
//   reuse the ring at the end.  One slab per block alone leaves most
//   SMs idle when N is 1024 (32 blocks), so the K range is split over a
//   thread block cluster of KS blocks (KS <= 8, chosen from K and N
//   only) and the cluster's first block sums the others' partials
//   through distributed shared memory -- no workspace in device memory.
//   Every sum runs in a fixed order (K lanes by shuffles, then warps,
//   then cluster ranks), and nothing in it depends on M, so decode is
//   batch-invariant.
// - prefill (M > 16): gemm_tile.cuh's tile with int8 weights (Int8W), on
//   the tensor cores in split-TF32: x split into hi and lo as each
//   fragment loads, q converted to f32 once when it lands, two MMAs a
//   product; each 32-deep K tile sums in a fresh fragment, which its
//   chunk's scale row multiplies into the accumulator (the tile depth
//   divides the quantization chunk: the reference's chunk % bk == 0
//   rule).  No sum depends on M or on the tile form, so a row's result
//   is the same in any prefill batch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace cg = cooperative_groups;
namespace {

using gemm::apply_act;
using tc::cp16;
using tc::cp4;
using tc::cp_commit;
using tc::cp_wait;

// decode: M <= MB rows; a block owns 32 columns and K rows
// [blockIdx.y * kpb, (blockIdx.y + 1) * kpb); the blocks of one column
// slab form a cluster along y
constexpr int KT = 256;       // K rows per step of the decode kernel
constexpr int RPT = KT / 32;  // rows per thread per step
constexpr int MAX_KS = 8;     // largest portable cluster
constexpr int DSTAGES = 4;    // steps in flight
constexpr int DECODE_M = 16;  // the decode kernel's rows; more: the tile

// one step's stage in shared memory: x[:, k0 .. k0 + KT) f32, then the
// step's KT weight rows of the block's 32 columns
template <int MB>
struct Dec {
  static constexpr int XS = MB * KT * 4;
  static constexpr int STAGE = XS + KT * 32;
  static constexpr int PART = MB * 32 * 4;
  static constexpr int bytes = DSTAGES * STAGE + PART;
  static_assert(8 * MB * 32 * 4 <= DSTAGES * STAGE,
                "warp partials reuse the stages");
  static_assert(2 * (bytes + 1024) <= 228 * 1024, "two blocks an SM");
};

// cp.async one step into its stage: x rows past M and K rows past
// k_end zero; VEC: N % 16 == 0, whole 16-byte weight chunks, else
// 4-byte copies with columns past N zero
template <int MB, bool VEC>
__device__ __forceinline__ void load_step(char* stage,
                                          const float* __restrict__ x,
                                          const int8_t* __restrict__ wq,
                                          int k0, int k_end, int n0, int M,
                                          int N, int K) {
  float* xs = reinterpret_cast<float*>(stage);
  for (int i = threadIdx.x; i < MB * KT / 4; i += 256) {
    const int m = i / (KT / 4), c = 4 * (i % (KT / 4));
    const bool ok = m < M && k0 + c < k_end;
    cp16(xs + m * KT + c, x + (ok ? (size_t)m * K + k0 + c : 0), ok);
  }
  char* ws = stage + Dec<MB>::XS;
  if (VEC) {
    for (int i = threadIdx.x; i < KT * 2; i += 256) {
      const int r = i / 2, c = 16 * (i % 2);
      const bool ok = k0 + r < k_end && n0 + c < N;
      cp16(ws + r * 32 + c, wq + (ok ? (size_t)(k0 + r) * N + n0 + c : 0),
           ok);
    }
  } else {
    for (int i = threadIdx.x; i < KT * 8; i += 256) {
      const int r = i / 8, c = 4 * (i % 8);
      const bool ok = k0 + r < k_end && n0 + c < N;
      cp4(ws + r * 32 + c, wq + (ok ? (size_t)(k0 + r) * N + n0 + c : 0),
          ok);
    }
  }
}

// Its 256 threads are 8 column groups (4 columns) x 32 K lanes: a
// thread's rows of a step are kl, kl + 32, ..., so a warp reads whole
// 32-byte rows of the stage.  DSTAGES steps of x and weights are in
// flight by cp.async while a step's FMAs run.
template <int MB, bool VEC>
__global__ void __launch_bounds__(256, 2)
mm_int8_skinny(const float* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scales,
               const float* __restrict__ bias,
               const float* __restrict__ res, float* __restrict__ out,
               int M, int N, int K, int chunk, int act, int kpb) {
  using D = Dec<MB>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float (*part)[32] =
      reinterpret_cast<float (*)[32]>(smem + DSTAGES * D::STAGE);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cgp = tid % 8;  // column group: columns cgp*4 .. cgp*4+3
  const int kl = tid / 8;   // K lane: rows kl, kl+32, ... of each step
  const int n0 = blockIdx.x * 32;
  const int n = min(n0 + cgp * 4, N - 4);   // N % 4 == 0; past N: unused
  const int k_begin = blockIdx.y * kpb;
  const int k_end = min(K, k_begin + kpb);
  const int steps = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;
  // a step never crosses a quantization chunk when KT divides chunk
  const bool step_scale = chunk % KT == 0;

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < steps)
      load_step<MB, VEC>(smem + s * D::STAGE, x, wq, k_begin + s * KT,
                         k_end, n0, M, N, K);
    cp_commit();
  }
  for (int st = 0; st < steps; ++st) {
    const int k0 = k_begin + st * KT;
    cp_wait<DSTAGES - 2>();
    __syncthreads();                // step st landed; step st - 1 consumed
    if (st + DSTAGES - 1 < steps)
      load_step<MB, VEC>(smem + (st + DSTAGES - 1) % DSTAGES * D::STAGE, x,
                         wq, k0 + (DSTAGES - 1) * KT, k_end, n0, M, N, K);
    cp_commit();
    const char* stage = smem + st % DSTAGES * D::STAGE;
    const float* xs = reinterpret_cast<const float*>(stage);
    const char* ws = stage + D::XS;
    float4 s4 = __ldg(reinterpret_cast<const float4*>(
        scales + (size_t)(k0 / chunk) * N + n));
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = k0 + kl + 32 * r;
      if (!step_scale)
        s4 = __ldg(reinterpret_cast<const float4*>(
            scales + (size_t)(min(k, k_end - 1) / chunk) * N + n));
      // rows past k_end landed as zero: they add nothing
      const char4 q =
          *reinterpret_cast<const char4*>(ws + (kl + 32 * r) * 32 + 4 * cgp);
      const float w[4] = {(float)q.x * s4.x, (float)q.y * s4.y,
                          (float)q.z * s4.z, (float)q.w * s4.w};
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float xv = xs[m * KT + kl + 32 * r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += xv * w[j];
      }
    }
  }
  // the 4 K lanes of a warp sit 8 and 16 lanes apart
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  cp_wait<0>();
  __syncthreads();                  // every stage consumed: reuse them
  float (*red)[MB][32] = reinterpret_cast<float (*)[MB][32]>(smem);
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][m][cgp * 4 + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < MB * 32; i += 256) {
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) y += red[w][i / 32][i % 32];
    part[i / 32][i % 32] = y;
  }
  cluster.sync();  // every block's partial is written
  if (cluster.block_rank() == 0) {
    const int ks = (int)cluster.num_blocks();
    for (int i = tid; i < MB * 32; i += 256) {
      const int m = i / 32, c = i % 32, gn = n0 + c;
      if (m >= M || gn >= N) continue;
      float y = 0.f;
      for (int r = 0; r < ks; ++r)
        y += cluster.map_shared_rank(&part[0][0], r)[i];
      if (bias) y += bias[gn];
      y = apply_act(y, act);
      if (res) y += res[(size_t)m * N + gn];
      out[(size_t)m * N + gn] = y;
    }
  }
  cluster.sync();  // keep every block's shared memory alive until read
}

template <int MB, bool VEC>
cudaError_t launch_skinny_form(const float* x, const int8_t* wq,
                               const float* scales, const float* bias,
                               const float* res, float* out, int M, int N,
                               int K, int chunk, int act,
                               cudaStream_t stream) {
  // split K over KS blocks of a cluster while the grid still fits two
  // blocks per SM (264) and each K range keeps at least one step
  const int slabs = (N + 31) / 32;
  int ks = 1;
  while (ks < MAX_KS && slabs * ks * 2 <= 264 && K / (2 * ks) >= KT)
    ks *= 2;
  const int kpb = (K / ks + KT - 1) / KT * KT;
  constexpr int bytes = Dec<MB>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mm_int8_skinny<MB, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs, ks);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mm_int8_skinny<MB, VEC>, x, wq, scales,
                           bias, res, out, M, N, K, chunk, act, kpb);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int MB>
cudaError_t launch_skinny(const float* x, const int8_t* wq,
                          const float* scales, const float* bias,
                          const float* res, float* out, int M, int N, int K,
                          int chunk, int act, cudaStream_t stream) {
  return N % 16 == 0
             ? launch_skinny_form<MB, true>(x, wq, scales, bias, res, out, M,
                                            N, K, chunk, act, stream)
             : launch_skinny_form<MB, false>(x, wq, scales, bias, res, out,
                                             M, N, K, chunk, act, stream);
}

}  // namespace

// x [M, K] f32, wq [K, N] int8, scales [K/chunk, N] f32, bias [N] or
// NULL, res [M, N] or NULL, out [M, N] f32; all contiguous, x, wq and
// scales 16-byte aligned.  K and chunk must be multiples of the tile
// depth 32, N of 4.
extern "C" int matmul_int8_f32(const float* x, const int8_t* wq,
                               const float* scales, const float* bias,
                               const float* res, float* out, int M, int N,
                               int K, int chunk, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || chunk % 32 || N % 4)
    return (int)cudaErrorInvalidValue;
  if (M <= 1)
    return (int)launch_skinny<1>(x, wq, scales, bias, res, out, M, N, K,
                                 chunk, act, s);
  if (M <= 2)
    return (int)launch_skinny<2>(x, wq, scales, bias, res, out, M, N, K,
                                 chunk, act, s);
  if (M <= 4)
    return (int)launch_skinny<4>(x, wq, scales, bias, res, out, M, N, K,
                                 chunk, act, s);
  if (M <= 8)
    return (int)launch_skinny<8>(x, wq, scales, bias, res, out, M, N, K,
                                 chunk, act, s);
  if (M <= DECODE_M)
    return (int)launch_skinny<DECODE_M>(x, wq, scales, bias, res, out, M, N,
                                        K, chunk, act, s);
  const gemm::Args a{x, wq, scales, bias, res, out, nullptr, M, N, K, chunk,
                     act};
  return (int)gemm::run<gemm::Int8W>(a, N % 16 == 0, s);
}

// The tile (BM, BN) matmul_int8_f32 runs for an [M, N] output, or
// (0, 0) for the decode kernel.
extern "C" int matmul_int8_tile(int M, int N, int* bm, int* bn) {
  if (M <= DECODE_M) {
    *bm = *bn = 0;
    return 0;
  }
  return (int)gemm::tile_of(M, N, bm, bn);
}
