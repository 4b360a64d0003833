// K8: x @ dequant(int8 W) with the bias / activation / residual epilogue.
//
// Replaces the TPU kernel paddle_tpu/kernels/matmul_fused.py
// _matmul_int8_kernel (launched by matmul_int8_dequant): x f32 [M, K]
// times W = int8 q [K, N] x f32 scales [K/chunk, N] (one scale per
// K-chunk of a column), accumulated in f32, then + bias, act ('' /
// relu / tanh-gelu), + residual.  The f32 weights never exist in device
// memory: int8 values are rescaled on the SM right before the FMAs.
//
// What bounds it on the H100: at decode (M <= 16) bytes -- every int8
// weight byte is read once per step and used for M FMAs -- and at
// prefill (M up to 2048) the products.  They run as float32 FMAs (67
// TFLOP/s); the least time for them is on the tensor cores: the int8
// weights are exact in TF32, so a float32-accurate product takes two
// TF32 MMAs (x hi and x lo times w), 494.7/2 TFLOP/s -- not used yet.
// So two kernels:
//
// - decode (M <= 16), mm_int8_skinny: a block owns a 32-column slab and
//   one K range.  Its 256 threads are 8 column groups (4 columns, one
//   4-byte load per row) x 32 K lanes, so a warp reads whole 32-byte
//   rows.  K runs in steps of 256 rows: x's slice of the step is staged
//   in shared memory, and each thread's 8 weight rows of the NEXT step
//   are loaded into registers before this step's FMAs, keeping them in
//   flight.  One slab per block alone leaves most SMs idle when N is
//   1024 (32 blocks), so the K range is split over a thread block
//   cluster of KS blocks (KS <= 8, chosen from K and N only) and the
//   cluster's first block sums the others' partials through distributed
//   shared memory -- no workspace in device memory.  Every sum runs in
//   a fixed order (K lanes by shuffles, then warps, then cluster ranks),
//   and nothing in it depends on M, so decode is batch-invariant.
// - prefill (M > 16), mm_int8_tiled: 64 x 64 output tiles looping over
//   32-deep K tiles; the tile depth divides the quantization chunk, so
//   one scale row rescales a whole tile (the reference's chunk % bk == 0
//   rule) into shared memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;
namespace {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  if (act == ACT_GELU)
    return 0.5f * y *
           (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
  return y;
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mm_int8_tiled(const float* __restrict__ x, const int8_t* __restrict__ wq,
              const float* __restrict__ scales,
              const float* __restrict__ bias,
              const float* __restrict__ res, float* __restrict__ out,
              int M, int N, int K, int chunk, int act) {
  constexpr int CX = BN / TN;           // column threads
  constexpr int NT = (BM / TM) * CX;
  __shared__ float Xs[BK][BM + 1];      // x tile, transposed
  __shared__ float Ws[BK][BN];          // dequantized weight tile

  const int tid = threadIdx.x;
  const int tx = tid % CX;
  const int ty = tid / CX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK, gm = m0 + r;
      Xs[c][r] = gm < M ? x[(size_t)gm * K + k0 + c] : 0.f;
    }
    const float* srow = scales + (size_t)(k0 / chunk) * N;
    for (int i = tid; i < BK * BN / 4; i += NT) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4, gn = n0 + c;
      if (gn < N) {
        const char4 w4 = *reinterpret_cast<const char4*>(
            wq + (size_t)(k0 + r) * N + gn);
        const float4 s4 = *reinterpret_cast<const float4*>(srow + gn);
        Ws[r][c] = (float)w4.x * s4.x;
        Ws[r][c + 1] = (float)w4.y * s4.y;
        Ws[r][c + 2] = (float)w4.z * s4.z;
        Ws[r][c + 3] = (float)w4.w * s4.w;
      } else {
        Ws[r][c] = Ws[r][c + 1] = Ws[r][c + 2] = Ws[r][c + 3] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = Xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = Ws[kk][tx + CX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += xv[i] * wv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + CX * j;
      if (gn >= N) continue;
      float y = acc[i][j];
      if (bias) y += bias[gn];
      y = apply_act(y, act);
      if (res) y += res[(size_t)gm * N + gn];
      out[(size_t)gm * N + gn] = y;
    }
  }
}

// decode: M <= MB rows; a block owns 32 columns and K rows
// [blockIdx.y * kpb, (blockIdx.y + 1) * kpb); the blocks of one column
// slab form a cluster along y
constexpr int KT = 256;       // K rows per step of the skinny kernel
constexpr int RPT = KT / 32;  // rows per thread per step
constexpr int MAX_KS = 8;     // largest portable cluster

// the RPT weight rows (4 columns each) a thread uses in one step
__device__ __forceinline__ void load_rows(const int8_t* __restrict__ wq,
                                          int k0, int kl, int k_end, int N,
                                          int n, char4 (&w4)[RPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = k0 + kl + 32 * r;
    w4[r] = k < k_end ? __ldg(reinterpret_cast<const char4*>(
                            wq + (size_t)k * N + n))
                      : make_char4(0, 0, 0, 0);
  }
}

// MB >= 8 needs ~130 registers: capping it at 128 lets two blocks share
// an SM, which is faster at M=16; the cap slows M <= 4, which needs
// fewer than 128 anyway
template <int MB>
__global__ void __launch_bounds__(256, MB >= 8 ? 2 : 1)
mm_int8_skinny(const float* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scales,
               const float* __restrict__ bias,
               const float* __restrict__ res, float* __restrict__ out,
               int M, int N, int K, int chunk, int act, int kpb) {
  __shared__ float xs[MB][KT];      // x[:, k0 .. k0+KT) of this step
  __shared__ float red[8][MB][32];  // per-warp partials
  __shared__ float part[MB][32];    // this block's partial
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cgp = tid % 8;  // column group: columns cgp*4 .. cgp*4+3
  const int kl = tid / 8;   // K lane: rows kl, kl+32, ... of each step
  const int n0 = blockIdx.x * 32;
  const int n = min(n0 + cgp * 4, N - 4);   // N % 4 == 0; past N: unused
  const int k_begin = blockIdx.y * kpb;
  const int k_end = min(K, k_begin + kpb);
  // a step never crosses a quantization chunk when KT divides chunk
  const bool step_scale = chunk % KT == 0;

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  // software pipeline: the next step's weight rows are in flight while
  // this step's FMAs run
  char4 cur[RPT], nxt[RPT];
  load_rows(wq, k_begin, kl, k_end, N, n, cur);
  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    __syncthreads();
    for (int i = tid; i < KT * MB; i += 256) {
      const int m = i / KT, kk = i % KT;
      xs[m][kk] =
          (m < M && k0 + kk < k_end) ? x[(size_t)m * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (k0 + KT < k_end) load_rows(wq, k0 + KT, kl, k_end, N, n, nxt);
    float4 s4 = __ldg(reinterpret_cast<const float4*>(
        scales + (size_t)(k0 / chunk) * N + n));
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int k = k0 + kl + 32 * r;
      if (!step_scale)
        s4 = __ldg(reinterpret_cast<const float4*>(
            scales + (size_t)(min(k, k_end - 1) / chunk) * N + n));
      // rows past k_end loaded as zero: they add nothing
      const float w[4] = {(float)cur[r].x * s4.x, (float)cur[r].y * s4.y,
                          (float)cur[r].z * s4.z, (float)cur[r].w * s4.w};
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float xv = xs[m][kl + 32 * r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += xv * w[j];
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) cur[r] = nxt[r];
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

template <int MB>
cudaError_t launch_skinny(const float* x, const int8_t* wq,
                          const float* scales, const float* bias,
                          const float* res, float* out, int M, int N, int K,
                          int chunk, int act, cudaStream_t stream) {
  // split K over KS blocks of a cluster while the grid still fits two
  // blocks per SM (264) and each K range keeps at least one step
  const int slabs = (N + 31) / 32;
  int ks = 1;
  while (ks < MAX_KS && slabs * ks * 2 <= 264 && K / (2 * ks) >= KT)
    ks *= 2;
  const int kpb = (K / ks + KT - 1) / KT * KT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs, ks);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, mm_int8_skinny<MB>, x, wq, scales, bias, res,
                         out, M, N, K, chunk, act, kpb);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_tiled(const float* x, const int8_t* wq,
                         const float* scales, const float* bias,
                         const float* res, float* out, int M, int N, int K,
                         int chunk, int act, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_int8_tiled<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, wq, scales, bias, res,
                                                   out, M, N, K, chunk, act);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] f32, wq [K, N] int8, scales [K/chunk, N] f32, bias [N] or
// NULL, res [M, N] or NULL, out [M, N] f32; all contiguous.  K and
// chunk must be multiples of the tile depth 32, N of 4.
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
  if (M <= 16)
    return (int)launch_skinny<16>(x, wq, scales, bias, res, out, M, N, K,
                                  chunk, act, s);
  return (int)launch_tiled<64, 64, 32, 4, 4>(x, wq, scales, bias, res, out,
                                             M, N, K, chunk, act, s);
}
