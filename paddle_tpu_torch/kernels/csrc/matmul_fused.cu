// K4: x @ w in float32 with the fused bias / activation / residual
// epilogue, and K5: residual add + LayerNorm.
//
// K4 replaces the TPU kernel paddle_tpu/kernels/matmul_fused.py
// _matmul_kernel (launched by matmul_epilogue): x f32 [M, K] times
// w f32 [K, N], accumulated in f32, then + bias [N], an optional copy of
// that pre-activation (`pre`, the grad's saved residual), act ('' /
// relu / tanh-gelu), + residual [M, N].  The raw product never reaches
// device memory between the matmul and its elementwise tail.
//
// What bounds K4 on the H100: its products.  The flagship LM's
// projections (M = 32768, K and N 1024..8192) do 2 M K N FLOPs against
// a few bytes a row: fc1 (K 1024, N 4096) is 275 GFLOP against 0.69 GB,
// 1.67 ms of float32-accurate products on the tensor cores against
// 0.21 ms of bytes.  The products run in split-TF32 on mma.sync (three
// TF32 MMAs a product, 494.7 / 3 TFLOP/s at most; the f32 FMA pipes
// give 67).  Design: gemm_tile.cuh's tile with f32 weights (F32W): the
// Pallas kernel carries its accumulator across a sequential K grid axis
// in VMEM; here a block owns one 128 x 64 (or, on a grid short of one
// block an SM, 64 x 64) output tile and loops over K itself, so nothing
// carries between blocks, there are no atomics, and every element is
// summed in one fixed order, each 32-deep K tile in a fresh fragment
// added in float32.  Any M and N; K a multiple of 4 (16-byte copies of
// x rows); N % 4 == 0 takes 16-byte copies of w and float2 epilogue
// accesses, else 4-byte copies and scalar ones.
//
// K5 replaces paddle_tpu/kernels/matmul_fused.py _add_ln_kernel
// (launched by add_ln): s = x + y per row of D, mean and variance in
// f32 (var = mean((s - mean)^2), the layer_norm lowering's order), then
// (s - mean) * rsqrt(var + eps) * scale + bias; writes out, s, mean and
// var.  What bounds it: bytes (two reads and two writes of [M, D]; a
// few FLOPs per byte).  Design: one warp per row, 8 rows per block; a
// lane loads its D / 128 float4 of x and y at once (all in flight
// before the first use), keeps the sum in registers, and the two
// statistics are warp-shuffle reductions -- the sum is written once and
// never read back.
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"

namespace {

// ---------------------------------------------------------------- K5

constexpr int LN_ROWS = 8;   // rows (warps) per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NV: float4 per lane, D <= 128 * NV
template <int NV>
__global__ void __launch_bounds__(32 * LN_ROWS)
add_ln_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ scale,
              const float* __restrict__ bias, float* __restrict__ out,
              float* __restrict__ sum, float* __restrict__ mean_out,
              float* __restrict__ var_out, int M, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (row >= M) return;  // a whole warp leaves; no block barrier follows
  const int d4 = D / 4;
  const size_t base = (size_t)row * D;
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  const float4* y4 = reinterpret_cast<const float4*>(y + base);

  float4 a[NV], b[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + 32 * v;
    a[v] = c < d4 ? x4[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    b[v] = c < d4 ? y4[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4* s4 = reinterpret_cast<float4*>(sum + base);
  float total = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    a[v].x += b[v].x;
    a[v].y += b[v].y;
    a[v].z += b[v].z;
    a[v].w += b[v].w;
    const int c = lane + 32 * v;
    if (c < d4) {
      s4[c] = a[v];
      total += (a[v].x + a[v].y) + (a[v].z + a[v].w);
    }
  }
  const float mean = warp_sum(total) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (lane + 32 * v < d4) {
      const float dx = a[v].x - mean, dy = a[v].y - mean;
      const float dz = a[v].z - mean, dw = a[v].w - mean;
      sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
  }
  const float var = warp_sum(sq) / (float)D;
  const float rstd = rsqrtf(var + eps);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  const float4* sc4 = reinterpret_cast<const float4*>(scale);
  const float4* bi4 = reinterpret_cast<const float4*>(bias);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + 32 * v;
    if (c >= d4) continue;
    float4 o = make_float4((a[v].x - mean) * rstd, (a[v].y - mean) * rstd,
                           (a[v].z - mean) * rstd, (a[v].w - mean) * rstd);
    if (scale) {
      const float4 g = sc4[c];
      o.x *= g.x;
      o.y *= g.y;
      o.z *= g.z;
      o.w *= g.w;
    }
    if (bias) {
      const float4 h = bi4[c];
      o.x += h.x;
      o.y += h.y;
      o.z += h.z;
      o.w += h.w;
    }
    o4[c] = o;
  }
  if (lane == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

template <int NV>
cudaError_t launch_add_ln(const float* x, const float* y, const float* scale,
                          const float* bias, float* out, float* sum,
                          float* mean, float* var, int M, int D, float eps,
                          cudaStream_t stream) {
  const int blocks = (M + LN_ROWS - 1) / LN_ROWS;
  add_ln_kernel<NV><<<blocks, 32 * LN_ROWS, 0, stream>>>(
      x, y, scale, bias, out, sum, mean, var, M, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x [M, K], w [K, N], bias [N] or NULL, res [M, N] or NULL, out [M, N],
// pre [M, N] or NULL; all float32, contiguous, 16-byte aligned.  act: 0
// none, 1 relu, 2 tanh-gelu.  K must be a multiple of 4.
extern "C" int matmul_epilogue_f32(const float* x, const float* w,
                                   const float* bias, const float* res,
                                   float* out, float* pre, int M, int N,
                                   int K, int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const gemm::Args a{x, w, nullptr, bias, res, out, pre, M, N, K, 0, act};
  return (int)gemm::run<gemm::F32W>(a, N % 4 == 0,
                                    static_cast<cudaStream_t>(stream));
}

// The tile (BM, BN) matmul_epilogue_f32 runs for an [M, N] output.
extern "C" int matmul_epilogue_tile(int M, int N, int* bm, int* bn) {
  return (int)gemm::tile_of(M, N, bm, bn);
}

// x, y, out, sum [M, D]; scale, bias [D] or NULL; mean, var [M]; all
// float32, contiguous, 16-byte aligned.  D must be a multiple of 4 and
// at most 1024.
extern "C" int add_ln_f32(const float* x, const float* y, const float* scale,
                          const float* bias, float* out, float* sum,
                          float* mean, float* var, int M, int D, float eps,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || D % 4 || D > 1024)
    return (int)cudaErrorInvalidValue;
  if (D <= 128)
    return (int)launch_add_ln<1>(x, y, scale, bias, out, sum, mean, var, M,
                                 D, eps, s);
  if (D <= 256)
    return (int)launch_add_ln<2>(x, y, scale, bias, out, sum, mean, var, M,
                                 D, eps, s);
  if (D <= 512)
    return (int)launch_add_ln<4>(x, y, scale, bias, out, sum, mean, var, M,
                                 D, eps, s);
  return (int)launch_add_ln<8>(x, y, scale, bias, out, sum, mean, var, M, D,
                               eps, s);
}
