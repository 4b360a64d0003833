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
// K4's bf16 form (the fused LM under AMP, where the reference kernel
// takes bf16 x, w, bias and residual): wgmma_gemm.cuh's tile, the same
// function from bf16 operands.  What bounds it on the H100: at the
// fused step's projections (M = 32768, K 1024 or 4096, N 1024..8192)
// its products on the tensor cores, 989.4 TFLOP/s dense in bf16 (fc1,
// K 1024, N 4096: 0.28 ms of products against 0.35 ms of bytes with
// both pre and out; the others are further from their bytes).  Only
// wgmma reaches that rate, and only when a block keeps it fed: so TMA
// fills a 5-stage ring of 64-deep K tiles in 128-byte-swizzled shared
// memory from a producer warpgroup, two consumer warpgroups issue the
// wgmmas of a 128 x 128 output tile with its accumulator in registers
// over the whole K range (every 4 K tiles' products summed in a fresh
// fragment and added in float32, so that the tensor cores' truncating
// sums never run over K = 4096), and one block an SM walks its tiles so
// that the next tile's loads and first products overlap this one's
// epilogue, whose stores go out by TMA.  The epilogue runs in float32
// from the accumulator, as _matmul_kernel's does: + bias (bf16,
// widened), pre = bf16(y) (one rounding), act, + residual (bf16,
// widened), out = bf16(y) (one rounding).  K and N must be multiples of
// 8, x, w, out and pre 16-byte aligned (TMA).
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
//
// K5's bf16 form rounds where _add_ln_kernel rounds a bf16 row: s =
// bf16(x + y), written out as Sum; mean and var in float32 from s, each
// rounded to bf16 (and written); then (s - mean), * rsqrt(var + eps),
// * scale, + bias, each op in float32 and rounded to bf16, as bf16
// elementwise ops are (scale and bias f32 in memory, rounded to bf16 as
// the reference's astype does).  The f32 statistics come from float64
// sums: a row of bf16 values sums exactly in float64, so the f32 mean is
// the correctly rounded one in any order (ln_from_sum takes it so too);
// rounded to bf16, a last-bit difference would move a whole row.  A lane
// loads its D / 256 16-byte chunks of x and y (8 bf16 each) at once;
// D a multiple of 8, at most 1024.
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"
#include "wgmma_gemm.cuh"

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

// ------------------------------------------------------------ K5, bf16

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// NV: 16-byte chunks (8 bf16) per lane, D <= 256 * NV
template <int NV>
__global__ void __launch_bounds__(32 * LN_ROWS)
add_ln_bf16_kernel(const gemm::bf16* __restrict__ x,
                   const gemm::bf16* __restrict__ y,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   gemm::bf16* __restrict__ out, gemm::bf16* __restrict__ sum,
                   gemm::bf16* __restrict__ mean_out,
                   gemm::bf16* __restrict__ var_out, int M, int D,
                   float eps) {
  using gemm::bf16;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (row >= M) return;  // a whole warp leaves; no block barrier follows
  const int d8 = D / 8;
  const size_t base = (size_t)row * D;
  const uint4* x8 = reinterpret_cast<const uint4*>(x + base);
  const uint4* y8 = reinterpret_cast<const uint4*>(y + base);

  uint4 a[NV], b[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + 32 * v;
    a[v] = c < d8 ? x8[c] : make_uint4(0u, 0u, 0u, 0u);
    b[v] = c < d8 ? y8[c] : make_uint4(0u, 0u, 0u, 0u);
  }
  // s = bf16(x + y), kept widened; the row's sum exact in float64
  float s[NV][8];
  uint4* s8 = reinterpret_cast<uint4*>(sum + base);
  double total = 0.0;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&a[v]);
    const __nv_bfloat162* yb = reinterpret_cast<const __nv_bfloat162*>(&b[v]);
    uint4 packed;
    uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 xf = __bfloat1622float2(xa[j]);
      const float2 yf = __bfloat1622float2(yb[j]);
      pw[j] = tc::pack_bf16(__fadd_rn(xf.x, yf.x), __fadd_rn(xf.y, yf.y));
      const float2 sf =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pw[j]));
      s[v][2 * j] = sf.x;
      s[v][2 * j + 1] = sf.y;
    }
    if (lane + 32 * v < d8) {
      s8[lane + 32 * v] = packed;
#pragma unroll
      for (int e = 0; e < 8; ++e) total += (double)s[v][e];
    }
  }
  const float mean = (float)(warp_sum_d(total) / (double)D);
  double sq = 0.0;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (lane + 32 * v < d8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const double dv = (double)s[v][e] - (double)mean;
        sq += dv * dv;
      }
    }
  }
  const float var = (float)(warp_sum_d(sq) / (double)D);
  const bf16 mean_b = __float2bfloat16_rn(mean);
  const bf16 var_b = __float2bfloat16_rn(var);
  const float mb = __bfloat162float(mean_b);
  const float rs = bf16r(rsqrtf(bf16r(__bfloat162float(var_b) + eps)));
  uint4* o8 = reinterpret_cast<uint4*>(out + base);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + 32 * v;
    if (c >= d8) continue;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = bf16r(bf16r(s[v][e] - mb) * rs);
    if (scale) {
      const float4 g0 = reinterpret_cast<const float4*>(scale)[2 * c];
      const float4 g1 = reinterpret_cast<const float4*>(scale)[2 * c + 1];
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = bf16r(o[e] * bf16r(g[e]));
    }
    if (bias) {
      const float4 h0 = reinterpret_cast<const float4*>(bias)[2 * c];
      const float4 h1 = reinterpret_cast<const float4*>(bias)[2 * c + 1];
      const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = bf16r(o[e] + bf16r(h[e]));
    }
    uint4 packed;
    uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) pw[j] = tc::pack_bf16(o[2 * j], o[2 * j + 1]);
    o8[c] = packed;
  }
  if (lane == 0) {
    mean_out[row] = mean_b;
    var_out[row] = var_b;
  }
}

template <int NV>
cudaError_t launch_add_ln_bf16(const gemm::bf16* x, const gemm::bf16* y,
                               const float* scale, const float* bias,
                               gemm::bf16* out, gemm::bf16* sum,
                               gemm::bf16* mean, gemm::bf16* var, int M,
                               int D, float eps, cudaStream_t stream) {
  const int blocks = (M + LN_ROWS - 1) / LN_ROWS;
  add_ln_bf16_kernel<NV><<<blocks, 32 * LN_ROWS, 0, stream>>>(
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

// The bf16 form: x [M, K], w [K, N], bias [N] or NULL, res [M, N] or
// NULL, out [M, N], pre [M, N] or NULL; all bf16, contiguous, 16-byte
// aligned; K and N multiples of 8.  The product and the epilogue in
// float32, pre and out rounded once.
extern "C" int matmul_epilogue_bf16(const gemm::bf16* x, const gemm::bf16* w,
                                    const gemm::bf16* bias,
                                    const gemm::bf16* res, gemm::bf16* out,
                                    gemm::bf16* pre, int M, int N, int K,
                                    int act, void* stream) {
  if (act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  const gemm::ArgsT<gemm::bf16> a{x, w, nullptr, bias, res, out, pre,
                                  M, N, K, 0, act};
  return (int)wg::gemm_bf16<wg::GemmBf16>(a,
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

// The bf16 form: x, y, out, sum [M, D], mean, var [M] bf16; scale, bias
// [D] float32 or NULL (rounded to bf16 per use); all contiguous, 16-byte
// aligned.  D must be a multiple of 8 and at most 1024.
extern "C" int add_ln_bf16(const gemm::bf16* x, const gemm::bf16* y,
                           const float* scale, const float* bias,
                           gemm::bf16* out, gemm::bf16* sum,
                           gemm::bf16* mean, gemm::bf16* var, int M, int D,
                           float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || D % 8 || D > 1024)
    return (int)cudaErrorInvalidValue;
  if (D <= 256)
    return (int)launch_add_ln_bf16<1>(x, y, scale, bias, out, sum, mean, var,
                                      M, D, eps, s);
  if (D <= 512)
    return (int)launch_add_ln_bf16<2>(x, y, scale, bias, out, sum, mean, var,
                                      M, D, eps, s);
  return (int)launch_add_ln_bf16<4>(x, y, scale, bias, out, sum, mean, var,
                                    M, D, eps, s);
}
