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
// What bounds K4 on the H100: float32 FMA throughput (67 TFLOP/s).  The
// flagship LM's projections (M = 32768, K and N 1024..8192) do 128 to
// 2048 FLOPs per byte, far above the card's 20 FLOP/byte in f32; there
// is no tensor-core path that keeps the reference's f32 precision
// (TF32 keeps ~3 decimal digits).  Design: the Pallas kernel carries
// its accumulator across a sequential K grid axis in VMEM; here one
// block owns one 128 x 128 output tile and loops over K itself, so
// nothing carries between blocks, there are no atomics, and every
// element is summed in one fixed order.  256 threads each hold an 8 x 8
// register tile of scalar FMAs (two 4 x 4 quadrants 64 rows / columns
// apart, so shared-memory reads are float4 broadcasts and contiguous
// rows without bank conflicts).  K tiles 8 deep are double-buffered in
// shared memory: the next tile's global loads are started into registers
// before this tile's FMAs and stored to the other buffer after them,
// one barrier per tile.  The x tile is stored k-major (transposed),
// padded so the transposing stores hit 32 distinct banks.  The epilogue
// runs from the accumulator registers.  Ragged M and N are masked here;
// K must be a multiple of 4 (float4 loads of x) and N % 4 == 0 selects
// float4 loads and stores of w and the output (else scalar ones).
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

namespace {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  if (act == ACT_GELU)
    return 0.5f * y *
           (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
  return y;
}

// ---------------------------------------------------------------- K4

constexpr int BM = 128;      // output rows per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 8;        // K depth of a shared-memory tile
constexpr int NT = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int AP = BM + 4;   // padded row of the transposed x tile

__device__ __forceinline__ float4 load_x(const float* __restrict__ x,
                                         int gm, int M, int k, int K) {
  if (gm < M && k < K)
    return *reinterpret_cast<const float4*>(x + (size_t)gm * K + k);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <bool VEC>
__device__ __forceinline__ float4 load_w(const float* __restrict__ w, int k,
                                         int K, int n, int N) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k >= K) return v;
  const float* row = w + (size_t)k * N;
  if (VEC) {
    if (n < N) v = *reinterpret_cast<const float4*>(row + n);
  } else {
    if (n < N) v.x = row[n];
    if (n + 1 < N) v.y = row[n + 1];
    if (n + 2 < N) v.z = row[n + 2];
    if (n + 3 < N) v.w = row[n + 3];
  }
  return v;
}

// the epilogue of 4 adjacent outputs (row gm, columns gn .. gn+3)
template <bool VEC>
__device__ __forceinline__ void epilogue4(
    float (&v)[4], int gm, int gn, int N, const float* __restrict__ bias,
    const float* __restrict__ res, float* __restrict__ out,
    float* __restrict__ pre, int act) {
  const size_t off = (size_t)gm * N + gn;
  if (bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < N) v[j] += bias[gn + j];
  }
  if (pre) {
    if (VEC) {
      *reinterpret_cast<float4*>(pre + off) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) pre[off + j] = v[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = apply_act(v[j], act);
  if (res) {
    if (VEC) {
      const float4 r = *reinterpret_cast<const float4*>(res + off);
      v[0] += r.x;
      v[1] += r.y;
      v[2] += r.z;
      v[3] += r.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) v[j] += res[off + j];
    }
  }
  if (VEC) {
    *reinterpret_cast<float4*>(out + off) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < N) out[off + j] = v[j];
  }
}

// VEC: N % 4 == 0, so a float4 of w / out / res starting at a column
// below N lies wholly inside the row
template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
mm_epilogue_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ res, float* __restrict__ out,
                   float* __restrict__ pre, int M, int N, int K, int act) {
  __shared__ __align__(16) float As[2][BK][AP];  // x tile, k-major
  __shared__ __align__(16) float Bs[2][BK][BN];  // w tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column group: tx*4 .. +3 and 64 + tx*4 ..
  const int ty = tid / 16;   // row group: ty*4 .. +3 and 64 + ty*4 ..
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // this thread's share of a tile load: one float4 of x (row a_r,
  // depth a_k .. a_k+3) and one float4 of w (depth b_k, columns b_c ..)
  const int a_r = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_c = (tid & 31) * 4;
  const int gm_a = m0 + a_r;
  const int gn_b = n0 + b_c;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = load_x(x, gm_a, M, a_k, K);
  float4 rb = load_w<VEC>(w, b_k, K, gn_b, N);
  As[0][a_k + 0][a_r] = ra.x;
  As[0][a_k + 1][a_r] = ra.y;
  As[0][a_k + 2][a_r] = ra.z;
  As[0][a_k + 3][a_r] = ra.w;
  *reinterpret_cast<float4*>(&Bs[0][b_k][b_c]) = rb;
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) {  // the next tile's loads are in flight during the FMAs
      ra = load_x(x, gm_a, M, k0 + BK + a_k, K);
      rb = load_w<VEC>(w, k0 + BK + b_k, K, gn_b, N);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bf[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    if (more) {  // the other buffer was last read before the barrier
      const int nb = buf ^ 1;
      As[nb][a_k + 0][a_r] = ra.x;
      As[nb][a_k + 1][a_r] = ra.y;
      As[nb][a_k + 2][a_r] = ra.z;
      As[nb][a_k + 3][a_r] = ra.w;
      *reinterpret_cast<float4*>(&Bs[nb][b_k][b_c]) = rb;
    }
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      if (gn >= N) continue;
      float v[4] = {acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                    acc[i][h * 4 + 3]};
      epilogue4<VEC>(v, gm, gn, N, bias, res, out, pre, act);
    }
  }
}

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || act < 0 || act > 2 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (N % 4 == 0)
    mm_epilogue_kernel<true><<<grid, NT, 0, s>>>(x, w, bias, res, out, pre,
                                                 M, N, K, act);
  else
    mm_epilogue_kernel<false><<<grid, NT, 0, s>>>(x, w, bias, res, out, pre,
                                                  M, N, K, act);
  return (int)cudaGetLastError();
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
