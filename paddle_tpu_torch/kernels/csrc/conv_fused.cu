// K6: the ResNet conv stage -- an NHWC x HWIO convolution in float32 with
// a fused epilogue, as an implicit GEMM.
//
// Replaces the TPU kernel paddle_tpu/kernels/conv_fused.py
// _conv_stage_kernel (launched by conv2d_nhwc): x f32 [N, H, W, Ci] (NHWC)
// convolved with w f32 [KH, KW, Ci, Co] (HWIO) at stride (sh, sw) and
// zero padding (ph, pw) into an f32 accumulator, then, from the
// accumulator and in this order:
//   stats    per-channel partial (sum acc, sum acc^2), written per M tile
//            to partials [ceil(M / 128), 2, Co] before any other epilogue
//            (the wrapper reduces them in a fixed order: deterministic,
//            no atomics);
//   affine   y = acc * a[c] + b[c] (the test-mode BatchNorm fold);
//   residual y += r;
//   act      relu.
//
// What bounds K6 on the H100: float32 FMA throughput (67 TFLOP/s).  Every
// ResNet-50 stage shape at batch 256 does 120..1100 FLOPs per byte it
// must move, far above the card's 20 FLOP/byte in f32, and TF32 would
// keep only ~3 decimal digits of the reference's f32 conv.
//
// Design: the Pallas kernel runs one image per grid step over an input
// padded in HBM.  Here the conv is an implicit GEMM: M = N * Ho * Wo
// output pixels, GEMM-N = Co, K = KH * KW * Ci.  The HWIO filter as
// stored is the row-major [K, Co] B operand.  The A tile is gathered
// straight from NHWC x through (n, ho, wo) x (kh, kw, ci) index
// arithmetic; padding is a zero predicate on the load, so there is no
// im2col buffer and no padded copy in memory.  M tiles run across image
// boundaries, so the 7 x 7 stages (49 rows an image) still fill a tile.
// The tile machinery is K4's (csrc/matmul_fused.cu): one block owns a
// 128 x 128 output tile and loops over K itself, 256 threads each hold
// an 8 x 8 accumulator (two 4 x 4 quadrants 64 apart), K tiles 8 deep
// are double-buffered in shared memory with the next tile's loads in
// registers during the FMAs, the A tile stored k-major and padded.
// Scalar f32 FMAs, no TF32.  Ci % 8 == 0 (every ResNet stage but the
// stem) selects float4 gathers along Ci: an 8-deep K tile then lies in
// one (kh, kw) tap, whose position every thread tracks incrementally.
// The stem (Ci = 3) gathers scalars and decomposes each k.  Co must be a
// multiple of 4 (float4 loads of w, a, b, r and stores of out); ragged M
// and Co are masked.  The stats reduction reuses the tile buffers.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 128;      // output channels per block
constexpr int BK = 8;        // K depth of a shared-memory tile
constexpr int NT = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int AP = BM + 4;   // padded row of the transposed A tile
constexpr int SMEM = 2 * BK * AP + 2 * BK * BN;  // floats

struct Shape {
  int N, H, W, Ci, Co, KH, KW, sh, sw, ph, pw, Ho, Wo, M, K;
};

// float4 of x at (image base, hi, wi, c .. c+3), zero outside the image
__device__ __forceinline__ float4 gather4(const float* __restrict__ xim,
                                          bool row_ok, int hi, int wi, int c,
                                          const Shape& s) {
  if (row_ok && (unsigned)hi < (unsigned)s.H && (unsigned)wi < (unsigned)s.W)
    return *reinterpret_cast<const float4*>(
        xim + ((size_t)hi * s.W + wi) * s.Ci + c);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// the four A values at k .. k+3 for any Ci (the stem): each k decomposed
// into its (kh, kw, ci)
__device__ __forceinline__ float4 gather1(const float* __restrict__ xim,
                                          bool row_ok, int hi0, int wi0,
                                          int k, const Shape& s) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = 0.f;
    const int kk = k + j;
    if (row_ok && kk < s.K) {
      const int tap = kk / s.Ci;
      const int c = kk - tap * s.Ci;
      const int kh = tap / s.KW;
      const int hi = hi0 + kh, wi = wi0 + (tap - kh * s.KW);
      if ((unsigned)hi < (unsigned)s.H && (unsigned)wi < (unsigned)s.W)
        v[j] = xim[((size_t)hi * s.W + wi) * s.Ci + c];
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 load_w(const float* __restrict__ w, int k,
                                         int n, const Shape& s) {
  if (k < s.K && n < s.Co)
    return *reinterpret_cast<const float4*>(w + (size_t)k * s.Co + n);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// VEC: Ci % 8 == 0
template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
conv_stage_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ res, float* __restrict__ out,
                  float* __restrict__ partials, Shape s, int act) {
  __shared__ __align__(16) float smem[SMEM];
  float(*As)[BK][AP] = reinterpret_cast<float(*)[BK][AP]>(smem);
  float(*Bs)[BK][BN] = reinterpret_cast<float(*)[BK][BN]>(smem + 2 * BK * AP);

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column group: tx*4 .. +3 and 64 + tx*4 ..
  const int ty = tid / 16;   // row group: ty*4 .. +3 and 64 + ty*4 ..
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's share of a tile load: one float4 of A (pixel a_r,
  // depth a_k .. a_k+3) and one float4 of w (depth b_k, channels b_c ..)
  const int a_r = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_c = (tid & 31) * 4;
  const int gm_a = m0 + a_r;
  const int gn_b = n0 + b_c;

  // the output pixel this thread gathers for: image, top-left input tap
  const bool row_ok = gm_a < s.M;
  int hi0 = 0, wi0 = 0;
  const float* xim = x;
  if (row_ok) {
    const int hw = s.Ho * s.Wo;
    const int img = gm_a / hw;
    const int r = gm_a - img * hw;
    const int ho = r / s.Wo;
    hi0 = ho * s.sh - s.ph;
    wi0 = (r - ho * s.Wo) * s.sw - s.pw;
    xim = x + (size_t)img * s.H * s.W * s.Ci;
  }
  // VEC: the (kh, kw, c) of the next K tile to load, the same in every
  // thread of the block
  int kh = 0, kw = 0, c0 = 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra, rb;
  if (VEC) {
    ra = gather4(xim, row_ok, hi0 + kh, wi0 + kw, c0 + a_k, s);
    c0 += BK;
    if (c0 == s.Ci) { c0 = 0; if (++kw == s.KW) { kw = 0; ++kh; } }
  } else {
    ra = gather1(xim, row_ok, hi0, wi0, a_k, s);
  }
  rb = load_w(w, b_k, gn_b, s);
  As[0][a_k + 0][a_r] = ra.x;
  As[0][a_k + 1][a_r] = ra.y;
  As[0][a_k + 2][a_r] = ra.z;
  As[0][a_k + 3][a_r] = ra.w;
  *reinterpret_cast<float4*>(&Bs[0][b_k][b_c]) = rb;
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < s.K; k0 += BK) {
    const bool more = k0 + BK < s.K;
    if (more) {  // the next tile's loads are in flight during the FMAs
      if (VEC) {
        ra = gather4(xim, row_ok, hi0 + kh, wi0 + kw, c0 + a_k, s);
        c0 += BK;
        if (c0 == s.Ci) { c0 = 0; if (++kw == s.KW) { kw = 0; ++kh; } }
      } else {
        ra = gather1(xim, row_ok, hi0, wi0, k0 + BK + a_k, s);
      }
      rb = load_w(w, k0 + BK + b_k, gn_b, s);
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

  if (partials) {
    // per-channel partials of this M tile from the raw accumulator:
    // each thread sums its valid rows, then thread c (c < 128) adds the
    // 16 row groups' sums of channel c and thread 128 + c their squares,
    // in a fixed order (the loop above ended on a barrier, so the tile
    // buffers are free)
    float* red_s = smem;             // [16][BN]
    float* red_q = smem + 16 * BN;   // [16][BN]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float sj = 0.f, qj = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
        if (gm < s.M) {
          sj += acc[i][j];
          qj = fmaf(acc[i][j], acc[i][j], qj);
        }
      }
      const int col = (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      red_s[ty * BN + col] = sj;
      red_q[ty * BN + col] = qj;
    }
    __syncthreads();
    const int col = tid % BN;
    const float* red = tid < BN ? red_s : red_q;
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) t += red[g * BN + col];
    if (n0 + col < s.Co)
      partials[((size_t)blockIdx.x * 2 + (tid < BN ? 0 : 1)) * s.Co + n0 +
               col] = t;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= s.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      if (gn >= s.Co) continue;
      float4 v = make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                             acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      const size_t off = (size_t)gm * s.Co + gn;
      if (a) {
        const float4 av = *reinterpret_cast<const float4*>(a + gn);
        const float4 bv = *reinterpret_cast<const float4*>(b + gn);
        v.x = v.x * av.x + bv.x;
        v.y = v.y * av.y + bv.y;
        v.z = v.z * av.z + bv.z;
        v.w = v.w * av.w + bv.w;
      }
      if (res) {
        const float4 r = *reinterpret_cast<const float4*>(res + off);
        v.x += r.x;
        v.y += r.y;
        v.z += r.z;
        v.w += r.w;
      }
      if (act) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f);
        v.w = fmaxf(v.w, 0.f);
      }
      *reinterpret_cast<float4*>(out + off) = v;
    }
  }
}

}  // namespace

// x [N, H, W, Ci], w [KH, KW, Ci, Co], out [N, Ho, Wo, Co]; a, b [Co] or
// both NULL; res [N, Ho, Wo, Co] or NULL; partials [ceil(M / 128), 2, Co]
// or NULL (M = N * Ho * Wo).  All float32, contiguous, 16-byte aligned.
// Co must be a multiple of 4.  act: 0 none, 1 relu.
extern "C" int conv_stage_f32(const float* x, const float* w, const float* a,
                              const float* b, const float* res, float* out,
                              float* partials, int N, int H, int W, int Ci,
                              int Co, int KH, int KW, int sh, int sw, int ph,
                              int pw, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  s.N = N; s.H = H; s.W = W; s.Ci = Ci; s.Co = Co; s.KH = KH; s.KW = KW;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  if (N <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || Co % 4 ||
      KH <= 0 || KW <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0 ||
      act < 0 || act > 1 || (a == nullptr) != (b == nullptr))
    return (int)cudaErrorInvalidValue;
  s.Ho = (H + 2 * ph - KH) / sh + 1;
  s.Wo = (W + 2 * pw - KW) / sw + 1;
  if (s.Ho <= 0 || s.Wo <= 0) return (int)cudaErrorInvalidValue;
  const long long m = (long long)N * s.Ho * s.Wo;
  const long long k = (long long)KH * KW * Ci;
  if (m > 0x7fffffffLL || k > 0x7fffffffLL || (Co + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  s.M = (int)m;
  s.K = (int)k;
  dim3 grid((s.M + BM - 1) / BM, (Co + BN - 1) / BN);
  if (Ci % 8 == 0)
    conv_stage_kernel<true><<<grid, NT, 0, st>>>(x, w, a, b, res, out,
                                                 partials, s, act);
  else
    conv_stage_kernel<false><<<grid, NT, 0, st>>>(x, w, a, b, res, out,
                                                  partials, s, act);
  return (int)cudaGetLastError();
}
