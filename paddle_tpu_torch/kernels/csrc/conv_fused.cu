// K6: the ResNet conv stage -- an NHWC x HWIO convolution in float32 with
// a fused epilogue, as an implicit GEMM on the split-TF32 tensor-core
// tile of gemm_tile.cuh.
//
// Replaces the TPU kernel paddle_tpu/kernels/conv_fused.py
// _conv_stage_kernel (launched by conv2d_nhwc): x f32 [N, H, W, Ci] (NHWC)
// convolved with w f32 [KH, KW, Ci, Co] (HWIO) at stride (sh, sw) and
// zero padding (ph, pw) into an f32 accumulator, then, from the
// accumulator and in this order:
//   stats    per-channel partial (sum acc, sum acc^2), written per
//            `rows` output pixels (an M tile, or a wgmma warpgroup's 64
//            rows) to partials [ceil(M / rows), 2, Co] before any other
//            epilogue (the wrapper reduces them in a fixed order:
//            deterministic, no atomics; conv_stage_tile gives rows);
//   affine   y = acc * a[c] + b[c] (the test-mode BatchNorm fold);
//   residual y += r;
//   act      relu.
//
// The product: M = N * Ho * Wo output pixels, GEMM-N = Co, K = KH * KW *
// Ci in (kh, kw, ci) order, which is HWIO's row order, so the filter as
// stored is the row-major [K, Co] W operand that gemm_tile.cuh's F32W
// load reads.  The products run in split-TF32 on mma.sync (three TF32
// MMAs a product, each 32-deep K tile in a fresh fragment added in
// float32: float32's accuracy at K = 4608, tf32_mma.cuh).
//
// What bounds K6 on the H100, at ResNet-50's 20 stage shapes at batch
// 256: the 3x3 stages and the stem by their operations (120..1100 FLOPs
// a byte; 164.9 TFLOP/s for f32-accurate products, where the f32 FMA
// pipes give 67); the 1x1 stages with K = 64 by their bytes (the output
// is most of them: (56, 64, 256, 1x1) writes 822 MB, 0.25 ms at
// 3.35 TB/s); the other 1x1 stages by both about equally.
//
// Design.  The Pallas kernel runs one image a grid step over an input
// padded in HBM.  Here the tile's mainloop is K4's and K8's; only the A
// operand and the epilogue are K6's own (gemm_tile.cuh's policies):
// - ConvA gathers A straight from NHWC x: no im2col buffer, no padded
//   copy.  Once a block it writes each of its BM rows' (offset of x at
//   the top-left tap from the block's first image, hi0, wi0) into a
//   table in shared memory (a thread copies for 8 rows, too many to
//   hold in registers beside the accumulators); a copy is then one
//   16-byte table read, two bounds checks and a 32-bit offset.  A thread's K column lies in one tap (kh, kw): with
//   Ci % 4 == 0 its 4 channels are one 16-byte cp.async, else one
//   4-byte one a channel (the stem, Ci = 3).  Each K tile the thread
//   steps its (kh, kw, ci) by BK, so the K loop has no integer divide.
//   Padding, the ragged M edge and k >= K are cp.async's zero fill.
//   M tiles run across image boundaries, so the 7 x 7 stages fill them.
// - ConvEpi runs from the accumulator fragments: the statistics of the
//   raw accumulator over the tile's valid rows, summed in one fixed
//   order (a thread's own rows, then the 8 row groups of a fragment by
//   __shfl_xor over lane bits 2..4, then the WM warps along M through
//   shared memory), then affine, residual (every load issued before the
//   first store), relu and the float2 store.
// Form (conv_stage_tile): the tile's Large (128 x 64, 4 warps, two
// blocks an SM), which gives every one of the 20 shapes at batch 256 at
// least 784 blocks and the Co = 64 stages a full tile.  It was the
// fastest at all 20 (tools/gemm_forms.py --k6 times Large, Small and an
// 8-warp 128 x 128 there, and the stem also with x padded to Ci = 4 for
// the 16-byte gather, which lost).  Co must be a
// multiple of 4 (16-byte copies of w, float2 epilogue accesses); any N,
// H, W, Ci, kernel size, stride and padding.
//
// The bf16 form (conv_stage_bf16; the fused ResNet step under AMP, where
// the reference kernel takes bf16 x and w).  x, w, res and out are
// bf16; the statistics are still taken from the f32 accumulator before
// any rounding (as the reference does), a, b stay f32, and each output
// is rounded once to bf16 after the f32 epilogue.  Co must be a
// multiple of 8 (TMA's 16-byte rows, 4-byte bf16 pairs).  Two forms, by
// a rule of the launcher (bf16_form):
// - Ci % 8 == 0 (every stage but the stem): the wgmma tile of
//   wgmma_gemm.cuh (K4's bf16 mainloop: a producer warpgroup, a ring of
//   64-deep K tiles, two consumer warpgroups on wgmma, every 4 K tiles'
//   products added in f32, a persistent grid), with two policies of its
//   own.  Im2colLoad loads A by TMA's im2col mode straight from NHWC x:
//   K tile kt is tap (kh, kw) = kt / ceil(Ci / 64) and channels c0 ..
//   c0 + 63, c0 = 64 (kt mod ceil(Ci / 64)); its box is the tile's 128
//   output pixels' input pixels at that tap, walked from the first
//   pixel's top-left tap (wo sw - pw, ho sh - ph, n) through the
//   bounding box of top-left taps by the strides, across rows and
//   images, padding and channels past Ci read as zeros -- the 128 x 128
//   byte, 128B-swizzled K-major A box K4 reads.  W [KH KW, Ci, Co] by a
//   rank-3 map in boxes of 64 ci x 64 co of one tap (channels past Ci
//   zero, never the next tap's), MN-major as K4's W.  ConvWgEpi is
//   ConvEpi's arithmetic in wgmma's accumulator layout: each warpgroup's
//   statistics of its 64 rows (one row of partials each, so the two
//   never wait for each other), then affine, residual, relu, one
//   rounding into the swizzled out tile and a TMA store.  BN = 128 for
//   Co >= 128, BN = 64 (m64n64k16) below: the Co = 64 stages fill the
//   tile.  TMA takes a rank-4 map's box corners in [-128, 127] and
//   element strides up to 8, so this form takes strides <= 8 and
//   paddings and kernels whose corners fit.  At the 20 shapes at batch
//   256 the bf16 products bound the 3x3 stages (989.4 TFLOP/s dense) and
//   the bytes the 1x1 stages with K <= 256 (the output is most of them);
//   the persistent tile overlaps one tile's epilogue with the next
//   tile's first products and the producer's loads.
// - Ci % 8 != 0 (the stem's Ci = 3, which the wrapper pads to 4: TMA
//   needs 16-byte pixel rows): gemm_tile.cuh's bf16_kernel, one
//   mma.sync.m16n8k16 bf16 MMA a product on the 128 x 64 tile, ConvA's
//   gather of 4 channels an 8-byte cp.async, and ConvEpi.  Padding the
//   stem to 8 channels for the wgmma form would make each tap a 64-deep
//   K tile with 8 real channels: 8x the products.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "wgmma_gemm.cuh"

namespace {

using gemm::ArgsT;
using gemm::bf16;

// x [N, H, W, Ci], w [KH, KW, Ci, Co], out [N, Ho, Wo, Co]
struct Shape {
  int H, W, Ci, KH, KW, sh, sw, ph, pw, Ho, Wo;
};

// The A policy of K6: row m of A is output pixel (n, ho, wo), column k
// is tap (kh, kw) and channel ci, k = (kh * KW + kw) * Ci + ci, and
// A[m, k] = x[n, ho * sh - ph + kh, wo * sw - pw + kw, ci], zero outside
// the image.  T: x's type (float, bf16).  CB: the bytes of one copy
// (cp.async of 16, 8 or 4), E = CB / sizeof(T) channels; Ci must be a
// multiple of E.  (f32: ConvA<16> and ConvA<4>; bf16: ConvA<8, bf16>.)
template <int CB, class T = float>
struct ConvA {
  using Params = Shape;
  // a row of the block's table: x's offset at (n, hi0, wi0, 0) from the
  // block's base (its first row's image; make_call bounds the span),
  // and the top-left tap's input position (hi0, wi0)
  template <class C>
  static constexpr int smem_bytes = C::BM * (int)sizeof(int4);
  static constexpr int E = CB / (int)sizeof(T);   // channels a copy
  static_assert(CB == 16 || CB == 8 || CB == 4, "cp.async sizes");
  static_assert(E >= 1, "a copy holds a channel");

  const int4* rows;
  const T* base;       // x at the block's first image
  int kh, kw, ci;      // this thread's column in the next K tile

  // one grid dimension (M can pass 65535 tiles), N tiles innermost
  template <class C, class A>
  static bool grid(const A& a, dim3& g) {
    const long long b = ((long long)a.M + C::BM - 1) / C::BM *
                        ((a.N + C::BN - 1) / C::BN);
    g = dim3((unsigned)b);
    return b <= 0x7fffffffLL;
  }
  template <class C, class A>
  __device__ __forceinline__ static void tile(const A& a, int& m0,
                                              int& n0) {
    const int ntn = (a.N + C::BN - 1) / C::BN;
    const int bm = blockIdx.x / ntn;
    m0 = bm * C::BM;
    n0 = (blockIdx.x - bm * ntn) * C::BN;
  }

  template <class C, class A>
  __device__ __forceinline__ void init(const A& a, const Shape& s,
                                       char* tab, int m0) {
    int4* r = reinterpret_cast<int4*>(tab);
    const int hw = s.Ho * s.Wo, img0 = m0 / hw;
    for (int i = threadIdx.x; i < C::BM; i += C::NT) {
      const int gm = m0 + i;
      int4 e = make_int4(0, -0x40000000, 0, 0);   // past M: no tap inside
      if (gm < a.M) {
        const int img = gm / hw, p = gm - img * hw, ho = p / s.Wo;
        e.y = ho * s.sh - s.ph;
        e.z = (p - ho * s.Wo) * s.sw - s.pw;
        e.x = (((img - img0) * s.H + e.y) * s.W + e.z) * s.Ci;
      }
      r[i] = e;
    }
    rows = r;
    base = a.x + (size_t)img0 * s.H * s.W * s.Ci;
    // this thread's column of the first K tile; the only divides
    const int k = E * (threadIdx.x % (C::BK / E));
    const int tap = k / s.Ci;
    ci = k - tap * s.Ci;
    kh = tap / s.KW;
    kw = tap - kh * s.KW;
    __syncthreads();   // the table is read by other threads' copies
  }

  template <class C, class A>
  __device__ __forceinline__ void load(T* dst, const A&, const Shape& s,
                                       int, int) {
    constexpr int CPR = C::BK / E, N_CH = C::BM * CPR;
    static_assert(N_CH % C::NT == 0 && C::NT % CPR == 0,
                  "A copies must split evenly, one column a thread");
    const int c = threadIdx.x % CPR;
    const int hk = kh < s.KH ? kh : -0x40000000;   // k >= K: no row inside
    const int tap = (kh * s.W + kw) * s.Ci + ci;   // from a row's offset
#pragma unroll
    for (int it = 0; it < N_CH / C::NT; ++it) {
      const int r = threadIdx.x / CPR + it * (C::NT / CPR);
      const int4 e = rows[r];   // (offset, hi0, wi0)
      const bool ok = (unsigned)(e.y + hk) < (unsigned)s.H &&
                      (unsigned)(e.z + kw) < (unsigned)s.W;
      const T* src = base + (ok ? e.x + tap : 0);
      if constexpr (CB == 16)
        tc::cp16(dst + r * C::AS + E * c, src, ok);
      else if constexpr (CB == 8)
        tc::cp8(dst + r * C::AS + E * c, src, ok);
      else
        tc::cp4(dst + r * C::AS + E * c, src, ok);
    }
    ci += C::BK;   // the next K tile's column
    while (ci >= s.Ci) {
      ci -= s.Ci;
      if (++kw == s.KW) {
        kw = 0;
        ++kh;
      }
    }
  }
};

// two adjacent outputs as float2, from float or bf16
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// ... stored as float, or rounded once to bf16
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The epilogue of K6, from the accumulator fragments (element e of
// fragment (i, j) holds row 16 i + g + 8 (e / 2), column 8 j + 2 t +
// e % 2 of the warp tile), for float or bf16 res and out.
struct ConvEpi {
  struct Params {
    const float* scale;   // affine a [Co] or NULL
    const float* shift;   // affine b [Co], with scale
    float* partials;      // [ceil(M / BM), 2, Co] or NULL
  };

  // per-channel (sum, sum of squares) of the raw accumulator over the
  // tile's valid rows, into partials row m0 / BM
  template <class C, class A>
  __device__ __forceinline__ static void stats(
      const float (&acc)[C::MI][C::NI][4], const A& a, const Params& p,
      char* smem, int m0, int n0) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4, wm = warp / C::WN;
    const int wm0 = wm * C::WTM, wn0 = (warp % C::WN) * C::WTN;
    float s[C::NI][2], q[C::NI][2];
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
      s[j][0] = s[j][1] = q[j][0] = q[j][1] = 0.f;
    // my rows, g + 8 r in order (rows past M hold 0 and add nothing)
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = m0 + wm0 + 16 * i + g + 8 * h < a.M;
#pragma unroll
        for (int j = 0; j < C::NI; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = ok ? acc[i][j][2 * h + e] : 0.f;
            s[j][e] += v;
            q[j][e] = fmaf(v, v, q[j][e]);
          }
      }
    // the 8 row groups of the warp tile (lane bits 2..4), pairwise
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
          q[j][e] += __shfl_xor_sync(0xffffffffu, q[j][e], off);
        }
    // the WM warps along M, in order, through the stages' memory (free
    // once every copy has landed and every warp has left the mainloop)
    tc::cp_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);   // [WM][2][BN]
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn0 + 8 * j + 2 * t + e;
          red[(2 * wm) * C::BN + col] = s[j][e];
          red[(2 * wm + 1) * C::BN + col] = q[j][e];
        }
    }
    __syncthreads();
    const size_t row = (size_t)(m0 / C::BM) * 2;
    for (int i = threadIdx.x; i < 2 * C::BN; i += C::NT) {
      const int which = i / C::BN, col = i - which * C::BN;
      float v = 0.f;
#pragma unroll
      for (int m = 0; m < C::WM; ++m) v += red[(2 * m + which) * C::BN + col];
      if (n0 + col < a.N) p.partials[(row + which) * a.N + n0 + col] = v;
    }
  }

  template <class C, bool VEC, class A>
  __device__ __forceinline__ static void apply(
      const float (&acc)[C::MI][C::NI][4], const A& a, const Params& p,
      char* smem, int m0, int n0) {
    static_assert(VEC, "K6 takes Co % 4 == 0");
    if (p.partials) stats<C>(acc, a, p, smem, m0, n0);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int wm0 = (warp / C::WN) * C::WTM, wn0 = (warp % C::WN) * C::WTN;
    auto row = [&](int i, int h) { return m0 + wm0 + 16 * i + g + 8 * h; };
    auto col = [&](int j) { return n0 + wn0 + 8 * j + 2 * t; };   // + 1 < N
    float y[C::MI][C::NI][4];
#pragma unroll
    for (int j = 0; j < C::NI; ++j) {
      float2 sc = make_float2(1.f, 1.f), sh = make_float2(0.f, 0.f);
      if (p.scale && col(j) < a.N) {
        sc = __ldg(reinterpret_cast<const float2*>(p.scale + col(j)));
        sh = __ldg(reinterpret_cast<const float2*>(p.shift + col(j)));
      }
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[i][j][e] = p.scale ? acc[i][j][e] * (e & 1 ? sc.y : sc.x) +
                                     (e & 1 ? sh.y : sh.x)
                               : acc[i][j][e];
    }
    // every residual load before the first store: res and out may
    // alias, so a load after a store would wait for it
    if (a.res) {
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int i = 0; i < C::MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (row(i, h) >= a.M || col(j) >= a.N) continue;
            const float2 r = load2(a.res + (size_t)row(i, h) * a.N +
                                   col(j));
            y[i][j][2 * h] += r.x;
            y[i][j][2 * h + 1] += r.y;
          }
    }
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row(i, h) >= a.M || col(j) >= a.N) continue;
          float v0 = y[i][j][2 * h], v1 = y[i][j][2 * h + 1];
          if (a.act) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          store2(a.out + (size_t)row(i, h) * a.N + col(j), v0, v1);
        }
  }
};

// ------------------------------------------------------ the wgmma form

// The wgmma form's operands beyond its tensor maps
struct ConvWg {
  const float* scale;   // affine a [Co] or NULL
  const float* shift;   // affine b [Co], with scale
  const bf16* res;      // [M, Co] or NULL
  float* partials;      // [ceil(M / 64), 2, Co] or NULL
  int M, N, nk;         // output pixels, Co, K tiles a tile
  int cit, KW;          // K tiles a tap (ceil(Ci / 64)), filter width
  int Ho, Wo, sh, sw, ph, pw, act;
};

// A by TMA's im2col mode, W by its rank-3 map (header)
template <class C>
struct Im2colLoad {
  const CUtensorMap* tx;
  const CUtensorMap* tw;
  const ConvWg* p;
  int n, h, w;   // the tile's first pixel: image, top-left tap

  __device__ __forceinline__ void start(int m0) {
    const int hw = p->Ho * p->Wo;
    n = m0 / hw;
    const int q = m0 - n * hw, ho = q / p->Wo;
    h = ho * p->sh - p->ph;
    w = (q - ho * p->Wo) * p->sw - p->pw;
  }
  __device__ __forceinline__ void load(uint8_t* st, uint64_t* bar, int n0,
                                       int kt) const {
    const int tap = kt / p->cit, c0 = (kt - tap * p->cit) * C::BK;
    const int kh = tap / p->KW, kw = tap - kh * p->KW;
    wg::tma_load_im2col(st, tx, bar, c0, w, h, n, (uint16_t)kw,
                        (uint16_t)kh);
#pragma unroll
    for (int i = 0; i < C::BN / 64; ++i)
      wg::tma_load(st + C::A_BYTES + i * C::B_BOX, tw, bar, n0 + 64 * i, c0,
                   tap);
  }
};

// ConvEpi's arithmetic on a warpgroup's m64nBN accumulator: rows r0 ..
// r0 + 63 of the output (warp w of the warpgroup rows 16 w + g, + 8;
// register 4 j + 2 h + c column 8 j + 2 t + c), columns n0 .. n0 + BN - 1
template <class C>
struct ConvWgEpi {
  const ConvWg* p;
  const CUtensorMap* tout;

  __device__ __forceinline__ void begin(int) {}

  // per-channel (sum, sum of squares) of the raw accumulator over the
  // warpgroup's rows below M, into partials row r0 / 64: a thread's 2
  // rows, then the 8 row groups of a warp (lane bits 4, 3, 2) by a
  // reduce-scatter -- at each bit the pair of lanes splits its live
  // values in halves, each keeps one and adds its partner's, so 7 BN / 16
  // shuffles a thread where a full butterfly takes 3 BN / 2 -- then the 4
  // warps in order through `red` (the pre tile's memory, which K6 does
  // not store).  Each sum is one fixed tree whatever the grid.
  __device__ __forceinline__ void stats(const float (&acc)[C::BN / 2],
                                        float* red, int r0, int n0,
                                        int bar_id) const {
    static_assert(8 * C::BN * 4 <= C::OUT / C::NWG, "red fits the pre tile");
    constexpr int NV = C::BN / 4;   // (column, e) pairs a thread holds
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int wr = (threadIdx.x / 32) % 4, rw = 16 * wr + lane / 4;
    const bool ok0 = r0 + rw < p->M, ok1 = r0 + rw + 8 < p->M;
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    // lane bit 4: the sums stay with b4 = 0, the squares with b4 = 1;
    // v[o] is then column 8 (o / 2) + 2 t + o % 2's
    float v[NV];
#pragma unroll
    for (int o = 0; o < NV; ++o) {
      const float a0 = ok0 ? acc[4 * (o / 2) + o % 2] : 0.f;
      const float a1 = ok1 ? acc[4 * (o / 2) + 2 + o % 2] : 0.f;
      const float sum = a0 + a1, sq = fmaf(a1, a1, a0 * a0);
      v[o] = (b4 ? sq : sum) +
             __shfl_xor_sync(0xffffffffu, b4 ? sum : sq, 16);
    }
    // lane bits 3 and 2: keep the upper half of v with the bit set
#pragma unroll
    for (int o = 0; o < NV / 2; ++o)
      v[o] = (b3 ? v[o + NV / 2] : v[o]) +
             __shfl_xor_sync(0xffffffffu, b3 ? v[o] : v[o + NV / 2], 8);
#pragma unroll
    for (int o = 0; o < NV / 4; ++o)
      v[o] = (b2 ? v[o + NV / 4] : v[o]) +
             __shfl_xor_sync(0xffffffffu, b2 ? v[o] : v[o + NV / 4], 4);
    // v[i] is now pair o = (b3 NV / 2 + b2 NV / 4 + i) of the warp's
    // sums (b4 = 0) or squares (b4 = 1)
#pragma unroll
    for (int i = 0; i < NV / 4; ++i) {
      const int o = (b3 ? NV / 2 : 0) + (b2 ? NV / 4 : 0) + i;
      red[(2 * wr + (b4 ? 1 : 0)) * C::BN + 8 * (o / 2) + 2 * t + o % 2] =
          v[i];
    }
    wg::bar_sync(bar_id, 128);
    if (r0 >= p->M) return;   // a half-tile wholly past M has no row
    const size_t row = (size_t)(r0 / 64) * 2;
    for (int i = threadIdx.x % 128; i < 2 * C::BN; i += 128) {
      const int which = i / C::BN, col = i - which * C::BN;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) sum += red[(2 * m + which) * C::BN + col];
      if (n0 + col < p->N) p->partials[(row + which) * p->N + n0 + col] = sum;
    }
  }

  __device__ __forceinline__ void apply(float (&acc)[C::BN / 2], uint8_t* so,
                                        uint8_t* sp, int r0, int n0,
                                        int bar_id, bool lead) const {
    constexpr int NJ = C::BN / 8;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int rw = 16 * ((threadIdx.x / 32) % 4) + g;
    if (p->partials) stats(acc, reinterpret_cast<float*>(sp), r0, n0, bar_id);
    if (p->scale) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int gn = n0 + 8 * j + 2 * t;   // Co % 8 == 0: gn + 1 < Co too
        float2 sc = make_float2(1.f, 1.f), sh = make_float2(0.f, 0.f);
        if (gn < p->N) {
          sc = __ldg(reinterpret_cast<const float2*>(p->scale + gn));
          sh = __ldg(reinterpret_cast<const float2*>(p->shift + gn));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * j + e] = acc[4 * j + e] * (e % 2 ? sc.y : sc.x) +
                           (e % 2 ? sh.y : sh.x);
      }
    }
    if (p->res) {   // every load issued before the first store
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gn = n0 + 8 * j + 2 * t, gm = r0 + rw + 8 * h;
          unsigned r = 0u;
          if (gn < p->N && gm < p->M)
            r = __ldg(reinterpret_cast<const unsigned*>(
                p->res + (size_t)gm * p->N + gn));
          const float2 rf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&r));
          acc[4 * j + 2 * h] += rf.x;
          acc[4 * j + 2 * h + 1] += rf.y;
        }
    }
    if (p->act) {
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) acc[i] = fmaxf(acc[i], 0.f);
    }
    if (lead) wg::store_wait_read();   // the last tile's store read so
    wg::bar_sync(bar_id, 128);
    wg::store_tile<C>(acc, so);
    wg::fence_async_smem();
    wg::bar_sync(bar_id, 128);
    if (lead) {
#pragma unroll
      for (int b = 0; b < C::BN / 64; ++b)
        wg::tma_store(tout, so + b * C::OUT_BOX, n0 + 64 * b, r0);
      wg::store_commit();
    }
  }
};

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tout,
                  const __grid_constant__ ConvWg p) {
  Im2colLoad<C> prod{&tx, &tw, &p, 0, 0, 0};
  ConvWgEpi<C> epi{&p, &tout};
  wg::run<C>(prod, epi, p.M, p.N, p.nk);
}

// the forms: 5 stages of 128 x 128 (K4's), 8 of 128 x 64
using ConvWide = wg::GemmTile<5, 4, 128>;
using ConvNarrow = wg::GemmTile<8, 4, 64>;

// One launch's operands, checked; T: x, w, res and out's type.
template <class T>
struct Call {
  ArgsT<T> a;
  Shape s;
  ConvEpi::Params p;
};

// K6's bf16 form for a shape (header): the wgmma tile when TMA can map
// x's pixel rows (Ci % 8 == 0), 128 x 128 for Co >= 128 and 128 x 64
// below; else the mma.sync tile
enum class Bf16Form { MMA_SYNC, WGMMA_WIDE, WGMMA_NARROW };

inline Bf16Form bf16_form(int Ci, int Co) {
  if (Ci % 8) return Bf16Form::MMA_SYNC;
  return Co >= 128 ? Bf16Form::WGMMA_WIDE : Bf16Form::WGMMA_NARROW;
}

// Fill `c`; cudaErrorInvalidValue for what K6 does not take (Co a
// multiple of 4; in bf16 Co a multiple of 8 and Ci of 4).
template <class T>
cudaError_t make_call(Call<T>& c, const T* x, const T* w,
                      const float* scale, const float* shift, const T* res,
                      T* out, float* partials, int N, int H, int W, int Ci,
                      int Co, int KH, int KW, int sh, int sw, int ph,
                      int pw, int act) {
  if (N <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
      Co % (16 / (int)sizeof(T)) || (sizeof(T) == 2 && Ci % 4) ||
      KH <= 0 || KW <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0 ||
      act < 0 || act > 1 || (scale == nullptr) != (shift == nullptr))
    return cudaErrorInvalidValue;
  const int Ho = (H + 2 * ph - KH) / sh + 1, Wo = (W + 2 * pw - KW) / sw + 1;
  if (Ho <= 0 || Wo <= 0) return cudaErrorInvalidValue;
  const long long m = (long long)N * Ho * Wo;
  const long long k = (long long)KH * KW * Ci;
  if (m > 0x7fffffffLL || k > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the gather forms' offsets into x are 32-bit from a block's first
  // row's image: its rows span at most (BM - 1) / (Ho Wo) + 2 images, and
  // a tap adds (kh W + kw) Ci + ci (TMA's coordinates are int32 a
  // dimension, and N, H, W and Ci are ints; bf16_im2col_map checks the
  // wgmma form's corners and strides)
  const long long span =
      ((gemm::Large::BM - 1) / ((long long)Ho * Wo) + 2) * H * W * Ci +
      ((long long)KH * W + KW) * Ci;
  if ((sizeof(T) == 4 || bf16_form(Ci, Co) == Bf16Form::MMA_SYNC) &&
      span > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  c.a = ArgsT<T>{x, w, nullptr, nullptr, res, out, nullptr, (int)m, Co,
                 (int)k, 0, act};
  c.s = Shape{H, W, Ci, KH, KW, sh, sw, ph, pw, Ho, Wo};
  c.p = ConvEpi::Params{scale, shift, partials};
  return cudaSuccess;
}

template <class C>
cudaError_t launch_form(const Call<float>& c, cudaStream_t st) {
  using gemm::F32W;
  if (c.s.Ci % 4 == 0)
    return gemm::launch<C, F32W, true, ConvA<16>, ConvEpi>(c.a, st, c.s,
                                                           c.p);
  return gemm::launch<C, F32W, true, ConvA<4>, ConvEpi>(c.a, st, c.s, c.p);
}

// One launch of the wgmma form C: x's im2col map, W's rank-3 map, out's
// 2-D map, then a persistent grid (`cap` blocks at most if cap > 0)
template <class C>
cudaError_t launch_wgmma(const Call<bf16>& c, cudaStream_t st, int cap) {
  const Shape& s = c.s;
  const int M = c.a.M, Co = c.a.N;
  const int N = M / (s.Ho * s.Wo), cit = (s.Ci + C::BK - 1) / C::BK;
  CUtensorMap tx, tw, tout;
  const cuuint64_t xd[4] = {(cuuint64_t)s.Ci, (cuuint64_t)s.W,
                            (cuuint64_t)s.H, (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)s.Ci * 2, (cuuint64_t)s.W * s.Ci * 2,
                            (cuuint64_t)s.H * s.W * s.Ci * 2};
  const int lower[2] = {-s.pw, -s.ph};
  const int upper[2] = {s.pw - (s.KW - 1), s.ph - (s.KH - 1)};
  const cuuint32_t es[4] = {1, (cuuint32_t)s.sw, (cuuint32_t)s.sh, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)Co, (cuuint64_t)s.Ci,
                            (cuuint64_t)s.KH * s.KW};
  const cuuint64_t ws[2] = {(cuuint64_t)Co * 2, (cuuint64_t)s.Ci * Co * 2};
  const cuuint32_t wb[3] = {64, C::BK, 1};
  const cuuint64_t od[2] = {(cuuint64_t)Co, (cuuint64_t)M};
  const cuuint64_t os[1] = {(cuuint64_t)Co * 2};
  const cuuint32_t ob[2] = {64, 64};
  cudaError_t err = wg::bf16_im2col_map(&tx, c.a.x, xd, xs, lower, upper,
                                        C::BK, C::BM, es);
  if (err == cudaSuccess) err = wg::bf16_map(&tw, c.a.w, 3, wd, ws, wb);
  if (err == cudaSuccess) err = wg::bf16_map(&tout, c.a.out, 2, od, os, ob);
  if (err != cudaSuccess) return err;
  const ConvWg p{c.p.scale, c.p.shift, c.a.res, c.p.partials,
                 M, Co, s.KH * s.KW * cit, cit, s.KW, s.Ho, s.Wo,
                 s.sh, s.sw, s.ph, s.pw, c.a.act};
  err = cudaFuncSetAttribute(conv_wgmma_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::bytes);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = wg::persistent_grid<C>(M, Co, cap, &grid);
  if (err != cudaSuccess) return err;
  conv_wgmma_kernel<C><<<grid, C::NT, C::bytes, st>>>(tx, tw, tout, p);
  return cudaGetLastError();
}

cudaError_t launch_stage_bf16(const Call<bf16>& c, cudaStream_t st,
                              int cap) {
  switch (bf16_form(c.s.Ci, c.a.N)) {
    case Bf16Form::WGMMA_WIDE:
      return launch_wgmma<ConvWide>(c, st, cap);
    case Bf16Form::WGMMA_NARROW:
      return launch_wgmma<ConvNarrow>(c, st, cap);
    default:
      return gemm::launch_bf16<gemm::Large, ConvA<8, bf16>, ConvEpi>(
          c.a, st, c.s, c.p);
  }
}

}  // namespace

// x [N, H, W, Ci], w [KH, KW, Ci, Co], out [N, Ho, Wo, Co]; a, b [Co] or
// both NULL; res [N, Ho, Wo, Co] or NULL; partials [rows, 2, Co] or NULL
// (rows from conv_stage_tile).  All float32, contiguous, 16-byte
// aligned.  Co must be a multiple of 4.  act: 0 none, 1 relu.
extern "C" int conv_stage_f32(const float* x, const float* w, const float* a,
                              const float* b, const float* res, float* out,
                              float* partials, int N, int H, int W, int Ci,
                              int Co, int KH, int KW, int sh, int sw, int ph,
                              int pw, int act, void* stream) {
  Call<float> c;
  const cudaError_t err = make_call(c, x, w, a, b, res, out, partials, N, H,
                                    W, Ci, Co, KH, KW, sh, sw, ph, pw, act);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_form<gemm::Large>(c, static_cast<cudaStream_t>(stream));
}

// The bf16 form: x, w, res and out bf16 (a, b and partials float32);
// Co must be a multiple of 8 and Ci of 4.  Otherwise as conv_stage_f32,
// on the form bf16_form picks (conv_stage_tile names it and its rows
// of partials).
extern "C" int conv_stage_bf16(const bf16* x, const bf16* w, const float* a,
                               const float* b, const bf16* res, bf16* out,
                               float* partials, int N, int H, int W, int Ci,
                               int Co, int KH, int KW, int sh, int sw,
                               int ph, int pw, int act, void* stream) {
  Call<bf16> c;
  const cudaError_t err = make_call(c, x, w, a, b, res, out, partials, N, H,
                                    W, Ci, Co, KH, KW, sh, sw, ph, pw, act);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stage_bf16(c, static_cast<cudaStream_t>(stream), 0);
}

// conv_stage_bf16 on a grid of at most `blocks` blocks (the wgmma form;
// the mma.sync form's grid is its tiles'): for a test that the grid
// changes no sum
extern "C" int conv_stage_bf16_capped(const bf16* x, const bf16* w,
                                      const float* a, const float* b,
                                      const bf16* res, bf16* out,
                                      float* partials, int N, int H, int W,
                                      int Ci, int Co, int KH, int KW, int sh,
                                      int sw, int ph, int pw, int act,
                                      int blocks, void* stream) {
  Call<bf16> c;
  const cudaError_t err = make_call(c, x, w, a, b, res, out, partials, N, H,
                                    W, Ci, Co, KH, KW, sh, sw, ph, pw, act);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stage_bf16(c, static_cast<cudaStream_t>(stream), blocks);
}

// The form conv_stage_f32 (is_bf16 = 0) or conv_stage_bf16 (1) runs
// for Ci and Co channels: its output tile (bm, bn), the output pixels
// of one row of statistics partials (rows: 128 on the mma.sync tiles, a
// warpgroup's 64 on the wgmma tile), and whether it is the wgmma form.
extern "C" int conv_stage_tile(int Ci, int Co, int is_bf16, int* bm, int* bn,
                               int* rows, int* wgmma) {
  if (Ci <= 0 || Co <= 0) return (int)cudaErrorInvalidValue;
  const Bf16Form f = is_bf16 ? bf16_form(Ci, Co) : Bf16Form::MMA_SYNC;
  *wgmma = f != Bf16Form::MMA_SYNC;
  *bm = *wgmma ? ConvWide::BM : gemm::Large::BM;
  *bn = f == Bf16Form::WGMMA_WIDE     ? ConvWide::BN
        : f == Bf16Form::WGMMA_NARROW ? ConvNarrow::BN
                                      : gemm::Large::BN;
  *rows = *wgmma ? 64 : gemm::Large::BM;
  return 0;
}
