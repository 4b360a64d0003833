// The GEMM tile shared by K4 (matmul_fused.cu), K8's prefill form
// (matmul_int8.cu) and K6 (conv_fused.cu): out = epilogue(A @ W) in
// float32, the products in split-TF32 on the tensor cores
// (tf32_mma.cuh); and its bf16 form (bf16_kernel, at the end: K6 under
// AMP), bf16 A and W with one bf16 MMA a product into float32
// (bf16_mma.cuh).  K4's bf16 form runs wgmma_gemm.cuh's tile, with
// GemmEpi's arithmetic.
//
// Three policies make a kernel of the one mainloop:
// - the W policy: F32W, f32 weights, split like A, three MMAs a
//   product (mma3); Int8W, int8 weights with one f32 scale per
//   (K-chunk, column): the int8 values are exact in TF32, so two MMAs a
//   product (a_lo q + a_hi q), and the scale multiplies each K tile's
//   partial sum, acc += s[c, n] * sum_{k in tile} a_k q_kn -- the
//   dequantized product's sum in another order.  A K tile lies inside
//   one chunk.  W is [K, N] row-major either way.
// - the A policy, which fills a tile's A rows: DenseA copies rows of
//   x [M, K] (K4, K8; float); K6's ConvA gathers them from an
//   NHWC image.
// - the epilogue policy, which runs from the accumulator registers:
//   GemmEpi is + bias, the optional pre-activation store (K4's `pre`),
//   act ('' / relu / tanh-gelu), + residual, the store, all in float32
//   from the accumulator (bias and residual widened from bf16 in the
//   bf16 form, pre and out rounded to bf16 once each); K6 has ConvEpi.
//
// A block owns a BM x BN output tile and loops over K in 32-deep tiles;
// nothing carries between blocks and there are no atomics, so every
// element is summed in one fixed order, whatever M is and whichever
// form runs.  The block's warps form a WM x WN grid, each owning a
// (BM / WM) x (BN / WN) warp tile of m16n8k8 fragments.  Blocks are
// numbered along N first, so the blocks that share an A tile run
// together and find it in L2.
//
// Pipeline: STAGES shared-memory stages filled by cp.async (16-byte
// copies, zero-filled past the ragged M, N and K edges; 4-byte copies
// where rows are not 16-byte aligned), one barrier a K tile.  The
// operands stay raw in shared memory and each fragment splits in
// registers as it is loaded (cvt.rna + FSUB an element): a split kept
// in shared memory would double the fragment loads, and shared-memory
// bandwidth is what the MMAs compete with.  (flash_bwd.cu's truncating
// split, one LOP for the cvt, measured slower here in the 128-row
// forms.)  int8 W is
// converted to f32 once when it lands, by the threads that copied it,
// into one of two slots (two, so converting tile kt + 1 never
// overwrites what a slower warp still reads of tile kt).
//
// Accuracy: each K tile's products sum in a fresh fragment (8 or 12
// MMAs), added to the running accumulator by a float32 add (int8: a
// float32 FMA with the scale), so the tensor cores' truncating
// accumulation never runs over a long sum (tf32_mma.cuh).
//
// Fragments: a contraction may visit its index in any order as long as
// both operands agree; here A-fragment column t holds k = 2t and t + 4
// holds 2t + 1, so each A fragment is two float2 loads.  A rows are
// padded to BK + 8 floats (float2 loads on distinct banks), W rows to
// BN + 4 (the B fragment's scalar loads on distinct banks).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace gemm {

using namespace tc;

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  if (act == ACT_GELU)
    return 0.5f * y *
           (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
  return y;
}

using bf16 = __nv_bfloat16;

// One launch: out [M, N] = epilogue(A [M, K] @ W [K, N]), A's rows
// read from x by the A policy; T is the type of x, bias, res, pre and
// out (float, or bf16 in the bf16 form).
template <class T>
struct ArgsT {
  const T* x;           // DenseA: [M, K]; ConvA: the NHWC image
  const void* w;        // float [K, N] (F32W), int8_t (Int8W), bf16
  const float* scales;  // Int8W: [K / chunk, N]
  const T* bias;        // [N] or NULL
  const T* res;         // [M, N] or NULL
  T* out;
  T* pre;               // [M, N] or NULL: x @ W + bias
  int M, N, K, chunk, act;
};
using Args = ArgsT<float>;

struct F32W {
  using T = float;
  static constexpr bool INT8 = false;
};
struct Int8W {
  using T = int8_t;
  static constexpr bool INT8 = true;
};

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MIN_BLOCKS_,
          int BK_ = 32>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WM = WM_, WN = WN_;        // warps along M, N
  static constexpr int NT = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MI = WTM / 16, NI = WTN / 8;   // fragments
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int AS = BK + 8;   // x row stride, = 8 mod 32 floats
  static constexpr int BS = BN + 4;   // W row stride, = 4 mod 32 floats
  static_assert(WTM % 16 == 0 && WTN % 8 == 0, "warp tile");
  static_assert(STAGES >= 2, "stages");
};

// Large: 128 x 64, 4 warps of 64 x 32, 3 stages, two blocks an SM;
// Small: 64 x 64, 4 warps of 32 x 32, 4 stages, two blocks an SM, for
// grids that leave SMs idle in Large.  Chosen among 128 x 128 (8
// warps), 64 x 128 and 32- and 64-deep K tiles by tools/gemm_forms.py
// at K4's and K8's path shapes.
using Large = Tile<128, 64, 2, 2, 3, 2>;
using Small = Tile<64, 64, 2, 2, 4, 2>;

// Dynamic shared memory: STAGES x (A tile, raw W tile), then for int8
// W two slots of W as f32, then EXTRA bytes of the A policy's own.
template <class C, class W, int EXTRA = 0>
struct Smem {
  static constexpr int A = C::BM * C::AS * 4;
  static constexpr int B = W::INT8 ? C::BK * C::BN : C::BK * C::BS * 4;
  static constexpr int STAGE = A + B;
  static constexpr int SLOT = W::INT8 ? C::BK * C::BS * 4 : 0;
  static constexpr int OWN = C::STAGES * STAGE + 2 * SLOT;
  static constexpr int bytes = OWN + EXTRA;
  static_assert(A % 16 == 0 && B % 16 == 0 && OWN % 16 == 0,
                "16-byte copies");
  // 227 KB a block; an SM's 228 KB hold MIN_BLOCKS blocks and their
  // 1 KB reserves
  static_assert(bytes <= 227 * 1024 &&
                    (bytes + 1024) * C::MIN_BLOCKS <= 228 * 1024,
                "shared memory");
};

// The A policy of K4 and K8: A is x [M, K] as stored, float or bf16.
// An A policy has Params (its kernel argument), smem_bytes (the shared
// memory it wants beside the stages), grid and tile (how blocks are
// numbered: along N first), init (once a block, before the first load;
// it may end on a barrier) and load (one A tile; called for K tiles 0,
// 1, 2, ... in that order).
struct DenseA {
  struct Params {};
  template <class C>
  static constexpr int smem_bytes = 0;

  // N tiles on x, M tiles on y (at most 65535)
  template <class C, class A>
  static bool grid(const A& a, dim3& g) {
    const int mt = (a.M + C::BM - 1) / C::BM;
    g = dim3((a.N + C::BN - 1) / C::BN, mt);
    return mt <= 65535;
  }
  template <class C, class A>
  __device__ __forceinline__ static void tile(const A&, int& m0, int& n0) {
    m0 = blockIdx.y * C::BM;
    n0 = blockIdx.x * C::BN;
  }

  template <class C, class A>
  __device__ __forceinline__ void init(const A&, const Params&, char*,
                                       int) {}

  // x[m0 .., k0 ..] into an A tile, 16 bytes (E elements) a copy; K is
  // a multiple of E (4 floats, 8 bf16)
  template <class C, class T>
  __device__ __forceinline__ void load(T* dst, const ArgsT<T>& a,
                                       const Params&, int m0, int k0) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int CPR = C::BK / E, N_CH = C::BM * CPR;
    static_assert(N_CH % C::NT == 0, "x copies must split evenly");
#pragma unroll
    for (int it = 0; it < N_CH / C::NT; ++it) {
      const int i = threadIdx.x + it * C::NT, r = i / CPR, c = i % CPR;
      const int gm = m0 + r, gk = k0 + E * c;
      const bool ok = gm < a.M && gk < a.K;
      cp16(dst + r * C::AS + E * c,
           a.x + (ok ? (size_t)gm * a.K + gk : 0), ok);
    }
  }
};

// W rows k0 .. k0 + BK, columns n0 .. n0 + BN into a raw W tile: chunks
// of 16 bytes (4 f32 or 16 int8 columns), one cp.async each (VEC: W's
// rows are 16-byte aligned) or four 4-byte ones; past K or N zero.
template <class C, class W, bool VEC>
__device__ __forceinline__ void load_w(char* dst, const Args& a, int n0,
                                       int k0) {
  constexpr int COLS = 16 / (int)sizeof(typename W::T);   // a chunk's
  constexpr int CPR = C::BN / COLS, N_CH = C::BK * CPR;
  constexpr int ROW = W::INT8 ? C::BN : C::BS * 4;        // bytes
  static_assert(N_CH % C::NT == 0, "W copies must split evenly");
  const char* w = static_cast<const char*>(a.w);
  constexpr int E = (int)sizeof(typename W::T);
#pragma unroll
  for (int it = 0; it < N_CH / C::NT; ++it) {
    const int i = threadIdx.x + it * C::NT, r = i / CPR, c = i % CPR;
    const int gk = k0 + r, gn = n0 + COLS * c;
    char* d = dst + r * ROW + 16 * c;
    if (VEC) {
      const bool ok = gk < a.K && gn < a.N;
      cp16(d, w + (ok ? ((size_t)gk * a.N + gn) * E : 0), ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = gn + j * (COLS / 4);
        const bool ok = gk < a.K && n < a.N;
        cp4(d + 4 * j, w + (ok ? ((size_t)gk * a.N + n) * E : 0), ok);
      }
    }
  }
}

// Convert the int8 W chunks load_w had this thread copy, landed, to f32
// into `slot`.
template <class C>
__device__ __forceinline__ void convert_w(const char* raw, float* slot) {
  constexpr int CPR = C::BN / 16, N_CH = C::BK * CPR;
#pragma unroll
  for (int it = 0; it < N_CH / C::NT; ++it) {
    const int i = threadIdx.x + it * C::NT, r = i / CPR, c = i % CPR;
    union {
      int4 v;
      char4 q[4];
    } u;
    u.v = *reinterpret_cast<const int4*>(raw + r * C::BN + 16 * c);
    float4* d = reinterpret_cast<float4*>(slot + r * C::BS + 16 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[j] = make_float4(u.q[j].x, u.q[j].y, u.q[j].z, u.q[j].w);
  }
}

// two adjacent outputs (row gm, columns gn, gn + 1); VEC: N is even, so
// both lie inside the row when gn does, and a float2 is aligned
template <bool VEC>
__device__ __forceinline__ void store2(float* p, int gn, int N, float v0,
                                       float v1) {
  if (VEC) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (gn + 1 < N) p[1] = v1;
  }
}
// two adjacent values (VEC: aligned as a pair) widened to float
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The epilogue policy of K4 and K8, from the accumulator registers:
// + bias, the optional pre-activation store, act, + residual, the
// store, in float32 (wgmma_gemm.cuh's epilogue is its bf16 form: bf16
// bias and residual widened, pre and out rounded once each).  An epilogue
// policy has Params (its kernel argument) and apply, which may reuse
// the stages' shared memory after cp_wait<0>() and a barrier.
struct GemmEpi {
  struct Params {};

  template <class C, bool VEC, class A>
  __device__ __forceinline__ static void apply(
      const float (&acc)[C::MI][C::NI][4], const A& a, const Params&,
      char*, int m0, int n0) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int wm0 = (warp / C::WN) * C::WTM, wn0 = (warp % C::WN) * C::WTN;
    // C fragment: element e holds row g + 8 (e / 2), column 2t + e % 2
#pragma unroll
    for (int j = 0; j < C::NI; ++j) {
      const int gn = n0 + wn0 + 8 * j + 2 * t;
      if (gn >= a.N) continue;
      float b0 = 0.f, b1 = 0.f;
      if (a.bias) {
        b0 = a.bias[gn];
        if (gn + 1 < a.N) b1 = a.bias[gn + 1];
      }
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm0 + 16 * i + g + 8 * h;
          if (gm >= a.M) continue;
          const size_t off = (size_t)gm * a.N + gn;
          float v0 = acc[i][j][2 * h] + b0, v1 = acc[i][j][2 * h + 1] + b1;
          if (a.pre) store2<VEC>(a.pre + off, gn, a.N, v0, v1);
          v0 = apply_act(v0, a.act);
          v1 = apply_act(v1, a.act);
          if (a.res) {
            if (VEC) {
              const float2 r = load_pair(a.res + off);
              v0 += r.x;
              v1 += r.y;
            } else {
              v0 += a.res[off];
              if (gn + 1 < a.N) v1 += a.res[off + 1];
            }
          }
          store2<VEC>(a.out + off, gn, a.N, v0, v1);
        }
      }
    }
  }
};

template <class C, class W, bool VEC, class AL, class EP>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
gemm_kernel(const Args a, const typename AL::Params ap,
            const typename EP::Params ep) {
  using L = Smem<C, W, AL::template smem_bytes<C>>;
  constexpr int BK = C::BK, AS = C::AS, BS = C::BS, STAGES = C::STAGES;
  constexpr int MI = C::MI, NI = C::NI;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp / C::WN) * C::WTM, wn0 = (warp % C::WN) * C::WTN;
  int m0, n0;
  AL::template tile<C>(a, m0, n0);
  const int nk = (a.K + BK - 1) / BK;

  auto stage_x = [&](int s) {
    return reinterpret_cast<float*>(smem + s * L::STAGE);
  };
  auto stage_w = [&](int s) { return smem + s * L::STAGE + L::A; };
  auto slot = [&](int s) {
    return reinterpret_cast<float*>(smem + STAGES * L::STAGE + s * L::SLOT);
  };

  AL src;   // the A policy's state
  src.template init<C>(a, ap, smem + L::OWN, m0);

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) zero(acc[i]);
  float sc[NI][2];   // int8: the current chunk's scales of my columns

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      src.template load<C>(stage_x(s), a, ap, m0, s * BK);
      load_w<C, W, VEC>(stage_w(s), a, n0, s * BK);
    }
    cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    cp_wait<STAGES - 2>();          // this thread's chunks of tile kt
    if (W::INT8) convert_w<C>(stage_w(st), slot(kt & 1));
    __syncthreads();                // tile kt landed; tile kt - 1 consumed
    {
      const int nt = kt + STAGES - 1;
      if (nt < nk) {
        src.template load<C>(stage_x(nt % STAGES), a, ap, m0, nt * BK);
        load_w<C, W, VEC>(stage_w(nt % STAGES), a, n0, nt * BK);
      }
      cp_commit();
    }
    const float* xs = stage_x(st);
    const float* ws = W::INT8 ? slot(kt & 1)
                              : reinterpret_cast<const float*>(stage_w(st));

    float fr[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) zero(fr[i]);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t ah[MI][4], al[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int at = (wm0 + 16 * i + g) * AS + 8 * kk + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(xs + at);
        const float2 x1 = *reinterpret_cast<const float2*>(xs + at + 8 * AS);
        split(x0.x, ah[i][0], al[i][0]);  // g, 2t
        split(x1.x, ah[i][1], al[i][1]);  // g+8, 2t
        split(x0.y, ah[i][2], al[i][2]);  // g, 2t+1
        split(x1.y, ah[i][3], al[i][3]);  // g+8
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int at = (8 * kk + 2 * t) * BS + wn0 + 8 * j + g;
        if (W::INT8) {
          const uint32_t b0 = __float_as_uint(ws[at]);
          const uint32_t b1 = __float_as_uint(ws[at + BS]);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma(fr[i][j], al[i], b0, b1);
            mma(fr[i][j], ah[i], b0, b1);
          }
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split(ws[at], bh0, bl0);
          split(ws[at + BS], bh1, bl1);
#pragma unroll
          for (int i = 0; i < MI; ++i)
            mma3(fr[i][j], ah[i], al[i], bh0, bh1, bl0, bl1);
        }
      }
    }
    if (W::INT8) {
      if ((kt * BK) % a.chunk == 0) {   // the first tile of a chunk
        const float* srow = a.scales + (size_t)(kt * BK / a.chunk) * a.N;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int gn = n0 + wn0 + 8 * j + 2 * t;
          const float2 s = gn < a.N
              ? __ldg(reinterpret_cast<const float2*>(srow + gn))
              : make_float2(0.f, 0.f);
          sc[j][0] = s.x;
          sc[j][1] = s.y;
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] = fmaf(sc[j][e & 1], fr[i][j][e], acc[i][j][e]);
    } else {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += fr[i][j][e];
    }
  }

  EP::template apply<C, VEC>(acc, a, ep, smem, m0, n0);
}

template <class C, class W, bool VEC, class AL = DenseA,
          class EP = GemmEpi>
cudaError_t launch(const Args& a, cudaStream_t stream,
                   const typename AL::Params& ap = {},
                   const typename EP::Params& ep = {}) {
  constexpr int bytes = Smem<C, W, AL::template smem_bytes<C>>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<C, W, VEC, AL, EP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!AL::template grid<C>(a, grid)) return cudaErrorInvalidValue;
  gemm_kernel<C, W, VEC, AL, EP><<<grid, C::NT, bytes, stream>>>(a, ap, ep);
  return cudaGetLastError();
}

// Large when its blocks give every SM one, else Small (as the flash
// tile's use_large).  Both forms sum every element in the same order,
// so the choice never changes a result.
inline cudaError_t use_large(int M, int N, bool* large) {
  const SmCount& c = sm_count();
  const long long blocks = (long long)((M + Large::BM - 1) / Large::BM) *
                           ((N + Large::BN - 1) / Large::BN);
  *large = blocks >= c.sms;
  return c.err;
}

// The tile (BM, BN) run() launches for an [M, N] output.
inline cudaError_t tile_of(int M, int N, int* bm, int* bn) {
  bool large = false;
  const cudaError_t err = use_large(M, N, &large);
  *bm = large ? Large::BM : Small::BM;
  *bn = large ? Large::BN : Small::BN;
  return err;
}

// K4's and K8's out = epilogue(x @ W) on the form use_large picks; vec:
// W's rows are 16-byte aligned (N % 4 == 0 for F32W, N % 16 == 0 for
// Int8W) and N is even.
template <class W>
cudaError_t run(const Args& a, bool vec, cudaStream_t stream) {
  bool large = false;
  const cudaError_t err = use_large(a.M, a.N, &large);
  if (err != cudaSuccess) return err;
  if (large)
    return vec ? launch<Large, W, true>(a, stream)
               : launch<Large, W, false>(a, stream);
  return vec ? launch<Small, W, true>(a, stream)
             : launch<Small, W, false>(a, stream);
}

// ---------------------------------------------------------------------------
// The bf16 form (K6 under AMP): A and W bf16 in shared memory,
// one mma.sync.m16n8k16.bf16 a 16-deep product into float32 fragments
// (no split: a bf16 product is exact in float32).  The same Tile, A policy
// and epilogue policy interfaces as gemm_kernel, the same block
// numbering, cp.async stage ring and fixed summation order (each K tile
// in a fresh fragment added by float32 adds, as the split form does);
// only the operand layout in shared memory and the fragments differ:
// - rows of 2-byte elements, A padded to BK + 8 (80 bytes) and W to
//   BN + 8 (144 bytes), so the 8 rows an ldmatrix phase reads start 16
//   bytes apart modulo 128 and fall on distinct banks;
// - fragments by ldmatrix: A's m16k16 fragment by one .x4 (matrices:
//   rows 0-7 / 8-15 x k 0-7 / 8-15), W's two k16n8 fragments of 16
//   columns by one .x4.trans from its row-major [k][n] rows, in the
//   natural k order of the m16n8k16 layout (a0: row g, k 2t, 2t + 1;
//   a2: k + 8; b0: k 2t, 2t + 1, column g; b1: k + 8).
// The C fragment layout is the m16n8k8 one, so the epilogue policies
// read the accumulator as they do in the split form.
// ---------------------------------------------------------------------------

// (mma_bf16, ldsm4 and ldsm4_t: bf16_mma.cuh)

// Dynamic shared memory of the bf16 form: STAGES x (A tile, W tile),
// then EXTRA bytes of the A policy's own.
template <class C, int EXTRA = 0>
struct SmemBf16 {
  static constexpr int AS = C::BK + 8;   // A row stride, elements
  static constexpr int BS = C::BN + 8;   // W row stride, elements
  static constexpr int A = C::BM * AS * 2;
  static constexpr int B = C::BK * BS * 2;
  static constexpr int STAGE = A + B;
  static constexpr int OWN = C::STAGES * STAGE;
  static constexpr int bytes = OWN + EXTRA;
  // the A policies address A rows by C::AS
  static_assert(AS == C::AS, "A row stride");
  static_assert((AS * 2) % 32 == 16 && (BS * 2) % 32 == 16,
                "ldmatrix rows on distinct banks");
  static_assert(A % 16 == 0 && B % 16 == 0 && OWN % 16 == 0,
                "16-byte copies");
  static_assert(bytes <= 227 * 1024 &&
                    (bytes + 1024) * C::MIN_BLOCKS <= 228 * 1024,
                "shared memory");
};

// W rows k0 .. k0 + BK, columns n0 .. n0 + BN (bf16, N % 8 == 0) into
// a W tile, 8 columns a 16-byte cp.async; past K or N zero.
template <class C>
__device__ __forceinline__ void load_w_bf16(bf16* dst, const ArgsT<bf16>& a,
                                            int n0, int k0) {
  constexpr int CPR = C::BN / 8, N_CH = C::BK * CPR;
  constexpr int BS = SmemBf16<C>::BS;
  static_assert(N_CH % C::NT == 0, "W copies must split evenly");
  const bf16* w = static_cast<const bf16*>(a.w);
#pragma unroll
  for (int it = 0; it < N_CH / C::NT; ++it) {
    const int i = threadIdx.x + it * C::NT, r = i / CPR, c = i % CPR;
    const int gk = k0 + r, gn = n0 + 8 * c;
    const bool ok = gk < a.K && gn < a.N;
    cp16(dst + r * BS + 8 * c, w + (ok ? (size_t)gk * a.N + gn : 0), ok);
  }
}

template <class C, class AL, class EP>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
bf16_kernel(const ArgsT<bf16> a, const typename AL::Params ap,
            const typename EP::Params ep) {
  using L = SmemBf16<C, AL::template smem_bytes<C>>;
  constexpr int BK = C::BK, AS = L::AS, BS = L::BS, STAGES = C::STAGES;
  constexpr int MI = C::MI, NI = C::NI;
  static_assert(BK % 16 == 0 && NI % 2 == 0, "bf16 fragments");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm0 = (warp / C::WN) * C::WTM, wn0 = (warp % C::WN) * C::WTN;
  int m0, n0;
  AL::template tile<C>(a, m0, n0);
  const int nk = (a.K + BK - 1) / BK;

  auto stage_a = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * L::STAGE);
  };
  auto stage_w = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * L::STAGE + L::A);
  };

  AL src;   // the A policy's state
  src.template init<C>(a, ap, smem + L::OWN, m0);

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) zero(acc[i]);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      src.template load<C>(stage_a(s), a, ap, m0, s * BK);
      load_w_bf16<C>(stage_w(s), a, n0, s * BK);
    }
    cp_commit();
  }

  // this lane's ldmatrix row: A rows 0-15 at k 0 / 8; W k rows 0-7 /
  // 8-15 at columns 0 / 8
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    cp_wait<STAGES - 2>();          // this thread's copies of tile kt
    __syncthreads();                // tile kt landed; tile kt - 1 consumed
    {
      const int nt = kt + STAGES - 1;
      if (nt < nk) {
        src.template load<C>(stage_a(nt % STAGES), a, ap, m0, nt * BK);
        load_w_bf16<C>(stage_w(nt % STAGES), a, n0, nt * BK);
      }
      cp_commit();
    }
    const bf16* as = stage_a(st);
    const bf16* ws = stage_w(st);

    float fr[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) zero(fr[i]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm4(af[i], as + (wm0 + 16 * i + a_row) * AS + 16 * kk + a_col);
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {
        uint32_t b[4];
        ldsm4_t(b, ws + (16 * kk + b_row) * BS + wn0 + 16 * jj + b_col);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(fr[i][2 * jj], af[i], b[0], b[1]);
          mma_bf16(fr[i][2 * jj + 1], af[i], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += fr[i][j][e];
  }

  EP::template apply<C, true>(acc, a, ep, smem, m0, n0);
}

// one launch of the bf16 form; W's rows must be 16-byte aligned and N a
// multiple of 8
template <class C, class AL, class EP>
cudaError_t launch_bf16(const ArgsT<bf16>& a, cudaStream_t stream,
                        const typename AL::Params& ap,
                        const typename EP::Params& ep) {
  constexpr int bytes = SmemBf16<C, AL::template smem_bytes<C>>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bf16_kernel<C, AL, EP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!AL::template grid<C>(a, grid)) return cudaErrorInvalidValue;
  bf16_kernel<C, AL, EP><<<grid, C::NT, bytes, stream>>>(a, ap, ep);
  return cudaGetLastError();
}

}  // namespace gemm
