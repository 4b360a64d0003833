// K7: decode-mode attention through a paged KV cache, float32.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py
// _paged_kernel (launched by paged_attention): one query token per
// sequence attends over the K/V pages named by that sequence's row of
// the block table; positions >= context_lens[b] are masked with
// NEG_INF = -1e30.
//
// What bounds it on the H100: bytes.  Each live K/V position is read
// once (2 x D x 4 bytes a head) and used for 2 x D FMAs, far below the
// card's ~20 FMA/byte balance point, so the kernel is a stream of the
// live pages at 3.35 TB/s, and what it needs is enough blocks and
// enough bytes in flight on every SM whatever the batch.
//
// Design: a split over pages.  A row's live pages (page p is live when
// p x BS < its context length; table entries past them are never read)
// are cut into spans of P consecutive pages.  The grid is (span, head,
// sequence), ceil(NB / P) spans a row; a block whose span starts at or
// past its row's context returns having read only the length.  P is a
// constant of this file, never a function of the batch, the table width
// NB or the lengths, so a row's split points, and with them every
// rounding, are the same in every batch and block-count bucket: a row's
// output is bit-identical solo and batched.
//
// A block streams its span's pages through a ring of STAGES stages in
// shared memory with cp.async: a stage is one page's head slice, BS
// rows of K and BS of V (512 bytes each, rows H x D floats apart), so
// STAGES - 1 pages are in flight while one is reduced.  Its NW warps
// take the page's rows round-robin (warp w: rows w, w + NW, ...); each
// keeps an online softmax (m, l, acc) over its rows, acc's D dims four
// to a lane, and the block merges the warps' states in warp order.  A
// row with one live span writes acc / l to out.  Otherwise each span
// writes (acc, m, l) to a scratch [B, H, S, D + 2] that the wrapper
// allocates, and a second kernel, one block a (sequence, head), folds
// the spans in order 0 .. n - 1 in one online pass.  It is a
// programmatic dependent launch, scheduled while the span kernel runs,
// so its launch latency is hidden.  No atomics touch the data, so two
// calls give the same bits.
//
// The form, from tools/paged_forms.py on the card (P in {4, 8, 16, 32},
// 3, 4 or 6 stages, 4 or 8 warps, at B = 1..16 and contexts of 128 to
// 2048 tokens): P = 16 (256 tokens), 3 stages, 8 warps, the least time
// summed over the 20 shapes.  The ring's depth moves a shape's time by
// a few percent either way (three stages leave four 48 KB blocks an
// SM); 8 warps beat 4 in 231 of the 240 (form, shape) pairs.
// P = 8 wins at B = 1 with 1024 tokens or fewer, P = 32 at B >= 8 with
// long rows; a fixed P is what keeps rows batch-invariant.  The
// one-launch combine (the last span of a (sequence, head) folds it,
// found by a self-resetting ticket) was no faster at B = 1 and slower
// at B >= 8, so the second launch stays.
#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace paged {

constexpr float NEG_INF = -1e30f;
constexpr int D = 128;   // the flagship LM's head_dim
constexpr int BS = 16;   // the serving block size

// P pages a span, STAGES ring stages, NW warps a block
template <int P_, int STAGES_, int NW_>
struct Form {
  static constexpr int P = P_, STAGES = STAGES_, NW = NW_;
  static constexpr int THREADS = NW * 32;
  static constexpr int STAGE = 2 * BS * D;                  // floats
  static constexpr int COPIES = STAGE / 4 / THREADS;        // 16 B each
  static constexpr int SMEM = STAGES * STAGE * 4;           // bytes
  static_assert(BS % NW == 0 && STAGE / 4 % THREADS == 0, "form");
  static_assert(STAGES >= 2 && NW * (D + 2) <= STAGE, "form");
};

// the product's form; the wrapper sizes the scratch from its P
// (paged_span_pages below), and launch refuses a span count that
// disagrees
using Product = Form<16, 3, 8>;

// q [B, H, D]; pages [N, BS, H, D]; tables [B, NB]; lens [B]; out
// [B, H, D]; part [B, H, S, D + 2], S = ceil(NB / P), unused when S = 1
struct Args {
  const float *q, *kp, *vp;
  const int *tables, *lens;
  float *out, *part;
  int B, H, NB, S;
  float scale;
};

__device__ __forceinline__ int live_pages(int ctx, int nb) {
  return min(nb, (ctx + BS - 1) / BS);
}

// One block's span: the online softmax over its pages, the warps
// merged in order, then acc / l to out (the row's only span) or
// (acc, m, l) to part.
template <class F>
__device__ __forceinline__ void span_pass(const Args& a, float* ring) {
  constexpr int P = F::P, STAGES = F::STAGES, NW = F::NW;
  constexpr int THREADS = F::THREADS, STAGE = F::STAGE;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ctx = a.lens[b];
  const int pages = live_pages(ctx, a.NB);
  const int p0 = s * P;
  if (p0 >= pages) return;
  const int np = min(P, pages - p0);
  const int* tab = a.tables + (size_t)b * a.NB + p0;
  const int row = a.H * D;                      // a page row's stride
  const float* kh = a.kp + (size_t)h * D;
  const float* vh = a.vp + (size_t)h * D;

  // page i of the span into stage i % STAGES: chunk c (16 bytes) is
  // K or V, row r, dims col..col+3; a warp copies one 512-byte row
  auto load = [&](int i) {
    const size_t page = (size_t)tab[i] * BS * row;
    float* st = ring + (i % STAGES) * STAGE;
#pragma unroll
    for (int it = 0; it < F::COPIES; ++it) {
      const int c = it * THREADS + threadIdx.x;
      const int r = (c / (D / 4)) % BS, col = (c % (D / 4)) * 4;
      const float* src = (c < BS * D / 4 ? kh : vh) + page + r * row + col;
      tc::cp16(st + 4 * c, src, true);
    }
  };

  float4 qv = *reinterpret_cast<const float4*>(
      a.q + ((size_t)b * a.H + h) * D + lane * 4);
  qv.x *= a.scale;
  qv.y *= a.scale;
  qv.z *= a.scale;
  qv.w *= a.scale;
  float m = NEG_INF, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < np) load(i);
    tc::cp_commit();
  }
  for (int i = 0; i < np; ++i) {
    tc::cp_wait<STAGES - 2>();
    __syncthreads();   // page i landed; page i - 1's stage is free
    if (i + STAGES - 1 < np) load(i + STAGES - 1);
    tc::cp_commit();
    const float* K = ring + (i % STAGES) * STAGE;
    const float* V = K + BS * D;
    const int pos0 = (p0 + i) * BS + warp;     // this warp's first row
    if (pos0 < ctx) {
      float sc[BS / NW];
#pragma unroll
      for (int j = 0; j < BS / NW; ++j) {
        const float4 k = *reinterpret_cast<const float4*>(
            K + (j * NW + warp) * D + lane * 4);
        sc[j] = qv.x * k.x + qv.y * k.y + qv.z * k.z + qv.w * k.w;
      }
#pragma unroll
      for (int j = 0; j < BS / NW; ++j)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], off);
      float mx = m;
#pragma unroll
      for (int j = 0; j < BS / NW; ++j)
        if (pos0 + j * NW < ctx) mx = fmaxf(mx, sc[j]);
      const float alpha = expf(m - mx);
      l *= alpha;
      acc.x *= alpha;
      acc.y *= alpha;
      acc.z *= alpha;
      acc.w *= alpha;
#pragma unroll
      for (int j = 0; j < BS / NW; ++j) {
        if (pos0 + j * NW < ctx) {
          const float p = expf(sc[j] - mx);
          const float4 v = *reinterpret_cast<const float4*>(
              V + (j * NW + warp) * D + lane * 4);
          l += p;
          acc.x += p * v.x;
          acc.y += p * v.y;
          acc.z += p * v.z;
          acc.w += p * v.w;
        }
      }
      m = mx;
    }
  }

  // merge the warps' states in warp order, through the drained ring
  tc::cp_wait<0>();
  __syncthreads();
  float* accs = ring;                           // [NW][D]
  float* ms = ring + NW * D;
  float* ls = ms + NW;
  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = l;
  }
  *reinterpret_cast<float4*>(accs + warp * D + lane * 4) = acc;
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float mt = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mt = fmaxf(mt, ms[w]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(ms[w] - mt);
      lt += ls[w] * c;
      o += accs[w * D + d] * c;
    }
    if (pages <= P) {
      a.out[((size_t)b * a.H + h) * D + d] = o / lt;
    } else {
      float* pt = a.part + (((size_t)b * a.H + h) * a.S + s) * (D + 2);
      pt[d] = o;
      if (d == 0) {
        pt[D] = mt;
        pt[D + 1] = lt;
      }
    }
  }
}

// Fold the n spans of (b, h) in order 0 .. n - 1 into out, one online
// pass (each span's loads independent of the fold so far); thread d
// writes dim d.  L2 loads: the spans were written by other blocks.
__device__ __forceinline__ void combine_pass(const Args& a, int b, int h,
                                             int n, int d) {
  const float* pt = a.part + ((size_t)b * a.H + h) * a.S * (D + 2);
  float mt = NEG_INF, lt = 0.f, o = 0.f;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float* pj = pt + j * (D + 2);
    const float m = __ldcg(pj + D), l = __ldcg(pj + D + 1);
    const float acc = __ldcg(pj + d);
    const float mn = fmaxf(mt, m);
    const float c0 = expf(mt - mn), c1 = expf(m - mn);
    lt = lt * c0 + l * c1;
    o = o * c0 + acc * c1;
    mt = mn;
  }
  a.out[((size_t)b * a.H + h) * D + d] = o / lt;
}

template <class F>
__global__ void __launch_bounds__(F::THREADS) span_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  // the combine may be scheduled once every block has started; it waits
  // for this grid's completion before it reads a span (griddepcontrol)
  asm volatile("griddepcontrol.launch_dependents;");
  span_pass<F>(a, reinterpret_cast<float*>(smem4));
}

template <int P>
__global__ void __launch_bounds__(D) combine_kernel(const Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n = (live_pages(a.lens[b], a.NB) + P - 1) / P;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (n > 1) combine_pass(a, b, h, n, threadIdx.x);
}

// Both launches on the caller's stream, each checked.  The combine is a
// programmatic dependent launch: it is scheduled while the span kernel
// runs, so its launch latency is hidden, and reads nothing of it
// before that grid has completed.
template <class F>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.S != (a.NB + F::P - 1) / F::P) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      span_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (err != cudaSuccess) return err;
  span_kernel<F><<<dim3(a.S, a.H, a.B), F::THREADS, F::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.B);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel<F::P>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace paged

// q [B, H, D]; k_pages/v_pages [N, bs, H, D]; tables [B, NB] int32;
// lens [B] int32 (>= 1); out [B, H, D]; part [B, H, spans, D + 2] with
// spans = ceil(NB / P) (null when spans is 1).  All contiguous, float32
// data, q and the pages on 16-byte boundaries.
extern "C" int paged_attention_f32(const float* q, const float* kp,
                                   const float* vp, const int* tables,
                                   const int* lens, float* out, float* part,
                                   int B, int H, int D, int bs, int NB,
                                   int spans, float scale, void* stream) {
  // built for the flagship LM's head_dim and the serving block size
  // only; add an instantiation when a configuration serves another
  if (B <= 0 || H <= 0 || NB <= 0 || D != paged::D || bs != paged::BS ||
      B > 65535 || H > 65535 || (spans > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const paged::Args a{q, kp, vp, tables, lens, out, part, B, H, NB, spans,
                      scale};
  return (int)paged::launch<paged::Product>(a, static_cast<cudaStream_t>(
                                                   stream));
}

// the product's span length P in pages, for the wrapper's scratch
extern "C" int paged_span_pages() { return paged::Product::P; }
