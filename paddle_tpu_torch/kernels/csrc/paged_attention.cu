// K7: decode-mode attention through a paged KV cache, float32.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py
// _paged_kernel (launched by paged_attention): one query token per
// sequence attends over K/V pages named by that sequence's row of the
// block table; positions >= context_lens[b] are masked with
// NEG_INF = -1e30 and pages wholly past the context are skipped.
//
// What bounds it on the H100: bytes.  Each live K/V position is read
// once (2 x H x D x 4 bytes) and used for 2 x D FMAs per head, far
// below the card's ~20 FMA/byte balance point, so the kernel is a
// memory stream of the live pages at 3.35 TB/s.  Design: one block per
// (sequence, head); it reads its own block-table row and context
// length (there is no scalar prefetch on the GPU).  Its 8 warps take
// the live pages round-robin, so up to 8 pages of one sequence are in
// flight at once; within a warp each lane holds D/32 contiguous dims,
// loads a page row of one head as one coalesced 16-byte access per
// lane, and the BS rows of a page are loaded before any is reduced, to
// keep loads in flight.  Each warp keeps its own online softmax
// (m, l, acc); the block merges the 8 partial states in shared memory
// at the end.  The gathered [B, S] context never exists in device
// memory.  A page row's stride is H x D floats.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NW = 8;  // warps per block

template <int E>
struct Vec;
template <>
struct Vec<4> {
  static __device__ void get(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
};

template <int D, int BS>
__global__ void __launch_bounds__(NW * 32)
paged_kernel(const float* __restrict__ q, const float* __restrict__ kp,
             const float* __restrict__ vp, const int* __restrict__ tables,
             const int* __restrict__ lens, float* __restrict__ out, int H,
             int NB, float scale) {
  constexpr int E = D / 32;  // dims per lane
  __shared__ float m_s[NW], l_s[NW];
  __shared__ float acc_s[NW][D];

  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ctx = lens[b];
  const int* tab = tables + (size_t)b * NB;
  const size_t row = (size_t)H * D;
  const size_t page = (size_t)BS * row;

  float qv[E];
  Vec<E>::get(q + ((size_t)b * H + h) * D + lane * E, qv);
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] *= scale;

  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  const int n_live = min(NB, (ctx + BS - 1) / BS);  // page * BS < ctx
  for (int pi = warp; pi < n_live; pi += NW) {
    const size_t base = (size_t)tab[pi] * page + (size_t)h * D + lane * E;
    float s[BS];
#pragma unroll
    for (int r = 0; r < BS; ++r) {
      float kk[E];
      Vec<E>::get(kp + base + r * row, kk);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part += qv[e] * kk[e];
      s[r] = part;
    }
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < BS; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      if (pi * BS + r >= ctx) s[r] = NEG_INF;
      mx = fmaxf(mx, s[r]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int r = 0; r < BS; ++r) {
      const float p = expf(s[r] - m_new);
      float vv[E];
      Vec<E>::get(vp + base + r * row, vv);
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += p * vv[e];
    }
    m = m_new;
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) acc_s[warp][lane * E + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NW * 32) {
    float mt = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mt = fmaxf(mt, m_s[w]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(m_s[w] - mt);
      lt += l_s[w] * c;
      o += acc_s[w][d] * c;
    }
    out[((size_t)b * H + h) * D + d] = o / lt;
  }
}

template <int D, int BS>
cudaError_t launch(const float* q, const float* kp, const float* vp,
                   const int* tables, const int* lens, float* out, int B,
                   int H, int NB, float scale, cudaStream_t stream) {
  dim3 grid(H, B);
  paged_kernel<D, BS><<<grid, NW * 32, 0, stream>>>(q, kp, vp, tables, lens,
                                                   out, H, NB, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, D]; k_pages/v_pages [N, bs, H, D]; tables [B, NB] int32;
// lens [B] int32 (>= 1); out [B, H, D].  All contiguous, float32 data.
extern "C" int paged_attention_f32(const float* q, const float* kp,
                                   const float* vp, const int* tables,
                                   const int* lens, float* out, int B,
                                   int H, int D, int bs, int NB,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // built for the flagship LM's head_dim and the serving block size
  // only; add an instantiation when a configuration serves another
  if (B <= 0 || H <= 0 || NB <= 0 || D != 128 || bs != 16)
    return (int)cudaErrorInvalidValue;
  return (int)launch<128, 16>(q, kp, vp, tables, lens, out, B, H, NB, scale,
                              s);
}
