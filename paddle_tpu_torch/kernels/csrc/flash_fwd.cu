// K1: flash attention forward with per-row log-sum-exp, float32.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py
// _flash_kernel (launched by _flash_pallas): softmax(Q K^T * scale
// [causal]) V over [BH, T, D] with an online max/sum, writing out and
// lse = m + log(l) per query row, skipping K tiles wholly above the
// diagonal under the causal mask.
//
// What bounds it on the H100: in float32 there is no tensor-core path
// (TF32 would lose the reference's precision), so a long causal prefill
// is bound by float32 FMA issue (67 TFLOP/s) and, in this simple form,
// by shared-memory reads feeding those FMAs; a short one is bound by
// launch latency.  Design: one block per (batch*head, 64-row Q tile);
// a loop over 32-row K/V tiles replaces the TPU's sequential grid axis
// (blocks run in parallel and in no order, so the running max, sum and
// accumulator live in registers of the block).  The Q tile is loaded
// once, pre-scaled; each thread owns 4 query rows x (32/16) scores and
// 4 rows x (D/16) output columns.  Rows padded to D+1 floats keep the
// 16 column lanes of a half-warp on distinct banks.  The [T, T] score
// matrix never exists in device memory.  Ragged T and Tk are masked
// here, not by the caller.  Masked scores are NEG_INF = -1e30 (not
// -inf), as in the reference, so they underflow to exactly zero.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // key rows per tile
constexpr int NT = 256;       // 16 row groups x 16 column lanes
constexpr int RM = BQ / 16;   // query rows per thread
constexpr int CN = BK / 16;   // score columns per thread

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) *
         (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int T, int Tk, float scale,
                 int causal) {
  constexpr int DP = D + 1;
  constexpr int DN = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DP], pre-scaled
  float* Ks = Qs + BQ * DP;      // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][BK + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float* qb = q + (size_t)bh * T * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, gr = q0 + r;
    Qs[r * DP + c] = gr < T ? qb[(size_t)gr * D + c] * scale : 0.f;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int n_k = (Tk + BK - 1) / BK;
  if (causal) n_k = min(n_k, (q0 + BQ - 1) / BK + 1);  // the TPU skip rule
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, gr = k0 + r;
      const bool ok = gr < Tk;
      Ks[r * DP + c] = ok ? kb[(size_t)gr * D + c] : 0.f;
      Vs[r * D + c] = ok ? vb[(size_t)gr * D + c] : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float qv = Qs[(ty * RM + i) * DP + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] += qv * kv[j];
      }
    }

    // online softmax: each row's BK scores sit on the 16 lanes of one
    // half-warp, so xor-shuffles 8..1 reduce a row without shared memory
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qr = q0 + ty * RM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kc = k0 + tx + 16 * j;
        if (kc >= Tk || (causal && kc > qr)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * RM + i) * (BK + 1) + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = Ps[(ty * RM + i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] += p * vv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty * RM + i;
    if (qr >= T) continue;
    float* orow = out + ((size_t)bh * T + qr) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) orow[tx + 16 * j] = acc[i][j] / l[i];
    if (tx == 0) lse[(size_t)bh * T + qr] = m[i] + logf(l[i]);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, float* lse, int bh, int t, int tk,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_kernel<D><<<grid, NT, bytes, stream>>>(q, k, v, out, lse, t,
                                                   tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [bh, t, d], k/v [bh, tk, d], out [bh, t, d], lse [bh, t]; all float32,
// contiguous.  Returns the launch's cudaError_t.
extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             float* out, float* lse, int bh, int t, int tk,
                             int d, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  // built for the flagship LM's head_dim only; add an instantiation
  // when a configuration serves another
  if (d != 128) return (int)cudaErrorInvalidValue;
  return (int)launch<128>(q, k, v, out, lse, bh, t, tk, scale, causal, s);
}
