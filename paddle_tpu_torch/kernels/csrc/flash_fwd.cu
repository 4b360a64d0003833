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
// accumulator live in registers of the block): flash_tile.cuh's
// fold_k_tiles, from (NEG_INF, 0, 0), then out = acc / l and lse.  The
// [T, T] score matrix never exists in device memory.  Ragged T and Tk
// are masked here, not by the caller.
#include "flash_tile.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int T, int Tk, float scale,
                 int causal) {
  constexpr int DN = D / 16;
  extern __shared__ float smem[];
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }
  fold_k_tiles<D>(q + (size_t)bh * T * D, k + (size_t)bh * Tk * D,
                  v + (size_t)bh * Tk * D, smem, q0, T, Tk,
                  live_k_tiles(q0, Tk, causal, 0), scale, causal, 0, m, l,
                  acc);

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
