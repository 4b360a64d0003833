// K1: flash attention forward with per-row log-sum-exp, float32.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py
// _flash_kernel (launched by _flash_pallas): softmax(Q K^T * scale
// [causal]) V over [BH, T, D] with an online max/sum, writing out and
// lse = m + log(l) per query row, skipping K tiles wholly above the
// diagonal under the causal mask.
//
// What bounds it on the H100: its two products, 4 T Tk D FLOPs (about
// half that causal), done in split-TF32 on the tensor cores, 3 TF32
// MMAs a product, so at most 494.7 / 3 = 165 TFLOP/s of float32-accurate
// products (the float32 FMA pipes give 67); against that, the bytes
// (q, k, v read once, out and lse written once) at 3.35 TB/s.  A causal
// [16, 8, 2048, 128] prefill is 137 GFLOP against 513 MiB: 0.83 ms of
// products against 0.16 ms of bytes, so operation-bound; a short one is
// bound by launch latency.  Design: flash_tile.cuh's fold_k_tiles, from
// (NEG_INF, 0, 0), then out = o / l and lse: a block per (batch*head,
// Q tile of 64 rows, or 128 on a grid that fills the card), a
// warp per 16 rows on mma.sync m16n8k8 tf32 in split form, each operand
// split once, K/V tiles double-buffered by cp.async, a warp skipping the
// keys in its own rows' future; the [T, T] score matrix never exists in
// device memory.  Under the causal
// mask the heaviest Q tiles (the last) launch first, so the light ones
// fill the tail.  Ragged T and Tk are masked here, not by the caller.
//
// The bf16 form (flash_fwd_bf16; the LM under AMP, where the reference
// kernel takes bf16 q, k, v and widens them to f32 in its body): the
// same function of the same operands, m, l, the accumulator and the LSE
// in float32, out rounded to bf16 once, on wgmma with TMA; its mainloop
// is flash_bf16.cuh's, which K9's bf16 form (flash_chunk.cu) shares
// with a carry policy.  A causal [16, 8, 2048, 128] forward is 137
// GFLOP against 257 MiB: 0.21 ms of those products (P V as hi + lo;
// 0.14 ms at the full rate), 0.08 ms of bytes, so bound by the tensor
// cores, which only wgmma drives at that rate.
#include "flash_bf16.cuh"
#include "flash_tile.cuh"

namespace {

using namespace flash;

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int T, int Tk, float scale,
                 int causal) {
  constexpr int D = C::D;
  extern __shared__ float4 smem4[];
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * C::BQ;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * (threadIdx.x / 32) + g;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  fold_k_tiles<C>(q + (size_t)bh * T * D, k + (size_t)bh * Tk * D,
                  v + (size_t)bh * Tk * D, reinterpret_cast<float*>(smem4),
                  q0, T, Tk, live_k_tiles<C>(q0, Tk, causal, 0), scale,
                  causal, 0, m, l, o);

  // rows g (C-fragment elements 0, 1) and g + 8 (2, 3); output n-tile
  // pair (2n, 2n + 1) holds d = 16n + 4t .. 16n + 4t + 3 of each row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = r0 + 8 * i;
    if (qr >= T) continue;
    const float inv = 1.f / l[i];
    float4* orow = reinterpret_cast<float4*>(out + ((size_t)bh * T + qr) * D);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      orow[4 * n + t] = make_float4(
          o[2 * n][2 * i] * inv, o[2 * n + 1][2 * i] * inv,
          o[2 * n][2 * i + 1] * inv, o[2 * n + 1][2 * i + 1] * inv);
    if (t == 0) lse[(size_t)bh * T + qr] = m[i] + logf(l[i]);
  }
}

template <class C>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, float* lse, int bh, int t, int tk,
                   float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return err;
  const int n_q = (t + C::BQ - 1) / C::BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  dim3 grid(bh, n_q);
  flash_fwd_kernel<C><<<grid, C::NT, C::bytes, stream>>>(
      q, k, v, out, lse, t, tk, scale, causal);
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
  bool large = false;
  cudaError_t err = use_large<128>(bh, t, &large);
  if (err != cudaSuccess) return (int)err;
  return (int)(large ? launch<Large<128>>(q, k, v, out, lse, bh, t, tk, scale,
                                          causal, s)
                     : launch<Small<128>>(q, k, v, out, lse, bh, t, tk, scale,
                                          causal, s));
}

// The bf16 form: q, k, v, out bf16 [bh, t|tk, d], lse float32 [bh, t];
// contiguous, 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int flash_fwd_bf16(const tc::bf16* q, const tc::bf16* k,
                              const tc::bf16* v, tc::bf16* out, float* lse,
                              int bh, int t, int tk, int d, float scale,
                              int causal, void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  if (d != f16::D) return (int)cudaErrorInvalidValue;
  return (int)f16::run<false>(q, k, v, out, lse, f16::Carry{}, bh, t, tk,
                              scale, causal, 0,
                              static_cast<cudaStream_t>(stream));
}
