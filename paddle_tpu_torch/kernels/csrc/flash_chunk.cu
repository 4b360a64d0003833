// K9: one ring step of sequence-parallel attention, float32: fold one
// K/V block into the online-softmax carry (m, l, acc).
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py
// _chunk_kernel (launched by _chunk_pallas): the flash forward's inner
// loop, seeded from the carry the ring threads from step to step instead
// of (NEG_INF, 0, 0), and written back UNNORMALIZED (acc is the numerator
// of softmax(s) V; the ring's last step divides by l).  Per tile:
//
//   s   = scale q k^T, set to NEG_INF where q_pos < k_offset + k_pos
//         (causal only) and past the ragged Tk edge
//   m'  = max(m, rowmax s)
//   p   = 0 where s <= NEG_INF / 2, else exp(s - m')
//   l'  = l exp(m - m') + rowsum p,   acc' = acc exp(m - m') + p v
//
// The guard on p makes a fully masked block leave the carry bit for bit
// as it was: with m = m' = NEG_INF, exp(s - m') would be exp(0) = 1 and
// manufacture mass.  A K tile wholly in the future of the Q tile
// (k_offset + kt BK > q0 + BQ - 1) is skipped, the TPU's rule, so a Q
// tile with no live K tile copies its carry through unchanged.
//
// What bounds it on the H100: as K1, its two products in split-TF32 on
// the tensor cores, at most 494.7 / 3 = 165 TFLOP/s of float32-accurate
// products, against the bytes (q, k, v, the carry in and out) at
// 3.35 TB/s.  A non-causal [16, 8, 512, 128] block is 17.2 GFLOP against
// 160 MiB: 0.104 ms of products against 0.050 ms of bytes, so still
// operation-bound, the carry's bytes a third of the bound.  Design: K1's
// tile loop (flash_tile.cuh's fold_k_tiles: a block per (batch*head,
// Q tile of 64 or 128 rows), a warp per 16 rows on mma.sync tf32 in
// split form, cp.async double-buffered K/V tiles, a warp skipping the
// keys in its own rows' future, which is what the diagonal block's fold
// needs); the
// carry is read straight into the warps' C-fragment registers (float4
// loads in fragment order) before the loop and written from them after
// it, the carry's extra cost over K1.
//
// The bf16 form (flash_chunk_bf16; the sp LM under AMP, where the
// reference kernel takes bf16 q, k, v, widens them to f32 in its body
// and keeps an f32 carry): the same fold of the same operands, the carry
// float32 in and out, on K1's bf16 mainloop (flash_bf16.cuh: wgmma with
// TMA, P V as hi + lo) with its carry policy: (m, l, acc) read into the
// accumulator's registers before the loop and written from them after
// it, m compared in natural units so that a row whose max does not rise
// keeps it bit for bit, the reference's p = 0 guard on masked scores,
// k_offset in the mask and the stop rules.  What bounds it at the ring's
// non-causal [16, 8, 512, 128] block: the bytes, q, k, v in bf16 (50.3
// MB) and the f32 carry in and out (m, l 1.0 MB, acc 67.1 MB), 118.5 MB
// at 3.35 TB/s = 0.035 ms, against 17.2 GFLOP of products at 989.4
// TFLOP/s = 0.017 ms (0.026 ms with P's split): bound by bytes, most of
// them the carry's.
#include "flash_bf16.cuh"
#include "flash_tile.cuh"

namespace {

using namespace flash;

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* m_in,
                   const float* l_in, const float* acc_in, float* m_out,
                   float* l_out, float* acc_out, int T, int Tk, float scale,
                   int causal, int k_offset) {
  constexpr int D = C::D;
  extern __shared__ float4 smem4[];
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * C::BQ;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * (threadIdx.x / 32) + g;

  // the carry of this thread's rows g (C-fragment elements 0, 1) and
  // g + 8 (2, 3); output n-tile pair (2n, 2n + 1) holds d = 16n + 4t ..
  // 16n + 4t + 3 of each row; rows past T are never written
  float m[2], l[2], o[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = r0 + 8 * i;
    const bool ok = qr < T;
    const size_t row = (size_t)bh * T + qr;
    m[i] = ok ? m_in[row] : NEG_INF;
    l[i] = ok ? l_in[row] : 0.f;
    const float4* arow = reinterpret_cast<const float4*>(acc_in + row * D);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      const float4 a = ok ? arow[4 * n + t] : make_float4(0.f, 0.f, 0.f, 0.f);
      o[2 * n][2 * i] = a.x;
      o[2 * n + 1][2 * i] = a.y;
      o[2 * n][2 * i + 1] = a.z;
      o[2 * n + 1][2 * i + 1] = a.w;
    }
  }
  fold_k_tiles<C>(q + (size_t)bh * T * D, k + (size_t)bh * Tk * D,
                  v + (size_t)bh * Tk * D, reinterpret_cast<float*>(smem4),
                  q0, T, Tk, live_k_tiles<C>(q0, Tk, causal, k_offset),
                  scale, causal, k_offset, m, l, o);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = r0 + 8 * i;
    if (qr >= T) continue;
    const size_t row = (size_t)bh * T + qr;
    float4* arow = reinterpret_cast<float4*>(acc_out + row * D);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      arow[4 * n + t] = make_float4(o[2 * n][2 * i], o[2 * n + 1][2 * i],
                                    o[2 * n][2 * i + 1],
                                    o[2 * n + 1][2 * i + 1]);
    if (t == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
  }
}

template <class C>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* m_in, const float* l_in, const float* acc_in,
                   float* m_out, float* l_out, float* acc_out, int bh, int t,
                   int tk, float scale, int causal, int k_offset,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_chunk_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return err;
  const int n_q = (t + C::BQ - 1) / C::BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  dim3 grid(bh, n_q);
  flash_chunk_kernel<C><<<grid, C::NT, C::bytes, stream>>>(
      q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, t, tk, scale,
      causal, k_offset);
  return cudaGetLastError();
}

}  // namespace

// q [bh, t, d], k/v [bh, tk, d]; carry in m_in/l_in [bh, t], acc_in
// [bh, t, d]; carry out m_out/l_out/acc_out of the same shapes (may be
// the carry in: each thread reads its own rows' carry before the fold
// and writes it after).  All float32, contiguous.  Returns the launch's
// cudaError_t.
extern "C" int flash_chunk_f32(const float* q, const float* k,
                               const float* v, const float* m_in,
                               const float* l_in, const float* acc_in,
                               float* m_out, float* l_out, float* acc_out,
                               int bh, int t, int tk, int d, float scale,
                               int causal, int k_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  // built for the flagship LM's head_dim only, like K1
  if (d != 128) return (int)cudaErrorInvalidValue;
  bool large = false;
  cudaError_t err = use_large<128>(bh, t, &large);
  if (err != cudaSuccess) return (int)err;
  return (int)(large ? launch<Large<128>>(q, k, v, m_in, l_in, acc_in, m_out,
                                          l_out, acc_out, bh, t, tk, scale,
                                          causal, k_offset, s)
                     : launch<Small<128>>(q, k, v, m_in, l_in, acc_in, m_out,
                                          l_out, acc_out, bh, t, tk, scale,
                                          causal, k_offset, s));
}

// The bf16 form: q, k, v bf16 [bh, t|tk, d], 16-byte aligned; the carry
// in and out float32 as above (out distinct from in).  Returns the
// launch's cudaError_t.
extern "C" int flash_chunk_bf16(const tc::bf16* q, const tc::bf16* k,
                                const tc::bf16* v, const float* m_in,
                                const float* l_in, const float* acc_in,
                                float* m_out, float* l_out, float* acc_out,
                                int bh, int t, int tk, int d, float scale,
                                int causal, int k_offset, void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  if (d != f16::D) return (int)cudaErrorInvalidValue;
  const f16::Carry carry{m_in, l_in, acc_in, m_out, l_out, acc_out};
  return (int)f16::run<true>(q, k, v, nullptr, nullptr, carry, bh, t, tk,
                             scale, causal, k_offset,
                             static_cast<cudaStream_t>(stream));
}
