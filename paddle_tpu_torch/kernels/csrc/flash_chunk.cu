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
// What bounds it on the H100: a non-causal [16, 8, 512, 128] block is
// 17.2 GFLOP of float32 FMAs against 160 MiB of bytes (q, k, v, the
// carry in and out), 0.256 ms at 67 TFLOP/s against 0.050 ms at
// 3.35 TB/s, so FLOP-bound like K1.  Design: K1's tile loop
// (flash_tile.cuh's fold_k_tiles: a block per (batch*head, 64-row Q
// tile), 32-row K/V tiles looped inside the block); the carry is read
// into registers before the loop and written after it, the carry's
// extra cost over K1 (acc read and written once per fold).
#include "flash_tile.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* m_in,
                   const float* l_in, const float* acc_in, float* m_out,
                   float* l_out, float* acc_out, int T, int Tk, float scale,
                   int causal, int k_offset) {
  constexpr int DN = D / 16;
  extern __shared__ float smem[];
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  // the carry of this thread's rows; rows past T are never written
  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty * RM + i;
    const bool ok = qr < T;
    const size_t row = (size_t)bh * T + qr;
    m[i] = ok ? m_in[row] : NEG_INF;
    l[i] = ok ? l_in[row] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      acc[i][j] = ok ? acc_in[row * D + tx + 16 * j] : 0.f;
  }
  fold_k_tiles<D>(q + (size_t)bh * T * D, k + (size_t)bh * Tk * D,
                  v + (size_t)bh * Tk * D, smem, q0, T, Tk,
                  live_k_tiles(q0, Tk, causal, k_offset), scale, causal,
                  k_offset, m, l, acc);

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty * RM + i;
    if (qr >= T) continue;
    const size_t row = (size_t)bh * T + qr;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc_out[row * D + tx + 16 * j] = acc[i][j];
    if (tx == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* m_in, const float* l_in, const float* acc_in,
                   float* m_out, float* l_out, float* acc_out, int bh, int t,
                   int tk, float scale, int causal, int k_offset,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_chunk_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BQ - 1) / BQ, bh);
  flash_chunk_kernel<D><<<grid, NT, bytes, stream>>>(
      q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, t, tk, scale,
      causal, k_offset);
  return cudaGetLastError();
}

}  // namespace

// q [bh, t, d], k/v [bh, tk, d]; carry in m_in/l_in [bh, t], acc_in
// [bh, t, d]; carry out m_out/l_out/acc_out of the same shapes (may be
// the carry in: each block reads its own rows before it writes them).
// All float32, contiguous.  Returns the launch's cudaError_t.
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
  return (int)launch<128>(q, k, v, m_in, l_in, acc_in, m_out, l_out,
                          acc_out, bh, t, tk, scale, causal, k_offset, s);
}
