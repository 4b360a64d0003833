// The online-softmax tile loop shared by K1 (flash_fwd.cu) and K9
// (flash_chunk.cu), float32.
//
// A block owns a 64-row Q tile of one (batch*head) and loops over
// 32-row K/V tiles, folding each into the running max m, sum l and
// unnormalized accumulator acc that its threads hold in registers:
//
//   s   = (scale q) k^T, NEG_INF where q_pos < k_offset + k_pos (causal)
//         or past the ragged Tk edge
//   m'  = max(m, rowmax s)
//   p   = 0 where s <= NEG_INF / 2, else exp(s - m')
//   l'  = l exp(m - m') + rowsum p,   acc' = acc exp(m - m') + p v
//
// Masked scores carry exactly no mass, so a row with no live key in a
// tile keeps (m, l, acc) bit for bit.  256 threads: 16 row groups x 16
// column lanes, each thread 4 query rows x 2 scores and 4 rows x D/16
// output columns; rows padded to D+1 floats keep a half-warp's 16 lanes
// on distinct shared-memory banks.  Masked scores are NEG_INF = -1e30
// (not -inf), as in the reference.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace flash {

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

// K tiles a Q tile starting at row q0 visits: all of them, or under
// the causal mask those with k_offset + kt * BK <= q0 + BQ - 1 (the TPU
// kernels' skip rule; none when the whole block is in the future).
__device__ __forceinline__ int live_k_tiles(int q0, int Tk, int causal,
                                            int k_offset) {
  const int n_k = (Tk + BK - 1) / BK;
  if (!causal) return n_k;
  const int last = q0 + BQ - 1 - k_offset;
  return last < 0 ? 0 : min(n_k, last / BK + 1);
}

// Fold K/V tiles [0, n_k) of one (batch*head) into the thread's (m, l,
// acc).  qb/kb/vb point at that (batch*head)'s [T, D] / [Tk, D] rows;
// smem holds the block's dynamic shared memory.
template <int D>
__device__ __forceinline__ void fold_k_tiles(
    const float* __restrict__ qb, const float* __restrict__ kb,
    const float* __restrict__ vb, float* smem, int q0, int T, int Tk,
    int n_k, float scale, int causal, int k_offset, float (&m)[RM],
    float (&l)[RM], float (&acc)[RM][D / 16]) {
  constexpr int DP = D + 1;
  constexpr int DN = D / 16;
  float* Qs = smem;              // [BQ][DP], pre-scaled
  float* Ks = Qs + BQ * DP;      // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][BK + 1]
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  if (n_k == 0) return;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, gr = q0 + r;
    Qs[r * DP + c] = gr < T ? qb[(size_t)gr * D + c] * scale : 0.f;
  }

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
        if (kc >= Tk || (causal && qr < k_offset + kc)) s[i][j] = NEG_INF;
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
        const float p = s[i][j] <= 0.5f * NEG_INF ? 0.f
                                                  : expf(s[i][j] - m_new);
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
}

}  // namespace flash
