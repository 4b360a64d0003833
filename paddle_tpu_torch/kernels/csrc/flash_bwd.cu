// K2 and K3: flash attention backward from the saved log-sum-exp, float32.
//
// Replace the TPU kernels paddle_tpu/kernels/flash_attention.py
// _dq_kernel (launched by _flash_bwd_dq) and _dkv_kernel (launched by
// _flash_bwd_dkv).  Given Q, K, V, dO, the forward's per-row lse and
// delta = rowsum(dO * O) (computed by the caller, as the JAX package
// does), they rebuild the probability tile P = exp(Q K^T * scale - lse)
// tile by tile, form dS = P * (dO V^T - delta), and accumulate
//   K2: dQ = dS K * scale                    (one block per Q tile)
//   K3: dK = dS^T Q * scale, dV = P^T dO     (one block per K tile)
// The [T, Tk] score matrix never exists in device memory.
//
// What bounds them on the H100: in float32 there is no tensor-core path
// (TF32 would lose the 1e-4 agreement with the plain version), so at the
// training shape both are bound by the float32 FMA rate (67 TFLOP/s): K2
// does three T x Tk x D products per head, K3 four.  Design: the TPU's
// sequential grid axis becomes a loop inside the block; each output
// element belongs to exactly one block, so there are no atomics and the
// result is deterministic (the reason for the two-kernel split).  Tiles
// live in dynamic shared memory (above the 48 KB static limit), rows
// padded to D+1 floats so the 16 column lanes of a half-warp hit distinct
// banks; each thread owns 4 rows x (tile/16) scores and 4 rows x (D/16)
// accumulator columns, as in flash_fwd.cu.  Under the causal mask K2 stops
// at the diagonal and K3 starts there (the TPU kernels' `live` rule).
// Ragged T and Tk are masked here, not by the caller.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;        // 16 row groups x 16 column lanes

// ---------------------------------------------------------------- K2: dQ
constexpr int DQ_BQ = 64;      // query rows per block
constexpr int DQ_BK = 32;      // key rows per tile

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * DQ_BQ * (D + 1) + 2 * DQ_BK * (D + 1) +
          DQ_BQ * (DQ_BK + 1)) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int T, int Tk, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int RM = DQ_BQ / 16;   // query rows per thread
  constexpr int CN = DQ_BK / 16;   // score columns per thread
  constexpr int DN = D / 16;       // dQ columns per thread
  constexpr int SP = DQ_BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][DP], pre-scaled
  float* dOs = Qs + DQ_BQ * DP;     // [BQ][DP]
  float* Ks = dOs + DQ_BQ * DP;     // [BK][DP]
  float* Vs = Ks + DQ_BK * DP;      // [BK][DP]
  float* dSs = Vs + DQ_BK * DP;     // [BQ][BK + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * DQ_BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float* qb = q + (size_t)bh * T * D;
  const float* ob = dout + (size_t)bh * T * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;

  for (int i = tid; i < DQ_BQ * D; i += NT) {
    const int r = i / D, c = i % D, gr = q0 + r;
    const bool ok = gr < T;
    Qs[r * DP + c] = ok ? qb[(size_t)gr * D + c] * scale : 0.f;
    dOs[r * DP + c] = ok ? ob[(size_t)gr * D + c] : 0.f;
  }
  float lse_r[RM], delta_r[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty * RM + i;
    lse_r[i] = qr < T ? lse[(size_t)bh * T + qr] : 0.f;
    delta_r[i] = qr < T ? delta[(size_t)bh * T + qr] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int n_k = (Tk + DQ_BK - 1) / DQ_BK;
  if (causal) n_k = min(n_k, (q0 + DQ_BQ - 1) / DQ_BK + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * DQ_BK;
    __syncthreads();  // the previous tile's Ks/Vs/dSs are consumed
    for (int i = tid; i < DQ_BK * D; i += NT) {
      const int r = i / D, c = i % D, gr = k0 + r;
      const bool ok = gr < Tk;
      Ks[r * DP + c] = ok ? kb[(size_t)gr * D + c] : 0.f;
      Vs[r * DP + c] = ok ? vb[(size_t)gr * D + c] : 0.f;
    }
    __syncthreads();

    // S = (Q scale) K^T and dP = dO V^T, both [BQ, BK]
    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[CN], vv[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float qv = Qs[(ty * RM + i) * DP + d];
        const float ov = dOs[(ty * RM + i) * DP + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] += qv * kv[j];
          dp[i][j] += ov * vv[j];
        }
      }
    }
    // P from the saved lse, masked to exactly 0 above the diagonal and
    // past Tk; dS = P (dP - delta)
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qr = q0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool live = kc < Tk && !(causal && kc > qr);
        const float p = live ? expf(s[i][j] - lse_r[i]) : 0.f;
        dSs[(ty * RM + i) * SP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < DQ_BK; ++c) {
      float kk[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) kk[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float ds = dSs[(ty * RM + i) * SP + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] += ds * kk[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty * RM + i;
    if (qr >= T) continue;
    float* row = dq + ((size_t)bh * T + qr) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) row[tx + 16 * j] = acc[i][j] * scale;
  }
}

// ------------------------------------------------------------ K3: dK, dV
constexpr int DKV_BK = 64;     // key rows per block
constexpr int DKV_BQ = 32;     // query rows per tile

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * DKV_BK * (D + 1) + 2 * DKV_BQ * (D + 1) +
          DKV_BK * (DKV_BQ + 1) + 2 * DKV_BQ) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int T,
                     int Tk, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int RM = DKV_BK / 16;  // key rows per thread
  constexpr int CN = DKV_BQ / 16;  // score columns (query rows) per thread
  constexpr int DN = D / 16;       // dK/dV columns per thread
  constexpr int TP = DKV_BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BK][DP], pre-scaled
  float* Vs = Ks + DKV_BK * DP;     // [BK][DP]
  float* Qs = Vs + DKV_BK * DP;     // [BQ][DP]
  float* dOs = Qs + DKV_BQ * DP;    // [BQ][DP]
  float* Ts = dOs + DKV_BQ * DP;    // [BK][BQ + 1]: P^T, then dS^T
  float* lse_s = Ts + DKV_BK * TP;  // [BQ]
  float* delta_s = lse_s + DKV_BQ;  // [BQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * DKV_BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float* qb = q + (size_t)bh * T * D;
  const float* ob = dout + (size_t)bh * T * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;

  for (int i = tid; i < DKV_BK * D; i += NT) {
    const int r = i / D, c = i % D, gr = k0 + r;
    const bool ok = gr < Tk;
    Ks[r * DP + c] = ok ? kb[(size_t)gr * D + c] * scale : 0.f;
    Vs[r * DP + c] = ok ? vb[(size_t)gr * D + c] : 0.f;
  }
  float acc_k[RM][DN], acc_v[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_q = (T + DKV_BQ - 1) / DKV_BQ;
  // causal: query rows above this K tile's first row see none of it
  const int q_start = causal ? k0 / DKV_BQ : 0;
  for (int qt = q_start; qt < n_q; ++qt) {
    const int q0 = qt * DKV_BQ;
    __syncthreads();  // the previous tile's Qs/dOs/Ts are consumed
    for (int i = tid; i < DKV_BQ * D; i += NT) {
      const int r = i / D, c = i % D, gr = q0 + r;
      const bool ok = gr < T;
      Qs[r * DP + c] = ok ? qb[(size_t)gr * D + c] : 0.f;
      dOs[r * DP + c] = ok ? ob[(size_t)gr * D + c] : 0.f;
    }
    if (tid < DKV_BQ) {
      const int gr = q0 + tid;
      lse_s[tid] = gr < T ? lse[(size_t)bh * T + gr] : 0.f;
      delta_s[tid] = gr < T ? delta[(size_t)bh * T + gr] : 0.f;
    }
    __syncthreads();

    // S^T = (K scale) Q^T and dP^T = V dO^T, both [BK, BQ]: P^T is built
    // straight from K Q^T, never transposed
    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[CN], ov[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        qv[j] = Qs[(tx + 16 * j) * DP + d];
        ov[j] = dOs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float kv = Ks[(ty * RM + i) * DP + d];
        const float vv = Vs[(ty * RM + i) * DP + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] += kv * qv[j];
          dp[i][j] += vv * ov[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kr = k0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int qc = q0 + tx + 16 * j;
        const bool live = qc < T && kr < Tk && !(causal && qc < kr);
        const float p =
            live ? expf(s[i][j] - lse_s[tx + 16 * j]) : 0.f;
        s[i][j] = p * (dp[i][j] - delta_s[tx + 16 * j]);  // dS^T
        Ts[(ty * RM + i) * TP + tx + 16 * j] = p;
      }
    }
    __syncthreads();

    // dV += P^T dO
#pragma unroll 4
    for (int c = 0; c < DKV_BQ; ++c) {
      float oo[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) oo[j] = dOs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = Ts[(ty * RM + i) * TP + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc_v[i][j] += p * oo[j];
      }
    }
    __syncthreads();  // P^T is consumed: reuse Ts for dS^T
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        Ts[(ty * RM + i) * TP + tx + 16 * j] = s[i][j];
    __syncthreads();

    // dK += dS^T Q
#pragma unroll 4
    for (int c = 0; c < DKV_BQ; ++c) {
      float qq[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) qq[j] = Qs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float ds = Ts[(ty * RM + i) * TP + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc_k[i][j] += ds * qq[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kr = k0 + ty * RM + i;
    if (kr >= Tk) continue;
    float* krow = dk + ((size_t)bh * Tk + kr) * D;
    float* vrow = dv + ((size_t)bh * Tk + kr) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      krow[tx + 16 * j] = acc_k[i][j] * scale;
      vrow[tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse,
                      const float* delta, float* dq, int bh, int t, int tk,
                      float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + DQ_BQ - 1) / DQ_BQ, bh);
  flash_bwd_dq_kernel<D><<<grid, NT, bytes, stream>>>(
      q, k, v, dout, lse, delta, dq, t, tk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int bh,
                       int t, int tk, float scale, int causal,
                       cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + DKV_BK - 1) / DKV_BK, bh);
  flash_bwd_dkv_kernel<D><<<grid, NT, bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, t, tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q/dout [bh, t, d], k/v [bh, tk, d], lse/delta [bh, t], dq [bh, t, d];
// all float32, contiguous.  Returns the launch's cudaError_t.
extern "C" int flash_bwd_dq_f32(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* delta,
                                float* dq, int bh, int t, int tk, int d,
                                float scale, int causal, void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  // built for the flagship LM's head_dim only, like flash_fwd.cu
  if (d != 128) return (int)cudaErrorInvalidValue;
  return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, t, tk,
                             scale, causal,
                             static_cast<cudaStream_t>(stream));
}

// as above, writing dk and dv [bh, tk, d]
extern "C" int flash_bwd_dkv_f32(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dk, float* dv, int bh, int t, int tk,
                                 int d, float scale, int causal,
                                 void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  if (d != 128) return (int)cudaErrorInvalidValue;
  return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, t, tk,
                              scale, causal,
                              static_cast<cudaStream_t>(stream));
}
