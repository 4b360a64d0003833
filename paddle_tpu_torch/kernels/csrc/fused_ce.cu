// K10: fused softmax cross-entropy, float32: loss[n] = logsumexp(x[n, :])
// - x[n, label[n]], one pass over each row of logits.
//
// Replaces the TPU kernel paddle_tpu/kernels/fused.py _ce_kernel
// (launched by fused_softmax_cross_entropy): the class axis streams
// through the kernel with an online logsumexp (running max m and sum s,
// s rescaled by exp(m - m') when the max grows), so the [N, C]
// probability matrix never exists in device memory.  A label outside
// [0, C) picks nothing, as the TPU kernel's class-id compare does.
//
// What bounds it on the H100: every logit is read once and one exp is
// taken per logit, so at the LM's [32768, 8192] it moves 1 GiB, 0.32 ms
// at 3.35 TB/s, far above the exp and FMA time: memory-bound.  Design:
// one warp per row (a block holds a group of 8 rows, one per warp), each
// lane streaming 16-byte loads of its row with its own (m, s); the 32
// lane states merge through xor-shuffles with the same rescaling.  No
// shared memory, no atomics; the lane and merge order is fixed, so the
// result is deterministic.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ROWS = 8;       // rows per block, one per warp
constexpr int NT = 32 * ROWS;

__device__ __forceinline__ void fold(float& m, float& s, float x) {
  const float m_new = fmaxf(m, x);
  s = s * expf(m - m_new) + expf(x - m_new);
  m = m_new;
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
fused_ce_kernel(const float* __restrict__ logits,
                const int* __restrict__ labels, float* __restrict__ out,
                int n, int c) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= n) return;
  const float* x = logits + (size_t)row * c;
  float m = NEG_INF, s = 0.f;
  if (VEC) {  // every row starts 16-byte aligned
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = lane; i < c / 4; i += 32) {
      const float4 f = x4[i];
      const float mx = fmaxf(fmaxf(f.x, f.y), fmaxf(f.z, f.w));
      const float m_new = fmaxf(m, mx);
      s = s * expf(m - m_new) + expf(f.x - m_new) + expf(f.y - m_new) +
          expf(f.z - m_new) + expf(f.w - m_new);
      m = m_new;
    }
  } else {
    for (int i = lane; i < c; i += 32) fold(m, s, x[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float m_new = fmaxf(m, mo);
    s = s * expf(m - m_new) + so * expf(mo - m_new);
    m = m_new;
  }
  if (lane == 0) {
    const int lab = labels[row];
    const float picked = (lab >= 0 && lab < c) ? x[lab] : 0.f;
    out[row] = m + logf(s) - picked;
  }
}

}  // namespace

// logits [n, c] float32, labels [n] int32, out [n] float32; contiguous.
// Returns the launch's cudaError_t.
extern "C" int fused_ce_f32(const float* logits, const int* labels,
                            float* out, int n, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + ROWS - 1) / ROWS);
  if (c % 4 == 0 && reinterpret_cast<size_t>(logits) % 16 == 0)
    fused_ce_kernel<true><<<grid, NT, 0, s>>>(logits, labels, out, n, c);
  else
    fused_ce_kernel<false><<<grid, NT, 0, s>>>(logits, labels, out, n, c);
  return (int)cudaGetLastError();
}
