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
// in float32, out rounded to bf16 once.  S = Q K^T is one
// mma.sync.m16n8k16 bf16 MMA a product, exact products summed in f32,
// scaled in f32 afterwards.  P is float32 in the reference; rounding it
// to bf16 before P V (FlashAttention-2's choice) would be a 2^-9 error a
// term, so P is split into bf16 hi + lo (bf16_mma.cuh) and P V takes
// two exact MMAs a product: 3 bf16 MMAs for the 2 products, at most
// 989.4 / 1.5 = 660 TFLOP/s of the card's dense bf16 rate.  A causal
// [16, 8, 2048, 128] forward is 137 GFLOP against 257 MiB: 0.21 ms of
// those MMAs, 0.14 ms at the full rate, 0.08 ms of bytes.  Design, a
// simple one: a block per (batch*head, 64-row Q tile), 4 warps of 16
// rows; Q's fragments by ldmatrix from the resident Q tile (held in
// registers they would push the accumulator into spills); 64-key
// K/V tiles double-buffered by cp.async (16 bytes = 8 bf16 a copy, rows
// padded to 136 elements so each ldmatrix phase hits distinct banks),
// K's B fragments by ldmatrix, V's by ldmatrix.trans; the online
// softmax as in the f32 form; P goes from C to A layout in registers
// (bf16_mma.cuh), and each tile's P V sums in fresh fragments added to
// the accumulator in f32.  Causal blocks launch heaviest first, and a
// warp skips a tile wholly in its rows' future.
#include "bf16_mma.cuh"
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

// ------------------------------------------------------------ bf16 form

namespace f16 {

using tc::bf16;

constexpr int D = 128;          // head_dim
constexpr int BQ = 64;          // query rows a block: 4 warps of 16
constexpr int BK = 64;          // keys a K/V tile
constexpr int NT = BQ / 16 * 32;
constexpr int S = D + 8;        // row stride, elements (272 bytes)
constexpr int NJ = BK / 8;      // score n-tiles of a K tile
constexpr int KD = D / 16;      // k16 steps over d
constexpr int KS = BK / 16;     // k16 steps over a tile's keys
constexpr int TILE = BK * S;
constexpr int bytes = (BQ * S + 4 * TILE) * (int)sizeof(bf16);
static_assert(bytes <= 113 * 1024, "two blocks an SM");

// rows [r0, r0 + R) of a [n, D] bf16 matrix into shared rows of stride
// S, 16 bytes a copy, rows past n zero-filled
template <int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int n) {
  constexpr int C = D / 8;
  static_assert(R * C % NT == 0, "tile copies must split evenly");
#pragma unroll
  for (int it = 0; it < R * C / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < n;
    cp16(dst + r * S + 8 * c, src + (size_t)(ok ? r0 + r : 0) * D + 8 * c,
         ok);
  }
}

__global__ void __launch_bounds__(NT, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int T, int Tk, float scale,
                      int causal) {
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* KV = Qs + BQ * S;     // two buffers: K tile, V tile
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;
  const int row0 = q0 + rw + g;            // this thread's rows: + 0, + 8
  const bf16* kb = k + (size_t)bh * Tk * D;
  const bf16* vb = v + (size_t)bh * Tk * D;

  int n_k = (Tk + BK - 1) / BK;
  if (causal) n_k = min(n_k, (q0 + BQ - 1) / BK + 1);

  load_rows<BQ>(Qs, q + (size_t)bh * T * D, q0, T);
  load_rows<BK>(KV, kb, 0, Tk);
  load_rows<BK>(KV + TILE, vb, 0, Tk);
  cp_commit();

  // ldmatrix lanes: A rows 0-15 at k 0 / 8; B (K^T) keys 0-7 / 8-15 at
  // d 0 / 8; B (V) keys 0-7 / 8-15 at d 0 / 8, transposed
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int kb_row = lane % 8 + (lane / 16) * 8, kb_col = ((lane / 8) % 2) * 8;
  const int vb_row = lane % 8 + ((lane / 8) % 2) * 8, vb_col = (lane / 16) * 8;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    const bf16* Ks = KV + (kt & 1) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    if (kt + 1 < n_k) {
      bf16* nk = KV + ((kt + 1) & 1) * 2 * TILE;
      load_rows<BK>(nk, kb, k0 + BK, Tk);
      load_rows<BK>(nk + TILE, vb, k0 + BK, Tk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();               // tile kt (and at kt = 0 the Q tile)
    // a warp whose rows all lie before the tile's first key skips it
    if (!causal || q0 + rw + 15 >= k0) {
      float s[NJ][4];
      zero(s);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qf[4];
        tc::ldsm4(qf, Qs + (rw + a_row) * S + 16 * kk + a_col);
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          uint32_t b[4];
          tc::ldsm4(b, Ks + (16 * jj + kb_row) * S + 16 * kk + kb_col);
          tc::mma_bf16(s[2 * jj], qf, b[0], b[1]);
          tc::mma_bf16(s[2 * jj + 1], qf, b[2], b[3]);
        }
      }
      // scale, then mask (only a tile on the warp's diagonal or the
      // ragged Tk edge has masked scores)
      const bool edge = k0 + BK > Tk || (causal && q0 + rw < k0 + BK - 1);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (edge) {
            const int kc = k0 + 8 * j + 2 * t + (e & 1);
            const int r = row0 + 8 * (e / 2);
            if (kc >= Tk || (causal && r < kc)) x = NEG_INF;
          }
          s[j][e] = x;
        }
      // the online softmax of rows g (s[j][0..1]) and g + 8 (s[j][2..3])
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
      const float a0 = __expf(m[0] - mn0), a1 = __expf(m[1] - mn1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = s[j][e] <= 0.5f * NEG_INF ? 0.f : __expf(s[j][e] - mn0);
          s[j][2 + e] =
              s[j][2 + e] <= 0.5f * NEG_INF ? 0.f : __expf(s[j][2 + e] - mn1);
          ps0 += s[j][e];
          ps1 += s[j][2 + e];
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
      }
      l[0] = l[0] * a0 + ps0;
      l[1] = l[1] * a1 + ps1;
      m[0] = mn0;
      m[1] = mn1;
      // P in A layout, split hi + lo: k16 step ks is n-tiles 2ks, 2ks + 1
      uint32_t ph[KS][4], pl[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        split_bf16(s[2 * ks][0], s[2 * ks][1], ph[ks][0], pl[ks][0]);
        split_bf16(s[2 * ks][2], s[2 * ks][3], ph[ks][1], pl[ks][1]);
        split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[ks][2], pl[ks][2]);
        split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[ks][3], pl[ks][3]);
      }
      // o = o alpha + p v, the tile's terms in fresh fragments
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        float x0[4] = {0.f, 0.f, 0.f, 0.f}, x1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];
          tc::ldsm4_t(b, Vs + (16 * ks + vb_row) * S + 16 * dn + vb_col);
          tc::mma_bf16(x0, pl[ks], b[0], b[1]);
          tc::mma_bf16(x0, ph[ks], b[0], b[1]);
          tc::mma_bf16(x1, pl[ks], b[2], b[3]);
          tc::mma_bf16(x1, ph[ks], b[2], b[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = e < 2 ? a0 : a1;
          o[2 * dn][e] = o[2 * dn][e] * a + x0[e];
          o[2 * dn + 1][e] = o[2 * dn + 1][e] * a + x1[e];
        }
      }
    }
    __syncthreads();               // tile kt's buffer is consumed
  }

  // out = o / l rounded once; n-tile n holds d = 8n + 2t, + 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = row0 + 8 * i;
    if (qr >= T) continue;
    const float inv = 1.f / l[i];
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + ((size_t)bh * T + qr) * D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      orow[4 * n + t] = pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (t == 0) lse[(size_t)bh * T + qr] = m[i] + logf(l[i]);
  }
}

cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, int bh, int t, int tk, float scale, int causal,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int n_q = (t + BQ - 1) / BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  dim3 grid(bh, n_q);
  flash_fwd_bf16_kernel<<<grid, NT, bytes, stream>>>(q, k, v, out, lse, t, tk,
                                                     scale, causal);
  return cudaGetLastError();
}

}  // namespace f16

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
  return (int)f16::launch(q, k, v, out, lse, bh, t, tk, scale, causal,
                          static_cast<cudaStream_t>(stream));
}
