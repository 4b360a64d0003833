// The online-softmax tile loop shared by K1 (flash_fwd.cu) and K9
// (flash_chunk.cu): float32 in and out, the two products on the tensor
// cores in split-TF32.
//
// A block owns a BQ-row Q tile of one (batch*head); each of its BQ / 16
// warps owns 16 of those rows, in the FlashAttention-2 layout: the
// warp's running max m, sum l and unnormalized accumulator o live in
// mma.m16n8k8 C-fragment registers, and a row's max and sum reduce over
// the 4 lanes of a quad by shuffles.  The block loops over BK-row K/V
// tiles and folds each into (m, l, o):
//
//   s   = (scale q) k^T, NEG_INF where q_pos < k_offset + k_pos (causal)
//         or past the ragged Tk edge
//   m'  = max(m, rowmax s)
//   p   = 0 where s <= NEG_INF / 2, else exp(s - m')
//   l'  = l exp(m - m') + rowsum p,   o' = o exp(m - m') + p v
//
// Masked scores carry exactly no mass, so a row with no live key in a
// tile keeps (m, l, o) bit for bit.  Masked scores are NEG_INF = -1e30
// (not -inf), as in the reference.
//
// Split-TF32: every operand x is split into hi = x rounded to TF32 and
// lo = x - hi, and a product is lo*hi + hi*lo + hi*hi on
// mma.sync.m16n8k8.tf32 with float32 accumulation; what is lost, lo*lo
// and lo's bits past TF32, is ~2^-21 relative, so the products keep
// float32's accuracy, where single-pass TF32 keeps ~2^-11.  Each
// operand is split once: the scaled Q tile when it lands, hi into
// registers and lo back into shared memory; a K/V tile when it lands,
// hi in place and lo beside it, each thread splitting the 16-byte
// chunks it copied; P in registers.
//
// Layout and fragments.  Q and K rows are padded to D + 8 floats and V
// rows to D + 4, which puts every fragment load below on distinct banks.
// A contraction may visit its index in any order as long as both
// operands agree, and the loop uses that twice: (1) in s = q k^T the
// A-fragment column t holds d = 8kk + 2t and column t + 4 holds d + 1,
// so each thread's Q and K fragments are float2 loads; (2) in o += p v
// the A-fragment column t holds key 2t and t + 4 key 2t + 1, exactly
// the two scores the thread's s C-fragment holds, so P goes from C to A
// layout in registers with no shuffle; and output n-tile 2n / 2n + 1
// column c holds d = 16n + 2c / 16n + 2c + 1, so each V fragment pair is
// a float2 load and each thread's output is a float4.
//
// K/V tiles are double buffered: cp.async (16 bytes, zero-filled past
// Tk) brings tile kt + 1 while the warps split and fold tile kt.  So
// q, k, v, out and K9's acc carry must start on 16-byte boundaries
// (the 16-byte copies and float4 accesses); the wrappers check it.  Under
// the causal mask a warp skips the 8-key groups, and so whole tiles,
// that lie wholly in its own 16 rows' future.
//
// Two tile shapes, chosen by the launchers from the grid (Small / Large
// below): 64 x 16 (4 warps, 103 KiB of shared memory, two blocks an SM)
// keeps a short or one-head grid's blocks spread over the SMs; 128 x 32
// (8 warps, 207 KiB, one block an SM) splits and reads each K/V element
// once for twice the query rows, which pays once the grid gives every
// SM a block (use_large).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"   // the split-TF32 primitives

namespace flash {

using namespace tc;

constexpr float NEG_INF = -1e30f;

template <int D_, int BQ_, int BK_, int MIN_BLOCKS_>
struct Tile {
  static_assert(D_ % 32 == 0, "head_dim must be a multiple of 32");
  static constexpr int D = D_;
  static constexpr int BQ = BQ_;           // query rows per block
  static constexpr int BK = BK_;           // key rows per K/V tile
  static constexpr int NT = BQ / 16 * 32;  // threads: a warp per 16 rows
  static constexpr int NJ = BK / 8;        // 8-key groups (s n-tiles)
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // blocks an SM
  static constexpr int QS = D + 8;   // Q / K row stride, = 8 mod 32 floats
  static constexpr int VS = D + 4;   // V row stride, = 4 mod 32 floats
  static constexpr int KD = D / 8;   // k-steps of q k^T
  // one K/V buffer: K hi, K lo [BK][QS], then V hi, V lo [BK][VS]
  static constexpr int BUF = 2 * BK * QS + 2 * BK * VS;
  static constexpr int bytes = (BQ * QS + 2 * BUF) * (int)sizeof(float);
  static_assert(bytes * MIN_BLOCKS <= 227 * 1024, "shared memory");
};

template <int D>
using Small = Tile<D, 64, 16, 2>;
template <int D>
using Large = Tile<D, 128, 32, 1>;

// Whether bh heads of t query rows take the Large tiles: when those
// give every SM a block (else Small).  Both forms timed at the same
// shapes (tools/flash_forms.py, H100): Small wins at 128 Large blocks
// (8 heads of 2048 rows) by 3 %, Large from 192 blocks (12 heads) on,
// by 5-10 %.
template <int D>
inline cudaError_t use_large(int bh, int t, bool* large) {
  const SmCount& c = sm_count();
  constexpr int bq = Large<D>::BQ;
  *large = (long long)bh * ((t + bq - 1) / bq) >= c.sms;
  return c.err;
}

// K tiles a Q tile starting at row q0 visits: all of them, or under
// the causal mask those with k_offset + kt * BK <= q0 + BQ - 1 (the TPU
// kernels' skip rule; none when the whole block is in the future).
template <class C>
__device__ __forceinline__ int live_k_tiles(int q0, int Tk, int causal,
                                            int k_offset) {
  constexpr int BQ = C::BQ, BK = C::BK;
  const int n_k = (Tk + BK - 1) / BK;
  if (!causal) return n_k;
  const int last = q0 + BQ - 1 - k_offset;
  return last < 0 ? 0 : min(n_k, last / BK + 1);
}

// Rows [r0, r0 + R) of a [n, D] matrix into shared rows of stride S,
// 16 bytes a copy, rows past n zero-filled (a zero V row times p = 0
// adds exactly nothing; garbage could be NaN).
template <int D, int R, int S, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n) {
  constexpr int C = D / 4;
  static_assert(R * C % NT == 0, "tile copies must split evenly");
#pragma unroll
  for (int it = 0; it < R * C / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < n;
    cp16(dst + r * S + 4 * c, src + (size_t)(ok ? r0 + r : 0) * D + 4 * c,
         ok);
  }
}

// Split the chunks load_rows<D, R, S, NT> had this thread copy: hi in
// place, lo into the same place of lo_rows.
template <int D, int R, int S, int NT>
__device__ __forceinline__ void split_rows(float* rows, float* lo_rows) {
  constexpr int C = D / 4;
#pragma unroll
  for (int it = 0; it < R * C / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int at = (i / C) * S + 4 * (i % C);
    float4* p = reinterpret_cast<float4*>(rows + at);
    const float4 x = *p;
    uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
    split(x.x, h0, l0);
    split(x.y, h1, l1);
    split(x.z, h2, l2);
    split(x.w, h3, l3);
    *p = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(h2), __uint_as_float(h3));
    *reinterpret_cast<float4*>(lo_rows + at) =
        make_float4(__uint_as_float(l0), __uint_as_float(l1),
                    __uint_as_float(l2), __uint_as_float(l3));
  }
}

// Fold one split K/V tile (keys k0 .. k0 + BK - 1 of the block) into
// the warp's (m, l, o).  Qw: the warp's 16 rows of Q lo; r0: the
// position of its first row; live: its 8-key groups with a live key
// (>= 1).
template <class C>
__device__ __forceinline__ void fold_tile(
    const float* Qw, const float* Kh, const float* Kl, const float* Vh,
    const float* Vl, const uint32_t (&qh)[C::D / 8][4], int r0, int k0,
    int Tk, int causal, int k_offset, int live, float (&m)[2],
    float (&l)[2], float (&o)[C::D / 8][4]) {
  constexpr int D = C::D, BK = C::BK, NJ = C::NJ;
  constexpr int QS = C::QS, VS = C::VS, KD = C::KD;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  // s = (scale q) k^T: n-tile j holds keys 8j .. 8j + 7 of the tile.
  // The three terms of the split sum into three accumulators, added in
  // float32 at the end: the tensor cores' accumulation truncates to the
  // accumulator's magnitude, so the small terms summed beside the large
  // ones would each lose bits of s; and three 16-deep chains of
  // dependent MMAs instead of one 48-deep chain keep the pipe busy.
  float s[NJ][4], sa[NJ][4], sb[NJ][4];
  zero(s);
  zero(sa);
  zero(sb);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const float2 x0 =
        *reinterpret_cast<const float2*>(Qw + g * QS + 8 * kk + 2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(
        Qw + (g + 8) * QS + 8 * kk + 2 * t);
    const uint32_t ql[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                            __float_as_uint(x0.y), __float_as_uint(x1.y)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < live) {
        const int at = (8 * j + g) * QS + 8 * kk + 2 * t;
        const float2 kh = *reinterpret_cast<const float2*>(Kh + at);
        const float2 kl = *reinterpret_cast<const float2*>(Kl + at);
        const uint32_t h0 = __float_as_uint(kh.x), h1 = __float_as_uint(kh.y);
        const uint32_t l0 = __float_as_uint(kl.x), l1 = __float_as_uint(kl.y);
        mma(sa[j], ql, h0, h1);
        mma(sb[j], qh[kk], l0, l1);
        mma(s[j], qh[kk], h0, h1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += sa[j][e] + sb[j][e];

  // mask (only a tile on the warp's diagonal or the ragged Tk edge has
  // masked scores), then the online softmax of rows g (s[j][0..1]) and
  // g + 8 (s[j][2..3]); a row's 8 scores of a tile sit on the 4 lanes of
  // a quad, so xor-shuffles 1 and 2 reduce it
  const int row0 = r0 + g, row1 = row0 + 8;
  if (k0 + BK > Tk || (causal && r0 < k_offset + k0 + BK - 1)) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + 8 * j + 2 * t + e;
        const bool dead = j >= live || kc >= Tk;
        if (dead || (causal && row0 < k_offset + kc)) s[j][e] = NEG_INF;
        if (dead || (causal && row1 < k_offset + kc)) s[j][2 + e] = NEG_INF;
      }
    }
  }
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
  // once the running max settles, most tiles leave every row's max
  // where it was (alpha = exp(0) = 1): skip the warp's 64 multiplies
  if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
  }

  // o += p v, a k-step per live 8-key group
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < live) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);   // row g,     key 2t
      split(s[j][2], ph[1], pl[1]);   // row g + 8, key 2t
      split(s[j][1], ph[2], pl[2]);   // row g,     key 2t + 1
      split(s[j][3], ph[3], pl[3]);   // row g + 8, key 2t + 1
      const int at = (8 * j + 2 * t) * VS + 2 * g;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        const float2 xh = *reinterpret_cast<const float2*>(Vh + at + 16 * n);
        const float2 yh =
            *reinterpret_cast<const float2*>(Vh + at + VS + 16 * n);
        const float2 xl = *reinterpret_cast<const float2*>(Vl + at + 16 * n);
        const float2 yl =
            *reinterpret_cast<const float2*>(Vl + at + VS + 16 * n);
        mma3(o[2 * n], ph, pl, __float_as_uint(xh.x), __float_as_uint(yh.x),
             __float_as_uint(xl.x), __float_as_uint(yl.x));
        mma3(o[2 * n + 1], ph, pl, __float_as_uint(xh.y),
             __float_as_uint(yh.y), __float_as_uint(xl.y),
             __float_as_uint(yl.y));
      }
    }
  }
}

// Fold K/V tiles [0, n_k) of one (batch*head) into the warp's (m, l, o)
// (rows g and g + 8 of the warp's 16).  qb/kb/vb point at that
// (batch*head)'s [T, D] / [Tk, D] rows; smem holds C::bytes of dynamic
// shared memory.  Every thread of the block must call it.
template <class C>
__device__ __forceinline__ void fold_k_tiles(
    const float* __restrict__ qb, const float* __restrict__ kb,
    const float* __restrict__ vb, float* smem, int q0, int T, int Tk,
    int n_k, float scale, int causal, int k_offset, float (&m)[2],
    float (&l)[2], float (&o)[C::D / 8][4]) {
  constexpr int D = C::D, BQ = C::BQ, BK = C::BK, NT = C::NT, NJ = C::NJ;
  constexpr int QS = C::QS, VS = C::VS, KD = C::KD, BUF = C::BUF;
  float* Qs = smem;                 // [BQ][QS]: q, then its lo part
  float* KV = Qs + BQ * QS;         // two K/V buffers
  if (n_k == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;
  const int last = q0 + rw + 15;    // the warp's last query position

  load_rows<D, BQ, QS, NT>(Qs, qb, q0, T);
  load_rows<D, BK, QS, NT>(KV, kb, 0, Tk);
  load_rows<D, BK, VS, NT>(KV + 2 * BK * QS, vb, 0, Tk);
  cp_commit();
  cp_wait<0>();
  __syncthreads();                  // the Q tile and K/V tile 0 have landed

  // split scale * q once: hi into registers, lo back in place (each
  // thread rewrites just the elements it read, of its warp's rows)
  uint32_t qh[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    float2* p0 =
        reinterpret_cast<float2*>(Qs + (rw + g) * QS + 8 * kk + 2 * t);
    float2* p1 =
        reinterpret_cast<float2*>(Qs + (rw + g + 8) * QS + 8 * kk + 2 * t);
    const float2 x0 = *p0, x1 = *p1;
    uint32_t l0, l1, l2, l3;
    split(x0.x * scale, qh[kk][0], l0);
    split(x1.x * scale, qh[kk][1], l1);
    split(x0.y * scale, qh[kk][2], l2);
    split(x1.y * scale, qh[kk][3], l3);
    *p0 = make_float2(__uint_as_float(l0), __uint_as_float(l2));
    *p1 = make_float2(__uint_as_float(l1), __uint_as_float(l3));
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    float* Kh = KV + (kt & 1) * BUF;
    float* Kl = Kh + BK * QS;
    float* Vh = Kl + BK * QS;
    float* Vl = Vh + BK * VS;
    if (kt + 1 < n_k) {
      float* nk = KV + ((kt + 1) & 1) * BUF;
      load_rows<D, BK, QS, NT>(nk, kb, k0 + BK, Tk);
      load_rows<D, BK, VS, NT>(nk + 2 * BK * QS, vb, k0 + BK, Tk);
    }
    cp_commit();
    cp_wait<1>();                   // this thread's chunks of tile kt
    split_rows<D, BK, QS, NT>(Kh, Kl);
    split_rows<D, BK, VS, NT>(Vh, Vl);
    __syncthreads();                // tile kt split, the Q lo part written
    // the warp's 8-key groups with a live key: past Tk none, and under
    // the causal mask none wholly in the future of its last row
    int live = min(NJ, (Tk - k0 + 7) / 8);
    if (causal) {
      const int span = last - k_offset - k0;
      live = span < 0 ? 0 : min(live, span / 8 + 1);
    }
    if (live > 0)
      fold_tile<C>(Qs + rw * QS, Kh, Kl, Vh, Vl, qh, q0 + rw, k0, Tk, causal,
                   k_offset, live, m, l, o);
    __syncthreads();                // tile kt's buffer is consumed
  }
}

}  // namespace flash
