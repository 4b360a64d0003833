// K2 and K3: flash attention backward from the saved log-sum-exp, float32,
// the seven products in split-TF32 on the tensor cores.
//
// Replace the TPU kernels paddle_tpu/kernels/flash_attention.py
// _dq_kernel (launched by _flash_bwd_dq) and _dkv_kernel (launched by
// _flash_bwd_dkv).  Given Q, K, V, dO, the forward's per-row lse and
// delta = rowsum(dO * O) (computed by the caller, as the JAX package
// does), they rebuild the probability tile P = exp(Q K^T scale - lse)
// tile by tile, form dS = P (dO V^T - delta), and accumulate
//   K2: dQ = dS K scale                      (a block per Q tile)
//   K3: dK = dS^T Q scale, dV = P^T dO       (a block per K tile)
// Each output element is written by exactly one block: no atomics, and
// the result is deterministic (the reason for the two-kernel split).
// The [T, Tk] score matrix never exists in device memory.  The mask is
// the chunk form's: a score is dead where q_pos < k_offset + k_pos
// (causal; k_offset 0 is the plain top-left mask), past the ragged T or
// Tk edge, or in a row whose lse is NEG_INF (a row with no live key);
// a dead score has p = 0 exactly, so zero-filled rows add exactly
// nothing.
//
// What bounds them on the H100: their products, K2 three and K3 four
// T x Tk x D products a head (about half of that causal), done in
// split-TF32 on the tensor cores (flash_tile.cuh: x = hi + lo, hi*hi +
// hi*lo + lo*hi on mma.sync.m16n8k8.tf32, f32-accurate), so at most
// 494.7 / 3 TFLOP/s; against that, the bytes (q, k, v, dO, lse, delta
// read once, the gradients written once) at 3.35 TB/s.  At the training
// shape [16, 8, 2048, 128] causal that is 1.25 ms (K2) and 1.67 ms (K3)
// of products, operation-bound.
//
// Design: both kernels are one loop.  A block of 8 warps owns BR = 128
// resident rows of two operands (K2: Q and dO; K3: K and V), a warp 16
// of them, and streams BT = 16-row tiles of the other two (K2: K and V;
// K3: Q and dO, with their lse and delta), double-buffered by cp.async.
// Per tile each warp computes, in mma.sync C-fragments,
//   c1 = R1 S1^T, c2 = R2 S2^T        (K2: s, dp; K3: s^T, dp^T)
// then p and ds in registers, and accumulates into 16 x D fragments
//   K2: dq += ds S1;   K3: dv += p^T S2, dk += ds^T S1,
// each tile's terms summed on the tensor cores in fresh fragments and
// added to the long-lived accumulator in float32 (round to nearest), so
// the tensor cores' truncating accumulation never runs over a whole
// row of the sequence.
// K3 builds p^T straight from K Q^T, never a transpose (the reference's
// transpose-free form).
//
// Registers: a warp's 16 x 128 f32 accumulator is 64 registers a thread,
// K3 holds two.  So no operand stays resident in registers: the
// resident rows stay raw in shared memory and each warp splits its A
// fragments as it loads them (a LOP and a FADD an element, reused over
// the tile's two 8-row groups); each streamed tile is split once, hi in
// place and lo beside it, by the thread that copied each 16-byte chunk.
// The inner loops have no branch: on an edge or diagonal tile the
// groups a warp could skip are zero-filled or finite rows whose p the
// mask sets to 0, and a warp with no live score in a tile skips it.
// Shared memory: resident 2 x 128 x 132 floats, two buffers of 4 x 16 x
// 132 (+ 32) = 203,008 bytes, one block an SM.
//
// Layout: one row stride S = D + 4 (= 4 mod 32) for every tile, because
// a streamed tile is read in two forms.  In c = R S^T (k = d) the
// fragments take the natural d order, A column t <-> d = 8kk + t, which
// is ldmatrix's: one ldmatrix.x4 loads an A fragment or the B fragments
// of both 8-row groups, 8 rows of 16 bytes a phase on banks 4r .. 4r +
// 3, all distinct.  In acc += P S (k = the tile's row) the A-fragment
// column t holds row 2t and t + 4 row 2t + 1, exactly the two scores a
// thread's C-fragment holds, so P goes from C to A layout in registers;
// B is a float2 at rows 2t, 2t + 1 and d = 16n + 2g: banks 8t + 2g
// (+1), distinct in each half-warp; and the output n-tile pair (2n,
// 2n + 1) holds d = 16n + 4t .. + 3 of a row, a float4 store.  So q,
// k, v, dO and the gradients must start on 16-byte boundaries; the
// wrappers check it.
//
// Under the causal mask K2 stops at the last K tile its block sees and
// a warp skips a tile wholly in its rows' future; K3 starts at the
// first Q tile that sees its block (the TPU kernels' `live` rule) and a
// warp skips a tile wholly before its keys.
// Causal K2 blocks launch heaviest first, as K1's; K3's heaviest (the
// first K tiles) launch first in plain order.
//
// The bf16 forms (flash_bwd_dq_bf16, flash_bwd_dkv_bf16; the LM under
// AMP): bf16 Q, K, V and dO (dO cast to O's dtype by the caller), f32
// lse and delta, the same function, the same mask, the same two-kernel
// split and k_offset argument, no atomics.  S = Q K^T and dP = dO V^T
// are single exact bf16 MMAs (mma.sync.m16n8k16, f32 sums); P and dS =
// P (dP - delta) stay f32, and the three products that take them (dV +=
// P^T dO, dQ += dS K, dK += dS^T Q) take them split into bf16 hi + lo
// (bf16_mma.cuh), two exact MMAs a product, so the gradients keep f32's
// accuracy until their one rounding to bf16.  Products on the causal
// training shape: K2 1.5 x 68.7 GFLOP worth of MMAs, K3 2 x; at the
// card's dense bf16 rate the operations, not the bytes, bound both.
// Design, a simple one: a block of 4 warps owns 64 resident rows
// (K2: Q and dO; K3: K and V) in shared memory, a warp 16 of them, and
// streams tiles of the other two (K2: 32 keys of K and V; K3: 16
// queries of Q and dO with their lse and delta), double-buffered by
// cp.async; A fragments by ldmatrix from the resident rows, B fragments
// by ldmatrix (the k = d products) or ldmatrix.trans (the k = row
// products) from the streamed tile; P / dS go from C to A layout in
// registers; each tile's terms sum in fresh fragments added to the
// long-lived accumulators in f32.  Rows padded to 136 elements.
#include "bf16_mma.cuh"
#include "flash_tile.cuh"

namespace {

using namespace flash;

template <int D_>
struct Bwd {
  static_assert(D_ % 32 == 0, "head_dim must be a multiple of 32");
  static constexpr int D = D_;
  static constexpr int BR = 128;             // resident rows per block
  static constexpr int BT = 16;              // streamed rows per tile
  static constexpr int NT = BR / 16 * 32;    // threads: a warp per 16 rows
  static constexpr int NJ = BT / 8;          // 8-row groups of a tile
  static constexpr int KD = D / 8;           // k-steps over d
  static constexpr int S = D + 4;            // every row stride
  static constexpr int TILE = BT * S;
  // one streamed buffer: S1 hi, S1 lo, S2 hi, S2 lo, then K3's lse and
  // delta of the tile's rows
  static constexpr int BUF = 4 * TILE + 2 * BT;
  static constexpr int bytes = (2 * BR * S + 2 * BUF) * (int)sizeof(float);
  static_assert(bytes <= 227 * 1024, "shared memory");
};

using B128 = Bwd<128>;

constexpr float LOG2E = 1.4426950408889634f;

// Four 8 x 4-float matrices from shared memory, each thread giving one
// row address (lanes 8m .. 8m + 7 the rows of matrix m); register m of
// lane l holds float l % 4 of row l / 4 of matrix m, which is a tf32
// mma fragment's layout.  Rows of stride = 4 mod 32 floats: conflict-free.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The resident operands' split, per use: hi = x with its low 13 bits
// cleared (the TF32 the MMA reads), lo = x - hi exactly: one LOP and one
// FADD, fewer instructions than cvt.rna's rounding in this
// instruction-bound loop.  lo < 2^-10 |x| instead of 2^-11, so a product keeps 2^-20
// relative instead of 2^-21, still f32-accurate.
__device__ __forceinline__ void split_trunc(uint32_t x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// c1 = R1 S1^T and c2 = R2 S2^T for the warp's 16 resident rows (R1w,
// R2w raw, stride S) against the split streamed tile's two 8-row groups.
// c1 (the scores) sums each pair of k-steps on the tensor cores in a
// fresh fragment and adds it in float32: the backward divides by the
// saved lse, so an error in s goes straight into p, and the tensor
// cores' accumulation truncates to the accumulator's magnitude (|s|
// reaches hundreds before the scale).  c2 (dp, whose error only shifts
// ds by as much) accumulates straight, the small terms first.
template <class C>
__device__ __forceinline__ void tile_scores(
    const float* R1w, const float* R2w, const float* S1h, const float* S1l,
    const float* S2h, const float* S2l, float (&c1)[C::NJ][4],
    float (&c2)[C::NJ][4]) {
  constexpr int NJ = C::NJ, KD = C::KD, S = C::S;
  static_assert(KD % 2 == 0, "k-steps come in pairs");
  static_assert(NJ == 2, "one ldmatrix.x4 holds B for both 8-row groups");
  const int lane = threadIdx.x % 32, m = lane / 8, r = lane % 8;
  // this lane's ldmatrix row: A matrices (rows 0-7 | 8-15) x (d 0-3 |
  // 4-7), B matrices (group 0 d 0-3, 0 d 4-7, group 1 d 0-3, 1 d 4-7)
  const int ra = ((m & 1) * 8 + r) * S + (m >> 1) * 4;
  const int rb = ((m >> 1) * 8 + r) * S + (m & 1) * 4;
  zero(c1);
  zero(c2);
#pragma unroll
  for (int k2 = 0; k2 < KD; k2 += 2) {
    float x[NJ][4];
    zero(x);
#pragma unroll
    for (int kk = k2; kk < k2 + 2; ++kk) {
      uint32_t a1[4], a2[4], h1[4], l1[4], h2[4], l2[4];
      ldsm4(a1, R1w + ra + 8 * kk);
      ldsm4(a2, R2w + ra + 8 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split_trunc(a1[i], h1[i], l1[i]);
        split_trunc(a2[i], h2[i], l2[i]);
      }
      uint32_t bh[4], bl[4], vh[4], vl[4];
      ldsm4(bh, S1h + rb + 8 * kk);
      ldsm4(bl, S1l + rb + 8 * kk);
      ldsm4(vh, S2h + rb + 8 * kk);
      ldsm4(vl, S2l + rb + 8 * kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma3(x[j], h1, l1, bh[2 * j], bh[2 * j + 1], bl[2 * j],
             bl[2 * j + 1]);
        mma3(c2[j], h2, l2, vh[2 * j], vh[2 * j + 1], vl[2 * j],
             vl[2 * j + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c1[j][e] += x[j][e];
  }
}

// acc[16 x D] += P[16 x BT] Sx[BT x D]: P in C-fragments, split in
// registers; Sx a split streamed tile.  Each output n-tile pair sums
// the tile's terms on the tensor cores in fragments of its own, then
// adds them to acc in float32: the tensor cores' accumulation
// truncates, and a gradient summed over thousands of rows straight in
// acc would carry that bias on every addition.
template <class C>
__device__ __forceinline__ void tile_accumulate(
    const float (&p)[C::NJ][4], const float* Sh, const float* Sl,
    float (&acc)[C::D / 8][4]) {
  constexpr int D = C::D, NJ = C::NJ, S = C::S;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split(p[j][0], ph[j][0], pl[j][0]);   // row g,     tile row 2t
    split(p[j][2], ph[j][1], pl[j][1]);   // row g + 8, tile row 2t
    split(p[j][1], ph[j][2], pl[j][2]);   // row g,     tile row 2t + 1
    split(p[j][3], ph[j][3], pl[j][3]);   // row g + 8, tile row 2t + 1
  }
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int at = (8 * j + 2 * t) * S + 2 * g + 16 * n;
      const float2 h0 = *reinterpret_cast<const float2*>(Sh + at);
      const float2 h1 = *reinterpret_cast<const float2*>(Sh + at + S);
      const float2 l0 = *reinterpret_cast<const float2*>(Sl + at);
      const float2 l1 = *reinterpret_cast<const float2*>(Sl + at + S);
      // n-tile 2n: d = 16n + 2g, n-tile 2n + 1: d + 1; k = t, t + 4
      mma3(x, ph[j], pl[j], __float_as_uint(h0.x), __float_as_uint(h1.x),
           __float_as_uint(l0.x), __float_as_uint(l1.x));
      mma3(y, ph[j], pl[j], __float_as_uint(h0.y), __float_as_uint(h1.y),
           __float_as_uint(l0.y), __float_as_uint(l1.y));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * n][e] += x[e];
      acc[2 * n + 1][e] += y[e];
    }
  }
}

// Copy rows [r0, r0 + BT) of the two streamed operands (and, for K3,
// their lse and delta) into buffer buf; rows past n are zero-filled.
template <class C, bool STATS>
__device__ __forceinline__ void load_tile(float* buf, const float* s1,
                                          const float* s2, const float* lse,
                                          const float* delta, int r0, int n) {
  constexpr int D = C::D, BT = C::BT, S = C::S, NT = C::NT, TILE = C::TILE;
  load_rows<D, BT, S, NT>(buf, s1, r0, n);
  load_rows<D, BT, S, NT>(buf + 2 * TILE, s2, r0, n);
  if (STATS) {
    const int i = threadIdx.x;
    if (i < 2 * BT) {
      const int r = i % BT;
      const bool ok = r0 + r < n;
      cp4(buf + 4 * TILE + i, (i < BT ? lse : delta) + (ok ? r0 + r : 0),
          ok);
    }
  }
}

template <class C>
__device__ __forceinline__ void split_tile(float* buf) {
  constexpr int D = C::D, BT = C::BT, S = C::S, NT = C::NT, TILE = C::TILE;
  split_rows<D, BT, S, NT>(buf, buf + TILE);
  split_rows<D, BT, S, NT>(buf + 2 * TILE, buf + 3 * TILE);
}

// Store a warp's 16 x D accumulator times mul to rows r and r + 8 of out
// (rows at or past n are not written).
template <class C>
__device__ __forceinline__ void store_rows(float* out, int r, int n,
                                           float mul,
                                           const float (&acc)[C::D / 8][4]) {
  constexpr int D = C::D;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r + 8 * i >= n) continue;
    float4* row = reinterpret_cast<float4*>(out + (size_t)(r + 8 * i) * D);
#pragma unroll
    for (int m = 0; m < D / 16; ++m)
      row[4 * m + t] = make_float4(
          acc[2 * m][2 * i] * mul, acc[2 * m + 1][2 * i] * mul,
          acc[2 * m][2 * i + 1] * mul, acc[2 * m + 1][2 * i + 1] * mul);
  }
}

// ---------------------------------------------------------------- K2: dQ
template <class C>
__global__ void __launch_bounds__(C::NT, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int T, int Tk, float scale, int causal, int k_offset) {
  constexpr int D = C::D, BR = C::BR, BT = C::BT, NJ = C::NJ, S = C::S;
  constexpr int NT = C::NT, TILE = C::TILE, BUF = C::BUF;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BR][S] raw
  float* Os = Qs + BR * S;                       // [BR][S] raw dO
  float* KV = Os + BR * S;                       // two streamed buffers
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;

  // this thread's rows q0 + rw + g and + 8: lse in log2 units (+inf
  // where dead or past T, so p = 2^-inf = 0) and delta
  const float sl2 = scale * LOG2E;
  float lr[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rw + g + 8 * i;
    const float l = r < T ? lse[(size_t)bh * T + r] : NEG_INF;
    lr[i] = l <= 0.5f * NEG_INF ? INFINITY : l * LOG2E;
    dl[i] = r < T ? delta[(size_t)bh * T + r] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_k = (Tk + BT - 1) / BT;
  if (causal) {
    const int last = q0 + BR - 1 - k_offset;
    n_k = last < 0 ? 0 : min(n_k, last / BT + 1);
  }
  if (n_k > 0) {
    load_rows<D, BR, S, NT>(Qs, q + (size_t)bh * T * D, q0, T);
    load_rows<D, BR, S, NT>(Os, dout + (size_t)bh * T * D, q0, T);
    load_tile<C, false>(KV, kb, vb, nullptr, nullptr, 0, Tk);
    cp_commit();
  }
  const int wlast = q0 + rw + 15;            // the warp's last query
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BT;
    float* buf = KV + (kt & 1) * BUF;
    if (kt + 1 < n_k)
      load_tile<C, false>(KV + ((kt + 1) & 1) * BUF, kb, vb, nullptr,
                          nullptr, k0 + BT, Tk);
    cp_commit();
    cp_wait<1>();                  // this thread's chunks of tile kt
    split_tile<C>(buf);
    __syncthreads();               // tile kt split; the resident rows landed
    // skip the tile when the warp's rows are all past T or all see none
    // of its keys (the tile wholly in their future)
    if (q0 + rw < T && (!causal || wlast >= k_offset + k0)) {
      float c1[NJ][4], c2[NJ][4];
      tile_scores<C>(Qs + rw * S, Os + rw * S, buf, buf + TILE,
                     buf + 2 * TILE, buf + 3 * TILE, c1, c2);
      // p = exp(s scale - lse), 0 where dead; ds = p (dp - delta) in
      // c1.  Only a tile on the Tk edge or the warp's diagonal has a
      // dead score (rows past T or dead carry lse = +inf)
      const bool edge = k0 + BT > Tk ||
                        (causal && q0 + rw < k_offset + k0 + BT - 1);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          float p = ex2(c1[j][e] * sl2 - lr[i]);
          if (edge) {
            const int kc = k0 + 8 * j + 2 * t + (e & 1);
            const int r = q0 + rw + g + 8 * i;
            if (kc >= Tk || (causal && r < k_offset + kc))
              p = 0.f;
          }
          c1[j][e] = p * (c2[j][e] - dl[i]);
        }
      tile_accumulate<C>(c1, buf, buf + TILE, acc);
    }
    __syncthreads();               // tile kt's buffer is consumed
  }
  store_rows<C>(dq + (size_t)bh * T * D, q0 + rw + g, T, scale, acc);
}

// ------------------------------------------------------------ K3: dK, dV
template <class C>
__global__ void __launch_bounds__(C::NT, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int T,
                     int Tk, float scale, int causal, int k_offset) {
  constexpr int D = C::D, BR = C::BR, BT = C::BT, NJ = C::NJ, S = C::S;
  constexpr int NT = C::NT, TILE = C::TILE, BUF = C::BUF;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BR][S] raw
  float* Vs = Ks + BR * S;                       // [BR][S] raw
  float* QO = Vs + BR * S;                       // two streamed buffers
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;
  const int kw = k0 + rw;                        // the warp's first key
  const float* qb = q + (size_t)bh * T * D;
  const float* ob = dout + (size_t)bh * T * D;
  const float* lb = lse + (size_t)bh * T;
  const float* db = delta + (size_t)bh * T;
  const float sl2 = scale * LOG2E;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  const int n_q = (T + BT - 1) / BT;
  // causal: the first Q tile whose last row sees the block's first key
  const int first = k_offset + k0;
  const int q_start = causal ? (first <= 0 ? 0 : min(n_q, first / BT)) : 0;
  if (q_start < n_q) {
    load_rows<D, BR, S, NT>(Ks, k + (size_t)bh * Tk * D, k0, Tk);
    load_rows<D, BR, S, NT>(Vs, v + (size_t)bh * Tk * D, k0, Tk);
    load_tile<C, true>(QO, qb, ob, lb, db, q_start * BT, T);
    cp_commit();
  }
  for (int qt = q_start; qt < n_q; ++qt) {
    const int q0 = qt * BT;
    float* buf = QO + ((qt - q_start) & 1) * BUF;
    if (qt + 1 < n_q)
      load_tile<C, true>(QO + ((qt + 1 - q_start) & 1) * BUF, qb, ob, lb, db,
                         q0 + BT, T);
    cp_commit();
    cp_wait<1>();                  // this thread's chunks of tile qt
    split_tile<C>(buf);
    __syncthreads();               // tile qt split; the resident rows landed
    const float* Ls = buf + 4 * TILE;
    const float* Ds = Ls + BT;
    // skip the tile when the warp's keys are all past Tk or no query of
    // the tile sees any of them
    if (kw < Tk && (!causal || q0 + BT - 1 >= k_offset + kw)) {
      float c1[NJ][4], c2[NJ][4];
      tile_scores<C>(Ks + rw * S, Vs + rw * S, buf, buf + TILE,
                     buf + 2 * TILE, buf + 3 * TILE, c1, c2);
      // p^T = exp(s^T scale - lse[q]) in c1, 0 where dead; ds^T =
      // p^T (dp^T - delta[q]) in c2.  The columns' lse in log2 units,
      // +inf for a query past T or a dead row (p = 2^-inf = 0); only a
      // tile on the warp's diagonal has other dead scores
      float lq[NJ][2], dlt[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float l = Ls[c];
          lq[j][e] = q0 + c >= T || l <= 0.5f * NEG_INF ? INFINITY
                                                        : l * LOG2E;
          dlt[j][e] = Ds[c];
        }
      const bool edge = causal && q0 < k_offset + kw + 15;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(c1[j][e] * sl2 - lq[j][e & 1]);
          if (edge) {
            const int qc = q0 + 8 * j + 2 * t + (e & 1);
            const int kr = kw + g + 8 * (e / 2);
            if (qc < k_offset + kr) p = 0.f;
          }
          c1[j][e] = p;
          c2[j][e] = p * (c2[j][e] - dlt[j][e & 1]);
        }
      tile_accumulate<C>(c1, buf + 2 * TILE, buf + 3 * TILE, acc_v);
      tile_accumulate<C>(c2, buf, buf + TILE, acc_k);
    }
    __syncthreads();               // tile qt's buffer is consumed
  }
  store_rows<C>(dk + (size_t)bh * Tk * D, kw + g, Tk, scale, acc_k);
  store_rows<C>(dv + (size_t)bh * Tk * D, kw + g, Tk, 1.f, acc_v);
}

template <class C>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse,
                      const float* delta, float* dq, int bh, int t, int tk,
                      float scale, int causal, int k_offset,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return err;
  const int n_q = (t + C::BR - 1) / C::BR;
  if (n_q > 65535) return cudaErrorInvalidValue;
  dim3 grid(bh, n_q);
  flash_bwd_dq_kernel<C><<<grid, C::NT, C::bytes, stream>>>(
      q, k, v, dout, lse, delta, dq, t, tk, scale, causal, k_offset);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int bh,
                       int t, int tk, float scale, int causal, int k_offset,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return err;
  const int n_k = (tk + C::BR - 1) / C::BR;
  if (n_k > 65535) return cudaErrorInvalidValue;
  dim3 grid(bh, n_k);
  flash_bwd_dkv_kernel<C><<<grid, C::NT, C::bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, t, tk, scale, causal, k_offset);
  return cudaGetLastError();
}

// ----------------------------------------------------------- bf16 forms

namespace b16 {

using tc::bf16;

constexpr int D = 128;        // head_dim
constexpr int BR = 64;        // resident rows a block: 4 warps of 16
constexpr int NT = BR / 16 * 32;
constexpr int S = D + 8;      // row stride, elements (272 bytes)
constexpr int KD = D / 16;    // k16 steps over d

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

// c[16 x 8 NJ] = R[16 x D] X^T for the warp's resident rows Rw and the
// streamed tile's rows X (8 NJ of them), exact bf16 products summed in
// f32
template <int NJ>
__device__ __forceinline__ void scores(const bf16* Rw, const bf16* X,
                                       float (&c)[NJ][4]) {
  static_assert(NJ % 2 == 0, "an ldmatrix.x4 holds two 8-row groups");
  const int lane = threadIdx.x % 32;
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;
  zero(c);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t a[4];
    tc::ldsm4(a, Rw + a_row * S + 16 * kk + a_col);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      uint32_t b[4];
      tc::ldsm4(b, X + (16 * jj + b_row) * S + 16 * kk + b_col);
      tc::mma_bf16(c[2 * jj], a, b[0], b[1]);
      tc::mma_bf16(c[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x D] += P[16 x 8 NJ] X[8 NJ x D]: P in C fragments (f32), split
// into bf16 hi + lo in A layout; X the streamed tile's rows.  Each
// output n-tile pair sums the tile's terms in fresh fragments, then
// adds them to acc in f32.
template <int NJ>
__device__ __forceinline__ void accumulate(const float (&p)[NJ][4],
                                           const bf16* X,
                                           float (&acc)[D / 8][4]) {
  constexpr int KS = NJ / 2;
  const int lane = threadIdx.x % 32;
  const int b_row = lane % 8 + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;
  uint32_t ph[KS][4], pl[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    split_bf16(p[2 * ks][0], p[2 * ks][1], ph[ks][0], pl[ks][0]);
    split_bf16(p[2 * ks][2], p[2 * ks][3], ph[ks][1], pl[ks][1]);
    split_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1], ph[ks][2], pl[ks][2]);
    split_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3], ph[ks][3], pl[ks][3]);
  }
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    float x0[4] = {0.f, 0.f, 0.f, 0.f}, x1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[4];
      tc::ldsm4_t(b, X + (16 * ks + b_row) * S + 16 * dn + b_col);
      tc::mma_bf16(x0, pl[ks], b[0], b[1]);
      tc::mma_bf16(x0, ph[ks], b[0], b[1]);
      tc::mma_bf16(x1, pl[ks], b[2], b[3]);
      tc::mma_bf16(x1, ph[ks], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * dn][e] += x0[e];
      acc[2 * dn + 1][e] += x1[e];
    }
  }
}

// a warp's 16 x D accumulator times mul, rounded once to bf16, to rows
// r and r + 8 of out (rows at or past n are not written)
__device__ __forceinline__ void store_rows(bf16* out, int r, int n, float mul,
                                           const float (&acc)[D / 8][4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r + 8 * i >= n) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(out + (size_t)(r + 8 * i) * D);
#pragma unroll
    for (int m = 0; m < D / 8; ++m)
      row[4 * m + t] = pack_bf16(acc[m][2 * i] * mul, acc[m][2 * i + 1] * mul);
  }
}

// ------------------------------------------------------------- K2: dQ
constexpr int BT2 = 32;       // keys a streamed K/V tile
constexpr int NJ2 = BT2 / 8;
constexpr int TILE2 = BT2 * S;
constexpr int bytes_dq = (2 * BR * S + 4 * TILE2) * (int)sizeof(bf16);

__global__ void __launch_bounds__(NT, 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int T, int Tk, float scale, int causal,
          int k_offset) {
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);   // [BR][S]
  bf16* Os = Qs + BR * S;                      // [BR][S] dO
  bf16* KV = Os + BR * S;                      // two buffers: K, V tiles
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;
  const bf16* kb = k + (size_t)bh * Tk * D;
  const bf16* vb = v + (size_t)bh * Tk * D;

  // this thread's rows q0 + rw + g and + 8: lse in log2 units (+inf
  // where dead or past T, so p = 2^-inf = 0) and delta
  const float sl2 = scale * LOG2E;
  float lr[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rw + g + 8 * i;
    const float l = r < T ? lse[(size_t)bh * T + r] : NEG_INF;
    lr[i] = l <= 0.5f * NEG_INF ? INFINITY : l * LOG2E;
    dl[i] = r < T ? delta[(size_t)bh * T + r] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_k = (Tk + BT2 - 1) / BT2;
  if (causal) {
    const int last = q0 + BR - 1 - k_offset;
    n_k = last < 0 ? 0 : min(n_k, last / BT2 + 1);
  }
  if (n_k > 0) {
    load_rows<BR>(Qs, q + (size_t)bh * T * D, q0, T);
    load_rows<BR>(Os, dout + (size_t)bh * T * D, q0, T);
    load_rows<BT2>(KV, kb, 0, Tk);
    load_rows<BT2>(KV + TILE2, vb, 0, Tk);
    cp_commit();
  }
  const int wlast = q0 + rw + 15;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BT2;
    const bf16* Ks = KV + (kt & 1) * 2 * TILE2;
    const bf16* Vs = Ks + TILE2;
    if (kt + 1 < n_k) {
      bf16* nk = KV + ((kt + 1) & 1) * 2 * TILE2;
      load_rows<BT2>(nk, kb, k0 + BT2, Tk);
      load_rows<BT2>(nk + TILE2, vb, k0 + BT2, Tk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();               // tile kt; the resident rows landed
    if (q0 + rw < T && (!causal || wlast >= k_offset + k0)) {
      float c1[NJ2][4], c2[NJ2][4];
      scores<NJ2>(Qs + rw * S, Ks, c1);      // s
      scores<NJ2>(Os + rw * S, Vs, c2);      // dp
      const bool edge = k0 + BT2 > Tk ||
                        (causal && q0 + rw < k_offset + k0 + BT2 - 1);
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          float p = ex2(c1[j][e] * sl2 - lr[i]);
          if (edge) {
            const int kc = k0 + 8 * j + 2 * t + (e & 1);
            const int r = q0 + rw + g + 8 * i;
            if (kc >= Tk || (causal && r < k_offset + kc)) p = 0.f;
          }
          c1[j][e] = p * (c2[j][e] - dl[i]);   // ds
        }
      accumulate<NJ2>(c1, Ks, acc);          // dq += ds k
    }
    __syncthreads();               // tile kt's buffer is consumed
  }
  store_rows(dq + (size_t)bh * T * D, q0 + rw + g, T, scale, acc);
}

// --------------------------------------------------------- K3: dK, dV
constexpr int BT3 = 16;       // queries a streamed Q/dO tile
constexpr int NJ3 = BT3 / 8;
constexpr int TILE3 = BT3 * S;
// a buffer: Q tile, dO tile, then the tile's lse and delta (f32)
constexpr int BUF3 = 2 * TILE3 * (int)sizeof(bf16) + 2 * BT3 * 4;
constexpr int bytes_dkv = 2 * BR * S * (int)sizeof(bf16) + 2 * BUF3;
static_assert(BUF3 % 16 == 0, "16-byte copies");

__global__ void __launch_bounds__(NT, 2)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Tk,
           float scale, int causal, int k_offset) {
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);   // [BR][S]
  bf16* Vs = Ks + BR * S;                      // [BR][S]
  char* QO = reinterpret_cast<char*>(Vs + BR * S);   // two buffers
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;
  const int kw = k0 + rw;                      // the warp's first key
  const bf16* qb = q + (size_t)bh * T * D;
  const bf16* ob = dout + (size_t)bh * T * D;
  const float* lb = lse + (size_t)bh * T;
  const float* db = delta + (size_t)bh * T;
  const float sl2 = scale * LOG2E;
  auto buf_q = [&](int i) { return reinterpret_cast<bf16*>(QO + i * BUF3); };
  auto buf_s = [&](int i) {
    return reinterpret_cast<float*>(QO + i * BUF3 + 2 * TILE3 * 2);
  };
  auto load = [&](int i, int r0) {
    load_rows<BT3>(buf_q(i), qb, r0, T);
    load_rows<BT3>(buf_q(i) + TILE3, ob, r0, T);
    const int j = threadIdx.x;
    if (j < 2 * BT3) {
      const int r = j % BT3;
      const bool ok = r0 + r < T;
      cp4(buf_s(i) + j, (j < BT3 ? lb : db) + (ok ? r0 + r : 0), ok);
    }
  };

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  const int n_q = (T + BT3 - 1) / BT3;
  // causal: the first Q tile whose last row sees the block's first key
  const int first = k_offset + k0;
  const int q_start = causal ? (first <= 0 ? 0 : min(n_q, first / BT3)) : 0;
  if (q_start < n_q) {
    load_rows<BR>(Ks, k + (size_t)bh * Tk * D, k0, Tk);
    load_rows<BR>(Vs, v + (size_t)bh * Tk * D, k0, Tk);
    load(0, q_start * BT3);
    cp_commit();
  }
  for (int qt = q_start; qt < n_q; ++qt) {
    const int q0 = qt * BT3;
    const int cur = (qt - q_start) & 1;
    if (qt + 1 < n_q) load(cur ^ 1, q0 + BT3);
    cp_commit();
    cp_wait<1>();
    __syncthreads();               // tile qt; the resident rows landed
    const bf16* Qt = buf_q(cur);
    const bf16* Ot = Qt + TILE3;
    const float* Ls = buf_s(cur);
    const float* Ds = Ls + BT3;
    if (kw < Tk && (!causal || q0 + BT3 - 1 >= k_offset + kw)) {
      float c1[NJ3][4], c2[NJ3][4];
      scores<NJ3>(Ks + rw * S, Qt, c1);      // s^T
      scores<NJ3>(Vs + rw * S, Ot, c2);      // dp^T
      // the columns' lse in log2 units, +inf for a query past T or a
      // dead row (p = 2^-inf = 0); only a tile on the warp's diagonal
      // has other dead scores
      float lq[NJ3][2], dlt[NJ3][2];
#pragma unroll
      for (int j = 0; j < NJ3; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float l = Ls[c];
          lq[j][e] = q0 + c >= T || l <= 0.5f * NEG_INF ? INFINITY
                                                        : l * LOG2E;
          dlt[j][e] = Ds[c];
        }
      const bool edge = causal && q0 < k_offset + kw + 15;
#pragma unroll
      for (int j = 0; j < NJ3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(c1[j][e] * sl2 - lq[j][e & 1]);
          if (edge) {
            const int qc = q0 + 8 * j + 2 * t + (e & 1);
            const int kr = kw + g + 8 * (e / 2);
            if (qc < k_offset + kr) p = 0.f;
          }
          c1[j][e] = p;                                  // p^T
          c2[j][e] = p * (c2[j][e] - dlt[j][e & 1]);     // ds^T
        }
      accumulate<NJ3>(c1, Ot, acc_v);        // dv += p^T do
      accumulate<NJ3>(c2, Qt, acc_k);        // dk += ds^T q
    }
    __syncthreads();               // tile qt's buffer is consumed
  }
  store_rows(dk + (size_t)bh * Tk * D, kw + g, Tk, scale, acc_k);
  store_rows(dv + (size_t)bh * Tk * D, kw + g, Tk, 1.f, acc_v);
}

cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* dout, const float* lse, const float* delta,
                      bf16* dq, int bh, int t, int tk, float scale,
                      int causal, int k_offset, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dq);
  if (err != cudaSuccess) return err;
  const int n_q = (t + BR - 1) / BR;
  if (n_q > 65535) return cudaErrorInvalidValue;
  dim3 grid(bh, n_q);
  dq_kernel<<<grid, NT, bytes_dq, stream>>>(q, k, v, dout, lse, delta, dq, t,
                                            tk, scale, causal, k_offset);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* dout, const float* lse, const float* delta,
                       bf16* dk, bf16* dv, int bh, int t, int tk, float scale,
                       int causal, int k_offset, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_dkv);
  if (err != cudaSuccess) return err;
  const int n_k = (tk + BR - 1) / BR;
  if (n_k > 65535) return cudaErrorInvalidValue;
  dim3 grid(bh, n_k);
  dkv_kernel<<<grid, NT, bytes_dkv, stream>>>(q, k, v, dout, lse, delta, dk,
                                              dv, t, tk, scale, causal,
                                              k_offset);
  return cudaGetLastError();
}

}  // namespace b16

}  // namespace

// q/dout [bh, t, d], k/v [bh, tk, d], lse/delta [bh, t], dq [bh, t, d];
// all float32, contiguous, q/k/v/dout/dq on 16-byte boundaries; causal
// masks q_pos < k_offset + k_pos.  Returns the launch's cudaError_t.
extern "C" int flash_bwd_dq_f32(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* delta,
                                float* dq, int bh, int t, int tk, int d,
                                float scale, int causal, int k_offset,
                                void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  // built for the flagship LM's head_dim only, like flash_fwd.cu
  if (d != 128) return (int)cudaErrorInvalidValue;
  return (int)launch_dq<B128>(q, k, v, dout, lse, delta, dq, bh, t, tk,
                              scale, causal, k_offset,
                              static_cast<cudaStream_t>(stream));
}

// as above, writing dk and dv [bh, tk, d]
extern "C" int flash_bwd_dkv_f32(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dk, float* dv, int bh, int t, int tk,
                                 int d, float scale, int causal,
                                 int k_offset, void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  if (d != 128) return (int)cudaErrorInvalidValue;
  return (int)launch_dkv<B128>(q, k, v, dout, lse, delta, dk, dv, bh, t, tk,
                               scale, causal, k_offset,
                               static_cast<cudaStream_t>(stream));
}

// The bf16 forms: q, k, v, dout and the gradients bf16, lse and delta
// float32; otherwise as flash_bwd_dq_f32 / flash_bwd_dkv_f32.
extern "C" int flash_bwd_dq_bf16(const tc::bf16* q, const tc::bf16* k,
                                 const tc::bf16* v, const tc::bf16* dout,
                                 const float* lse, const float* delta,
                                 tc::bf16* dq, int bh, int t, int tk, int d,
                                 float scale, int causal, int k_offset,
                                 void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  if (d != b16::D) return (int)cudaErrorInvalidValue;
  return (int)b16::launch_dq(q, k, v, dout, lse, delta, dq, bh, t, tk, scale,
                             causal, k_offset,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv_bf16(const tc::bf16* q, const tc::bf16* k,
                                  const tc::bf16* v, const tc::bf16* dout,
                                  const float* lse, const float* delta,
                                  tc::bf16* dk, tc::bf16* dv, int bh, int t,
                                  int tk, int d, float scale, int causal,
                                  int k_offset, void* stream) {
  if (bh <= 0 || t <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  if (d != b16::D) return (int)cudaErrorInvalidValue;
  return (int)b16::launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, t, tk,
                              scale, causal, k_offset,
                              static_cast<cudaStream_t>(stream));
}
