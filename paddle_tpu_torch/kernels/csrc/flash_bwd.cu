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
// are exact bf16 products summed in f32; P and dS = P (dP - delta) stay
// f32, and the products that take them (K2: dQ += dS K; K3: dV += P^T
// dO, dK += dS^T Q) take them split into bf16 hi + lo (bf16_mma.cuh),
// two exact products each, so the gradients keep f32's accuracy until
// their one rounding to bf16.
//
// What bounds them on the H100: the tensor cores' dense bf16 rate,
// 989.4 TFLOP/s.  One causal product at [16, 8, 2048, 128] is 6.875e10
// FLOPs, 0.0695 ms.  The function needs three (K2: S, dP, dS K; 0.2085
// ms) and four (K3: S^T, dP^T, P^T dO, dS^T Q; 0.2780 ms); as run, with
// the hi + lo split, K2 runs four (0.278 ms) and K3 six (0.417 ms).  The
// bytes (q, k, v, dO, lse, delta read once, the
// gradients written once) take 0.10 ms (K2) and 0.12 ms (K3) at 3.35
// TB/s, so the products bound both, and only wgmma drives the tensor
// cores at that rate.
// Recomputing S and dP in both kernels (10 products where an atomic
// dQ would need 7) is the price of the deterministic split.
//
// Design (as K1's bf16 form, flash_bf16.cuh): a block per (head, 128
// resident rows; 64 on a grid short of a block an SM), one consumer
// warpgroup a 64 rows and a producer warpgroup, which gives its
// registers to the consumers (setmaxnreg).  The producer's first thread
// asks TMA for the resident rows once (K2: Q and dO; K3: K and V) and
// for 64-row tiles of the streamed pair (K2: K and V; K3: Q and dO)
// through a 3-stage ring of mbarriers, all by 3-D tensor maps [BH, T,
// D] (a box past a head's last row reads zeros, never the next head),
// each 64-wide half of D a 128-byte-swizzled box; in K3 a second
// producer warp writes each tile's lse (in log2 units) and delta to
// shared memory and arrives on the same barrier.  A consumer
// warpgroup issues its two 64 x 64 score tiles (wgmma m64n64k16, both
// operands K-major in shared memory) into f32 registers, masks them
// with one warp-uniform branch a tile and selects inside it, makes p
// with one ex2 a score and dS beside it, splits them into hi + lo in
// registers (the C layout is the A-fragment layout, no shuffle), and
// adds them into its accumulators (K2: dQ, 64 registers; K3: dK and
// dV, 128) by wgmma m64n128k16 with A from registers and the streamed
// tile itself read MN-major (the transpose bit): no transposed copy.
// The warpgroups run free of each other: K1's turns (named barriers)
// measured 29 % slower in K2 and only 1.7 % faster in K3, too little
// for a second synchronisation path (PERF.md section 6).
// Each accumulator sums its terms in one fixed order (tile by tile,
// k16 step by k16 step, lo before hi) whatever form runs.  Under the
// causal mask K2's heaviest Q tiles launch first and a block stops at
// its diagonal; K3's first K tiles, its heaviest, launch first and a
// block starts at the first Q tile that sees its keys; a warpgroup
// skips a tile that none of its rows sees.
#include "bf16_mma.cuh"
#include "flash_tile.cuh"
#include "wgmma.cuh"

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

constexpr int D = 128;   // head_dim: two 64-wide (128-byte) boxes a row

// the streamed tiles' rows and the ring's stages, in every form
constexpr int BS = 64;
constexpr int STAGES = 3;

// A block owns BR resident rows of two operands (K2: Q and dO; K3: K
// and V), a consumer warpgroup 64 of them, and streams tiles of BS rows
// of the other two (K2: K and V; K3: Q and dO) through STAGES stages.
template <int BR_>
struct Form {
  static constexpr int BR = BR_;
  static constexpr int NWG = BR / 64;
  static constexpr int NT = (NWG + 1) * 128;   // + the producer's
  static constexpr int R_BOX = BR * 128;       // BR rows x 64 d, bytes
  static constexpr int S_BOX = BS * 128;       // BS rows x 64 d
  static constexpr int S_TILE = 2 * S_BOX;     // one streamed operand
  static constexpr int STAGE = 2 * S_TILE;     // both streamed operands
  // the resident operands, the stages (1024-byte aligned), K3's lse and
  // delta of each stage's rows, the barriers (at most 1 + 4 a stage) and
  // the alignment's slack
  static constexpr int bytes = 4 * R_BOX + STAGES * STAGE +
                               STAGES * 2 * BS * 4 +
                               8 * (1 + 4 * STAGES) + 1024;
  static_assert(BR == 64 || BR == 128, "resident rows");
  static_assert(bytes <= 227 * 1024, "shared memory");
};

// 128 resident rows on a grid that gives every SM a block, else 64
using Wide = Form<128>;
using Narrow = Form<64>;

// the tiles of B rows up to and including row `last` of n tiles: none
// when last < 0
__device__ __forceinline__ int tiles_to(int last, int n, int B) {
  return last < 0 ? 0 : min(n, last / B + 1);
}

// lse in log2 units: +inf for a dead row (lse NEG_INF) or one past the
// edge, so that p = 2^(s - inf) = 0
__device__ __forceinline__ float lse2(const float* lse, int r, int n) {
  const float l = r < n ? lse[r] : NEG_INF;
  return l <= 0.5f * NEG_INF ? INFINITY : l * LOG2E;
}

// the k16 steps' A fragments of a 64 x 16 KS f32 tile in C layout
// (register 4 j + e: row g + 8 (e / 2), column 8 j + 2 t + e % 2), split
// into bf16 hi + lo: k16 step ks is n8 chunks 2 ks and 2 ks + 1
template <int KS>
__device__ __forceinline__ void split_a(const float (&c)[8 * KS],
                                        uint32_t (&hi)[KS][4],
                                        uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * ks + r / 2) + 2 * (r % 2);
      split_bf16(c[i], c[i + 1], hi[ks][r], lo[ks][r]);
    }
}

// x[64 x 64] = A B^T, A the warpgroup's 64 resident rows and B a
// streamed tile's 64 rows, both K-major over d in two 128-byte-swizzled
// boxes (A's R_BOX, B's S_BOX bytes apart); issued, not waited for
template <class F>
__device__ __forceinline__ void scores(float (&x)[32], const uint8_t* A,
                                       const uint8_t* B) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int half = kk / 4, at = 32 * (kk % 4);
    wg::mma_ss<0>(x, wg::desc(A + half * F::R_BOX + at, 16, 1024),
                  wg::desc(B + half * F::S_BOX + at, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += (hi + lo)[64 x BS] X[BS x D], X a streamed tile read
// MN-major (the transpose bit): the k16 step ks is rows 16 ks .., 2048
// bytes on, its second 64 columns S_BOX bytes on; lo first, the small
// terms; issued, not waited for
template <class F, int KS>
__device__ __forceinline__ void accumulate(float (&acc)[64],
                                           const uint32_t (&hi)[KS][4],
                                           const uint32_t (&lo)[KS][4],
                                           const uint8_t* X) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t dx = wg::desc(X + ks * 2048, F::S_BOX, 1024);
    wg::mma_rs<1>(acc, lo[ks], dx, 1);
    wg::mma_rs<1>(acc, hi[ks], dx, 1);
  }
}

// a warpgroup's 64 x D accumulator times mul, rounded once to bf16, to
// the rows r0 (registers 4 j, 4 j + 1) and r0 + 8 (4 j + 2, 4 j + 3) of
// out, columns 8 j + 2 t; rows at or past n are not written
__device__ __forceinline__ void store_rows(bf16* out, int r0, int n,
                                           float mul,
                                           const float (&acc)[64]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r0 + 8 * i >= n) continue;
    bf16* row = out + (size_t)(r0 + 8 * i) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// ------------------------------------------------------------- K2: dQ
template <class F>
__global__ void __launch_bounds__(F::NT, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int T, int Tk, float scale,
                         int causal, int k_offset) {
  constexpr int BR = F::BR, BKV = BS;
  constexpr int NJ = BKV / 8, KS = BKV / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - wg::smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* Os = Qs + 2 * F::R_BOX;
  uint8_t* KVs = Os + 2 * F::R_BOX;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      KVs + STAGES * F::STAGE + STAGES * 2 * BKV * 4);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the K/V tiles the block sees: under the causal mask, up to its last
  // row's diagonal
  int n_k = (Tk + BKV - 1) / BKV;
  if (causal) n_k = tiles_to(q0 + BR - 1 - k_offset, n_k, BKV);

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&k_full[s], 1);
      wg::mbar_init(&v_full[s], 1);
      wg::mbar_init(&k_empty[s], F::NWG * 4);   // one arrival a warp
      wg::mbar_init(&v_empty[s], F::NWG * 4);
    }
    wg::fence_init();
  }
  __syncthreads();

  if (warp / 4 == F::NWG) {   // the producer warpgroup; it never rejoins
    if (F::NWG > 1) wg::regs_dec<40>();
    if (warp % 4 == 0 && lane == 0) {
      wg::mbar_expect(q_full, 4 * F::R_BOX);
      wg::tma_load(Qs, &tq, q_full, 0, q0, bh);
      wg::tma_load(Qs + F::R_BOX, &tq, q_full, 64, q0, bh);
      wg::tma_load(Os, &tdo, q_full, 0, q0, bh);
      wg::tma_load(Os + F::R_BOX, &tdo, q_full, 64, q0, bh);
      // V goes back once dP is done, K once dQ += dS K is
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES, k0 = kt * BKV;
        const uint32_t free_ph = ((kt / STAGES) & 1) ^ 1;
        uint8_t* st = KVs + s * F::STAGE;
        wg::mbar_wait(&k_empty[s], free_ph);
        wg::mbar_expect(&k_full[s], F::S_TILE);
        wg::tma_load(st, &tk, &k_full[s], 0, k0, bh);
        wg::tma_load(st + F::S_BOX, &tk, &k_full[s], 64, k0, bh);
        wg::mbar_wait(&v_empty[s], free_ph);
        wg::mbar_expect(&v_full[s], F::S_TILE);
        wg::tma_load(st + F::S_TILE, &tv, &v_full[s], 0, k0, bh);
        wg::tma_load(st + F::S_TILE + F::S_BOX, &tv, &v_full[s], 64, k0, bh);
      }
    }
    return;
  }

  if (F::NWG > 1) wg::regs_inc<232>();
  const int wgi = warp / 4, g = lane / 4, t = lane % 4;
  const int wfirst = q0 + 64 * wgi;                   // the warpgroup's rows
  const int wrow = wfirst + 16 * (warp % 4);          // the warp's
  const int row0 = wrow + g;                          // + 0 and + 8
  const uint8_t* Qw = Qs + wgi * 64 * 128;
  const uint8_t* Ow = Os + wgi * 64 * 128;
  const float sl2 = scale * LOG2E;
  float lr[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lr[i] = lse2(lse + (size_t)bh * T, r, T);
    dl[i] = r < T ? delta[(size_t)bh * T + r] : 0.f;
  }
  // the warpgroup's live tiles: none past T, under the causal mask none
  // wholly in its rows' future
  int n_live = wfirst < T ? n_k : 0;
  if (causal) n_live = min(n_live, tiles_to(wfirst + 63 - k_offset, n_k, BKV));
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  auto release = [&](uint64_t* bar, int kt) {
    if (lane == 0) wg::mbar_arrive(&bar[kt % STAGES]);
  };
  wg::mbar_wait(q_full, 0);

  for (int kt = 0; kt < n_live; ++kt) {
    const int s = kt % STAGES, k0 = kt * BKV;
    const uint32_t ph = (kt / STAGES) & 1;
    const uint8_t* Ks = KVs + s * F::STAGE;
    const uint8_t* Vs = Ks + F::S_TILE;
    float sc[BKV / 2], dp[BKV / 2];
    wg::mbar_wait(&k_full[s], ph);
    wg::fence();
    scores<F>(sc, Qw, Ks);                 // S = Q K^T
    wg::commit();
    wg::mbar_wait(&v_full[s], ph);
    scores<F>(dp, Ow, Vs);                 // dP = dO V^T
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(sc);
    wg::fence_operand(dp);
    release(v_empty, kt);
    // the masks: one warp-uniform branch, selects inside (only a tile on
    // the Tk edge or the warp's diagonal has a dead score; rows past T
    // or dead carry lr = +inf)
    if (k0 + BKV > Tk || (causal && wrow < k_offset + k0 + BKV - 1)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = k0 + 8 * j + 2 * t + (e & 1);
          const int r = row0 + 8 * (e / 2);
          const bool dead = (kc >= Tk) | ((causal != 0) & (r < k_offset + kc));
          sc[4 * j + e] = dead ? -INFINITY : sc[4 * j + e];
        }
    }
    // p = 2^(s scale log2(e) - lse log2(e)); dS = p (dP - delta), in sc
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int e = (i % 4) / 2;
      sc[i] = ex2(fmaf(sc[i], sl2, -lr[e])) * (dp[i] - dl[e]);
    }
    uint32_t hi[KS][4], lo[KS][4];
    split_a<KS>(sc, hi, lo);
    wg::fence();
    accumulate<F, KS>(acc, hi, lo, Ks);    // dQ += dS K, K MN-major
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
    fence_regs(hi);
    fence_regs(lo);
    release(k_empty, kt);
  }
  // tiles wholly in the warpgroup's future: land, then release
  for (int kt = n_live; kt < n_k; ++kt) {
    const uint32_t ph = (kt / STAGES) & 1;
    wg::mbar_wait(&k_full[kt % STAGES], ph);
    wg::mbar_wait(&v_full[kt % STAGES], ph);
    release(v_empty, kt);
    release(k_empty, kt);
  }
  store_rows(dq + (size_t)bh * T * D, row0, T, scale, acc);
}

// --------------------------------------------------------- K3: dK, dV
template <class F>
__global__ void __launch_bounds__(F::NT, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int T, int Tk, float scale, int causal,
                          int k_offset) {
  constexpr int BK = F::BR, BQ = BS;
  constexpr int NJ = BQ / 8, KS = BQ / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = smem_raw + ((1024 - wg::smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* Vs = Ks + 2 * F::R_BOX;
  uint8_t* QOs = Vs + 2 * F::R_BOX;
  // a stage's lse (log2 units, +inf where p = 0) and delta, BQ each
  float* stats = reinterpret_cast<float*>(QOs + STAGES * F::STAGE);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + STAGES * 2 * BQ);
  uint64_t* qo_full = kv_full + 1;
  uint64_t* qo_empty = qo_full + STAGES;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_q = (T + BQ - 1) / BQ;
  // causal: the first Q tile whose last row sees the block's first key
  const int first = k_offset + k0;
  const int q_start = causal ? (first <= 0 ? 0 : min(n_q, first / BQ)) : 0;

  if (threadIdx.x == 0) {
    wg::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's arrival and the statistics warp's 32
      wg::mbar_init(&qo_full[s], 1 + 32);
      wg::mbar_init(&qo_empty[s], F::NWG * 4);
    }
    wg::fence_init();
  }
  __syncthreads();

  if (warp / 4 == F::NWG) {   // the producer warpgroup; it never rejoins
    if (F::NWG > 1) wg::regs_dec<40>();
    if (warp % 4 == 0 && lane == 0) {
      wg::mbar_expect(kv_full, 4 * F::R_BOX);
      wg::tma_load(Ks, &tk, kv_full, 0, k0, bh);
      wg::tma_load(Ks + F::R_BOX, &tk, kv_full, 64, k0, bh);
      wg::tma_load(Vs, &tv, kv_full, 0, k0, bh);
      wg::tma_load(Vs + F::R_BOX, &tv, kv_full, 64, k0, bh);
      for (int qt = q_start; qt < n_q; ++qt) {
        const int i = qt - q_start, s = i % STAGES, q0 = qt * BQ;
        uint8_t* st = QOs + s * F::STAGE;
        wg::mbar_wait(&qo_empty[s], ((i / STAGES) & 1) ^ 1);
        wg::mbar_expect(&qo_full[s], F::STAGE);
        wg::tma_load(st, &tq, &qo_full[s], 0, q0, bh);
        wg::tma_load(st + F::S_BOX, &tq, &qo_full[s], 64, q0, bh);
        wg::tma_load(st + F::S_TILE, &tdo, &qo_full[s], 0, q0, bh);
        wg::tma_load(st + F::S_TILE + F::S_BOX, &tdo, &qo_full[s], 64, q0,
                     bh);
      }
    } else if (warp % 4 == 1) {   // the statistics warp
      const float* lb = lse + (size_t)bh * T;
      const float* db = delta + (size_t)bh * T;
      for (int qt = q_start; qt < n_q; ++qt) {
        const int i = qt - q_start, s = i % STAGES, q0 = qt * BQ;
        float* st = stats + s * 2 * BQ;
        wg::mbar_wait(&qo_empty[s], ((i / STAGES) & 1) ^ 1);
#pragma unroll
        for (int c = 0; c < BQ / 32; ++c) {
          const int r = lane + 32 * c;
          st[r] = lse2(lb, q0 + r, T);
          st[BQ + r] = q0 + r < T ? db[q0 + r] : 0.f;
        }
        wg::mbar_arrive(&qo_full[s]);   // releases the stores above
      }
    }
    return;
  }

  if (F::NWG > 1) wg::regs_inc<232>();
  const int wgi = warp / 4, g = lane / 4, t = lane % 4;
  const int kwg = k0 + 64 * wgi;                  // the warpgroup's keys
  const int kw = kwg + 16 * (warp % 4);           // the warp's
  const int row0 = kw + g;                        // + 0 and + 8
  const uint8_t* Kw = Ks + wgi * 64 * 128;
  const uint8_t* Vw = Vs + wgi * 64 * 128;
  const float sl2 = scale * LOG2E;
  // a warpgroup's first live Q tile: none past Tk, under the causal
  // mask the first whose last row sees its first key
  const int fw = k_offset + kwg;
  const int q_live = kwg >= Tk ? n_q
                     : causal  ? (fw <= 0 ? 0 : min(n_q, fw / BQ))
                               : 0;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  wg::mbar_wait(kv_full, 0);

  for (int qt = q_start; qt < n_q; ++qt) {
    const int i = qt - q_start, s = i % STAGES, q0 = qt * BQ;
    wg::mbar_wait(&qo_full[s], (i / STAGES) & 1);
    if (qt >= q_live) {
      const uint8_t* Qt = QOs + s * F::STAGE;
      const uint8_t* Ot = Qt + F::S_TILE;
      const float* st = stats + s * 2 * BQ;
      float sc[BQ / 2], dp[BQ / 2];
      wg::fence();
      scores<F>(sc, Kw, Qt);               // S^T = K Q^T
      wg::commit();
      scores<F>(dp, Vw, Ot);               // dP^T = V dO^T
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(sc);
      wg::fence_operand(dp);
      // the causal mask: one warp-uniform branch, selects inside (queries
      // past T and dead rows carry lse = +inf)
      if (causal && q0 < k_offset + kw + 15) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = q0 + 8 * j + 2 * t + (e & 1);
            const bool dead = qc < k_offset + row0 + 8 * (e / 2);
            sc[4 * j + e] = dead ? -INFINITY : sc[4 * j + e];
          }
      }
      // p^T = 2^(s^T scale log2(e) - lse[q] log2(e)) in sc, dS^T = p^T
      // (dP^T - delta[q]) in dp; a column's lse and delta are a float2
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(st + BQ + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float p = ex2(fmaf(sc[i], sl2, (e & 1) ? -l2.y : -l2.x));
          sc[i] = p;
          dp[i] = p * (dp[i] - ((e & 1) ? d2.y : d2.x));
        }
      }
      uint32_t ph[KS][4], pl[KS][4], dh[KS][4], dl[KS][4];
      split_a<KS>(sc, ph, pl);
      split_a<KS>(dp, dh, dl);
      wg::fence();
      accumulate<F, KS>(acc_v, ph, pl, Ot);   // dV += P^T dO
      accumulate<F, KS>(acc_k, dh, dl, Qt);   // dK += dS^T Q
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(acc_v);
      wg::fence_operand(acc_k);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
    }
    if (lane == 0) wg::mbar_arrive(&qo_empty[s]);
  }
  store_rows(dk + (size_t)bh * Tk * D, row0, Tk, scale, acc_k);
  store_rows(dv + (size_t)bh * Tk * D, row0, Tk, 1.f, acc_v);
}

// the tensor maps of q, dO [bh, t, D] and k, v [bh, tk, D] in boxes of
// q_rows and k_rows rows by 64 d
inline cudaError_t maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
                        CUtensorMap* mo, const bf16* q, const bf16* k,
                        const bf16* v, const bf16* dout, int bh, int t,
                        int tk, int q_rows, int k_rows) {
  const cuuint64_t qd[3] = {D, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t qs[2] = {D * 2, (cuuint64_t)t * D * 2};
  const cuuint32_t qb[3] = {64, (cuuint32_t)q_rows, 1};
  const cuuint64_t kd[3] = {D, (cuuint64_t)tk, (cuuint64_t)bh};
  const cuuint64_t ks[2] = {D * 2, (cuuint64_t)tk * D * 2};
  const cuuint32_t kb[3] = {64, (cuuint32_t)k_rows, 1};
  cudaError_t err = wg::bf16_map(mq, q, 3, qd, qs, qb);
  if (err == cudaSuccess) err = wg::bf16_map(mo, dout, 3, qd, qs, qb);
  if (err == cudaSuccess) err = wg::bf16_map(mk, k, 3, kd, ks, kb);
  if (err == cudaSuccess) err = wg::bf16_map(mv, v, 3, kd, ks, kb);
  return err;
}

template <class F>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* dout, const float* lse, const float* delta,
                      bf16* dq, int bh, int t, int tk, float scale,
                      int causal, int k_offset, cudaStream_t stream) {
  const int n_q = (t + F::BR - 1) / F::BR;
  if (n_q > 65535) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = maps(&mq, &mk, &mv, &mo, q, k, v, dout, bh, t, tk,
                         F::BR, BS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, n_q);   // heads first: the heaviest causal Q tiles of
                        // every head launch before any lighter one
  flash_bwd_dq_bf16_kernel<F><<<grid, F::NT, F::bytes, stream>>>(
      mq, mk, mv, mo, lse, delta, dq, t, tk, scale, causal, k_offset);
  return cudaGetLastError();
}

template <class F>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* dout, const float* lse,
                       const float* delta, bf16* dk, bf16* dv, int bh, int t,
                       int tk, float scale, int causal, int k_offset,
                       cudaStream_t stream) {
  const int n_k = (tk + F::BR - 1) / F::BR;
  if (n_k > 65535) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = maps(&mq, &mk, &mv, &mo, q, k, v, dout, bh, t, tk,
                         BS, F::BR);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, n_k);   // the first K tiles, the heaviest under the
                        // causal mask, of every head launch first
  flash_bwd_dkv_bf16_kernel<F><<<grid, F::NT, F::bytes, stream>>>(
      mq, mk, mv, mo, lse, delta, dk, dv, t, tk, scale, causal, k_offset);
  return cudaGetLastError();
}

// Wide when its blocks give every SM one, else Narrow (as K1's bf16
// form); both sum every element in the same order
inline cudaError_t wide(int bh, int rows, bool* w) {
  const SmCount& c = sm_count();
  *w = (long long)bh * ((rows + Wide::BR - 1) / Wide::BR) >= c.sms;
  return c.err;
}

inline cudaError_t run_dq(const bf16* q, const bf16* k, const bf16* v,
                          const bf16* dout, const float* lse,
                          const float* delta, bf16* dq, int bh, int t,
                          int tk, float scale, int causal, int k_offset,
                          cudaStream_t stream) {
  bool w = false;
  const cudaError_t err = wide(bh, t, &w);
  if (err != cudaSuccess) return err;
  return w ? launch_dq<Wide>(q, k, v, dout, lse, delta, dq, bh, t, tk, scale,
                             causal, k_offset, stream)
           : launch_dq<Narrow>(q, k, v, dout, lse, delta, dq, bh, t, tk,
                               scale, causal, k_offset, stream);
}

inline cudaError_t run_dkv(const bf16* q, const bf16* k, const bf16* v,
                           const bf16* dout, const float* lse,
                           const float* delta, bf16* dk, bf16* dv, int bh,
                           int t, int tk, float scale, int causal,
                           int k_offset, cudaStream_t stream) {
  bool w = false;
  const cudaError_t err = wide(bh, tk, &w);
  if (err != cudaSuccess) return err;
  return w ? launch_dkv<Wide>(q, k, v, dout, lse, delta, dk, dv, bh, t, tk,
                              scale, causal, k_offset, stream)
           : launch_dkv<Narrow>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                tk, scale, causal, k_offset, stream);
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
  return (int)b16::run_dq(q, k, v, dout, lse, delta, dq, bh, t, tk, scale,
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
  return (int)b16::run_dkv(q, k, v, dout, lse, delta, dk, dv, bh, t, tk,
                           scale, causal, k_offset,
                           static_cast<cudaStream_t>(stream));
}
