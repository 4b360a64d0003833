// The bf16 online-softmax forward on wgmma with TMA, shared by K1's bf16
// form (flash_fwd.cu flash_fwd_bf16: from (NEG_INF, 0, 0) to out and
// lse) and K9's (flash_chunk.cu flash_chunk_bf16: from the ring's carry
// to the carry).  sm_90a only.
//
// The function, as the reference kernels compute it on bf16 q, k, v
// (they widen the operands to f32 in their bodies): S = Q K^T scale on
// exact bf16 products summed in f32, masked where q_pos < k_offset +
// k_pos (causal) or past the ragged Tk edge, an online softmax whose m,
// l and accumulator are f32.  P is f32 in the reference; rounding it to
// bf16 before P V (FlashAttention-2's choice) would be a 2^-9 error a
// term, so P is split into bf16 hi + lo (bf16_mma.cuh) and P V takes two
// exact products: 3 bf16 products for the 2, at most 989.4 / 1.5 = 660
// TFLOP/s of the card's dense bf16 rate.
//
// Design: a block per (batch*head, 128 query rows; 64 on a grid short of
// a block an SM), one consumer warpgroup a 64 rows and a producer
// warpgroup, which gives its registers to the consumers (setmaxnreg).
// The producer's first thread asks TMA for the Q tile once and for
// 128-key K and V tiles through a 2-stage ring of mbarriers (K and V
// each full and empty: K's half goes back once S is done), all by a 3-D
// tensor map [BH, T, D] (so a box past a head's last row reads zeros,
// never the next head), each 64-wide half of D a 128-byte-swizzled box.
// A warpgroup computes S = Q K^T by wgmma (Q and K K-major in shared
// memory) into float32 registers, scales and masks it, runs the online
// softmax there (one ex2 a score), splits P into hi + lo in registers
// (the m64n128 C layout is the A-fragment layout, so no shuffle),
// rescales O in registers and adds P_lo V + P_hi V by wgmma with A from
// registers and V read MN-major (the transpose bit), O never leaving
// registers.  A 128-row block's two warpgroups take turns at issuing S,
// so that one's softmax overlaps the other's products.  Under the causal
// mask the heaviest Q tiles launch first, a block stops at the last K
// tile its last row sees, and a warpgroup skips a tile wholly in its
// rows' future.
//
// The two policies (the template's CARRY), each its own kernel symbol:
// flash_fwd_bf16_kernel (K1) and flash_chunk_bf16_kernel (K9).
// - K1 (CARRY false): m, l, O start at (NEG_INF, 0, 0); m is kept as
//   max(s) log2(e), so that each p is one ex2 of a difference; out = O /
//   l is rounded to bf16 once and lse = (m + log2 l) ln 2.  A row's
//   first tile holds its key 0, live under K1's mask (k_offset 0), so m
//   is finite after it and a masked score's ex2 is exactly 0.
// - K9 (CARRY true): m, l, O start from the ring's f32 carry, read from
//   device memory into the registers of the m64n128 accumulator layout
//   (register 4 j + e of lane (g, t): row g + 8 (e / 2), d = 8 j + 2 t +
//   e % 2, a float2 a row and j), and go back there unnormalised.  The
//   carry's m is in natural units, and is compared in them: m' = max(m,
//   rowmax s) with s = scale Q K^T, p = 2^(s log2(e) - m' log2(e)) by one
//   FFMA and one ex2, alpha = 2^((m - m') log2(e)), so a row whose max
//   does not rise keeps m bit for bit (a round trip through base 2 would
//   not).  A masked score (NEG_INF, natural units) carries p = 0 by the
//   reference's guard s <= NEG_INF / 2: with m = m' = NEG_INF the
//   exponent would be 0 and manufacture mass.  So a row with no live key
//   keeps (m, l, O) bit for bit (alpha = 2^0 = 1), a wholly masked block
//   (k_offset >= T) runs no tile at all, and a Q tile with no live K
//   tile copies its carry through.  The k_offset enters the mask and
//   the stop rules; when it leaves a 128-row block's two warpgroups with
//   different tile counts, they run without turns.
#pragma once

#include "bf16_mma.cuh"
#include "flash_tile.cuh"
#include "wgmma.cuh"

namespace f16 {

using namespace flash;
using tc::bf16;

constexpr int D = 128;   // head_dim: two 64-wide (128-byte) boxes a row
constexpr float LOG2E = 1.4426950408889634f;

// 2^x, one MUFU op (what __expf does after its multiply by log2(e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// BQ query rows a block (a consumer warpgroup a 64), 128 keys a K/V
// tile, two K/V stages.  A warpgroup runs a tile's two products and its
// softmax in turn; the two warpgroups of a 128-row block take turns
// issuing S = Q K^T (named barriers 3 and 4), so that one's softmax runs
// while the other's products do, where two identical warpgroups would
// keep in step.  (Issuing the next tile's S before this one's softmax
// needs a second S and P in registers: past 255 with P's hi + lo, and
// slower with 64-key tiles; PERF.md section 6.)
template <int BQ_>
struct Form {
  static constexpr int BQ = BQ_, BKV = 128, STAGES = 2;
  static constexpr int NWG = BQ / 64;
  static constexpr int NT = (NWG + 1) * 128;  // + the producer's
  // two consumers share 65536 / 384 = 168 registers a thread with the
  // producer by setmaxnreg; one consumer has 255 without it
  static constexpr int Q_BOX = BQ * 128;      // BQ rows x 64 d, bytes
  static constexpr int KV_BOX = BKV * 128;    // BKV rows x 64 d
  static constexpr int KV = 2 * KV_BOX;       // a K or V tile
  static constexpr int STAGE = 2 * KV;        // K, then V
  // Q, the stages (1024-byte aligned), the barriers (Q full, then K
  // full, V full, K empty and V empty a stage) and the alignment's slack
  static constexpr int bytes =
      2 * Q_BOX + STAGES * STAGE + 8 * (1 + 4 * STAGES) + 1024;
  // the turns need both warpgroups to run the same tiles: so BQ <= BKV
  static_assert((BQ == 64 || BQ == 128) && BQ <= BKV, "tiles");
  static_assert(bytes <= 227 * 1024, "shared memory");
};

// 128 rows on a grid that gives every SM a block, else 64
using Wide = Form<128>;
using Narrow = Form<64>;

// K9's carry: m, l [bh, T] and the unnormalised acc [bh, T, D], all
// float32, read before the fold and written after it (K1: all null)
struct Carry {
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
};

// the K/V tiles of BKV keys up to and including key `last` of n tiles:
// none when last < 0
__device__ __forceinline__ int tiles_to(int last, int n, int bkv) {
  return last < 0 ? 0 : min(n, last / bkv + 1);
}

// the block's work under either policy; tq, tk, tv are the kernel's
// __grid_constant__ tensor maps
template <class F, bool CARRY>
__device__ __forceinline__ void fwd_bf16_block(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    bf16* __restrict__ out, float* __restrict__ lse, const Carry& carry,
    int T, int Tk, float scale, int causal, int k_offset) {
  constexpr int BQ = F::BQ, BKV = F::BKV, STAGES = F::STAGES;
  constexpr int NJ = BKV / 8, KS = BKV / 16;   // score n8 / k16 steps
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - wg::smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* KVs = Qs + 2 * F::Q_BOX;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(KVs + STAGES * F::STAGE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the K/V tiles the block sees: under the causal mask, up to its last
  // row's diagonal, shifted by k_offset
  int n_k = (Tk + BKV - 1) / BKV;
  if (causal) n_k = tiles_to(q0 + BQ - 1 - k_offset, n_k, BKV);

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&k_full[s], 1);
      wg::mbar_init(&v_full[s], 1);
      // one arrival a consumer warp
      wg::mbar_init(&k_empty[s], F::NWG * 4);
      wg::mbar_init(&v_empty[s], F::NWG * 4);
    }
    wg::fence_init();
  }
  __syncthreads();

  if (warp / 4 == F::NWG) {   // the producer warpgroup; it never rejoins
    if (F::NWG > 1) wg::regs_dec<40>();
    if (warp % 4 == 0 && lane == 0) {
      wg::mbar_expect(q_full, 2 * F::Q_BOX);
      wg::tma_load(Qs, tq, q_full, 0, q0, bh);
      wg::tma_load(Qs + F::Q_BOX, tq, q_full, 64, q0, bh);
      // K and V of a stage are released apart: K once S = Q K^T is
      // done, V once P V is
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES, k0 = kt * BKV;
        const uint32_t free_ph = ((kt / STAGES) & 1) ^ 1;
        uint8_t* st = KVs + s * F::STAGE;
        wg::mbar_wait(&k_empty[s], free_ph);
        wg::mbar_expect(&k_full[s], F::KV);
        wg::tma_load(st, tk, &k_full[s], 0, k0, bh);
        wg::tma_load(st + F::KV_BOX, tk, &k_full[s], 64, k0, bh);
        wg::mbar_wait(&v_empty[s], free_ph);
        wg::mbar_expect(&v_full[s], F::KV);
        wg::tma_load(st + F::KV, tv, &v_full[s], 0, k0, bh);
        wg::tma_load(st + F::KV + F::KV_BOX, tv, &v_full[s], 64, k0, bh);
      }
    }
    return;
  }

  if (F::NWG > 1) wg::regs_inc<232>();
  const int wgi = warp / 4, g = lane / 4, t = lane % 4;
  const int wrow = q0 + 64 * wgi + 16 * (warp % 4);   // the warp's first row
  const int row0 = wrow + g;              // this thread's rows: + 0, + 8
  const uint8_t* Qw = Qs + wgi * 64 * 128;
  // K1 scales to base 2 (m is max(s) log2(e)); K9 to natural units
  const float sc_mul = CARRY ? scale : scale * LOG2E;
  // a warpgroup's live tiles: under the causal mask, those not wholly in
  // its rows' future
  auto live_of = [&](int w) {
    return causal ? tiles_to(q0 + 64 * w + 63 - k_offset, n_k, BKV) : n_k;
  };
  const int n_live = live_of(wgi);
  float m[2], l[2], o[D / 2];
  if constexpr (CARRY) {
    // this thread's rows of the carry, in accumulator order; rows past
    // T fold nothing and are never written
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = row0 + 8 * i;
      const bool ok = qr < T;
      const size_t row = (size_t)bh * T + qr;
      m[i] = ok ? carry.m_in[row] : NEG_INF;
      l[i] = ok ? carry.l_in[row] : 0.f;
      const float* arow = carry.acc_in + row * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 a = ok ? *reinterpret_cast<const float2*>(
                                  arow + 8 * j + 2 * t)
                            : make_float2(0.f, 0.f);
        o[4 * j + 2 * i] = a.x;
        o[4 * j + 2 * i + 1] = a.y;
      }
    }
  } else {
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  }
  wg::mbar_wait(q_full, 0);

  // issue S = Q K^T of tile kt into sc once its K lands
  auto scores = [&](float (&sc)[BKV / 2], int kt) {
    const int s = kt % STAGES;
    wg::mbar_wait(&k_full[s], (kt / STAGES) & 1);
    const uint8_t* Ks = KVs + s * F::STAGE;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int half = kk / 4, at = 32 * (kk % 4);
      wg::mma_ss<0>(sc, wg::desc(Qw + half * F::Q_BOX + at, 16, 1024),
                    wg::desc(Ks + half * F::KV_BOX + at, 16, 1024), kk > 0);
    }
    wg::commit();
  };
  // tile kt's K (or V) read: its half of the stage back to the producer
  auto release = [&](uint64_t* bar, int kt) {
    if (lane == 0) wg::mbar_arrive(&bar[kt % STAGES]);
  };
  // the online softmax of tile kt's scores, then issue o = o alpha + P V
  // once its V lands
  auto fold = [&](float (&sc)[BKV / 2], int kt) {
    const int s = kt % STAGES, k0 = kt * BKV;
    // scale, then mask (only a tile on the warp's diagonal or the ragged
    // Tk edge has masked scores); register 4 j + e holds row row0 + 8 (e
    // / 2), key k0 + 8 j + 2 t + e % 2
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] *= sc_mul;
    // one warp-uniform branch, and selects inside it: a branch a score
    // would run on every tile
    if (k0 + BKV > Tk || (causal && wrow < k_offset + k0 + BKV - 1)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = k0 + 8 * j + 2 * t + (e & 1);
          const int r = row0 + 8 * (e / 2);
          const bool dead =
              (kc >= Tk) | ((causal != 0) & (r < k_offset + kc));
          sc[4 * j + e] = dead ? NEG_INF : sc[4 * j + e];
        }
    }
    // rows row0 (e = 0, 1) and row0 + 8 (2, 3)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    float a0, a1;
    float ps0 = 0.f, ps1 = 0.f;
    if constexpr (CARRY) {
      // natural units: the carry's m compared as it came in
      a0 = ex2((m[0] - mn0) * LOG2E);
      a1 = ex2((m[1] - mn1) * LOG2E);
      const float b0 = mn0 * LOG2E, b1 = mn1 * LOG2E;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x0 = sc[4 * j + e];
          float& x1 = sc[4 * j + 2 + e];
          x0 = x0 <= 0.5f * NEG_INF ? 0.f : ex2(fmaf(x0, LOG2E, -b0));
          x1 = x1 <= 0.5f * NEG_INF ? 0.f : ex2(fmaf(x1, LOG2E, -b1));
          ps0 += x0;
          ps1 += x1;
        }
      }
    } else {
      // base 2: a masked score (NEG_INF) gives ex2 of about -1e30,
      // exactly 0, as the reference's masked_fill does
      a0 = ex2(m[0] - mn0);
      a1 = ex2(m[1] - mn1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x0 = sc[4 * j + e];
          float& x1 = sc[4 * j + 2 + e];
          x0 = ex2(x0 - mn0);
          x1 = ex2(x1 - mn1);
          ps0 += x0;
          ps1 += x1;
        }
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
    // P in A layout, split hi + lo: k16 step ks is n8 chunks 2 ks,
    // 2 ks + 1
    uint32_t ph_[KS][4], pl_[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (2 * ks + r / 2) + 2 * (r % 2);
        tc::split_bf16(sc[i], sc[i + 1], ph_[ks][r], pl_[ks][r]);
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    wg::mbar_wait(&v_full[s], (kt / STAGES) & 1);
    const uint8_t* Vs = KVs + s * F::STAGE + F::KV;
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t dv = wg::desc(Vs + ks * 2048, F::KV_BOX, 1024);
      wg::mma_rs<1>(o, pl_[ks], dv, 1);
      wg::mma_rs<1>(o, ph_[ks], dv, 1);
    }
    wg::commit();
  };

  // turns (two warpgroups): warpgroup w waits at barrier 3 + w before
  // it issues S, then lets the other go; both run n_live tiles (BQ <=
  // BKV, and under K9's k_offset only when both have the same live
  // tiles, at least one), and every arrival meets a wait
  const bool turns =
      F::NWG == 2 && (!CARRY || (live_of(0) == live_of(1) && n_live > 0));
  if (turns && wgi == 1) wg::bar_arrive(3, 256);
  for (int kt = 0; kt < n_live; ++kt) {
    float sc[BKV / 2];
    if (turns) wg::bar_sync(3 + wgi, 256);
    scores(sc, kt);
    if (turns && (wgi == 0 || kt + 1 < n_live)) wg::bar_arrive(4 - wgi, 256);
    wg::wait<0>();
    wg::fence_operand(sc);
    release(k_empty, kt);
    fold(sc, kt);
    wg::wait<0>();
    wg::fence_operand(o);
    release(v_empty, kt);
  }
  // tiles wholly in the warpgroup's future: land, then release
  for (int kt = n_live; kt < n_k; ++kt) {
    wg::mbar_wait(&k_full[kt % STAGES], (kt / STAGES) & 1);
    wg::mbar_wait(&v_full[kt % STAGES], (kt / STAGES) & 1);
    release(k_empty, kt);
    release(v_empty, kt);
  }

  // register 4 j + e holds row row0 + 8 (e / 2), d = 8 j + 2 t + e % 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = row0 + 8 * i;
    if (qr >= T) continue;
    const size_t row = (size_t)bh * T + qr;
    if constexpr (CARRY) {
      // the carry back, unnormalised
      float* arow = carry.acc_out + row * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(arow + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      if (t == 0) {
        carry.m_out[row] = m[i];
        carry.l_out[row] = l[i];
      }
    } else {
      // out = o / l rounded once
      const float inv = 1.f / l[i];
      bf16* orow = out + row * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      // m is max(s) log2(e): lse = (m + log2 l) ln 2
      if (t == 0) lse[row] = (m[i] + log2f(l[i])) * 0.6931471805599453f;
    }
  }
}

// K1's bf16 form and K9's, each its own symbol (a profiler trace tells
// them apart)
template <class F>
__global__ void __launch_bounds__(F::NT, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int T, int Tk, float scale, int causal) {
  fwd_bf16_block<F, false>(&tq, &tk, &tv, out, lse, Carry{}, T, Tk, scale,
                           causal, 0);
}

template <class F>
__global__ void __launch_bounds__(F::NT, 1)
flash_chunk_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Carry carry, int T, int Tk, float scale,
                        int causal, int k_offset) {
  fwd_bf16_block<F, true>(&tq, &tk, &tv, nullptr, nullptr, carry, T, Tk,
                          scale, causal, k_offset);
}

// one launch of form F: the tensor maps of q [bh, t, D] and k, v [bh,
// tk, D], then a block per (head, Q tile)
template <class F, bool CARRY>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, const Carry& carry, int bh, int t, int tk,
                   float scale, int causal, int k_offset,
                   cudaStream_t stream) {
  const int n_q = (t + F::BQ - 1) / F::BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  const cuuint64_t qd[3] = {D, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t qs[2] = {D * 2, (cuuint64_t)t * D * 2};
  const cuuint32_t qb[3] = {64, F::BQ, 1};
  const cuuint64_t kd[3] = {D, (cuuint64_t)tk, (cuuint64_t)bh};
  const cuuint64_t ks[2] = {D * 2, (cuuint64_t)tk * D * 2};
  const cuuint32_t kb[3] = {64, F::BKV, 1};
  cudaError_t err = wg::bf16_map(&mq, q, 3, qd, qs, qb);
  if (err == cudaSuccess) err = wg::bf16_map(&mk, k, 3, kd, ks, kb);
  if (err == cudaSuccess) err = wg::bf16_map(&mv, v, 3, kd, ks, kb);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, n_q);   // heads first: the heaviest causal Q tiles of
                        // every head launch before any lighter one
  if constexpr (CARRY) {
    err = cudaFuncSetAttribute(flash_chunk_bf16_kernel<F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F::bytes);
    if (err != cudaSuccess) return err;
    flash_chunk_bf16_kernel<F><<<grid, F::NT, F::bytes, stream>>>(
        mq, mk, mv, carry, t, tk, scale, causal, k_offset);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F::bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<F><<<grid, F::NT, F::bytes, stream>>>(
        mq, mk, mv, out, lse, t, tk, scale, causal);
  }
  return cudaGetLastError();
}

// Wide when its blocks give every SM a block, else Narrow (as the f32
// form's use_large); both sum every element in the same order
template <bool CARRY>
inline cudaError_t run(const bf16* q, const bf16* k, const bf16* v,
                       bf16* out, float* lse, const Carry& carry, int bh,
                       int t, int tk, float scale, int causal, int k_offset,
                       cudaStream_t stream) {
  const SmCount& c = sm_count();
  if (c.err != cudaSuccess) return c.err;
  const bool wide = (long long)bh * ((t + Wide::BQ - 1) / Wide::BQ) >= c.sms;
  return wide ? launch<Wide, CARRY>(q, k, v, out, lse, carry, bh, t, tk,
                                    scale, causal, k_offset, stream)
              : launch<Narrow, CARRY>(q, k, v, out, lse, carry, bh, t, tk,
                                      scale, causal, k_offset, stream);
}

}  // namespace f16
