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
// in float32, out rounded to bf16 once.  P is float32 in the reference;
// rounding it to bf16 before P V (FlashAttention-2's choice) would be a
// 2^-9 error a term, so P is split into bf16 hi + lo (bf16_mma.cuh) and
// P V takes two exact products: 3 bf16 products for the 2, at most
// 989.4 / 1.5 = 660 TFLOP/s of the card's dense bf16 rate.  A causal
// [16, 8, 2048, 128] forward is 137 GFLOP against 257 MiB: 0.21 ms of
// those products (0.14 ms at the full rate), 0.08 ms of bytes, so
// bound by the tensor cores, which only wgmma drives at that rate.
// Design: a block per (batch*head, 128 query rows; 64 on a grid short
// of a block an SM), one consumer warpgroup a 64 rows and a producer
// warpgroup, which gives its registers to the consumers (setmaxnreg).
// The producer's first thread asks TMA for the Q tile once and for
// 128-key K and V tiles through a 2-stage ring of mbarriers (K and V
// each full and empty: K's half goes back once S is done), all by a 3-D
// tensor map [BH, T, D] (so a box past a head's last row reads zeros,
// never the next head), each 64-wide half of D a 128-byte-swizzled box.
// A warpgroup computes S = Q K^T by wgmma (Q and K K-major in shared
// memory) into float32 registers, scales and masks it, runs the online
// softmax there in base 2 (one ex2 a score), splits P into hi + lo in
// registers (the m64n128 C layout is the A-fragment layout, so no
// shuffle), rescales O in registers and adds P_lo V + P_hi V by wgmma
// with A from registers and V read MN-major (the transpose bit), O never
// leaving registers.  A 128-row block's two warpgroups take turns at
// issuing S, so that one's softmax overlaps the other's products.
// Under the causal mask the heaviest Q tiles launch first, a block
// stops at its diagonal, and a warpgroup skips a tile wholly in its
// rows' future.
#include "bf16_mma.cuh"
#include "flash_tile.cuh"
#include "wgmma.cuh"

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

constexpr int D = 128;   // head_dim: two 64-wide (128-byte) boxes a row

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

template <class F>
__global__ void __launch_bounds__(F::NT, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int T, int Tk, float scale, int causal) {
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
  int n_k = (Tk + BKV - 1) / BKV;
  if (causal) n_k = min(n_k, (q0 + BQ - 1) / BKV + 1);

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
      wg::tma_load(Qs, &tq, q_full, 0, q0, bh);
      wg::tma_load(Qs + F::Q_BOX, &tq, q_full, 64, q0, bh);
      // K and V of a stage are released apart: K once S = Q K^T is
      // done, V once P V is
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES, k0 = kt * BKV;
        const uint32_t free_ph = ((kt / STAGES) & 1) ^ 1;
        uint8_t* st = KVs + s * F::STAGE;
        wg::mbar_wait(&k_empty[s], free_ph);
        wg::mbar_expect(&k_full[s], F::KV);
        wg::tma_load(st, &tk, &k_full[s], 0, k0, bh);
        wg::tma_load(st + F::KV_BOX, &tk, &k_full[s], 64, k0, bh);
        wg::mbar_wait(&v_empty[s], free_ph);
        wg::mbar_expect(&v_full[s], F::KV);
        wg::tma_load(st + F::KV, &tv, &v_full[s], 0, k0, bh);
        wg::tma_load(st + F::KV + F::KV_BOX, &tv, &v_full[s], 64, k0, bh);
      }
    }
    return;
  }

  if (F::NWG > 1) wg::regs_inc<232>();
  const int wgi = warp / 4, g = lane / 4, t = lane % 4;
  const int wrow = q0 + 64 * wgi + 16 * (warp % 4);   // the warp's first row
  const int row0 = wrow + g;              // this thread's rows: + 0, + 8
  const uint8_t* Qw = Qs + wgi * 64 * 128;
  const float scale2 = scale * 1.4426950408889634f;   // scale log2(e)
  // the warpgroup's live tiles: under the causal mask, those not wholly
  // in its rows' future
  const int n_live = causal ? min(n_k, (q0 + 64 * wgi + 63) / BKV + 1) : n_k;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
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
    // scale to base 2 (m is kept as max(s) log2(e), so that each p is one
    // ex2), then mask (only a tile on the warp's diagonal or the ragged Tk
    // edge has masked scores); register 4 j + e holds row row0 + 8 (e /
    // 2), key k0 + 8 j + 2 t + e % 2
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] *= scale2;
    // one warp-uniform branch, and selects inside it: a branch a score
    // would run on every tile
    if (k0 + BKV > Tk || (causal && wrow < k0 + BKV - 1)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = k0 + 8 * j + 2 * t + (e & 1);
          const int r = row0 + 8 * (e / 2);
          const bool dead = (kc >= Tk) | ((causal != 0) & (r < kc));
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
    // a row's first tile holds its key 0, live under any mask, so mn is
    // finite from there on: a masked score (NEG_INF) gives ex2 of about
    // -1e30, exactly 0, as the reference's masked_fill does
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float a0 = ex2(m[0] - mn0), a1 = ex2(m[1] - mn1);
    float ps0 = 0.f, ps1 = 0.f;
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
  // BKV), and every arrival meets a wait
  constexpr bool turns = F::NWG == 2;
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

  // out = o / l rounded once; register 4 j + e holds row row0 + 8 (e /
  // 2), d = 8 j + 2 t + e % 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = row0 + 8 * i;
    if (qr >= T) continue;
    const float inv = 1.f / l[i];
    bf16* orow = out + ((size_t)bh * T + qr) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    // m is max(s) log2(e): lse = (m + log2 l) ln 2
    if (t == 0)
      lse[(size_t)bh * T + qr] = (m[i] + log2f(l[i])) * 0.6931471805599453f;
  }
}

// one launch of form F: the tensor maps of q [bh, t, D] and k, v [bh,
// tk, D], then a block per (head, Q tile)
template <class F>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, int bh, int t, int tk, float scale, int causal,
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
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, n_q);   // heads first: the heaviest causal Q tiles of
                        // every head launch before any lighter one
  flash_fwd_bf16_kernel<F><<<grid, F::NT, F::bytes, stream>>>(
      mq, mk, mv, out, lse, t, tk, scale, causal);
  return cudaGetLastError();
}

// Wide when its blocks give every SM one, else Narrow (as the f32
// form's use_large); both sum every element in the same order
inline cudaError_t run(const bf16* q, const bf16* k, const bf16* v,
                       bf16* out, float* lse, int bh, int t, int tk,
                       float scale, int causal, cudaStream_t stream) {
  const SmCount& c = sm_count();
  if (c.err != cudaSuccess) return c.err;
  const bool wide = (long long)bh * ((t + Wide::BQ - 1) / Wide::BQ) >= c.sms;
  return wide ? launch<Wide>(q, k, v, out, lse, bh, t, tk, scale, causal,
                             stream)
              : launch<Narrow>(q, k, v, out, lse, bh, t, tk, scale, causal,
                               stream);
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
  return (int)f16::run(q, k, v, out, lse, bh, t, tk, scale, causal,
                       static_cast<cudaStream_t>(stream));
}
