// The wgmma GEMM tile: K4's bf16 form (matmul_fused.cu), out =
// epilogue(x @ W) with x [M, K] and W [K, N] bf16, the products on
// Hopper's wgmma into float32 registers, and gemm_tile.cuh's GemmEpi
// arithmetic from those registers (+ bias, pre = bf16(y), act,
// + residual, out = bf16(y): the epilogue in float32, pre and out each
// rounded once); and the mainloop of K6's bf16 form (conv_fused.cu),
// which brings its own producer and epilogue policies.
//
// Policies.  run() is the block with a producer policy P and an
// epilogue policy E: the ring, the producer's loop over tiles and K
// tiles, and the consumers' loop.  P gives a tile's boxes: P::start(m0)
// once a tile, then P::load(stage, bar, n0, kt) asks TMA for K tile
// kt's A box (BM rows x 64 k, K-major, at the stage) and its BN / 64 W
// boxes (64 k x 64 n, MN-major, after A), which complete C::STAGE bytes
// on `bar`.  E works on a warpgroup's accumulator: E::begin(n0) when
// its tile starts, E::apply(acc, so, sp, r0, n0, bar_id, lead) when its
// products are in.  K6's bf16 form runs on run() (conv_fused.cu).  K4's
// kernel, gemm_bf16_kernel, is the same block written out with its
// loads and epilogue in place: run() with K4's loads and epilogue as
// policies computed the same bits, but its QKV projection ran 1.7-2.5 %
// slower on an H100 in turns with this kernel (PERF.md section 6), so K4
// keeps its own.
//
// Block: two consumer warpgroups and a producer warpgroup, one block
// an SM.  A block owns a BM x BN = 128 x 128 output tile at a time (or
// 128 x 64, on m64n64k16), each consumer 64 rows of it, and walks the
// tiles t = blockIdx.x, + gridDim.x, ... (numbered along N first, so
// that the blocks in flight share their A rows in L2).  The producer
// gives its registers to the consumers (setmaxnreg) and its first
// thread, per 64-deep K tile, waits for a free stage of the ring (its
// `empty` barrier), then asks TMA for x's 128 x 64 box and W's BN / 64
// boxes of 64 k x 64 n, which complete on the stage's `full` barrier.
// The ring runs on across output tiles, so the producer loads the next
// tile's first stages while the consumers run this one's epilogue.
//
// Accuracy: the tensor cores sum a wgmma chain with truncation, which
// over K = 4096 (256 k16 steps) drifts past one bf16 ulp of small
// outputs.  So the wgmmas of PI K tiles at a time sum into a fresh
// register fragment, which is added to the float32 accumulator by
// ordinary (round-to-nearest) adds, as gemm_tile.cuh's forms do; the
// group's stages go back to the producer then, and the next group is
// issued.  A tile's last group is followed by the next tile's first, so
// the tensor cores run it during this tile's epilogue.  Each element is
// summed in one fixed order whatever the grid, the tile or M.
//
// Epilogue: GemmEpi's arithmetic in registers, then each warpgroup
// writes its 64 x 128 bf16 tile (and pre's) into 128-byte-swizzled
// shared memory (conflict-free 4-byte writes) and one thread stores it
// by TMA, two 64 x 64 boxes, while the warpgroup goes on to the next
// tile.  Ragged M, N and K come from TMA's zero fill on loads (an
// element past an edge multiplies as 0) and its clipping on stores.
// TMA needs x, W, out and pre on 16-byte boundaries and their rows a
// multiple of 16 bytes (K and N multiples of 8).
#pragma once

#include "gemm_tile.cuh"   // ArgsT, apply_act, load_pair
#include "wgmma.cuh"

namespace wg {

using bf16 = __nv_bfloat16;

template <int STAGES_, int PI_, int BN_ = 128>
struct GemmTile {
  static constexpr int BM = 128, BN = BN_, BK = 64;
  static constexpr int NWG = 2;                // consumer warpgroups
  static constexpr int NT = (NWG + 1) * 128;   // + the producer's
  // registers a thread: 384 threads start at 168 (65536 / 384); the
  // producer keeps 40, its consumers take the rest
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int STAGES = STAGES_;
  static constexpr int PI = PI_;               // K tiles a fragment
  static constexpr int A_BYTES = BM * BK * 2;  // x's box, 128 rows x 128 B
  static constexpr int B_BOX = BK * 64 * 2;    // a W box, 64 k x 64 n
  static constexpr int STAGE = A_BYTES + BN / 64 * B_BOX;
  static constexpr int OUT_BOX = 64 * 64 * 2;  // a 64 x 64 output box
  static constexpr int OUT = NWG * BN / 64 * OUT_BOX;   // the tile's
  // the stages, the out and pre tiles (1024-byte aligned: the swizzle's
  // period), a full and an empty barrier a stage, the alignment's slack
  static constexpr int bytes = STAGES * STAGE + 2 * OUT + 16 * STAGES + 1024;
  static_assert(BN == 128 || BN == 64, "m64n128k16 or m64n64k16");
  static_assert(STAGE % 1024 == 0, "stages on the swizzle period");
  static_assert(PI >= 1 && PI < STAGES,
                "a group's stages, and one more, in the ring");
  static_assert(bytes <= 227 * 1024, "shared memory");
  static_assert(128 * PRODUCER_REGS + NWG * 128 * CONSUMER_REGS <=
                    NT * 168, "register budget");
};

// 5 stages, a fragment every 4 K tiles: the product's form.  A
// fragment every 1 or 2 K tiles waits on the tensor cores 4x or 2x as
// often, and making the warpgroups take turns at issuing (as the flash
// forward's do) was slower (tools/gemm_forms.py; PERF.md section 6).
using GemmBf16 = GemmTile<5, 4>;

// The bias values a thread's epilogue adds, loaded when its tile starts,
// so that they land during the main loop
template <class C>
struct EpiIn {
  float2 bias[C::BN / 8];

  __device__ __forceinline__ void load(const gemm::ArgsT<bf16>& a, int n0) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      const int gn = n0 + 8 * j + 2 * t;   // N % 8 == 0: gn + 1 < N too
      bias[j] = a.bias && gn < a.N ? gemm::load_pair(a.bias + gn)
                                   : make_float2(0.f, 0.f);
    }
  }
};

// GemmEpi's arithmetic on a warpgroup's m64n128 accumulator (in place):
// rows r0 .. r0 + 63 of the output (warp w of the warpgroup rows 16 w +
// g, + 8), columns n0 .. n0 + 127, into the swizzled tiles `so` (out)
// and `sp` (pre), then TMA stores them.  Each step is one pass over the
// registers behind one uniform branch (a branch an element would run
// for every element).  `lead` is the warpgroup's first thread, which
// issues the stores; the next tile's epilogue waits for them to have
// read the tiles.
template <class C>
__device__ __forceinline__ void epilogue(float (&acc)[C::BN / 2],
                                         const EpiIn<C>& in,
                                         const gemm::ArgsT<bf16>& a,
                                         const CUtensorMap* tout,
                                         const CUtensorMap* tpre,
                                         uint8_t* so, uint8_t* sp, int r0,
                                         int n0, int bar_id, bool lead) {
  constexpr int NJ = C::BN / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = 16 * ((threadIdx.x / 32) % 4) + g;   // row in the 64
  // register 4 j + 2 h + c: row rw + 8 h, column 8 j + 2 t + c, stored
  // at row rw + 8 h of box j / 8, its 16-byte chunk j % 8 swizzled by
  // the row (rw + 8 h = g mod 8)
  auto at = [&](int j, int h) {
    return (j / 8) * C::OUT_BOX + (rw + 8 * h) * 128 + ((j % 8) ^ g) * 16 +
           4 * t;
  };
  auto store = [&](uint8_t* tile) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(tile + at(j, h)) =
            tc::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  };
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * j + e] += e % 2 ? in.bias[j].y : in.bias[j].x;
  if (lead) store_wait_read();   // the last tile's stores read so, sp
  bar_sync(bar_id, 128);
  if (a.pre) store(sp);
  if (a.act == gemm::ACT_RELU) {
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) acc[i] = fmaxf(acc[i], 0.f);
  } else if (a.act == gemm::ACT_GELU) {
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i)
      acc[i] = gemm::apply_act(acc[i], gemm::ACT_GELU);
  }
  if (a.res) {   // read-only loads: issued together, not behind stores
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + 8 * j + 2 * t, gm = r0 + rw + 8 * h;
        unsigned r = 0u;
        if (gn < a.N && gm < a.M)
          r = __ldg(reinterpret_cast<const unsigned*>(
              a.res + (size_t)gm * a.N + gn));
        const float2 rf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&r));
        acc[4 * j + 2 * h] += rf.x;
        acc[4 * j + 2 * h + 1] += rf.y;
      }
  }
  store(so);
  fence_async_smem();
  bar_sync(bar_id, 128);
  if (lead) {
#pragma unroll
    for (int b = 0; b < C::BN / 64; ++b) {
      tma_store(tout, so + b * C::OUT_BOX, n0 + 64 * b, r0);
      if (a.pre) tma_store(tpre, sp + b * C::OUT_BOX, n0 + 64 * b, r0);
    }
    store_commit();
  }
}

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap tout,
                 const __grid_constant__ CUtensorMap tpre,
                 const gemm::ArgsT<bf16> a) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, STAGES = C::STAGES;
  constexpr int PI = C::PI;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* out_tiles = smem + STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + 2 * C::OUT);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (a.N + BN - 1) / BN;
  const int tiles = (a.M + BM - 1) / BM * n_tiles;
  const int nk = (a.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 4);   // one arrival a consumer warp
    }
    fence_init();
  }
  __syncthreads();

  if (warp / 4 == C::NWG) {   // the producer warpgroup; it never rejoins
    regs_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == C::NWG * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * C::STAGE;
          mbar_expect(&full[s], C::STAGE);
          tma_load(st, &tx, &full[s], kt * BK, m0);
#pragma unroll
          for (int i = 0; i < BN / 64; ++i)
            tma_load(st + C::A_BYTES + i * C::B_BOX, &tw, &full[s],
                     n0 + 64 * i, kt * BK);
        }
      }
    }
    return;
  }

  regs_inc<C::CONSUMER_REGS>();
  const int wgi = warp / 4;   // this warpgroup's 64 rows of the tile
  const bool lead = threadIdx.x % 128 == 0;
  uint8_t* so = out_tiles + wgi * (C::OUT / C::NWG);
  uint8_t* sp = so + C::OUT;
  float acc[BN / 2], f[BN / 2];
  EpiIn<C> in;
  int it = 0, done = 0;   // K tiles issued / released, over all tiles
  // the wgmmas of the next n K tiles into f, each once its stage lands
  auto issue = [&](int n) {
    fence();
#pragma unroll
    for (int i = 0; i < PI; ++i) {
      if (i < n) {
        const int s = (it + i) % STAGES;
        mbar_wait(&full[s], ((it + i) / STAGES) & 1);
        const uint8_t* st = smem + s * C::STAGE;
        // x K-major at this warpgroup's rows, W MN-major
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_ss<1>(f, desc(st + wgi * 64 * 128 + 32 * kk, 16, 1024),
                    desc(st + C::A_BYTES + kk * 2048, C::B_BOX, 1024),
                    i > 0 || kk > 0);
      }
    }
    commit();
    it += n;
  };
  const int ng = (nk + PI - 1) / PI;   // groups a tile; the last may be short
  auto size = [&](int g) { return min(PI, nk - g * PI); };
  if (blockIdx.x < tiles) issue(size(0));
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    in.load(a, n0);
    for (int g = 0; g < ng; ++g) {
      // group g done: its fragment into acc, its stages released, and
      // the next group issued -- at a tile's last, the next tile's
      // first, which runs during this tile's epilogue
      wait<0>();
      fence_operand(f);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = g ? acc[i] + f[i] : f[i];
      if (lane == 0)
        for (int i = 0; i < size(g); ++i)
          mbar_arrive(&empty[(done + i) % STAGES]);
      done += size(g);
      if (g + 1 < ng)
        issue(size(g + 1));
      else if (tile + (int)gridDim.x < tiles)
        issue(size(0));
    }
    epilogue<C>(acc, in, a, &tout, &tpre, so, sp, m0 + 64 * wgi, n0,
                1 + wgi, lead);
  }
  if (lead) store_wait();
}

// A warpgroup's m64nBN accumulator, rounded once to bf16, into the
// 128-byte-swizzled tile: register 4 j + 2 h + c (row rw + 8 h, column
// 8 j + 2 t + c) at row rw + 8 h of box j / 8, its 16-byte chunk j % 8
// swizzled by the row (rw + 8 h = g mod 8); conflict-free 4-byte writes
template <class C>
__device__ __forceinline__ void store_tile(const float (&acc)[C::BN / 2],
                                           uint8_t* tile) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = 16 * ((threadIdx.x / 32) % 4) + g;
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + (j / 8) * C::OUT_BOX +
                                   (rw + 8 * h) * 128 + ((j % 8) ^ g) * 16 +
                                   4 * t) =
          tc::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// The block, for a grid of `tiles` BM x BN output tiles over M rows and
// N columns and nk K tiles each (one fixed order of products and adds
// per output, whatever the grid): the producer warpgroup feeds the ring
// through P, the consumer warpgroups run the products and hand each
// finished accumulator to E.
template <class C, class P, class E>
__device__ __forceinline__ void run(P& prod, E& epi, int M, int N, int nk) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, STAGES = C::STAGES;
  constexpr int PI = C::PI;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* out_tiles = smem + STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + 2 * C::OUT);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 4);   // one arrival a consumer warp
    }
    fence_init();
  }
  __syncthreads();

  if (warp / 4 == C::NWG) {   // the producer warpgroup; it never rejoins
    regs_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == C::NWG * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % n_tiles * BN;
        prod.start(tile / n_tiles * BM);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect(&full[s], C::STAGE);
          prod.load(smem + s * C::STAGE, &full[s], n0, kt);
        }
      }
    }
    return;
  }

  regs_inc<C::CONSUMER_REGS>();
  const int wgi = warp / 4;   // this warpgroup's 64 rows of the tile
  const bool lead = threadIdx.x % 128 == 0;
  uint8_t* so = out_tiles + wgi * (C::OUT / C::NWG);
  uint8_t* sp = so + C::OUT;
  float acc[BN / 2], f[BN / 2];
  int it = 0, done = 0;   // K tiles issued / released, over all tiles
  // the wgmmas of the next n K tiles into f, each once its stage lands
  auto issue = [&](int n) {
    fence();
#pragma unroll
    for (int i = 0; i < PI; ++i) {
      if (i < n) {
        const int s = (it + i) % STAGES;
        mbar_wait(&full[s], ((it + i) / STAGES) & 1);
        const uint8_t* st = smem + s * C::STAGE;
        // A K-major at this warpgroup's rows, W MN-major
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_ss<1>(f, desc(st + wgi * 64 * 128 + 32 * kk, 16, 1024),
                    desc(st + C::A_BYTES + kk * 2048, C::B_BOX, 1024),
                    i > 0 || kk > 0);
      }
    }
    commit();
    it += n;
  };
  const int ng = (nk + PI - 1) / PI;   // groups a tile; the last may be short
  auto size = [&](int g) { return min(PI, nk - g * PI); };
  if (blockIdx.x < tiles) issue(size(0));
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    epi.begin(n0);
    for (int g = 0; g < ng; ++g) {
      // group g done: its fragment into acc, its stages released, and
      // the next group issued -- at a tile's last, the next tile's
      // first, which runs during this tile's epilogue
      wait<0>();
      fence_operand(f);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = g ? acc[i] + f[i] : f[i];
      if (lane == 0)
        for (int i = 0; i < size(g); ++i)
          mbar_arrive(&empty[(done + i) % STAGES]);
      done += size(g);
      if (g + 1 < ng)
        issue(size(g + 1));
      else if (tile + (int)gridDim.x < tiles)
        issue(size(0));
    }
    epi.apply(acc, so, sp, m0 + 64 * wgi, n0, 1 + wgi, lead);
  }
  if (lead) store_wait();
}

// The grid of a persistent launch: one block an SM, or a tile if fewer,
// or `cap` blocks if cap > 0 (a test's, to show that the grid does not
// change a sum); cudaErrorInvalidValue if the tiles pass int
template <class C>
inline cudaError_t persistent_grid(int M, int N, int cap, int* grid) {
  const tc::SmCount& sms = tc::sm_count();
  if (sms.err != cudaSuccess) return sms.err;
  const long long tiles = (long long)((M + C::BM - 1) / C::BM) *
                          ((N + C::BN - 1) / C::BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  long long g = tiles < sms.sms ? tiles : sms.sms;
  if (cap > 0 && cap < g) g = cap;
  *grid = (int)g;
  return cudaSuccess;
}

// One launch of the C form for a.x [M, K], a.w [K, N], a.out and a.pre
// [M, N] (bf16, contiguous, 16-byte aligned; K and N multiples of 8):
// the tensor maps, then one block an SM (or a tile, if fewer).
template <class C>
cudaError_t gemm_bf16(const gemm::ArgsT<bf16>& a, cudaStream_t stream) {
  if (a.M <= 0 || a.N <= 0 || a.K <= 0 || a.K % 8 || a.N % 8)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw, tout, tpre;
  const cuuint64_t xd[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
  const cuuint64_t xs[1] = {(cuuint64_t)a.K * 2};
  const cuuint32_t xb[2] = {C::BK, C::BM};
  const cuuint64_t wd[2] = {(cuuint64_t)a.N, (cuuint64_t)a.K};
  const cuuint64_t ws[1] = {(cuuint64_t)a.N * 2};
  const cuuint32_t wb[2] = {64, C::BK};
  const cuuint64_t od[2] = {(cuuint64_t)a.N, (cuuint64_t)a.M};
  const cuuint32_t ob[2] = {64, 64};
  cudaError_t err = bf16_map(&tx, a.x, 2, xd, xs, xb);
  if (err == cudaSuccess) err = bf16_map(&tw, a.w, 2, wd, ws, wb);
  if (err == cudaSuccess) err = bf16_map(&tout, a.out, 2, od, ws, ob);
  if (err == cudaSuccess)
    err = bf16_map(&tpre, a.pre ? a.pre : a.out, 2, od, ws, ob);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_bf16_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::bytes);
  if (err != cudaSuccess) return err;
  const tc::SmCount& sms = tc::sm_count();
  if (sms.err != cudaSuccess) return sms.err;
  const long long tiles = (long long)((a.M + C::BM - 1) / C::BM) *
                          ((a.N + C::BN - 1) / C::BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms.sms ? tiles : sms.sms);
  gemm_bf16_kernel<C><<<grid, C::NT, C::bytes, stream>>>(tx, tw, tout, tpre,
                                                         a);
  return cudaGetLastError();
}

}  // namespace wg
