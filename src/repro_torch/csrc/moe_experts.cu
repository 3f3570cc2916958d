// Grouped expert product of the MoE layer: out[r] = a[r] @ w[e(r)] for
// rows r sorted by expert, fp32 out (``jnp.dot(...,
// preferred_element_type=float32)`` of ``_expert_mlp`` in
// src/repro/models/moe.py:65, which the JAX package leaves to XLA as
// one product per expert, no Pallas). models/moe.py launches it three
// times a MoE layer and call: gate, up and down.
//
// Layout: a (n, K) in the rows' order, w (E, K, N), ``offsets`` (E + 1)
// int32 on the card: expert e owns rows [offsets[e], offsets[e + 1]);
// rows from offsets[E] on belong to no expert and come out zero. Nothing
// is read on the host and the grid depends on (n, K, N, E) alone, so a
// CUDA graph holds the call. A block reads only its expert's weights, so
// an expert no row chose is never read.
//
// The tile list. A row tile holds up to BR rows of one group (BR = 32
// narrow, 128 wide, 16 fma), a group's rows cut into tiles of BR from its
// first row. Group e's tiles start at slot f(e) = floor(offsets[e] / BR)
// + min(e, offsets[e]): f never decreases, f(e + 1) - f(e) >=
// ceil(rows of e / BR), and f(E) <= floor(n / BR) + min(E, n), so the
// grid has that many row slots whatever the groups (at most min(E, n)
// groups hold rows). A block finds the group of its slot by a 32-way
// search over e (one warp probes 32 values of f a round: two rounds of
// loads of ``offsets`` for E = 256), and its tile from the slot's
// distance to f(e); a slot past its group's tiles has no tile and
// returns. kernels/moe_experts.py mirrors the mapping (``slot_start``,
// ``tile_of``).
//
// What bounds it. At decode a group holds a row or two, so the work is
// the chosen experts' weights read once (bytes): at deepseek-v3's down
// product 32 pairs choose up to 32 of 256 experts, 0.94 GB, 0.28 ms at
// 3.35 TB/s. Past a few dozen rows a group, the products (operations):
// at 4096 tokens llama4-scout's gate is 343 GFLOP, 0.35 ms at
// 989 TFLOP/s. Two routes, one rule (``moe_experts.route``), and on the
// "tc" route two tile shapes chosen from (n, E, K, N) alone
// (``moe_experts.tc_tiles``):
//   "tc" narrow (decode and staging rounds: at most 4 rows a group on
//         average) -- the swapped product out^T = W[e]^T a^T on wgmma
//         m64n8k16: the weight is the 64-row MN-major operand (a 128 x
//         64 box of W[e], one 128-byte swizzle atom wide, by TMA through
//         a 3-D tensor map over (E, K, N)), 8 token rows the N-wide
//         K-major one (a 2-D map over a). A tile holds up to 32 rows of
//         its group, walked in four slices of 8 over the same weight
//         stage, so a group of up to 32 rows reads its weights once; a
//         slice past the group's rows loads no tokens and is never
//         written. A block is one (tile, 64 output columns, K range): a
//         loader warp keeps a 3-stage ring of 24 KB stages in flight on
//         full / empty mbarriers, one consumer warpgroup multiplies;
//         three blocks an SM, so each SM has up to 144 KB of weight
//         loads outstanding; neighbouring blocks take neighbouring
//         column tiles of one expert's rows. K is split into
//         ceil(K / 2048) ranges of whole 128-deep chunks, so no block
//         streams more than 256 KB of weights and a decode step of few
//         experts still spreads over every SM; each range writes an fp32
//         partial to a workspace the wrapper zeroes, and stream.cuh's
//         ``split_reduce`` sums them in a fixed order;
//   "tc" wide (long prefill chunks, training micro-batches: more than
//         4 rows a group on average) -- tokens as M: 128-row tiles on two
//         consumer warpgroups of 64 rows, 256 output columns a block
//         (wgmma m64n256k16, 128 fp32 accumulators a thread), A by a 2-D
//         map over a, W[e] as the MN-major B operand (four 64-column
//         boxes of 64 contraction rows through the same kind of 3-D map,
//         atoms ``desc_sw128_mn`` apart), a 4-stage 48 KB ring fed by a
//         loader warp, one block an SM; a warpgroup releases a stage
//         once the wgmma after it is issued, and waits on the ring in
//         inline PTX (``mbar_wait_asm``) so that ptxas does not
//         serialise the wgmma (C7518). A warpgroup whose 64 rows lie past
//         a group's last, short tile sits out. Blocks run in bands of 8
//         column tiles, the columns of one tile side by side: a group's
//         tiles share each weight panel in L2 (weights read from HBM
//         once) and a tile's rows of a stay in L2 across the band (a
//         read once a band). Clusters of four blocks on neighbouring
//         column tiles share the a box, each loading a quarter by TMA
//         multicast; a stage is released in all four by arrivals on
//         their barriers (CTA-scope release: a cluster-scope release on
//         every arrival made the kernel twice as slow);
//   "fma" fp32, or bf16 of any other width: 16 x 64 tiles, each thread
//         four rows of one column, fmaf in ascending k.
// The narrow and wide kernels launch as programmatic dependents
// (common.cuh): barrier set-up overlaps the launch before's tail.
//
// What a row's result depends on. Within one tc shape each output
// element sums its K terms by the same wgmma sequence over the same K
// ranges, whatever other rows share its tile, and the narrow shape's
// split count depends on K alone: a row alone equals its row in
// a batch, and a call equals itself run to run, bit for bit (the fma
// route likewise, in ascending k). Across the narrow and wide shapes a
// row's bits may differ (a 1e-4 relative tolerance by row holds them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sidebar_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = repro::hopper;
namespace tc = repro::tc;

// ---- the tile list ------------------------------------------------------

// ``rows`` rows from ``row0``, all of expert ``expert`` (-1: no tile)
struct Tile {
  int expert, row0, rows;
};

// the first slot of group e's tiles
__device__ __forceinline__ int slot_start(const int* __restrict__ off, int e,
                                          int br) {
  const int o = off[e];
  return o / br + min(e, o);
}

// one full warp: the tile of slot ``s``. The group is the largest e in
// [0, E] with slot_start(e) <= s (slot_start(0) = 0): each round the 32
// lanes probe 32 evenly spaced e and keep the bracket the ballot names
template <int BR>
__device__ __forceinline__ Tile find_tile(const int* __restrict__ off,
                                          int E, int s) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = E;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int e = lo + (lane + 1) * step;
    const bool ok = e <= hi && slot_start(off, e, BR) <= s;
    const int c = __popc(__ballot_sync(0xffffffffu, ok));
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  if (lo == E) return {-1, 0, 0};
  const int o = off[lo], c = off[lo + 1] - o;
  const int j = s - (o / BR + min(lo, o));
  if (j * BR >= c) return {-1, 0, 0};
  return {lo, o + j * BR, min(BR, c - j * BR)};
}

// the tile of ``slot``, found by warp 0 and shared; every thread of the
// block calls it
template <int BR>
__device__ __forceinline__ Tile block_tile(const int* __restrict__ off,
                                           int E, int slot) {
  __shared__ Tile shared;
  if (threadIdx.x < 32) {
    const Tile t = find_tile<BR>(off, E, slot);
    if (threadIdx.x == 0) shared = t;
  }
  __syncthreads();
  return shared;
}

// ---- "tc" narrow: the swapped product -----------------------------------

constexpr int NS = 8;                       // token rows of a slice (wgmma N)
constexpr int NSL = 4;                      // slices of a tile
constexpr int NR = NS * NSL;                // token rows of a narrow tile
constexpr int NCOLS = 64;                   // output columns of a block
constexpr int N_XBOX = NS * 128;            // a slice's 8 rows x 64 of a
// a 128-deep stage: W[e]'s 128 x 64 box (tc::TILE), then each slice's
// two token boxes (contraction columns [k, k + 64) and [k + 64, k + 128))
constexpr int N_STAGE = tc::TILE + NSL * 2 * N_XBOX;   // 16 KB + 8 KB
constexpr int N_THREADS = 128 + 32;         // a consumer warpgroup, a loader
// three blocks an SM: each keeps below a third of the SM's 228 KB, less
// the 1 KB the runtime reserves for every block
constexpr int N_CAP = 233472 / 3 - 1024;
constexpr int N_FIT = (N_CAP - 1024) / (N_STAGE + 16);
constexpr int N_STAGES = N_FIT < 6 ? N_FIT : 6;
constexpr int N_BYTES = 1024 + N_STAGES * (N_STAGE + 16);
static_assert(N_STAGES >= 3 && N_BYTES <= N_CAP, "three blocks an SM");

// grid (slots x ``ncols`` 64-column tiles, K splits), columns fastest
// (neighbouring blocks stream neighbouring columns of one expert's
// rows): block (s * ncols + t, z) computes out[tile rows, t*64 : t*64 +
// 64] over the z-th range of the ``nk`` 128-deep chunks; one split
// writes out, several write ws[z]. A tile's rows are walked in slices of
// 8 over the same weight stage, each slice by the m64n8k16 sequence a
// slice alone gets; a slice past the tile's rows loads nothing and its
// products (of whatever its stage holds) are never written, so no wgmma
// sits in a branch.
__global__ void __launch_bounds__(N_THREADS, 3)
grouped_mm_narrow(const __grid_constant__ CUtensorMap mw,
                  const __grid_constant__ CUtensorMap ma,
                  const int* __restrict__ offsets, float* __restrict__ out,
                  float* __restrict__ ws, int n, int N, int E, int nk,
                  int ncols) {
  extern __shared__ __align__(1024) unsigned char narrow_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(narrow_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + N_STAGES * N_STAGE);
  uint64_t* empty = full + N_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < N_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 1);
    }
    hp::fence_barrier_init();
  }
  repro::griddep_wait();  // a and offsets are the launches before's output
  const Tile t = block_tile<NR>(offsets, E, blockIdx.x / ncols);
  if (t.expert < 0) return;
  const int n0 = (blockIdx.x % ncols) * NCOLS;
  // this split's whole chunks: ranges within one chunk of each other
  const int z = blockIdx.y, splits = gridDim.y;
  const int q = nk / splits, rem = nk % splits;
  const int c0 = z * q + min(z, rem), cn = q + (z < rem ? 1 : 0);

  if (tid < 128) {
    // ---- consumer: out^T += W^T a^T, stage by stage, slice by slice -----
    float acc[NSL][NS / 2];
#pragma unroll
    for (int j = 0; j < NSL; ++j)
#pragma unroll
      for (int r = 0; r < NS / 2; ++r) acc[j][r] = 0.f;
    const uint32_t base = hp::smem_addr(smem);
    int s = 0;
    uint32_t ph = 0;
    for (int kc = 0; kc < cn; ++kc) {
      hp::mbar_wait(&full[s], ph);
      const uint32_t st = base + s * N_STAGE;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < tc::KD / 16; ++kk) {
        const uint64_t dw = hp::desc_sw128(st + kk * 2048);
#pragma unroll
        for (int j = 0; j < NSL; ++j)
          hp::wgmma_m64n8k16_ss<1, 0>(
              acc[j], dw,
              hp::desc_sw128(st + tc::TILE + (2 * j + kk / 4) * N_XBOX +
                             (kk % 4) * 32));
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NSL; ++j) hp::fence_regs<NS / 2>(acc[j]);
      if (tid == 0) hp::mbar_arrive(&empty[s]);
      if (++s == N_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    repro::griddep_launch_dependents();
    // thread t holds out^T rows (output columns) 16 w + l / 4 (+ 8) and
    // columns (a slice's token rows) 2 (l % 4) (+ 1): hopper.cuh's m64n8
    // layout
    const int warp = tid / 32, lane = tid % 32;
    float* dst = splits == 1 ? out : ws + (size_t)z * n * N;
#pragma unroll
    for (int j = 0; j < NSL; ++j)
#pragma unroll
      for (int r = 0; r < NS / 2; ++r) {
        const int col = n0 + 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
        const int tok = NS * j + 2 * (lane & 3) + (r & 1);
        if (tok < t.rows && col < N)
          dst[(size_t)(t.row0 + tok) * N + col] = acc[j][r];
      }
  } else if (tid == 128) {
    // ---- loader: W[e]'s 128 x 64 box and the live slices' token boxes
    // of each chunk of the range ------------------------------------------
    const int live = (t.rows + NS - 1) / NS;
    int s = 0;
    uint32_t ph = 0;
    for (int kc = 0; kc < cn; ++kc) {
      hp::mbar_wait(&empty[s], ph ^ 1);
      unsigned char* st = smem + s * N_STAGE;
      const int k = (c0 + kc) * tc::KD;
      hp::mbar_arrive_expect_tx(&full[s], tc::TILE + live * 2 * N_XBOX);
      hp::tma_load_3d(st, &mw, &full[s], n0, k, t.expert);
      for (int j = 0; j < live; ++j) {
        unsigned char* xs = st + tc::TILE + 2 * j * N_XBOX;
        hp::tma_load_2d(xs, &ma, &full[s], k, t.row0 + NS * j);
        hp::tma_load_2d(xs + N_XBOX, &ma, &full[s], k + 64, t.row0 + NS * j);
      }
      if (++s == N_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  }
}

// ---- "tc" wide: tokens as M ---------------------------------------------

constexpr int WR = 128;                     // token rows of a wide tile
constexpr int WCOLS = 256;                  // output columns of a block
constexpr int WK = 64;                      // contraction rows of a stage
constexpr int W_ABOX = WR * 128;            // 128 rows x 64 of a: 16 KB
constexpr int W_WBOX = WK * 128;            // 64 rows x 64 columns of W
constexpr int W_STAGE = W_ABOX + (WCOLS / 64) * W_WBOX;  // 48 KB
constexpr int W_STAGES = 4;
constexpr int W_THREADS = 2 * 128 + 32;     // two consumer warpgroups, a
                                            // loader
constexpr int W_BYTES = 1024 + W_STAGES * (W_STAGE + 16);
static_assert(W_BYTES <= 232448, "a block's shared memory");
constexpr int W_BAND = 8;                   // column tiles of a band
constexpr int WC = 4;                       // blocks of a cluster: column
                                            // tiles sharing one a box

// (slot, unit) of cluster ``u`` of ``slots`` x ``units`` units of WC
// column tiles: bands of ``band`` units (the last one narrower), slot by
// slot within a band, its units fastest (kernels/moe_experts.py
// ``band_tile``)
__device__ __forceinline__ void band_tile(int u, int slots, int units,
                                          int band, int& slot, int& unit) {
  const int c0 = u / (slots * band) * band;
  const int width = min(band, units - c0);
  const int r = u - c0 * slots;
  slot = r / width;
  unit = c0 + r % width;
}

// grid (slots x ``ncols`` 256-column tiles, rounded up to whole units of
// WC) in clusters of WC blocks on neighbouring column tiles of one slot,
// in bands of ``W_BAND`` column tiles, columns fastest within a band:
// the tiles of one group run side by side on each weight panel (read
// from HBM once), and a tile's rows of a stay in L2 while the band's
// columns read them (a read once a band). Each block of a cluster loads
// a quarter of the tile's a box and multicasts it to the four (L2 reads
// of a / 4). Block (slot, t) computes out[tile rows, t*256 : t*256 +
// 256] over the whole K (a t past the columns loads zeros and writes
// nothing). A warpgroup whose 64 rows lie past the tile's (a group's
// last, short tile) takes no part: a stage is released when the live
// warpgroups of all four blocks have read it
__global__ void __cluster_dims__(WC, 1, 1) __launch_bounds__(W_THREADS, 1)
grouped_mm_wide(const __grid_constant__ CUtensorMap mw,
                const __grid_constant__ CUtensorMap ma,
                const int* __restrict__ offsets, float* __restrict__ out,
                int N, int E, int nk, int slots, int ncols) {
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wide_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W_STAGES * W_STAGE);
  uint64_t* empty = full + W_STAGES;
  const int tid = threadIdx.x;
  repro::griddep_wait();  // a and offsets are the launches before's output
  // the role and the tile as warp-uniform values (a lane-0 shuffle), so
  // ptxas sees no divergence around the consumers' wgmma
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int rank = (int)hp::cluster_rank();
  int slot, unit;
  band_tile(blockIdx.x / WC, slots, (ncols + WC - 1) / WC, W_BAND / WC,
            slot, unit);
  const Tile st_tile = block_tile<WR>(offsets, E, slot);
  const Tile t = {__shfl_sync(0xffffffffu, st_tile.expert, 0),
                  __shfl_sync(0xffffffffu, st_tile.row0, 0),
                  __shfl_sync(0xffffffffu, st_tile.rows, 0)};
  if (t.expert < 0) return;   // the whole cluster: one slot
  const int n0 = (unit * WC + rank) * WCOLS;
  const int live = (t.rows + 63) / 64;   // consumer warpgroups with rows
  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], WC * live);   // a live warpgroup of each
    }                                        // block of the cluster
    hp::fence_barrier_init();
  }
  hp::cluster_sync();

  if (role < live) {
    // ---- consumers: warpgroup g, rows 64 g .. 64 g + 63 of the tile ----
    const int g = role;
    float acc[WCOLS / 2];
#pragma unroll
    for (int r = 0; r < WCOLS / 2; ++r) acc[r] = 0.f;
    const uint32_t base = hp::smem_addr(smem);
    int s = 0, s_prev = 0;
    uint32_t ph = 0;
    for (int kc = 0; kc < nk; ++kc) {
      hp::mbar_wait_asm(&full[s], ph);
      const uint32_t st = base + s * W_STAGE;
      hp::fence_regs<WCOLS / 2>(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
        hp::wgmma_m64n256k16_ss<0, 1>(
            acc, hp::desc_sw128(st + g * (W_ABOX / 2) + kk * 32),
            hp::desc_sw128_mn(st + W_ABOX + kk * 2048, W_WBOX));
      hp::wgmma_commit();
      hp::wgmma_wait<1>();   // the stage before this one is read
      hp::fence_regs<WCOLS / 2>(acc);
      // released in every block of the cluster: their loaders write
      // this block's stage with their share of a
      const bool rel = kc > 0 && tid % 128 == 0;
      hp::mbar_arrive_if(&empty[s_prev], rel);
#pragma unroll
      for (int p = 1; p < WC; ++p)
        hp::mbar_arrive_remote_if(
            hp::map_rank(hp::smem_addr(&empty[s_prev]), (rank + p) % WC),
            rel);
      s_prev = s;
      if (++s == W_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs<WCOLS / 2>(acc);
    repro::griddep_launch_dependents();
    // thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns
    // 8 i + 2 (l % 4) (+ 1) of its warpgroup's 64 x 256: acc[4 i + 2 h + e]
    const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * g + 16 * warp + lane / 4 + 8 * h;
      if (r >= t.rows) continue;
      float* orow = out + (size_t)(t.row0 + r) * N + n0 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < WCOLS / 8; ++i) {
        if (n0 + 8 * i + 2 * (lane & 3) < N)
          *reinterpret_cast<float2*>(orow + 8 * i) =
              make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  } else if (tid == 256) {
    // ---- loader: a's 128 x 64 box and W[e]'s four 64 x 64 boxes of each
    // 64-deep stage ---------------------------------------------------------
    int s = 0;
    uint32_t ph = 0;
    for (int kc = 0; kc < nk; ++kc) {
      hp::mbar_wait(&empty[s], ph ^ 1);
      unsigned char* st = smem + s * W_STAGE;
      const int k = kc * WK;
      hp::mbar_arrive_expect_tx(&full[s], W_STAGE);
      hp::tma_load_2d_multicast(st + rank * (W_ABOX / WC), &ma, &full[s],
                                k, t.row0 + rank * (WR / WC),
                                (uint16_t)((1u << WC) - 1));
#pragma unroll
      for (int j = 0; j < WCOLS / 64; ++j)
        hp::tma_load_3d(st + W_ABOX + j * W_WBOX, &mw, &full[s], n0 + 64 * j,
                        k, t.expert);
      if (++s == W_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  }
  // no block leaves while another of its cluster may still write its
  // shared memory or arrive on its barriers
  hp::cluster_sync();
}

// W (E, K, N) in boxes of 64 columns x ``rows`` contraction rows of one
// expert; a (n, K) in boxes of ``rows_a`` token rows x 64 columns
bool maps(CUtensorMap* mw, CUtensorMap* ma, const void* w, const void* a,
          int n, int K, int N, int E, uint32_t rows, uint32_t rows_a) {
  const uint64_t dw[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t sw[2] = {2ull * N, 2ull * K * N};
  const uint32_t bw[3] = {64, rows, 1};
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)n};
  const uint64_t sa[1] = {2ull * K};
  const uint32_t ba[2] = {64, rows_a};
  return hp::make_tensor_map(mw, w, 3, dw, sw, bw) &&
         hp::make_tensor_map(ma, a, 2, da, sa, ba);
}

// ---- "fma": the CUDA cores, any type and width ------------------------

constexpr int F_BM = 16, F_BN = 64, F_BK = 32, F_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(F_THREADS)
grouped_mm_fma(const T* __restrict__ A, const T* __restrict__ W,
               const int* __restrict__ offsets, float* __restrict__ out,
               int K, int N, int E) {
  const Tile tile = block_tile<F_BM>(offsets, E, blockIdx.x);
  if (tile.expert < 0) return;
  const int n0 = blockIdx.y * F_BN;
  const T* Wj = W + static_cast<size_t>(tile.expert) * K * N;
  __shared__ float As[F_BM][F_BK];
  __shared__ float Bs[F_BK][F_BN];
  const int tid = threadIdx.x, tx = tid % F_BN, ty = tid / F_BN;
  float acc[F_BM / 4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = tid; i < F_BM * F_BK; i += F_THREADS) {
      const int r = i / F_BK, k = i % F_BK;
      As[r][k] = (r < tile.rows && k0 + k < K)
                     ? repro::to_f(A[static_cast<size_t>(tile.row0 + r) * K +
                                     k0 + k])
                     : 0.f;
    }
    for (int i = tid; i < F_BK * F_BN; i += F_THREADS) {
      const int k = i / F_BN, c = i % F_BN;
      Bs[k][c] = (k0 + k < K && n0 + c < N)
                     ? repro::to_f(Wj[static_cast<size_t>(k0 + k) * N + n0 + c])
                     : 0.f;
    }
    __syncthreads();
    const int kn = min(F_BK, K - k0);
    for (int k = 0; k < kn; ++k) {
      const float b = Bs[k][tx];
#pragma unroll
      for (int i = 0; i < F_BM / 4; ++i)
        acc[i] = fmaf(As[ty + 4 * i][k], b, acc[i]);
    }
    __syncthreads();
  }
  const int col = n0 + tx;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < F_BM / 4; ++i) {
    const int r = ty + 4 * i;
    if (r < tile.rows)
      out[static_cast<size_t>(tile.row0 + r) * N + col] = acc[i];
  }
}

// the slots of a grid: floor(n / br) + min(E, n)
unsigned slots(int n, int E, int br) { return n / br + (E < n ? E : n); }

}  // namespace

// a (n, K), w (E, K, N), offsets (E + 1) int32, out (n, N) fp32 zeroed
// by the caller. route 1 = "tc", 0 = "fma" (kernels/moe_experts.py
// ``ROUTES``); on "tc", ``shape`` 0 = narrow with ``splits`` K ranges
// (more than one: ws holds splits * n * N fp32, zeroed, and out is
// written whole by the reduce) or 1 = wide (splits 1). Returns the
// cudaError_t of the launches.
extern "C" int moe_grouped_mm_launch(const void* a, const void* w,
                                     const void* offsets, void* out,
                                     void* ws, int n, int K, int N, int E,
                                     int dtype, int route, int shape,
                                     int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || N <= 0 || E <= 0 || K <= 0) return cudaSuccess;
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  if (route == repro::kTc) {
    if (dtype != repro::kBF16 || K % 8 || N % 8) return cudaErrorInvalidValue;
    CUtensorMap mw, ma;
    cudaError_t err;
    if (shape == 0) {
      const int nk = (K + tc::KD - 1) / tc::KD;
      if (splits < 1 || splits > nk || (splits > 1 && ws == nullptr))
        return cudaErrorInvalidValue;
      if (!maps(&mw, &ma, w, a, n, K, N, E, tc::KD, NS))
        return cudaErrorInvalidValue;
      err = cudaFuncSetAttribute(grouped_mm_narrow,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 N_BYTES);
      if (err != cudaSuccess) return err;
      const int ncols = (N + NCOLS - 1) / NCOLS;
      const dim3 grid(slots(n, E, NR) * ncols, splits);
      err = repro::launch_dependent(grouped_mm_narrow, grid,
                                    dim3(N_THREADS), N_BYTES, s, mw, ma, off,
                                    o, static_cast<float*>(ws), n, N, E, nk,
                                    ncols);
      if (err != cudaSuccess || splits == 1) return err;
      return repro::launch_split_reduce(static_cast<const float*>(ws), o,
                                        (size_t)n * N, splits, s);
    }
    if (shape != 1 || splits != 1) return cudaErrorInvalidValue;
    if (!maps(&mw, &ma, w, a, n, K, N, E, WK, WR / WC))
      return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(grouped_mm_wide,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W_BYTES);
    if (err != cudaSuccess) return err;
    const int ncols = (N + WCOLS - 1) / WCOLS, nslots = slots(n, E, WR);
    const int units = (ncols + WC - 1) / WC;
    return repro::launch_dependent(grouped_mm_wide,
                                   dim3(nslots * units * WC),
                                   dim3(W_THREADS), W_BYTES, s, mw, ma, off,
                                   o, N, E, (K + WK - 1) / WK, nslots,
                                   ncols);
  }
  dim3 grid(slots(n, E, F_BM), (N + F_BN - 1) / F_BN);
  if (dtype == repro::kF32) {
    grouped_mm_fma<float><<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), off, o,
        K, N, E);
  } else if (dtype == repro::kBF16) {
    grouped_mm_fma<bf16><<<grid, F_THREADS, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w), off, o, K,
        N, E);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
