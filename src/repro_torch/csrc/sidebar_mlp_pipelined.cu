// Ring-pipelined Sidebar MLP for Hopper: y = f(x @ W1) @ W2 with a
// T-deep ring of f(h) sub-tiles in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/sidebar_mlp.py:
// sidebar_mlp_pipelined (body ``_pipelined_kernel``, pallas_call at
// :273): the kernel behind ExecutionMode.SIDEBAR_PIPELINED at ring
// depth T.
//
// What bounds it on an H100: streaming the two weight matrices (604 MB
// per layer of nemotron-4-15b in bf16, at least 180 us at 3.35 TB/s);
// the row count at serving shapes (4 at decode, up to 64 in a staging
// round) is far below the operations-per-byte line. So the design is
// about bytes in flight on every SM, with the products on the tensor
// cores so that they never become the limit.
//
// Rounding points (src/repro/kernels/ref.py:34-37): fp32 h, f in fp32,
// f(h) cast to W2's type, fp32 accumulation, output in x's type.
//
// ---- bf16: a thread-block-cluster ring on the tensor cores ------------
//
// A cluster of C blocks (neighbouring SMs) owns one (panel of N token
// rows, F range) pair: N = 8 for M <= 8 and 16 for M <= 16 on clusters
// of C = 4, N = 32 above on clusters of C = 8. The F range is walked in
// sub-tiles of C x 64 columns, one ring slot each. Each block has three
// warpgroups and two loader warps:
//   * the PRODUCER warpgroup computes h^T = W1^T x^T for ITS 64 columns
//     of the sub-tile over the whole D contraction (wgmma m64nNk16, the
//     weight as the 64-row MN-major operand, x^T as the N-wide K-major
//     one: at 4-64 tokens the swapped product keeps the tensor cores'
//     M on the weight), applies f in fp32 (``apply_activation``, so the
//     table's run-time ``device_expr`` builds keep working), rounds
//     f(h) to bf16 and writes its 64 columns into the ring slot of EVERY
//     block of the cluster through distributed shared memory. The
//     Sidebar thus spans the cluster: f(h) never reaches HBM;
//   * two CONSUMER warpgroups multiply the oldest filled slot
//     (K = C x 64) by the W2 rows of that sub-tile: y^T = W2^T f(h)^T,
//     again with the weight as the 64-row MN-major operand. D2 is split
//     into 64-column tiles dealt round-robin over the cluster's C blocks
//     x 2 consumer warpgroups, so a consumer holds at most 6144 / (2 C)
//     columns (12 or 6 tiles; 96 registers of 64 x N fp32 accumulators
//     at most) for the whole F range: no partial y round-trips through
//     memory between sub-tiles. A D2 wider than 6144 (MAX_D2) is walked
//     in passes of 6144 columns, one grid z index each; each pass
//     recomputes its clusters' f(h), so W1 is read once per pass;
//   * a loader warp streams W1 (128 x 64 tiles) and x for the producer,
//     another streams W2 (two 128 x 64 tiles a stage) for the consumers,
//     by TMA into rings with full/empty mbarriers. Their stage counts
//     (``Layout``) fill the shared memory the f(h) slots leave, ~200 KB:
//     measured on the card, a deeper W1 ring pays most.
// Slot j % T has a "full" barrier that completes when all C producers
// of the cluster have written their columns (cluster-scope release /
// acquire) and an "empty" barrier in every block that completes when
// all 2 C consumer warpgroups of the cluster have drained it. A
// producer waits for its slot to be empty BEFORE it computes the
// sub-tile, so the consumers lag at most T - 1 sub-tiles, as the TPU
// kernel's do; T = 1 is the serial schedule. The ring never holds more
// slots than the sub-tiles a cluster owns (the wrapper caps T there) nor
// than ``Layout`` has room for (4, or 2 on clusters of 8: the launch caps
// T there; the output does not depend on T).
//
// Bitwise equal across depths: the F partition (``f_range_pipelined``)
// and the (N, C) shape depend on M and F only, sub-tiles are consumed
// in order, and every output element is the same sequence of wgmma
// instructions (the same shapes and k-steps) at every depth. Each
// cluster writes its fp32 partial of y once; a second pass sums the F
// ranges in a fixed order (no atomics) and casts to x's type. The
// clusters of all panels aim at one block on each of the 132 SMs (128
// at decode: 32 clusters of 4).
//
// Eligibility (the wrapper raises otherwise): D, F and D2 multiples of
// 8 (TMA row strides in whole 16 bytes), 16-byte aligned operands.
// Ragged M, D, F and D2 are zero-filled by TMA and masked.
//
// ---- fp32: plain FMA --------------------------------------------------
//
// TF32 would break the fp32 gates (1e-4), so fp32 keeps the CUDA-core
// route: a block owns a (16-row panel, F range) pair and splits into a
// producer and a consumer role of four warps each, which meet at a ring
// of 64-column sub-tiles; the consumer carries its fp32 partial of y in
// a workspace slice across sub-tiles (16 rows x D2 fit neither shared
// memory nor registers), which keeps every element one FMA chain at
// every depth.

#include "activation.cuh"
#include "hopper.cuh"
#include "stream.cuh"

namespace {

using repro::apply_activation;
using repro::from_f;
using repro::to_f;
using repro::hopper::mbar_arrive;
using repro::hopper::mbar_init;
using repro::hopper::mbar_wait;

// ===========================================================================
// bf16: the cluster ring on the tensor cores
// ===========================================================================
namespace tc {

namespace hp = repro::hopper;

constexpr int SHARE = 64;            // F columns a block computes a sub-tile
constexpr int KD = 128;              // D rows of a W1 stage
constexpr int KF = 128;              // F rows of a W2 stage
constexpr int TILE = 64 * 128 * 2;   // one 128-row x 64-column bf16 box
constexpr int W2_STAGE = 2 * TILE;   // one box per consumer warpgroup
constexpr int MAX_D2 = 6144;         // D2 columns of one pass (the
                                     // consumers' registers)
constexpr int THREADS = 3 * 128 + 2 * 32;  // 2 consumer WGs, producer WG,
                                           // 2 loader warps

// Panels of N token rows on clusters of C blocks: (8, 4) and (16, 4), or
// (32, 8) so that the 64 x 32 accumulators of D2 / 16 columns fit a
// consumer's registers. A sub-tile is C x 64 columns; the stage counts
// and ring slots are what shared memory holds beside them.
template <int N, int C>
struct Layout {
  static constexpr int SUB = C * SHARE;         // F columns of a sub-tile
  static constexpr int MT = MAX_D2 / (C * 2 * 64);  // D2 tiles a consumer
  static constexpr int XBOX = N * 128;          // N rows x 64 of x
  static constexpr int W1_STAGE = TILE + 2 * XBOX;
  static constexpr int W1_STAGES = N == 8 ? 5 : 4;
  static constexpr int W2_STAGES = C == 8 ? 2 : 3;
  static constexpr int MAX_SLOTS = C == 8 ? 2 : 4;
  static constexpr int CHUNK = N * 128;         // a block's 64 columns
  static constexpr int SLOT = C * CHUNK;        // one sub-tile of f(h)
  static constexpr int BARS = 2 * (W1_STAGES + W2_STAGES + MAX_SLOTS);
  // ring slots at depth ``depth``: no more than shared memory holds
  static int slots(int depth) {
    return depth < MAX_SLOTS ? depth : MAX_SLOTS;
  }
  static size_t bytes(int depth) {
    return 1024 + (size_t)W2_STAGES * W2_STAGE +
           (size_t)W1_STAGES * W1_STAGE + (size_t)slots(depth) * SLOT +
           BARS * 8;
  }
};

// m64nNk16, A (the weight) MN-major, B K-major, both in shared memory
template <int N>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 8)
    hp::wgmma_m64n8k16_ss<1, 0>(d, da, db);
  else if constexpr (N == 16)
    hp::wgmma_m64n16k16_ss<1, 0>(d, da, db);
  else
    hp::wgmma_m64n32k16_ss<1, 0>(d, da, db);
}

template <int N, int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(THREADS, 1)
ring(const __grid_constant__ CUtensorMap mx,
     const __grid_constant__ CUtensorMap mw1,
     const __grid_constant__ CUtensorMap mw2, float* __restrict__ ws,
     int M, int D, int F, int D2, int frange, int slots, int act) {
  using L = Layout<N, C>;
  constexpr int R = N / 2;  // accumulator registers of one m64nN tile
  constexpr int SUB = L::SUB, MT = L::MT, W2_STAGES = L::W2_STAGES;
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  // 128-byte-swizzled tiles need 1024-byte alignment (Layout::bytes
  // reserves the slack)
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* w2s = smem;
  unsigned char* w1s = w2s + W2_STAGES * W2_STAGE;
  unsigned char* fhs = w1s + L::W1_STAGES * L::W1_STAGE;
  uint64_t* w2_full = reinterpret_cast<uint64_t*>(fhs + slots * L::SLOT);
  uint64_t* w2_empty = w2_full + W2_STAGES;
  uint64_t* w1_full = w2_empty + W2_STAGES;
  uint64_t* w1_empty = w1_full + L::W1_STAGES;
  uint64_t* fh_full = w1_empty + L::W1_STAGES;
  uint64_t* fh_empty = fh_full + L::MAX_SLOTS;

  const int rank = (int)hp::cluster_rank();
  const int split = blockIdx.x / C;
  const int m0 = blockIdx.y * N;
  const int f_begin = split * frange;
  const int flen = min(F, f_begin + frange) - f_begin;
  const int nsub = (flen + SUB - 1) / SUB;
  const int nkc = (D + KD - 1) / KD;
  const int n_base = blockIdx.z * MAX_D2;  // this pass's first D2 column
  const int ntile = (min(D2 - n_base, MAX_D2) + 63) / 64;
  // D2 tile t belongs to block t % C and warpgroup (t / C) % 2, as its
  // accumulator t / 2C: the rounds mt with a tile for warpgroup 0 here
  const int mcount = ntile > rank ? (ntile - rank + 2 * C - 1) / (2 * C) : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < W2_STAGES; ++s) {
      mbar_init(&w2_full[s], 1);
      mbar_init(&w2_empty[s], 2);
    }
    for (int s = 0; s < L::W1_STAGES; ++s) {
      mbar_init(&w1_full[s], 1);
      mbar_init(&w1_empty[s], 1);
    }
    for (int s = 0; s < L::MAX_SLOTS; ++s) {
      mbar_init(&fh_full[s], C * 128);   // every producer thread
      mbar_init(&fh_empty[s], C * 2);    // every consumer warpgroup
    }
    hp::fence_barrier_init();
  }
  hp::cluster_sync();  // every barrier of the cluster is initialised

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  if (wg < 2) {
    // ---- consumers: y^T += W2^T f(h)^T, slot by slot ------------------
    float acc[MT][R];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[mt][r] = 0.f;
    int s = 0;
    uint32_t ph = 0;
    const uint32_t fh0 = hp::smem_addr(fhs);
    const uint32_t w20 = hp::smem_addr(w2s) + wg * TILE;
    for (int j = 0; j < nsub; ++j) {
      const int slot = j % slots;
      hp::mbar_wait<true>(&fh_full[slot], (j / slots) & 1);
      const uint32_t fb = fh0 + slot * L::SLOT;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mcount) {
#pragma unroll
          for (int kh = 0; kh < SUB / KF; ++kh) {
            mbar_wait(&w2_full[s], ph);
            const uint32_t ab = w20 + s * W2_STAGE;
            hp::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KF / 16; ++kk) {
              const int k = kh * (KF / 16) + kk;  // k-step of the sub-tile
              mma<N>(acc[mt], hp::desc_sw128(ab + kk * 2048),
                     hp::desc_sw128(fb + (k / 4) * L::CHUNK + (k % 4) * 32));
            }
            hp::wgmma_commit();
            hp::wgmma_wait<0>();
            hp::fence_regs<R>(acc[mt]);
            if (tid % 128 == 0) mbar_arrive(&w2_empty[s]);
            if (++s == W2_STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
      // the slot is drained: free it in every producer of the cluster
      if (tid % 128 == 0) {
        const uint32_t e = hp::smem_addr(&fh_empty[slot]);
        for (int c = 0; c < C; ++c)
          hp::mbar_arrive_cluster(hp::map_rank(e, c));
      }
    }
    // this cluster's partial of y, written once
    float* out = ws + (size_t)split * M * D2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int n0 = n_base + (mt * 2 * C + wg * C + rank) * 64;
      if (mt >= mcount || n0 >= D2) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d2 = n0 + 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
        const int tok = m0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
        if (d2 < D2 && tok < M) out[(size_t)tok * D2 + d2] = acc[mt][r];
      }
    }
  } else if (wg == 2) {
    // ---- producer: h^T = W1^T x^T for this block's 64 columns, f, and
    // the f(h) columns into every cluster block's slot -----------------
    float h[R];
    int s = 0;
    uint32_t ph = 0;
    const uint32_t w10 = hp::smem_addr(w1s);
    const uint32_t fh0 = hp::smem_addr(fhs) + rank * L::CHUNK;
    for (int j = 0; j < nsub; ++j) {
      const int slot = j % slots;
      // sub-tile j starts once all consumers have drained sub-tile
      // j - depth from its slot
      hp::mbar_wait<true>(&fh_empty[slot], ((j / slots) & 1) ^ 1);
#pragma unroll
      for (int r = 0; r < R; ++r) h[r] = 0.f;
      for (int kc = 0; kc < nkc; ++kc) {
        mbar_wait(&w1_full[s], ph);
        const uint32_t ab = w10 + s * L::W1_STAGE;
        const uint32_t xb = ab + TILE;
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KD / 16; ++kk)
          mma<N>(h, hp::desc_sw128(ab + kk * 2048),
                 hp::desc_sw128(xb + (kk / 4) * L::XBOX + (kk % 4) * 32));
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs<R>(h);
        if (tid % 128 == 0) mbar_arrive(&w1_empty[s]);
        if (++s == L::W1_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      // f in fp32, rounded to bf16, at (token n, column f) of this
      // block's chunk in the K-major, 128-byte-swizzled slot layout
      const uint32_t dst = fh0 + slot * L::SLOT;
      const int fcol0 = f_begin + j * SUB + rank * SHARE;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int fl = 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
        const int n = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
        const float v = fcol0 + fl < F ? apply_activation(act, h[r]) : 0.f;
        const uint16_t bits = __bfloat16_as_ushort(__float2bfloat16(v));
        const uint32_t off =
            n * 128 + ((((fl >> 3) ^ (n & 7))) << 4) + (fl & 7) * 2;
        for (int c = 0; c < C; ++c)
          hp::st_cluster_u16(hp::map_rank(dst + off, c), bits);
      }
      hp::fence_async_shared_cluster();
      const uint32_t fb = hp::smem_addr(&fh_full[slot]);
      for (int c = 0; c < C; ++c)
        hp::mbar_arrive_cluster(hp::map_rank(fb, c));
    }
  } else if (lane == 0) {
    int s = 0;
    uint32_t ph = 0;
    if (warp == 0) {
      // ---- W1 (this block's 64 columns) and x, D chunk by D chunk ----
      for (int j = 0; j < nsub; ++j) {
        const int fc = f_begin + j * SUB + rank * SHARE;
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_wait(&w1_empty[s], ph ^ 1);
          unsigned char* st = w1s + s * L::W1_STAGE;
          hp::mbar_arrive_expect_tx(&w1_full[s], L::W1_STAGE);
          hp::tma_load_2d(st, &mw1, &w1_full[s], fc, kc * KD);
          hp::tma_load_2d(st + TILE, &mx, &w1_full[s], kc * KD, m0);
          hp::tma_load_2d(st + TILE + L::XBOX, &mx, &w1_full[s],
                          kc * KD + 64, m0);
          if (++s == L::W1_STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else {
      // ---- W2: both consumers' 64-column tiles, 128 F rows a stage ----
      for (int j = 0; j < nsub; ++j) {
        for (int mt = 0; mt < mcount; ++mt) {
          for (int kh = 0; kh < SUB / KF; ++kh) {
            mbar_wait(&w2_empty[s], ph ^ 1);
            unsigned char* st = w2s + s * W2_STAGE;
            const int fr = f_begin + j * SUB + kh * KF;
            hp::mbar_arrive_expect_tx(&w2_full[s], W2_STAGE);
            hp::tma_load_2d(st, &mw2, &w2_full[s],
                            n_base + (mt * 2 * C + rank) * 64, fr);
            hp::tma_load_2d(st + TILE, &mw2, &w2_full[s],
                            n_base + (mt * 2 * C + C + rank) * 64, fr);
            if (++s == W2_STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
  }
  // no block leaves while a peer may still write its slots or arrive on
  // its barriers
  hp::cluster_sync();
}

template <int N, int C>
int launch(const void* x, const void* w1, const void* w2, void* y, void* ws,
           int M, int D, int F, int D2, int frange, int depth, int act,
           cudaStream_t stream) {
  using L = Layout<N, C>;
  if (depth < 1 || frange % L::SUB || D % 8 || F % 8 || D2 % 8)
    return cudaErrorInvalidValue;
  const int slots = L::slots(depth);
  CUtensorMap mx, mw1, mw2;
  const uint64_t dx[2] = {(uint64_t)D, (uint64_t)M}, sx[1] = {2ull * D};
  const uint64_t d1[2] = {(uint64_t)F, (uint64_t)D}, s1[1] = {2ull * F};
  const uint64_t d2[2] = {(uint64_t)D2, (uint64_t)F}, s2[1] = {2ull * D2};
  const uint32_t bx[2] = {64, N}, b1[2] = {64, KD}, b2[2] = {64, KF};
  if (!repro::hopper::make_tensor_map(&mx, x, 2, dx, sx, bx) ||
      !repro::hopper::make_tensor_map(&mw1, w1, 2, d1, s1, b1) ||
      !repro::hopper::make_tensor_map(&mw2, w2, 2, d2, s2, b2))
    return cudaErrorInvalidValue;
  const size_t smem = L::bytes(depth);
  cudaError_t err = cudaFuncSetAttribute(
      ring<N, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nsplit = (F + frange - 1) / frange;
  const dim3 grid(nsplit * C, (M + N - 1) / N, (D2 + MAX_D2 - 1) / MAX_D2);
  ring<N, C><<<grid, THREADS, smem, stream>>>(
      mx, mw1, mw2, static_cast<float*>(ws), M, D, F, D2, frange, slots,
      act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return repro::launch_split_reduce(static_cast<const float*>(ws),
                                    static_cast<__nv_bfloat16*>(y),
                                    (size_t)M * D2, nsplit, stream);
}

// token rows of a panel: N of the m64nNk16 products (the wrapper's
// ``tokens_per_panel``); panels of 32 run on clusters of 8
inline int panel_rows(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : 32; }

inline int smem_bytes(int M, int depth) {
  switch (panel_rows(M)) {
    case 8: return (int)Layout<8, 4>::bytes(depth);
    case 16: return (int)Layout<16, 4>::bytes(depth);
    default: return (int)Layout<32, 8>::bytes(depth);
  }
}

int launch_bf16(const void* x, const void* w1, const void* w2, void* y,
                void* ws, int M, int D, int F, int D2, int frange, int depth,
                int act, cudaStream_t s) {
  switch (panel_rows(M)) {
    case 8:
      return launch<8, 4>(x, w1, w2, y, ws, M, D, F, D2, frange, depth, act,
                          s);
    case 16:
      return launch<16, 4>(x, w1, w2, y, ws, M, D, F, D2, frange, depth, act,
                           s);
    default:
      return launch<32, 8>(x, w1, w2, y, ws, M, D, F, D2, frange, depth, act,
                           s);
  }
}

}  // namespace tc

// ===========================================================================
// fp32: plain FMA on the CUDA cores
// ===========================================================================
namespace fp32 {

constexpr int BM = 16;             // rows per row panel
constexpr int BF = 64;             // F columns of one sub-tile (ring slot)
constexpr int BK = 64;             // producer's contraction chunk
constexpr int BN = 64;             // consumer's output-column tile
constexpr int RT = 128;            // threads of one role (4 warps)
constexpr int THREADS = 2 * RT;    // producer warps 0-3, consumer 4-7
constexpr int ROWS = BM / (RT / BF);  // one column x 8 rows a thread
static_assert(BF == BN, "both roles map a thread to one column");

// named barriers of the two roles (0 is __syncthreads)
constexpr int kProducerBar = 1;
constexpr int kConsumerBar = 2;

template <typename T>
using W1 = repro::WeightChunk<T, BK, BF, RT>;
template <typename T>
using W2 = repro::WeightChunk<T, BF, BN, RT>;
using X = repro::RowPanel<BM, BK, RT>;

__device__ __forceinline__ void role_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(RT) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pipelined_partial(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ w2, float* __restrict__ ws, int M,
                  int D, int F, int D2, int frange, int depth, int act,
                  int vec1, int vec2) {
  // dynamic: full[depth], empty[depth] mbarriers, then the ring
  // (depth, BM, BF) of f(h) in W2's type
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + depth;
  T* ring = reinterpret_cast<T*>(smem_raw + 16 * depth);
  __shared__ float psa[BM][BK];                 // producer: x chunk
  __shared__ __align__(16) T psb[BK][BF];       // producer: W1 chunk
  __shared__ __align__(16) T csb[BF][BN];       // consumer: W2 chunk

  const int m0 = blockIdx.x * BM;
  const int f_begin = blockIdx.y * frange;
  const int flen = min(F, f_begin + frange) - f_begin;
  const int nsub = (flen + BF - 1) / BF;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(&full[s], RT);
      mbar_init(&empty[s], RT);
    }
  }
  __syncthreads();  // the last block-wide barrier: the roles split here

  const int rt = tid % RT;
  const int col = rt % BF;
  const int r0 = (rt / BF) * ROWS;
  const bool live = m0 + r0 < M;  // warp-uniform
  float acc[ROWS];

  if (tid < RT) {
    // ---- producer: static primitive #1 + the flexible function ------
    const int nk = (D + BK - 1) / BK;
    uint4 reg[W1<T>::NV];
    float xr[X::PER];
    for (int j = 0; j < nsub; ++j) {
      const int slot = j % depth;
      const int fw = min(BF, flen - j * BF);     // valid sub-tile columns
      const T* w1p = w1 + f_begin + j * BF;
      // sub-tile j starts only once the consumer has drained sub-tile
      // j - depth from its slot: depth bounds how far the producer runs
      // ahead, and at depth 1 it waits for every drain (serial)
      mbar_wait(&empty[slot], ((j / depth) & 1) ^ 1);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      W1<T>::fetch(reg, w1p, F, 0, D, 0, fw, vec1, rt);
      X::fetch(xr, x, D, m0, M, 0, D, rt);
      W1<T>::stash(psb, reg, rt);
      X::stash(psa, xr, rt);
      role_sync(kProducerBar);
      for (int kc = 0; kc < nk; ++kc) {
        if (kc + 1 < nk) {
          const int k1 = (kc + 1) * BK;
          W1<T>::fetch(reg, w1p, F, k1, D, 0, fw, vec1, rt);
          X::fetch(xr, x, D, m0, M, k1, D, rt);
        }
        if (live) {
#pragma unroll
          for (int k = 0; k < BK; ++k) {
            const float b = to_f(psb[k][col]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r] = fmaf(psa[r0 + r][k], b, acc[r]);
          }
        }
        role_sync(kProducerBar);
        if (kc + 1 < nk) {
          W1<T>::stash(psb, reg, rt);
          X::stash(psa, xr, rt);
        }
        role_sync(kProducerBar);
      }
      T* dst = ring + (size_t)slot * BM * BF;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        dst[(r0 + r) * BF + col] =
            from_f<T>(col < fw ? apply_activation(act, acc[r]) : 0.f);
      mbar_arrive(&full[slot]);
    }
  } else {
    // ---- consumer: static primitive #2 on the oldest filled slot ----
    float* out = ws + (size_t)blockIdx.y * M * D2;
    const int ntile = (D2 + BN - 1) / BN;
    uint4 reg[W2<T>::NV];
    for (int j = 0; j < nsub; ++j) {
      const int slot = j % depth;
      const int fw = min(BF, flen - j * BF);
      const T* w2p = w2 + (size_t)(f_begin + j * BF) * D2;
      const T* fh = ring + (size_t)slot * BM * BF;
      // the weights do not depend on the ring: load before waiting
      W2<T>::fetch(reg, w2p, D2, 0, fw, 0, D2, vec2, rt);
      mbar_wait(&full[slot], (j / depth) & 1);
      for (int t = 0; t < ntile; ++t) {
        const int n0 = t * BN;
        role_sync(kConsumerBar);  // the previous tile's reads of csb
        W2<T>::stash(csb, reg, rt);
        role_sync(kConsumerBar);
        if (t + 1 < ntile)
          W2<T>::fetch(reg, w2p, D2, 0, fw, n0 + BN, D2, vec2, rt);
        if (!live || n0 + col >= D2) continue;
        // continue each output element's FMA chain from the workspace
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int gr = m0 + r0 + r;
          acc[r] = (j > 0 && gr < M) ? out[(size_t)gr * D2 + n0 + col]
                                     : 0.f;
        }
#pragma unroll 8
        for (int k = 0; k < BF; ++k) {
          const float b = to_f(csb[k][col]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r] = fmaf(to_f(fh[(r0 + r) * BF + k]), b, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int gr = m0 + r0 + r;
          if (gr < M) out[(size_t)gr * D2 + n0 + col] = acc[r];
        }
      }
      mbar_arrive(&empty[slot]);
    }
  }
}

template <typename T>
size_t smem_bytes(int depth) {
  return (size_t)depth * (16 + BM * BF * sizeof(T));
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, void* y, void* ws,
           int M, int D, int F, int D2, int frange, int depth, int act,
           cudaStream_t stream) {
  if (depth < 1 || frange % BF) return cudaErrorInvalidValue;
  const int nsplit = (F + frange - 1) / frange;
  const size_t smem = smem_bytes<T>(depth);
  cudaError_t err = cudaFuncSetAttribute(
      pipelined_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte weight loads need 16-byte aligned rows
  constexpr int VEC = 16 / sizeof(T);
  const int vec1 = (reinterpret_cast<uintptr_t>(w1) % 16 == 0) &&
                   (F % VEC == 0);
  const int vec2 = (reinterpret_cast<uintptr_t>(w2) % 16 == 0) &&
                   (D2 % VEC == 0);
  dim3 grid((M + BM - 1) / BM, nsplit);
  pipelined_partial<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<float*>(ws), M, D, F, D2,
      frange, depth, act, vec1, vec2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return repro::launch_split_reduce(static_cast<const float*>(ws),
                                    static_cast<T*>(y), (size_t)M * D2,
                                    nsplit, stream);
}


}  // namespace fp32

}  // namespace

// Dynamic shared memory (bytes) one block requests at ring depth
// ``depth`` for M token rows (the bf16 ring holds at most
// ``Layout::MAX_SLOTS`` slots, whatever the depth).
extern "C" int sidebar_mlp_pipelined_smem(int M, int depth, int dtype) {
  if (dtype == repro::kF32) return (int)fp32::smem_bytes<float>(depth);
  return tc::smem_bytes(M, depth);
}

// x (M, D), w1 (D, F), w2 (F, D2), y (M, D2), all contiguous row-major
// of type ``dtype``; ``frange`` a multiple of a sub-tile (C x 64 columns,
// bf16) or of 64 (fp32);
// ws holds ceil(F / frange) * M * D2 fp32. Returns the cudaError_t of
// the launches (cudaErrorInvalidValue for what a route does not take).
extern "C" int sidebar_mlp_pipelined_launch(const void* x, const void* w1,
                                            const void* w2, void* y,
                                            void* ws, int M, int D, int F,
                                            int D2, int frange, int depth,
                                            int act, int dtype,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return fp32::launch<float>(x, w1, w2, y, ws, M, D, F, D2, frange, depth,
                              act, s);
  if (dtype == repro::kBF16)
    return tc::launch_bf16(x, w1, w2, y, ws, M, D, F, D2, frange, depth,
                           act, s);
  return cudaErrorInvalidValue;
}
