// The tensor-core body of the Sidebar MLP kernels on Hopper (bf16
// operands), one template instantiated by three entry points:
//   * sidebar_mlp.cu, the serial kernel: y = f(x W1) W2 with ONE f(h)
//     slot (G = 1, depth 1);
//   * sidebar_mlp_pipelined.cu, the ring: the same body with a T-deep
//     ring of f(h) slots (G = 1, depth T);
//   * sidebar_gated_mlp.cu: y = (f(x Wg) * (x Wu)) Wd with one slot
//     (G = 2: the producer computes the gate and the up projection).
// sidebar_matmul.cu runs the producer's product alone (``Chunk``, the
// tensor maps), without the consumers: c^T = b^T a^T.
// Each source's header says which TPU kernel it replaces and what bounds
// it; this one says how the body works.
//
// A cluster of C blocks (neighbouring SMs) owns one (panel of N token
// rows, F range) pair. The F range is walked in sub-tiles of C x 64
// columns, one f(h) slot each: block r of the cluster computes the r-th
// 64-column share of every sub-tile. Each block has three warpgroups and
// two loader warps:
//   * the PRODUCER warpgroup computes h^T = W1^T x^T for its share over
//     the whole D contraction (wgmma m64nNk16, the weight as the 64-row
//     MN-major operand, x^T as the N-wide K-major one: at 4-64 tokens the
//     swapped product keeps the tensor cores' M on the weight). Under
//     G = 2 it computes g^T = Wg^T x^T and u^T = Wu^T x^T, two m64nN
//     accumulators over the same x tiles. It applies f in fp32
//     (``apply_activation``, so the run-time ``device_expr`` builds keep
//     working), and under G = 2 multiplies by u in fp32; it rounds the
//     result to bf16 (W2's type: the rounding points of
//     src/repro/kernels/ref.py:34-37 and
//     src/repro/kernels/sidebar_gated_mlp.py:68-71) and writes its 64
//     columns into the slot of EVERY block of the cluster through
//     distributed shared memory. The Sidebar thus spans the cluster:
//     f(h) never reaches HBM. A block whose share lies past the
//     cluster's range (a partial last sub-tile) loads nothing and writes
//     zeros;
//   * two CONSUMER warpgroups multiply the oldest filled slot
//     (K = C x 64) by the W2 rows of that sub-tile: y^T = W2^T f(h)^T,
//     again with the weight as the 64-row MN-major operand. The D2
//     columns are dealt in 64-column tiles round-robin over the
//     cluster's C blocks x 2 consumer warpgroups; a consumer holds MT
//     tiles of 64 x N fp32 accumulators (ACC_REGS registers a thread)
//     for the whole F range, so no partial y round-trips through memory
//     between sub-tiles. A pass thus covers MT x 2C x 64 columns (PASS:
//     12288 for (N, C) = (8, 4) and (16, 8), 6144 for (16, 4) and
//     (32, 8)); a wider D2 is walked in passes, one grid z index each,
//     and each pass recomputes its clusters' f(h) (W1 read once a pass);
//   * a loader warp streams W1 (128 x 64 tiles; Wg and Wu side by side
//     under G = 2) and x for the producer, another streams W2 (two
//     128 x 64 tiles a stage, rows of the cluster's range only) for the
//     consumers, by TMA into rings with full/empty mbarriers. The stage
//     counts (``Layout``) fill the shared memory the f(h) slots leave.
// Slot j % T has a "full" barrier that completes when all C producers of
// the cluster have written their columns (cluster-scope release /
// acquire) and an "empty" barrier in every block that completes when all
// 2C consumer warpgroups of the cluster have drained it. A producer waits
// for its slot to be empty BEFORE it computes the sub-tile, so the
// consumers lag at most T - 1 sub-tiles, as the TPU kernel's do. With
// one slot (T = 1) the producer computes a sub-tile only after every
// consumer of the cluster has drained the one before: the TPU kernel's
// order (compute a sidebar tile, consume it, then the next) and the
// paper's serial Sidebar mode.
//
// Bitwise equal across depths: the F partition and the (N, C) shape
// depend on M and F only, sub-tiles are consumed in order, and every
// output element is the same sequence of wgmma instructions at every
// depth, so the serial kernel equals the ring at every depth. Each
// cluster writes its fp32 partial of y once; a second pass
// (stream.cuh ``split_reduce``) sums the F ranges in a fixed order (no
// atomics) and casts to x's type: bit-identical run to run.
//
// Partition (the wrappers compute it; the kernel takes ``part``):
//   * G = 1 (the plain MLP, ``sidebar_mlp.f_range_pipelined``): ranges of
//     ``part`` columns, whole sub-tiles; the panels' clusters aim at one
//     block on each of the 132 SMs;
//   * G = 2 (the gated MLP, ``sidebar_gated_mlp.gated_splits``): ``part``
//     clusters a panel, whose ranges of 64-column shares differ by at most
//     one share, so every SM gets a block even where F / 64 is not a
//     multiple of the cluster count (deepseek-7b's 172 shares on 33
//     clusters of 4 at decode, deepseek-v3's 288).
// Only the last sub-tile of a range can be partial: its W2 rows past the
// range are not loaded (whole 128-row boxes: at most 64 rows of the next
// range ride along, multiplied by zeros).
//
// Eligibility (the wrappers' route rule, kernels/sidebar_mlp.py
// ``route``): D, F and D2 multiples of 8 (TMA row strides in whole
// 16 bytes), 16-byte aligned operands. Ragged M, D, F and D2 are
// zero-filled by TMA and masked.
#pragma once

#include "activation.cuh"
#include "hopper.cuh"
#include "stream.cuh"

namespace repro {
namespace tc {

namespace hp = repro::hopper;

constexpr int SHARE = 64;            // F columns a block computes a sub-tile
constexpr int KD = 128;              // D rows of a W1 stage
constexpr int KF = 128;              // F rows of a W2 stage
constexpr int TILE = 64 * 128 * 2;   // one 128-row x 64-column bf16 box
constexpr int W2_STAGE = 2 * TILE;   // one box per consumer warpgroup
constexpr int ACC_REGS = 96;         // fp32 accumulators of a consumer
                                     // thread in one pass
constexpr int THREADS = 3 * 128 + 2 * 32;  // 2 consumer WGs, producer WG,
                                           // 2 loader warps

// Panels of N token rows on clusters of C blocks; G products in the
// producer (1: W1; 2: Wg and Wu). The stage counts and ring slots are
// what the 227 KB of shared memory hold beside each other.
template <int N, int C, int G>
struct Layout {
  static constexpr int ROWS = N, CLUSTER = C;
  static constexpr int R = N / 2;               // registers of an m64nN tile
  static constexpr int SUB = C * SHARE;         // F columns of a sub-tile
  static constexpr int MT = ACC_REGS / R;       // D2 tiles of a consumer
  static constexpr int PASS = MT * 2 * C * 64;  // D2 columns of a pass
  static constexpr int W1_STAGE = G * TILE + 2 * N * 128;  // Chunk::BYTES
  static constexpr int W1_STAGES = G == 2 ? (N == 32 ? 3 : 4)
                                          : (N == 8 ? 5 : 4);
  static constexpr int W2_STAGES = G == 2 || C == 8 ? 2 : 3;
  static constexpr int MAX_SLOTS = G == 2 ? 1 : C == 8 ? 2 : 4;
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
  static_assert(W2_STAGES * W2_STAGE + W1_STAGES * W1_STAGE +
                        MAX_SLOTS * SLOT + 1024 + BARS * 8 <= 232448,
                "a block's shared memory");
};

// m64nNk16, A (the weight) MN-major, B K-major, both in shared memory
template <int N>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "m64nN product");
  if constexpr (N == 8)
    hp::wgmma_m64n8k16_ss<1, 0>(d, da, db);
  else if constexpr (N == 16)
    hp::wgmma_m64n16k16_ss<1, 0>(d, da, db);
  else if constexpr (N == 32)
    hp::wgmma_m64n32k16_ss<1, 0>(d, da, db);
  else
    hp::wgmma_m64n64k16_ss<1, 0>(d, da, db);
}

// One KD-deep contraction chunk of the swapped product h^T = W^T x^T on
// N token rows, as the MLP body's producer and sidebar_matmul.cu's
// consumer run it. A stage holds G 128 x 64 weight boxes (KD contraction
// rows x 64 output columns: the 64-row MN-major operand; Wg then Wu
// under G = 2) and then two N x 64 boxes of the token rows (contraction
// columns [k, k + 64) and [k + 64, k + 128): the K-major operand).
template <int N, int G>
struct Chunk {
  static constexpr int XBOX = N * 128;               // N rows x 64 of x
  static constexpr int BYTES = G * TILE + 2 * XBOX;  // one stage

  // h^T (+)= W^T x^T over the stage at shared address ``st``; under
  // G = 2 the second weight box into ``u``. The caller fences, commits
  // and waits.
  static __device__ __forceinline__ void mma_stage(float* h, float* u,
                                                   uint32_t st) {
    const uint32_t xb = st + G * TILE;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      const uint64_t dx =
          hp::desc_sw128(xb + (kk / 4) * XBOX + (kk % 4) * 32);
      mma<N>(h, hp::desc_sw128(st + kk * 2048), dx);
      if constexpr (G == 2)
        mma<N>(u, hp::desc_sw128(st + TILE + kk * 2048), dx);
    }
  }

  // the loader's side: the weight box(es) at (column c, row k) and the
  // token rows' boxes at (column k, row m0) into the stage ``st``,
  // completing on ``bar``
  static __device__ __forceinline__ void load(
      unsigned char* st, const CUtensorMap* mw, const CUtensorMap* mwu,
      const CUtensorMap* mx, uint64_t* bar, int c, int k, int m0) {
    hp::mbar_arrive_expect_tx(bar, BYTES);
    hp::tma_load_2d(st, mw, bar, c, k);
    if constexpr (G == 2) hp::tma_load_2d(st + TILE, mwu, bar, c, k);
    unsigned char* xs = st + G * TILE;
    hp::tma_load_2d(xs, mx, bar, k, m0);
    hp::tma_load_2d(xs + XBOX, mx, bar, k + 64, m0);
  }
};

// The tensor maps of the swapped product: a row-major (rows, cols) bf16
// weight in boxes of 128 rows x 64 columns, and N token rows of a
// row-major (M, D) operand in boxes of N rows x 64 columns. False if
// the encoding is refused.
inline bool weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {2ull * cols};
  const uint32_t box[2] = {64, 128};
  return hp::make_tensor_map(map, w, 2, dims, strides, box);
}

template <int N>
bool rows_map(CUtensorMap* map, const void* x, int M, int D) {
  const uint64_t dims[2] = {(uint64_t)D, (uint64_t)M};
  const uint64_t strides[1] = {2ull * D};
  const uint32_t box[2] = {64, N};
  return hp::make_tensor_map(map, x, 2, dims, strides, box);
}

// F columns [begin, begin + len) of the cluster of F split ``split``
template <int G>
__device__ __forceinline__ void cluster_span(int split, int part, int F,
                                             int& begin, int& len) {
  int end;
  if constexpr (G == 1) {  // whole ranges of ``part`` columns
    begin = split * part;
    end = begin + part;
  } else {  // ``part`` ranges of 64-column shares, within one of each other
    const int shares = (F + SHARE - 1) / SHARE;
    const int q = shares / part, rem = shares % part;
    begin = (split * q + min(split, rem)) * SHARE;
    end = begin + (q + (split < rem ? 1 : 0)) * SHARE;
  }
  len = max(0, min(F, end) - begin);
}

template <int N, int C, int G>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(THREADS, 1)
ring(const __grid_constant__ CUtensorMap mx,
     const __grid_constant__ CUtensorMap mw1,
     const __grid_constant__ CUtensorMap mwu,
     const __grid_constant__ CUtensorMap mw2, float* __restrict__ ws,
     int M, int D, int F, int D2, int part, int slots, int act) {
  using L = Layout<N, C, G>;
  static_assert(L::W1_STAGE == Chunk<N, G>::BYTES, "a W1 stage is a chunk");
  constexpr int R = L::R;
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
  int f_begin, flen;
  cluster_span<G>(split, part, F, f_begin, flen);
  const int nsub = (flen + SUB - 1) / SUB;
  const int nkc = (D + KD - 1) / KD;
  const int n_base = blockIdx.z * L::PASS;  // this pass's first column
  const int ntile = (min(D2 - n_base, L::PASS) + 63) / 64;
  // D2 tile t belongs to block t % C and warpgroup (t / C) % 2, as its
  // accumulator t / 2C: the rounds mt with a tile for warpgroup 0 here
  const int mcount = ntile > rank ? (ntile - rank + 2 * C - 1) / (2 * C) : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < W2_STAGES; ++s) {
      hp::mbar_init(&w2_full[s], 1);
      hp::mbar_init(&w2_empty[s], 2);
    }
    for (int s = 0; s < L::W1_STAGES; ++s) {
      hp::mbar_init(&w1_full[s], 1);
      hp::mbar_init(&w1_empty[s], 1);
    }
    for (int s = 0; s < L::MAX_SLOTS; ++s) {
      hp::mbar_init(&fh_full[s], C * 128);   // every producer thread
      hp::mbar_init(&fh_empty[s], C * 2);    // every consumer warpgroup
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
      // W2 boxes of this sub-tile's rows inside the range
      const int nkh = (min(SUB, flen - j * SUB) + KF - 1) / KF;
      hp::mbar_wait<true>(&fh_full[slot], (j / slots) & 1);
      const uint32_t fb = fh0 + slot * L::SLOT;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mcount) {
          for (int kh = 0; kh < nkh; ++kh) {
            hp::mbar_wait(&w2_full[s], ph);
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
            if (tid % 128 == 0) hp::mbar_arrive(&w2_empty[s]);
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
    // ---- producer: this block's share of each sub-tile (h, or g and u),
    // f, and the f(h) columns into every cluster block's slot ----------
    float h[R], u[G == 2 ? R : 1];
    int s = 0;
    uint32_t ph = 0;
    const uint32_t w10 = hp::smem_addr(w1s);
    const uint32_t fh0 = hp::smem_addr(fhs) + rank * L::CHUNK;
    for (int j = 0; j < nsub; ++j) {
      const int slot = j % slots;
      const int share0 = j * SUB + rank * SHARE;  // within the range
      // a share past the range (a partial last sub-tile) loads nothing
      const int nk = share0 < flen ? nkc : 0;
      // sub-tile j starts once all consumers have drained sub-tile
      // j - depth from its slot
      hp::mbar_wait<true>(&fh_empty[slot], ((j / slots) & 1) ^ 1);
#pragma unroll
      for (int r = 0; r < R; ++r) h[r] = 0.f;
      if constexpr (G == 2) {
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = 0.f;
      }
      for (int kc = 0; kc < nk; ++kc) {
        hp::mbar_wait(&w1_full[s], ph);
        hp::wgmma_fence();
        Chunk<N, G>::mma_stage(h, u, w10 + s * L::W1_STAGE);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs<R>(h);
        if constexpr (G == 2) hp::fence_regs<R>(u);
        if (tid % 128 == 0) hp::mbar_arrive(&w1_empty[s]);
        if (++s == L::W1_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      // f in fp32 (times u under G = 2), rounded to bf16, at (token n,
      // column f) of this block's chunk in the K-major, 128-byte-swizzled
      // slot layout; zeros past the range
      const uint32_t dst = fh0 + slot * L::SLOT;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int fl = 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
        const int n = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
        float v = 0.f;
        if (share0 + fl < flen) {
          v = apply_activation(act, h[r]);
          if constexpr (G == 2) v *= u[r];
        }
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
      // ---- W1 (this block's share; Wg and Wu under G = 2) and x, D
      // chunk by D chunk ---------------------------------------------
      for (int j = 0; j < nsub; ++j) {
        const int share0 = j * SUB + rank * SHARE;
        const int fc = f_begin + share0;
        const int nk = share0 < flen ? nkc : 0;
        for (int kc = 0; kc < nk; ++kc) {
          hp::mbar_wait(&w1_empty[s], ph ^ 1);
          Chunk<N, G>::load(w1s + s * L::W1_STAGE, &mw1, &mwu, &mx,
                            &w1_full[s], fc, kc * KD, m0);
          if (++s == L::W1_STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else {
      // ---- W2: both consumers' 64-column tiles, 128 F rows a stage ----
      for (int j = 0; j < nsub; ++j) {
        const int nkh = (min(SUB, flen - j * SUB) + KF - 1) / KF;
        for (int mt = 0; mt < mcount; ++mt) {
          for (int kh = 0; kh < nkh; ++kh) {
            hp::mbar_wait(&w2_empty[s], ph ^ 1);
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

// x (M, D); w1 (D, F) (Wg under G = 2, wu its Wu); w2 (F, D2); y (M, D2);
// ws holds splits * M * D2 fp32
template <int N, int C, int G>
int launch(const void* x, const void* w1, const void* wu, const void* w2,
           void* y, void* ws, int M, int D, int F, int D2, int part,
           int depth, int act, cudaStream_t stream) {
  using L = Layout<N, C, G>;
  if (depth < 1 || part < 1 || (G == 1 && part % L::SUB) || D % 8 ||
      F % 8 || D2 % 8)
    return cudaErrorInvalidValue;
  const int slots = L::slots(depth);
  CUtensorMap mx, mw1, mwu, mw2;
  if (!rows_map<N>(&mx, x, M, D) || !weight_map(&mw1, w1, D, F) ||
      !weight_map(&mwu, G == 2 ? wu : w1, D, F) ||
      !weight_map(&mw2, w2, F, D2))
    return cudaErrorInvalidValue;
  const size_t smem = L::bytes(depth);
  cudaError_t err = cudaFuncSetAttribute(
      ring<N, C, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // F splits of a panel: ranges of ``part`` columns, or ``part`` clusters
  const int nsplit = G == 1 ? (F + part - 1) / part : part;
  const dim3 grid(nsplit * C, (M + N - 1) / N,
                  (D2 + L::PASS - 1) / L::PASS);
  ring<N, C, G><<<grid, THREADS, smem, stream>>>(
      mx, mw1, mwu, mw2, static_cast<float*>(ws), M, D, F, D2, part, slots,
      act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_split_reduce(static_cast<const float*>(ws),
                             static_cast<__nv_bfloat16*>(y), (size_t)M * D2,
                             nsplit, stream);
}

// token rows of a panel: N of the m64nNk16 products (the wrappers'
// ``tokens_per_panel``)
inline int panel_rows(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : 32; }

// Each instance (N, C) of G products at M token rows: clusters of 4
// beside 8-row panels; of 8 beside 32-row panels (a consumer holds
// 64 x 32 accumulators); beside 16-row panels of 4 for the plain MLP and
// of 8 for the gated one, whose pass then covers 12288 columns
// (deepseek-v3's D2 of 7168 in one pass). The wrappers' ``cluster_size``
// and ``gated_cluster_size`` say the same.
template <int G, typename Fn>
auto dispatch(int M, Fn&& fn) {
  switch (panel_rows(M)) {
    case 8: return fn(Layout<8, 4, G>{});
    case 16:
      if constexpr (G == 1)
        return fn(Layout<16, 4, G>{});
      else
        return fn(Layout<16, 8, G>{});
    default: return fn(Layout<32, 8, G>{});
  }
}

template <int G>
int launch_bf16(const void* x, const void* w1, const void* wu,
                const void* w2, void* y, void* ws, int M, int D, int F,
                int D2, int part, int depth, int act, cudaStream_t s) {
  return dispatch<G>(M, [&](auto l) {
    using L = decltype(l);
    return launch<L::ROWS, L::CLUSTER, G>(x, w1, wu, w2, y, ws, M, D, F, D2,
                                          part, depth, act, s);
  });
}

// dynamic shared memory (bytes) a block requests at ring depth ``depth``
template <int G>
int smem_bytes(int M, int depth) {
  return dispatch<G>(M,
                     [&](auto l) { return (int)decltype(l)::bytes(depth); });
}

// D2 passes (grid z) at M token rows
template <int G>
int passes(int M, int D2) {
  return dispatch<G>(M, [&](auto l) {
    return (D2 + decltype(l)::PASS - 1) / decltype(l)::PASS;
  });
}

}  // namespace tc
}  // namespace repro
