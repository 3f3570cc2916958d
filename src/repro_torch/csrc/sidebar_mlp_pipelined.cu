// Ring-pipelined Sidebar MLP for Hopper: y = f(x @ W1) @ W2 with a
// T-deep ring of f(h) sub-tiles in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/sidebar_mlp.py:
// sidebar_mlp_pipelined (body ``_pipelined_kernel``, pallas_call at
// :273): the kernel behind ExecutionMode.SIDEBAR_PIPELINED at ring
// depth T.
//
// What bounds it on an H100: as for sidebar_mlp.cu, streaming the two
// weight matrices (604 MB per layer of nemotron-4-15b in bf16, at least
// 180 us at 3.35 TB/s); the row count at serving shapes (4 at decode,
// up to 64 in a staging round) is far below the operations-per-byte
// line.
//
// What the design does about it: a block owns a (16-row panel, F range)
// pair and splits into two roles of four warps each, which run at once
// and meet only at the ring:
//   * the PRODUCER computes h = x @ W1[:, sub-tile] for one 64-column
//     sub-tile of its F range at a time over the whole D contraction,
//     applies f in fp32, rounds f(h) to W2's type and writes it into
//     ring slot j % T (the Sidebar: f(h) never reaches HBM);
//   * the CONSUMER takes the oldest filled slot (slot (j - T + 1) % T
//     while the producer fills slot j % T, once the ring runs full),
//     multiplies it by the W2 rows of that sub-tile for every 64-column
//     tile of the output, and frees the slot.
// Each slot has a "full" and an "empty" mbarrier: the producer waits
// until its slot is empty BEFORE it computes the sub-tile, fills it and
// arrives on "full"; the consumer waits until the slot is full, drains
// it and arrives on "empty". So the producer computes sub-tile j only
// after sub-tile j - T is drained: the consumer lags at most T - 1
// sub-tiles, as the TPU kernel's does, and for T >= 2 the producer's W1
// stream overlaps the consumer's W2 stream. T = 1 is the serial schedule
// (compute, drain, compute, ...). The TPU kernel realizes the same ring
// with a lagged sequential grid and T - 1 drain steps
// (sidebar_mlp.py:119-168).
//
// The F range of a block is at least 4 sub-tiles (the wrapper's
// ``f_range_pipelined``), so a ring has something to pipeline even at
// decode, where the serial kernel gives a block one 128-column tile.
// The consumer's accumulator for 16 rows x D2 outputs (393 KB for
// D2 = 6144) fits neither shared memory nor registers, so the block
// carries its fp32 partial y in its own workspace slice: for every
// sub-tile it loads each element's running sum, continues its FMA chain
// over the sub-tile's 64 terms, and stores it back. fp32 stores and
// loads are exact and the sub-tiles are consumed in order, so every
// element is the same chain of FMAs at every depth: the output is
// BITWISE identical for every T (as the TPU kernel's is,
// sidebar_mlp.py:245-246), because the F partition depends on M and F
// only. A second pass sums the per-block partials in a fixed order (no
// atomics) and casts to x's type. Products are plain fp32 FMA.
//
// Rounding points (src/repro/kernels/ref.py:34-37): fp32 h, f in fp32,
// f(h) cast to W2's type, fp32 accumulation, output in x's type.
// Ragged M, D, F and D2 are masked, so any shape works.

#include "activation.cuh"
#include "stream.cuh"

namespace {

using repro::apply_activation;
using repro::from_f;
using repro::to_f;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive with release semantics: this thread's shared-memory writes
// (or reads) before it are ordered before the phase completes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// wait (acquire) until the phase of parity ``parity`` has completed. A
// protocol fault must not hang the card: after ~10 s of spinning the
// kernel traps, and the launch reports an error instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t ok;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
    if (ok) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
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

}  // namespace

// Dynamic shared memory (bytes) one block requests at ring depth
// ``depth``: the ring and its mbarriers.
extern "C" int sidebar_mlp_pipelined_smem(int depth, int dtype) {
  return dtype == repro::kF32 ? (int)smem_bytes<float>(depth)
                              : (int)smem_bytes<__nv_bfloat16>(depth);
}

// x (M, D), w1 (D, F), w2 (F, D2), y (M, D2), all contiguous row-major
// of type ``dtype``; ``frange`` a multiple of 64; ws holds
// ceil(F / frange) * M * D2 fp32. Returns the cudaError_t of the
// launches.
extern "C" int sidebar_mlp_pipelined_launch(const void* x, const void* w1,
                                            const void* w2, void* y,
                                            void* ws, int M, int D, int F,
                                            int D2, int frange, int depth,
                                            int act, int dtype,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(x, w1, w2, y, ws, M, D, F, D2, frange, depth, act,
                         s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, w1, w2, y, ws, M, D, F, D2, frange,
                                 depth, act, s);
  return cudaErrorInvalidValue;
}
