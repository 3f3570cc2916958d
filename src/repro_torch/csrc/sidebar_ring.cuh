// The Sidebar MLP ring of the Hopper kernels sidebar_mlp.cu (one slot:
// the serial kernel) and sidebar_mlp_pipelined.cu (a T-deep ring), and
// the route between its two bodies:
//   * tc (sidebar_tc.cuh): bf16 operands with D, F and D2 multiples of 8
//     and 16-byte aligned data, on the tensor cores;
//   * fma (below): fp32 operands, and bf16 operands of any other width or
//     alignment, on the CUDA cores.
// The route is the wrappers' choice (kernels/sidebar_mlp.py ``route``, a
// pure function of dtype, widths and alignment); a launch on a route that
// does not take its operands returns cudaErrorInvalidValue.
//
// ---- fma: plain FMA ---------------------------------------------------
//
// TF32 would break the fp32 gates (1e-4), so fp32 stays on the CUDA
// cores: a block owns a (16-row panel, F range) pair and splits into a
// producer and a consumer role of four warps each, which meet at a ring
// of 64-column sub-tiles (f(h) in W2's type); the consumer carries its
// fp32 partial of y in a workspace slice across sub-tiles (16 rows x D2
// fit neither shared memory nor registers), which keeps every element
// one FMA chain at every depth: bitwise equal across depths, and the
// serial kernel (depth 1) equals the ring. The weights stream through
// stream.cuh's register prefetch, as 16-byte vectors where the rows and
// the pointer allow it and element by element elsewhere, so any width
// and alignment computes.
#pragma once

#include "activation.cuh"
#include "hopper.cuh"
#include "sidebar_tc.cuh"
#include "stream.cuh"

namespace repro {
namespace fma {

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
      hopper::mbar_init(&full[s], RT);
      hopper::mbar_init(&empty[s], RT);
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
      hopper::mbar_wait(&empty[slot], ((j / depth) & 1) ^ 1);
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
      hopper::mbar_arrive(&full[slot]);
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
      hopper::mbar_wait(&full[slot], (j / depth) & 1);
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
      hopper::mbar_arrive(&empty[slot]);
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
  return launch_split_reduce(static_cast<const float*>(ws),
                                    static_cast<T*>(y), (size_t)M * D2,
                                    nsplit, stream);
}
}  // namespace fma

// Dynamic shared memory (bytes) one block requests at ring depth
// ``depth`` for M token rows on ``route``.
inline int mlp_ring_smem(int M, int depth, int dtype, int route) {
  if (route == kTc) return tc::smem_bytes<1>(M, depth);
  return (int)(dtype == kF32 ? fma::smem_bytes<float>(depth)
                             : fma::smem_bytes<__nv_bfloat16>(depth));
}

// y = f(x @ w1) @ w2 through a ``depth``-deep ring on ``route``; x (M, D),
// w1 (D, F), w2 (F, D2), y (M, D2), contiguous row-major of type
// ``dtype``; ``frange`` the F range of one cluster (tc: whole sub-tiles)
// or block (fma: whole 64-column sub-tiles); ws holds
// ceil(F / frange) * M * D2 fp32.
inline int mlp_ring_launch(const void* x, const void* w1, const void* w2,
                           void* y, void* ws, int M, int D, int F, int D2,
                           int frange, int depth, int act, int dtype,
                           int route, cudaStream_t s) {
  if (route == kTc && dtype == kBF16)
    return tc::launch_bf16<1>(x, w1, nullptr, w2, y, ws, M, D, F, D2,
                              frange, depth, act, s);
  if (route != kFma) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return fma::launch<float>(x, w1, w2, y, ws, M, D, F, D2, frange, depth,
                              act, s);
  if (dtype == kBF16)
    return fma::launch<__nv_bfloat16>(x, w1, w2, y, ws, M, D, F, D2, frange,
                                      depth, act, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro
