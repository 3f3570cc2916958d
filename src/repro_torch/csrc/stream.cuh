// Register-prefetched tile streaming shared by the product kernels' FMA
// routes (sidebar_ring.cuh, sidebar_gated_mlp.cu, sidebar_matmul.cu),
// and the fixed-order split reduce of every MLP kernel.
//
// A kernel multiplies a (BM, BK) panel of its left operand, held in
// shared memory as fp32, by a (BK, BN) chunk of a row-major weight,
// held in shared memory in the weight's type. While it multiplies one
// chunk, each of its NT threads already holds the next chunk's loads in
// flight in registers (``fetch``), and writes them to shared memory
// (``stash``) once the current chunk is done. Out-of-range elements
// load as zeros, so ragged edges need no other mask.
#pragma once

#include "common.cuh"

namespace repro {

// (BK, BN) chunk of a row-major weight, streamed by NT threads as
// 16-byte vectors where the rows allow it
template <typename T, int BK, int BN, int NT>
struct WeightChunk {
  static constexpr int VEC = 16 / sizeof(T);         // elements per vector
  static constexpr int NV = BK * BN / NT / VEC;      // vectors per thread
  static constexpr int VPR = BN / VEC;               // vectors per row
  static_assert(BK * BN % (NT * VEC) == 0, "chunk must split evenly");

  // rows [k0, k0 + BK) x columns [n0, n0 + BN) of ``w`` (leading
  // dimension ``ld``, K x N valid) into registers, zeros outside
  static __device__ __forceinline__ void fetch(uint4* reg,
                                               const T* __restrict__ w,
                                               size_t ld, int k0, int K,
                                               int n0, int N, bool vec_ok,
                                               int tid) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + i * NT;
      const int k = k0 + v / VPR, c = n0 + (v % VPR) * VEC;
      if (vec_ok && k < K && c + VEC <= N) {
        reg[i] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * ld + c));
      } else {  // ragged edge or unaligned rows: element by element
        uint4 u;
        T* e_out = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          e_out[e] = (k < K && c + e < N) ? w[(size_t)k * ld + c + e]
                                          : from_f<T>(0.f);
        reg[i] = u;
      }
    }
  }

  static __device__ __forceinline__ void stash(T (*sb)[BN], const uint4* reg,
                                               int tid) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + i * NT;
      *reinterpret_cast<uint4*>(&sb[v / VPR][(v % VPR) * VEC]) = reg[i];
    }
  }
};

// (BM, BK) panel of a row-major left operand as fp32, streamed by NT
// threads
template <int BM, int BK, int NT>
struct RowPanel {
  static constexpr int PER = BM * BK / NT;           // elements per thread
  static_assert(BM * BK % NT == 0, "panel must split evenly");

  // rows [m0, m0 + BM) x columns [k0, k0 + BK) of ``x`` (leading
  // dimension ``ld``, M x K valid) into registers, zeros outside
  template <typename T>
  static __device__ __forceinline__ void fetch(float* xr,
                                               const T* __restrict__ x,
                                               size_t ld, int m0, int M,
                                               int k0, int K, int tid) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT;
      const int gr = m0 + i / BK, gk = k0 + i % BK;
      xr[j] = (gr < M && gk < K) ? to_f(x[(size_t)gr * ld + gk]) : 0.f;
    }
  }

  static __device__ __forceinline__ void stash(float (*sa)[BK],
                                               const float* xr, int tid) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT;
      sa[i / BK][i % BK] = xr[j];
    }
  }
};

// y = cast(sum over ``nsplit`` fp32 partials of ``total`` elements, in
// split order 0, 1, 2, ...): the fixed-order second pass of a product
// split across blocks (no atomics: bit-identical run to run). Launched
// as a programmatic dependent of the product (common.cuh): every thread
// waits for it before touching global memory.
template <typename T>
__global__ void split_reduce(const float* __restrict__ ws, T* __restrict__ y,
                             size_t total, int nsplit) {
  griddep_wait();
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += ws[(size_t)sp * total + i];
  griddep_launch_dependents();
  y[i] = from_f<T>(s);
}

template <typename T>
cudaError_t launch_split_reduce(const float* ws, T* y, size_t total,
                                int nsplit, cudaStream_t stream) {
  const unsigned threads = 256;
  return launch_dependent(split_reduce<T>,
                          dim3((unsigned)((total + threads - 1) / threads)),
                          dim3(threads), 0, stream, ws, y, total, nsplit);
}

}  // namespace repro
