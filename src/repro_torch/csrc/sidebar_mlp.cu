// Fused Sidebar MLP for Hopper: y = f(x @ W1) @ W2.
//
// Replaces the TPU kernel src/repro/kernels/sidebar_mlp.py:sidebar_mlp
// (body ``_kernel``, pallas_call at :209).
//
// What bounds it on an H100: at the serving path's shapes (decode rows
// M = live slots, 4; prefill rows = staged rows x chunk, 64) the two
// products do 2*M*D*F*2 operations over D*F*2 + F*D*2 weight bytes, so
// the kernel is memory-bound: the bf16 W1 + W2 of nemotron-4-15b are
// 604 MB per layer, at least 180 us at 3.35 TB/s.
//
// What the design does about it: every weight byte is read once per
// row panel (one panel covers up to 16 rows, so decode reads each byte
// once), and the intermediate never leaves the SM. The TPU kernel runs
// its F blocks in order on one core and carries the sum over them in a
// VMEM accumulator; Hopper runs blocks in parallel and in no order, so
// here
//   pass 1: block (row panel, F split) computes h = x @ W1[:, split]
//           over the whole D contraction, applies f in fp32, rounds
//           f(h) to W2's type and keeps it in SHARED MEMORY (the
//           Sidebar: it never reaches HBM), then multiplies it by the
//           W2 row panel of its split, writing one fp32 partial y per
//           split to a workspace;
//   pass 2: sums the partials over the splits in a fixed order (split
//           0, 1, 2, ...) and casts to the output type.
// No atomics: the result is bit-identical run to run. The number of
// splits is chosen by the wrapper so that the grid fills the card.
// Each product streams its weight panel through a two-stage pipeline
// (16-byte loads of the next 64-row chunk in flight in registers while
// the current chunk is multiplied out of shared memory), so a block
// keeps 16-32 KB of loads outstanding. Products are plain fp32 FMA (no
// tensor cores, no TF32); wgmma/TMA pipelines are later work.
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

constexpr int BM = 16;        // rows per row panel
constexpr int BN = 128;       // output-column tile of both products
constexpr int BK = 64;        // contraction chunk (one pipeline stage)
constexpr int THREADS = 256;  // BN columns x 2 groups of 8 rows
constexpr int ROWS = BM / (THREADS / BN);

template <typename T>
using W = repro::WeightChunk<T, BK, BN, THREADS>;
using X = repro::RowPanel<BM, BK, THREADS>;

// Both products stream their weight panel through a two-stage pipeline:
// while the block multiplies the chunk in shared memory, each thread
// already holds the next chunk's loads in flight in registers. The
// (tile, chunk) iterations are flattened so the prefetch also crosses
// column-tile boundaries. A row group whose rows all lie past M skips
// its FMAs (decode has 4 live rows of the 16-row panel).
template <typename T>
__global__ void __launch_bounds__(THREADS)
sidebar_partial(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ w2, float* __restrict__ ws, int M,
                int D, int F, int D2, int frange, int act, int vec1,
                int vec2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sidebar = reinterpret_cast<T*>(smem_raw);  // (BM, frange): f(h)
  __shared__ float sa[BM][BK];
  __shared__ __align__(16) T sb[BK][BN];

  const int m0 = blockIdx.x * BM;
  const int f_begin = blockIdx.y * frange;
  const int flen = min(F, f_begin + frange) - f_begin;
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int r0 = (tid / BN) * ROWS;
  const bool live = m0 + r0 < M;  // warp-uniform
  uint4 reg[W<T>::NV];
  float xr[X::PER];
  float acc[ROWS];

  // columns [flen, frange) of the Sidebar are read (as zeros) by the
  // second product's last chunk
  for (int i = tid; i < BM * (frange - flen); i += THREADS)
    sidebar[(i / (frange - flen)) * frange + flen + i % (frange - flen)] =
        from_f<T>(0.f);

  // static primitive #1: h = x[m0:m0+BM] @ W1[:, f_begin:f_end], then
  // the flexible function on the fp32 tile, into the Sidebar
  const T* w1p = w1 + f_begin;
  const int nk1 = (D + BK - 1) / BK;
  const int n1 = ((flen + BN - 1) / BN) * nk1;
  W<T>::fetch(reg, w1p, F, 0, D, 0, flen, vec1, tid);
  X::fetch(xr, x, D, m0, M, 0, D, tid);
  W<T>::stash(sb, reg, tid);
  X::stash(sa, xr, tid);
  __syncthreads();
  for (int it = 0; it < n1; ++it) {
    const int kc = it % nk1, n0 = (it / nk1) * BN;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    }
    if (it + 1 < n1) {
      const int k1 = ((it + 1) % nk1) * BK;
      W<T>::fetch(reg, w1p, F, k1, D, ((it + 1) / nk1) * BN, flen, vec1,
                  tid);
      X::fetch(xr, x, D, m0, M, k1, D, tid);
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float b = to_f(sb[k][col]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sa[r0 + r][k], b, acc[r]);
      }
    }
    if (kc == nk1 - 1 && n0 + col < flen) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        sidebar[(r0 + r) * frange + n0 + col] =
            from_f<T>(apply_activation(act, acc[r]));
    }
    __syncthreads();
    if (it + 1 < n1) {
      W<T>::stash(sb, reg, tid);
      X::stash(sa, xr, tid);
    }
    __syncthreads();
  }

  // static primitive #2: partial y = f(h) @ W2[f_begin:f_end, :]
  const T* w2p = w2 + (size_t)f_begin * D2;
  float* out = ws + (size_t)blockIdx.y * M * D2;
  const int nk2 = (flen + BK - 1) / BK;
  const int n2 = ((D2 + BN - 1) / BN) * nk2;
  W<T>::fetch(reg, w2p, D2, 0, flen, 0, D2, vec2, tid);
  W<T>::stash(sb, reg, tid);
  __syncthreads();
  for (int it = 0; it < n2; ++it) {
    const int kc = it % nk2, n0 = (it / nk2) * BN, k0 = kc * BK;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    }
    if (it + 1 < n2)
      W<T>::fetch(reg, w2p, D2, ((it + 1) % nk2) * BK, flen,
                  ((it + 1) / nk2) * BN, D2, vec2, tid);
    if (live) {
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float b = to_f(sb[k][col]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = fmaf(to_f(sidebar[(r0 + r) * frange + k0 + k]), b,
                        acc[r]);
      }
    }
    if (kc == nk2 - 1 && live && n0 + col < D2) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int gr = m0 + r0 + r;
        if (gr < M) out[(size_t)gr * D2 + n0 + col] = acc[r];
      }
    }
    __syncthreads();
    if (it + 1 < n2) W<T>::stash(sb, reg, tid);
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, void* y, void* ws,
           int M, int D, int F, int D2, int frange, int act,
           cudaStream_t stream) {
  const int nsplit = (F + frange - 1) / frange;
  const size_t smem = (size_t)BM * frange * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      sidebar_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte weight loads need 16-byte aligned rows
  constexpr int VEC = 16 / sizeof(T);
  const int vec1 = (reinterpret_cast<uintptr_t>(w1) % 16 == 0) &&
                   (F % VEC == 0) && (frange % VEC == 0);
  const int vec2 = (reinterpret_cast<uintptr_t>(w2) % 16 == 0) &&
                   (D2 % VEC == 0);
  dim3 grid((M + BM - 1) / BM, nsplit);
  sidebar_partial<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<float*>(ws), M, D, F, D2,
      frange, act, vec1, vec2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return repro::launch_split_reduce(static_cast<const float*>(ws),
                                    static_cast<T*>(y), (size_t)M * D2,
                                    nsplit, stream);
}

}  // namespace

// x (M, D), w1 (D, F), w2 (F, D2), y (M, D2), all contiguous row-major
// of type ``dtype``; ws holds ceil(F / frange) * M * D2 fp32. Returns
// the cudaError_t of the launches.
extern "C" int sidebar_mlp_launch(const void* x, const void* w1,
                                  const void* w2, void* y, void* ws, int M,
                                  int D, int F, int D2, int frange, int act,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(x, w1, w2, y, ws, M, D, F, D2, frange, act, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, w1, w2, y, ws, M, D, F, D2, frange, act,
                                 s);
  return cudaErrorInvalidValue;
}
