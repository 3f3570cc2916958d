// Tiled product with a function-table epilogue for Hopper: c = f(a @ b).
//
// Replaces the TPU kernel src/repro/kernels/sidebar_matmul.py:
// sidebar_matmul (body ``_kernel``, pallas_call at :98): the single
// static primitive of the Sidebar design, and the producer and consumer
// products of the FLEXIBLE_DMA route (an identity epilogue there, with
// the activation as its own launch, activation.cu).
//
// What bounds it on an H100: at the serving path's shapes (rows = live
// slots, 4, or a staging round, up to 64; a (M, 6144) x (6144, 24576)
// and a (M, 24576) x (24576, 6144), bf16) it does 2*M*K*N operations
// over K*N*2 weight bytes, so it is memory-bound: 302 MB of weights per
// product for nemotron-4-15b, at least 90 us at 3.35 TB/s.
//
// What the design does about it: one block per (16-row panel, 128-column
// tile, K range) streams its (K range, 128) weight panel once, through
// the same register-prefetched two-stage pipeline as sidebar_mlp.cu
// (stream.cuh), and applies the epilogue to the fp32 accumulator before
// the single rounding to a's type. The TPU kernel carries the K-sum in
// a VMEM tile across a sequential grid axis; here the wrapper may split
// K across blocks so that a product with few column tiles (the consumer
// product at decode has 48) still fills 132 SMs. Then each block writes
// an fp32 partial to a workspace and a second pass sums the partials in
// a fixed order (no atomics: bit-identical run to run) and casts. That
// split is taken ONLY for the identity epilogue: under any other
// epilogue one block owns the whole K range of its tile, so the
// pre-activation sum never reaches HBM (sidebar_matmul.py:16-17).
// Products are plain fp32 FMA (no tensor cores, no TF32).
//
// Rounding points (src/repro/kernels/ref.py:sidebar_matmul_ref): fp32
// accumulation, f on the fp32 sum, one cast to a's type. Ragged M, K and
// N are masked, so any shape works.

#include "activation.cuh"
#include "stream.cuh"

namespace {

using repro::apply_activation;
using repro::from_f;
using repro::to_f;

constexpr int BM = 16;        // rows per row panel
constexpr int BN = 128;       // output-column tile
constexpr int BK = 64;        // contraction chunk (one pipeline stage)
constexpr int THREADS = 256;  // BN columns x 2 groups of 8 rows
constexpr int ROWS = BM / (THREADS / BN);

template <typename T>
using W = repro::WeightChunk<T, BK, BN, THREADS>;
using A = repro::RowPanel<BM, BK, THREADS>;

// grid (row panels, column tiles, K splits). With one split the block
// writes f(acc) in T; with several it writes its fp32 partial to
// ws[split] (identity epilogue only, enforced by the wrapper).
template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_tile(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, float* __restrict__ ws, int M, int K, int N,
            int krange, int act, int vecb) {
  __shared__ float sa[BM][BK];
  __shared__ __align__(16) T sb[BK][BN];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * krange;
  const int k_end = min(K, k_begin + krange);
  const int nk = (k_end - k_begin + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int r0 = (tid / BN) * ROWS;
  const bool live = m0 + r0 < M;  // warp-uniform
  uint4 reg[W<T>::NV];
  float ar[A::PER];
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  W<T>::fetch(reg, b, N, k_begin, k_end, n0, N, vecb, tid);
  A::fetch(ar, a, K, m0, M, k_begin, k_end, tid);
  W<T>::stash(sb, reg, tid);
  A::stash(sa, ar, tid);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      const int k1 = k_begin + (kc + 1) * BK;
      W<T>::fetch(reg, b, N, k1, k_end, n0, N, vecb, tid);
      A::fetch(ar, a, K, m0, M, k1, k_end, tid);
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float bv = to_f(sb[k][col]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = fmaf(sa[r0 + r][k], bv, acc[r]);
      }
    }
    __syncthreads();
    if (kc + 1 < nk) {
      W<T>::stash(sb, reg, tid);
      A::stash(sa, ar, tid);
    }
    __syncthreads();
  }

  if (!live || n0 + col >= N) return;
  float* part = ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int gr = m0 + r0 + r;
    if (gr >= M) continue;
    const size_t i = (size_t)gr * N + n0 + col;
    if (gridDim.z == 1)
      c[i] = from_f<T>(apply_activation(act, acc[r]));
    else
      part[i] = acc[r];
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, void* ws, int M, int K,
           int N, int krange, int act, cudaStream_t stream) {
  const int nsplit = K > 0 ? (K + krange - 1) / krange : 1;
  if (nsplit > 1 && act != 0) return cudaErrorInvalidValue;
  // 16-byte weight loads need 16-byte aligned rows
  constexpr int VEC = 16 / sizeof(T);
  const int vecb = (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
                   (N % VEC == 0);
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, nsplit);
  matmul_tile<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(c), static_cast<float*>(ws), M, K, N, krange, act,
      vecb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return repro::launch_split_reduce(static_cast<const float*>(ws),
                                    static_cast<T*>(c), (size_t)M * N,
                                    nsplit, stream);
}

}  // namespace

// a (M, K), b (K, N), c (M, N), all contiguous row-major of type
// ``dtype``; the K range of one block is ``krange`` (a multiple of 64;
// K itself when it covers K). With more than one K range, ``act`` must
// be 0 (identity) and ws holds ceil(K / krange) * M * N fp32. Returns
// the cudaError_t of the launches.
extern "C" int sidebar_matmul_launch(const void* a, const void* b, void* c,
                                     void* ws, int M, int K, int N,
                                     int krange, int act, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(a, b, c, ws, M, K, N, krange, act, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(a, b, c, ws, M, K, N, krange, act, s);
  return cudaErrorInvalidValue;
}
