// Fused gated Sidebar MLP for Hopper: y = (f(x @ Wg) * (x @ Wu)) @ Wd.
//
// Replaces the TPU kernel
// src/repro/kernels/sidebar_gated_mlp.py:sidebar_gated_mlp (body
// ``_kernel``, pallas_call at :118): the MLP of the llama family
// (deepseek-7b, and 7 other of the repository's 10 architectures).
//
// What bounds it on an H100: at the serving path's shapes (decode rows
// M = live slots, 4; prefill rows = staged rows x chunk, up to 64) the
// three products do 3*2*M*D*F operations over 3*D*F*2 weight bytes, so
// the kernel is memory-bound: the bf16 Wg + Wu + Wd of deepseek-7b are
// 270.5 MB per layer (at least 81 us at 3.35 TB/s), of deepseek-v3's
// dense layers 792.7 MB (237 us).
//
// Two routes, chosen by the wrapper (kernels/sidebar_mlp.py ``route``):
//
// ---- tc: bf16 operands that TMA can stride (D, F, D2 multiples of 8,
// 16-byte aligned) take the tensor-core body of the Sidebar MLP kernels
// (sidebar_tc.cuh, G = 2) with one f(h) slot, the TPU kernel's serial
// order: the producer warpgroup of each block computes g^T = Wg^T x^T and
// u^T = Wu^T x^T for its 64 F columns as two wgmma accumulators over the
// whole D (a W1 stage holds a Wg box and a Wu box beside the x box),
// writes h = f(g) * u (fp32, rounded to Wd's type) into every block's
// slot of the cluster, and the consumers run the ring's W2 side on Wd.
// Clusters of 4 beside 8-row panels and of 8 beside 16- and 32-row
// panels, so that a pass covers 12288 D2 columns at up to 16 rows:
// deepseek-v3's 7168 in one pass, Wg and Wu read once. Filling the card:
// the wrapper (``gated_splits``) gives each panel's clusters F ranges of
// 64-column shares that differ by at most one share, not whole sub-tiles
// (deepseek-7b at decode: 172 shares on 33 clusters of 4, all 132 SMs,
// where whole 256-column sub-tiles kept 88 busy). The partition depends
// on M and F only: one run's output equals the next one's bit for bit.
//
// ---- fma: fp32 operands, and bf16 ones of any other width or alignment,
// take the stream kernel below. What it does: every weight byte is read
// once per row panel (one panel covers up to 16 rows, so decode reads
// each byte once), and neither the gate, the up projection nor their
// product ever leaves the SM. The TPU kernel runs its F blocks in order
// on one core, with two fp32 (bm, bf) sidebars for gate and up and an
// accumulator carried across them in VMEM; Hopper runs blocks in
// parallel and in no order, so here
//   pass 1: block (row panel, F split) walks its F range one 64-column
//           tile at a time. For each tile it streams the Wg and Wu
//           panels together over the whole D contraction, holding the
//           gate and up tiles in fp32 REGISTERS (4 rows x 1 column a
//           thread), then applies f to the gate, multiplies by the up
//           tile, rounds h to Wd's type and keeps it in SHARED MEMORY
//           (the Sidebar: it never reaches HBM). Only h (16 x F range
//           in the weight type, <= 64 KB in bf16) needs shared memory;
//           two fp32 sidebars of 16 x 2048 would not fit a block's
//           227 KB.
//           The block then multiplies h by the Wd row panel of its
//           split, writing one fp32 partial y per split to a workspace;
//   pass 2: sums the partials over the splits in a fixed order (split
//           0, 1, 2, ...) and casts to the output type (stream.cuh).
// No atomics: the result is bit-identical run to run. The 64-column
// tile lets an F that 128 does not divide (deepseek-7b: 11008 = 172 x
// 64) fill the card: 172 blocks at decode, where 128-column tiles give
// 86 for 132 SMs. The wrapper picks the split so the grid fills the
// card; a ragged last split is masked. Each product streams its weights
// through the register-prefetched two-stage pipeline of stream.cuh (the
// next chunk's 16-byte loads in flight while the current one is
// multiplied out of shared memory, element by element where the rows or
// pointers are not 16-byte aligned). Products are plain fp32 FMA (TF32
// would break the fp32 gates).
//
// Rounding points (src/repro/kernels/sidebar_gated_mlp.py:68, :71 and
// :84; src/repro/kernels/ref.py:40-54): fp32 gate and up, f in fp32 on
// the gate, h = f(g) * u cast to Wd's type, fp32 accumulation, the
// output cast to x's type once. Ragged M, D, F and D2 are masked, so any
// shape works.

#include "activation.cuh"
#include "sidebar_tc.cuh"
#include "stream.cuh"

namespace {

using repro::apply_activation;
using repro::from_f;
using repro::to_f;

constexpr int BM = 16;        // rows per row panel
constexpr int BK = 64;        // contraction chunk of all three products
constexpr int THREADS = 256;
// pass 1: BN1 F columns x 4 groups of 4 rows, gate and up side by side
constexpr int BN1 = 64;
constexpr int ROWS1 = BM / (THREADS / BN1);
// the down product: BN2 output columns x 2 groups of 8 rows
constexpr int BN2 = 128;
constexpr int ROWS2 = BM / (THREADS / BN2);

template <typename T>
using W1 = repro::WeightChunk<T, BK, BN1, THREADS>;
template <typename T>
using W2 = repro::WeightChunk<T, BK, BN2, THREADS>;
using X = repro::RowPanel<BM, BK, THREADS>;

// A row group whose rows all lie past M skips its FMAs (decode has 4
// live rows of the 16-row panel); the groups are warp-aligned.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gated_partial(const T* __restrict__ x, const T* __restrict__ wg,
              const T* __restrict__ wu, const T* __restrict__ wd,
              float* __restrict__ ws, int M, int D, int F, int D2,
              int frange, int act, int vec1, int vec2) {
  static_assert(2 * W1<T>::NV == W2<T>::NV, "one register stage for both");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sidebar = reinterpret_cast<T*>(smem_raw);  // (BM, frange): h
  __shared__ float sa[BM][BK];
  // pass 1 stages the Wg chunk in rows [0, BK) and the Wu chunk in rows
  // [BK, 2 BK) of (2 BK, BN1); the down product stages its (BK, BN2)
  // chunk in the same bytes
  __shared__ __align__(16) T sb[2 * BK * BN1];
  T(*sgu)[BN1] = reinterpret_cast<T(*)[BN1]>(sb);
  T(*sd)[BN2] = reinterpret_cast<T(*)[BN2]>(sb);

  const int m0 = blockIdx.x * BM;
  const int f_begin = blockIdx.y * frange;
  const int flen = min(F, f_begin + frange) - f_begin;
  const int tid = threadIdx.x;
  uint4 reg[W2<T>::NV];
  float xr[X::PER];

  // columns [flen, frange) of the Sidebar are read (as zeros) by the
  // down product's last chunk
  const int pad = frange - flen;
  for (int i = tid; i < BM * pad; i += THREADS)
    sidebar[(i / pad) * frange + flen + i % pad] = from_f<T>(0.f);

  {
    // static primitives #1 and #2: g = x[m0:m0+BM] @ Wg[:, range] and
    // u = x[m0:m0+BM] @ Wu[:, range], tile by tile; then the flexible
    // function and the gate product on the fp32 tiles, into the Sidebar
    const int col = tid % BN1;
    const int r0 = (tid / BN1) * ROWS1;
    const bool live = m0 + r0 < M;  // warp-uniform
    float accg[ROWS1], accu[ROWS1];
    const T* wgp = wg + f_begin;
    const T* wup = wu + f_begin;
    const int nk = max(1, (D + BK - 1) / BK);
    const int n = ((flen + BN1 - 1) / BN1) * nk;
    W1<T>::fetch(reg, wgp, F, 0, D, 0, flen, vec1, tid);
    W1<T>::fetch(reg + W1<T>::NV, wup, F, 0, D, 0, flen, vec1, tid);
    X::fetch(xr, x, D, m0, M, 0, D, tid);
    W1<T>::stash(sgu, reg, tid);
    W1<T>::stash(sgu + BK, reg + W1<T>::NV, tid);
    X::stash(sa, xr, tid);
    __syncthreads();
    for (int it = 0; it < n; ++it) {
      const int kc = it % nk, n0 = (it / nk) * BN1;
      if (kc == 0) {
#pragma unroll
        for (int r = 0; r < ROWS1; ++r) accg[r] = accu[r] = 0.f;
      }
      if (it + 1 < n) {
        const int k1 = ((it + 1) % nk) * BK, c1 = ((it + 1) / nk) * BN1;
        W1<T>::fetch(reg, wgp, F, k1, D, c1, flen, vec1, tid);
        W1<T>::fetch(reg + W1<T>::NV, wup, F, k1, D, c1, flen, vec1, tid);
        X::fetch(xr, x, D, m0, M, k1, D, tid);
      }
      if (live) {
#pragma unroll 16
        for (int k = 0; k < BK; ++k) {
          const float bg = to_f(sgu[k][col]);
          const float bu = to_f(sgu[BK + k][col]);
#pragma unroll
          for (int r = 0; r < ROWS1; ++r) {
            const float a = sa[r0 + r][k];
            accg[r] = fmaf(a, bg, accg[r]);
            accu[r] = fmaf(a, bu, accu[r]);
          }
        }
      }
      if (kc == nk - 1 && n0 + col < flen) {
#pragma unroll
        for (int r = 0; r < ROWS1; ++r)
          sidebar[(r0 + r) * frange + n0 + col] =
              from_f<T>(apply_activation(act, accg[r]) * accu[r]);
      }
      __syncthreads();
      if (it + 1 < n) {
        W1<T>::stash(sgu, reg, tid);
        W1<T>::stash(sgu + BK, reg + W1<T>::NV, tid);
        X::stash(sa, xr, tid);
      }
      __syncthreads();
    }
  }

  // static primitive #3: partial y = h @ Wd[f_begin:f_end, :]
  const int col = tid % BN2;
  const int r0 = (tid / BN2) * ROWS2;
  const bool live = m0 + r0 < M;  // warp-uniform
  float acc[ROWS2];
  const T* wdp = wd + (size_t)f_begin * D2;
  float* out = ws + (size_t)blockIdx.y * M * D2;
  const int nk = (flen + BK - 1) / BK;
  const int n = ((D2 + BN2 - 1) / BN2) * nk;
  W2<T>::fetch(reg, wdp, D2, 0, flen, 0, D2, vec2, tid);
  W2<T>::stash(sd, reg, tid);
  __syncthreads();
  for (int it = 0; it < n; ++it) {
    const int kc = it % nk, n0 = (it / nk) * BN2, k0 = kc * BK;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < ROWS2; ++r) acc[r] = 0.f;
    }
    if (it + 1 < n)
      W2<T>::fetch(reg, wdp, D2, ((it + 1) % nk) * BK, flen,
                   ((it + 1) / nk) * BN2, D2, vec2, tid);
    if (live) {
#pragma unroll 16
      for (int k = 0; k < BK; ++k) {
        const float b = to_f(sd[k][col]);
#pragma unroll
        for (int r = 0; r < ROWS2; ++r)
          acc[r] = fmaf(to_f(sidebar[(r0 + r) * frange + k0 + k]), b,
                        acc[r]);
      }
    }
    if (kc == nk - 1 && live && n0 + col < D2) {
#pragma unroll
      for (int r = 0; r < ROWS2; ++r) {
        const int gr = m0 + r0 + r;
        if (gr < M) out[(size_t)gr * D2 + n0 + col] = acc[r];
      }
    }
    __syncthreads();
    if (it + 1 < n) W2<T>::stash(sd, reg, tid);
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* y, void* ws, int M, int D, int F, int D2, int frange,
           int act, cudaStream_t stream) {
  // the Sidebar is read in whole BK chunks: frange is a multiple of BN1
  // (the wrapper's rule), and BN1 of BK
  if (frange <= 0 || frange % BN1) return cudaErrorInvalidValue;
  const int nsplit = (F + frange - 1) / frange;
  const size_t smem = (size_t)BM * frange * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gated_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte weight loads need 16-byte aligned rows
  constexpr int VEC = 16 / sizeof(T);
  const int vec1 = (reinterpret_cast<uintptr_t>(wg) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(wu) % 16 == 0) &&
                   (F % VEC == 0) && (frange % VEC == 0);
  const int vec2 = (reinterpret_cast<uintptr_t>(wd) % 16 == 0) &&
                   (D2 % VEC == 0);
  dim3 grid((M + BM - 1) / BM, nsplit);
  gated_partial<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<float*>(ws), M, D, F, D2, frange, act, vec1, vec2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return repro::launch_split_reduce(static_cast<const float*>(ws),
                                    static_cast<T*>(y), (size_t)M * D2,
                                    nsplit, stream);
}

}  // namespace

// D2 passes (grid z) of the tc route at M token rows: each recomputes
// its clusters' h, so Wg and Wu are read once a pass.
extern "C" int sidebar_gated_mlp_passes(int M, int D2) {
  return repro::tc::passes<2>(M, D2);
}

// x (M, D), wg and wu (D, F), wd (F, D2), y (M, D2), all contiguous
// row-major of type ``dtype``; ``act`` an elementwise id of
// activation.cuh; ``route`` a ``repro::Route``. ``part``: on the fma
// route the F range of one block (a multiple of 64; ws holds
// ceil(F / part) * M * D2 fp32), on the tc route the clusters a panel
// (ws holds part * M * D2 fp32). Returns the cudaError_t of the
// launches (cudaErrorInvalidValue for what a route does not take).
extern "C" int sidebar_gated_mlp_launch(const void* x, const void* wg,
                                        const void* wu, const void* wd,
                                        void* y, void* ws, int M, int D,
                                        int F, int D2, int part, int act,
                                        int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > repro::kMaxActivation || act == repro::kSoftmax ||
      act == repro::kRmsnorm)
    return cudaErrorInvalidValue;
  if (route == repro::kTc && dtype == repro::kBF16)
    return repro::tc::launch_bf16<2>(x, wg, wu, wd, y, ws, M, D, F, D2, part,
                                     1, act, s);
  if (route != repro::kFma) return cudaErrorInvalidValue;
  if (dtype == repro::kF32)
    return launch<float>(x, wg, wu, wd, y, ws, M, D, F, D2, part, act, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, wg, wu, wd, y, ws, M, D, F, D2, part,
                                 act, s);
  return cudaErrorInvalidValue;
}
