// Tiled product with a function-table epilogue for Hopper: c = f(a @ b).
//
// Replaces the TPU kernel src/repro/kernels/sidebar_matmul.py:
// sidebar_matmul (body ``_kernel``, pallas_call at :98): the single
// static primitive of the Sidebar design, and the producer and consumer
// products of the FLEXIBLE_DMA route (an identity epilogue there, with
// the activation as its own launch, activation.cu). Its epilogue writes
// c to HBM: that round trip is the FLEXIBLE_DMA design the paper
// measures the Sidebar against, so nothing here fuses it away.
//
// What bounds it on an H100: at the serving path's shapes (rows = live
// slots, 4, or a staging round, up to 64; a (M, 6144) x (6144, 24576)
// and a (M, 24576) x (24576, 6144), bf16) it does 2*M*K*N operations
// over K*N*2 weight bytes, so it is memory-bound: 302 MB of weights per
// product for nemotron-4-15b, at least 90 us at 3.35 TB/s. The weight
// has to stream from HBM once, with tens of KB of loads in flight on
// every SM.
//
// What the design does about it. Two routes, chosen by the wrappers'
// rule of shape (kernels/sidebar_mlp.py ``route``, shared with the MLP
// kernels); the partition of each is a pure function of (M, K, N, the
// epilogue, the route), computed by kernels/sidebar_matmul.py ``plan``
// and passed in (panel rows, K range):
//   * "tc" (bf16, K and N multiples of 8, 16-byte aligned): the MLP
//     body's producer (sidebar_tc.cuh ``Chunk``) without its consumers:
//     c^T = b^T a^T on the tensor cores, a 128 x 64 box of b as the
//     64-row MN-major wgmma operand and the panel's token rows of a as
//     the N-wide K-major one. One block owns 64 output columns of one
//     panel of up to 64 rows (m64n8/16/32/64 products), so at M <= 64
//     each weight tile is read from HBM once; above 64 rows panels of 64
//     are walked on grid x (correct, not tuned: no serving path sends
//     more than 64 rows). One loader warp keeps a TMA ring of (weight
//     box, token boxes) stages in flight with full/empty mbarriers, one
//     consumer warpgroup multiplies; the ring fills what two blocks an
//     SM leave of shared memory (about 100 KB each), so an SM has up to
//     ~190 KB of weight loads outstanding. The epilogue writes its 64
//     columns of c (M, N) row-major from the c^T accumulator fragment,
//     masking ragged M and N;
//   * "fma" (fp32; bf16 of other widths or alignment): one block per
//     (16-row panel, 128-column tile, K range) streams its (K range,
//     128) weight panel once through the register-prefetched two-stage
//     pipeline of stream.cuh on the CUDA cores (plain fp32 FMA, no
//     TF32); ragged M, K and N are masked, so any shape works.
// Filling the card: the consumer product at decode has only 96 (tc) or
// 48 (fma) column tiles, so under the identity epilogue K is split
// across blocks. Then each block writes an fp32 partial to a workspace
// and a second pass (stream.cuh ``split_reduce``) sums the partials in
// a fixed order (no atomics: bit-identical run to run) and casts. The
// split is taken ONLY for the identity epilogue: under any other one
// block owns the whole K range of its tile, so the pre-activation sum
// never reaches HBM (sidebar_matmul.py:16-17).
//
// Both routes, and the split reduce, launch as programmatic dependents
// (common.cuh ``launch_dependent``), so FLEXIBLE_DMA's chain of five
// launches (producer, its reduce, the activation, consumer, its reduce)
// overlaps each launch's ramp with the end of the one before. A block
// sets up only shared memory before ``griddep_wait``: a operand is the
// launch before's output, and c or ws may reuse a buffer it still reads.
// It lets the next launch be scheduled once its last K chunk is in.
//
// Rounding points (src/repro/kernels/ref.py:sidebar_matmul_ref): fp32
// accumulation, f on the fp32 sum (``apply_activation``, so run-time
// ``device_expr`` builds keep working), one cast to a's type.

#include "sidebar_tc.cuh"

namespace {

using repro::apply_activation;
using repro::from_f;
using repro::to_f;

// ---- the fma route ------------------------------------------------------

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
// ws[split] (identity epilogue only, enforced by the launch).
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

  repro::griddep_wait();  // a is the launch before's output
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
  repro::griddep_launch_dependents();

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
int launch_fma(const void* a, const void* b, void* c, void* ws, int M,
               int K, int N, int krange, int act, cudaStream_t stream) {
  const int nsplit = K > 0 ? (K + krange - 1) / krange : 1;
  // 16-byte weight loads need 16-byte aligned rows
  constexpr int VEC = 16 / sizeof(T);
  const int vecb = (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
                   (N % VEC == 0);
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, nsplit);
  cudaError_t err = repro::launch_dependent(
      matmul_tile<T>, grid, dim3(THREADS), 0, stream,
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(c), static_cast<float*>(ws), M, K, N, krange, act,
      vecb);
  if (err != cudaSuccess || nsplit == 1) return err;
  return repro::launch_split_reduce(static_cast<const float*>(ws),
                                    static_cast<T*>(c), (size_t)M * N,
                                    nsplit, stream);
}

// ---- the tc route -------------------------------------------------------

namespace tc = repro::tc;
namespace hp = repro::hopper;

constexpr int TC_N = 64;                 // output columns of a block
constexpr int TC_THREADS = 128 + 32;     // a consumer warpgroup, a loader
constexpr int TC_MAX_STAGES = 8;
// two blocks an SM: each keeps below half of the SM's 228 KB, less the
// 1 KB the runtime reserves for every block
constexpr int TC_SMEM_CAP = 233472 / 2 - 1024;

// The ring of a block with panels of N token rows: as many stages as
// the shared memory of two blocks an SM holds, and a full / empty
// mbarrier each (plus the slack that 1024-aligns the swizzled tiles)
template <int N>
struct Ring {
  static constexpr int ROWS = N;
  static constexpr int STAGE = tc::Chunk<N, 1>::BYTES;
  static constexpr int FIT = (TC_SMEM_CAP - 1024) / (STAGE + 16);
  static constexpr int STAGES = FIT < TC_MAX_STAGES ? FIT : TC_MAX_STAGES;
  static constexpr int BYTES = 1024 + STAGES * (STAGE + 16);
  static_assert(STAGES >= 2 && BYTES <= TC_SMEM_CAP, "two blocks an SM");
};

// grid (row panels, 64-column tiles, K splits): block (p, t, s) computes
// c[p*N : p*N + N, t*64 : t*64 + 64] over K range s. One split: f(acc)
// in bf16 into c; several: the fp32 partial into ws[s] (identity only).
template <int N>
__global__ void __launch_bounds__(TC_THREADS, 2)
matmul_tc(const __grid_constant__ CUtensorMap ma,
          const __grid_constant__ CUtensorMap mb,
          __nv_bfloat16* __restrict__ c, float* __restrict__ ws, int M,
          int K, int Ncol, int krange, int act) {
  using R = Ring<N>;
  using Ch = tc::Chunk<N, 1>;
  constexpr int ACC = N / 2;  // fp32 accumulators of an m64nN thread
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;

  const int m0 = blockIdx.x * N;
  const int n0 = blockIdx.y * TC_N;
  const int k0 = blockIdx.z * krange;
  const int nk = (min(K, k0 + krange) - k0 + tc::KD - 1) / tc::KD;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 1);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  repro::griddep_wait();  // a is the launch before's output

  if (tid < 128) {
    // ---- consumer: c^T += b^T a^T, stage by stage --------------------
    float acc[ACC];
#pragma unroll
    for (int r = 0; r < ACC; ++r) acc[r] = 0.f;
    const uint32_t base = hp::smem_addr(smem);
    int s = 0;
    uint32_t ph = 0;
    for (int kc = 0; kc < nk; ++kc) {
      hp::mbar_wait(&full[s], ph);
      hp::wgmma_fence();
      Ch::mma_stage(acc, nullptr, base + s * R::STAGE);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs<ACC>(acc);
      if (tid == 0) hp::mbar_arrive(&empty[s]);
      if (++s == R::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    repro::griddep_launch_dependents();
    // thread t holds c^T rows (output columns) 16 w + l / 4 (+ 8) and
    // columns (token rows) 8 i + 2 (l % 4) (+ 1): hopper.cuh's layout
    const int warp = tid / 32, lane = tid % 32;
    float* part = ws + (size_t)blockIdx.z * M * Ncol;
#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      const int col = n0 + 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
      const int tok = m0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      if (col >= Ncol || tok >= M) continue;
      const size_t i = (size_t)tok * Ncol + col;
      if (gridDim.z == 1)
        c[i] = __float2bfloat16(apply_activation(act, acc[r]));
      else
        part[i] = acc[r];
    }
  } else if (tid == 128) {
    // ---- loader: the weight box and the panel's token boxes of each
    // 128-deep chunk of this block's K range --------------------------
    int s = 0;
    uint32_t ph = 0;
    for (int kc = 0; kc < nk; ++kc) {
      hp::mbar_wait(&empty[s], ph ^ 1);
      Ch::load(smem + s * R::STAGE, &mb, &mb, &ma, &full[s], n0,
               k0 + kc * tc::KD, m0);
      if (++s == R::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  }
}

template <int N>
int launch_tc(const void* a, const void* b, void* c, void* ws, int M, int K,
              int Ncol, int krange, int act, cudaStream_t stream) {
  if (krange <= 0 || krange % tc::KD || K <= 0 || K % 8 || Ncol % 8)
    return cudaErrorInvalidValue;
  const int nsplit = (K + krange - 1) / krange;
  CUtensorMap ma, mb;
  if (!tc::rows_map<N>(&ma, a, M, K) || !tc::weight_map(&mb, b, K, Ncol))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_tc<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<N>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + N - 1) / N, (Ncol + TC_N - 1) / TC_N, nsplit);
  err = repro::launch_dependent(matmul_tc<N>, grid, dim3(TC_THREADS),
                                Ring<N>::BYTES, stream, ma, mb,
                                static_cast<__nv_bfloat16*>(c),
                                static_cast<float*>(ws), M, K, Ncol, krange,
                                act);
  if (err != cudaSuccess || nsplit == 1) return err;
  return repro::launch_split_reduce(static_cast<const float*>(ws),
                                    static_cast<__nv_bfloat16*>(c),
                                    (size_t)M * Ncol, nsplit, stream);
}

// the tc instance of a panel of ``rows`` token rows (8, 16, 32 or 64)
template <typename Fn>
int tc_dispatch(int rows, Fn&& fn) {
  switch (rows) {
    case 8: return fn(Ring<8>{});
    case 16: return fn(Ring<16>{});
    case 32: return fn(Ring<32>{});
    case 64: return fn(Ring<64>{});
    default: return -1;
  }
}

}  // namespace

// a (M, K), b (K, N), c (M, N), all contiguous row-major of type
// ``dtype``, on route ``route`` (common.cuh ``Route``) with the partition
// of kernels/sidebar_matmul.py ``plan``: panels of ``panel_rows`` rows
// (16 on the fma route; 8, 16, 32 or 64 on the tc route) and K ranges
// of ``krange`` (a multiple of 64 on the fma route, of 128 on the tc
// route; K itself or more when it covers K). With more than one K range
// ``act`` must be 0 (identity) and ws holds ceil(K / krange) * M * N
// fp32. Returns the cudaError_t of the launches.
extern "C" int sidebar_matmul_launch(const void* a, const void* b, void* c,
                                     void* ws, int M, int K, int N,
                                     int panel_rows, int krange, int act,
                                     int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (krange <= 0 || (K > krange && act != 0)) return cudaErrorInvalidValue;
  if (route == repro::kTc) {
    if (dtype != repro::kBF16) return cudaErrorInvalidValue;
    const int err = tc_dispatch(panel_rows, [&](auto r) {
      return launch_tc<decltype(r)::ROWS>(a, b, c, ws, M, K, N, krange, act, s);
    });
    return err < 0 ? cudaErrorInvalidValue : err;
  }
  if (route != repro::kFma || panel_rows != BM || krange % BK)
    return cudaErrorInvalidValue;
  if (dtype == repro::kF32)
    return launch_fma<float>(a, b, c, ws, M, K, N, krange, act, s);
  if (dtype == repro::kBF16)
    return launch_fma<__nv_bfloat16>(a, b, c, ws, M, K, N, krange, act, s);
  return cudaErrorInvalidValue;
}

// dynamic + static shared memory (bytes) one block of ``route`` takes
// at panels of ``panel_rows`` rows in ``dtype``; -1 for an instance the
// launch does not have
extern "C" int sidebar_matmul_smem(int panel_rows, int dtype, int route) {
  if (route == repro::kTc)
    return tc_dispatch(panel_rows, [](auto r) {
      return decltype(r)::BYTES;
    });
  if (route != repro::kFma || panel_rows != BM) return -1;
  const int wbytes = dtype == repro::kF32 ? 4 : 2;
  return BM * BK * 4 + BK * BN * wbytes;
}
