// Grouped expert product of the MoE layer: out[r] = a[r] @ w[e(r)] for
// rows r sorted by expert, fp32 out (``jnp.dot(...,
// preferred_element_type=float32)`` of ``_expert_mlp`` in
// src/repro/models/moe.py:65, which the JAX package leaves to XLA as
// one product per expert, no Pallas).
//
// Layout: a (n, K) in the rows' order, w (E, K, N), ``offsets`` (E + 1)
// int32 on the card: expert e owns rows [offsets[e], offsets[e + 1]);
// rows from offsets[E] on belong to no expert and keep the zeros the
// wrapper wrote. The grid has a fixed size for a given (n, N, E), so the
// product never reads the groups on the host and a CUDA graph can hold
// it: x walks every (expert, row tile) the groups could need, at most
// ceil(n / BM) + E of them, and a block finds its own from ``offsets``
// (blocks past the last tile return at once); y walks column tiles. A
// block reads only its expert's weights, so an expert no row chose is
// never read: at deepseek-v3's decode the layer reads the at most 32
// chosen of 256 experts.
//
// What bounds it: at decode a group holds a few rows, so the work is
// the chosen experts' weights read once (bytes); at a long prefill the
// products (operations). Two routes, one rule (``moe_experts.route``):
//   "tc"  bf16 with K and N multiples of 8 at 16-byte aligned
//         addresses: 64 x 64 tiles on four warps, mma.sync m16n8k16
//         bf16 -> fp32, a three-stage cp.async ring of 32-deep A and W
//         tiles (the W tile of a column stripe is read from HBM once a
//         row tile; rows past the group are zero-filled by cp.async);
//   "fma" fp32, or bf16 of any other width: 16 x 64 tiles, each thread
//         four rows of one column, fmaf in ascending k.
// Each output element sums its K terms in a fixed order that depends
// only on its own row and column, never on which other rows share its
// tile: a token's expert output is the same alone or in a batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the (expert, first row, rows) of row tile ``tile`` over the groups
struct Tile {
  int expert, row0, rows;
};

__device__ __forceinline__ Tile find_tile(const int* __restrict__ offsets,
                                          int E, int tile, int BM) {
  for (int e = 0; e < E; ++e) {
    const int b = offsets[e];
    const int c = offsets[e + 1] - b;
    const int t = (c + BM - 1) / BM;
    if (tile < t) return {e, b + tile * BM, min(BM, c - tile * BM)};
    tile -= t;
  }
  return {-1, 0, 0};
}

// ---- "tc": mma.sync on the tensor cores ------------------------------

constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 32, TC_STAGES = 3;
constexpr int TC_THREADS = 128;
constexpr int A_LD = TC_BK + 8;   // padded rows: 80 bytes, ldmatrix
constexpr int B_LD = TC_BN + 8;   // without bank conflicts (144 bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(TC_THREADS)
grouped_mm_tc(const bf16* __restrict__ A, const bf16* __restrict__ W,
              const int* __restrict__ offsets, float* __restrict__ out,
              int K, int N, int E) {
  const Tile tile = find_tile(offsets, E, blockIdx.x, TC_BM);
  if (tile.expert < 0) return;
  const int n0 = blockIdx.y * TC_BN;
  const bf16* Wj = W + static_cast<size_t>(tile.expert) * K * N;

  __shared__ __align__(128) bf16 As[TC_STAGES][TC_BM][A_LD];
  __shared__ __align__(128) bf16 Bs[TC_STAGES][TC_BK][B_LD];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kt_count = (K + TC_BK - 1) / TC_BK;

  // one 32-deep stage: A 64 x 32 and W 32 x 64, 16 bytes a copy, two of
  // each a thread
  auto load = [&](int stage, int kt) {
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * TC_THREADS;
      const int r = c / (TC_BK / 8), col = (c % (TC_BK / 8)) * 8;
      const bool ok = r < tile.rows && k0 + col < K;
      const bf16* src =
          ok ? A + static_cast<size_t>(tile.row0 + r) * K + k0 + col : A;
      cp_async16(&As[stage][r][col], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * TC_THREADS;
      const int r = c / (TC_BN / 8), col = (c % (TC_BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + col < N;
      const bf16* src =
          ok ? Wj + static_cast<size_t>(k0 + r) * N + n0 + col : Wj;
      cp_async16(&Bs[stage][r][col], src, ok);
    }
  };

  float acc[TC_BN / 8][4];
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < kt_count) load(s, s);
    cp_async_commit();
  }
  // a warp whose 16 rows all lie past the group computes nothing
  const bool live = warp * 16 < tile.rows;
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    const int next = kt + TC_STAGES - 1;
    if (next < kt_count) load(next % TC_STAGES, next);
    cp_async_commit();
    const int st = kt % TC_STAGES;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < TC_BK; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, &As[st][warp * 16 + lane % 16][kk + lane / 16 * 8]);
#pragma unroll
        for (int j = 0; j < TC_BN / 8; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, &Bs[st][kk + lane % 16][(j + lane / 16) * 8]);
          mma_bf16(acc[j], a, b[0], b[1]);
          mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!live) return;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      if (r < tile.rows) {
        float2 v = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        *reinterpret_cast<float2*>(
            out + static_cast<size_t>(tile.row0 + r) * N + col) = v;
      }
    }
  }
}

// ---- "fma": the CUDA cores, any type and width ------------------------

constexpr int F_BM = 16, F_BN = 64, F_BK = 32, F_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(F_THREADS)
grouped_mm_fma(const T* __restrict__ A, const T* __restrict__ W,
               const int* __restrict__ offsets, float* __restrict__ out,
               int K, int N, int E) {
  const Tile tile = find_tile(offsets, E, blockIdx.x, F_BM);
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

}  // namespace

// grid x: the row tiles the groups could need (ceil(n / BM) + E), y: the
// column tiles; route 1 = "tc", 0 = "fma" (kernels/moe_experts.py)
extern "C" int moe_grouped_mm_launch(const void* a, const void* w,
                                     const void* offsets, void* out, int n,
                                     int K, int N, int E, int dtype,
                                     int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || N <= 0 || E <= 0) return cudaSuccess;
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  if (route == repro::kTc) {
    if (dtype != repro::kBF16 || K % 8 || N % 8) return cudaErrorInvalidValue;
    dim3 grid((n + TC_BM - 1) / TC_BM + E, (N + TC_BN - 1) / TC_BN);
    grouped_mm_tc<<<grid, TC_THREADS, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w), off, o, K,
        N, E);
    return cudaGetLastError();
  }
  dim3 grid((n + F_BM - 1) / F_BM + E, (N + F_BN - 1) / F_BN);
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
