// Standalone activation for Hopper: y = f(x), its own launch, HBM -> HBM.
//
// Replaces the TPU kernel src/repro/kernels/activations.py:activation_2d
// (body ``_kernel``, pallas_call at :145; wrapped by ``activation``,
// :96): the FLEXIBLE_DMA "host step". Its input and output cross HBM on
// purpose: that round trip is the baseline the paper measures the
// Sidebar against, so it is never fused into the producer product.
//
// What bounds it on an H100: a few operations per element over 2 x the
// element size of bytes, far below the card's operations-per-byte line:
// memory-bound. At the serving path's shape (4 x 24576 bf16 at decode,
// 393 KB read and written, 0.12 us at 3.35 TB/s) the launch dominates:
// a plain launch took 3.2 us, almost all of it the gap after the
// kernel before it and the ramp of a grid.
//
// What the design does about it:
//   * it is launched as a programmatic dependent (common.cuh
//     ``launch_dependent``): its blocks are scheduled while the kernel
//     before it (FLEXIBLE_DMA's producer product or its split reduce)
//     still runs, and wait on the device (``griddep_wait``) before their
//     first load of x and before any store -- nothing before the wait
//     touches global memory, since x is that kernel's output and y may
//     reuse a buffer it still reads. Once its loads are issued it lets
//     the next launch (the consumer product, also a dependent) be
//     scheduled, so both edges of the chain overlap;
//   * elementwise entries (ids 0-12, and 15 in a library built for a
//     run-time ``device_expr``): a grid-stride pass in which each
//     thread loads and stores 16 bytes at a time (8 bf16 or 4 fp32),
//     computes f in fp32 and rounds once to x's type; the tail that
//     does not fill a vector, and unaligned tensors, go element by
//     element;
//   * rowwise entries (softmax 13, rmsnorm 14): one block per row, the
//     whole row read in fp32 as the TPU kernel keeps it resident
//     (activations.py:54-55); the row's max and sums are reduced in a
//     fixed order (each thread's strided elements in order, then a
//     fixed tree over the block), so a row's result is bit-identical
//     run to run. Launched the same way.

#include "activation.cuh"
#include "common.cuh"

namespace {

using repro::apply_activation;
using repro::from_f;
using repro::to_f;

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
elementwise(const T* __restrict__ x, T* __restrict__ y, size_t n, int act,
            int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t first = (size_t)blockIdx.x * THREADS + threadIdx.x;
  size_t done = 0;
  repro::griddep_wait();  // x is the kernel before's output
  if (vec_ok) {
    const size_t nv = n / VEC;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (size_t v = first; v < nv; v += stride) {
      uint4 u = __ldg(xv + v);
      repro::griddep_launch_dependents();
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        e[j] = from_f<T>(apply_activation(act, to_f(e[j])));
      yv[v] = u;
    }
    done = nv * VEC;
  }
  for (size_t i = done + first; i < n; i += stride) {
    const float v = to_f(x[i]);
    repro::griddep_launch_dependents();
    y[i] = from_f<T>(apply_activation(act, v));
  }
}

// every thread gets op over all threads' ``v``, combined in a fixed tree
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] = op(red[tid], red[tid + o]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();  // red is reused by the next reduction
  return out;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rowwise(const T* __restrict__ x, T* __restrict__ y, int N, int act) {
  __shared__ float red[THREADS];
  const T* xr = x + (size_t)blockIdx.x * N;
  T* yr = y + (size_t)blockIdx.x * N;
  const int tid = threadIdx.x;
  auto add = [](float p, float q) { return p + q; };
  repro::griddep_wait();  // x is the kernel before's output
  if (act == repro::kSoftmax) {
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = tid; j < N; j += THREADS) m = fmaxf(m, to_f(xr[j]));
    repro::griddep_launch_dependents();
    m = block_reduce(m, red, [](float p, float q) { return fmaxf(p, q); });
    float s = 0.f;
    for (int j = tid; j < N; j += THREADS) s += expf(to_f(xr[j]) - m);
    s = block_reduce(s, red, add);
    for (int j = tid; j < N; j += THREADS)
      yr[j] = from_f<T>(expf(to_f(xr[j]) - m) / s);
  } else {  // rmsnorm: x * rsqrt(mean(x^2) + eps)
    float s = 0.f;
    for (int j = tid; j < N; j += THREADS) {
      const float v = to_f(xr[j]);
      s = fmaf(v, v, s);
    }
    repro::griddep_launch_dependents();
    s = block_reduce(s, red, add);
    const float scale = rsqrtf(s / N + repro::kRmsnormEps);
    for (int j = tid; j < N; j += THREADS)
      yr[j] = from_f<T>(to_f(xr[j]) * scale);
  }
}

template <typename T>
int launch(const void* x, void* y, int M, int N, int act,
           cudaStream_t stream) {
  if (act == repro::kSoftmax || act == repro::kRmsnorm)
    return repro::launch_dependent(rowwise<T>, dim3(M), dim3(THREADS), 0,
                                   stream, static_cast<const T*>(x),
                                   static_cast<T*>(y), N, act);
  constexpr int VEC = 16 / sizeof(T);
  const size_t n = (size_t)M * N;
  const int vec_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // enough blocks for one vector per thread, at most 8 per SM
  const size_t want = (n / VEC + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : (want > 1056 ? 1056
                                                                  : want));
  return repro::launch_dependent(elementwise<T>, dim3(blocks),
                                 dim3(THREADS), 0, stream,
                                 static_cast<const T*>(x),
                                 static_cast<T*>(y), n, act, vec_ok);
}

}  // namespace

// x, y (M, N) contiguous row-major of type ``dtype``; ``act`` a device
// id of activation.cuh (rowwise ids reduce over each row of N). A
// programmatic dependent launch. Returns the cudaError_t of the launch.
extern "C" int activation_launch(const void* x, void* y, int M, int N,
                                 int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > repro::kMaxActivation) return cudaErrorInvalidValue;
  if (dtype == repro::kF32) return launch<float>(x, y, M, N, act, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, y, M, N, act, s);
  return cudaErrorInvalidValue;
}
