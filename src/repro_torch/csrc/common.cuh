// Element conversions shared by the kernels. bf16 rounds to nearest
// even (__float2bfloat16), as the jnp ``astype`` does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the value ``v`` takes after a round trip through type T
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
// an int8 pool is dequantized to fp32 before use: no rounding point
template <>
__device__ __forceinline__ float round_to<int8_t>(float v) { return v; }

// element-type codes of the C entry points (see the Python wrappers)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// route codes of the MLP entry points (kernels/sidebar_mlp.py ``ROUTES``):
// the CUDA cores' FMA, or the tensor cores (sidebar_tc.cuh)
enum Route : int { kFma = 0, kTc = 1 };

// ---- programmatic dependent launch --------------------------------------
// A kernel launched by ``launch_dependent`` may start while the kernel
// before it on the stream still runs. It must call ``griddep_wait``
// before it reads anything an earlier launch wrote AND before it writes
// any global memory: the caching allocator hands a buffer freed by the
// host straight to the next call, so a buffer this kernel writes may be
// one the kernel before it still reads. Only work that touches no global
// memory (barrier setup, register set-up) may come first. Every thread
// waits, so a grid never completes before its predecessor has.

// block until every earlier grid on the stream has completed and its
// memory operations are visible
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// let the next launch on the stream be scheduled once every block of
// this grid has issued this (or exited); the first call in a block counts
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// launch ``kern`` as a programmatic dependent of the launch before it
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kern)(Params...), dim3 grid, dim3 block,
                             size_t smem, cudaStream_t stream,
                             Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<Params>(args)...);
}

}  // namespace repro
