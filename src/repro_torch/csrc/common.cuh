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

}  // namespace repro
