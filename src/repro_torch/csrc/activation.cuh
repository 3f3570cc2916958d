// The function table's kernel-side entries, shared by every kernel.
//
// Ids are the ``device_id``s of src/repro_torch/core/function_table.py
// (_DEFAULTS): keep the two in step. Ids 0-12 are elementwise and are
// applied by ``apply_activation`` to one fp32 value; every kernel takes
// them. Ids 13 (softmax) and 14 (rmsnorm) are rowwise: they need a whole
// row, so only the standalone activation kernel (activation.cu) takes
// them, and the fused kernels' wrappers reject rowwise entries.
//
// Id 15 (kUser) is reserved for a function registered at run time with a
// ``device_expr``. kernels/build.py compiles these sources once more for
// such an entry, with -DREPRO_USER_ACTIVATION and a generated header
// (-include) that defines ``repro_user_activation(float x)`` from the
// expression; only in that library does id 15 reach it. A new activation
// is thus a table row, never an edit here.
#pragma once

#include <cuda_runtime.h>

namespace repro {

enum ActivationId : int { kSoftmax = 13, kRmsnorm = 14, kUser = 15 };

// the largest id this library takes
#ifdef REPRO_USER_ACTIVATION
constexpr int kMaxActivation = kUser;
#else
constexpr int kMaxActivation = kRmsnorm;
#endif

// rmsnorm's epsilon (function_table._rmsnorm)
constexpr float kRmsnormEps = 1e-6f;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float apply_activation(int id, float x) {
  switch (id) {
    case 0: return x;                                  // identity
    case 1: return x > 0.f ? 1.f : 0.f;                // heaviside
    case 2: return fmaxf(x, 0.f);                      // relu
    case 3: return x > 0.f ? x : 0.01f * x;            // leaky_relu
    case 4: return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;  // elu
    case 5: return tanhf(x);                           // tanh
    case 6: return sigmoid_f(x);                       // sigmoid
    case 7: return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // softplus
    case 8: { float r = fmaxf(x, 0.f); return r * r; }       // squared_relu
    case 9: return x * sigmoid_f(x);                   // silu
    case 10: {                                         // gelu (tanh)
      const float c = 0.7978845608028654f;
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case 11: return fabsf(x);                          // abs
    case 12: return expf(-expf(x));                    // exp_decay
#ifdef REPRO_USER_ACTIVATION
    case kUser: return repro_user_activation(x);       // device_expr
#endif
    default: return x;
  }
}

}  // namespace repro
