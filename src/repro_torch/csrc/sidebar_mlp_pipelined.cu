// Ring-pipelined Sidebar MLP for Hopper: y = f(x @ W1) @ W2 with a
// T-deep ring of f(h) sub-tiles in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/sidebar_mlp.py:
// sidebar_mlp_pipelined (body ``_pipelined_kernel``, pallas_call at
// :273): the kernel behind ExecutionMode.SIDEBAR_PIPELINED at ring
// depth T.
//
// What bounds it on an H100: streaming the two weight matrices (604 MB
// per layer of nemotron-4-15b in bf16, at least 180 us at 3.35 TB/s);
// the row count at serving shapes (4 at decode, up to 64 in a staging
// round) is far below the operations-per-byte line: bytes.
//
// Rounding points (src/repro/kernels/ref.py:34-37): fp32 h, f in fp32,
// f(h) cast to W2's type, fp32 accumulation, output in x's type.
//
// What the design does about it: the ring of sidebar_ring.cuh. bf16
// operands that TMA can stride (D, F, D2 multiples of 8, 16-byte aligned)
// take the tensor-core body (sidebar_tc.cuh: a thread-block-cluster ring,
// TMA weight rings fed by loader warps, swapped wgmma, f(h) shared across
// the cluster through distributed shared memory, y in the consumers'
// registers); fp32 operands and bf16 ones of any other width or
// alignment take its FMA body. Both are bitwise equal across depths, and
// the serial kernel (sidebar_mlp.cu) is the same ring with one slot.

#include "sidebar_ring.cuh"

// Dynamic shared memory (bytes) one block requests at ring depth
// ``depth`` for M token rows on ``route`` (the bf16 ring holds at most
// ``Layout::MAX_SLOTS`` slots, whatever the depth).
extern "C" int sidebar_mlp_pipelined_smem(int M, int depth, int dtype,
                                          int route) {
  return repro::mlp_ring_smem(M, depth, dtype, route);
}

// x (M, D), w1 (D, F), w2 (F, D2), y (M, D2), all contiguous row-major
// of type ``dtype``; ``frange`` a multiple of a sub-tile (tc: C x 64
// columns; fma: 64); ws holds ceil(F / frange) * M * D2 fp32; ``route``
// a ``repro::Route``. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for what a route does not take).
extern "C" int sidebar_mlp_pipelined_launch(const void* x, const void* w1,
                                            const void* w2, void* y,
                                            void* ws, int M, int D, int F,
                                            int D2, int frange, int depth,
                                            int act, int dtype, int route,
                                            void* stream) {
  return repro::mlp_ring_launch(x, w1, w2, y, ws, M, D, F, D2, frange,
                                depth, act, dtype, route,
                                static_cast<cudaStream_t>(stream));
}
