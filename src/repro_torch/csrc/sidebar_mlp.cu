// Fused Sidebar MLP for Hopper, the serial kernel: y = f(x @ W1) @ W2.
//
// Replaces the TPU kernel src/repro/kernels/sidebar_mlp.py:sidebar_mlp
// (body ``_kernel``, pallas_call at :209): the MLP of
// ExecutionMode.SIDEBAR, the serving path's default plan, and of the
// training forward.
//
// What bounds it on an H100 (nemotron-4-15b, 6144 x 24576, bf16):
//   * at decode (4 rows) and in staging rounds (16 and 64 rows) the two
//     products do 2 * 2 * M * D * F operations over 604 MB of weights a
//     layer: bytes, at least 180 us at 3.35 TB/s;
//   * at 4096 rows (the training forward) the 2.47 TFLOP take at least
//     2.50 ms at 989 TFLOP/s: operations.
//
// What the design does about it: it is the ring of
// sidebar_mlp_pipelined.cu with ONE f(h) slot (sidebar_ring.cuh; the
// tensor-core body is sidebar_tc.cuh): TMA keeps the weight tiles in
// flight on every SM, wgmma takes the products with the weight as the
// 64-row operand, f(h) is shared across a cluster of blocks through
// distributed shared memory, and y stays in the consumers' registers.
// With one slot the producer computes a sub-tile only after every
// consumer of the cluster has drained the one before: the TPU kernel's
// order and the paper's serial mode. The wrapper hands it the ring's
// partition, so for the same (M, F) its output equals the ring's at every
// depth, bit for bit.
//
// At 4096 rows the instance runs 128 panels of 32 rows on clusters of 8,
// and each panel streams all the weights: the consumers' registers cap a
// panel at 32 rows (32 x D2 / 8 fp32 accumulators a block), so that size
// is bound by L2, not by the tensor cores (ROADMAP Queue 2 holds the
// design for large M). fp32 operands, and bf16 ones whose widths or
// alignment TMA cannot take, run the ring's FMA route with one slot.

#include "sidebar_ring.cuh"

// x (M, D), w1 (D, F), w2 (F, D2), y (M, D2), all contiguous row-major
// of type ``dtype``; ``frange`` and ws as ``mlp_ring_launch``; ``route``
// a ``repro::Route``. Returns the cudaError_t of the launches.
extern "C" int sidebar_mlp_launch(const void* x, const void* w1,
                                  const void* w2, void* y, void* ws, int M,
                                  int D, int F, int D2, int frange, int act,
                                  int dtype, int route, void* stream) {
  return repro::mlp_ring_launch(x, w1, w2, y, ws, M, D, F, D2, frange, 1,
                                act, dtype, route,
                                static_cast<cudaStream_t>(stream));
}
