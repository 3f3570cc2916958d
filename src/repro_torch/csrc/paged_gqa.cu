// Paged GQA decode attention for Hopper, in place on the KV block pool.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py:paged_gqa_kernel (body
// ``_gqa_kernel``, pallas_call at :265), int8 dequantization included.
//
// What bounds it on an H100: one query token per row, so each call
// reads every live K/V position once and does 4*G*Dh operations per
// position -- far below the card's operations-per-byte line: it is
// memory-bound, and at the serving path's sizes (4 rows x 256
// positions x 8 KV heads x 128, bf16: about 4 MB per layer, ~1.3 us at
// 3.35 TB/s) the launch itself dominates.
//
// What the design does about it: one block per (row, KV head) serves
// all G query heads of the group, so every K/V block is read from HBM
// exactly once per call (GQA without duplication). The TPU kernel gets
// the table row and length by scalar prefetch; here each block loads
// its own ``tables[b, :]`` entries and ``lengths[b]`` from global
// memory and walks the row's blocks in order, only up to
// ceil(length / bs) -- blocks past the frontier are never read. Each
// pooled block (bs x Dh) is staged in shared memory, dequantized there
// for an int8 pool with its fp32 per-(position, head) scales, and the
// online softmax (running max, running sum, rescaled accumulator) runs
// in fp32 in shared memory, as the Pallas body does in VMEM scratch.
//
// Numerics match the Pallas body: logits at kpos >= length are -1e30,
// the probabilities are rounded to the value type before the P.V
// product (a bf16 pool rounds them to bf16; int8/fp32 pools keep
// fp32), the running sum uses the unrounded probabilities, a row with
// l == 0 divides by 1, and the output is written in q's type.
//
// Tables are NOT bounds-checked here (no more than the Pallas DMA
// was): the scheduler validates every table host-side before the
// launch (launch/kvpool.py:validate_tables).

#include "common.cuh"

namespace {

using repro::from_f;
using repro::round_to;
using repro::to_f;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_gqa(const TQ* __restrict__ q, const TKV* __restrict__ kp,
          const TKV* __restrict__ vp, const float* __restrict__ ks,
          const float* __restrict__ vs, const int* __restrict__ tables,
          const int* __restrict__ lengths, TQ* __restrict__ out, int H,
          int Hkv, int bs, int Dh, int nb, float scale) {
  extern __shared__ float sm[];
  const int G = H / Hkv;
  float* sq = sm;                 // (G, Dh) queries, fp32
  float* sacc = sq + G * Dh;      // (G, Dh) accumulator
  float* sk = sacc + G * Dh;      // (bs, Dh) this block's keys
  float* sv = sk + bs * Dh;       // (bs, Dh) this block's values
  float* ss = sv + bs * Dh;       // (G, bs) logits, then probabilities
  float* s_m = ss + G * bs;       // (G,) running max
  float* s_l = s_m + G;           // (G,) running sum
  float* s_alpha = s_l + G;       // (G,) rescale of this block

  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x;
  const int length = lengths[b];
  const size_t qoff = ((size_t)b * H + (size_t)hk * G) * Dh;

  for (int i = tid; i < G * Dh; i += THREADS) {
    sq[i] = to_f(q[qoff + i]);
    sacc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    s_m[g] = NEG_INF;
    s_l[g] = 0.f;
  }
  __syncthreads();

  const int nblk = length > 0 ? min(nb, (length + bs - 1) / bs) : 0;
  for (int j = 0; j < nblk; ++j) {
    const size_t blk = (size_t)tables[(size_t)b * nb + j] * Hkv + hk;
    const size_t base = blk * bs * Dh;
    for (int i = tid; i < bs * Dh; i += THREADS) {
      float kv = to_f(kp[base + i]), vv = to_f(vp[base + i]);
      if (QUANT) {
        const size_t sidx = blk * bs + i / Dh;
        kv *= ks[sidx];
        vv *= vs[sidx];
      }
      sk[i] = kv;
      sv[i] = vv;
    }
    __syncthreads();
    for (int i = tid; i < G * bs; i += THREADS) {
      const int g = i / bs, p = i % bs;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(sq[g * Dh + d], sk[p * Dh + d], s);
      ss[i] = (j * bs + p < length) ? s * scale : NEG_INF;
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
      const float m_prev = s_m[g];
      float m_cur = m_prev;
      for (int p = 0; p < bs; ++p) m_cur = fmaxf(m_cur, ss[g * bs + p]);
      const float alpha = expf(m_prev - m_cur);
      float l = 0.f;
      for (int p = 0; p < bs; ++p) {
        const float e = expf(ss[g * bs + p] - m_cur);
        l += e;
        ss[g * bs + p] = round_to<TKV>(e);
      }
      s_l[g] = alpha * s_l[g] + l;
      s_m[g] = m_cur;
      s_alpha[g] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < G * Dh; i += THREADS) {
      const int g = i / Dh, d = i % Dh;
      float pv = 0.f;
      for (int p = 0; p < bs; ++p) pv = fmaf(ss[g * bs + p], sv[p * Dh + d], pv);
      sacc[i] = sacc[i] * s_alpha[g] + pv;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * Dh; i += THREADS) {
    float l = s_l[i / Dh];
    l = (l == 0.f) ? 1.f : l;
    out[qoff + i] = from_f<TQ>(sacc[i] / l);
  }
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* tables, const void* lengths,
           void* out, int B, int H, int Hkv, int bs, int Dh, int nb,
           float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) *
                      ((size_t)2 * G * Dh + (size_t)2 * bs * Dh +
                       (size_t)G * bs + 3 * (size_t)G);
  auto kern = paged_gqa<TQ, TKV, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(B, Hkv), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), H, Hkv, bs, Dh,
      nb, scale);
  return cudaGetLastError();
}

template <typename TQ>
int dispatch_kv(int kvtype, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* tables,
                const void* lengths, void* out, int B, int H, int Hkv, int bs,
                int Dh, int nb, float scale, cudaStream_t s) {
  switch (kvtype) {
    case repro::kF32:
      return launch<TQ, float, false>(q, k, v, ks, vs, tables, lengths, out,
                                      B, H, Hkv, bs, Dh, nb, scale, s);
    case repro::kBF16:
      return launch<TQ, __nv_bfloat16, false>(q, k, v, ks, vs, tables,
                                              lengths, out, B, H, Hkv, bs,
                                              Dh, nb, scale, s);
    case repro::kI8:
      return launch<TQ, int8_t, true>(q, k, v, ks, vs, tables, lengths, out,
                                      B, H, Hkv, bs, Dh, nb, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Dh) and out (B, H, Dh) of type ``qtype``; k/v pools
// (P, Hkv, bs, Dh) of type ``kvtype``; ks/vs (P, Hkv, bs) fp32 for an
// int8 pool (else unused); tables (B, nb) int32; lengths (B,) int32.
// Returns the cudaError_t of the launch.
extern "C" int paged_gqa_launch(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* tables, const void* lengths,
                                void* out, int B, int H, int Hkv, int bs,
                                int Dh, int nb, float scale, int qtype,
                                int kvtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtype == repro::kF32)
    return dispatch_kv<float>(kvtype, q, k, v, ks, vs, tables, lengths, out,
                              B, H, Hkv, bs, Dh, nb, scale, s);
  if (qtype == repro::kBF16)
    return dispatch_kv<__nv_bfloat16>(kvtype, q, k, v, ks, vs, tables,
                                      lengths, out, B, H, Hkv, bs, Dh, nb,
                                      scale, s);
  return cudaErrorInvalidValue;
}
