// Paged GQA decode attention for Hopper, in place on the KV block pool:
// split-KV (flash-decoding) with a fixed-order merge.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py:paged_gqa_kernel (body
// ``_gqa_kernel``, pallas_call at :265), int8 dequantization included.
//
// What bounds it on an H100: one query token per row, so each call
// reads every live K/V position once and does 4*G*Dh operations per
// position -- far below the card's operations-per-byte line: it is
// memory-bound, and at the serving path's sizes (4 rows x up to 256
// positions x 8 KV heads x 128, bf16: about 3.4 MB per layer, ~1 us at
// 3.35 TB/s) latency and the launches themselves are the floor. A grid
// of one block per (row, KV head) -- the TPU kernel's grid without its
// sequential block axis -- puts 32 blocks on 132 SMs at nemotron's
// decode shape, each walking its row's blocks one after another.
//
// What the design does about it:
//   * grid (split, row x KV-head tile, ...): a split covers a fixed
//     CHUNK of positions, a multiple of the block size
//     (kernels/paged_attention.py ``split_chunk``), with boundaries at
//     multiples of CHUNK, so a row's splits depend on its own length
//     only -- not on the batch, the table width nb or its batch mates.
//     A split that starts at or past the row's length exits at once and
//     writes nothing: the merge reads only the row's live splits;
//   * inside a block (four warps) the split's positions are dealt to
//     lane groups of ``lp`` lanes; a group reads one pool row (a
//     position's Dh values) as one 16-byte load a lane (8 bf16 or 4
//     fp32; 8 bytes of int8) and every group has UNROLL positions in
//     flight (a whole split of 64 positions at once for bf16 and int8
//     pools; the first batch's V rows load beside its K rows). All
//     heads of a tile of the group (GT = 1, 2, 4, 6 or 8 query heads
//     sharing the KV head; a group of 3 runs as a tile of 4 with a
//     masked head, one above 8 in tiles) stay in registers; dot
//     products reduce across the group by warp shuffles. The CUDA cores
//     suffice: at 4*G*Dh operations a position the kernel is bound by
//     memory and latency.
//     Head dims that are not a multiple of the vector (or pools not
//     aligned to it) take a scalar instance of the same kernel (one
//     element a lane, up to 8 a lane: Dh <= 256);
//   * a split computes its logits (K pass), its own max m_s, p =
//     e^(s - m_s), l_s = sum of the unrounded p, and acc_s = sum of p
//     rounded to the value type times V (V pass), all in fp32, and
//     writes (m_s, l_s, acc_s) to an fp32 workspace the wrapper
//     allocates. A second launch over (head, row), a programmatic
//     dependent of the first (scheduled early, it waits on the device
//     for the splits to finish), merges in split index order: m = max m_s, l = sum l_s e^(m_s - m), acc = sum acc_s
//     e^(m_s - m), out = acc / (l or 1). No atomics: the bits are the
//     same run to run, and a row's output is a function of its own q,
//     blocks and length.
//
// Numerics (the Pallas body's, but one): logits at kpos >= length are
// -1e30 (here: never computed; they underflow to exactly 0 there), the
// probabilities are rounded to the value type before the P.V product
// (a bf16 pool rounds them to bf16; int8 and fp32 pools keep fp32), the
// sums use the unrounded probabilities, int8 blocks are dequantized
// with their fp32 per-(position, head) scales, a row with l == 0
// divides by 1, and the output is written in q's type. The one
// difference: p is rounded against its SPLIT's max, where the Pallas
// body rounds against the running max over the row's blocks so far.
// fp32 and int8 pools round nothing, so they stay within 1e-4 of the
// plain version; a bf16 pool stays within the bf16 tolerance (2e-2).
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
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;        // four warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DH = 256;

// raw load of B bytes
template <int B> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<1> { using type = unsigned char; };

// A lane's share of a pool row: NV loads of V elements (the vector
// instance: one 16-byte load, 8 bytes for int8; the scalar one: up to
// eight single elements), and the positions a lane group has in flight
// (UNROLL: a whole split of 64 positions in one batch on the vector
// instance of bf16 and int8 pools)
template <typename T, bool VEC>
struct Lanes {
  static constexpr int V = VEC ? (sizeof(T) == 4 ? 4 : 8) : 1;
  static constexpr int NV = VEC ? 1 : MAX_DH / 32;
  static constexpr int UNROLL = VEC ? 8 : 2;
  using R = typename Raw<V * sizeof(T)>::type;
};

template <typename T, int V, typename R>
__device__ __forceinline__ void unpack(float* out, const R& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
}

__device__ __forceinline__ float load_q(const void* q, int qtype, size_t i) {
  return qtype == repro::kF32
             ? static_cast<const float*>(q)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
}

// One split of one (row, KV head, tile of GT query heads): its partial
// (m, l, acc) into the workspace. Grid (split, KV head x head tile, row).
template <typename TKV, bool QUANT, int GT, bool VEC>
__global__ void __launch_bounds__(THREADS)
gqa_split(const void* __restrict__ q, int qtype, const TKV* __restrict__ kp,
          const TKV* __restrict__ vp, const float* __restrict__ ks,
          const float* __restrict__ vs, const int* __restrict__ tables,
          const int* __restrict__ lengths, float* __restrict__ ws_acc,
          float* __restrict__ ws_ml, int H, int Hkv, int bs, int Dh, int nb,
          int chunk, int S, int lp, float scale) {
  using Ln = Lanes<TKV, VEC>;
  using R = typename Ln::R;
  constexpr int V = Ln::V, NV = Ln::NV, DPL = V * NV, UNROLL = Ln::UNROLL;
  extern __shared__ float sm[];

  const int G = H / Hkv;
  const int tiles = (G + GT - 1) / GT;
  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / tiles, g0 = (blockIdx.y % tiles) * GT;
  const int ng = min(GT, G - g0);  // live heads of this tile
  const int p0 = split * chunk;
  // the merge launch may start now: it waits for this grid to finish
  // (griddepcontrol.wait) before it reads the workspace
  repro::griddep_launch_dependents();

  float* s_p = sm;                    // (GT, chunk) logits, then p
  float* s_m = s_p + GT * chunk;      // (GT,) the split's max
  float* s_l = s_m + GT;              // (GT,) the split's sum
  float* s_red = s_l + GT;            // (WARPS, GT, Dh) warps' acc

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gpw = 32 / lp;            // lane groups per warp
  const int ngroups = WARPS * gpw;
  const int grp = warp * gpw + lane / lp, li = lane % lp;
  const size_t h0 = (size_t)b * H + (size_t)hk * G + g0;

  // the query values and the first batch's table entries do not depend
  // on the row's length: their loads overlap its load
  // this lane's dims of each query head of the tile, fp32
  float qr[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = (li + v * lp) * V + e;
        qr[g][v * V + e] =
            (g < ng && d < Dh) ? load_q(q, qtype, (h0 + g) * Dh + d) : 0.f;
      }
  int blk0[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = u * ngroups + grp, pos = p0 + i;
    blk0[u] = i < chunk && pos < nb * bs ? tables[(size_t)b * nb + pos / bs]
                                         : 0;
  }
  // positions past the table are not the row's (the plain version's
  // dense view ends at nb * bs)
  const int length = min(lengths[b], nb * bs);
  if (p0 >= length) return;
  const int n = min(chunk, length - p0);

  // ---- K pass: the split's logits ------------------------------------
  // The first batch's V rows are loaded beside its K rows, so their
  // latency hides behind the K pass and the softmax.
  R vfirst[UNROLL][NV];
  float vsfirst[UNROLL];
  for (int base = 0; base < n; base += ngroups * UNROLL) {
    R raw[UNROLL][NV];
    float sc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * ngroups + grp;
      if (i < n) {
        const int pos = p0 + i;
        const int blk =
            base == 0 ? blk0[u] : tables[(size_t)b * nb + pos / bs];
        const size_t row = ((size_t)blk * Hkv + hk) * bs + pos % bs;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int d0 = (li + v * lp) * V;
          if (d0 < Dh) {
            raw[u][v] = __ldg(reinterpret_cast<const R*>(kp + row * Dh + d0));
            if (base == 0)
              vfirst[u][v] =
                  __ldg(reinterpret_cast<const R*>(vp + row * Dh + d0));
          }
        }
        if (QUANT) {
          sc[u] = ks[row];
          if (base == 0) vsfirst[u] = vs[row];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * ngroups + grp;
      float kf[DPL];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (i < n && (li + v * lp) * V < Dh) {
          unpack<TKV, V>(kf + v * V, raw[u][v]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) kf[v * V + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) dot = fmaf(qr[g][j], kf[j], dot);
        // across the group's lanes; unrolled (the shuffle past the group
        // is discarded) so the chains of every head and position overlap
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float t = __shfl_xor_sync(FULL, dot, off);
          if (off < lp) dot += t;
        }
        if (li == 0 && i < n)
          s_p[g * chunk + i] = (QUANT ? dot * sc[u] : dot) * scale;
      }
    }
  }
  __syncthreads();

  // ---- the split's max and sum; p rounded to the value type ----------
  for (int g = warp; g < GT; g += WARPS) {
    float m = NEG_INF;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, s_p[g * chunk + i]);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(s_p[g * chunk + i] - m);
      l += e;
      s_p[g * chunk + i] = round_to<TKV>(e);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) l += __shfl_xor_sync(FULL, l, off);
    if (lane == 0) {
      s_m[g] = m;
      s_l[g] = l;
    }
  }
  __syncthreads();

  // ---- V pass: acc = p . V --------------------------------------------
  float acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  for (int base = 0; base < n; base += ngroups * UNROLL) {
    R raw[UNROLL][NV];
    float sc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * ngroups + grp;
      if (base == 0) {
#pragma unroll
        for (int v = 0; v < NV; ++v) raw[u][v] = vfirst[u][v];
        if (QUANT) sc[u] = vsfirst[u];
      } else if (i < n) {
        const int pos = p0 + i;
        const size_t row =
            ((size_t)tables[(size_t)b * nb + pos / bs] * Hkv + hk) * bs +
            pos % bs;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int d0 = (li + v * lp) * V;
          if (d0 < Dh)
            raw[u][v] = __ldg(reinterpret_cast<const R*>(vp + row * Dh + d0));
        }
        if (QUANT) sc[u] = vs[row];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * ngroups + grp;
      if (i >= n) continue;
      float vf[DPL];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if ((li + v * lp) * V < Dh) {
          unpack<TKV, V>(vf + v * V, raw[u][v]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) vf[v * V + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float p = s_p[g * chunk + i];
        if (QUANT) p *= sc[u];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
      }
    }
  }
  // the lane groups of a warp, then the warps in order
  for (int off = lp; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        acc[g][j] += __shfl_xor_sync(FULL, acc[g][j], off);
  if (lane < lp) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int d = (li + v * lp) * V + e;
          if (d < Dh) s_red[(warp * GT + g) * Dh + d] = acc[g][v * V + e];
        }
  }
  __syncthreads();
  for (int t = tid; t < ng * Dh; t += THREADS) {
    const int g = t / Dh, d = t % Dh;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += s_red[(w * GT + g) * Dh + d];
    ws_acc[((h0 + g) * S + split) * Dh + d] = sum;
  }
  if (tid < ng) {
    ws_ml[((h0 + tid) * S + split) * 2] = s_m[tid];
    ws_ml[((h0 + tid) * S + split) * 2 + 1] = s_l[tid];
  }
}

// The fixed-order merge of a row's live splits: one block per (head,
// row), a thread per head dim.
template <typename TQ>
__global__ void gqa_merge(const float* __restrict__ ws_acc,
                          const float* __restrict__ ws_ml,
                          const int* __restrict__ lengths,
                          TQ* __restrict__ out, int H, int bs, int Dh, int nb,
                          int chunk, int S) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int length = min(lengths[b], nb * bs);
  const int live = length > 0 ? (length + chunk - 1) / chunk : 0;
  // launched as the split grid's programmatic dependent: every write of
  // that grid is complete and visible after this wait
  repro::griddep_wait();
  const size_t row = (size_t)b * H + h;
  const float* ml = ws_ml + row * S * 2;
  float m = NEG_INF;
  for (int s = 0; s < live; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < live; ++s) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  l = (l == 0.f) ? 1.f : l;
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < live; ++s)
      acc += ws_acc[(row * S + s) * Dh + d] * expf(ml[2 * s] - m);
    out[row * Dh + d] = from_f<TQ>(acc / l);
  }
}

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename TKV, bool QUANT, int GT, bool VEC>
int launch_split(const void* q, int qtype, const void* k, const void* v,
                 const void* ks, const void* vs, const void* tables,
                 const void* lengths, float* ws_acc, float* ws_ml, int B,
                 int H, int Hkv, int bs, int Dh, int nb, int chunk, int S,
                 float scale, cudaStream_t stream) {
  using Ln = Lanes<TKV, VEC>;
  // lanes of a group: the vector loads of a row, a power of two
  const int lp = VEC ? pow2_at_least(Dh / Ln::V) : min(32, pow2_at_least(Dh));
  if (lp > 32 || (Dh + lp * Ln::V - 1) / (lp * Ln::V) > Ln::NV)
    return cudaErrorInvalidValue;
  const int tiles = (H / Hkv + GT - 1) / GT;
  const size_t smem =
      sizeof(float) * ((size_t)GT * chunk + 2 * GT + (size_t)WARPS * GT * Dh);
  auto kern = gqa_split<TKV, QUANT, GT, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(S, Hkv * tiles, B), THREADS, smem, stream>>>(
      q, qtype, static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      ws_acc, ws_ml, H, Hkv, bs, Dh, nb, chunk, S, lp, scale);
  return cudaGetLastError();
}

// the split kernel's instance: the head tile GT from the group (8 for
// every group above 6, in tiles), the vector loads where the head dim
// and the pools' alignment take them, else the scalar instance
template <typename TKV, bool QUANT>
int dispatch_split(const void* q, int qtype, const void* k, const void* v,
                   const void* ks, const void* vs, const void* tables,
                   const void* lengths, float* ws_acc, float* ws_ml, int B,
                   int H, int Hkv, int bs, int Dh, int nb, int chunk, int S,
                   float scale, cudaStream_t s) {
  using Vec = Lanes<TKV, true>;
  constexpr int VB = Vec::V * sizeof(TKV);
  const bool vec = Dh % Vec::V == 0 && Dh <= 32 * Vec::V &&
                   reinterpret_cast<uintptr_t>(k) % VB == 0 &&
                   reinterpret_cast<uintptr_t>(v) % VB == 0;
  const int G = H / Hkv;
#define REPRO_GQA_SPLIT(GT, VEC)                                            \
  launch_split<TKV, QUANT, GT, VEC>(q, qtype, k, v, ks, vs, tables, lengths, \
                                    ws_acc, ws_ml, B, H, Hkv, bs, Dh, nb,    \
                                    chunk, S, scale, s)
  if (!vec) return REPRO_GQA_SPLIT(8, false);
  if (G == 1) return REPRO_GQA_SPLIT(1, true);
  if (G == 2) return REPRO_GQA_SPLIT(2, true);
  if (G <= 4) return REPRO_GQA_SPLIT(4, true);
  if (G <= 6) return REPRO_GQA_SPLIT(6, true);
  return REPRO_GQA_SPLIT(8, true);
#undef REPRO_GQA_SPLIT
}

}  // namespace

// q (B, H, Dh) and out (B, H, Dh) of type ``qtype``; k/v pools
// (P, Hkv, bs, Dh) of type ``kvtype``; ks/vs (P, Hkv, bs) fp32 for an
// int8 pool (else unused); tables (B, nb) int32; lengths (B,) int32.
// Splits of ``chunk`` positions (a multiple of bs), S = ceil(nb * bs /
// chunk) of them a row at most; ws_acc holds B * H * S * Dh fp32 and
// ws_ml B * H * S * 2. Two launches (the splits, the merge). Returns the
// cudaError_t of the launches.
extern "C" int paged_gqa_launch(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* tables, const void* lengths,
                                void* out, void* ws_acc, void* ws_ml, int B,
                                int H, int Hkv, int bs, int Dh, int nb,
                                int chunk, float scale, int qtype,
                                int kvtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || H % Hkv || bs < 1 || nb < 1 || Dh < 1 ||
      Dh > MAX_DH || chunk < bs || chunk % bs ||
      (qtype != repro::kF32 && qtype != repro::kBF16))
    return cudaErrorInvalidValue;
  const int S = (nb * bs + chunk - 1) / chunk;
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  int err;
  switch (kvtype) {
    case repro::kF32:
      err = dispatch_split<float, false>(q, qtype, k, v, ks, vs, tables,
                                         lengths, wa, wm, B, H, Hkv, bs, Dh,
                                         nb, chunk, S, scale, s);
      break;
    case repro::kBF16:
      err = dispatch_split<__nv_bfloat16, false>(q, qtype, k, v, ks, vs,
                                                 tables, lengths, wa, wm, B,
                                                 H, Hkv, bs, Dh, nb, chunk, S,
                                                 scale, s);
      break;
    case repro::kI8:
      err = dispatch_split<int8_t, true>(q, qtype, k, v, ks, vs, tables,
                                         lengths, wa, wm, B, H, Hkv, bs, Dh,
                                         nb, chunk, S, scale, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  // the merge as a programmatic dependent launch: it is scheduled while
  // the splits run and waits for them on the device, so the gap between
  // the two launches is hidden
  const dim3 grid(H, B), block(min(MAX_DH, (Dh + 31) / 32 * 32));
  const int* ln = static_cast<const int*>(lengths);
  if (qtype == repro::kF32)
    return repro::launch_dependent(gqa_merge<float>, grid, block, 0, s,
                                   (const float*)wa, (const float*)wm, ln,
                                   static_cast<float*>(out), H, bs, Dh, nb,
                                   chunk, S);
  return repro::launch_dependent(gqa_merge<__nv_bfloat16>, grid, block, 0, s,
                                 (const float*)wa, (const float*)wm, ln,
                                 static_cast<__nv_bfloat16*>(out), H, bs, Dh,
                                 nb, chunk, S);
}
