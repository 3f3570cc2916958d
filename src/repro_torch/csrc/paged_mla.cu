// Paged MLA absorbed decode for Hopper, in place on the compressed
// (latent + shared rope key) block pool.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py:paged_mla_kernel (body
// ``_mla_kernel``, pallas_call at :361). Its semantics, not its block
// structure: per row b the kernel walks ``tables[b, :]`` and skips
// blocks at or past ``lengths[b]``; logits are (q_lat . c_kv + q_rope .
// k_rope) * scale in fp32 with kpos >= length masked to -1e30; an online
// softmax (running max, running sum, rescaled accumulator) runs across
// the row's blocks; the latent block is used in fp32 for both products
// (the Pallas body's ``ckv.astype(float32)``), q_rope is cast to fp32;
// probabilities stay fp32 (unlike the GQA kernel, nothing is rounded to
// the pool type); a row with l == 0 divides by 1; ctx_lat is written in
// fp32. The w_uk / w_uv absorption stays in the model.
//
// What bounds it on an H100: q_lat is fp32 (B, H, 512), so at deepseek-
// v3's decode shapes (4 rows, 128 heads, lengths 256/241/200/129, block
// 16, bf16 pool) the work is 2 * 826 * 128 * (576 + 512) ~ 0.23 GFLOP of
// fp32 FMA (~3.4 us at 67 TFLOP/s outside the tensor cores) against
// ~3.1 MB of bytes (q_lat and ctx_lat 1 MB each, the live latent rows
// ~1 MB; ~0.9 us at 3.35 TB/s): bound by operations.
//
// What the design does about it: one block per (row, group of HG = 4
// heads), one warp per head -- 4 rows x 32 groups = 128 blocks for 132
// SMs at the serving shapes. Each pooled block (bs x kvr latent + bs x
// rope key) is read from global memory once per block as 16-byte
// vectors, converted to fp32 into shared memory, and shared by the
// group's heads; the next pooled block's loads are already in flight in
// registers while the current one is scored, and the row's block ids
// are read into shared memory once. A warp keeps its head's query
// (latent | rope, five float4 a lane), the (kvr) fp32 accumulator (four
// float4 a lane) and the softmax state in registers: lanes split the
// contraction dimension four elements at a time, so every shared-memory
// read of a warp is 512 consecutive bytes (no bank conflicts), the
// logits of 16 positions are 16 independent FMA chains, and one
// butterfly reduction gives every lane every logit -- the online
// softmax then needs no shared memory and no barrier. Plain fp32 FMA,
// no tensor cores; splitting the KV walk across blocks (flash-decoding)
// is later work.
//
// Limits (checked by the wrapper, paged_attention.py): kvr <= 512,
// kvr + rope <= 640, kvr and rope multiples of one 16-byte vector, pools
// 16-byte aligned; any block size.
//
// Duplicate table entries (prefix-shared blocks) are only read. Tables
// are NOT bounds-checked here (no more than the Pallas DMA was): the
// scheduler validates every table host-side before the launch
// (launch/kvpool.py:validate_tables).

#include "common.cuh"

namespace {

using repro::to_f;

constexpr float NEG_INF = -1e30f;
constexpr int HG = 4;              // heads per block, one warp each
constexpr int THREADS = 32 * HG;
constexpr int QC = 5;              // query float4s a lane: kvr + rope <= 640
constexpr int AC = 4;              // accumulator float4s a lane: kvr <= 512
constexpr int PG = 16;             // positions scored together
constexpr int RV = 9;              // 16-byte vectors a thread per round:
                                   // a bf16 16 x (512 + 64) block in one

// one 16-byte vector of the pool, as fp32, into 16-byte aligned shared
// memory
__device__ __forceinline__ void unpack(const uint4& u, float* o,
                                       const float*) {
  *reinterpret_cast<float4*>(o) =
      make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                  __uint_as_float(u.z), __uint_as_float(u.w));
}
__device__ __forceinline__ void unpack(const uint4& u, float* o,
                                       const __nv_bfloat16*) {
  // a bf16 is the high half of the fp32 of the same value; the element
  // at the lower address is the low half of each 32-bit word
  float4* o4 = reinterpret_cast<float4*>(o);
  o4[0] = make_float4(__uint_as_float(u.x << 16),
                      __uint_as_float(u.x & 0xffff0000u),
                      __uint_as_float(u.y << 16),
                      __uint_as_float(u.y & 0xffff0000u));
  o4[1] = make_float4(__uint_as_float(u.z << 16),
                      __uint_as_float(u.z & 0xffff0000u),
                      __uint_as_float(u.w << 16),
                      __uint_as_float(u.w & 0xffff0000u));
}

// A pooled block's latent rows then rope rows, as one space of 16-byte
// vectors (no vector straddles a row: kvr and rope are whole vectors),
// staged into shared memory rows of stride S = kvr + rope.
template <typename T>
struct Stage {
  static constexpr int V = 16 / sizeof(T);     // elements per vector
  int n_lat, n, kvr, rope, S;

  // vectors [base, base + RV * THREADS) of the block into registers
  __device__ __forceinline__ void fetch(uint4* raw, const uint4* lat,
                                        const uint4* rp, int base) const {
#pragma unroll
    for (int r = 0; r < RV; ++r) {
      const int i = min(base + r * THREADS + (int)threadIdx.x, n - 1);
      raw[r] = i < n_lat ? __ldg(lat + i) : __ldg(rp + (i - n_lat));
    }
  }

  __device__ __forceinline__ void stash(const uint4* raw, int base,
                                        float* sk) const {
#pragma unroll
    for (int r = 0; r < RV; ++r) {
      const int i = base + r * THREADS + (int)threadIdx.x;
      if (i < n) {
        int p, d;
        if (i < n_lat) {
          const int el = i * V;
          p = el / kvr;
          d = el - p * kvr;
        } else {
          const int el = (i - n_lat) * V;
          p = el / rope;
          d = kvr + el - p * rope;
        }
        unpack(raw[r], sk + p * S + d, static_cast<const T*>(nullptr));
      }
    }
  }
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_mla(const float* __restrict__ q_lat, const TQ* __restrict__ q_rope,
          const TKV* __restrict__ ckv, const TKV* __restrict__ krope,
          const int* __restrict__ tables, const int* __restrict__ lengths,
          float* __restrict__ out, int H, int kvr, int rope, int bs, int nb,
          float scale) {
  // (bs, W) c_kv | k_rope of the pooled block, then the row's block ids
  extern __shared__ __align__(16) float sk[];
  const int W = kvr + rope;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x, h = blockIdx.y * HG + (threadIdx.x >> 5);
  const bool head = h < H;
  const size_t row = (size_t)b * H + (head ? h : 0);
  const int length = lengths[b];

  // this lane's slice of the query: q[c] holds elements 4 lane + 128 c
  // .. + 3 of (q_lat | q_rope)
  float4 q[QC];
#pragma unroll
  for (int c = 0; c < QC; ++c) {
    const int d = 4 * lane + 128 * c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (head && d < W) {
      if (d < kvr) {
        v = *reinterpret_cast<const float4*>(q_lat + row * kvr + d);
      } else {
        const TQ* r = q_rope + row * rope + (d - kvr);
        v = make_float4(to_f(r[0]), to_f(r[1]), to_f(r[2]), to_f(r[3]));
      }
    }
    q[c] = v;
  }
  float4 acc[AC];
#pragma unroll
  for (int c = 0; c < AC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = NEG_INF, l = 0.f;

  Stage<TKV> st;
  st.kvr = kvr;
  st.rope = rope;
  st.S = W;
  st.n_lat = bs * kvr / Stage<TKV>::V;
  st.n = st.n_lat + bs * rope / Stage<TKV>::V;
  const int round = RV * THREADS;
  const int nblk = length > 0 ? min(nb, (length + bs - 1) / bs) : 0;

  // pooled block j of the row, as 16-byte vectors
  int* row_table = reinterpret_cast<int*>(sk + bs * W);
  for (int i = threadIdx.x; i < nblk; i += THREADS)
    row_table[i] = tables[(size_t)b * nb + i];
  __syncthreads();
  const size_t lat_len = (size_t)bs * kvr, rope_len = (size_t)bs * rope;
  uint4 raw[RV];
  if (nblk > 0) {
    const size_t blk = (size_t)row_table[0];
    st.fetch(raw, reinterpret_cast<const uint4*>(ckv + blk * lat_len),
             reinterpret_cast<const uint4*>(krope + blk * rope_len), 0);
  }
  for (int j = 0; j < nblk; ++j) {
    const size_t blk = (size_t)row_table[j];
    const uint4* lat = reinterpret_cast<const uint4*>(ckv + blk * lat_len);
    const uint4* rp = reinterpret_cast<const uint4*>(krope + blk * rope_len);
    __syncthreads();                       // the last block is consumed
    st.stash(raw, 0, sk);
    for (int base = round; base < st.n; base += round) {
      st.fetch(raw, lat, rp, base);
      st.stash(raw, base, sk);
    }
    __syncthreads();
    if (j + 1 < nblk) {                    // in flight while we score
      const size_t nxt = (size_t)row_table[j + 1];
      st.fetch(raw, reinterpret_cast<const uint4*>(ckv + nxt * lat_len),
               reinterpret_cast<const uint4*>(krope + nxt * rope_len), 0);
    }
    for (int p0 = 0; p0 < bs; p0 += PG) {
      // positions p0 .. p0 + 15; one past the block reads its last row
      // (branch-free inner loops: a guard on each read was far slower)
      // and is masked out below
      int off[PG];
#pragma unroll
      for (int i = 0; i < PG; ++i) off[i] = min(p0 + i, bs - 1) * W;
      // partial logits over this lane's dimensions
      float s[PG];
#pragma unroll
      for (int i = 0; i < PG; ++i) s[i] = 0.f;
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        const int d = 4 * lane + 128 * c;
        if (d < W) {
          const float* col = sk + d;
#pragma unroll
          for (int i = 0; i < PG; ++i) {
            const float4 k = *reinterpret_cast<const float4*>(col + off[i]);
            s[i] = fmaf(q[c].x, k.x, s[i]);
            s[i] = fmaf(q[c].y, k.y, s[i]);
            s[i] = fmaf(q[c].z, k.z, s[i]);
            s[i] = fmaf(q[c].w, k.w, s[i]);
          }
        }
      }
      // butterfly sums: every lane ends with every logit
#pragma unroll
      for (int i = 0; i < PG; ++i) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      }
      float m_cur = m;
#pragma unroll
      for (int i = 0; i < PG; ++i) {
        const int p = p0 + i;
        s[i] = (p < bs && j * bs + p < length) ? s[i] * scale : NEG_INF;
        m_cur = fmaxf(m_cur, s[i]);
      }
      const float alpha = expf(m - m_cur);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < PG; ++i) {
        s[i] = expf(s[i] - m_cur);
        psum += s[i];
      }
      l = alpha * l + psum;
      m = m_cur;
#pragma unroll
      for (int c = 0; c < AC; ++c) {
        const int d = 4 * lane + 128 * c;
        if (d < kvr) {
          const float* col = sk + d;
          float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < PG; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(col + off[i]);
            pv.x = fmaf(s[i], v.x, pv.x);
            pv.y = fmaf(s[i], v.y, pv.y);
            pv.z = fmaf(s[i], v.z, pv.z);
            pv.w = fmaf(s[i], v.w, pv.w);
          }
          acc[c].x = acc[c].x * alpha + pv.x;
          acc[c].y = acc[c].y * alpha + pv.y;
          acc[c].z = acc[c].z * alpha + pv.z;
          acc[c].w = acc[c].w * alpha + pv.w;
        }
      }
    }
  }
  if (head) {
    const float inv_l = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int d = 4 * lane + 128 * c;
      if (d < kvr)
        *reinterpret_cast<float4*>(out + row * kvr + d) =
            make_float4(acc[c].x * inv_l, acc[c].y * inv_l,
                        acc[c].z * inv_l, acc[c].w * inv_l);
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* tables, const void* lengths,
           void* out, int B, int H, int kvr, int rope, int bs, int nb,
           float scale, cudaStream_t stream) {
  constexpr int V = Stage<TKV>::V;
  if (kvr > AC * 128 || kvr + rope > QC * 128 || kvr % V || rope % V)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)bs * (kvr + rope) +
                      sizeof(int) * (size_t)nb;
  auto kern = paged_mla<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(B, (H + HG - 1) / HG), THREADS, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const TQ*>(q_rope),
      static_cast<const TKV*>(ckv), static_cast<const TKV*>(krope),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(out), H, kvr, rope, bs, nb, scale);
  return cudaGetLastError();
}

template <typename TQ>
int dispatch_kv(int kvtype, const void* q_lat, const void* q_rope,
                const void* ckv, const void* krope, const void* tables,
                const void* lengths, void* out, int B, int H, int kvr,
                int rope, int bs, int nb, float scale, cudaStream_t s) {
  switch (kvtype) {
    case repro::kF32:
      return launch<TQ, float>(q_lat, q_rope, ckv, krope, tables, lengths,
                               out, B, H, kvr, rope, bs, nb, scale, s);
    case repro::kBF16:
      return launch<TQ, __nv_bfloat16>(q_lat, q_rope, ckv, krope, tables,
                                       lengths, out, B, H, kvr, rope, bs, nb,
                                       scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_lat (B, H, kvr) fp32; q_rope (B, H, rope) of type ``qtype``; pools
// c_kv (P, bs, kvr) and k_rope (P, bs, rope) of type ``kvtype``, 16-byte
// aligned; tables (B, nb) int32; lengths (B,) int32; out (B, H, kvr)
// fp32. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for widths outside the limits above).
extern "C" int paged_mla_launch(const void* q_lat, const void* q_rope,
                                const void* ckv, const void* krope,
                                const void* tables, const void* lengths,
                                void* out, int B, int H, int kvr, int rope,
                                int bs, int nb, float scale, int qtype,
                                int kvtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtype == repro::kF32)
    return dispatch_kv<float>(kvtype, q_lat, q_rope, ckv, krope, tables,
                              lengths, out, B, H, kvr, rope, bs, nb, scale,
                              s);
  if (qtype == repro::kBF16)
    return dispatch_kv<__nv_bfloat16>(kvtype, q_lat, q_rope, ckv, krope,
                                      tables, lengths, out, B, H, kvr, rope,
                                      bs, nb, scale, s);
  return cudaErrorInvalidValue;
}
