// Blocked (flash) attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body ``_kernel`` :41, pallas_call :133). Its
// semantics, not its block structure: q (B, Hq, S, D) against k/v
// (B, Hkv, T, D); query head h reads kv head h / (Hq / Hkv) (GQA without
// duplicating k/v); queries sit at the end of the sequence (offset =
// T - S), so under ``causal`` key kpos is visible to query row i iff
// kpos <= i + offset; logits = (q . k) * scale in fp32, masked ones
// -1e30; running max m, running sum l and the (rows x D) accumulator in
// fp32; the probabilities are rounded to v's type before the PV product
// (the Pallas body's ``p.astype(v.dtype)``) while l sums them unrounded;
// a row with l == 0 divides by 1; the output is written once, in q's
// type. Key tiles strictly above the diagonal are never visited.
//
// The Sidebar: the (BQ x BK) logits / probability tile and the per-row
// m and l live in registers and shared memory and never reach HBM; only
// the (S x D) output does. That is the paper's point applied to
// attention (flash_attention.py:1-10).
//
// What bounds it on an H100: at nemotron-4-15b's training shape (S = T
// = 4096, 48 query heads, D 128, causal) the work is 2 products of
// S*T/2*D multiply-adds a head, 4*48*4096*4096*128/2 ~ 206 GFLOP,
// against ~0.12 GB of q, k, v and output: bound by operations (0.21 ms
// at the 989 TFLOP/s bf16 tensor-core peak).
//
// Two routes, one semantics:
//  * bf16 with D a multiple of 16 up to 128 (the model's shapes) takes
//    the tensor cores: ``flash_attention_mma`` below (mma.sync m16n8k16,
//    fp32 accumulation; one warp per 16 query rows).
//  * fp32, and bf16 at head dims 8 and 136-256, take ``flash_attention``:
//    fp32 FMA outside the tensor cores (67 TFLOP/s peak), which cannot
//    come within 15x of the bf16 bound.
// wgmma, TMA tile loads and a warp-specialised pipeline are later work.
//
// Design of the FMA route: one block of 256 threads per (b * Hq + h, q
// tile of BQ = 64 rows); q tiles are taken longest-first (the last tile
// of a causal head walks the most key tiles). The block stages its q
// tile once, as fp32, in shared memory, then walks the key tiles of BK =
// 64 up to the last one its last row can see: K tile into shared memory,
// logits (each thread a 4 x 4 sub-tile: rows 4*ty..4*ty+3, key columns
// tx + 16*c, float4 reads along D), scale and mask, the online softmax (a
// row's 64 logits sit in the 16 threads of one half warp: shuffles, no
// barrier), p into shared memory, then V into the same buffer and the PV
// product into the thread's accumulator (its 4 rows x D/16 columns,
// float4 groups tx + 16*j). Row strides of D + 4 floats keep the float4
// reads of eight consecutive rows on distinct banks.
//
// Limits (checked by the wrapper, flash_attention.py): fp32 or bf16
// operands of one type, contiguous, 16-byte aligned; D a multiple of 8,
// at most 256; Hq a multiple of Hkv; causal needs T >= S. Any S and T:
// rows and keys past the ends are masked.

#include "common.cuh"

namespace {

using repro::from_f;
using repro::round_to;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;             // query rows of a block
constexpr int BK = 64;             // keys of a tile
constexpr int THREADS = 256;       // 16 x 16: ty picks 4 rows, tx columns
constexpr int PLD = BK + 4;        // row stride of the p tile (floats)
static_assert(BQ == BK, "stage() moves tiles of BQ rows for q, k and v");

// 16-byte vectors of T as fp32, into 16-byte aligned shared memory
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

// rows [row0, row0 + rows) of a (n, D) matrix of T into a (rows, D + 4)
// fp32 tile; rows at or past n are zero
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0,
                                      int n, int D, float* dst) {
  constexpr int EPV = 16 / sizeof(T);            // elements a vector
  const int vpr = D / EPV;                       // vectors a row
  const int ld = D + 4;
  for (int i = threadIdx.x; i < BQ * vpr; i += THREADS) {
    const int r = i / vpr, cv = i - r * vpr;
    float* o = dst + r * ld + cv * EPV;
    if (row0 + r < n) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * D + cv * EPV);
      unpack(u, o, src);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; e += 4)
        *reinterpret_cast<float4*>(o + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// DG: float4 column groups of the accumulator a thread holds per row
// (ceil(D / 64))
template <typename T, int DG>
__global__ void __launch_bounds__(THREADS)
flash_attention(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int Hq,
                int group, int S, int Tn, int D, float scale, int causal,
                int offset) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BQ x (D + 4)
  float* kv = qs + BQ * (D + 4);                 // BK x (D + 4): K, then V
  float* ps = kv + BK * (D + 4);                 // BQ x PLD
  const int ld = D + 4;
  const int ng = D / 4;                          // float4 groups a row
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;            // longest tiles first
  const int bh = blockIdx.y;
  const int bkv = (bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const int q0 = qt * BQ;
  const T* kb = k + (size_t)bkv * Tn * D;
  const T* vb = v + (size_t)bkv * Tn * D;

  stage(q + (size_t)bh * S * D, q0, S, D, qs);

  // keys [0, kv_end) are visible to some row of the tile
  const int last_q = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? min(Tn, last_q + offset + 1) : Tn;
  const int n_tiles = (kv_end + BK - 1) / BK;

  float m[4], l[4];
  float4 acc[4][DG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DG; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                             // PV of the last tile done
    stage(kb, k0, Tn, D, kv);
    __syncthreads();

    // logits of rows 4*ty + i against keys tx + 16*c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * ld + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(kv + (tx + 16 * c) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(a[i].x, b[c].x, s[i][c]);
          s[i][c] = fmaf(a[i].y, b[c].y, s[i][c]);
          s[i][c] = fmaf(a[i].z, b[c].z, s[i][c]);
          s[i][c] = fmaf(a[i].w, b[c].w, s[i][c]);
        }
    }

    // scale, mask, online softmax; a row's 64 logits are spread over the
    // 16 threads of one half warp (same ty)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float val = s[i][c] * scale;
        if (kpos >= Tn || (causal && kpos > qpos + offset)) val = NEG_INF;
        s[i][c] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        ps[(4 * ty + i) * PLD + tx + 16 * c] = round_to<T>(p);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        acc[i][j].x *= alpha;
        acc[i][j].y *= alpha;
        acc[i][j].z *= alpha;
        acc[i][j].w *= alpha;
      }
    }
    __syncthreads();                             // K read, p written
    stage(vb, k0, Tn, D, kv);
    __syncthreads();

    // acc[i] += p[row i, :] . V[:, groups tx + 16 j]
    for (int c = 0; c < BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * PLD + c);
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        const int g = tx + 16 * j;
        if (g < ng) {
          const float4 v0 = *reinterpret_cast<const float4*>(kv + c * ld + 4 * g);
          const float4 v1 =
              *reinterpret_cast<const float4*>(kv + (c + 1) * ld + 4 * g);
          const float4 v2 =
              *reinterpret_cast<const float4*>(kv + (c + 2) * ld + 4 * g);
          const float4 v3 =
              *reinterpret_cast<const float4*>(kv + (c + 3) * ld + 4 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float4& a = acc[i][j];
            a.x = fmaf(p[i].x, v0.x, a.x);
            a.y = fmaf(p[i].x, v0.y, a.y);
            a.z = fmaf(p[i].x, v0.z, a.z);
            a.w = fmaf(p[i].x, v0.w, a.w);
            a.x = fmaf(p[i].y, v1.x, a.x);
            a.y = fmaf(p[i].y, v1.y, a.y);
            a.z = fmaf(p[i].y, v1.z, a.z);
            a.w = fmaf(p[i].y, v1.w, a.w);
            a.x = fmaf(p[i].z, v2.x, a.x);
            a.y = fmaf(p[i].z, v2.y, a.y);
            a.z = fmaf(p[i].z, v2.z, a.z);
            a.w = fmaf(p[i].z, v2.w, a.w);
            a.x = fmaf(p[i].w, v3.x, a.x);
            a.y = fmaf(p[i].w, v3.y, a.y);
            a.z = fmaf(p[i].w, v3.z, a.z);
            a.w = fmaf(p[i].w, v3.w, a.w);
          }
        }
      }
    }
  }

  // the accumulator, divided by l, written once
  T* ob = out + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < DG; ++j) {
      const int g = tx + 16 * j;
      if (g >= ng) continue;
      T* o = ob + (size_t)r * D + 4 * g;
      o[0] = from_f<T>(acc[i][j].x * inv);
      o[1] = from_f<T>(acc[i][j].y * inv);
      o[2] = from_f<T>(acc[i][j].z * inv);
      o[3] = from_f<T>(acc[i][j].w * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulation), for
// head_dim a multiple of 16 up to 128. Same semantics as above; the
// block is 4 warps over BQ = 64 rows (16 a warp), key tiles of BK = 64.
// A warp keeps its q rows as A fragments, the (16 x 64) logits tile
// and the (16 x D) accumulator as C fragments in registers: the logits
// never leave registers, the probabilities become the A fragments of
// the PV product in place (rounded to bf16, as the Pallas body rounds
// p to v's type), and each row's m and l live with the four lanes that
// hold the row (two shuffles reduce them). K and V tiles are staged in
// shared memory as bf16 with padded rows (D + 8: conflict-free 32-bit
// fragment reads and ldmatrix rows); V's B fragments come from
// ldmatrix .trans.
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + 64) of a (n, D) bf16 matrix into a (64, D + 8)
// tile; rows at or past n are zero
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src,
                                           int row0, int n,
                                           __nv_bfloat16* dst) {
  constexpr int VPR = D / 8;                     // 16-byte vectors a row
  for (int i = threadIdx.x; i < BQ * VPR; i += MMA_THREADS) {
    const int r = i / VPR, cv = i - r * VPR;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      u = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D +
                                          cv * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + cv * 8) = u;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int Hq, int group,
                    int S, int Tn, float scale, int causal, int offset) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;                     // k-steps of q . k
  constexpr int ND = D / 8;                      // n-tiles of the output
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;            // longest tiles first
  const int bh = blockIdx.y;
  const int bkv = (bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const int q0 = qt * BQ;
  const __nv_bfloat16* kb = k + (size_t)bkv * Tn * D;
  const __nv_bfloat16* vb = v + (size_t)bkv * Tn * D;

  stage_bf16<D>(q + (size_t)bh * S * D, q0, S, qs);
  __syncthreads();
  const int r0 = warp * 16 + g;                  // the lane's rows r0, r0+8
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    qa[s][0] = ld32(qs + r0 * LD + 16 * s + 2 * tig);
    qa[s][1] = ld32(qs + (r0 + 8) * LD + 16 * s + 2 * tig);
    qa[s][2] = ld32(qs + r0 * LD + 16 * s + 8 + 2 * tig);
    qa[s][3] = ld32(qs + (r0 + 8) * LD + 16 * s + 8 + 2 * tig);
  }

  const int last_q = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? min(Tn, last_q + offset + 1) : Tn;
  const int n_tiles = (kv_end + BK - 1) / BK;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                             // last tile's reads done
    stage_bf16<D>(kb, k0, Tn, ks);
    stage_bf16<D>(vb, k0, Tn, vs);
    __syncthreads();

    // logits: 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * LD + 2 * tig;
#pragma unroll
      for (int s = 0; s < KS; ++s)
        mma_bf16(sc[n], qa[s], ld32(kr + 16 * s), ld32(kr + 16 * s + 8));
    }

    // scale, mask, online softmax (row h: elements 2h, 2h+1 of each tile)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
        float val = sc[n][e] * scale;
        if (kpos >= Tn || (causal && kpos > qrow[h] + offset)) val = NEG_INF;
        sc[n][e] = val;
        mx[h] = fmaxf(mx[h], val);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m[e >> 1]);
        sum[e >> 1] += p;
        sc[n][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // PV: p (rounded to bf16) as the A fragments, 16 keys a k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const uint32_t row_addr = static_cast<uint32_t>(__cvta_generic_to_shared(
          vs + (kk * 16 + (lane & 15)) * LD));
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
            : "=r"(b0), "=r"(b1)
            : "r"(row_addr + n * 16));
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }

  // the accumulator, divided by l, written once
  __nv_bfloat16* ob = out + (size_t)bh * S * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= S) continue;
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    __nv_bfloat16* orow = ob + (size_t)qrow[h] * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int B, int Hq, int Hkv, int S, int Tn, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BQ + 2 * BK) * (D + 8);
  auto kern = flash_attention_mma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((S + BQ - 1) / BQ, B * Hq), MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Hq, Hq / Hkv, S, Tn, scale, causal, Tn - S);
  return cudaGetLastError();
}

template <typename T, int DG>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int Tn, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (D + 4) +
                                       (size_t)BQ * PLD);
  auto kern = flash_attention<T, DG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((S + BQ - 1) / BQ, B * Hq), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hq / Hkv, S, Tn,
      D, scale, causal, Tn - S);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               int B, int Hq, int Hkv, int S, int Tn, int D, float scale,
               int causal, cudaStream_t s) {
  switch ((D + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, out, B, Hq, Hkv, S, Tn, D, scale, causal,
                          s);
    case 2:
      return launch<T, 2>(q, k, v, out, B, Hq, Hkv, S, Tn, D, scale, causal,
                          s);
    case 3:
      return launch<T, 3>(q, k, v, out, B, Hq, Hkv, S, Tn, D, scale, causal,
                          s);
    case 4:
      return launch<T, 4>(q, k, v, out, B, Hq, Hkv, S, Tn, D, scale, causal,
                          s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, S, D), k and v (B, Hkv, T, D), out (B, Hq, S, D), all of
// type ``dtype`` (0 fp32, 1 bf16), contiguous and 16-byte aligned.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// shapes outside the limits above).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Hq, int Hkv, int S, int Tn, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (B < 1 || S < 1 || Tn < 1 || Hkv < 1 || Hq % Hkv || D % 8 || D < 8 ||
      D > 256 || (causal && Tn < S))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_d<float>(q, k, v, out, B, Hq, Hkv, S, Tn, D, scale,
                             causal, s);
  if (dtype == repro::kBF16) {
    switch (D) {                     // the tensor-core route
#define REPRO_MMA_CASE(d)                                                   \
      case d:                                                               \
        return launch_mma<d>(q, k, v, out, B, Hq, Hkv, S, Tn, scale, causal, s);
      REPRO_MMA_CASE(16)
      REPRO_MMA_CASE(32)
      REPRO_MMA_CASE(48)
      REPRO_MMA_CASE(64)
      REPRO_MMA_CASE(80)
      REPRO_MMA_CASE(96)
      REPRO_MMA_CASE(112)
      REPRO_MMA_CASE(128)
#undef REPRO_MMA_CASE
      default:
        return dispatch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, Tn, D,
                                         scale, causal, s);
    }
  }
  return cudaErrorInvalidValue;
}
