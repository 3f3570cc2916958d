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
//    the tensor cores: ``tc::flash_wgmma`` below (wgmma with fp32
//    accumulation, q / K / V tiles by TMA into a ring of mbarrier-guarded
//    stages, 128-row q tiles on two consumer warpgroups). It uses the
//    Hopper helpers of hopper.cuh. It masks the unscaled logit to -1e30
//    and takes exp(z) as 2^(z log2 e), with the scale folded into the
//    exponent's FFMA (scale > 0 keeps the max where it was): the same
//    function, rounded once where the FMA route rounds twice.
//  * fp32, and bf16 at head dims 8 and 136-256, take ``flash_attention``:
//    fp32 FMA outside the tensor cores (67 TFLOP/s peak), which cannot
//    come within 15x of the bf16 bound.
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
#include "hopper.cuh"

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
// bf16 on the tensor cores: wgmma with a TMA ring, head_dim 16-128 (a
// multiple of 16), computed at DP = 64 or 128 (TMA fills the columns
// past D with zeros: they add nothing to q . k, and the output's are not
// written). Same semantics as above.
//
// A block owns a BQ = 128-row q tile: two consumer warpgroups of 64 rows
// (no loader warp: a ninth warp would cap every thread at 168 registers,
// and the overlapped loop below needs ~190). Its first thread brings the
// q tile and the first K and V tiles (BKT = 128 keys) by TMA into a ring
// of KV_STAGES = 3 stages with full / empty mbarriers; afterwards the
// warpgroup that frees a stage last refills it, so loads run two tiles
// ahead of the products. A consumer warpgroup computes its (64 x 128)
// logits tile with wgmma (q and K both K-major in shared memory), keeps
// it in registers for the online softmax (a row's values sit in the four
// lanes of a quad: two shuffles), and feeds p — rounded to bf16 where
// the Pallas body rounds it, while l sums it unrounded — as the register
// A operand of the PV wgmma, V read MN-major from shared memory: the
// logits and probabilities never leave the SM. The PV product of tile t - 1 is
// issued with tile t's logits product and runs during tile t's softmax;
// the two warpgroups take turns (named barriers) to issue their
// products, so one's softmax overlaps the other's products. Only the
// tiles that cross the diagonal (or the end of the keys) are masked.
// The grid puts the heads of one kv head next to each other (they share
// K and V in L2) and the longest q tiles first.
// ---------------------------------------------------------------------------

namespace tc {

namespace hp = repro::hopper;

constexpr int BQ = 128;            // q rows of a block (two warpgroups)
constexpr int BKT = 128;           // keys of a K / V tile: the logits
                                   // product is m64n128k16
constexpr int KV_STAGES = 3;
constexpr int THREADS = 2 * 128;  // two consumer warpgroups
constexpr int BOX = 128 * 128;     // bytes of one 128-row x 64-column box
constexpr int KBOX = BKT * 128;    // bytes of one BKT-row x 64-column box

template <int DP>
size_t smem_bytes() {
  // q, the K / V stages, 1 + 2 x KV_STAGES mbarriers, the stages'
  // release counts, alignment slack
  return 1024 + (size_t)(DP / 64) * (BOX + 2 * KV_STAGES * KBOX) +
         8 * (1 + 2 * KV_STAGES) + 4 * KV_STAGES;
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (results below 2^-126 flush to 0:
// such a p is far below a bf16 ulp of any row's sum)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// named barriers (1, 2) of the two consumer warpgroups' turns: one waits
// for its turn (its 128 threads) while the other arrives (its 128)
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// o += p V for one tile: p (bf16, the register A operand) 16 keys a
// k-step, V (MN-major at shared address ``vb``) one 64-column box at a
// time; committed as one group, not waited for
template <int NB>
__device__ __forceinline__ void pv(float (*o)[32], const uint32_t (*pa)[4],
                                   uint32_t vb) {
  const uint64_t vdesc = hp::desc_sw128(vb);
#pragma unroll
  for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NB; ++c)
      hp::wgmma_m64n64k16_rs<1>(o[c], pa[kk],
                                vdesc + ((c * KBOX + kk * 2048) >> 4));
  hp::wgmma_commit();
}

// tile u's K and V (64-column boxes of BKT rows of kv head bkv) into
// stage st, completing kv_full[st]
template <int NB>
__device__ __forceinline__ void load_kv(unsigned char* kvs,
                                        uint64_t* kv_full,
                                        const CUtensorMap* mk,
                                        const CUtensorMap* mv, int st, int u,
                                        int bkv) {
  constexpr int KV_STAGE = 2 * NB * KBOX;
  unsigned char* dst = kvs + st * KV_STAGE;
  hp::mbar_arrive_expect_tx(&kv_full[st], KV_STAGE);
  for (int c = 0; c < NB; ++c) {
    hp::tma_load_3d(dst + c * KBOX, mk, &kv_full[st], c * 64, u * BKT, bkv);
    hp::tma_load_3d(dst + (NB + c) * KBOX, mv, &kv_full[st], c * 64,
                    u * BKT, bkv);
  }
}

// ---- consumer warpgroup tid / 128: q rows q0 + 64 wg .. + 63 ----------
template <int DP>
__device__ __forceinline__ void consume(
    unsigned char* qs, unsigned char* kvs, uint64_t* q_full,
    uint64_t* kv_full, uint64_t* kv_empty, int* released,
    const CUtensorMap* mk, const CUtensorMap* mv, int bkv,
    __nv_bfloat16* __restrict__ out, int bh, int q0, int n_tiles, int S,
    int Tn, int D, float scale, int causal, int offset) {
  constexpr int NB = DP / 64;
  constexpr int KV_STAGE = 2 * NB * KBOX;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 64 * wg + 16 * warp + lane / 4;   // rows r0, r0 + 8
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const int first_row = q0 + 64 * wg;
  const uint32_t qa = hp::smem_addr(qs) + wg * 64 * 128;
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint32_t kv0 = hp::smem_addr(kvs);

  float o[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // the two warpgroups take turns to issue their logits products, so
  // one's softmax runs while the other's products do (warpgroup 0 first)
  const int my_turn = 1 + wg, other_turn = 2 - wg;   // named barriers
  if (wg == 1) turn_arrive(1);
  hp::mbar_wait(q_full, 0);
  // Tile t's logits product is issued together with tile t - 1's PV
  // product, and the softmax of tile t runs while the PV product does:
  // o holds alpha-rescaled sums of every tile but the last one, whose p
  // is in ``pa`` (o_t = alpha_t (o_{t-1} + p_{t-1} V_{t-1})). The first
  // tile is peeled off, so that no wgmma sits in a branch (ptxas would
  // serialise every wgmma of the kernel).
  float sc[BKT / 2];
  uint32_t pa[BKT / 16][4];
  int s = 0, s_prev = 0;
  uint32_t ph = 0;

  // the logits of the tile in stage s: (64 x BKT) = q (64 x DP) . K^T,
  // 16 columns of d a k-step; committed, not waited for
  // (a descriptor's address field takes byte offsets / 16 as they are)
  const uint64_t qdesc = hp::desc_sw128(qa);
  // (the first k-step overwrites the accumulator: no zeroing)
  auto issue_logits = [&]() {
    const uint64_t kdesc = hp::desc_sw128(kv0 + s * KV_STAGE);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hp::wgmma_m64n128k16_ss<0, 0>(
          sc, qdesc + (((kk / 4) * BOX + (kk % 4) * 32) >> 4),
          kdesc + (((kk / 4) * KBOX + (kk % 4) * 32) >> 4), kk > 0);
    hp::wgmma_commit();
  };
  // mask (only a tile across the diagonal or the end of the keys: the
  // logit becomes -1e30), the online softmax of tile t in base 2
  // (exp(z) = 2^(z log2 e), so p = 2^(s scale log2 e - m scale log2 e),
  // one FFMA and one ex2 an element; m is kept unscaled): sc becomes p,
  // l and m advance, alpha is left for the rescale. sc[4 i + 2 h + e] is
  // row h, key k0 + 8 i + 2 (lane % 4) + e
  float alpha[2];
  auto softmax = [&](int t) {
    const int k0 = t * BKT;
    if (k0 + BKT > Tn || (causal && k0 + BKT - 1 > first_row + offset)) {
#pragma unroll
      for (int i = 0; i < BKT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * i + 2 * (lane & 3) + (e & 1);
          if (kpos >= Tn || (causal && kpos > qrow[e >> 1] + offset))
            sc[4 * i + e] = NEG_INF;
        }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BKT / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float sum[2] = {0.f, 0.f}, ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = ex2((m[h] - m_new) * scale_log2);
      m[h] = m_new;
      ms[h] = m_new * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < BKT / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
  };
  // o *= alpha; p rounded to bf16 into pa (four packed pairs a 16-key
  // k-step: the register A operand's layout) — l summed it unrounded
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < BKT / 4; ++i)
      pa[i / 4][i % 4] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  auto next_stage = [&]() {
    s_prev = s;
    if (++s == KV_STAGES) {
      s = 0;
      ph ^= 1;
    }
  };

  // tile 0
  hp::mbar_wait(&kv_full[s], ph);
  turn_sync(my_turn);
  hp::wgmma_fence();
  issue_logits();
  if (wg == 0 || n_tiles > 1) turn_arrive(other_turn);
  hp::wgmma_wait<0>();
  hp::fence_regs<BKT / 2>(sc);
  softmax(0);
  rescale_and_pack();
  next_stage();
  // tiles 1 .. n - 1, each with the previous tile's PV product
  for (int t = 1; t < n_tiles; ++t) {
    hp::mbar_wait(&kv_full[s], ph);
    turn_sync(my_turn);
    hp::wgmma_fence();
    issue_logits();
    pv<NB>(o, pa, kv0 + s_prev * KV_STAGE + NB * KBOX);
    if (wg == 0 || t + 1 < n_tiles) turn_arrive(other_turn);
    hp::wgmma_wait<1>();   // the logits; the PV product may still run
    hp::fence_regs<BKT / 2>(sc);
    softmax(t);
    hp::wgmma_wait<0>();   // tile t - 1's PV product: its stage is free
#pragma unroll
    for (int c = 0; c < NB; ++c) hp::fence_regs<32>(o[c]);
    if (tid % 128 == 0) {
      hp::mbar_arrive(&kv_empty[s_prev]);
      // the second warpgroup to free the stage refills it with tile
      // t - 1 + KV_STAGES
      const int u = t - 1 + KV_STAGES;
      if (u < n_tiles && atomicAdd(&released[s_prev], 1) == 1) {
        released[s_prev] = 0;
        hp::mbar_wait(&kv_empty[s_prev], ((t - 1) / KV_STAGES) & 1);
        load_kv<NB>(kvs, kv_full, mk, mv, s_prev, u, bkv);
      }
    }
    rescale_and_pack();
    next_stage();
  }
  hp::wgmma_fence();
  pv<NB>(o, pa, kv0 + s_prev * KV_STAGE + NB * KBOX);
  hp::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NB; ++c) hp::fence_regs<32>(o[c]);

  // the accumulator, divided by l, written once (columns below D)
  __nv_bfloat16* ob = out + (size_t)bh * S * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= S) continue;
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    __nv_bfloat16* orow = ob + (size_t)qrow[h] * D + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = c * 64 + 8 * i + 2 * (lane & 3);
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + c * 64 + 8 * i) = pack_bf16(
              o[c][4 * i + 2 * h] * inv, o[c][4 * i + 2 * h + 1] * inv);
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv,
            __nv_bfloat16* __restrict__ out, int Hq, int group, int S,
            int Tn, int D, float scale, int causal, int offset) {
  constexpr int NB = DP / 64;        // 64-column boxes of a row
  constexpr int KV_STAGE = 2 * NB * KBOX;
  extern __shared__ __align__(1024) unsigned char flash_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(flash_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* kvs = qs + NB * BOX;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kvs + KV_STAGES * KV_STAGE);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + KV_STAGES;
  int* released = reinterpret_cast<int*>(kv_empty + KV_STAGES);

  const int bh = blockIdx.x;
  const int bkv = (bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;   // longest tiles first
  const int last_q = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? min(Tn, last_q + offset + 1) : Tn;
  const int n_tiles = (kv_end + BKT - 1) / BKT;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      hp::mbar_init(&kv_full[s], 1);
      hp::mbar_init(&kv_empty[s], 2);
      released[s] = 0;
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    // q once, and the first KV_STAGES tiles; later tiles are loaded by
    // the warpgroup that frees a stage last
    hp::mbar_arrive_expect_tx(q_full, NB * BOX);
    for (int c = 0; c < NB; ++c)
      hp::tma_load_3d(qs + c * BOX, &mq, q_full, c * 64, q0, bh);
    for (int u = 0; u < min(KV_STAGES, n_tiles); ++u)
      load_kv<NB>(kvs, kv_full, &mk, &mv, u, u, bkv);
  }
  consume<DP>(qs, kvs, q_full, kv_full, kv_empty, released, &mk, &mv, bkv,
              out, bh, q0, n_tiles, S, Tn, D, scale, causal, offset);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int Tn, int D, float scale, int causal,
           cudaStream_t stream) {
  // (D, rows, heads) views; boxes of 64 columns x 128 rows of one head
  CUtensorMap mq, mk, mv;
  const uint64_t dq[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)B * Hq};
  const uint64_t dk[3] = {(uint64_t)D, (uint64_t)Tn, (uint64_t)B * Hkv};
  const uint64_t sq[2] = {2ull * D, 2ull * D * S};
  const uint64_t sk[2] = {2ull * D, 2ull * D * Tn};
  const uint32_t qbox[3] = {64, BQ, 1}, kbox[3] = {64, BKT, 1};
  if (!repro::hopper::make_tensor_map(&mq, q, 3, dq, sq, qbox) ||
      !repro::hopper::make_tensor_map(&mk, k, 3, dk, sk, kbox) ||
      !repro::hopper::make_tensor_map(&mv, v, 3, dk, sk, kbox))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<DP>();
  auto kern = flash_wgmma<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(B * Hq, (S + BQ - 1) / BQ), THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Hq, Hq / Hkv, S, Tn, D,
      scale, causal, Tn - S);
  return cudaGetLastError();
}

}  // namespace tc

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
    if (D % 16 == 0 && D <= 128)     // the tensor-core route
      return D <= 64 ? tc::launch<64>(q, k, v, out, B, Hq, Hkv, S, Tn, D,
                                      scale, causal, s)
                     : tc::launch<128>(q, k, v, out, B, Hq, Hkv, S, Tn, D,
                                       scale, causal, s);
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, Tn, D,
                                     scale, causal, s);
  }
  return cudaErrorInvalidValue;
}
