// Paged MLA absorbed decode for Hopper, in place on the compressed
// (latent + shared rope key) block pool: split-KV with a fixed-order
// merge, the heads of a group on the tensor cores.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py:paged_mla_kernel (body
// ``_mla_kernel``, pallas_call at :361). Its semantics, not its block
// structure: per row b the kernel reads the positions below
// ``lengths[b]`` through ``tables[b, :]``; logits are (q_lat . c_kv +
// q_rope . k_rope) * scale in fp32 with kpos >= length masked to -1e30;
// the softmax is online (here: per split, then merged); the latent rows
// enter both products at their fp32 value (the Pallas body's
// ``ckv.astype(float32)``); probabilities stay fp32 (unlike the GQA
// kernel, nothing is rounded to the pool type); a row with l == 0
// divides by 1, so a length-0 row gives 0; ctx_lat is written in fp32.
// The w_uk / w_uv absorption stays in the model.
//
// What bounds it on an H100: q_lat is fp32 (B, H, 512), so at deepseek-
// v3's decode shapes (4 rows, 128 heads, lengths 256/241/200/129, block
// 16, bf16 pool) the work is 2 * 826 * 128 * (576 + 512) ~ 0.23 GFLOP
// held to fp32 accuracy against ~3.1 MB of bytes (q_lat and ctx_lat 1 MB
// each, the live latent rows ~1 MB). On the CUDA cores that is ~3.4 us
// of fp32 FMA (67 TFLOP/s): bound by operations. On the tensor cores in
// TF32 (495 TFLOP/s), at two products for each one (below), it is ~0.9
// us, level with the bytes. In practice a decode call is bound by
// latency: two launches, and inside a block the chain of loads before
// the math. One block per (row, 4 heads) walking a whole row, as the
// first design did, left 128 blocks of 4 warps with nothing to hide that
// latency behind, and every head group re-read the row's latent cache.
//
// What the design does about it:
//   * split-KV: a split covers the CHUNK positions of
//     kernels/paged_attention.py ``split_chunk`` (64 at blocks of 1-64
//     positions), boundaries at its multiples, so a row's splits are a
//     function of its own length only (``split_bounds``), as
//     ``paged_gqa``'s are. A block takes one (split, head group, row),
//     writes the split's own max m_s, sum l_s = sum e^(s - m_s) and
//     unnormalised acc_s = sum e^(s - m_s) c_kv (fp32) to a workspace
//     the wrapper allocates, and a split at or past the row's length
//     exits at once. A second launch over (head, row), a programmatic
//     dependent of the first, merges the row's live splits: m = max m_s
//     and l = sum l_s e^(m_s - m) across a warp's lanes, acc = sum acc_s
//     e^(m_s - m) in split order, out = acc / (l or 1). No atomics: the
//     bits are the same run to run, and a row alone gives the bits it
//     gets in a batch.
//   * "tc" route (bf16 pool, kvr a multiple of 64 up to 512, kvr + rope
//     a multiple of 64 up to 576, splits of 64 positions; the wrapper's
//     rule ``mla_route``): a block of 8 warps takes 16 heads, the M of
//     mma.sync m16n8k8 (TF32); 4 rows x 15 live splits x 8 head groups
//     = 120 blocks at the decode shape. Staging is by TMA bulk copies
//     from one warp, on one mbarrier: per-thread 16-byte copies (4608
//     a block) saturated the SM's load pipeline and took half the
//     block's time. The head groups of one (split, row) form a
//     thread-block cluster of up to 8; the block of rank r copies rows
//     r, r + 8, ... of the split's 64 [c_kv | k_rope] rows, in the
//     pool's own type, and multicasts each into every block of the
//     cluster, so each row crosses from L2 once per cluster instead of
//     once per head group; each block copies its own 16 heads' q_lat
//     and q_rope rows. S = Q [c_kv | k_rope]^T: warp w contracts its 1/8
//     of the 576 dims for all 64 positions (Q in registers), the 8
//     partial tiles are summed in warp order through shared memory (in
//     the query's space, free by then); the softmax of each head's 64
//     logits is a warp's butterfly; ctx += P c_kv: warp w owns 64 of
//     the 512 latent columns (B fragments by ldmatrix.trans, no
//     transpose in memory). Within a k-step the contraction slots are
//     permuted (slot t <-> element 2t, slot t + 4 <-> element 2t + 1),
//     so one ldmatrix register holds both B values of a fragment; eight
//     independent accumulators keep the mma's from waiting on each
//     other. The merge launch is released once the products are done.
//     Precision: TF32 keeps 10 mantissa bits (about 1e-3 relative), and
//     the gates are 1e-4. A bf16 pool value is exact in TF32, so only
//     the fp32 side is split: q = q_hi + q_lo and p = p_hi + p_lo, each
//     part rounded to TF32 (cvt.rna), and each product is two mma's
//     (hi, then lo) into one fp32 accumulator: fp32-grade logits and
//     context (the residual is below 2^-21 of the operand).
//   * "fma" route (fp32 pools -- 3xTF32 would buy little at their
//     widths -- and widths too small or ragged for the tiles, e.g. the
//     smoke configs' kvr 32, rope 8): the first design's per-warp math
//     on the same split partition and merge. One block per (split, 4
//     heads, row), one warp per head; each pooled block (bs x kvr latent
//     + bs x rope key) is read as 16-byte vectors, converted to fp32 in
//     shared memory and shared by the group's heads, the next block's
//     loads in flight while the current one is scored; lanes split the
//     contraction four elements at a time and one butterfly gives every
//     lane every logit of 16 positions, so the online softmax needs no
//     shared memory. Limits (checked by the wrapper): kvr <= 512, kvr +
//     rope <= 640, kvr and rope multiples of one 16-byte vector, pools
//     and q_lat 16-byte aligned; any block size.
//
// Duplicate table entries (prefix-shared blocks) are only read. Tables
// are NOT bounds-checked here (no more than the Pallas DMA was): the
// scheduler validates every table host-side before the launch
// (launch/kvpool.py:validate_tables).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::to_f;
namespace hp = repro::hopper;

constexpr float NEG_INF = -1e30f;

// ---- the tc route -------------------------------------------------------

constexpr int TC_HEADS = 16;                   // the M of m16n8k8
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_POS = 64;                     // positions of a split
constexpr int TC_MAX_W = 576;                  // kvr + rope
constexpr int TC_MAX_KVR = 512;
constexpr int TC_KS = TC_MAX_W / 8 / TC_WARPS;   // S k-steps a warp: 9
constexpr int TC_NT = TC_MAX_KVR / 8 / TC_WARPS; // ctx n-tiles a warp: 8
constexpr int TC_PK = TC_POS / 8;              // P.V k-steps: 8
constexpr int TC_MAX_CLUSTER = 8;              // head groups a cluster
constexpr int SP = TC_POS + 8;                 // S / P row stride (fp32):
                                               // 8 banks apart

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo, both TF32; lo carries what hi rounded away
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c (16 x 8, fp32) += a (16 x 8, TF32) b (8 x 8, TF32)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices: lane l gives the row address of matrix
// l / 8; r[i] holds matrix i's elements (g, 2 t) and (g, 2 t + 1)
// (t = lane % 4, g = lane / 4), the lower column in the low half
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// four 8 x 8 bf16 matrices, transposed: lane l gives the row address of
// matrix l / 8; r[i] holds matrix i's elements (2 t, g) and (2 t + 1, g)
// (t = lane % 4, g = lane / 4), the lower row in the low half
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// the two bf16 of a 32-bit word as TF32: the lower address (low half)
// and the upper one
__device__ __forceinline__ uint32_t bf16_lo(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t w) {
  return w & 0xffff0000u;
}

// elements d, d + 1 (d even) of a head's staged (q_lat | q_rope), as
// fp32: kvr and rope are even, so a pair never straddles the two
__device__ __forceinline__ float2 q_pair(const float* ql, const float* qr,
                                         int kvr, int d) {
  return d < kvr ? *reinterpret_cast<const float2*>(ql + d)
                 : *reinterpret_cast<const float2*>(qr + d - kvr);
}
__device__ __forceinline__ float2 q_pair(const float* ql,
                                         const __nv_bfloat16* qr, int kvr,
                                         int d) {
  if (d < kvr) return *reinterpret_cast<const float2*>(ql + d);
  const uint32_t w = *reinterpret_cast<const uint32_t*>(qr + d - kvr);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// shared memory of one tc block: the staged rows; the group's q_lat and
// q_rope, whose space the warps' S tiles (the first one reused for S,
// then P) take over; the staging barrier. About 109 KB at deepseek-v3's
// widths: two blocks fit an SM
inline __host__ __device__ int tc_union_offset(int kvr, int rope) {
  return (int)sizeof(__nv_bfloat16) * TC_POS * (kvr + rope + 8);
}
inline __host__ __device__ int tc_union_bytes(int kvr, int rope,
                                              int q_rope_size) {
  const int q = (int)sizeof(float) * TC_HEADS * (kvr + 8) +
                q_rope_size * TC_HEADS * (rope + 8);
  const int r = (int)sizeof(float) * TC_WARPS * TC_HEADS * SP;
  return ((q > r ? q : r) + 7) / 8 * 8;
}
inline size_t tc_smem_bytes(int kvr, int rope, int q_rope_size) {
  return tc_union_offset(kvr, rope) +
         tc_union_bytes(kvr, rope, q_rope_size) + sizeof(uint64_t);
}

// One split of one (16-head group, row): its partial (m, l, acc) into
// the workspace. Grid (split, head group, row); W = kvr + rope.
template <typename TQ>
__global__ void __launch_bounds__(TC_THREADS)
mla_split_tc(const float* __restrict__ q_lat, const TQ* __restrict__ q_rope,
             const __nv_bfloat16* __restrict__ ckv,
             const __nv_bfloat16* __restrict__ krope,
             const int* __restrict__ tables, const int* __restrict__ lengths,
             float* __restrict__ ws_acc, float* __restrict__ ws_ml, int H,
             int kvr, int rope, int bs, int nb, int S, float scale) {
  const int W = kvr + rope;
  const int KR = W + 8;                 // staged row stride (bf16): 4
                                        // banks apart
  const int QR = kvr + 8;               // q_lat row stride (fp32): 8 banks
  const int RR = rope + 8;              // q_rope row stride: 4 (bf16) or
                                        // 8 (fp32) banks
  // the staged rows; then the group's q_lat and q_rope, whose space the
  // warps' S tiles reuse once the query is in registers; the barrier
  extern __shared__ __align__(16) unsigned char mla_smem[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(mla_smem);
  float* qs = reinterpret_cast<float*>(kv + TC_POS * KR);
  TQ* qrs = reinterpret_cast<TQ*>(qs + TC_HEADS * QR);
  float* red = qs;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      mla_smem + tc_union_offset(kvr, rope) +
      tc_union_bytes(kvr, rope, sizeof(TQ)));
  const int split = blockIdx.x, h0 = blockIdx.y * TC_HEADS, b = blockIdx.z;
  const int p0 = split * TC_POS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the cluster: the head groups of this (split, row)
  const uint32_t rank = hp::cluster_rank(), csize = hp::cluster_size();

  // the row's length, and (before it is known) the block ids of the
  // split's rows lane and lane + 32, loaded by the first warp
  const int length_raw = lengths[b];
  int blk[TC_POS / 32] = {0, 0};
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < TC_POS / 32; ++k) {
      const int pos = p0 + lane + 32 * k;
      if (pos < nb * bs) blk[k] = tables[(size_t)b * nb + pos / bs];
    }
  }
  if (tid == 0) {
    hp::mbar_init(bar, 1);
    hp::fence_barrier_init();
  }
  // every barrier of the cluster is initialised before a copy lands
  hp::cluster_sync();
  // the same row and split for the whole cluster: it exits together
  const int length = min(length_raw, nb * bs);
  if (p0 >= length) return;
  const int n = min(TC_POS, length - p0);
  const int hn = min(TC_HEADS, H - h0);     // the group's live heads

  // ---- stage the split's rows [c_kv | k_rope] and the group's query ---
  // by TMA bulk copies, all completing on one barrier: the block of
  // cluster rank r loads rows r, r + C, ... (a row's latent and rope
  // parts) and multicasts each into every block of the cluster, so the
  // cluster reads each row from L2 once; each block loads its own
  // heads' q_lat and q_rope rows. Rows past n and heads past H are zeros.
  // Every copy into a block completes on that block's own barrier, which
  // it waits for, and nothing arrives remotely: no block needs another
  // to stay resident, so there is no cluster barrier at the end
  if (warp == 0) {
    if (lane == 0)
      hp::mbar_arrive_expect_tx(
          bar, n * 2 * W + hn * (4 * kvr + (int)sizeof(TQ) * rope));
    __syncwarp();
    const uint16_t all = (uint16_t)((1u << csize) - 1u);
#pragma unroll
    for (int k = 0; k < TC_POS / 32; ++k) {
      const int i = lane + 32 * k;
      if (i < n && i % csize == rank) {
        const size_t row = (size_t)blk[k] * bs + (p0 + i) % bs;
        hp::bulk_load_multicast(kv + (size_t)i * KR, ckv + row * kvr,
                                2 * kvr, bar, all);
        if (rope)
          hp::bulk_load_multicast(kv + (size_t)i * KR + kvr,
                                  krope + row * rope, 2 * rope, bar, all);
      }
    }
    if (lane < hn) {
      const size_t hrow = (size_t)b * H + h0 + lane;
      hp::bulk_load(qs + lane * QR, q_lat + hrow * kvr, 4 * kvr, bar);
      if (rope)
        hp::bulk_load(qrs + lane * RR, q_rope + hrow * rope,
                      (int)sizeof(TQ) * rope, bar);
    }
  } else {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int row_v = KR / 8;               // 16-byte pieces a row
    for (int e = (n * KR) / 8 + tid - 32; e < TC_POS * row_v;
         e += TC_THREADS - 32)
      reinterpret_cast<uint4*>(kv)[e] = zero;
    for (int e = hn * QR + tid - 32; e < TC_HEADS * QR;
         e += TC_THREADS - 32)
      qs[e] = 0.f;
    for (int e = hn * RR + tid - 32; e < TC_HEADS * RR;
         e += TC_THREADS - 32)
      qrs[e] = repro::from_f<TQ>(0.f);
  }
  __syncthreads();
  hp::mbar_wait(bar, 0);

  // ---- the query of this warp's dims as A fragments, TF32 hi / lo ----
  // k-step j covers dims d0 + 8 j .. + 7; slot t <-> d0 + 8 j + 2 t,
  // slot t + 4 <-> d0 + 8 j + 2 t + 1
  const int kd = W / TC_WARPS, ks = kd / 8, d0 = warp * kd;
  uint32_t qa_hi[TC_KS][4], qa_lo[TC_KS][4];
#pragma unroll
  for (int j = 0; j < TC_KS; ++j) {
    float2 va = make_float2(0.f, 0.f), vb = va;
    if (j < ks) {
      const int d = d0 + 8 * j + 2 * t;
      va = q_pair(qs + g * QR, qrs + g * RR, kvr, d);
      vb = q_pair(qs + (g + 8) * QR, qrs + (g + 8) * RR, kvr, d);
    }
    split_tf32(va.x, qa_hi[j][0], qa_lo[j][0]);
    split_tf32(vb.x, qa_hi[j][1], qa_lo[j][1]);
    split_tf32(va.y, qa_hi[j][2], qa_lo[j][2]);
    split_tf32(vb.y, qa_hi[j][3], qa_lo[j][3]);
  }
  __syncthreads();                          // the query space is free

  // ---- S partial over this warp's dims, all 64 positions -------------
  {
    float c[TC_POS / 8][4];
#pragma unroll
    for (int nt = 0; nt < TC_POS / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[nt][r] = 0.f;
#pragma unroll
    for (int j = 0; j < TC_KS; ++j) {
      if (j < ks) {
        // n-tile nt = positions 8 nt .. + 7: matrices of 8 rows each
        uint32_t bw[TC_POS / 8];
        ldmatrix_x4(bw, kv + (size_t)lane * KR + d0 + 8 * j);
        ldmatrix_x4(bw + 4, kv + (size_t)(32 + lane) * KR + d0 + 8 * j);
        // the eight accumulators are independent: no mma waits on the
        // one before it
#pragma unroll
        for (int nt = 0; nt < TC_POS / 8; ++nt)
          mma_tf32(c[nt], qa_hi[j], bf16_lo(bw[nt]), bf16_hi(bw[nt]));
#pragma unroll
        for (int nt = 0; nt < TC_POS / 8; ++nt)
          mma_tf32(c[nt], qa_lo[j], bf16_lo(bw[nt]), bf16_hi(bw[nt]));
      }
    }
    // c[nt]: heads g (0, 1) and g + 8 (2, 3), positions 8 nt + 2 t (+ 1)
    float* mine = red + warp * TC_HEADS * SP;
#pragma unroll
    for (int nt = 0; nt < TC_POS / 8; ++nt) {
      *reinterpret_cast<float2*>(mine + g * SP + 8 * nt + 2 * t) =
          make_float2(c[nt][0], c[nt][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * SP + 8 * nt + 2 * t) =
          make_float2(c[nt][2], c[nt][3]);
    }
  }
  __syncthreads();
  // the warps' partials summed in warp order, scaled and masked, into
  // the first tile
  for (int e = tid; e < TC_HEADS * TC_POS; e += TC_THREADS) {
    const int hh = e / TC_POS, p = e % TC_POS;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) s += red[(w * TC_HEADS + hh) * SP + p];
    red[hh * SP + p] = p < n ? s * scale : NEG_INF;
  }
  __syncthreads();

  // ---- the split's softmax: warp w takes heads 2 w and 2 w + 1 --------
  const size_t slot0 = ((size_t)b * H + h0) * S + split;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int hh = 2 * warp + k;
    float* sr = red + hh * SP;
    const float s0 = sr[lane], s1 = sr[lane + 32];
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = expf(s0 - m), e1 = expf(s1 - m);
    float l = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    sr[lane] = e0;
    sr[lane + 32] = e1;
    if (lane == 0 && h0 + hh < H) {
      float* ml = ws_ml + (slot0 + (size_t)hh * S) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();

  // ---- ctx += P c_kv: warp w owns latent columns [64 w, 64 w + 64) ---
  const int nd = kvr / TC_WARPS, ntl = nd / 8, n0 = warp * nd;
  uint32_t pa_hi[TC_PK][4], pa_lo[TC_PK][4];
#pragma unroll
  for (int j = 0; j < TC_PK; ++j) {
    // slot t <-> position 8 j + 2 t, slot t + 4 <-> 8 j + 2 t + 1
    const float2 pa = *reinterpret_cast<const float2*>(red + g * SP + 8 * j +
                                                       2 * t);
    const float2 pb = *reinterpret_cast<const float2*>(
        red + (g + 8) * SP + 8 * j + 2 * t);
    split_tf32(pa.x, pa_hi[j][0], pa_lo[j][0]);
    split_tf32(pb.x, pa_hi[j][1], pa_lo[j][1]);
    split_tf32(pa.y, pa_hi[j][2], pa_lo[j][2]);
    split_tf32(pb.y, pa_hi[j][3], pa_lo[j][3]);
  }
  float acc[TC_NT][4];
#pragma unroll
  for (int nt = 0; nt < TC_NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < TC_PK; j0 += 4) {
    // bw[nt][q]: n-tile nt (columns n0 + 8 nt ..), k-step j0 + q
    // (positions 8 (j0 + q) + 0..7), one matrix each
    uint32_t bw[TC_NT][4];
#pragma unroll
    for (int nt = 0; nt < TC_NT; ++nt)
      if (nt < ntl)
        ldmatrix_x4_trans(bw[nt],
                          kv + (size_t)(8 * j0 + lane) * KR + n0 + 8 * nt);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int nt = 0; nt < TC_NT; ++nt)
        if (nt < ntl)
          mma_tf32(acc[nt], pa_hi[j0 + q], bf16_lo(bw[nt][q]),
                   bf16_hi(bw[nt][q]));
#pragma unroll
      for (int nt = 0; nt < TC_NT; ++nt)
        if (nt < ntl)
          mma_tf32(acc[nt], pa_lo[j0 + q], bf16_lo(bw[nt][q]),
                   bf16_hi(bw[nt][q]));
    }
  }
  // the merge launch may be scheduled now: it waits for this grid to
  // finish (griddepcontrol.wait) before it reads the workspace
  repro::griddep_launch_dependents();
  // acc[nt]: heads g (0, 1) and g + 8 (2, 3), columns n0 + 8 nt + 2 t (+ 1)
#pragma unroll
  for (int nt = 0; nt < TC_NT; ++nt) {
    if (nt < ntl) {
      const int d = n0 + 8 * nt + 2 * t;
      if (h0 + g < H)
        *reinterpret_cast<float2*>(
            ws_acc + (slot0 + (size_t)g * S) * kvr + d) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (h0 + g + 8 < H)
        *reinterpret_cast<float2*>(
            ws_acc + (slot0 + (size_t)(g + 8) * S) * kvr + d) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ---- the fma route ------------------------------------------------------

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

// One split of one (row, group of HG heads): its partial (m, l, acc)
// into the workspace. Grid (split, head group, row).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
mla_split_fma(const float* __restrict__ q_lat, const TQ* __restrict__ q_rope,
              const TKV* __restrict__ ckv, const TKV* __restrict__ krope,
              const int* __restrict__ tables, const int* __restrict__ lengths,
              float* __restrict__ ws_acc, float* __restrict__ ws_ml, int H,
              int kvr, int rope, int bs, int nb, int chunk, int S,
              float scale) {
  repro::griddep_launch_dependents();
  // (bs, W) c_kv | k_rope of the pooled block, then the split's block ids
  extern __shared__ __align__(16) float sk[];
  const int W = kvr + rope;
  const int lane = threadIdx.x & 31;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y * HG + (threadIdx.x >> 5);
  const bool head = h < H;
  const size_t row = (size_t)b * H + (head ? h : 0);
  const int length = min(lengths[b], nb * bs);
  const int p0 = split * chunk;
  if (p0 >= length) return;

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
  // the split's pooled blocks j0 .. j0 + nblk - 1 (chunk is whole blocks)
  const int j0 = p0 / bs;
  const int nblk = (min(length, p0 + chunk) - p0 + bs - 1) / bs;

  int* split_table = reinterpret_cast<int*>(sk + bs * W);
  for (int i = threadIdx.x; i < nblk; i += THREADS)
    split_table[i] = tables[(size_t)b * nb + j0 + i];
  __syncthreads();
  const size_t lat_len = (size_t)bs * kvr, rope_len = (size_t)bs * rope;
  uint4 raw[RV];
  {
    const size_t blk = (size_t)split_table[0];
    st.fetch(raw, reinterpret_cast<const uint4*>(ckv + blk * lat_len),
             reinterpret_cast<const uint4*>(krope + blk * rope_len), 0);
  }
  for (int jj = 0; jj < nblk; ++jj) {
    const int j = j0 + jj;
    const size_t blk = (size_t)split_table[jj];
    const uint4* lat = reinterpret_cast<const uint4*>(ckv + blk * lat_len);
    const uint4* rp = reinterpret_cast<const uint4*>(krope + blk * rope_len);
    __syncthreads();                       // the last block is consumed
    st.stash(raw, 0, sk);
    for (int base = round; base < st.n; base += round) {
      st.fetch(raw, lat, rp, base);
      st.stash(raw, base, sk);
    }
    __syncthreads();
    if (jj + 1 < nblk) {                   // in flight while we score
      const size_t nxt = (size_t)split_table[jj + 1];
      st.fetch(raw, reinterpret_cast<const uint4*>(ckv + nxt * lat_len),
               reinterpret_cast<const uint4*>(krope + nxt * rope_len), 0);
    }
    for (int q0 = 0; q0 < bs; q0 += PG) {
      // positions q0 .. q0 + 15; one past the block reads its last row
      // (branch-free inner loops: a guard on each read was far slower)
      // and is masked out below
      int off[PG];
#pragma unroll
      for (int i = 0; i < PG; ++i) off[i] = min(q0 + i, bs - 1) * W;
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
        const int p = q0 + i;
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
    const size_t slot = row * S + split;
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int d = 4 * lane + 128 * c;
      if (d < kvr)
        *reinterpret_cast<float4*>(ws_acc + slot * kvr + d) = acc[c];
    }
    if (lane == 0) {
      ws_ml[slot * 2] = m;
      ws_ml[slot * 2 + 1] = l;
    }
  }
}

// ---- the merge (both routes) ---------------------------------------------

// The fixed-order merge of a row's live splits: one block per (head,
// row), launched as the split grid's programmatic dependent. A thread
// owns 4 latent columns and loads its partials of the first MERGE_AHEAD
// splits at once, while the first warp takes the splits' (m_s, l_s) a
// lane each: m = max m_s and l = sum l_s e^(m_s - m) by butterflies (a
// fixed order for a given number of live splits), the weights e^(m_s -
// m) into shared memory. Then each thread sums acc_s e^(m_s - m) in
// split order.
constexpr int MERGE_THREADS = 128;
constexpr int MERGE_AHEAD = 8;

__global__ void __launch_bounds__(MERGE_THREADS)
mla_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
          const int* __restrict__ lengths, float* __restrict__ out, int H,
          int kvr, int bs, int nb, int chunk, int S) {
  extern __shared__ float wsplit[];    // (S) weights, then l
  const int h = blockIdx.x, b = blockIdx.y;
  const int length = min(lengths[b], nb * bs);
  const int live = length > 0 ? (length + chunk - 1) / chunk : 0;
  // every write of the split grid is complete and visible after this
  repro::griddep_wait();
  const size_t row = (size_t)b * H + h;
  const float* acc_row = ws_acc + row * S * kvr;
  const int d = 4 * threadIdx.x;
  float4 v[MERGE_AHEAD];
#pragma unroll
  for (int u = 0; u < MERGE_AHEAD; ++u)
    if (u < live && d < kvr)
      v[u] = *reinterpret_cast<const float4*>(acc_row + (size_t)u * kvr + d);
  if (threadIdx.x < 32) {
    const float* ml = ws_ml + row * S * 2;
    const int lane = threadIdx.x;
    float m = NEG_INF;
    for (int s = lane; s < live; s += 32) m = fmaxf(m, ml[2 * s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int s = lane; s < live; s += 32) {
      const float w = expf(ml[2 * s] - m);
      wsplit[s] = w;
      l = fmaf(ml[2 * s + 1], w, l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) wsplit[S] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  const float l = wsplit[S];
  auto add = [](float4& acc, const float4& x, float w) {
    acc.x = fmaf(x.x, w, acc.x);
    acc.y = fmaf(x.y, w, acc.y);
    acc.z = fmaf(x.z, w, acc.z);
    acc.w = fmaf(x.w, w, acc.w);
  };
  // kvr <= 512 = 4 x MERGE_THREADS: one pass (the loop only for wider)
  for (int dd = d; dd < kvr; dd += 4 * MERGE_THREADS) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int s = 0;
    if (dd == d) {
#pragma unroll
      for (int u = 0; u < MERGE_AHEAD; ++u)
        if (u < live) add(acc, v[u], wsplit[u]);
      s = min(live, MERGE_AHEAD);
    }
    for (; s < live; ++s)
      add(acc,
          *reinterpret_cast<const float4*>(acc_row + (size_t)s * kvr + dd),
          wsplit[s]);
    *reinterpret_cast<float4*>(out + row * kvr + dd) =
        make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  }
}

// ---- launches -----------------------------------------------------------

template <typename TQ>
int launch_tc(const void* q_lat, const void* q_rope, const void* ckv,
              const void* krope, const void* tables, const void* lengths,
              float* wa, float* wm, int B, int H, int kvr, int rope, int bs,
              int nb, int chunk, int S, float scale, cudaStream_t stream) {
  const int W = kvr + rope;
  if (chunk != TC_POS || kvr % 64 || kvr > TC_MAX_KVR || W % 64 ||
      W > TC_MAX_W)
    return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(kvr, rope, sizeof(TQ));
  auto kern = mla_split_tc<TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // clusters of the head groups of one (split, row): the largest power
  // of two up to TC_MAX_CLUSTER that divides the groups
  const int G = (H + TC_HEADS - 1) / TC_HEADS;
  int C = TC_MAX_CLUSTER;
  while (G % C) C /= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, G, B);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(q_lat),
      static_cast<const TQ*>(q_rope), static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), wa,
      wm, H, kvr, rope, bs, nb, S, scale);
}

template <typename TQ, typename TKV>
int launch_fma(const void* q_lat, const void* q_rope, const void* ckv,
               const void* krope, const void* tables, const void* lengths,
               float* wa, float* wm, int B, int H, int kvr, int rope, int bs,
               int nb, int chunk, int S, float scale, cudaStream_t stream) {
  constexpr int V = Stage<TKV>::V;
  if (kvr > AC * 128 || kvr + rope > QC * 128 || kvr % V || rope % V)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)bs * (kvr + rope) +
                      sizeof(int) * (size_t)(chunk / bs);
  auto kern = mla_split_fma<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(S, (H + HG - 1) / HG, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const TQ*>(q_rope),
      static_cast<const TKV*>(ckv), static_cast<const TKV*>(krope),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), wa,
      wm, H, kvr, rope, bs, nb, chunk, S, scale);
  return cudaGetLastError();
}

template <typename TQ>
int launch_split(int kvtype, int route, const void* q_lat, const void* q_rope,
                 const void* ckv, const void* krope, const void* tables,
                 const void* lengths, float* wa, float* wm, int B, int H,
                 int kvr, int rope, int bs, int nb, int chunk, int S,
                 float scale, cudaStream_t s) {
  if (route == repro::kTc)
    return kvtype == repro::kBF16
               ? launch_tc<TQ>(q_lat, q_rope, ckv, krope, tables, lengths,
                               wa, wm, B, H, kvr, rope, bs, nb, chunk, S,
                               scale, s)
               : cudaErrorInvalidValue;
  if (route != repro::kFma) return cudaErrorInvalidValue;
  switch (kvtype) {
    case repro::kF32:
      return launch_fma<TQ, float>(q_lat, q_rope, ckv, krope, tables,
                                   lengths, wa, wm, B, H, kvr, rope, bs, nb,
                                   chunk, S, scale, s);
    case repro::kBF16:
      return launch_fma<TQ, __nv_bfloat16>(q_lat, q_rope, ckv, krope, tables,
                                           lengths, wa, wm, B, H, kvr, rope,
                                           bs, nb, chunk, S, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_lat (B, H, kvr) fp32; q_rope (B, H, rope) of type ``qtype``; pools
// c_kv (P, bs, kvr) and k_rope (P, bs, rope) of type ``kvtype``, 16-byte
// aligned; tables (B, nb) int32; lengths (B,) int32; out (B, H, kvr)
// fp32. Splits of ``chunk`` positions (a multiple of bs), S = ceil(nb *
// bs / chunk) of them a row at most; ws_acc holds B * H * S * kvr fp32
// and ws_ml B * H * S * 2. ``route`` (common.cuh ``Route``) is the
// wrapper's ``mla_route``. Two launches (the splits, the merge). Returns
// the cudaError_t of the launches (cudaErrorInvalidValue for widths
// outside the route's limits above).
extern "C" int paged_mla_launch(const void* q_lat, const void* q_rope,
                                const void* ckv, const void* krope,
                                const void* tables, const void* lengths,
                                void* out, void* ws_acc, void* ws_ml, int B,
                                int H, int kvr, int rope, int bs, int nb,
                                int chunk, float scale, int qtype, int kvtype,
                                int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || kvr < 1 || kvr % 4 || bs < 1 || nb < 1 ||
      chunk < bs || chunk % bs)
    return cudaErrorInvalidValue;
  const int S = (nb * bs + chunk - 1) / chunk;
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  int err;
  if (qtype == repro::kF32)
    err = launch_split<float>(kvtype, route, q_lat, q_rope, ckv, krope,
                              tables, lengths, wa, wm, B, H, kvr, rope, bs,
                              nb, chunk, S, scale, s);
  else if (qtype == repro::kBF16)
    err = launch_split<__nv_bfloat16>(kvtype, route, q_lat, q_rope, ckv,
                                      krope, tables, lengths, wa, wm, B, H,
                                      kvr, rope, bs, nb, chunk, S, scale, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  // the merge as a programmatic dependent launch: scheduled while the
  // splits run, it waits for them on the device
  return repro::launch_dependent(
      mla_merge, dim3(H, B), dim3(MERGE_THREADS), sizeof(float) * (S + 1),
      s, (const float*)wa, (const float*)wm,
      static_cast<const int*>(lengths), static_cast<float*>(out), H, kvr, bs,
      nb, chunk, S);
}
